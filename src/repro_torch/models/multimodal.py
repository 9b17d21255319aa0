"""Modality frontends: stubs.

Counterpart of ``repro/models/multimodal.py``.  The ``audio`` and ``vlm``
architectures specify the transformer backbone only; a batch carries
precomputed frame or patch embeddings in place of a frontend.  The defs
here describe those stub inputs, (batch, ``frontend_tokens``, d_model), so
that a real InternViT or w2v-BERT frontend producing tensors of exactly
these shapes plugs in without touching the backbone.
"""

from __future__ import annotations

from repro_torch.configs import ArchConfig
from repro_torch.models.sharding import Param

#: the batch key of each frontend's stub embeddings
FRONTEND_KEYS = {"vision_stub": "patch_embeds", "audio_stub": "frame_embeds"}


def frontend_input_defs(cfg: ArchConfig, batch: int) -> dict:
    """Stub embedding inputs for a batch (empty for text-only archs)."""
    if cfg.frontend == "none" or cfg.frontend_tokens == 0:
        return {}
    return {
        FRONTEND_KEYS[cfg.frontend]: Param(
            (batch, cfg.frontend_tokens, cfg.d_model),
            ("batch", "seq", "embed"),
        )
    }


def frontend_embeds(batch_inputs: dict):
    """The stub embeddings of a batch dict (None for a text-only batch)."""
    for key in ("patch_embeds", "frame_embeds"):
        if key in batch_inputs:
            return batch_inputs[key]
    return None
