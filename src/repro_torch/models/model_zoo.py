"""Model bundle: one object per architecture, its train and serve entry points.

Counterpart of ``repro/models/model_zoo.py``.  The port trains and serves
dense decoders whose layers are all full-attention GQA (``F``), and serves
the SSM and hybrid families whose layers are Mamba-2 (``M``) and Zamba-style
shared GQA attention (``S``) — mamba2 and zamba2; their training waits for
the SSM-training slice.  Every other family or layer code raises
``NotImplementedError`` naming ROADMAP queue A.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.configs import ArchConfig, get_config, smoke_config
from repro_torch.models import transformer as tf_mod
from repro_torch.models.sharding import materialize, zeros_like_defs


@dataclasses.dataclass
class ModelBundle:
    cfg: ArchConfig

    def __post_init__(self):
        cfg = self.cfg
        codes = set(cfg.layer_codes())
        if cfg.family not in ("dense", "ssm", "hybrid") or cfg.moe is not None:
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} is not ported yet; the "
                "port serves dense GQA decoders, mamba2 and zamba2 "
                "(ROADMAP queue A)"
            )
        if not codes <= set(tf_mod.LAYER_CODES):
            raise NotImplementedError(
                f"{cfg.name}: layer pattern {cfg.layer_pattern!r} needs the "
                "L/G/C layer codes, not ported yet (ROADMAP queue A)"
            )
        if codes & {"F", "S"} and (
            cfg.attention is None or cfg.attention.kind != "gqa"
        ):
            raise NotImplementedError(
                f"{cfg.name}: only GQA attention is ported (ROADMAP queue A)"
            )

    # -- defs ----------------------------------------------------------------
    def param_defs(self):
        return tf_mod.lm_defs(self.cfg)

    def cache_defs(self, batch: int, max_len: int):
        return tf_mod.lm_cache_defs(self.cfg, batch, max_len)

    # -- materialization -------------------------------------------------
    def init_params(self, generator: torch.Generator, dtype=None):
        """Random weights drawn from ``generator``, on its device."""
        return materialize(self.param_defs(), generator, dtype or self.cfg.dtype)

    def init_cache(self, batch: int, max_len: int, dtype=None, device=None):
        return zeros_like_defs(
            self.cache_defs(batch, max_len), dtype or self.cfg.dtype,
            resolve_device(device),
        )

    # -- compute entry points ---------------------------------------------
    def train_loss(self, params, batch: dict, *, remat: str = "full"):
        """(loss, {"ce", "aux"}) of ``batch`` (``tokens``, ``labels``)."""
        if set(self.cfg.layer_codes()) & set(tf_mod.SSM_CODES):
            raise NotImplementedError(
                f"{self.cfg.name}: training through M/S layers is not ported "
                "yet (ROADMAP A5: ssm_train and the ssd_scan backward kernel)"
            )
        return tf_mod.lm_loss(
            params, batch["tokens"], batch["labels"], self.cfg, remat=remat
        )

    def prefill(self, params, batch: dict, caches):
        """Fill ``caches`` (in place) from ``batch["tokens"]`` at position 0;
        returns (last-token logits, caches)."""
        return tf_mod.lm_prefill(params, batch["tokens"], caches, self.cfg)

    def prefill_at(self, params, batch: dict, caches, offsets):
        """Chunked batched prefill at per-row cache offsets.

        ``batch`` holds ``tokens`` (B, S) — one prompt chunk per row — and
        ``new_lens`` (B,) — how many of the chunk's positions are real for
        each row (0 = leave the row untouched).  ``offsets`` (B,) is each
        row's current cache fill.  Returns (last-valid-position logits,
        caches updated in place).
        """
        return tf_mod.lm_prefill_at(
            params, batch["tokens"], caches, offsets, batch["new_lens"],
            self.cfg,
        )

    def decode_step(self, params, batch: dict, caches):
        return tf_mod.lm_decode_step(
            params, batch["tokens"], caches, batch["lengths"], self.cfg
        )


def get_bundle(arch: str) -> ModelBundle:
    return ModelBundle(get_config(arch))


def get_smoke_bundle(arch: str) -> ModelBundle:
    return ModelBundle(smoke_config(arch))
