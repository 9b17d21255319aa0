"""Model bundle: one object per architecture, its train and serve entry points.

Counterpart of ``repro/models/model_zoo.py``.  The port trains and serves
all ten of the reference's architectures: GQA decoders whatever their
attention layer codes — full (``F``), global (``G``), sliding-window
(``L``) and chunk-local (``C``) rings, as gemma3 mixes them — and MLA
decoders (deepseek-v2), with dense FFNs or GShard MoE ones (family
``"moe"``: llama4, deepseek-v2 with its dense lead layer), the SSM and
hybrid families whose layers are Mamba-2 (``M``) and Zamba-style shared
GQA attention (``S``): mamba2 and zamba2; the vision-stub VLM (family
``"vlm"``: internvl2, its patch embeddings prepended to the text), and
the encoder-decoder (family ``"audio"``: seamless-m4t,
:mod:`repro_torch.models.encdec`, its frame embeddings encoded).

The sizing half — the bytes, flops and planner profiles of a shape — is
pure arithmetic over the config and lives in :class:`ModelSizing`, so the
planner's tables can price a model without building it.
:class:`ModelBundle` adds the model itself.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import resolve_device
from repro_torch.configs import ArchConfig, ShapeSpec, get_config, smoke_config
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models.multimodal import frontend_embeds, frontend_input_defs
from repro_torch.models.sharding import (
    Param,
    local_defs,
    materialize,
    tree_leaves,
    zeros_like_defs,
)


@dataclasses.dataclass
class ModelSizing:
    """The sizing half of the reference's ``ModelBundle``
    (``repro/models/model_zoo.py:136-247``): the same numbers for the same
    config."""

    cfg: ArchConfig

    @property
    def encdec(self) -> bool:
        """An encoder-decoder (the audio family with encoder layers)."""
        return self.cfg.family == "audio" and self.cfg.n_encoder_layers > 0

    def cache_defs(self, batch: int, max_len: int):
        if self.encdec:
            return encdec_mod.encdec_cache_defs(self.cfg, batch, max_len)
        return tf_mod.lm_cache_defs(self.cfg, batch, max_len)

    def decode_cache_len(self, shape: ShapeSpec) -> int:
        return shape.seq_len

    def model_bytes(self, shape: ShapeSpec) -> float:
        """Bytes that must cross the HBM bus per step: one read of the
        active parameters (+ the decode-state read for decode shapes)."""
        itemsize = 2  # bf16
        nbytes = self.cfg.active_params() * itemsize
        if shape.mode == "decode":
            nbytes += self.cache_bytes(shape)
        return nbytes

    def cache_bytes(self, shape: ShapeSpec) -> float:
        return self.cache_bytes_for(shape.global_batch, shape.seq_len)

    def cache_bytes_for(self, batch: int, max_len: int) -> float:
        """Total decode-cache bytes for an explicit (batch, max_len)."""
        total = 0.0
        for p in tree_leaves(self.cache_defs(batch, max_len)):
            width = 4 if str(p.dtype) == "float32" else 2
            total += math.prod(p.shape) * width
        return total

    def model_flops(self, shape: ShapeSpec) -> float:
        """MODEL_FLOPS per step: 6·N·D train (N=active for MoE), 2·N·D fwd."""
        n = self.cfg.active_params()
        if shape.mode == "train":
            return 6.0 * n * shape.global_batch * shape.seq_len
        if shape.mode == "prefill":
            return 2.0 * n * shape.global_batch * shape.seq_len
        return 2.0 * n * shape.global_batch  # one token per row

    # -- planner profiles ---------------------------------------------------
    def train_workload(
        self,
        shape: ShapeSpec,
        *,
        num_chips: int = 1,
        data_axis_size: int = 1,
        pod_axis_size: int = 1,
        remat: bool = True,
    ):
        """Planner :func:`~repro_torch.core.planner.train_profile` for ``shape``."""
        from repro_torch.core.planner import train_profile

        cfg = self.cfg
        return train_profile(
            name=cfg.name,
            param_bytes=cfg.num_params() * 2,
            step_flops=self.model_flops(shape),
            activation_bytes=2.0 * shape.global_batch * shape.seq_len
            * cfg.d_model * cfg.n_layers,
            num_chips=num_chips,
            remat=remat,
            n_layers=max(cfg.n_layers, 1),
            data_axis_size=data_axis_size,
            pod_axis_size=pod_axis_size,
        )

    def decode_workload(self, shape: ShapeSpec, *, num_chips: int = 1):
        """Planner :func:`~repro_torch.core.planner.decode_profile` for ``shape``."""
        from repro_torch.core.planner import decode_profile

        cfg = self.cfg
        return decode_profile(
            name=cfg.name,
            param_bytes=cfg.num_params() * 2,
            kv_bytes=self.cache_bytes(shape),
            step_flops=self.model_flops(shape),
            num_chips=num_chips,
            n_layers=max(cfg.n_layers, 1),
        )

    def prefill_workload(
        self, shape: ShapeSpec, *, chunk_tokens: int, num_chips: int = 1
    ):
        """Planner :func:`~repro_torch.core.planner.prefill_profile` for one
        chunked-prefill dispatch of ``chunk_tokens`` per row of ``shape``'s
        batch (the serve engine's admission phase)."""
        from repro_torch.core.planner import prefill_profile

        cfg = self.cfg
        chunk_shape = ShapeSpec(
            shape.name, chunk_tokens, shape.global_batch, "prefill"
        )
        return prefill_profile(
            name=cfg.name,
            param_bytes=cfg.num_params() * 2,
            kv_bytes=self.cache_bytes(shape),
            chunk_flops=self.model_flops(chunk_shape),
            activation_bytes=2.0 * shape.global_batch * chunk_tokens
            * cfg.d_model * cfg.n_layers,
            num_chips=num_chips,
            n_layers=max(cfg.n_layers, 1),
        )


@dataclasses.dataclass
class ModelBundle(ModelSizing):
    """Sizing plus the model: defs, materialization and the compute entry
    points."""

    def __post_init__(self):
        cfg = self.cfg
        codes = set(cfg.layer_codes())
        if not codes <= set(tf_mod.LAYER_CODES):
            raise NotImplementedError(
                f"{cfg.name}: layer pattern {cfg.layer_pattern!r} has codes "
                "the port does not run (ROADMAP queue A)"
            )
        if codes - {"M"} and (cfg.attention is None
                              or cfg.attention.kind not in ("gqa", "mla")):
            raise NotImplementedError(
                f"{cfg.name}: only GQA and MLA attention are ported (ROADMAP queue A)"
            )

    def check_model_axis(self, ranks: int) -> None:
        """Raise ``NotImplementedError`` for a ``model`` axis of ``ranks`` > 1
        over a family whose layers the port does not split yet: the
        tensor-parallel layers are the dense decoder's GQA attention, MLP,
        embedding and head (ROADMAP A10b, rest)."""
        if ranks < 2:
            return
        cfg, what = self.cfg, []
        if cfg.moe is not None:
            what.append("MoE experts")
        if set(cfg.layer_codes()) & {"M", "S"}:
            what.append("M/S layers (ssm_heads, d_inner)")
        if cfg.attention is not None and cfg.attention.kind == "mla":
            what.append("MLA")
        if self.encdec:
            what.append("the encoder-decoder")
        elif cfg.frontend != "none":
            what.append("the VLM")
        if what:
            raise NotImplementedError(
                f"{cfg.name}: a {ranks}-rank model axis over {', '.join(what)} is not "
                "ported yet (ROADMAP A10b, rest); a data or pod axis trains it, and a "
                "data axis serves it")

    # -- defs ----------------------------------------------------------------
    def param_defs(self):
        if self.encdec:
            return encdec_mod.encdec_defs(self.cfg)
        return tf_mod.lm_defs(self.cfg)

    def input_defs(self, shape: ShapeSpec) -> dict:
        """Batch-input defs for one (shape) cell.  A train or prefill batch
        of a frontend model carries its stub embeddings too; a VLM's text
        is ``S - frontend_tokens`` long, so that patches and text fill S."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        text_len = S if self.encdec else S - cfg.frontend_tokens
        toks = ("batch", "seq")
        if shape.mode == "train":
            return {
                "tokens": Param((B, text_len), toks, dtype="int32"),
                "labels": Param((B, text_len), toks, dtype="int32"),
                **frontend_input_defs(cfg, B),
            }
        if shape.mode == "prefill":
            return {"tokens": Param((B, text_len), toks, dtype="int32"),
                    **frontend_input_defs(cfg, B)}
        # decode: one new token against a cache of S entries
        return {
            "tokens": Param((B, 1), toks, dtype="int32"),
            "lengths": Param((B,), ("batch",), dtype="int32"),
        }

    # -- materialization -------------------------------------------------
    def init_params(self, generator: torch.Generator, dtype=None):
        """Random weights drawn from ``generator``, on its device."""
        return materialize(self.param_defs(), generator, dtype or self.cfg.dtype)

    def init_cache(self, batch: int, max_len: int, dtype=None, device=None, *,
                   specs=None, mesh=None):
        """A zero cache of ``batch`` rows; with a mesh's cache ``specs``
        this rank's shards of it, made at their local shapes."""
        defs = self.cache_defs(batch, max_len)
        if specs is not None:
            defs = local_defs(defs, specs, mesh)
        return zeros_like_defs(defs, dtype or self.cfg.dtype, resolve_device(device))

    # -- compute entry points ---------------------------------------------
    def train_loss(self, params, batch: dict, *, remat: str = "full"):
        """(loss, {"ce", "aux"}) of ``batch`` (``tokens``, ``labels`` and a
        frontend model's ``frame_embeds`` / ``patch_embeds``).  An
        encoder-decoder takes no ``remat``, as the reference's does not."""
        if self.encdec:
            return encdec_mod.encdec_train_loss(
                params, batch["frame_embeds"], batch["tokens"],
                batch["labels"], self.cfg,
            )
        return tf_mod.lm_loss(
            params, batch["tokens"], batch["labels"], self.cfg,
            extra_embeds=frontend_embeds(batch), remat=remat,
        )

    def param_windows(self, params) -> list[dict]:
        """The windows in which a step reads ``params``, in step order: the
        embedding, each layer, the tail (:func:`~repro_torch.models.
        transformer.param_windows`; an encoder-decoder's decoder layers,
        :func:`~repro_torch.models.encdec.param_windows`)."""
        if self.encdec:
            return encdec_mod.param_windows(self.cfg, params)
        return tf_mod.param_windows(self.cfg, params)

    def cache_windows(self, caches) -> list[dict]:
        """The cache's windows, one a layer (a stage's stacked index), in
        step order (:func:`~repro_torch.models.transformer.leaf_windows`;
        an encoder-decoder's ``{"self", "cross"}`` a decoder layer,
        :func:`~repro_torch.models.encdec.cache_windows`)."""
        if self.encdec:
            return encdec_mod.cache_windows(caches)
        return tf_mod.leaf_windows(caches)

    def train_loss_windowed(self, source, batch: dict, grads):
        """:meth:`train_loss` and its gradients over params read window by
        window from ``source`` (a ``HostStream`` or ``ParamViews`` over
        :meth:`param_windows`) -> (loss, {"ce", "aux"}), the gradients
        written into the device tree ``grads``
        (:func:`~repro_torch.models.transformer.lm_loss_windowed`).  An
        encoder-decoder raises: its training loops read the params whole
        (ROADMAP A7c)."""
        if self.encdec:
            raise NotImplementedError(
                f"{self.cfg.name}: training an encoder-decoder with its params in "
                "host memory is not ported yet (ROADMAP A7c)")
        return tf_mod.lm_loss_windowed(
            source, batch["tokens"], batch["labels"], grads, self.cfg,
            extra_embeds=frontend_embeds(batch))

    def prefill(self, params, batch: dict, caches, *, feed=None):
        """Fill ``caches`` (in place) from ``batch["tokens"]`` at position 0
        — after a VLM's ``patch_embeds``, or over an encoder-decoder's
        encoded ``frame_embeds`` — and return (last-token logits, caches).
        ``feed``: see :class:`~repro_torch.models.transformer.ResidentFeed`."""
        if self.encdec:
            return encdec_mod.encdec_prefill(
                params, batch["frame_embeds"], batch["tokens"], caches,
                self.cfg, feed=feed,
            )
        return tf_mod.lm_prefill(params, batch["tokens"], caches, self.cfg,
                                 extra_embeds=frontend_embeds(batch), feed=feed)

    def prefill_at(self, params, batch: dict, caches, offsets, *, feed=None):
        """Chunked batched prefill at per-row cache offsets.

        ``batch`` holds ``tokens`` (B, S) — one prompt chunk per row — and
        ``new_lens`` (B,) — how many of the chunk's positions are real for
        each row (0 = leave the row untouched).  ``offsets`` (B,) is each
        row's current cache fill.  Returns (last-valid-position logits,
        caches updated in place).  An encoder-decoder's self cache fills as
        the LM path's does; its cross KV, read-only while generating, rides
        through unchanged.  A VLM's chunks are text only.
        """
        if self.encdec:
            return encdec_mod.encdec_prefill_at(
                params, batch["tokens"], caches, offsets, batch["new_lens"],
                self.cfg, feed=feed,
            )
        return tf_mod.lm_prefill_at(
            params, batch["tokens"], caches, offsets, batch["new_lens"],
            self.cfg, feed=feed,
        )

    def decode_step(self, params, batch: dict, caches, *, feed=None):
        if self.encdec:
            return encdec_mod.encdec_decode_step(
                params, batch["tokens"], caches, batch["lengths"], self.cfg,
                feed=feed,
            )
        return tf_mod.lm_decode_step(
            params, batch["tokens"], caches, batch["lengths"], self.cfg,
            feed=feed,
        )


def get_bundle(arch: str) -> ModelBundle:
    return ModelBundle(get_config(arch))


def get_smoke_bundle(arch: str) -> ModelBundle:
    return ModelBundle(smoke_config(arch))
