"""Model bundle: one object per architecture, its train and serve entry points.

Counterpart of ``repro/models/model_zoo.py``.  The port trains and serves
dense decoders whose layers are all full-attention GQA (``F``), and serves
the SSM and hybrid families whose layers are Mamba-2 (``M``) and Zamba-style
shared GQA attention (``S``) — mamba2 and zamba2; their training waits for
the SSM-training slice.  Every other family or layer code raises
``NotImplementedError`` naming ROADMAP queue A.

The sizing half — the bytes, flops and planner profiles of a shape — is
pure arithmetic over the config and lives in :class:`ModelSizing`, which
takes every config whose decode cache the port can describe (all but the
encoder-decoder audio family), so the planner's tables can price models
the port does not run.  :class:`ModelBundle` adds the model itself.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import resolve_device
from repro_torch.configs import ArchConfig, ShapeSpec, get_config, smoke_config
from repro_torch.models import transformer as tf_mod
from repro_torch.models.sharding import (
    Param,
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

    def cache_defs(self, batch: int, max_len: int):
        if self.cfg.family == "audio" and self.cfg.n_encoder_layers:
            raise NotImplementedError(
                f"{self.cfg.name}: encoder-decoder caches are not ported yet "
                "(ROADMAP A7)"
            )
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
    points, for the families the port runs."""

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

    def input_defs(self, shape: ShapeSpec) -> dict:
        """Batch-input defs for one (shape) cell.  The port's families
        are text-only, so there are no frontend embeddings."""
        B, S = shape.global_batch, shape.seq_len
        toks = ("batch", "seq")
        if shape.mode == "train":
            return {
                "tokens": Param((B, S), toks, dtype="int32"),
                "labels": Param((B, S), toks, dtype="int32"),
            }
        if shape.mode == "prefill":
            return {"tokens": Param((B, S), toks, dtype="int32")}
        # decode: one new token against a cache of S entries
        return {
            "tokens": Param((B, 1), toks, dtype="int32"),
            "lengths": Param((B,), ("batch",), dtype="int32"),
        }

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
