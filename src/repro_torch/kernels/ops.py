"""The attention ops the model calls, dispatched on the tensors' device.

Counterpart of ``repro/kernels/ops.py`` (``decode_attention`` and
``prefill_attention``).  There is no ``backend`` knob: a CPU tensor takes
the plain PyTorch version in :mod:`repro_torch.kernels.ref`, a CUDA tensor
takes the hand-written CUDA kernel, and anything else raises.  There is no
fallback from the kernel to the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import flash_decode
from repro_torch.kernels.flash_attention import flash_prefill


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"no attention path for device {t.device}")


def decode_attention(q, k_cache, v_cache, lengths, *, scale=None):
    """(B, Hq, D) single-token decode against a padded KV cache."""
    if _route(q) == "cuda":
        return flash_decode(q, k_cache, v_cache, lengths, scale=scale)
    return ref.decode_attention(q, k_cache, v_cache, lengths, scale=scale)


def prefill_attention(
    q, k, v, q_pos, k_pos, *,
    k_new=None, v_new=None,
    kind: str = "causal",
    window: int = 0,
    chunk: int = 0,
    scale: float | None = None,
):
    """(B, Hq, Sq, D) chunk queries vs the keys ``k ++ k_new``.

    With ``k_new``/``v_new`` absent this is the reference's one-source
    signature, ``k``/``v`` already holding cache ++ chunk.  The model
    passes the prior cache as ``k``/``v`` and the chunk's own keys as
    ``k_new``/``v_new``; ``k_pos`` covers both, cache slots first.
    """
    if _route(q) == "cuda":
        return flash_prefill(
            q, k, v, q_pos, k_pos, k_new=k_new, v_new=v_new,
            kind=kind, window=window, chunk=chunk, scale=scale,
        )
    if k_new is not None:
        k = torch.cat([k, k_new], dim=2)
        v = torch.cat([v, v_new], dim=2)
    return ref.prefill_attention(
        q, k, v, q_pos, k_pos,
        kind=kind, window=window, chunk=chunk, scale=scale,
    )
