"""Shared benchmark helpers: CSV emission, buffers in a memory tier, L2 labels.

Every benchmark prints ``name,us_per_call,derived`` rows, as the
reference's do.  A measured row on the card whose buffers fit the H100's
50 MB L2 says so in its ``derived`` column: repeated passes over a buffer
in device memory are served from L2, not from HBM.
"""

from __future__ import annotations

import torch

#: the H100's L2 cache (data sheet: 50 MB)
L2_BYTES = 50 * 2**20


def emit(name: str, us_per_call: float, derived: str) -> None:
    print(f"{name},{us_per_call:.2f},{derived}")


def kinds(device: torch.device) -> list[str]:
    """Memory kinds a benchmark on ``device`` places buffers in: the
    device's own memory, plus pinned host memory on the card."""
    return ["device", "pinned_host"] if device.type == "cuda" else ["device"]


def placed(n: int, kind: str, device: torch.device, dtype=torch.float32,
           fill: float = 1.0) -> torch.Tensor:
    """``n`` elements of ``fill`` in ``kind`` memory (``device``: the
    device's own; ``pinned_host``: page-locked host memory)."""
    if kind == "device":
        return torch.full((n,), fill, dtype=dtype, device=device)
    if kind == "pinned_host":
        return torch.full((n,), fill, dtype=dtype).pin_memory()
    raise ValueError(f"unknown memory kind {kind!r}")


def l2_note(nbytes: float, device: torch.device) -> str:
    """`` L2-resident`` for a card row whose device-memory buffers fit L2,
    else ``''``."""
    return " L2-resident" if device.type == "cuda" and nbytes < L2_BYTES else ""
