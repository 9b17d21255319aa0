"""PyTorch/CUDA port of the ``repro`` train/serve stack for one NVIDIA H100.

The JAX package ``repro`` stays the reference; this package mirrors its
module names so each counterpart is easy to find:

* :mod:`repro_torch.configs` — a copy of the architecture configs;
* :mod:`repro_torch.kernels` — the plain PyTorch versions of the attention
  kernels (``ref``), the hand-written CUDA kernels behind ``ops``, and the
  ``nvcc`` build step;
* :mod:`repro_torch.models` — the dense GQA decoder over dict pytrees;
* :mod:`repro_torch.serve` — sampling, slot state, the executor and the
  continuous-batching :class:`~repro_torch.serve.Server`;
* :mod:`repro_torch.optim`, :mod:`repro_torch.train` — AdamW with an f32
  master and the train step;
* :mod:`repro_torch.data`, :mod:`repro_torch.checkpoint`,
  :mod:`repro_torch.runtime` — the synthetic data pipeline, checkpoints in
  the reference's layout, the supervisor;
* :mod:`repro_torch.api` — the ``Runtime``: device, placement policy and
  planner, realizing host placements;
* :mod:`repro_torch.launch` — the ``serve`` and ``train`` entry points;
* :mod:`repro_torch.convert` — carries reference weights and train state
  across.

It imports ``torch`` and numpy only.  Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; asking for CUDA without a card raises.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Raises when CUDA is asked for and no card is visible — the port never
    falls back to the CPU in silence.  ``meta`` (shapes and dtypes only,
    nothing computed) is the dry run's device
    (:mod:`repro_torch.launch.dryrun`).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
