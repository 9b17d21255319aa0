"""Shared benchmark helpers: CSV emission, buffers in a memory tier, L2
labels, and a runner of gloo ranks.

Every benchmark prints ``name,us_per_call,derived`` rows, as the
reference's do.  A measured row on the card whose buffers fit the H100's
50 MB L2 says so in its ``derived`` column: repeated passes over a buffer
in device memory are served from L2, not from HBM.  The collective
benchmarks measure over gloo ranks on the CPU (:func:`run_with_ranks`),
the counterpart of the reference's forced host devices.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import tempfile
import textwrap
import time

import torch

#: the package's source root (the ranks import it from there)
SRC = pathlib.Path(__file__).resolve().parents[2]

_PRELUDE = """\
import datetime, sys, time
import torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("gloo", init_method="file://{store}", rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds={timeout}))
"""

_EPILOGUE = """
dist.barrier()
dist.destroy_process_group()
"""

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


def run_with_ranks(code: str, n: int = 8, timeout: float = 600.0, workdir=None) -> str:
    """Run ``code`` in ``n`` gloo ranks on the CPU, one subprocess each,
    and return rank 0's standard output.

    Counterpart of the reference's ``run_with_devices``: the caller's
    process keeps no process group.  The ranks join through a file store
    in ``workdir`` (a fresh temporary directory by default; no TCP port),
    each with ``rank``, ``world``, ``torch`` and ``dist``
    (``torch.distributed``) bound and one intra-op thread, and write their
    output there.  Every rank has a deadline: on timeout every rank is
    killed and this raises, as it does when a rank fails.
    """
    if workdir is None:
        with tempfile.TemporaryDirectory() as tmp:
            return run_with_ranks(code, n, timeout, tmp)
    tmp = pathlib.Path(workdir)
    script = (_PRELUDE.format(store=tmp / "store", timeout=int(timeout))
              + textwrap.dedent(code) + _EPILOGUE)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(SRC), env.get("PYTHONPATH")) if p)
    logs = [open(tmp / f"rank_{r}.{k}", "w") for r in range(n) for k in ("out", "err")]
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), str(n)], env=env,
                              stdout=logs[2 * r], stderr=logs[2 * r + 1])
             for r in range(n)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"ranks failed or timed out after {timeout} s: " + "; ".join(
            f"rank {r} (rc {rc}): {(tmp / f'rank_{r}.err').read_text()[-3000:]}"
            for r, rc in failed))
    return (tmp / "rank_0.out").read_text()
