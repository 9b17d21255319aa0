"""Run a script body in several gloo ranks on the CPU (a test helper).

Each rank is a fresh interpreter that joins a gloo process group through a
file store under the test's temporary directory (no TCP port, so parallel
test workers cannot collide), runs ``body`` with ``rank``, ``world`` and
``inputs`` bound, and saves the dict ``out`` it fills.  The ranks are
spawned, given a deadline and killed on timeout by the package's
``run_with_ranks``, so a hung collective fails its test instead of the
suite.

A second helper runs the JAX reference in a subprocess with
``--xla_force_host_platform_device_count`` (the pattern of
``tests/test_distributed.py``), since the test process keeps one device.
"""

import os
import pathlib
import subprocess
import sys
import textwrap
import time

import numpy as np
import torch

from repro_torch.benchmarks.common import run_with_ranks

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.update(extra)
    return env


def run_ranks(body: str, world: int, tmp_path, inputs=None, timeout: float = 120.0):
    """``body`` in ``world`` gloo ranks (through
    :func:`repro_torch.benchmarks.common.run_with_ranks`); returns each
    rank's ``out`` dict, by rank.  ``inputs`` (anything ``torch.save``
    takes) is bound as ``inputs`` in every rank."""
    tmp = pathlib.Path(tmp_path) / f"ranks_{time.monotonic_ns()}"
    tmp.mkdir(parents=True)
    torch.save(inputs, tmp / "inputs.pt")
    code = (f"inputs = torch.load({str(tmp / 'inputs.pt')!r}, weights_only=False)\n"
            "out = {}\n" + textwrap.dedent(body)
            + f"\ntorch.save(out, {str(tmp)!r} + '/rank_%d.pt' % rank)\n")
    run_with_ranks(code, world, timeout, workdir=tmp)
    return [torch.load(tmp / f"rank_{r}.pt", weights_only=False) for r in range(world)]


def run_reference(body: str, tmp_path, devices: int = 8, timeout: float = 300.0) -> dict:
    """``body`` in a JAX subprocess that sees ``devices`` CPU devices; the
    dict ``out`` it fills (numpy arrays) comes back."""
    path = pathlib.Path(tmp_path) / f"ref_{time.monotonic_ns()}.npz"
    script = ("import os\n"
              f'os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={devices}"\n'
              "import numpy as np\nout = {}\n" + textwrap.dedent(body)
              + f"\nnp.savez({str(path)!r}, **out)\n")
    r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                       timeout=timeout, env=_env(JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr[-4000:]}"
    with np.load(path) as f:
        return {k: f[k] for k in f.files}
