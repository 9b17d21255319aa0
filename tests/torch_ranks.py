"""Run a script body in several gloo ranks on the CPU (a test helper).

Each rank is a fresh interpreter (``python -c``) that joins a gloo process
group through a file store under the test's temporary directory (no TCP
port, so parallel test workers cannot collide), runs ``body`` with
``rank``, ``world`` and ``inputs`` bound, and saves the dict ``out`` it
fills.  Every rank has a deadline: on timeout all ranks are killed and the
test fails, so a hung collective fails its test instead of the suite.

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

ROOT = pathlib.Path(__file__).resolve().parents[1]

_PRELUDE = """\
import datetime, sys
import torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("gloo", init_method="file://{store}", rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds={timeout}))
inputs = torch.load("{inputs}", weights_only=False)
out = {{}}
"""

_EPILOGUE = """
torch.save(out, "{outdir}/rank_%d.pt" % rank)
dist.barrier()
dist.destroy_process_group()
"""


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.update(extra)
    return env


def run_ranks(body: str, world: int, tmp_path, inputs=None, timeout: float = 120.0):
    """``body`` in ``world`` gloo ranks; returns each rank's ``out`` dict,
    by rank.  ``inputs`` (anything ``torch.save`` takes) is bound as
    ``inputs`` in every rank."""
    tmp = pathlib.Path(tmp_path) / f"ranks_{time.monotonic_ns()}"
    tmp.mkdir(parents=True)
    torch.save(inputs, tmp / "inputs.pt")
    script = (_PRELUDE.format(store=tmp / "store", timeout=int(timeout),
                              inputs=tmp / "inputs.pt")
              + textwrap.dedent(body) + _EPILOGUE.format(outdir=tmp))
    procs, logs = [], []
    for r in range(world):
        log = open(tmp / f"log_{r}.txt", "w")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, "-c", script, str(r), str(world)],
                                      env=_env(), stdout=log, stderr=subprocess.STDOUT))
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
        text = "\n".join(f"--- rank {r} (rc {rc}):\n"
                         + (tmp / f"log_{r}.txt").read_text()[-3000:] for r, rc in failed)
        raise AssertionError(f"ranks failed or timed out after {timeout} s:\n{text}")
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
