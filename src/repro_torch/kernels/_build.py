"""Build the CUDA sources in ``repro_torch/csrc`` with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library, loaded with :mod:`ctypes` (no PyTorch headers, so a build takes
seconds).  Libraries land in ``build/kernels/`` at the repository root —
a git-ignored directory — or in ``$REPRO_TORCH_BUILD_DIR`` when set, under
a name that carries a hash of the source, of every shared header
``csrc/*.cuh`` and of the flags, so an edited source or header is rebuilt
and an unchanged one is reused.

Nothing here runs when a module is imported: the CPU tests import every
module on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
#: name -> (build seconds, nvcc output) of the builds this process ran
BUILD_LOG: dict[str, tuple[float, str]] = {}


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "can only be built on a machine with the CUDA toolkit"
        )
    return path


def _target(name: str) -> pathlib.Path:
    """The library's path: its name hashes the source, every header in
    ``csrc`` (any source may include any of them) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: list[str] | None = None) -> dict[str, pathlib.Path]:
    """Compile the named sources (default: every ``csrc/*.cu``) that have
    no up-to-date library yet, one ``nvcc`` per source, all started
    together.  Raises with the compiler's output if any build fails."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    targets = {n: _target(n) for n in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if todo:
        build_dir().mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = {}
        for n, t in todo.items():
            tmp = t.with_suffix(f".{os.getpid()}.tmp")
            procs[n] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        failed = []
        for n, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            BUILD_LOG[n] = (time.perf_counter() - t0, out)
            if proc.returncode != 0:
                failed.append(f"--- {n}.cu (exit {proc.returncode}) ---\n{out}")
            else:
                os.replace(tmp, todo[n])
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LIBS[name] = lib
    return lib


def check(status: int, name: str) -> None:
    """Raise if ``csrc/<name>.cu``'s launch returned a non-zero
    ``cudaError_t``; the message comes from its ``<name>_error_string``."""
    if status != 0:
        describe = getattr(load(name), f"{name}_error_string")
        describe.argtypes = [ctypes.c_int]
        describe.restype = ctypes.c_char_p
        raise RuntimeError(
            f"{name}: CUDA launch failed with cudaError {status} "
            f"({describe(status).decode()})"
        )


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (a ``torch.device`` or an
    index), read once per device: the launch plans size their grids by it
    without a query per call."""
    device = torch.device("cuda", device) if isinstance(device, int) else torch.device(device)
    return _sm_count(device.index if device.index is not None else torch.cuda.current_device())
