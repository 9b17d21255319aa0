"""KV write-back into pinned host memory: the CUDA kernel and its wrapper.

No Pallas original: the reference leaves host<->device transfers to XLA.
Under a streamed host placement of the KV cache each layer computes on a
device staging window of its cache slab; :func:`kv_write_back` copies the
rows the step wrote there back into the slab in pinned host memory,
through the card's mapped view of it (``repro_torch/csrc/kv_stream.cu``,
whose header says what bounds it and how it is built).  The plain version
is :func:`repro_torch.kernels.ref.kv_write_back`; a CPU source takes it.

The same library carries the host tier's plumbing, which is no kernel:
:func:`copy_async` (``cudaMemcpyAsync``, the window copies of a streamed
role, capturable in a CUDA graph) and :func:`register` / :func:`unregister`
(``cudaHostRegister``, the pinned arenas of
:mod:`repro_torch.core.placement`).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_fns = None


def _lib():
    global _fns
    if _fns is None:
        lib = _build.load("kv_stream")
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.kv_stream_write_back_launch.argtypes = [P] * 6 + [I] * 4 + [P]
        lib.kv_stream_copy.argtypes = [P, P, L, P]
        lib.kv_stream_host_register.argtypes = [P, L]
        lib.kv_stream_host_unregister.argtypes = [P]
        for fn in (lib.kv_stream_write_back_launch, lib.kv_stream_copy,
                   lib.kv_stream_host_register, lib.kv_stream_host_unregister):
            fn.restype = I
        _fns = lib
    return _fns


def kv_write_back(
    src_k: torch.Tensor,    # (B, H, S, D) staging window on the card
    src_v: torch.Tensor,
    dst_k: torch.Tensor,    # (B, H, S, D) the layer's slab: pinned host (or card)
    dst_v: torch.Tensor,
    pos: torch.Tensor,      # (B,) int32 on the card
    n: torch.Tensor,        # (B,) int32 on the card
) -> None:
    """Copy rows ``[pos[b], pos[b] + n[b])`` (mod S) of every head from the
    staging window into the slab, in place.  A CPU source takes the plain
    version; a CUDA source launches the kernel on the current stream, and
    the launcher refuses a destination in pageable host memory."""
    if src_k.device.type == "cpu":
        ref.kv_write_back(src_k, src_v, dst_k, dst_v, pos, n)
        return
    if src_k.device.type != "cuda":
        raise ValueError(f"kv_write_back runs on CUDA or CPU tensors, got {src_k.device}")
    B, H, S, D = src_k.shape
    for name, t in (("src_v", src_v), ("dst_k", dst_k), ("dst_v", dst_v)):
        if t.shape != src_k.shape or t.dtype != src_k.dtype:
            raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)}, expected "
                             f"{src_k.dtype} {tuple(src_k.shape)}")
    for name, t in (("src_k", src_k), ("src_v", src_v), ("dst_k", dst_k),
                    ("dst_v", dst_v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if src_v.device != src_k.device:
        raise ValueError(f"src_v is on {src_v.device}, src_k on {src_k.device}")
    for name, t in (("pos", pos), ("n", n)):
        if t.shape != (B,) or t.dtype != torch.int32 or t.device != src_k.device:
            raise ValueError(f"{name} must be a ({B},) int32 tensor on {src_k.device}")
    row_bytes = D * src_k.element_size()
    if row_bytes % 16:
        raise ValueError(f"a row of {D} x {src_k.dtype} is {row_bytes} bytes, "
                         "not a multiple of 16")
    with torch.cuda.device(src_k.device):
        status = _lib().kv_stream_write_back_launch(
            src_k.data_ptr(), src_v.data_ptr(), dst_k.data_ptr(), dst_v.data_ptr(),
            pos.data_ptr(), n.data_ptr(), B, H, S, row_bytes,
            torch.cuda.current_stream(src_k.device).cuda_stream,
        )
    _build.check(status, "kv_stream")
    kv_write_back.launches += 1


#: launches of the write-back kernel since the last reset
kv_write_back.launches = 0


def copy_async(dst: torch.Tensor, src: torch.Tensor, stream: torch.cuda.Stream) -> None:
    """``dst <- src`` (same bytes; card or pinned host memory on either
    side) as one ``cudaMemcpyAsync`` on ``stream``."""
    nbytes = src.numel() * src.element_size()
    if dst.numel() * dst.element_size() != nbytes:
        raise ValueError(f"copy of {nbytes} bytes into {dst.numel() * dst.element_size()}")
    if not (src.is_contiguous() and dst.is_contiguous()):
        raise ValueError("copy_async takes contiguous tensors")
    _build.check(_lib().kv_stream_copy(dst.data_ptr(), src.data_ptr(), nbytes,
                                       stream.cuda_stream), "kv_stream")


def register(t: torch.Tensor) -> None:
    """Pin a contiguous CPU tensor's bytes in place, mapped for the card."""
    _build.check(_lib().kv_stream_host_register(
        t.data_ptr(), t.numel() * t.element_size()), "kv_stream")


def unregister(ptr: int) -> None:
    """Undo :func:`register` for the range that starts at ``ptr``."""
    _build.check(_lib().kv_stream_host_unregister(ptr), "kv_stream")
