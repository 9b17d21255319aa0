"""KV write-back into pinned host memory: the CUDA kernel and its wrapper.

No Pallas original: the reference leaves host<->device transfers to XLA.
Under a streamed host placement of the KV cache each layer computes on a
device staging window of its cache slab; :func:`kv_write_back` copies the
rows the step wrote there back into the slab in pinned host memory,
through the card's mapped view of it (``repro_torch/csrc/kv_stream.cu``,
whose header says what bounds it and how it is built).  The plain version
is :func:`repro_torch.kernels.ref.kv_write_back`; a CPU source takes it.
:func:`write_back_blocks` sizes the kernel's grid and
:func:`write_back_stores` says, in numpy, which thread stores which
16-byte chunk (``tests/test_torch_kv_stream_tiles.py`` holds it to the
plain version on the CPU).

The same library carries the host tier's plumbing, which is no kernel:
:func:`copy_async` (``cudaMemcpyAsync``, the window copies of a streamed
role, capturable in a CUDA graph), :func:`pinned_empty` (``cudaHostAlloc``,
the pinned arenas of :mod:`repro_torch.core.placement`), :func:`device_view` (the address
through which the card writes a tensor), :func:`mapped` (a CUDA tensor
over that address: a RESIDENT host placement's leaves, which the steps
compute on in place) and :func:`empty_launch` (a kernel
that does nothing: the launch floor).
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels import _build, ref

#: threads a block of ``write_back_kernel`` (``csrc/kv_stream.cu`` NT)
THREADS = 256
#: the grid has at most one block for every SMS_PER_BLOCK SMs (8 blocks on an
#: H100), and the kernel's loop strides past them: a prefill dispatch's
#: write-back runs beside the layers' kernels, which lose every SM and
#: thread it holds, and 8 blocks write within a few percent of what more do
SMS_PER_BLOCK = 16
#: rows a launch may have (``csrc/kv_stream.cu`` MAX_ROWS: each block keeps
#: every row's ring bounds in shared memory)
MAX_ROWS = 2048
#: bytes a thread stores at once
CHUNK_BYTES = 16

_fns = None


def _lib():
    global _fns
    if _fns is None:
        lib = _build.load("kv_stream")
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.kv_stream_write_back_launch.argtypes = [P] * 6 + [I] * 5 + [P]
        lib.kv_stream_device_view.argtypes = [P, ctypes.POINTER(P)]
        lib.kv_stream_empty_launch.argtypes = [I, P]
        lib.kv_stream_copy.argtypes = [P, P, L, P]
        lib.kv_stream_host_alloc.argtypes = [ctypes.POINTER(P), L]
        lib.kv_stream_host_free.argtypes = [P]
        for fn in (lib.kv_stream_write_back_launch, lib.kv_stream_device_view,
                   lib.kv_stream_empty_launch, lib.kv_stream_copy,
                   lib.kv_stream_host_alloc, lib.kv_stream_host_free):
            fn.restype = I
        _fns = lib
    return _fns


def write_back_blocks(chunks: int, sms: int) -> int:
    """The write-back kernel's grid for at most ``chunks`` 16-byte chunks:
    one chunk a thread in blocks of :data:`THREADS`, at most one block for
    every :data:`SMS_PER_BLOCK` of the card's ``sms``, at least one."""
    return max(1, min(-(-int(chunks) // THREADS), sms // SMS_PER_BLOCK))


def write_back_stores(pos, n, H: int, S: int, chunks: int, blocks: int) -> dict:
    """Every store the write-back kernel makes, in numpy, by its own
    arithmetic: one entry per surviving 16-byte chunk, in the order of the
    flat index ``g`` (row, keys then values, head, position, chunk) that the
    kernel strides over.  ``pos`` and ``n`` hold one entry a row.  Keys:
    ``block``, ``warp``, ``lane`` and ``step`` (the grid-stride iteration)
    of the thread that stores it; ``kv`` (0 keys, 1 values), ``b``, ``h``,
    ``slot`` and ``chunk`` of where it goes (and comes from)."""
    pos = np.asarray(pos, np.int64)
    n = np.asarray(n, np.int64)
    W = np.clip(n, 0, S)
    start = (pos + n - W) % S                 # floor modulo: in [0, S)
    run = W * chunks                          # chunks of one (head, k/v) run
    first = np.concatenate([[0], np.cumsum(2 * H * run)])
    g = np.arange(first[-1], dtype=np.int64)
    b = np.searchsorted(first, g, side="right") - 1
    u, e = np.divmod(g - first[b], run[b])
    j, c = np.divmod(e, chunks)
    slot = start[b] + j
    slot = np.where(slot >= S, slot - S, slot)
    kv = (u >= H).astype(np.int64)
    stride = blocks * THREADS
    thread = g % stride
    return dict(block=thread // THREADS, warp=thread % THREADS // 32, lane=thread % 32,
                step=g // stride, kv=kv, b=b, h=u - kv * H, slot=slot, chunk=c)


#: tensor -> (data_ptr, the card's view of it), kept while the tensor
#: lives; freeing a pinned block empties it
_views = WeakIdKeyDictionary()


def device_view(t: torch.Tensor) -> int:
    """The address through which the card writes ``t``'s bytes: its
    mapped address when ``t`` lies in pinned host memory, ``t.data_ptr()``
    for device memory.  Raises (a ``cudaError``) for pageable host memory.
    Resolved once per tensor (the view of a pinned range is fixed while it
    stays registered), so a step that writes the same slabs every time
    makes no pointer query after its first."""
    hit = _views.get(t)
    if hit is not None and hit[0] == t.data_ptr():
        return hit[1]
    out = ctypes.c_void_p()
    _build.check(_lib().kv_stream_device_view(t.data_ptr(), ctypes.byref(out)),
                 "kv_stream")
    _views[t] = (t.data_ptr(), out.value or 0)
    return out.value or 0


class _CudaArray:
    """The CUDA array interface of ``nbytes`` bytes at the card's address
    ``ptr``; it holds ``owner`` (the host tensor whose memory that is), and
    the tensor made from it holds this object."""

    def __init__(self, owner: torch.Tensor, ptr: int, nbytes: int):
        self._owner = owner
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "strides": None, "version": 2}


def mapped(t: torch.Tensor) -> torch.Tensor:
    """A ``uint8`` CUDA tensor over the bytes of ``t``, a contiguous tensor
    in pinned host memory, through the card's mapped view of them
    (:func:`device_view`): kernels and PyTorch's operators read and write
    it in place, over PCIe.  It (and every view of it) keeps ``t`` alive.
    Raises (a ``cudaError``) for pageable host memory, and for a tensor
    that is not on the CPU."""
    if t.device.type != "cpu" or not t.is_contiguous():
        raise ValueError(f"mapped() takes a contiguous host tensor, got one on {t.device}")
    nbytes = t.numel() * t.element_size()
    out = torch.as_tensor(_CudaArray(t, device_view(t), nbytes))
    if out.device.type != "cuda" or out.numel() != nbytes:
        raise RuntimeError(f"the mapped view of {nbytes} host bytes came back as "
                           f"{out.numel()} bytes on {out.device}")
    return out


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
    version; a CUDA source launches the kernel on the current stream, into
    :func:`device_view` of the slab (pageable host memory is refused)."""
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
    if row_bytes % CHUNK_BYTES:
        raise ValueError(f"a row of {D} x {src_k.dtype} is {row_bytes} bytes, "
                         "not a multiple of 16")
    if B > MAX_ROWS:
        raise ValueError(f"kv_write_back takes at most {MAX_ROWS} rows, got {B}")
    per_position = 2 * H * row_bytes // CHUNK_BYTES       # chunks of one position a row
    if B * S * per_position >= 2**30:
        raise ValueError(f"a ({B}, {H}, {S}) slab of {row_bytes}-byte rows has 2^30 "
                         "chunks or more")
    with torch.cuda.device(src_k.device):
        status = _lib().kv_stream_write_back_launch(
            src_k.data_ptr(), src_v.data_ptr(), device_view(dst_k), device_view(dst_v),
            pos.data_ptr(), n.data_ptr(), B, H, S, row_bytes,
            write_back_blocks(B * S * per_position, _build.sm_count(src_k.device)),
            torch.cuda.current_stream(src_k.device).cuda_stream,
        )
    _build.check(status, "kv_stream")
    kv_write_back.launches += 1


#: launches of the write-back kernel since the last reset
kv_write_back.launches = 0


def empty_launch(blocks: int = 1) -> None:
    """One launch of a kernel that does nothing (``blocks`` blocks of
    :data:`THREADS`) on the current stream: the launch floor a write-back
    launch is measured against."""
    _build.check(_lib().kv_stream_empty_launch(
        blocks, torch.cuda.current_stream().cuda_stream), "kv_stream")


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


class _PinnedBlock:
    """``nbytes`` of pinned host memory mapped for the card, seen by numpy
    (``__array_interface__``); freed when the last tensor over it dies."""

    def __init__(self, nbytes: int):
        self.ptr = None               # nothing to free if the allocation fails
        ptr = ctypes.c_void_p()
        _build.check(_lib().kv_stream_host_alloc(ctypes.byref(ptr), nbytes), "kv_stream")
        self.ptr = ptr.value
        self.__array_interface__ = {"data": (self.ptr, False), "shape": (nbytes,),
                                    "typestr": "|u1", "version": 3}

    def __del__(self):
        if sys.is_finalizing() or self.ptr is None:   # the process's end releases it
            return
        _views.clear()                # no resolved view outlives its block
        _build.check(_lib().kv_stream_host_free(self.ptr), "kv_stream")


def pinned_empty(nbytes: int) -> torch.Tensor:
    """A ``uint8`` CPU tensor of exactly ``nbytes`` (at least 1) in pinned
    host memory mapped for the card (``cudaHostAlloc``, where PyTorch's
    pinned allocator rounds a request up to a power of two); the memory is
    freed when the tensor and every view of it are gone."""
    return torch.from_numpy(np.asarray(_PinnedBlock(max(int(nbytes), 1))))
