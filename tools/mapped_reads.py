"""In-place reads of pinned host memory on one card, by how it was pinned.

    python3 tools/mapped_reads.py

A RESIDENT host placement's kernels read pinned host memory through the
card's mapped view of it.  This times, with CUDA events, three readers of
the same bytes in device memory, in ``cudaHostAlloc`` memory (what the
port's host arenas are: ``kv_stream.pinned_empty``) and in pageable memory
pinned in place by ``cudaHostRegister`` (what they were before):

* ``membench.stream_read`` of 1 GiB (a streaming read, the calibration's
  PCIe term);
* ``flash_decode`` at yi-6b's serving shape (8 rows, 4 KV heads, 2048
  slots, D 128, bf16): ragged lengths, and every row full;
* a bf16 GEMM against a 4096 x 11008 weight (yi-6b's MLP) at M = 8 (a
  decode step's rows), 64 and 2048 (a prefill dispatch's).

Prints one line per reader and memory with its ms and the GB/s of the
bytes the function must read (the live keys; the weight once), and the
card's name and power limit.  Needs the card.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.kernels import kv_stream, membench  # noqa: E402
from repro_torch.kernels.decode_attention import flash_decode  # noqa: E402


def ms(fn, n=5):
    """Mean milliseconds of ``n`` calls after one, on the card's clock."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def copies(t: torch.Tensor) -> dict:
    """``t`` in device memory, and in host memory pinned each way, as CUDA
    tensors over the card's view (the same bytes in each)."""
    host = t.cpu().contiguous().view(torch.uint8).view(-1)
    alloc = kv_stream.pinned_empty(host.numel())
    alloc.copy_(host)
    pageable = host.clone()
    err = torch.cuda.cudart().cudaHostRegister(pageable.data_ptr(), pageable.numel(), 2)
    if int(err) != 0:
        raise RuntimeError(f"cudaHostRegister failed: {err}")

    def view(b):
        return kv_stream.mapped(b).view(t.dtype).view(t.shape)

    return {"device": t, "cudaHostAlloc": view(alloc), "cudaHostRegister": view(pageable)}


def main() -> int:
    if not torch.cuda.is_available():
        print("mapped_reads: needs the card", file=sys.stderr)
        return 2
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = 1 << 28
    x = torch.ones(n, dtype=torch.float32, device="cuda")
    for name, t in copies(x).items():
        t_ms = ms(lambda: membench.stream_read(t), 3)
        print(f"stream_read 1 GiB, {name}: {t_ms:.4f} ms = {n * 4 / t_ms / 1e6:.2f} GB/s",
              flush=True)
    del x
    B, Hq, Hkv, D, S = 8, 32, 4, 128, 2048
    lens = [100, 2048, 7, 1500, 64, 900, 1, 2047]
    q = torch.randn(B, Hq, D, generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(B, Hkv, S, D, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    ragged = torch.tensor(lens, dtype=torch.int32, device="cuda")
    full = torch.full((B,), S, dtype=torch.int32, device="cuda")
    per_pos = Hkv * D * 2 * 2
    kc, vc = copies(k), copies(v)
    for name in kc:
        a = ms(lambda: flash_decode(q, kc[name], vc[name], ragged))
        f = ms(lambda: flash_decode(q, kc[name], vc[name], full))
        print(f"flash_decode, {name}: ragged {a:.4f} ms = {sum(lens) * per_pos / a / 1e6:.2f} "
              f"GB/s, full {f:.4f} ms = {B * S * per_pos / f / 1e6:.2f} GB/s", flush=True)
    w = torch.randn(4096, 11008, generator=gen, device="cuda").to(torch.bfloat16)
    wc = copies(w)
    for M in (8, 64, 2048):
        xa = torch.randn(M, 4096, generator=gen, device="cuda").to(torch.bfloat16)
        for name, ww in wc.items():
            t_ms = ms(lambda: xa @ ww, 3)
            print(f"matmul M={M} x 4096 x 11008, weight in {name}: {t_ms:.4f} ms = "
                  f"{w.numel() * 2 / t_ms / 1e6:.2f} GB/s of weight bytes", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
