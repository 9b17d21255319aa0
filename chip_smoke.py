#!/usr/bin/env python3
"""Drive the port's serving, training and measurement paths on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card

Phases, in order; any failure raises and the script exits non-zero:

1. device and build — the card's name and power limit, the torch/CUDA
   versions, and an ``nvcc`` build of every ``src/repro_torch/csrc/*.cu``,
   with ``-Xptxas -v``'s registers, spills and shared memory for each
   kernel of ``flash_attention.cu``, ``prefill_attention.cu``,
   ``blocked_matmul.cu``, ``decode_attention.cu`` and ``ssd_scan.cu``;
2. each CUDA kernel against its plain PyTorch version on the card, in
   bfloat16 and float32.  Serving kernels at the serving path's shapes
   (yi-6b: 8 slots, 32/4 heads, head dim 128, 2048 cache slots, 256-token
   chunks), at G = 1 (olmo-1b: 16/16 heads) and at the smoke head dim,
   with ragged lengths, tails off the tile, cache holes and rows that
   write nothing; decode also at lengths around its 64-key tile, at G = 16
   and with two calls in a row bit-identical.  The training attention
   kernel, forward and backward (against ``torch.autograd.grad`` through
   the plain version), at the olmo-1b training shape (4, 16, 2048, 128), a
   yi-6b GQA shape, the sliding / chunked / bidirectional masks with
   ``q_offset > 0`` and ``Sq != Sk``, the smoke head dim and a length off
   the tile;
3. smoke parity on the card and on the CPU from the same weights:
   yi-6b-smoke and granite-8b-smoke in float32 through ``Server`` (the
   card's through its CUDA graphs; greedy tokens identical per request),
   then olmo-1b-smoke and yi-6b-smoke in float32 for 3 AdamW steps of the
   same batches (losses and grad norms within tolerance);
4. serving: full-width, full-depth yi-6b in bfloat16, weights drawn on the
   card from a seeded generator: 16 requests (prompts of 128-1536 tokens,
   64 new tokens each) through 8 slots, the server's decode step and
   prefill dispatch captured as CUDA graphs and replayed, each kernel's
   launches (launches per replay, counted at capture, x replays) checked
   against 32 x the decode steps or prefill dispatches; then the same
   requests through an eager server on the same weights, greedy tokens
   identical for every request, both runs' tok/s printed;
   (4b) granite-8b at full width and depth (36 layers, 8.05 B params) the
   same way, its first 4 requests also through an eager server;
5. times at the phase 4 shapes: each kernel, its plain version, the
   PyTorch library call for the same function (a yardstick the port never
   calls), and the least time the card could take, with the prefill
   kernel's TFLOP/s, its fraction of the operation bound and its ratio to
   SDPA; then ``torch.profiler`` windows over a few full-batch decode
   steps and one prefill dispatch, graph replays and then eager (wall
   time, device-busy share, the kernels that take the device time; a
   replay's kernel launches confirmed from the trace);
6. training: full-width, full-depth olmo-1b in bfloat16 through
   ``repro_torch.launch.train`` (weights from a seeded generator on the
   card, ``remat="full"``, batch 4 x 2048 tokens of ``SyntheticLM`` seed
   0, AdamW steps under ``Supervisor.run``): finite losses and grad norms,
   no restart, and 2 x 16 forward and 16 backward attention launches per
   step; step time, training tokens/s, peak memory, and a
   ``torch.profiler`` window over one more step;
7. times of the training attention kernels at the phase 6 shape, beside
   their plain versions, SDPA and their bounds, with each one's TFLOP/s,
   its fraction of the operation bound and its ratio to SDPA;
8. Mamba-2 serving.  (a) the SSD scan kernel against its plain versions
   (the chunked oracle and the literal recurrence) in bfloat16 and float32
   at the mamba2-780m serving shape (B 8, T 256, H 48, P 64, N 128) with a
   nonzero initial state, at zamba2-1.2b's (H 64, P 64, N 64), at ragged T
   (1, 100, 257), with rows whose dt is 0 past a per-row length and a row
   whose dt is 0 throughout (its state must come back bit for bit);
   (b) mamba2-smoke and zamba2-smoke in float32 through ``Server``, card
   against CPU, with a slot reused by a 1-token prompt; (c) full-width,
   full-depth mamba2-780m in bfloat16 serving phase 4's 16 requests
   through the graphs and then eagerly, tokens identical
   (``ssd_scan`` launches = 48 x prefill dispatches); (d) full-depth
   zamba2-1.2b with 8 requests the same way (per prefill dispatch 32
   scans and 6 prefill-attention launches, 6 decode-attention launches
   per step); (e) the scan's times at (c)'s shape and ``torch.profiler``
   windows over one mamba2 prefill dispatch and a few decode steps,
   graph replays and then eager;
9. the paper's single-GPU study.  (a) ``blocked_matmul`` against its plain
   version in bfloat16 and float32 at the reference test's three shapes,
   4096^3 in both output dtypes and a non-square shape, and a tiling with
   no instantiation refused; (b) the GEMM study through
   ``repro_torch.benchmarks.bench_gemm`` (N = 16384 bf16, N = 8192 f32,
   every tiling, ``torch.matmul`` beside it) with the kernel's launches
   counted and each tiling's TFLOP/s at N = 16384 bf16 beside
   ``torch.matmul``'s, then every call it timed (each tiling at N = 16384 bf16 and
   N = 8192 f32, on the study's own inputs) against its plain version, and
   the kernel's times at N = 16384; (c) ``bench_membw``, ``bench_copy``, ``bench_latency`` and
   ``bench_managed_vs_system`` on device memory and pinned host memory
   read in place, with sizes past the 50 MB L2, the membench kernels'
   launches counted, each held against its plain version and timed;
   (d) ``repro_torch.launch.calibrate`` on the card: ``build/
   calibration.json``, the spec-vs-measured summary and the replay error
   per term, a measured HBM bandwidth at most 1.05 x the spec, NVLink and
   InfiniBand terms left at ``spec``, each regime's spec-sheet and
   calibrated planner picks; (e) ``bench_llm_inference`` (the analytic leg
   and the serve leg at smoke scale through the graphs, written to
   ``build/BENCH_serve.json``) and ``bench_datapath_bounds``; then the
   planner's yi-6b decode step at phase 4's shape, on the spec sheet and
   the calibration, beside phase 4's measured step (information only).

The last three lines are the ``kernels`` JSON record, ``nvidia-smi``'s
name and power limit, and the device JSON.
Exits non-zero, printing no result, without a CUDA card or outside a
checkout of the repository.
"""

from __future__ import annotations

import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))


def peaks():
    """(device-memory bytes/s, bf16 tensor-core flops/s, f32 CUDA-core
    flops/s): the H100 data sheet's dense peaks, read from the port's
    hardware model so the kernel bounds and the model have one source."""
    from repro_torch.core.hardware import SPEC_SYSTEM

    c = SPEC_SYSTEM.chip
    return (c.hbm_bandwidth, c.peak_flops_by_dtype["bfloat16"],
            c.peak_flops_by_dtype["float32"])


#: elementwise limit |got - want| <= atol + rtol |want|, and a limit on each
#: output row's max error relative to that row's RMS in the plain version.
#: Random q/k/v give rows with RMS ~ 1/sqrt(live keys) (0.03 at 2048 keys),
#: so the row limit is what keeps a bf16 check meaningful on long rows; a
#: one-ulp bf16 rounding difference is under 0.01 x |element| <= 0.04 x RMS.
TOL = {"bfloat16": dict(atol=1e-2, rtol=1e-2, row=0.1),
       "float32": dict(atol=3e-5, rtol=1e-5, row=1e-3)}

#: gradients of the training attention kernel: f32 sums over up to 2048
#: terms in another order (f32); bf16 products take P and dS rounded to
#: bf16, as FlashAttention-2 does (bf16).  Same elementwise and row-RMS
#: form as TOL, but a row's RMS is floored at the median row RMS: some
#: gradient rows are 0 in exact arithmetic (causal query 0 sees only key 0,
#: so its dS is 0) and keep a rounding-level error that does not shrink
#: with them.  In bf16 a row's error may also exceed the limit by one ulp
#: of its largest element (<= 2^-7 of it): both sides round f32 gradients
#: that differ in the last bits, and a rounding flip on a row's largest
#: element is one ulp there.
GRAD_TOL = {"bfloat16": dict(atol=3e-2, rtol=3e-2, row=0.1, floor="median",
                             ulp=2.0 ** -7),
            "float32": dict(atol=1e-4, rtol=1e-4, row=1e-3, floor="median")}

#: main-path shapes (yi-6b serving: ServeConfig(8, 2048, 256))
YI = dict(B=8, Hq=32, Hkv=4, D=128, Smax=2048, chunk=256)

#: training path (olmo-1b, batch 4 x 2048 tokens, 16/16 heads, head dim 128)
OLMO_TRAIN = dict(B=4, Hq=16, Hkv=16, S=2048, D=128, steps=4)

#: Mamba-2 serving path (mamba2-780m: ServeConfig(8, 2048, 256), 48 SSD
#: heads of P 64, state N 128) and zamba2-1.2b's SSD widths
MAMBA = dict(B=8, T=256, H=48, P=64, N=128)
ZAMBA = dict(H=64, P=64, N=64)

#: the SSD scan's y: bf16 as TOL (the kernel and the plain version round
#: the same f32 sums, taken in other orders, once to bf16); f32 sums over
#: up to 256 positions and 128 state entries of O(10) terms in other
#: orders, and chunked at 32 against the plain version's 64-256, so its
#: f32 limit is 1e-4 (row 1e-3 x RMS).  The f32 state is held to 1e-4 x the
#: leaf's max |value| (the scale-aware bound of the reference's
#: tests/test_serve_fastpath.py).
SSD_TOL = {"bfloat16": TOL["bfloat16"],
           "float32": dict(atol=1e-4, rtol=1e-4, row=1e-3)}

#: blocked_matmul against ref.matmul.  9a draws a ~ N(0, 1) and b ~ N(0, 1)
#: / sqrt(K), so outputs have RMS ~1: an f32 output is the same products
#: (a bf16 product is exact in f32) summed over K in another order, held to
#: 1e-4 elementwise and a row's max error to 1e-3 x its RMS; a bf16 output
#: is one rounding of those sums, TOL's bf16 limits (one ulp is under
#: 2^-7 |element|).  9b's study inputs (bench_gemm.inputs) are scaled the
#: same way.
GEMM_TOL = {"bfloat16": TOL["bfloat16"],
            "float32": dict(atol=1e-4, rtol=1e-4, row=1e-3)}

#: the GEMM study's size on the card (bench_gemm: N = 16384, bf16)
GEMM_N = 16384


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def check_close(name, got, want, dtype_name, rows=None, tols=TOL):
    """Max abs error of ``got`` vs ``want`` over output rows (the last dim;
    optionally only the rows a mask selects); raises if any element is
    outside the elementwise tolerance or any row's max error exceeds the
    row limit times that row's RMS in ``want``."""
    import torch

    g, w = got.float(), want.float()
    if rows is not None:
        g, w = g[rows], w[rows]
    g, w = g.reshape(-1, g.shape[-1]), w.reshape(-1, w.shape[-1])
    tol = tols[dtype_name]
    err = (g - w).abs()
    bad = err > tol["atol"] + tol["rtol"] * w.abs()
    rms = w.square().mean(-1).sqrt()
    if tol.get("floor") == "median":
        rms = rms.clamp(min=float(rms.median()))
    row_err = err.amax(-1) - tol.get("ulp", 0.0) * w.abs().amax(-1)
    rel = row_err.clamp(min=0) / rms.clamp(min=1e-30)
    worst = int(rel.argmax())
    max_err = float(err.max())
    log(f"  {name}: max_abs_err {max_err:.3e} (atol {tol['atol']}, rtol "
        f"{tol['rtol']}); want's row RMS{' (floored at the median)' if 'floor' in tol else ''}"
        f" min {float(rms.min()):.3e} median "
        f"{float(rms.median()):.3e}; worst row err/RMS {float(rel.max()):.3e} "
        f"(limit {tol['row']}; row {worst}: max err {float(err[worst].max()):.3e}, "
        f"max |want| {float(w[worst].abs().max()):.3e}, RMS {float(rms[worst]):.3e}"
        f"{', less one ulp of its largest element' if 'ulp' in tol else ''})")
    if not torch.isfinite(g).all() or bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements out of tolerance")
    if bool((rel > tol["row"]).any()):
        raise AssertionError(f"{name}: {int((rel > tol['row']).sum())} rows with "
                             f"max error over {tol['row']} x their RMS")
    return max_err


# ---------------------------------------------------------------------------
# inputs at a given shape
# ---------------------------------------------------------------------------

def decode_inputs(B, Hq, Hkv, D, Smax, lengths, dtype, gen, copies=1):
    import torch

    dev = "cuda"
    q = torch.randn(B, Hq, D, generator=gen, device=dev).to(dtype)
    kv = [
        (torch.randn(B, Hkv, Smax, D, generator=gen, device=dev).to(dtype),
         torch.randn(B, Hkv, Smax, D, generator=gen, device=dev).to(dtype))
        for _ in range(copies)
    ]
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kv, lens


def prefill_positions(offsets, new_lens, Sc, Sn, holes=()):
    """q_pos (B, Sn) and k_pos (B, Sc + Sn) as the model builds them for
    a non-ring cache: slot r holds position r below the row's offset, the
    chunk's entries past new_lens are holes; ``holes`` punches extra
    (row, slot) holes into the cache part."""
    import torch

    dev = "cuda"
    off = torch.tensor(offsets, dtype=torch.int32, device=dev)[:, None]
    nl = torch.tensor(new_lens, dtype=torch.int32, device=dev)[:, None]
    j = torch.arange(Sn, dtype=torch.int32, device=dev)[None, :]
    r = torch.arange(Sc, dtype=torch.int32, device=dev)[None, :]
    q_pos = off + j
    kpos_cache = torch.where(r < off, r, -1)
    for b, slot in holes:
        kpos_cache[b, slot] = -1
    kpos_new = torch.where(j < nl, q_pos, -1)
    return q_pos.contiguous(), torch.cat([kpos_cache, kpos_new], 1).contiguous()


def live_mask(q_pos, k_pos, kind="causal", window=0, chunk=0):
    qp, kp = q_pos[:, :, None], k_pos[:, None, :]
    m = (qp >= kp) & (kp >= 0)
    if kind == "sliding":
        m &= (qp - kp) < window
    elif kind == "chunked":
        m &= (qp // chunk) == (kp // chunk)
    return m                                            # (B, Sq, Sk)


def prefill_inputs(B, Hq, Hkv, D, Sc, Sn, dtype, gen, copies=1):
    import torch

    dev = "cuda"
    q = torch.randn(B, Hq, Sn, D, generator=gen, device=dev).to(dtype)
    srcs = []
    for _ in range(copies):
        srcs.append(tuple(
            torch.randn(B, Hkv, S, D, generator=gen, device=dev).to(dtype)
            for S in (Sc, Sc, Sn, Sn)
        ))
    return q, srcs


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    import torch
    from repro_torch.kernels import _build

    log("== phase 1: device and build")
    log(f"  nvidia-smi: {nvidia_smi()}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libs = _build.build()
    log(f"  built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, (_, out) in sorted(_build.BUILD_LOG.items()):
        if name in PTXAS_NAMED:
            log_ptxas(name, out)
            continue
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


#: the libraries whose kernels phase 1 logs by name and template arguments
PTXAS_NAMED = ("flash_attention", "prefill_attention", "blocked_matmul",
               "decode_attention", "ssd_scan")


def log_ptxas(lib, out):
    """Each kernel of ``csrc/<lib>.cu`` as ``nvcc -Xptxas -v`` saw it:
    registers, spill stores and loads, static shared memory, and for the
    kernels that take dynamic shared memory what they launch with (the
    prefill kernel at the main path's Sc + Sn = 2304 keys, the scan at the
    serving shape's heads per block)."""
    import re

    from repro_torch.kernels import decode_attention, ssd_scan
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.blocked_matmul import traffic_model
    from repro_torch.kernels.flash_attention import prefill_smem_bytes, smem_footprint_bytes

    fa_dynamic = {"fa_fwd_mma_kernel": "fwd", "fa_bwd_dq_mma_kernel": "bwd_dq",
                  "fa_bwd_dkdv_mma_kernel": "bwd_dkdv"}

    def dynamic(kernel, args):
        if kernel in fa_dynamic:
            return smem_footprint_bytes(int(args[-1]))[fa_dynamic[kernel]]
        if kernel == "prefill_mma_kernel":
            return prefill_smem_bytes(int(args[0]), YI["Smax"] + YI["chunk"])
        if kernel in ("mm_wgmma_kernel", "mm_fma_kernel"):
            t = tuple(int(a) for a in args[:3])
            return traffic_model(*t, *t, itemsize=2 if kernel == "mm_wgmma_kernel" else 4)[
                "smem_bytes"]
        if kernel == "decode_mma_kernel":
            return decode_attention.smem_bytes(int(args[0]))
        if kernel == "ssd_mma_kernel":
            P, N = int(args[0]), int(args[1])
            m = MAMBA
            return ssd_scan.smem_bytes(P, N, ssd_scan.heads_per_block(
                m["B"], m["H"], P, sm_count(0)))
        return None

    name, spill = None, ""
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            # mangled kernel<T, D...>: "...fa_fwd_mma_kernelILi128EEEvPK..."
            k = re.search(r"(prefill_mma_kernel|prefill_kernel|mm_wgmma_kernel|mm_fma_kernel"
                          r"|decode_mma_kernel|decode_fma_kernel|ssd_mma_kernel|ssd_fma_kernel"
                          r"|fa_\w+?_kernel)I(.*?)EEv",
                          m.group(1))
            args = ["bf16" if t.startswith("13") else "f32" if t == "f" else t[2:-1]
                    for t in re.findall(r"13__nv_bfloat16|Li\d+E|f", k.group(2))] if k else []
            name = (k.group(1), args) if k else None
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            smem = re.search(r"(\d+) bytes smem", line)
            dyn = dynamic(*name)
            extra = "" if dyn is None else f", {int(dyn)} B dynamic smem"
            log(f"  ptxas {lib} {name[0]}<{','.join(name[1])}>: {regs} registers; {spill}; "
                f"{smem.group(1) if smem else 0} B static smem{extra}")
            name = None


def phase_kernels():
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import flash_decode
    from repro_torch.kernels.flash_attention import flash_prefill

    log("== phase 2: kernels against their plain versions on the card")
    gen = torch.Generator(device="cuda").manual_seed(1)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        # -- decode: main path, G=1, smoke head dim -----------------------
        y = YI
        cases = [
            ("yi", y["B"], y["Hq"], y["Hkv"], y["D"], y["Smax"],
             [1, 2048, 1000, 37, 64, 65, 1999, 513]),
            ("olmo", 4, 16, 16, 128, 1000, [1, 999, 1000, 333]),
            ("smoke", 3, 8, 1, 16, 64, [1, 17, 64]),
            # lengths around the 64-key tile and its splits; G = 16
            ("yi-edges", y["B"], y["Hq"], y["Hkv"], y["D"], y["Smax"],
             [1, 63, 64, 65, 2048, 129, 1, 640]),
            ("g16", 4, 32, 2, 128, 1500, [1500, 777, 129, 5]),
        ]
        for tag, B, Hq, Hkv, D, Smax, lens in cases:
            q, kv, L = decode_inputs(B, Hq, Hkv, D, Smax, lens, dtype, gen)
            k, v = kv[0]
            got = flash_decode(q, k, v, L)
            torch.cuda.synchronize()
            want = ref.decode_attention(q, k, v, L)
            e = check_close(f"decode {tag} {dn} B{B} Hq{Hq} Hkv{Hkv} D{D} Smax{Smax}",
                            got, want, dn)
            if tag == "yi":
                errs[("decode", dn)] = e
                if not torch.equal(got, flash_decode(q, k, v, L)):
                    raise AssertionError("decode: two calls in a row differ")
                log(f"  decode {tag} {dn}: two calls in a row bit-identical")
        # -- prefill: main path (two sources), G=1, smoke, mask kinds ------
        Sc, Sn = y["Smax"], y["chunk"]
        pcases = [
            ("yi", y["B"], y["Hq"], y["Hkv"], y["D"], Sc, Sn,
             [0, 256, 1792, 777, 1, 0, 1500, 1024],
             [256, 256, 256, 100, 0, 1, 256, 0], "causal", {}),
            ("olmo", 2, 16, 16, 128, 600, 40, [0, 561], [40, 23], "causal", {}),
            ("smoke", 3, 8, 1, 16, 64, 4, [5, 0, 60], [4, 0, 3], "causal", {}),
            ("sliding", 2, 8, 2, 64, 300, 48, [100, 200], [48, 30],
             "sliding", {"window": 64}),
            ("chunked", 2, 8, 2, 64, 300, 48, [100, 200], [48, 30],
             "chunked", {"chunk": 96}),
        ]
        for tag, B, Hq, Hkv, D, Sc_, Sn_, offs, nls, kind, kw in pcases:
            q, srcs = prefill_inputs(B, Hq, Hkv, D, Sc_, Sn_, dtype, gen)
            kc, vc, kn, vn = srcs[0]
            holes = [(0, 3), (B - 1, max(offs[-1] - 2, 0))]
            q_pos, k_pos = prefill_positions(offs, nls, Sc_, Sn_, holes)
            got = flash_prefill(q, kc, vc, q_pos, k_pos, k_new=kn, v_new=vn,
                                kind=kind, **kw)
            torch.cuda.synchronize()
            want = ref.prefill_attention(
                q, torch.cat([kc, kn], 2), torch.cat([vc, vn], 2), q_pos, k_pos,
                kind=kind, **kw,
            )
            # rows with no live key are padding: the kernel gives 0, the
            # plain version mean(V); both sides discard them
            rows = live_mask(q_pos, k_pos, kind, **kw).any(-1)      # (B, Sq)
            rows = rows[:, None, :].expand(B, Hq, Sn_)
            e = check_close(f"prefill {tag} {dn} B{B} Hq{Hq} Hkv{Hkv} D{D} "
                            f"Sc{Sc_} Sn{Sn_} {kind}", got, want, dn, rows)
            if tag == "yi":
                errs[("prefill", dn)] = e
        # one-source signature (the reference's): same numbers
        q, srcs = prefill_inputs(2, 8, 2, 32, 50, 10, dtype, gen)
        kc, vc, kn, vn = srcs[0]
        q_pos, k_pos = prefill_positions([20, 45], [10, 5], 50, 10)
        one = flash_prefill(q, torch.cat([kc, kn], 2).contiguous(),
                            torch.cat([vc, vn], 2).contiguous(), q_pos, k_pos)
        two = flash_prefill(q, kc, vc, q_pos, k_pos, k_new=kn, v_new=vn)
        torch.cuda.synchronize()
        if not torch.equal(one, two):
            raise AssertionError("one-source and two-source prefill disagree")
        log(f"  prefill one-source == two-source ({dn})")
    return errs


def phase_smoke_parity():
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.models.model_zoo import ModelBundle
    from repro_torch.models.sharding import tree_map
    from repro_torch.serve import Request, ServeConfig, Server

    log("== phase 3: yi-6b-smoke and granite-8b-smoke float32, card (CUDA graphs) "
        "against CPU")
    for arch in ("yi-6b", "granite-8b"):
        cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
        bundle = ModelBundle(cfg)
        params_cpu = bundle.init_params(torch.Generator().manual_seed(0))
        params_gpu = tree_map(lambda t: t.to("cuda"), params_cpu)
        rng = np.random.default_rng(2)
        prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32)
                   for n in (9, 14, 3, 6, 11)]
        tokens = {}
        for dev, params in (("cuda", params_gpu), ("cpu", params_cpu)):
            server = Server(bundle, ServeConfig(batch_slots=2, max_len=64,
                                                prefill_chunk=4), params, device=dev)
            reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
                    for i, p in enumerate(prompts)]
            server.add_requests(reqs)
            server.run_until_done(max_steps=300)
            assert all(r.done and len(r.out_tokens) == 6 for r in reqs), dev
            tokens[dev] = {r.rid: r.out_tokens for r in reqs}
            if dev == "cuda" and not server.engine.counters["decode_replays"]:
                raise AssertionError("the card's server replayed no decode graph")
        if tokens["cuda"] != tokens["cpu"]:
            raise AssertionError(f"{arch}: card/CPU greedy tokens differ: {tokens}")
        log(f"  {cfg.name}: greedy tokens identical for {len(prompts)} requests: "
            f"{tokens['cuda']}")


def serve_requests(bundle, params, scfg, prompts, new_tokens, *, eager=False):
    """Serve greedy requests through ``Server`` on the card.  The kernels'
    counts are reset just before the server is built, so its warm-up and
    capture belong to the run.  Returns (server, requests, wall seconds,
    launches): for a graphed server each kernel's launches per replay x
    the replays of its graph, for an eager one the wrappers' counts."""
    import torch
    from repro_torch.serve import Request, Server
    from repro_torch.serve.engine import KERNELS

    for fn in KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    server = Server(bundle, scfg, params, device="cuda", eager=eager)
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    reqs = [Request(rid=i, prompt=p, max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    server.add_requests(reqs)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng, c = server.engine, server.engine.counters
    vocab = bundle.cfg.vocab
    for r in reqs:
        if not r.done or len(r.out_tokens) != new_tokens:
            raise AssertionError(f"request {r.rid}: done={r.done}, "
                                 f"{len(r.out_tokens)} tokens")
        if not all(0 <= t < vocab for t in r.out_tokens):
            raise AssertionError(f"request {r.rid}: token out of range")
    if eager:
        launches = {name: fn.launches for name, fn in KERNELS.items()}
        if c["decode_replays"] or c["prefill_replays"]:
            raise AssertionError(f"an eager server replayed graphs: {c}")
    else:
        if (c["decode_replays"], c["prefill_replays"]) != (
                c["decode_steps"], c["prefill_dispatches"]):
            raise AssertionError(f"replays differ from steps and dispatches: {c}")
        launches = dict.fromkeys(KERNELS, 0)
        for phase in ("decode", "prefill"):
            for name, n in eng.graph_launches[phase].items():
                launches[name] += n * c[f"{phase}_replays"]
    tp = server.throughput()
    log(f"  {'eager' if eager else 'graphs'}: served {len(reqs)} requests in {wall:.2f} s "
        f"(server built in {built:.2f} s): {c['decode_steps']} decode steps, "
        f"{c['prefill_dispatches']} prefill dispatches, {c['decode_replays']} + "
        f"{c['prefill_replays']} graph replays; kernel launches {launches}"
        + ("" if eager else f" ({eng.graph_launches} per replay)"))
    log(f"  {'eager' if eager else 'graphs'}: prefill {tp['prefill_tokens']} tokens at "
        f"{tp['prefill_tps']:.1f} tok/s, decode {tp['decode_tokens']} tokens at "
        f"{tp['decode_tps']:.1f} tok/s; decode step EWMA "
        f"{eng.measured_step_s * 1e3:.2f} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return server, reqs, wall, launches


def same_tokens(label, a, b):
    """Greedy tokens per request identical between two runs."""
    diff = [r.rid for r, q in zip(a, b) if r.out_tokens != q.out_tokens]
    if diff:
        raise AssertionError(f"{label}: graph and eager tokens differ for requests {diff}")
    log(f"  {label}: greedy tokens identical, graphs against eager, for all "
        f"{len(b)} requests compared")


def check_logits(bundle, params, server, rows):
    """The logits behind the served tokens are finite (one more step on the
    served caches, eager and uncounted)."""
    import torch

    logits, _ = bundle.decode_step(
        params,
        {"tokens": torch.zeros(rows, 1, dtype=torch.int32, device="cuda"),
         "lengths": torch.full((rows,), 1600, dtype=torch.int32, device="cuda")},
        server.engine.caches,
    )
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite logits")


def dense_prompts(vocab, n=16):
    """Phase 4's requests: ``n`` prompts of 128-1536 tokens, numpy seed 0."""
    import numpy as np

    rng = np.random.default_rng(0)
    plens = rng.integers(128, 1537, size=n)
    return [rng.integers(0, vocab, k).astype(np.int32) for k in plens], plens


def phase_full():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import ModelBundle
    from repro_torch.serve import ServeConfig

    cfg = get_config("yi-6b")
    log(f"== phase 4: {cfg.name} bfloat16, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.attention.n_heads}/{cfg.attention.n_kv_heads} heads, "
        "through the CUDA graphs, then eager")
    bundle = ModelBundle(cfg)
    t0 = time.perf_counter()
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"  weights drawn on the card in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    scfg = ServeConfig(batch_slots=YI["B"], max_len=YI["Smax"],
                       prefill_chunk=YI["chunk"])
    prompts, plens = dense_prompts(cfg.vocab)
    server, reqs, _, launches = serve_requests(bundle, params, scfg, prompts, 64)
    st = server.stats()
    L = cfg.n_layers
    if launches["decode_attention"] != L * st["decode_steps"]:
        raise AssertionError(f"decode launches {launches} != {L} x {st['decode_steps']}")
    if launches["prefill_attention"] != L * st["prefill_dispatches"]:
        raise AssertionError(
            f"prefill launches {launches} != {L} x {st['prefill_dispatches']}")
    check_logits(bundle, params, server, YI["B"])
    eager, ereqs, _, elaunches = serve_requests(bundle, params, scfg, prompts, 64,
                                                eager=True)
    est = eager.stats()
    if elaunches["decode_attention"] != L * est["decode_steps"]:
        raise AssertionError(f"eager decode launches {elaunches}")
    same_tokens(cfg.name, reqs, ereqs)
    return launches, st, [int(n) for n in plens], server, eager


def phase_granite_full():
    """4b: granite-8b at full width and depth through the graphs: phase
    4's 16 requests, launch counts checked; its first 4 requests also
    through an eager server, greedy tokens identical."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import ModelBundle
    from repro_torch.serve import ServeConfig

    cfg = get_config("granite-8b")
    log(f"== phase 4b: {cfg.name} bfloat16, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.attention.n_heads}/{cfg.attention.n_kv_heads} heads, "
        f"{cfg.num_params() / 1e9:.2f} B params, through the CUDA graphs")
    bundle = ModelBundle(cfg)
    t0 = time.perf_counter()
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"  weights drawn on the card in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    scfg = ServeConfig(batch_slots=YI["B"], max_len=YI["Smax"], prefill_chunk=YI["chunk"])
    prompts, _ = dense_prompts(cfg.vocab)
    server, reqs, _, launches = serve_requests(bundle, params, scfg, prompts, 64)
    st, L = server.stats(), cfg.n_layers
    want = {"decode_attention": L * st["decode_steps"],
            "prefill_attention": L * st["prefill_dispatches"], "ssd_scan": 0}
    if launches != want:
        raise AssertionError(f"granite-8b launches {launches} != {want}")
    check_logits(bundle, params, server, YI["B"])
    del server
    torch.cuda.empty_cache()
    eager, ereqs, _, _ = serve_requests(bundle, params, scfg, prompts[:4], 64, eager=True)
    same_tokens(cfg.name, reqs[:4], ereqs)
    del eager, params
    torch.cuda.empty_cache()


#: the serving kernels' names in a profiler trace, by wrapper name
TRACE_NAMES = {"decode_attention": "decode_mma_kernel",
               "prefill_attention": "prefill_mma_kernel", "ssd_scan": "ssd_mma_kernel"}


def expected_trace(server, graph):
    """The kernel launches one call of ``graph``'s step makes, by trace
    name: what the Executor counted at capture (None for an eager server)."""
    eng = server.engine
    if not eng.graphed:
        return None
    return {TRACE_NAMES[k]: n for k, n in eng.graph_launches[graph].items()}


def profile_decode(servers, steps=4):
    """Where a full-batch decode step's time goes: ``torch.profiler`` over
    a few steady steps of 8 fresh requests (after their admission), for
    each server (graph replays, then eager)."""
    import numpy as np

    for label, server in servers.items():
        rng = np.random.default_rng(1)
        for i in range(server.cfg.batch_slots):
            server.submit(rng.integers(0, server.bundle.cfg.vocab, 1024),
                          max_new_tokens=steps + 5, rid=100 + i)
        server.step()                       # admission + first decode
        server.step()
        profile_window(f"{label}: decode step at 8 x ~1030 cached tokens", server.step,
                       steps, expected_trace(server, "decode"))
        server.run_until_done()


def profile_prefill(servers):
    """Where a prefill dispatch's time goes: ``torch.profiler`` over one
    dispatch of 8 rows x 256 new tokens at phase 5's cache fills (0..1792),
    on each phase 4 server's caches (their requests are done): a replay of
    the prefill graph, then the eager dispatch."""
    import numpy as np

    y = YI
    rng = np.random.default_rng(6)
    for label, server in servers.items():
        toks = rng.integers(0, server.bundle.cfg.vocab, (y["B"], y["chunk"])).astype(np.int32)
        new = np.full(y["B"], y["chunk"], np.int32)
        offs = np.arange(0, y["B"] * 256, 256, dtype=np.int32)
        profile_window(f"{label}: prefill dispatch (8 x 256 tokens at fills 0..1792, "
                       "32 layers)",
                       lambda: server.engine.dispatch_prefill(toks, new, offs), steps=2,
                       expect=expected_trace(server, "prefill"))


def time_ms(fn, inputs, reps=3, iters=10):
    """Device milliseconds per call: the card's own kernel records
    (``torch.profiler``, CUPTI) summed over ``iters`` calls, median of
    ``reps``.  Host launch overhead is left out — a CUDA-event window
    around these calls would time the Python wrapper, not the card.  The
    calls cycle through ``inputs``, copies big enough that the 50 MB L2
    does not hold them, so each call finds its operands cold.

    A profiler window now and then comes back with no device records at
    all (seen once in a run of every phase); such a window is taken again,
    up to three times, and a repetition that still has none is timed with
    CUDA events instead, which adds the host's launch gaps and is logged."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
        torch.cuda.synchronize()

    for i in range(3):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        for _attempt in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run()
            events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            if events:
                per.append(sum(e.self_device_time_total for e in events) / 1e3 / iters)
                break
        else:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            per.append(start.elapsed_time(end) / iters)
            log(f"  (torch.profiler recorded no device time three times: this "
                f"repetition timed with CUDA events, {per[-1]:.4f} ms)")
    return statistics.median(per)


def phase_times(launches, stats, plens, errs):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.decode_attention import flash_decode, num_splits
    from repro_torch.kernels.flash_attention import flash_prefill

    log("== phase 5: times at the main path's shapes (bfloat16)")
    sms = sm_count(0)
    y = YI
    B, Hq, Hkv, D, Smax, Sn = y["B"], y["Hq"], y["Hkv"], y["D"], y["Smax"], y["chunk"]
    dt, isz = torch.bfloat16, 2
    gen = torch.Generator(device="cuda").manual_seed(5)
    copies = 4   # 4 x 16.8 MB of K/V > 50 MB L2

    # decode: a mid-decode snapshot of phase 4 (first 8 prompts + 32 tokens)
    lens = [min(n + 32, Smax) for n in plens[:B]]
    q, kv, L = decode_inputs(B, Hq, Hkv, D, Smax, lens, dt, gen, copies)
    dec_in = [(q, k, v, L) for k, v in kv]
    mask = (torch.arange(Smax, device="cuda")[None, :] < L[:, None])[:, None, None, :]
    sd_in = [(q[:, :, None], k, v, mask) for k, v in kv]
    kern = time_ms(flash_decode, dec_in)
    plain = time_ms(ref.decode_attention, dec_in, iters=4)
    lib = time_ms(lambda qq, kk, vv, mm: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mm, enable_gqa=True), sd_in)
    keys = sum(lens)
    dbytes = 2 * keys * Hkv * D * isz + 2 * q.numel() * isz + L.numel() * 4
    dflops = 4 * keys * Hq * D
    dec = dict(ms=kern, plain_ms=plain, library_ms=lib, bytes=dbytes, flops=dflops)

    # prefill: one 256-token chunk per row at cache fills spread 0..1792
    offs = [0, 256, 512, 768, 1024, 1280, 1536, 1792]
    nls = [Sn] * B
    q, srcs = prefill_inputs(B, Hq, Hkv, D, Smax, Sn, dt, gen, copies)
    q_pos, k_pos = prefill_positions(offs, nls, Smax, Sn)
    pre_in = [(q, kc, vc, q_pos, k_pos, kn, vn) for kc, vc, kn, vn in srcs]
    live = live_mask(q_pos, k_pos)                                  # (B, Sq, Sk)
    cat_in = [(q, torch.cat([kc, kn], 2), torch.cat([vc, vn], 2), q_pos, k_pos)
              for kc, vc, kn, vn in srcs[:2]]
    kern = time_ms(lambda *a: flash_prefill(*a[:5], k_new=a[5], v_new=a[6]), pre_in)
    plain = time_ms(lambda *a: ref.prefill_attention(
        *a[:5]), cat_in, reps=3, iters=2)
    sd_in = [(a[0], a[1], a[2], live[:, None]) for a in cat_in]
    lib = time_ms(lambda qq, kk, vv, mm: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mm, enable_gqa=True), sd_in)
    pairs = int(live.sum())
    keys_read = int(live.any(1).sum())
    pbytes = (2 * keys_read * Hkv * D * isz + 2 * q.numel() * isz
              + (q_pos.numel() + k_pos.numel()) * 4)
    pflops = 4 * pairs * Hq * D
    pre = dict(ms=kern, plain_ms=plain, library_ms=lib, bytes=pbytes, flops=pflops)

    steps = max(stats["decode_steps"], 1)
    rows = [
        kernel_row(name, src, replaces, rec, launches[name], errs[(n, "bfloat16")])
        for name, src, replaces, rec, n in (
            ("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention.py:71", dec, "decode"),
            ("prefill_attention", "src/repro_torch/csrc/prefill_attention.cu",
             "src/repro/kernels/flash_attention.py:237", pre, "prefill"),
        )
    ]
    log(f"  decode_attention launches per decode step: "
        f"{launches['decode_attention'] / steps:g}")
    log(f"  decode_attention: {dbytes / dec['ms'] / 1e6:.1f} GB/s on its {keys} live keys "
        f"x {Hkv} KV heads, {rows[0]['bound_ms'] / dec['ms']:.3f} of the byte bound, "
        f"{dec['ms'] / dec['library_ms']:.2f}x SDPA; {num_splits(B, Hkv, Smax, 64, sms)} "
        f"blocks a (row, KV head) on {sms} SMs")
    log(f"  prefill_attention: {pflops / pre['ms'] / 1e9:.1f} TFLOP/s on its "
        f"{pairs} live (query, key) pairs x {Hq} heads, {rows[1]['bound_ms'] / pre['ms']:.3f} "
        f"of the operation bound, {pre['ms'] / pre['library_ms']:.2f}x SDPA "
        f"({pflops / pre['library_ms'] / 1e9:.1f} TFLOP/s)")
    return rows


# ---------------------------------------------------------------------------
# training attention: checks, smoke training parity, the full run, times
# ---------------------------------------------------------------------------

def fa_live_rows(kind, kw, Sq, Sk, q_offset):
    """(Sq,) bool: query rows with at least one live key under the mask."""
    import torch

    if kind == "bidirectional":
        return torch.ones(Sq, dtype=torch.bool, device="cuda")
    qp = q_offset + torch.arange(Sq, device="cuda")[:, None]
    kp = torch.arange(Sk, device="cuda")[None, :]
    live = qp >= kp
    if kind == "sliding":
        live &= (qp - kp) < kw["window"]
    elif kind == "chunked":
        live &= (qp // kw["chunk"]) == (kp // kw["chunk"])
    return live.any(-1)


def fa_inputs(B, Hq, Hkv, Sq, Sk, D, dtype, gen, rows=None):
    """q, k, v and a cotangent dout; dout is 0 on rows without a live key
    (padding: the kernel gives 0 there, the plain version mean(V))."""
    import torch

    q = torch.randn(B, Hq, Sq, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, Hkv, Sk, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, Hkv, Sk, D, generator=gen, device="cuda").to(dtype)
    dout = torch.randn(B, Hq, Sq, D, generator=gen, device="cuda").to(dtype)
    if rows is not None:
        dout = dout * rows[:, None].to(dtype)
    return q, k, v, dout


def phase_train_kernels():
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd

    log("== phase 2b: training attention kernel, forward and backward, against "
        "the plain version and autograd through it")
    o = OLMO_TRAIN
    cases = [
        ("olmo-train", o["B"], o["Hq"], o["Hkv"], o["S"], o["S"], o["D"], 0, "causal", {}),
        ("yi-gqa", 2, 32, 4, 1024, 1024, 128, 0, "causal", {}),
        ("sliding", 2, 8, 2, 192, 320, 64, 128, "sliding", {"window": 64}),
        ("chunked", 2, 8, 2, 192, 320, 64, 128, "chunked", {"chunk": 128}),
        ("bidirectional", 2, 8, 2, 192, 320, 64, 128, "bidirectional", {}),
        ("smoke", 2, 8, 1, 64, 64, 16, 0, "causal", {}),
        ("ragged", 2, 16, 16, 1000, 1000, 128, 0, "causal", {}),
    ]
    gen = torch.Generator(device="cuda").manual_seed(3)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for tag, B, Hq, Hkv, Sq, Sk, D, q_off, kind, kw in cases:
            rows = fa_live_rows(kind, kw, Sq, Sk, q_off)
            q, k, v, dout = fa_inputs(B, Hq, Hkv, Sq, Sk, D, dtype, gen, rows)
            mask = dict(kind=kind, q_offset=q_off, **kw)
            out, lse = flash_attention(q, k, v, **mask)
            grads = flash_attention_bwd(q, k, v, out, lse, dout, **mask)
            torch.cuda.synchronize()
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            want = ref.attention(*qkv, **mask)
            want_g = torch.autograd.grad(want, qkv, dout)
            shape = f"B{B} Hq{Hq} Hkv{Hkv} Sq{Sq} Sk{Sk} D{D} q_offset{q_off} {kind}"
            e_out = check_close(f"attention fwd {tag} {dn} {shape}", out,
                                want.detach(), dn, rows[None, None].expand(B, Hq, Sq))
            e_grad = max(
                check_close(f"attention bwd {name} {tag} {dn}", g, w, dn,
                            tols=GRAD_TOL)
                for name, g, w in zip(("dq", "dk", "dv"), grads, want_g)
            )
            if tag == "olmo-train":
                errs[("attention_fwd", dn)] = e_out
                errs[("attention_bwd", dn)] = e_grad
            del q, k, v, dout, out, lse, grads, qkv, want, want_g
        torch.cuda.empty_cache()
    return errs


def phase_train_parity():
    import dataclasses

    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.models.model_zoo import ModelBundle
    from repro_torch.models.sharding import tree_map
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import TrainConfig, make_train_step

    log("== phase 3b: smoke training, float32, card against CPU")
    # step 1 starts from the same weights: the losses differ only by the
    # order of f32 sums.  Steps 2-3 start from weights that AdamW moved by
    # up to lr per element, and m / sqrt(v) turns a near-zero gradient's
    # rounding difference into a full-lr step, so their limit is looser.
    tcfg = TrainConfig(remat="full", optimizer=AdamWConfig(lr=1e-3, warmup_steps=1))
    for arch in ("olmo-1b", "yi-6b"):
        cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
        bundle = ModelBundle(cfg)
        params_cpu = bundle.init_params(torch.Generator().manual_seed(0))
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4))
        batches = [next(data) for _ in range(3)]
        res = {}
        for dev in ("cuda", "cpu"):
            params = tree_map(lambda t: t.to(dev, copy=True), params_cpu)
            opt = init_opt_state(params)
            step = make_train_step(bundle, tcfg)
            before = (flash_attention.launches, flash_attention_bwd.launches)
            losses, gnorms = [], []
            for b in batches:
                batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
                params, opt, _, m = step(params, opt, None, batch)
                losses.append(float(m["loss"]))
                gnorms.append(float(m["grad_norm"]))
            res[dev] = (losses, gnorms)
            if dev == "cuda":
                n = (flash_attention.launches - before[0],
                     flash_attention_bwd.launches - before[1])
                want = (2 * cfg.n_layers * 3, cfg.n_layers * 3)
                if n != want:
                    raise AssertionError(f"{arch}: attention launches {n} != {want}")
        (lc, gc), (lp, gp) = res["cuda"], res["cpu"]
        for i in range(3):
            lim = 1e-5 if i == 0 else 1e-3
            if abs(lc[i] - lp[i]) > lim * abs(lp[i]) or abs(gc[i] - gp[i]) > 1e-2 * abs(gp[i]):
                raise AssertionError(f"{arch} step {i + 1}: card loss {lc[i]} grad norm "
                                     f"{gc[i]} vs CPU {lp[i]} {gp[i]}")
        log(f"  {arch}-smoke: losses card {lc} cpu {lp}; grad norms card {gc} cpu {gp}")


def phase_train_full():
    import logging

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.launch.train import parse_args, train

    o = OLMO_TRAIN
    cfg = get_config("olmo-1b")
    log(f"== phase 6: training {cfg.name} bfloat16, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.attention.n_heads}/{cfg.attention.n_kv_heads} heads, "
        f"batch {o['B']} x {o['S']}, remat full, {o['steps']} AdamW steps")
    logging.basicConfig(level=logging.INFO, format="  %(message)s")
    args = parse_args([
        "--arch", "olmo-1b", "--steps", str(o["steps"]), "--batch", str(o["B"]),
        "--seq", str(o["S"]), "--remat", "full", "--lr", "3e-4",
        "--ckpt-dir", str(ROOT / "build" / "ckpt-chip-smoke"),
        "--ckpt-every", "1000000", "--log-every", "1",
    ])
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    flash_attention_bwd.launches = 0
    t0 = time.perf_counter()
    out = train(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"attention_fwd": flash_attention.launches,
                "attention_bwd": flash_attention_bwd.launches}
    steps = o["steps"]
    if out["steps"] != steps or len(out["losses"]) != steps:
        raise AssertionError(f"ran {out['steps']} steps, {len(out['losses'])} losses")
    bad = [x for x in out["losses"] + out["grad_norms"] if not x == x or abs(x) == float("inf")]
    if bad:
        raise AssertionError(f"non-finite losses / grad norms {bad}")
    if out["restarts"] != 0:
        raise AssertionError(f"supervisor restarted {out['restarts']} times")
    L = cfg.n_layers
    if launches != {"attention_fwd": 2 * L * steps, "attention_bwd": L * steps}:
        raise AssertionError(f"attention launches {launches}: want forward 2 x {L} x "
                             f"{steps}, backward {L} x {steps}")
    tokens = o["B"] * o["S"]
    steady = statistics.median(out["step_s"][1:])
    log(f"  {steps} steps in {wall:.2f} s (set-up included); losses {out['losses']}; "
        f"grad norms {out['grad_norms']}")
    log(f"  step times {[round(t, 4) for t in out['step_s']]} s; steady step "
        f"{steady:.4f} s -> {tokens / steady:.1f} training tokens/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; kernel launches {launches}")
    return out, launches


def profile_train(out):
    """Where a training step's time goes: ``torch.profiler`` over one more
    step of the phase 6 run (its state, the next SyntheticLM batch)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models.model_zoo import ModelBundle
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, make_train_step

    o = OLMO_TRAIN
    cfg = get_config("olmo-1b")
    step = make_train_step(ModelBundle(cfg), TrainConfig(
        remat="full", optimizer=AdamWConfig(lr=3e-4, warmup_steps=2)))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=o["S"], global_batch=o["B"]))
    data.restore({"step": o["steps"], "seed": 0})
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in next(data).items()}
    st = out["state"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, _, m = step(st["params"], st["opt"], st["ef"], batch)
        loss = float(m["loss"])
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"  profiled step: loss {loss:.4f}, {wall * 1e3:.1f} ms wall, {busy:.1f} ms of "
        f"device time ({100 * busy / (wall * 1e3):.1f} % busy)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d} calls  {e.key[:90]}")
    return dict(wall_ms=wall * 1e3, busy_ms=busy)


def phase_train_times(launches, errs):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd

    o = OLMO_TRAIN
    B, H, S, D = o["B"], o["Hq"], o["S"], o["D"]
    log(f"== phase 7: training attention times at ({B}, {H}, {S}, {D}) causal bfloat16")
    dt, isz = torch.bfloat16, 2
    gen = torch.Generator(device="cuda").manual_seed(7)
    sets = [fa_inputs(B, H, H, S, S, D, dt, gen) for _ in range(2)]   # 2 x 128 MB > L2
    fwd_in = [(q, k, v) for q, k, v, _ in sets]
    fwd = dict(
        ms=time_ms(lambda q, k, v: flash_attention(q, k, v), fwd_in),
        plain_ms=time_ms(lambda q, k, v: ref.attention(q, k, v), fwd_in, iters=2),
        library_ms=time_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), fwd_in),
    )
    bwd_in = []
    for q, k, v, dout in sets:
        out, lse = flash_attention(q, k, v)
        bwd_in.append((q, k, v, out, lse, dout))
    bwd_ms = time_ms(lambda *a: flash_attention_bwd(*a), bwd_in)
    # the plain version's and SDPA's backward alone: autograd.grad over a
    # forward taken once outside the timed window
    q, k, v, dout = sets[0]
    qkv = [t.detach().requires_grad_() for t in (q, k, v)]
    graph = ref.attention(*qkv)
    plain_bwd = time_ms(lambda: torch.autograd.grad(graph, qkv, dout, retain_graph=True),
                        [()], iters=2)
    del graph
    graph = F.scaled_dot_product_attention(*qkv, is_causal=True)
    lib_bwd = time_ms(lambda: torch.autograd.grad(graph, qkv, dout, retain_graph=True),
                      [()])
    del graph
    pairs = B * H * S * (S + 1) // 2
    qbytes = B * H * S * D * isz
    bwd = dict(ms=bwd_ms, plain_ms=plain_bwd, library_ms=lib_bwd,
               bytes=8 * qbytes + B * H * S * 4, flops=10 * D * pairs)
    fwd.update(bytes=4 * qbytes + B * H * S * 4, flops=4 * D * pairs)
    _, bf16_flops_per_s, _ = peaks()
    for name, rec in (("forward", fwd), ("backward", bwd)):
        log(f"  {name}: {rec['flops'] / rec['ms'] / 1e9:.1f} TFLOP/s "
            f"({rec['flops']} flops in {rec['ms']:.4f} ms), "
            f"{rec['flops'] / bf16_flops_per_s * 1e3 / rec['ms']:.3f} of the operation bound, "
            f"{rec['ms'] / rec['library_ms']:.2f} x SDPA's {rec['library_ms']:.4f} ms")
    rows = []
    for name, rec, replaces in (
        ("attention_fwd", fwd, "src/repro/kernels/flash_attention.py:115"),
        ("attention_bwd", bwd, "src/repro/kernels/ops.py:66"),
    ):
        rows.append(kernel_row(name, "src/repro_torch/csrc/flash_attention.cu",
                               replaces, rec, launches[name], errs[(name, "bfloat16")]))
    return rows


# ---------------------------------------------------------------------------
# Mamba-2 serving: the SSD scan kernel, smoke parity, the full runs, times
# ---------------------------------------------------------------------------

def ssd_inputs(B, T, H, P, N, dtype, gen, state=True):
    """x, dt (softplus, scaled), A (negative), B, C and an initial state
    whose entries are O(1), as a serving cache's are."""
    import torch
    import torch.nn.functional as F

    r = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")  # noqa: E731
    x = (r(B, T, H, P) * 0.5).to(dtype)
    dt = F.softplus(r(B, T, H) - 1.0) * 0.5
    A = -torch.exp(r(H) * 0.5)
    Bm, Cm = (r(B, T, N) * 0.5).to(dtype), (r(B, T, N) * 0.5).to(dtype)
    h0 = r(B, H, P, N) if state else None
    return x, dt, A, Bm, Cm, h0


def check_state(name, got, want):
    """The f32 state within 1e-4 x the leaf's max |value|."""
    import torch

    err = float((got - want).abs().max())
    lim = 1e-4 * float(want.abs().max())
    log(f"  {name}: max_abs_err {err:.3e} (limit {lim:.3e} = 1e-4 x max |want|)")
    if not bool(torch.isfinite(got).all()) or err > lim:
        raise AssertionError(f"{name}: state error {err} over {lim}")
    return err


def phase_ssd_kernels():
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan

    log("== phase 8a: the SSD scan kernel against its plain versions on the card")
    m, z = MAMBA, ZAMBA
    gen = torch.Generator(device="cuda").manual_seed(11)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        cases = [
            ("mamba2", m["B"], m["T"], m["H"], m["P"], m["N"]),
            ("zamba2", 4, m["T"], z["H"], z["P"], z["N"]),
            ("T1", 3, 1, m["H"], m["P"], m["N"]),
            ("T100", 2, 100, m["H"], m["P"], m["N"]),
            ("T257", 2, 257, z["H"], z["P"], z["N"]),
        ]
        for tag, B, T, H, P, N in cases:
            x, dt, A, Bm, Cm, h0 = ssd_inputs(B, T, H, P, N, dtype, gen)
            if tag == "mamba2":
                # rows 1..: dt is 0 past a per-row length (a prefill chunk's
                # dead tail); row 0: dt is 0 throughout (an idle slot)
                lens = torch.tensor([0, 256, 255, 1, 100, 37, 200, 129],
                                    device="cuda")[:, None, None]
                dt = torch.where(torch.arange(T, device="cuda")[None, :, None] < lens,
                                 dt, 0.0)
            shape = f"B{B} T{T} H{H} P{P} N{N}"
            y, h = ssd_scan(x, dt, A, Bm, Cm, init_state=h0, return_state=True)
            torch.cuda.synchronize()
            chunk = 64 if T % 64 == 0 else T
            want_y, want_h = ref.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk,
                                          init_state=h0, return_state=True)
            e = check_close(f"ssd_scan y {tag} {dn} {shape}", y, want_y, dn,
                            tols=SSD_TOL)
            check_state(f"ssd_scan state {tag} {dn}", h, want_h)
            if tag == "mamba2":
                errs[("ssd_scan", dn)] = e
                if not torch.equal(h[0], h0[0]):
                    raise AssertionError("the dt == 0 row's state is not its "
                                         "initial state bit for bit")
                log("  dt == 0 row: final state == initial state, bit for bit")
                seq = ref.ssd_scan_sequential(x, dt, A, Bm, Cm, init_state=h0)
                check_close(f"ssd_scan y {tag} {dn} vs the literal recurrence",
                            y, seq, dn, tols=SSD_TOL)
                # the state written in place into the initial-state buffer
                buf = h0.clone()
                y2, _ = ssd_scan(x, dt, A, Bm, Cm, init_state=buf,
                                 return_state=True, state_out=buf)
                torch.cuda.synchronize()
                if not (torch.equal(buf, h) and torch.equal(y2, y)):
                    raise AssertionError("in-place state differs from a fresh buffer")
                log("  state written in place == state in a fresh buffer")
            del x, dt, A, Bm, Cm, h0, y, h, want_y, want_h
    return errs


def phase_ssm_parity():
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.models.model_zoo import ModelBundle
    from repro_torch.models.sharding import tree_map
    from repro_torch.serve import Request, ServeConfig, Server

    log("== phase 8b: mamba2-smoke and zamba2-smoke float32, card against CPU")
    for arch in ("mamba2-780m", "zamba2-1.2b"):
        cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
        bundle = ModelBundle(cfg)
        params_cpu = bundle.init_params(torch.Generator().manual_seed(0))
        params_gpu = tree_map(lambda t: t.to("cuda"), params_cpu)
        rng = np.random.default_rng(2)
        # 2 slots, 5 requests: the 1-token prompt lands in a reused slot
        prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32)
                   for n in (9, 14, 1, 6, 11)]
        tokens = {}
        for dev, params in (("cuda", params_gpu), ("cpu", params_cpu)):
            server = Server(bundle, ServeConfig(batch_slots=2, max_len=64,
                                                prefill_chunk=4), params, device=dev)
            reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
                    for i, p in enumerate(prompts)]
            server.add_requests(reqs)
            server.run_until_done(max_steps=300)
            assert all(r.done and len(r.out_tokens) == 6 for r in reqs), dev
            tokens[dev] = {r.rid: r.out_tokens for r in reqs}
        if tokens["cuda"] != tokens["cpu"]:
            raise AssertionError(f"{arch}: card/CPU greedy tokens differ: {tokens}")
        log(f"  {cfg.name}: greedy tokens identical for {len(prompts)} requests: "
            f"{tokens['cuda']}")


def serve_full(arch, n_requests, max_prompt, new_tokens):
    """Serve ``n_requests`` greedy requests (prompts of 128..max_prompt
    tokens, numpy seed 0) through full-width, full-depth ``arch`` in bf16 on
    ServeConfig(8, 2048, 256), through the CUDA graphs and then eagerly on
    the same weights: greedy tokens identical for every request."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import ModelBundle
    from repro_torch.serve import ServeConfig

    cfg = get_config(arch)
    bundle = ModelBundle(cfg)
    t0 = time.perf_counter()
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"  weights drawn on the card in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    m = MAMBA
    scfg = ServeConfig(batch_slots=m["B"], max_len=2048, prefill_chunk=m["T"])
    rng = np.random.default_rng(0)
    plens = rng.integers(128, max_prompt + 1, size=n_requests)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in plens]
    log(f"  prompts {int(plens.min())}-{int(plens.max())} tokens, {new_tokens} new each")
    server, reqs, _, launches = serve_requests(bundle, params, scfg, prompts, new_tokens)
    check_logits(bundle, params, server, m["B"])
    eager, ereqs, _, elaunches = serve_requests(bundle, params, scfg, prompts, new_tokens,
                                                eager=True)
    same_tokens(cfg.name, reqs, ereqs)
    return server, eager, params, launches, elaunches


def phase_mamba_full():
    from repro_torch.configs import get_config

    cfg = get_config("mamba2-780m")
    s = cfg.ssm
    log(f"== phase 8c: {cfg.name} bfloat16, {cfg.n_layers} M layers, d_model "
        f"{cfg.d_model}, {s.n_heads(cfg.d_model)} SSD heads x P {s.head_dim}, "
        f"N {s.d_state}, vocab {cfg.vocab}, through the CUDA graphs, then eager")
    server, eager, params, launches, elaunches = serve_full("mamba2-780m", 16, 1536, 64)
    L = cfg.n_layers
    for label, srv, ln in (("graphs", server, launches), ("eager", eager, elaunches)):
        want = {"ssd_scan": L * srv.stats()["prefill_dispatches"],
                "decode_attention": 0, "prefill_attention": 0}
        if ln != want:
            raise AssertionError(f"{label}: launches {ln} != {want}")
    return server, eager, params, launches


def phase_zamba_full():
    import torch
    from repro_torch.configs import get_config

    cfg = get_config("zamba2-1.2b")
    codes = cfg.layer_codes()
    log(f"== phase 8d: {cfg.name} bfloat16, {codes.count('M')} M layers and "
        f"{codes.count('S')} applications of one shared attention block "
        f"({cfg.attention.n_heads} x {cfg.attention.d_head} heads over width "
        f"{2 * cfg.d_model}), d_model {cfg.d_model}, through the CUDA graphs, then eager")
    server, eager, params, launches, elaunches = serve_full("zamba2-1.2b", 8, 1024, 32)
    n_m, n_s = codes.count("M"), codes.count("S")
    for label, srv, ln in (("graphs", server, launches), ("eager", eager, elaunches)):
        st = srv.stats()
        want = {"ssd_scan": n_m * st["prefill_dispatches"],
                "prefill_attention": n_s * st["prefill_dispatches"],
                "decode_attention": n_s * st["decode_steps"]}
        if ln != want:
            raise AssertionError(f"zamba2 {label} launches {ln} != {want}")
    del server, eager, params
    torch.cuda.empty_cache()


def profile_window(label, fn, steps, expect=None):
    """``torch.profiler`` over ``steps`` calls of ``fn``: wall and device
    time per call, the busy share, the kernels that take the device time.
    ``expect`` maps a kernel's trace name to its launches per call: the
    trace must show exactly that many (a graph's launches confirmed from
    the card's own records).  A window with no device records at all is
    taken again, up to three times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / steps
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        if kernels:
            break
        log(f"  ({label}: the profiler recorded no device time; taken again)")
    else:
        raise AssertionError(f"{label}: three profiler windows without device records")
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    n = sum(e.count for e in kernels) // steps
    log(f"  {label}: {wall * 1e3:.2f} ms wall, {busy:.2f} ms of device time "
        f"({100 * busy / (wall * 1e3):.1f} % busy), {n} kernel launches per call")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"    {e.self_device_time_total / 1e3 / steps:8.3f} ms/call "
            f"{e.count // steps:5d} launches/call  {e.key[:90]}")
    for name, per_call in (expect or {}).items():
        seen = sum(e.count for e in kernels if name in e.key)
        if seen != per_call * steps:
            raise AssertionError(f"{label}: the trace shows {seen} {name} launches, "
                                 f"the graph counted {per_call} x {steps} calls")
        log(f"    trace confirms {name}: {seen} launches = {per_call} per replay x {steps}")
    return dict(wall_ms=wall * 1e3, busy_ms=busy, launches=n)


def phase_ssd_times(servers, launches, errs):
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.ssd_scan import heads_per_block, ssd_scan

    m = MAMBA
    B, T, H, P, N = m["B"], m["T"], m["H"], m["P"], m["N"]
    log(f"== phase 8e: ssd_scan times at (B {B}, T {T}, H {H}, P {P}, N {N}) bfloat16, "
        "and mamba2-780m profile windows")
    gen = torch.Generator(device="cuda").manual_seed(13)
    sets = [ssd_inputs(B, T, H, P, N, torch.bfloat16, gen) for _ in range(4)]  # > L2
    kern = time_ms(lambda x, dt, A, Bm, Cm, h0: ssd_scan(
        x, dt, A, Bm, Cm, init_state=h0, return_state=True, state_out=h0), sets)
    plain = time_ms(lambda x, dt, A, Bm, Cm, h0: ref.ssd_scan(
        x, dt, A, Bm, Cm, chunk=T, init_state=h0, return_state=True), sets, iters=2)
    nbytes = (2 * B * T * H * P * 2          # x read, y written (bf16)
              + 2 * B * H * P * N * 4        # state in and out (f32)
              + B * T * H * 4 + H * 4        # dt, A (f32)
              + 2 * B * T * N * 2)           # B, C (bf16)
    Q = 32   # the kernel's chunk: C·Bᵀ and the masked product, h·C, the state update
    flops = 2 * B * H * T * (Q * (N + P) + 2 * P * N)
    rec = dict(ms=kern, plain_ms=plain, library_ms=None, bytes=nbytes, flops=flops)
    row = kernel_row("ssd_scan", "src/repro_torch/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan.py:90", rec, launches["ssd_scan"],
                     errs[("ssd_scan", "bfloat16")])
    hb = heads_per_block(B, H, P, sm_count(0))
    log(f"  ssd_scan: {nbytes / kern / 1e6:.1f} GB/s, {row['bound_ms'] / kern:.3f} of the "
        f"byte bound, {flops / kern / 1e9:.1f} TFLOP/s; {hb} heads a block, "
        f"{B * -(-H // hb)} blocks on {sm_count(0)} SMs")
    del sets

    # profile windows: one prefill dispatch (8 rows x 256 new tokens at
    # offset 0) and decode steps (8 rows), on the phase 8c servers' caches:
    # graph replays, then eager
    rng = np.random.default_rng(13)
    for label, server in servers.items():
        eng = server.engine
        toks = rng.integers(0, server.bundle.cfg.vocab, (B, T)).astype(np.int32)
        full, zeros = np.full(B, T, np.int32), np.zeros(B, np.int32)
        profile_window(f"{label}: prefill dispatch (8 x 256 tokens, 48 layers)",
                       lambda: eng.dispatch_prefill(toks, full, zeros), steps=2,
                       expect=expected_trace(server, "prefill"))
        profile_window(f"{label}: decode step (8 rows, 48 layers)", eng.decode, steps=4,
                       expect=expected_trace(server, "decode"))
    return row


# ---------------------------------------------------------------------------
# the paper's single-GPU study: the GEMM kernel, the memory benchmarks,
# calibration
# ---------------------------------------------------------------------------

def gemm_inputs(M, N, K, dtype, gen):
    import torch

    a = torch.randn(M, K, generator=gen, device="cuda")
    b = torch.randn(K, N, generator=gen, device="cuda") * K ** -0.5
    return a.to(dtype), b.to(dtype)


def study_ms(fn, repeats=10):
    """Milliseconds per call of ``fn`` on the card by the study's own method
    (``repro_torch.core.membench.measure``: CUDA events around each call
    after warm-up, the calls queued behind a spin kernel so each event pair
    spans the card's time), mean of ``repeats``.  Phase 9 times its rows
    this way: on an H100 80GB HBM3 at 700 W, ``torch.profiler`` put a 1 GiB
    read at 0.2824 ms, 3.80 TB/s, faster than its HBM can deliver."""
    from repro_torch.core.membench import measure

    return measure(fn, warmup=2, repeats=repeats, device="cuda").mean_s * 1e3


def phase_gemm_kernel():
    """9a: blocked_matmul against ref.matmul at the reference test's three
    shapes and tilings (the best supported tiling where the reference's
    has no f32 instantiation), 4096^3 in both output dtypes and a
    non-square shape, in bf16 and f32; a missing tiling must raise."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.blocked_matmul import best_tiling, blocked_matmul, supported

    log("== phase 9a: blocked_matmul against its plain version on the card")
    gen = torch.Generator(device="cuda").manual_seed(17)
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        isz = dtype.itemsize
        cases = [
            (256, 128, 512, (128, 128, 128), torch.float32),
            (128, 128, 128, (128, 128, 128), torch.float32),
            (512, 256, 256, (256, 128, 256), torch.float32),
            (4096, 4096, 4096, None, torch.float32),
            (4096, 4096, 4096, None, torch.bfloat16),
            (1536, 640, 2304, None, dtype),
        ]
        for M, N, K, tiling, out in cases:
            if tiling is None or not supported(*tiling, isz):
                tiling = best_tiling(M, N, K, itemsize=isz)
            a, b = gemm_inputs(M, N, K, dtype, gen)
            got = ops.matmul(a, b, out_dtype=out, bm=tiling[0], bn=tiling[1],
                             bk=tiling[2])
            torch.cuda.synchronize()
            on = str(out).split(".")[-1]
            check_close(f"blocked_matmul {dn}->{on} ({M}, {N}, {K}) tiling {tiling}",
                        got, ref.matmul(a, b, out_dtype=out), on, tols=GEMM_TOL)
        a, b = gemm_inputs(512, 256, 512, dtype, gen)
        for bad in ((64, 64, 64), (256, 128, 256) if isz == 4 else (128, 256, 32)):
            before = blocked_matmul.launches
            try:
                blocked_matmul(a, b, bm=bad[0], bn=bad[1], bk=bad[2])
            except ValueError as e:
                if blocked_matmul.launches != before:
                    raise AssertionError("a refused tiling launched") from e
                log(f"  {dn} tiling {bad} refused: {str(e)[:60]}...")
            else:
                raise AssertionError(f"tiling {bad} has no instantiation but ran")


def phase_gemm_study():
    """9b: the GEMM study through bench_gemm (N = 16384 bf16, N = 8192 f32),
    launches counted; then every call it timed (each tiling, on its own
    inputs) against the plain version, and the kernel's times at N = 16384
    bf16 beside the plain version's, torch.matmul's and the bound."""
    import torch
    from repro_torch.benchmarks import bench_gemm
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.blocked_matmul import best_tiling, blocked_matmul

    log("== phase 9b: the GEMM study (bench_gemm) on the card")
    blocked_matmul.launches = 0
    t0 = time.perf_counter()
    study = bench_gemm.main("cuda")
    torch.cuda.synchronize()
    launches = blocked_matmul.launches
    log(f"  bench_gemm took {time.perf_counter() - t0:.1f} s; blocked_matmul "
        f"launches {launches}")
    if launches == 0:
        raise AssertionError("bench_gemm ran no blocked_matmul kernel")
    for r in study:
        if r["N"] == GEMM_N and r["dtype"] == "bfloat16":
            who = "torch.matmul" if r["tiling"] is None else f"blocked_matmul {r['tiling']}"
            log(f"  N = {GEMM_N} bf16 {who}: {r['us_per_call'] / 1e3:.4f} ms, "
                f"{r['tflops']:.1f} TFLOP/s")

    dev = torch.device("cuda")
    err = 0.0
    for N, dtype in bench_gemm.SIZES["cuda"]:
        dn = str(dtype).split(".")[-1]
        a, b = bench_gemm.inputs(N, dtype, dev)
        want = ref.matmul(a, b)
        for bm, bn, bk in bench_gemm.tilings(N, dtype.itemsize):
            got = ops.matmul(a, b, bm=bm, bn=bn, bk=bk)
            torch.cuda.synchronize()
            err = max(err, check_close(f"bench_gemm's blocked_matmul {dn} ({N}, {N}, {N}) "
                                       f"tiling {(bm, bn, bk)}", got, want, dn,
                                       tols=GEMM_TOL))
            del got
        del want
        if N == GEMM_N and dtype == torch.bfloat16:
            log(f"  blocked_matmul at the study's shape, default tiling "
                f"{best_tiling(N, N, N)}")
            kern = study_ms(lambda: ops.matmul(a, b), repeats=5)
            plain = study_ms(lambda: ref.matmul(a, b), repeats=3)
            lib = study_ms(lambda: torch.matmul(a, b), repeats=5)
        del a, b
        torch.cuda.empty_cache()
    N = GEMM_N
    rec = dict(ms=kern, plain_ms=plain, library_ms=lib, bytes=3 * N * N * 2,
               flops=2 * N ** 3)
    row = kernel_row("blocked_matmul", "src/repro_torch/csrc/blocked_matmul.cu",
                     "src/repro/kernels/blocked_matmul.py:48", rec, launches, err)
    log(f"  blocked_matmul {2 * N ** 3 / kern / 1e9:.1f} TFLOP/s, torch.matmul "
        f"{2 * N ** 3 / lib / 1e9:.1f} TFLOP/s")
    return row


def phase_membench():
    """9c: bench_membw, bench_copy, bench_latency and
    bench_managed_vs_system on device memory and pinned host memory, sizes
    past L2, with the membench kernels' launches counted; then each kernel
    against its plain version at the largest shapes those runs give it,
    and its times."""
    import numpy as np
    import torch
    from repro_torch.benchmarks import (
        bench_copy,
        bench_latency,
        bench_managed_vs_system,
        bench_membw,
    )
    from repro_torch.kernels import membench, ref

    log("== phase 9c: memory benchmarks on device and pinned host memory")
    fns = (membench.stream_read, membench.stream_fill, membench.chase)
    for fn in fns:
        fn.launches = 0
    for mod in (bench_membw, bench_copy, bench_latency, bench_managed_vs_system):
        t0 = time.perf_counter()
        log(f"  # ==== {mod.__name__.rsplit('.', 1)[-1]} ====")
        mod.main("cuda")
        torch.cuda.synchronize()
        log(f"  # done in {time.perf_counter() - t0:.1f} s")
    launches = {fn.__name__: fn.launches for fn in fns}
    log(f"  membench launches: {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a membench kernel never ran: {launches}")

    gen = torch.Generator(device="cuda").manual_seed(19)
    n = max(bench_membw.CUDA_SIZES) // 4
    x = torch.randn(n, generator=gen, device="cuda")
    host = x.cpu().pin_memory()
    errs = {}
    for where, t in (("device", x), ("pinned_host", host)):
        got, want = float(membench.stream_read(t)), float(ref.stream_read(t.cuda()))
        lim = 1e-6 * float(t.abs().sum())     # f32 partial sums of ~1000 terms
        log(f"  stream_read {where} {n} floats: {got:.6f} vs plain {want:.6f} "
            f"(|err| {abs(got - want):.3e}, limit {lim:.3e})")
        if not abs(got - want) <= lim:
            raise AssertionError(f"stream_read on {where} disagrees")
        errs.setdefault("stream_read", abs(got - want))
    for where, t in (("device", x), ("pinned_host", host)):
        membench.stream_fill(t, 3.0)
        torch.cuda.synchronize()
        if not bool((t == 3.0).all()):
            raise AssertionError(f"stream_fill on {where} missed elements")
    log("  stream_fill: every element written on device and pinned host memory")
    errs["stream_fill"] = 0.0
    m = max(bench_latency.CUDA_SIZES)
    perm = torch.from_numpy(bench_latency.cyclic_permutation(m, np.random.default_rng(1)))

    def start():
        return torch.full((), 3, dtype=torch.int32, device="cuda")

    for where, t in (("device", perm.cuda()), ("pinned_host", perm.pin_memory())):
        got = int(membench.chase(t, bench_latency.CHAIN, start()))
        want = int(ref.chase(t.cuda(), bench_latency.CHAIN, start()))
        log(f"  chase {where} over {m * 4} B: ends at {got}, plain {want}")
        if got != want:
            raise AssertionError(f"chase on {where} disagrees")
    errs["chase"] = 0.0

    # times at those shapes, in device memory (1 GiB read and fill, the
    # 256 MiB chase): kernel, plain version, one library call, bound
    pd, pos = perm.cuda(), start()
    rows = []
    for name, kern_fn, plain_fn, lib_fn, nbytes, src_line in (
        ("stream_read", lambda: membench.stream_read(x), lambda: ref.stream_read(x),
         lambda: torch.sum(x), 4 * n + 8, "benchmarks/bench_membw.py:30"),
        ("stream_fill", lambda: membench.stream_fill(x, 2.0),
         lambda: ref.stream_fill(x, 2.0), lambda: x.fill_(2.0), 4 * n,
         "benchmarks/bench_membw.py:31"),
        ("chase", lambda: membench.chase(pd, bench_latency.CHAIN, pos),
         lambda: ref.chase(pd, bench_latency.CHAIN, pos), None,
         4 * bench_latency.CHAIN + 8, "benchmarks/bench_latency.py:22"),
    ):
        rec = dict(ms=study_ms(kern_fn), bytes=nbytes, flops=0,
                   plain_ms=study_ms(plain_fn, repeats=3),
                   library_ms=None if lib_fn is None else study_ms(lib_fn))
        rows.append(kernel_row(name, "src/repro_torch/csrc/membench.cu", src_line,
                               rec, launches[name], errs[name]))
    log(f"  chase: {rows[-1]['ms'] / bench_latency.CHAIN * 1e6:.1f} ns per dependent "
        f"load over {m * 4} B of device memory")
    return rows


def phase_calibrate():
    """9d: calibration on the card through repro_torch.launch.calibrate:
    the measured HBM read bandwidth may not exceed the spec by more than 5 %
    (an L2-resident sweep would), PCIe is measured, NVLink and InfiniBand
    keep spec provenance."""
    from repro_torch.core.calibration import Calibration
    from repro_torch.core.hardware import SPEC_SYSTEM
    from repro_torch.launch import calibrate as launch_calibrate

    log("== phase 9d: calibration on the card")
    out = ROOT / "build" / "calibration.json"
    t0 = time.perf_counter()
    rc = launch_calibrate.main(["--out", str(out), "--report",
                                str(ROOT / "build" / "replay_report.json")])
    if rc != 0:
        raise AssertionError(f"repro_torch.launch.calibrate exited {rc}")
    cal = Calibration.load(out)
    log(f"  calibration took {time.perf_counter() - t0:.1f} s; written to {out}")
    spec = SPEC_SYSTEM.term_value("hbm_bandwidth")
    hbm = cal.terms["hbm_bandwidth"].measured
    log(f"  hbm_bandwidth measured {hbm / 1e9:.1f} GB/s = {hbm / spec:.3f} x spec; "
        f"pcie_bandwidth measured {cal.terms['pcie_bandwidth'].measured / 1e9:.2f} GB/s")
    if not hbm <= 1.05 * spec:
        raise AssertionError(f"measured HBM bandwidth {hbm:.4g} B/s is over 1.05 x "
                             f"the spec {spec:.4g} B/s: the sweep read L2")
    system = cal.apply(SPEC_SYSTEM)
    for term in ("ici_link_bandwidth", "ici_hop_latency", "dcn_bandwidth", "dcn_latency"):
        if system.provenance_of(term) != "spec":
            raise AssertionError(f"{term} is {system.provenance_of(term)} on one card")
    for term, e in cal.replay.per_term_error().items():
        log(f"  replay {term}: mean rel error {e.mean_rel_error:.4f}, max "
            f"{e.max_rel_error:.4f} over {e.count} sweep points ({e.limiting_link})")


def phase_planner_benches():
    """9e: the planner-driven benchmarks on the card: bench_llm_inference's
    analytic leg and its serve leg at smoke scale (through the graphs,
    build/BENCH_serve.json), and bench_datapath_bounds."""
    from repro_torch.benchmarks import bench_datapath_bounds, bench_llm_inference

    log("== phase 9e: bench_llm_inference (analytic, serve at smoke scale) and "
        "bench_datapath_bounds on the card")
    rows = bench_llm_inference.analytic()
    if len(rows) != 3 * 8:
        raise AssertionError(f"{len(rows)} analytic rows")
    t0 = time.perf_counter()
    res = bench_llm_inference.serve("cuda")
    saved = json.loads(bench_llm_inference.OUT.read_text())
    if saved != json.loads(json.dumps(res)):
        raise AssertionError("BENCH_serve.json differs from the serve leg's result")
    for key, e in res.items():
        if (e["policy"]["name"] != "hbm_resident" or e["mesh_axes"] is not None
                or set(e["phases"]) != {"decode", "prefill"}
                or e["decode_tokens"] != e["requests"] * e["max_new"]
                or not e["decode_tps"] > 0 or not e["prefill_tps"] > 0):
            raise AssertionError(f"serve leg entry {key}: {e}")
    log(f"  serve leg took {time.perf_counter() - t0:.1f} s; wrote {bench_llm_inference.OUT}")
    bench_datapath_bounds.main("cuda")


def planner_against_measured(measured):
    """The planner's yi-6b ``hbm_resident`` decode step at phase 4's shape
    (8 slots, 2048 positions), on the spec sheet and on phase 9d's
    calibration, beside phase 4's measured step EWMAs.  Information, not a
    gate."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.core.calibration import Calibration
    from repro_torch.core.hardware import SPEC_SYSTEM
    from repro_torch.core.placement import get_policy
    from repro_torch.core.planner import predict
    from repro_torch.models.model_zoo import ModelSizing

    log("== the planner's yi-6b decode step against phase 4's measured steps")
    sizing = ModelSizing(get_config("yi-6b"))
    shape = ShapeSpec("serve", YI["Smax"], YI["B"], "decode")
    prof = sizing.decode_workload(shape)
    cal = Calibration.load(ROOT / "build" / "calibration.json").apply(SPEC_SYSTEM)
    for name, system in (("spec", SPEC_SYSTEM), ("calibrated", cal)):
        p = predict(prof, get_policy("hbm_resident"), system)
        log(f"  planner[{name}]: {p.step_s * 1e3:.3f} ms a step, limited by {p.limiting} "
            f"(params {sizing.cfg.num_params() * 2 / 1e9:.2f} GB + KV "
            f"{sizing.cache_bytes(shape) / 1e9:.2f} GB at full cache)")
    log("  measured_step_s (decode-step wall EWMA): " + ", ".join(
        f"{k} {v * 1e3:.2f} ms" for k, v in measured.items()))


def kernel_row(name, source, replaces, rec, launches, max_abs_err):
    """One entry of the ``kernels`` JSON line; logs it."""
    hbm_bytes_per_s, bf16_flops_per_s, f32_flops_per_s = peaks()
    t_bytes = rec["bytes"] / hbm_bytes_per_s * 1e3
    t_ops = rec["flops"] / bf16_flops_per_s * 1e3
    row = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": rec["ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": rec["library_ms"],
    }
    lib = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms"
    log(f"  {name}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"library {lib}, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}: {rec['bytes']} bytes, {rec['flops']} flops; "
        f"f32 CUDA-core floor {rec['flops'] / f32_flops_per_s * 1e3:.4f} ms), "
        f"{launches} launches on the main path")
    return row


def main() -> int:
    # the script drives one card: show torch only the first visible one, so
    # the device count it reports is the count it used
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0].strip()
    os.environ["CUDA_VISIBLE_DEVICES"] = visible or "0"
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script needs the card",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_build()
    errs = phase_kernels()
    errs.update(phase_train_kernels())
    errs.update(phase_ssd_kernels())
    phase_smoke_parity()
    phase_train_parity()
    phase_ssm_parity()
    launches, stats, plens, server, eager = phase_full()
    measured = {"graphs": server.engine.measured_step_s,
                "eager": eager.engine.measured_step_s}
    rows = phase_times(launches, stats, plens, errs)
    servers = {"graphs": server, "eager": eager}
    profile_decode(servers)
    profile_prefill(servers)
    del server, eager, servers
    torch.cuda.empty_cache()
    phase_granite_full()
    server, eager, params, ssm_launches = phase_mamba_full()
    rows.append(phase_ssd_times({"graphs": server, "eager": eager}, ssm_launches, errs))
    del server, eager, params
    torch.cuda.empty_cache()
    phase_zamba_full()
    out, train_launches = phase_train_full()
    profile_train(out)
    del out
    torch.cuda.empty_cache()
    rows += phase_train_times(train_launches, errs)
    phase_gemm_kernel()
    rows.append(phase_gemm_study())
    torch.cuda.empty_cache()
    rows += phase_membench()
    torch.cuda.empty_cache()
    phase_calibrate()
    phase_planner_benches()
    planner_against_measured(measured)
    log(f"== done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
