"""Two checkouts of the port compared on one card: the KV write-back kernel
and chip_smoke's phase 10b (yi-6b under the Fig. 17 placements), in turns.

    python3 tools/placement_ab.py [--out DIR] build/parent . . build/parent

Each argument is the root of a checkout (a ``git archive`` of the parent,
this tree, ...); each is run in its own process, in the order given, on
the same card.  A run builds that checkout's kernels, then

* times its ``kv_write_back`` at yi-6b's serving shape (8 rows, 4 KV
  heads, 2048 slots, D 128, bf16, into pinned host memory) on the decode
  and on the prefill row set of ``chip_smoke.KV_CASES``, by chip_smoke's
  ``study_ms`` (CUDA events, queued behind a spin kernel); beside it the
  launch floor: a kernel that does nothing on the same grid (where the
  checkout has ``empty_launch``), and one ``cudaMemcpyAsync`` of the same
  16 KB into pinned host memory;
* runs its ``phase_placed_serving`` (10b) with three things swapped in
  from THIS tree's ``chip_smoke.py``: ``replay_traffic`` (so every
  checkout's traces are read the same way, write-back device time and
  stream included), a ``serve_requests`` that hashes every request's
  tokens (SHA-256 per policy, graphs and eager), and the planner's step
  and mapped-read rate on the spec sheet only (``build/calibration.json``
  comes from phase 9, which is not run here).

Prints one JSON line per run and writes them all to
``DIR/placement_ab.json`` (default ``build``), each run's log to
``DIR/placement_ab_<i>.log``.  Needs the card.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]

RUN = r'''
import hashlib, importlib.util, json, sys, time
sys.argv = ["chip_smoke"]
import chip_smoke as c
import torch
from repro_torch.core import membench
from repro_torch.core.hardware import SPEC_SYSTEM
from repro_torch.core.placement import to_host
from repro_torch.core.planner import predict
from repro_torch.kernels import _build, kv_stream
# this tree's chip_smoke, for its trace reader only: the checkout's own
# repro_torch is imported already and stays the one every phase uses
path = list(sys.path)
spec = importlib.util.spec_from_file_location("probe", PROBE)
probe = importlib.util.module_from_spec(spec)
spec.loader.exec_module(probe)
sys.path[:] = path

out = {"root": ROOT, "card": c.nvidia_smi()}
t0 = time.perf_counter()
_build.build()
out["build_s"] = time.perf_counter() - t0

def ms(fn, repeats):
    return membench.measure(fn, warmup=2, repeats=repeats, device="cuda").mean_s * 1e3

B, H, S, D = 8, 4, 2048, 128
gen = torch.Generator(device="cuda").manual_seed(10)
src = {k: torch.randn(B, H, S, D, generator=gen, device="cuda").to(torch.bfloat16)
       for k in "kv"}
dst = to_host({k: torch.zeros(B, H, S, D, dtype=torch.bfloat16) for k in "kv"}, "cuda")
for label, pos, n in c.KV_CASES[:2]:
    p = torch.tensor(pos, dtype=torch.int32, device="cuda")
    cnt = torch.tensor(n, dtype=torch.int32, device="cuda")
    out[f"{label}_ms"] = ms(lambda: kv_stream.kv_write_back(
        src["k"], src["v"], dst["k"], dst["v"], p, cnt), 20 if label == "decode" else 5)
    out[f"{label}_bytes"] = 2 * sum(min(x, S) for x in n) * H * D * 2
    out[f"{label}_gbps"] = out[f"{label}_bytes"] / out[f"{label}_ms"] / 1e6
if hasattr(kv_stream, "empty_launch"):
    blocks = kv_stream.write_back_blocks(S * out["decode_bytes"] // 16,
                                         torch.cuda.get_device_properties(0).multi_processor_count)
    out["empty_ms"] = ms(lambda: kv_stream.empty_launch(blocks), 20)
staged = torch.zeros(out["decode_bytes"], dtype=torch.uint8, device="cuda")
pinned = torch.zeros(out["decode_bytes"], dtype=torch.uint8).pin_memory()
out["memcpy_ms"] = ms(lambda: kv_stream.copy_async(pinned, staged,
                                                   torch.cuda.current_stream()), 20)
del src, dst

traces, hashes = [], []
def replay_traffic(label, fn):
    tr = probe.replay_traffic(label, fn)
    traces.append({"label": label, **{k: v for k, v in tr.items() if k != "sizes"}})
    return tr
serve = c.serve_requests
def serve_requests(bundle, params, scfg, prompts, new_tokens, *, eager=False):
    res = serve(bundle, params, scfg, prompts, new_tokens, eager=eager)
    toks = [r.out_tokens for r in res[1]]
    hashes.append({"policy": scfg.policy, "eager": eager, "requests": len(toks),
                   "sha256": hashlib.sha256(json.dumps(toks).encode()).hexdigest()})
    return res
def planner_steps(sizing, policy, shape):
    pred = predict(sizing.decode_workload(shape), policy, SPEC_SYSTEM)
    return {"spec": pred, "calibrated": pred}
c.replay_traffic, c.serve_requests, c.planner_steps = replay_traffic, serve_requests, planner_steps
if hasattr(c, "mapped_read_rate"):     # the spec sheet's, as for the planner's step
    from repro_torch.core.datapath import read_bound
    from repro_torch.core.hardware import MemoryTier
    c.mapped_read_rate = lambda: read_bound(MemoryTier.HOST, SPEC_SYSTEM).bandwidth
t0 = time.perf_counter()
_, table = c.phase_placed_serving()
out["phase_10b_s"] = time.perf_counter() - t0
out["table"] = table
out["traces"] = traces
out["tokens"] = hashes
print("AB " + json.dumps(out, default=str), flush=True)
'''


def main(argv: list[str]) -> int:
    out = HERE / "build"
    if argv[:1] == ["--out"]:
        out, argv = HERE / argv[1], argv[2:]
    roots = argv
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    results = []
    out.mkdir(parents=True, exist_ok=True)
    for i, root in enumerate(roots):
        root = pathlib.Path(root).resolve()
        code = f"ROOT = {str(root)!r}; PROBE = {str(HERE / 'chip_smoke.py')!r}\n" + RUN
        proc = subprocess.run([sys.executable, "-c", code], cwd=root, text=True,
                              capture_output=True)
        (out / f"placement_ab_{i}.log").write_text(proc.stdout + proc.stderr)
        line = [x for x in proc.stdout.splitlines() if x.startswith("AB ")]
        if proc.returncode != 0 or not line:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            print(f"placement_ab: the run in {root} failed ({proc.returncode})",
                  file=sys.stderr)
            return 1
        results.append(json.loads(line[0][3:]))
        print(line[0], flush=True)
    (out / "placement_ab.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
