"""Which streams a ``kv_host`` server's capture, window copies and KV
write-backs run on, after any number of draws from PyTorch's stream pool.

    python3 tools/stream_pool.py ROOT [ROOT ...]

Each argument is the root of a checkout of the port (this tree, a ``git
archive`` of another commit); each runs in its own process on the card.
A run builds yi-6b-smoke (bfloat16) 33 times under ``kv_host`` (3 slots,
64 positions, prefill chunks of 8), each time after one more
``torch.cuda.Stream()`` draw than the last, so the pool's cursor stands
at every one of its 32 places once.  For each build it prints one JSON
line: the capture stream (the executor's own where it has one, else
``torch.cuda.graph``'s default capture stream), the cache stream's copy
and write-back streams, whether one of those is the capture stream, and
whether a traced prefill replay's write-back kernels ran on the stream
most other kernels ran on (``chip_smoke.replay_traffic``, the reading
phase 10b checks).  Then one ``SUMMARY`` line per checkout: the builds
whose write-back or copy stream was the capture stream, and those whose
write-backs ran on the compute stream.  Needs the card.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys
import textwrap

_RUN = textwrap.dedent('''
    import dataclasses, gc, json, sys, time
    import numpy as np
    import torch
    root = sys.argv[1]
    sys.path[:0] = [root + "/src", root]
    import chip_smoke as cs
    from repro_torch.configs import smoke_config
    from repro_torch.models.model_zoo import ModelBundle
    from repro_torch.serve import ServeConfig, Server

    t0 = time.perf_counter()
    tb = ModelBundle(dataclasses.replace(smoke_config("yi-6b"), dtype="bfloat16"))
    params = tb.init_params(torch.Generator(device="cuda").manual_seed(0))
    rows = []
    for k in range(33):
        torch.cuda.Stream()
        srv = Server(tb, ServeConfig(batch_slots=3, max_len=64, prefill_chunk=8,
                                     policy="kv_host"), params, device="cuda")
        eng = srv.engine
        cap = getattr(eng, "_stream", None) or torch.cuda.graph.default_capture_stream
        ids = dict(capture=cap.cuda_stream, copy=eng.feed.kv._copy_stream.cuda_stream,
                   write_back=eng.feed.kv._wb_stream.cuda_stream)
        eng.stage_prefill(np.ones((3, 8), np.int32), np.full(3, 8, np.int32),
                          np.arange(0, 24, 8, dtype=np.int32))
        torch.cuda.synchronize()
        tr = cs.replay_traffic("stream_pool", eng._graphs["prefill"].replay)
        row = dict(draws=k + 1, write_back_is_capture=ids["write_back"] == ids["capture"],
                   copy_is_capture=ids["copy"] == ids["capture"],
                   on_compute=tr["compute_stream"] in tr["write_back_streams"],
                   write_backs=tr["write_backs"], **{n: hex(v) for n, v in ids.items()})
        print(json.dumps(row), flush=True)
        rows.append(row)
        del srv, eng
        gc.collect()
        torch.cuda.empty_cache()
    print("SUMMARY", root, json.dumps(dict(
        capture_shared=[r["draws"] for r in rows
                        if r["write_back_is_capture"] or r["copy_is_capture"]],
        on_compute=[r["draws"] for r in rows if r["on_compute"]],
        seconds=time.perf_counter() - t0)), flush=True)
''')


def main(argv: list[str]) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for root in argv:
        root = str(pathlib.Path(root).resolve())
        rc |= subprocess.run([sys.executable, "-c", _RUN, root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
