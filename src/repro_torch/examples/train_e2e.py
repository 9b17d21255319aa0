"""End-to-end training driver: a ~100M-parameter LM for a few hundred steps.

    python -m repro_torch.examples.train_e2e                      # repro-100m, 300 steps
    python -m repro_torch.examples.train_e2e --tiny --device cpu  # repro-tiny, 30 steps

Counterpart of the reference's ``examples/train_e2e.py``: the model bundle,
remat, the prefetching data pipeline, the fault-tolerant supervisor with
async checkpoints and straggler monitoring, and a resume from the last
checkpoint at the end, on one device (``mesh=None``, the reference's
one-device mesh).  Runs on the card unless ``--device cpu``.

``repro-100m`` is 12 layers, d_model 768, d_ff 2048, vocab 32000, GQA
12:4 at head dim 64, float32: 100.07 M params.  It trains for 300 steps
at batch 16 x 256 tokens under remat ``full``; ``--tiny`` is
``repro-tiny``, 30 steps at 8 x 32 without remat.

A checkpoint is written every quarter of the run (``steps // 4`` steps;
the reference's ``max(50, steps // 4)`` writes none in a 30-step run).  At
the end the latest one is restored into a fresh state and the steps after
it are replayed on the same batches: the replayed losses must equal the
run's, and with no step to replay the restored state must equal the final
state bit for bit.  The run fails unless the loss decreased.
"""

from __future__ import annotations

import argparse
import logging
import os
import pathlib
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ArchConfig, AttentionSpec
from repro_torch.data import DataConfig, Prefetcher, SyntheticLM
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.models.sharding import tree_leaves
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import Supervisor, SupervisorConfig
from repro_torch.train import TrainConfig, init_train_state, make_train_step

log = logging.getLogger("repro_torch.train_e2e")

#: default checkpoint directory: build/ckpt-e2e at the repository root
#: (git-ignored)
DEFAULT_CKPT_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "ckpt-e2e"


def config_100m() -> ArchConfig:
    """~100M decoder-only LM (llama-style family)."""
    return ArchConfig(
        name="repro-100m",
        family="dense",
        n_layers=12,
        d_model=768,
        d_ff=2048,
        vocab=32_000,
        layer_pattern="F",
        norm="rmsnorm",
        attention=AttentionSpec(n_heads=12, n_kv_heads=4, d_head=64),
        act="silu",
        dtype="float32",
    )


def config_tiny() -> ArchConfig:
    return ArchConfig(
        name="repro-tiny",
        family="dense",
        n_layers=2,
        d_model=64,
        d_ff=128,
        vocab=512,
        layer_pattern="F",
        norm="rmsnorm",
        attention=AttentionSpec(n_heads=4, n_kv_heads=2, d_head=16),
        dtype="float32",
    )


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR),
                    help="where each run makes its own checkpoint directory "
                         "(default: build/ckpt-e2e at the repository root)")
    return ap.parse_args(argv)


def train(args: argparse.Namespace) -> dict:
    """Train, then resume from the last checkpoint.  Returns the losses,
    the step times (s), the final state, the bundle and config, the
    straggler stats, the checkpoint's step and the replayed losses."""
    device = resolve_device(args.device)
    cfg = config_tiny() if args.tiny else config_100m()
    steps = args.steps or (30 if args.tiny else 300)
    batch = args.batch or (8 if args.tiny else 16)
    seq = args.seq or (32 if args.tiny else 256)

    bundle = ModelBundle(cfg)
    tcfg = TrainConfig(
        remat="none" if args.tiny else "full",
        optimizer=AdamWConfig(lr=1e-3, warmup_steps=min(50, steps // 5 + 1),
                              weight_decay=0.01),
    )
    params, opt, ef = init_train_state(
        bundle, torch.Generator(device=device).manual_seed(0), tcfg)
    n = sum(t.numel() for t in tree_leaves(params))
    log.info("%s: %.2fM params on %s, %d steps, batch %d x seq %d",
             cfg.name, n / 1e6, device, steps, batch, seq)

    step_fn = make_train_step(bundle, tcfg)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                          structure=0.9)
    data = SyntheticLM(data_cfg)
    it = Prefetcher(data)
    os.makedirs(args.ckpt_dir, exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="run_", dir=args.ckpt_dir)   # this run's own
    ckpt = Checkpointer(ckpt_dir)
    sup = Supervisor(ckpt, SupervisorConfig(checkpoint_every=max(1, steps // 4)))

    losses, step_s = [], []

    def run_one(state, batch_np):
        t0 = time.perf_counter()
        b = {k: torch.from_numpy(v).to(device) for k, v in batch_np.items()}
        p, o, e, m = step_fn(state["p"], state["o"], state["e"], b)
        return {"p": p, "o": o, "e": e}, m, float(m["loss"]), time.perf_counter() - t0

    def one_step(state, batch_np):
        state, m, loss, dt = run_one(state, batch_np)
        losses.append(loss)
        step_s.append(dt)
        if len(losses) % 25 == 0:
            log.info("step %4d  loss %.4f  (%.3f s)", len(losses), loss, dt)
        return state, m

    state = {"p": params, "o": opt, "e": ef}
    try:
        state, done = sup.run(state, one_step, it, steps,
                              extra_state=lambda: {"data": data.state()})
    finally:
        it.close()
    stragglers = sup.monitor.summary()
    log.info("finished %d steps: loss %.4f -> %.4f | straggler stats: %s",
             done, losses[0], losses[-1], stragglers)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not decrease: {losses[0]} -> {losses[-1]}")

    # resume: the latest checkpoint into new tensors (the restore reads
    # only the structure and devices of its template), then the steps
    # after it on the same batches
    if ckpt.latest_step() is None:
        raise AssertionError(f"no checkpoint in {ckpt_dir}")
    restored, manifest = ckpt.restore(state)
    resumed = manifest["extra"]["step"]
    replay = SyntheticLM(data_cfg)
    replay.restore({"step": resumed, "seed": data_cfg.seed})
    replayed = []
    for _ in range(done - resumed):
        restored, _, loss, _ = run_one(restored, next(replay))
        replayed.append(loss)
    if replayed != losses[resumed:done]:
        raise AssertionError(f"resumed at step {resumed}: losses {replayed} != "
                             f"{losses[resumed:done]}")
    if not replayed:
        differ = [(i, tuple(a.shape), a.dtype, float((a.double() - b.double()).abs().max()))
                  for i, (a, b) in enumerate(zip(tree_leaves(restored), tree_leaves(state)))
                  if not torch.equal(a, b)]
        if differ:
            raise AssertionError(f"the checkpoint of step {resumed} differs from the final "
                                 f"state in {len(differ)} leaves (index, shape, dtype, max "
                                 f"|difference|): {differ[:6]}")
    log.info("resumed from the checkpoint of step %d in %s: %s", resumed, ckpt_dir,
             f"{len(replayed)} steps replayed, losses identical" if replayed
             else "state identical to the final one")
    return dict(losses=losses, step_s=step_s, state=state, bundle=bundle, cfg=cfg,
                tcfg=tcfg, batch=batch, seq=seq, steps=done, stragglers=stragglers,
                resumed=resumed, replayed=replayed, ckpt_dir=ckpt_dir)


def main(argv=None) -> list[float]:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    return train(parse_args(argv))["losses"]


if __name__ == "__main__":
    main()
