"""Quickstart: train a reduced-config LM for a few AdamW steps.

    python -m repro_torch.examples.quickstart [--arch granite-8b] [--device cpu]

Counterpart of the reference's ``examples/quickstart.py``: the config
registry, the model bundle, the train state, the train step and the data
pipeline in a few lines.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models.model_zoo import get_smoke_bundle
from repro_torch.models.sharding import tree_leaves
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, init_train_state, make_train_step


def main(argv: list[str] | None = None) -> list[float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    bundle = get_smoke_bundle(args.arch)
    tcfg = TrainConfig(
        remat="none",
        optimizer=AdamWConfig(lr=3e-3, warmup_steps=5, weight_decay=0.0),
    )
    params, opt_state, ef = init_train_state(
        bundle, torch.Generator(device=device).manual_seed(0), tcfg
    )
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"{args.arch} (reduced): {n_params/1e6:.2f}M params on {device}")

    step = make_train_step(bundle, tcfg)
    data = SyntheticLM(
        DataConfig(vocab=bundle.cfg.vocab, seq_len=32, global_batch=8,
                   structure=1.0)
    )
    losses = []
    for i, batch in zip(range(args.steps), data):
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        params, opt_state, ef, metrics = step(params, opt_state, ef, batch)
        losses.append(float(metrics["loss"]))
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:3d}  loss {losses[-1]:.4f}  "
                  f"grad_norm {float(metrics['grad_norm']):.3f}")
    return losses


if __name__ == "__main__":
    main()
