"""``data``/``model`` axes of one rank: the training step shards over
neither, as the reference's XLA makes FSDP and tensor parallelism over a
one-rank axis no-ops.

* two gloo ranks train olmo-1b-smoke on a (2, 1, 1) ``pod``/``data``/
  ``model`` mesh and on a (2,) ``pod`` mesh, under ``hbm_resident`` and
  ``weights_stream`` with ``remat="none"``: the losses, grad norms and
  params are the same bit for bit, and no ZeRO-3 window is gathered;
  ``make_train_step(..., one_rank=True)`` gathers ZeRO-3's windows over
  the one-rank ``data`` axis and holds the same losses;
* ``launch.train --mesh 2x1x1 --policy weights_stream --remat none`` under
  ``torchrun --standalone`` with two ranks trains (the launcher's
  documented pod run, with its params in host memory).
"""

import os
import subprocess
import sys

import torch

from torch_ranks import ROOT, run_ranks


def test_one_rank_data_and_model_axes_train_as_a_pod_mesh(tmp_path):
    outs = run_ranks("""
        from repro_torch.configs import smoke_config
        from repro_torch.data import DataConfig, SyntheticLM
        from repro_torch.launch.mesh import make_mesh_for
        from repro_torch.models.model_zoo import ModelBundle
        from repro_torch.models.sharding import tree_leaves
        from repro_torch.optim import AdamWConfig
        from repro_torch.train import TrainConfig, init_train_state, make_train_step
        b = ModelBundle(smoke_config("olmo-1b"))
        runs = [("pod", (2,), "hbm_resident", "none", False),
                ("pod", (2,), "weights_stream", "none", False),
                ("pod-data-model", (2, 1, 1), "hbm_resident", "none", False),
                ("pod-data-model", (2, 1, 1), "weights_stream", "none", False),
                ("pod-data-model", (2, 1, 1), "hbm_resident", "full", True)]
        for name, dims, policy, remat, one_rank in runs:
            mesh = make_mesh_for(dims, ("pod", "data", "model")[:len(dims)])
            tcfg = TrainConfig(remat=remat, policy=policy,
                               optimizer=AdamWConfig(lr=1e-3, warmup_steps=1))
            params, opt, ef = init_train_state(b, torch.Generator().manual_seed(0), tcfg, mesh)
            step = make_train_step(b, tcfg, mesh, one_rank=one_rank)
            data = SyntheticLM(DataConfig(vocab=b.cfg.vocab, seq_len=16, global_batch=4),
                               process_index=rank, process_count=world)
            losses, norms = [], []
            for _ in range(2):
                batch = {k: torch.from_numpy(v) for k, v in next(data).items()}
                params, opt, ef, m = step(params, opt, ef, batch)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
            out[f"{name}/{policy}/{remat}/{one_rank}"] = dict(
                losses=losses, norms=norms, params=[t.clone() for t in tree_leaves(params)],
                windows=step.placed.get("source") is not None)
    """, 2, tmp_path, timeout=240)
    for r in outs:
        for policy in ("hbm_resident", "weights_stream"):
            pod, mesh = r[f"pod/{policy}/none/False"], r[f"pod-data-model/{policy}/none/False"]
            assert not mesh["windows"] and not pod["windows"]
            assert mesh["losses"] == pod["losses"] and mesh["norms"] == pod["norms"]
            assert all(torch.equal(a, b) for a, b in zip(mesh["params"], pod["params"]))
        forced = r["pod-data-model/hbm_resident/full/True"]
        assert forced["windows"]
        assert forced["losses"] == r["pod/hbm_resident/none/False"]["losses"]
    assert outs[0]["pod/hbm_resident/none/False"]["losses"] == \
        outs[1]["pod/hbm_resident/none/False"]["losses"]


def test_launcher_trains_a_2x1x1_mesh_with_params_in_host_memory(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", "--arch", "olmo-1b",
         "--smoke", "--device", "cpu", "--mesh", "2x1x1", "--policy", "weights_stream",
         "--remat", "none", "--steps", "2", "--batch", "4", "--seq", "16",
         "--log-every", "1", "--ckpt-dir", str(tmp_path)],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=240,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    for r in (0, 1):
        assert f"rank {r} of 2 on the pod axis" in res.stderr, res.stderr[-4000:]
    assert res.stderr.count("done: 2 steps") == 2, res.stderr[-4000:]
    assert "ZeRO-3" not in res.stderr and "A10b" not in res.stderr, res.stderr[-4000:]
