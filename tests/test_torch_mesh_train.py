"""Training over ``data`` and ``model`` axes (ROADMAP A10b, training half),
held to the reference's ``TestParallelConsistency``
(``tests/test_distributed.py``), through gloo ranks on the CPU
(``tests/torch_ranks.py``):

* granite-8b-smoke on a (2, 2, 2) ``pod``/``data``/``model`` mesh, 8
  ranks, 4 AdamW steps (seq 32, batch 8, ``remat="none"``, lr 1e-3,
  warm-up 1) from the reference's initial weights: the bf16 losses equal
  the reference's one-device losses at rtol = atol = 2e-3 (its limit);
  in float32 the losses equal the port's own ``mesh=None`` run at
  rtol = atol = 1e-4, the first step's ``grad_norm`` (same weights, same
  rows: the sharded reductions alone) at 1e-5 and every step's at 5e-3
  (Adam's normalization turns rounding-level differences of near-zero
  gradients into whole steps, so later norms drift).  In bf16 the same
  comparison moves by more than 1e-4 in the loss (the ranks' partial
  products round at other points than one device's): bf16 is held to
  the reference's limit only;
* ZeRO-1 and ZeRO-3 on (1, 2, 1), float32: equal to each other and to one
  device at 1e-4; ``gather_full`` of ``shard_of`` gives each leaf back bit
  for bit; each rank's resident params and optimizer state are the
  sums of its local shard sizes (ZeRO-3 params half of one device's,
  ZeRO-1 params all of it, the optimizer state half either way); a ZeRO-3
  step holds at most two gathered windows;
* a 4-rank ``model`` mesh over granite's 2 kv heads replicates them (each
  rank slices its one) and equals one device at 1e-4;
* yi-6b-smoke under ``opt_host`` on (2, 2) ``data``/``model`` equals
  ``hbm_resident`` at 1e-4, its master in host memory (the reference's
  ``test_opt_host_offload_runs_and_matches``);
* ``launch.train --mesh 1x2x1`` under torchrun with two gloo ranks trains;
* a ``model`` axis over MoE, SSM, MLA, the encoder-decoder or the VLM
  raises naming ROADMAP A10b, rest, and query heads that straddle GQA
  groups over replicated kv heads raise by name.
"""

import dataclasses
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.launch.mesh import make_mesh_for as jax_mesh_for
from repro.models.model_zoo import ModelBundle as JaxBundle
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import init_train_state as jax_init_train_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch import convert
from repro_torch.configs import AttentionSpec, smoke_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models import attention
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.models.sharding import tree_leaves, tree_map, use_sharding
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, make_train_step, place_train_state
from torch_ranks import ROOT, run_ranks

jax.config.update("jax_platform_name", "cpu")

#: tests/test_distributed.py's limit between a sharded and a one-device run
REF_TOL = dict(rtol=2e-3, atol=2e-3)
#: a float32 mesh run against the port's mesh=None run
TOL = dict(rtol=1e-4, atol=1e-4)
STEPS, LR = 4, 1e-3

#: one training run inside a rank: ``arch``'s smoke config in ``dtype``
#: from the full weights ``start`` on ``mesh``; (losses, grad norms)
_TRAIN = """
import dataclasses
import numpy as np
from repro_torch.configs import smoke_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.models.sharding import tree_leaves, tree_map
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, batch_shard, make_train_step, place_train_state

def train(arch, dtype, start, mesh, steps, seq=32, batch=8, **kw):
    b = ModelBundle(dataclasses.replace(smoke_config(arch), dtype=dtype))
    tcfg = TrainConfig(remat="none", optimizer=AdamWConfig(lr=1e-3, warmup_steps=1), **kw)
    start = tree_map(lambda t: t.to(getattr(torch, dtype)), start)
    params, opt, ef = place_train_state(b, start, tcfg, mesh)
    step = make_train_step(b, tcfg, mesh)
    i, n = batch_shard(batch, mesh)
    data = SyntheticLM(DataConfig(vocab=b.cfg.vocab, seq_len=seq, global_batch=batch),
                       process_index=i, process_count=n)
    losses, norms = [], []
    for _ in range(steps):
        batch_ = {k: torch.from_numpy(v) for k, v in next(data).items()}
        params, opt, ef, m = step(params, opt, ef, batch_)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return dict(losses=losses, norms=norms, params=params, opt=opt, step=step)

def nbytes(tree):
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's own runs, as for its ranks:
    the cores stay with the ranks and the suite's other workers.
    Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def granite():
    """The reference's one-device run of granite-8b-smoke (4 AdamW steps,
    8 x 32 tokens) and its initial weights, carried across."""
    jb = JaxBundle(jax_smoke_config("granite-8b"))
    mesh = jax_mesh_for((1,), ("data",))
    tcfg = JaxTrainConfig(remat="none", optimizer=JaxAdamWConfig(lr=LR, warmup_steps=1))
    params, opt, ef = jax_init_train_state(jb, mesh, jax.random.PRNGKey(0), tcfg)
    start = convert.params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    step = jax.jit(jax_make_train_step(jb, mesh, tcfg))
    data = JaxSyntheticLM(JaxDataConfig(vocab=jb.cfg.vocab, seq_len=32, global_batch=8))
    losses = []
    for _ in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in next(data).items()}
        params, opt, ef, m = step(params, opt, ef, batch)
        losses.append(float(m["loss"]))
    return start, losses


def _one_device(arch, start, dtype="float32", steps=STEPS, seq=32, batch=8, **kw):
    """The port's mesh=None run: (losses, grad norms)."""
    b = ModelBundle(dataclasses.replace(smoke_config(arch), dtype=dtype))
    tcfg = TrainConfig(remat="none", optimizer=AdamWConfig(lr=LR, warmup_steps=1), **kw)
    params, opt, ef = place_train_state(
        b, tree_map(lambda t: t.to(getattr(torch, dtype)), start), tcfg)
    step = make_train_step(b, tcfg)
    data = SyntheticLM(DataConfig(vocab=b.cfg.vocab, seq_len=seq, global_batch=batch))
    losses, norms = [], []
    for _ in range(steps):
        params, opt, ef, m = step(params, opt, ef,
                                  {k: torch.from_numpy(v) for k, v in next(data).items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms


def _hold_norms(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=5e-3)


def test_granite_2x2x2_equals_the_reference_and_one_device(granite, tmp_path):
    start, ref_losses = granite
    outs = run_ranks(_TRAIN + """
mesh = make_mesh_for((2, 2, 2), ("pod", "data", "model"))
for dtype in ("bfloat16", "float32"):
    r = train("granite-8b", dtype, inputs, mesh, 4)
    out[dtype] = (r["losses"], r["norms"])
""", 8, tmp_path, inputs=start, timeout=240)
    assert all(o == outs[0] for o in outs)
    bf16, f32 = outs[0]["bfloat16"], outs[0]["float32"]
    np.testing.assert_allclose(bf16[0], ref_losses, **REF_TOL)
    losses, norms = _one_device("granite-8b", start)
    np.testing.assert_allclose(f32[0], losses, **TOL)
    _hold_norms(f32[1], norms)


def test_zero1_and_zero3_on_two_data_ranks(granite, tmp_path):
    start, _ = granite
    outs = run_ranks(_TRAIN + """
from repro_torch.models.sharding import gather_full, local_shape, shard_of, tree_leaves
from repro_torch.train import make_state_specs
mesh = make_mesh_for((1, 2, 1), ("pod", "data", "model"))
for zero in (1, 3):
    r = train("granite-8b", "float32", inputs, mesh, 4, zero_stage=zero)
    b = ModelBundle(dataclasses.replace(smoke_config("granite-8b"), dtype="float32"))
    pspecs, ospecs = make_state_specs(b, mesh, zero_stage=zero)
    shard_bytes = lambda specs: 4 * sum(
        int(np.prod(local_shape(p.shape, s, mesh)))
        for p, s in zip(tree_leaves(b.param_defs()), tree_leaves(specs)))
    src = r["step"].placed.get("source")
    out[f"roundtrip{zero}"] = all(torch.equal(gather_full(shard_of(p, sp, mesh), sp, mesh), p)
                                  for p, sp in zip(tree_leaves(inputs), tree_leaves(
                                      tree_map(lambda _, sp: sp, inputs, pspecs))))
    out[zero] = dict(losses=r["losses"], norms=r["norms"], params=nbytes(r["params"]),
                     opt=nbytes({k: r["opt"][k] for k in ("master", "mu", "nu")}),
                     want_params=shard_bytes(pspecs), want_opt=3 * shard_bytes(ospecs["master"]),
                     peak=src and src.peak_bytes, windows=src and src.window_bytes,
                     gathers=src and src.gathers)
""", 2, tmp_path,
                     inputs=start, timeout=180)
    full = sum(4 * t.numel() for t in tree_leaves(start))
    losses, norms = _one_device("granite-8b", start)
    for zero in (1, 3):
        o = outs[0][zero]
        np.testing.assert_allclose(o["losses"], losses, **TOL)
        _hold_norms(o["norms"], norms)
        assert o["params"] == o["want_params"] and o["opt"] == o["want_opt"]
        assert o["opt"] * 2 == 3 * full
        assert outs[1][zero]["losses"] == o["losses"]
    assert outs[0][3]["params"] * 2 == full and outs[0][1]["params"] == full
    assert all(o["roundtrip1"] and o["roundtrip3"] for o in outs)
    np.testing.assert_allclose(outs[0][1]["losses"], outs[0][3]["losses"], **TOL)
    z3 = outs[0][3]
    assert outs[0][1]["peak"] is None
    assert max(z3["windows"]) < z3["peak"] <= 2 * max(z3["windows"])
    # the forward sweep and the backward's re-fetch: every window twice a
    # step but the tail, which the forward reads with grad once
    assert z3["gathers"] == 2 * len(z3["windows"]) - 1


def test_kv_heads_replicate_over_a_wider_model_axis(granite, tmp_path):
    start, _ = granite
    cfg = smoke_config("granite-8b").attention
    assert cfg.n_kv_heads % 4 and cfg.n_heads % 4 == 0
    outs = run_ranks(_TRAIN + """
mesh = make_mesh_for((4,), ("model",))
r = train("granite-8b", "float32", inputs, mesh, 2)
out["m"] = (r["losses"], r["norms"])
layer = r["params"]["stages"][0]["0F"]["attn"]
out["shapes"] = {k: tuple(layer[k].shape) for k in ("w_q", "w_k", "w_o")}
""", 4, tmp_path, inputs=start, timeout=180)
    layer = start["stages"][0]["0F"]["attn"]
    L, d, hq, dh = layer["w_q"].shape
    assert outs[0]["shapes"] == {"w_q": (L, d, hq // 4, dh), "w_k": tuple(layer["w_k"].shape),
                                 "w_o": (L, hq // 4, dh, d)}
    losses, norms = _one_device("granite-8b", start, steps=2)
    np.testing.assert_allclose(outs[0]["m"][0], losses, **TOL)
    _hold_norms(outs[0]["m"][1], norms)
    assert all(o["m"] == outs[0]["m"] for o in outs)


def test_opt_host_on_a_data_model_mesh_equals_hbm_resident(tmp_path):
    b = ModelBundle(smoke_config("yi-6b"))
    start = b.init_params(torch.Generator().manual_seed(0))
    outs = run_ranks(_TRAIN + """
mesh = make_mesh_for((2, 2), ("data", "model"))
for policy in ("hbm_resident", "opt_host"):
    r = train("yi-6b", "bfloat16", inputs, mesh, 3, seq=16, batch=4, policy=policy)
    out[policy] = r["losses"]
    out[policy + "_host"] = all(getattr(t, "_host_arena", None) is not None
                                for t in tree_leaves(r["opt"]["master"]))
""", 4, tmp_path, inputs=start, timeout=180)
    o = outs[0]
    assert o["opt_host_host"] and not o["hbm_resident_host"]
    np.testing.assert_allclose(o["opt_host"], o["hbm_resident"], **TOL)


def test_launcher_trains_a_data_axis_under_torchrun(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", "--arch", "olmo-1b",
         "--smoke", "--device", "cpu", "--mesh", "1x2x1", "--steps", "3", "--batch", "4",
         "--seq", "16", "--log-every", "1", "--ckpt-dir", str(tmp_path)],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=240,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    for r in (0, 1):
        assert f"rank {r} of 2 on the mesh {{'pod': 1, 'data': 2, 'model': 1}}, batch rows " \
               f"{r} of 2" in res.stderr, res.stderr[-4000:]
    assert res.stderr.count("done: 3 steps") == 2, res.stderr[-4000:]


@pytest.mark.parametrize("arch,what", [
    ("llama4-maverick-400b-a17b", "MoE experts"), ("mamba2-780m", "M/S layers"),
    ("zamba2-1.2b", "M/S layers"), ("deepseek-v2-236b", "MLA"),
    ("seamless-m4t-medium", "the encoder-decoder"), ("internvl2-1b", "the VLM"),
])
def test_model_axis_over_families_without_tp_layers_raises(arch, what):
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 2))
    with pytest.raises(NotImplementedError, match=f"{what}.*A10b, rest"):
        make_train_step(ModelBundle(smoke_config(arch)), TrainConfig(), mesh)


def test_query_heads_straddling_gqa_groups_raise():
    spec = AttentionSpec(n_heads=6, n_kv_heads=3, d_head=8)
    defs = attention.attention_defs(16, spec)
    params = {k: torch.zeros(p.shape) for k, p in defs.items()}
    mesh = types.SimpleNamespace(mesh_dim_names=("model",), shape=(2,),
                                 get_group=lambda a: None, get_local_rank=lambda a: 0)
    with use_sharding(mesh), pytest.raises(NotImplementedError, match="straddle the GQA"):
        attention.gqa_train(params, torch.zeros(1, 4, 16), spec, "F")
