"""Serving under a ``data`` x ``model`` mesh (ROADMAP A10b, serving half)
and ``Supervisor.rescale``, held to the reference through gloo ranks on
the CPU (``tests/torch_ranks.py``).  One 4-rank spawn serves every case
and keeps what each test reads:

* yi-6b-smoke (1 kv head: replicated over ``model`` 2), granite-8b-smoke
  (2 kv heads: split), olmo-1b-smoke (MHA) and gemma3-27b-smoke (the
  ``L``/``G`` ring layers, a 40-token prompt wrapping the rings of 32) in
  float32 on a (2, 2) mesh serve 6 requests of mixed prompt lengths over
  chunked prefill and decode: the greedy tokens equal the reference
  ``Server``'s (``mesh=None``) token for token, the last decode step's
  gathered logits the port's ``mesh=None`` logits at rtol = atol = 1e-4,
  and each rank's cache and params are its local shards;
* granite-smoke on a 4-rank ``model`` axis replicates its 2 kv heads:
  ranks 2 and 3 attend head 1 in place; tokens the reference's;
* yi-smoke under ``kv_host``, and under ``weights_stream`` replanned to
  ``kv_host`` mid-serve, on the same mesh gives ``hbm_resident``'s
  tokens; sampled requests draw as on one device; ``batch_slots = 3``
  over ``data`` 2 replicates the slots and changes no token (these
  runs serve the first :data:`SIDE` prompts);
* preemption on a (2, 1) mesh over ranks 0 and 1 (spill verification on):
  a slot spilled from one data rank and restored (into the other rank's
  slot too: the rows are carried there) gives the uninterrupted tokens;
* ``Supervisor.rescale`` of granite-smoke's training state from a
  (1, 2, 2) mesh onto a 2-rank (1, 2, 1) one: gathered, the state is bit
  for bit the one before, and the next AdamW step equals the step of a
  2-rank run started from that state, bit for bit.

Also: ``launch.serve --mesh 2x2`` under torchrun with 4 gloo ranks serves
the one-process launcher's tokens; MoE, SSM, MLA, encoder-decoder and VLM
serving on ``model`` 2, rules over ``seq``, donor axes and the asyncio
``Scheduler`` over several ranks raise by name, without spawning ranks.
"""

import concurrent.futures
import dataclasses
import os
import re
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models.model_zoo import ModelBundle as JaxBundle
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import Server as JaxServer
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.launch import serve as serve_launcher
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.serve import (
    Executor,
    Request,
    SamplingParams,
    Scheduler,
    ServeConfig,
    Server,
)
from torch_ranks import ROOT, run_ranks

jax.config.update("jax_platform_name", "cpu")

#: a float32 mesh run's logits against the port's mesh=None run
TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("yi-6b", "granite-8b", "olmo-1b", "gemma3-27b")
CFG = dict(batch_slots=4, max_len=64, prefill_chunk=4)
PROMPT_LENS = (9, 14, 3, 6, 1, 40)
NEW = 5
#: the prompts the yi-smoke runs past the first serve (the short ones)
SIDE = 4

#: what every rank runs: the serving cases on (2, 2), preemption on a
#: (2, 1) mesh of ranks 0 and 1, the rescale of a training state
_BODY = """
import dataclasses
import numpy as np
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.configs import smoke_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.models.sharding import P, shard_of, tree_leaves, tree_map
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import Supervisor
from repro_torch.serve import Request, ServeConfig, Server
from repro_torch.train import (TrainConfig, batch_shard, make_state_specs, make_train_step,
                               place_train_state)

def bundle(arch):
    return ModelBundle(dataclasses.replace(smoke_config(arch), dtype="float32"))

def serve(arch, mesh, record=False, new=lambda i: inputs["new"], sampling=None,
          replan=None, n=None, **kw):
    b = bundle(arch)
    server = Server(b, ServeConfig(**{**inputs["cfg"], **kw}), inputs["params"][arch],
                    device="cpu", mesh=mesh)
    seen = {}
    if record:
        step = b.decode_step
        def decode_step(*a, **k):
            logits, caches = step(*a, **k)
            seen["logits"] = logits.clone()
            return logits, caches
        b.decode_step = decode_step
    reqs = [Request(rid=i, prompt=p, max_new_tokens=new(i),
                    **({} if sampling is None else {"sampling": sampling(i)}))
            for i, p in enumerate(inputs["prompts"][arch][:n])]
    server.add_requests(reqs)
    if replan is not None:
        for _ in range(4):
            server.step()
        server.replan(replan)
    server.run_until_done(max_steps=2000)
    return server, [r.out_tokens for r in reqs], seen.get("logits")

mesh = make_mesh_for((2, 2), ("data", "model"))
for arch in inputs["archs"]:
    server, tokens, logits = serve(arch, mesh, record=True)
    attn = server.params["stages"][0]["0" + smoke_config(arch).layer_pattern[0]]["attn"]
    out[arch] = dict(tokens=tokens, logits=logits,
                     rows=(server.engine.rows.start, server.engine.rows.stop),
                     cache=tuple(tree_leaves(server.engine.caches)[0].shape),
                     w_q=tuple(attn["w_q"].shape), w_k=tuple(attn["w_k"].shape),
                     embed=tuple(server.params["embed"]["embedding"].shape))
# granite's 2 kv heads replicated over a 4-rank model axis: ranks 2 and
# 3 attend kv head 1, read in place (``kv_head``)
side = inputs["side"]
server, out["granite_m4"], _ = serve("granite-8b", make_mesh_for((4,), ("model",)), n=side)
out["granite_m4_cache"] = tuple(tree_leaves(server.engine.caches)[0].shape)
server, out["kv_host"], _ = serve("yi-6b", mesh, policy="kv_host", n=side)
out["kv_host_policy"] = server.policy.name
server, out["replanned"], _ = serve("yi-6b", mesh, policy="weights_stream", replan="kv_host",
                                    n=side)
out["replanned_policy"] = (server.policy.name, server.stats()["migrations"])
from repro_torch.serve import SamplingParams
_, out["sampled"], _ = serve("yi-6b", mesh, sampling=lambda i: SamplingParams(
    temperature=0.8, seed=10 + i), n=side)
server, out["slots3"], _ = serve("yi-6b", mesh, batch_slots=3, n=side)
out["slots3_rows"] = (server.engine.rows.start, server.engine.rows.stop)

# preemption over two of the four ranks: ranks 2 and 3 hold no slot
sub = DeviceMesh("cpu", torch.arange(2).view(2, 1), mesh_dim_names=("data", "model"))
if sub.get_coordinate() is not None:
    server, out["preempt"], _ = serve("yi-6b", sub, new=lambda i: 6 + 2 * i, batch_slots=2,
                                      max_len=48, preempt=True, preempt_wait=2,
                                      verify_spills=True)
    out["preempt_stats"] = server.stats()
    out["preempt_moves"] = [m[0] for m in server.engine.moves]

# rescale: granite-smoke trained 2 steps on (1, 2, 2), moved onto the
# 2-rank (1, 2, 1) mesh of ranks 0 and 1
b = bundle("granite-8b")
tcfg = TrainConfig(remat="none", optimizer=AdamWConfig(lr=1e-3, warmup_steps=1))
old = make_mesh_for((1, 2, 2), ("pod", "data", "model"))
new = DeviceMesh("cpu", torch.arange(2).view(1, 2, 1), mesh_dim_names=("pod", "data", "model"))

def state_specs(m):
    p, o = make_state_specs(b, m, zero_stage=tcfg.zero_stage)
    return {"params": p, "opt": o, "ef": tree_map(lambda _: P(), b.param_defs())}

def one_step(state, m, step_fn, n=1):
    i, k = batch_shard(8, m)
    data = SyntheticLM(DataConfig(vocab=b.cfg.vocab, seq_len=16, global_batch=8),
                       process_index=i, process_count=k)
    for _ in range(n):
        batch = {key: torch.from_numpy(v) for key, v in next(data).items()}
        params, opt, ef, metrics = step_fn(state["params"], state["opt"], state["ef"], batch)
        state = {"params": params, "opt": opt, "ef": ef}
    return state, float(metrics["loss"])

params, opt, ef = place_train_state(b, inputs["params"]["granite-8b"], tcfg, old)
state, _ = one_step({"params": params, "opt": opt, "ef": ef}, old, make_train_step(b, tcfg, old), 2)
specs_old, specs_new = state_specs(old), state_specs(new)
full = Supervisor.rescale(state, specs_old, old, None, None)
moved = Supervisor.rescale(state, specs_old, old, new, specs_new)
out["rescaled_here"] = moved is not None
if moved is not None:
    again = Supervisor.rescale(moved, specs_new, new, None, None)
    out["roundtrip"] = all(torch.equal(a, c) for a, c in zip(tree_leaves(full), tree_leaves(again)))
    # the step of a 2-rank run started from the gathered state
    fresh = tree_map(lambda x, sp: shard_of(x, sp, new).clone(), full, specs_new)
    stepped, loss = one_step(moved, new, make_train_step(b, tcfg, new))
    want, want_loss = one_step(fresh, new, make_train_step(b, tcfg, new))
    out["rescale_loss"] = (loss, want_loss)
    out["rescale_equal"] = all(torch.equal(a, c) for a, c in
                               zip(tree_leaves(stepped), tree_leaves(want)))
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


def _prompts(vocab):
    rng = np.random.default_rng(11)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in PROMPT_LENS]


def _port_alone(arch, tparams, prompts):
    """The port's mesh=None tokens and last decode step's logits."""
    b = ModelBundle(dataclasses.replace(smoke_config(arch), dtype="float32"))
    seen = {}
    step = b.decode_step

    def decode_step(*a, **k):
        logits, caches = step(*a, **k)
        seen["logits"] = logits.clone()
        return logits, caches

    b.decode_step = decode_step
    server = Server(b, ServeConfig(**CFG), tparams, device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW) for i, p in enumerate(prompts)]
    server.add_requests(reqs)
    server.run_until_done(max_steps=2000)
    return [r.out_tokens for r in reqs], seen["logits"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's and the port's mesh=None runs of every arch, and
    the 4-rank spawn's outputs (the spawn runs while this process serves
    the mesh=None runs)."""
    ref, alone, params, prompts, jax_runs = {}, {}, {}, {}, {}
    for arch in ARCHS:
        jb = JaxBundle(dataclasses.replace(jax_smoke_config(arch), dtype="float32"))
        jparams = jb.init_params(jax.random.PRNGKey(0), "float32")
        params[arch] = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
        prompts[arch] = _prompts(jb.cfg.vocab)
        jax_runs[arch] = (jb, jparams)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawn = pool.submit(run_ranks, _BODY, 4, tmp_path_factory.mktemp("mesh_serve"),
                            inputs=dict(archs=ARCHS, params=params, prompts=prompts, cfg=CFG,
                                        new=NEW, side=SIDE), timeout=240)
        for arch, (jb, jparams) in jax_runs.items():
            jserver = JaxServer(jb, JaxServeConfig(**CFG), jparams)
            jreqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=NEW)
                     for i, p in enumerate(prompts[arch])]
            jserver.add_requests(jreqs)
            jserver.run_until_done(max_steps=2000)
            ref[arch] = [r.out_tokens for r in jreqs]
            alone[arch] = _port_alone(arch, params[arch], prompts[arch])
        outs = spawn.result()
    return dict(ref=ref, alone=alone, outs=outs, params=params, prompts=prompts)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_tokens_equal_the_reference_and_logits_one_device(runs, arch):
    outs = runs["outs"]
    assert all(o[arch]["tokens"] == runs["ref"][arch] for o in outs)
    assert runs["alone"][arch][0] == runs["ref"][arch]
    # the gathered logits are whole rows of the rank's slots
    for r, o in enumerate(outs):
        assert o[arch]["rows"] == (r // 2 * 2, r // 2 * 2 + 2)
        np.testing.assert_allclose(o[arch]["logits"].numpy(),
                                   runs["alone"][arch][1][slice(*o[arch]["rows"])].numpy(),
                                   **TOL)


def test_each_rank_holds_its_shards(runs):
    """Cache leaves are (layers, slots, kv heads, slots of the ring, head
    dim) at local shapes: the slots halved over data 2, yi's one kv head
    held whole (replicated), granite's two split; the query heads and the
    vocab rows halved over model 2."""
    o = runs["outs"][0]
    for arch in ARCHS:
        at = smoke_config(arch).attention
        layers = o[arch]["cache"][0]
        assert o[arch]["w_q"][1:] == (64, at.n_heads // 2, at.d_head)
        assert o[arch]["embed"] == (smoke_config(arch).vocab // 2, 64)
        kv = at.n_kv_heads if at.n_kv_heads % 2 else at.n_kv_heads // 2
        assert o[arch]["cache"][1:3] == (2, kv), arch
        assert o[arch]["w_k"][2] == kv
        assert layers >= 1
    assert o["yi-6b"]["cache"][2] == 1 and o["granite-8b"]["cache"][2] == 1
    assert smoke_config("granite-8b").attention.n_kv_heads == 2


def test_replicated_kv_heads_over_a_wider_model_axis(runs):
    """granite-smoke on a 4-rank ``model`` axis: its 2 kv heads do not
    split 4 ways, so every rank's cache holds both and every slot, and
    ranks 2 and 3 attend head 1 through ``kv_head``."""
    for o in runs["outs"]:
        assert o["granite_m4"] == runs["ref"]["granite-8b"][:SIDE]
        assert o["granite_m4_cache"][1:3] == (CFG["batch_slots"], 2)


def test_host_placements_and_a_replan_on_the_mesh_equal_hbm_resident(runs):
    """``kv_host`` and ``weights_stream`` realize on each rank's shards,
    and a replan mid-serve (``weights_stream`` to ``kv_host``) moves each
    rank's own shards."""
    for o in runs["outs"]:
        assert o["kv_host_policy"] == "kv_host"
        assert o["kv_host"] == o["yi-6b"]["tokens"][:SIDE]
        assert o["replanned_policy"] == ("kv_host", 1)
        assert o["replanned"] == o["yi-6b"]["tokens"][:SIDE]


def test_sampled_rows_draw_as_on_one_device(runs):
    """A sampled row's draw is keyed by (seed, position): its rank does
    not change it."""
    b = ModelBundle(dataclasses.replace(smoke_config("yi-6b"), dtype="float32"))
    server = Server(b, ServeConfig(**CFG), runs["params"]["yi-6b"], device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW,
                    sampling=SamplingParams(temperature=0.8, seed=10 + i))
            for i, p in enumerate(runs["prompts"]["yi-6b"][:SIDE])]
    server.add_requests(reqs)
    server.run_until_done(max_steps=2000)
    assert all(o["sampled"] == [r.out_tokens for r in reqs] for o in runs["outs"])


def test_slots_that_data_does_not_divide_replicate(runs):
    for o in runs["outs"]:
        assert o["slots3_rows"] == (0, 3)
        assert o["slots3"] == runs["ref"]["yi-6b"][:SIDE]


def test_preemption_across_data_ranks_gives_the_uninterrupted_tokens(runs):
    o0, o1 = runs["outs"][:2]
    b = ModelBundle(dataclasses.replace(smoke_config("yi-6b"), dtype="float32"))
    server = Server(b, ServeConfig(batch_slots=2, max_len=48, prefill_chunk=4),
                    runs["params"]["yi-6b"], device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6 + 2 * i)
            for i, p in enumerate(runs["prompts"]["yi-6b"])]
    server.add_requests(reqs)
    server.run_until_done(max_steps=2000)
    assert o0["preempt"] == [r.out_tokens for r in reqs] and o1["preempt"] == o0["preempt"]
    st = o0["preempt_stats"]
    assert st["preemptions"] >= 1 and st["promotions"] == st["preemptions"]
    assert st["spill_corruptions"] == 0 and o1["preempt_stats"]["preemptions"] == st["preemptions"]
    # each slot's rows were moved by the one data rank that holds them,
    # and rows promoted into the other rank's slot were carried there
    moves = o0["preempt_moves"] + o1["preempt_moves"]
    assert moves.count("spill") == st["preemptions"]
    assert moves.count("restore") == st["promotions"]
    assert 1 <= moves.count("carry") < st["promotions"]
    assert "preempt" not in runs["outs"][2] and "preempt" not in runs["outs"][3]


def test_rescale_onto_fewer_ranks(runs):
    outs = runs["outs"]
    assert [o["rescaled_here"] for o in outs] == [True, True, False, False]
    for o in outs[:2]:
        assert o["roundtrip"] and o["rescale_equal"]
        assert o["rescale_loss"][0] == o["rescale_loss"][1]


def test_launcher_serves_a_2x2_mesh_under_torchrun(caplog):
    args = ["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--requests", "3",
            "--slots", "2", "--max-len", "32", "--prefill-chunk", "4", "--prompt-len", "6",
            "--max-new", "4"]
    # the one-process launcher serves here while the ranks run
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(
            subprocess.run,
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
             "4", "-m", "repro_torch.launch.serve", *args, "--mesh", "2x2"],
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1"),
            capture_output=True, text=True, timeout=240)
        with caplog.at_level("INFO", logger="repro_torch.serve"):
            serve_launcher.main(args)
        res = ranks.result()
    assert res.returncode == 0, res.stderr[-4000:]
    assert "on the mesh {'data': 2, 'model': 2}" in res.stderr
    got = re.findall(r"request (\d+) tokens ([\d ]+)", res.stderr)
    want = re.findall(r"request (\d+) tokens ([\d ]+)", caplog.text)
    assert len(got) == 3 and got == want


@pytest.mark.parametrize("arch,what", [
    ("llama4-maverick-400b-a17b", "MoE experts"), ("mamba2-780m", "M/S layers"),
    ("zamba2-1.2b", "M/S layers"), ("deepseek-v2-236b", "MLA"),
    ("seamless-m4t-medium", "the encoder-decoder"), ("internvl2-1b", "the VLM"),
])
def test_model_axis_over_families_without_tp_layers_raises(arch, what):
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 2))
    with pytest.raises(NotImplementedError, match=f"{what}.*A10b, rest"):
        Executor(ModelBundle(smoke_config(arch)), ServeConfig(), None, "cpu", mesh=mesh)


@pytest.mark.parametrize("shape,axes,rules,match", [
    ((1, 2), ("data", "model"), {"seq": ("model",)}, "A10b, rest"),
    ((2, 1, 2), ("donor", "data", "model"), None, "A10c"),
])
def test_unported_meshes_raise_by_name(shape, axes, rules, match):
    mesh = types.SimpleNamespace(mesh_dim_names=axes, shape=shape)
    with pytest.raises(NotImplementedError, match=match):
        Executor(ModelBundle(smoke_config("yi-6b")), ServeConfig(rules=rules), None, "cpu",
                 mesh=mesh)


def test_asyncio_scheduler_over_several_ranks_raises():
    server = types.SimpleNamespace(ranks=types.SimpleNamespace(many=True))
    with pytest.raises(NotImplementedError, match="deadlock"):
        Scheduler(server)
