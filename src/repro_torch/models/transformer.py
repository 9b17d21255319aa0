"""Decoder-only LM assembled from pattern stages.

Counterpart of ``repro/models/transformer.py`` for the attention layers
— GQA full (``F``), global (``G``), sliding-window (``L``) and
chunk-local (``C``), whose caches are rings (``attention.cache_defs``),
or MLA (an ``F`` layer of a spec whose kind is ``"mla"``, DeepSeek-V2) —
with a dense or a GShard MoE FFN (``models/moe.py``, on the layers
``cfg.moe.is_moe_layer`` picks), Mamba-2 (``M``) and Zamba-style
shared-attention (``S``) layers.  The params and caches keep the
reference's pytree — one stacked dict per stage of ``cfg.stages()``, plus
the model-level ``shared_attn`` block whose params every ``S`` layer
reuses over concat(hidden, embedding output) — and the reference's
``scan`` over the stacked layer dim becomes
a Python loop that asks a *feed* for each layer's params and cache:
views of its slice when both are resident on the device
(:class:`ResidentFeed`), staging windows streamed from host memory under
a host placement (``repro_torch.serve.engine.PlacedFeed``).  Caches are
updated in place through what the feed hands out.  In training the slices come from
one ``unbind`` per stacked leaf, so each leaf's gradient is stacked once
per step rather than scattered into a zero stack per layer.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    apply_embed,
    apply_head,
    apply_mlp,
    apply_norm,
    embed_defs,
    head_defs,
    mlp_defs,
    fused_cross_entropy,
    norm_defs,
)
from repro_torch.models.sharding import (
    Param,
    all_gather_leaves,
    mesh_shape,
    padded,
    reduce_scatter_leaves,
    stack_defs,
    tree_leaves,
    tree_map,
)

#: layer codes ported so far
LAYER_CODES = ("F", "L", "G", "C", "M", "S")


# ---------------------------------------------------------------------------
# Param defs
# ---------------------------------------------------------------------------

def _check_code(code: str) -> None:
    if code not in LAYER_CODES:
        raise NotImplementedError(
            f"layer code {code!r} is not ported yet (ROADMAP queue A)"
        )


def _dense_ff(cfg: ArchConfig) -> int:
    """The width of a dense layer's MLP."""
    if cfg.moe is not None and cfg.moe.dense_d_ff:
        return cfg.moe.dense_d_ff
    return cfg.d_ff


def _layer_defs(cfg: ArchConfig, code: str, layer_idx: int) -> dict:
    _check_code(code)
    d = cfg.d_model
    if code == "M":
        return {"norm": norm_defs(d, cfg.norm), "ssm": ssm_mod.ssm_defs(d, cfg.ssm)}
    if code == "S":
        return {}  # the shared block's params live at model level
    defs = {
        "attn_norm": norm_defs(d, cfg.norm),
        "attn": attn.attention_defs(d, cfg.attention),
        "mlp_norm": norm_defs(d, cfg.norm),
    }
    if cfg.moe is not None and cfg.moe.is_moe_layer(layer_idx):
        defs["moe"] = moe_mod.moe_defs(d, cfg.moe)
    else:
        defs["mlp"] = mlp_defs(d, _dense_ff(cfg))
    return defs


def _shared_block_defs(cfg: ArchConfig) -> dict:
    """Zamba shared attention over concat(hidden, emb0) -> d_model out."""
    dc = 2 * cfg.d_model
    a = cfg.attention
    defs = attn.attention_defs(dc, a)
    defs["w_o"] = Param(
        (a.n_heads, a.d_head, cfg.d_model), ("heads", "head_dim", "embed")
    )
    defs["norm"] = norm_defs(dc, cfg.norm)
    return defs


def _check_pattern(cfg: ArchConfig) -> None:
    if cfg.moe is not None and cfg.moe.moe_period > 1:
        assert len(cfg.layer_pattern) % cfg.moe.moe_period == 0, (
            "moe_period must divide the pattern length so that every repeat "
            "of a stage has the same layers"
        )


def lm_defs(cfg: ArchConfig) -> dict:
    _check_pattern(cfg)
    defs = {
        "embed": embed_defs(cfg.vocab, cfg.d_model),
        "final_norm": norm_defs(cfg.d_model, cfg.norm),
        "head": head_defs(cfg.vocab, cfg.d_model, cfg.tie_embeddings),
        "stages": [],
    }
    for codes, count, start in cfg.stages():
        stage = {
            f"{j}{code}": _layer_defs(cfg, code, start + j)
            for j, code in enumerate(codes)
        }
        defs["stages"].append(stack_defs(stage, count))
    if "S" in cfg.layer_pattern:
        defs["shared_attn"] = _shared_block_defs(cfg)
    return defs


# ---------------------------------------------------------------------------
# Cache defs
# ---------------------------------------------------------------------------

def lm_cache_defs(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """An ``M`` layer gets the (conv, ssm) state, an ``S`` layer a full
    KV cache per application, an attention layer its KV cache."""
    caches = {"stages": []}
    for codes, count, start in cfg.stages():
        stage = {}
        for j, code in enumerate(codes):
            if code == "M":
                stage[f"{j}{code}"] = ssm_mod.ssm_cache_defs(batch, cfg.d_model, cfg.ssm)
            else:
                stage[f"{j}{code}"] = attn.cache_defs(
                    batch, max_len, cfg.attention, "F" if code == "S" else code
                )
        caches["stages"].append(stack_defs(stage, count))
    return caches


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def _apply_layer_train(cfg, code, lp, x, emb0, shared):
    """One layer of the training forward -> (x, aux): ``aux`` is an MoE
    layer's load-balancing loss, None for any other layer.  An ``M`` layer
    has no MLP; an ``S`` layer runs the ``shared`` block over
    concat(x, emb0)."""
    _check_code(code)
    if code == "M":
        return x + ssm_mod.ssm_train(
            lp["ssm"], apply_norm(lp["norm"], x, cfg.norm), cfg.d_model, cfg.ssm
        ), None
    if code == "S":
        xin = apply_norm(shared["norm"], torch.cat([x, emb0], dim=-1), cfg.norm)
        return x + attn.gqa_train(shared, xin, cfg.attention, "F"), None
    h = apply_norm(lp["attn_norm"], x, cfg.norm)
    x = x + attn.attn_train(lp["attn"], h, cfg.attention, code)
    h = apply_norm(lp["mlp_norm"], x, cfg.norm)
    if "moe" in lp:
        out, aux = moe_mod.apply_moe(lp["moe"], h, cfg.moe, cfg.act)
        return x + out, aux
    return x + apply_mlp(lp["mlp"], h, cfg.act, d_ff=_dense_ff(cfg)), None


def _attn_step(params, h, cache, lengths, spec, code, mode, new_lens):
    if mode == "prefill":
        return attn.attn_prefill(params, h, cache, spec, code)
    if mode == "prefill_at":
        return attn.attn_prefill_at(params, h, cache, lengths, new_lens, spec, code)
    if mode == "decode":
        return attn.attn_decode(params, h, cache, lengths, spec, code)
    raise ValueError(f"step mode {mode!r}")


def _apply_layer_step(
    cfg, code, lp, cache, x, emb0, lengths, shared, mode, new_lens=None
):
    """prefill/prefill_at/decode step for one layer; returns x.

    ``prefill_at`` is the serving engine's chunked batched prefill:
    ``lengths`` carries each row's cache fill *offset* and ``new_lens`` how
    many of the chunk's positions are real for that row (0 = untouched).
    ``cache`` holds views of this layer's slice and is written in place.
    An ``S`` layer runs the ``shared`` block over concat(x, emb0).
    """
    _check_code(code)
    if code == "M":
        h = apply_norm(lp["norm"], x, cfg.norm)
        if mode == "prefill":
            out = ssm_mod.ssm_prefill(lp["ssm"], h, cache, cfg.d_model, cfg.ssm)
        elif mode == "prefill_at":
            out = ssm_mod.ssm_prefill_at(
                lp["ssm"], h, cache, lengths, new_lens, cfg.d_model, cfg.ssm
            )
        elif mode == "decode":
            out = ssm_mod.ssm_decode(lp["ssm"], h, cache, cfg.d_model, cfg.ssm)
        else:
            raise ValueError(f"step mode {mode!r}")
        return x + out
    if code == "S":
        xin = apply_norm(shared["norm"], torch.cat([x, emb0], dim=-1), cfg.norm)
        return x + _attn_step(shared, xin, cache, lengths, cfg.attention, "F",
                              mode, new_lens)
    h = apply_norm(lp["attn_norm"], x, cfg.norm)
    x = x + _attn_step(lp["attn"], h, cache, lengths, cfg.attention, code,
                       mode, new_lens)
    h = apply_norm(lp["mlp_norm"], x, cfg.norm)
    if "moe" in lp:
        # every row of the step is routed, idle ones included, as in the
        # reference: through the capacity they share, a row's output
        # depends on its batch-mates
        return x + moe_mod.apply_moe(lp["moe"], h, cfg.moe, cfg.act)[0]
    return x + apply_mlp(lp["mlp"], h, cfg.act, d_ff=_dense_ff(cfg))


def _layer_slices(stage_params, count: int) -> list:
    """Per-layer views of a stacked stage: one ``unbind`` per leaf."""
    parts = [t.unbind(0) for t in tree_leaves(stage_params)]

    def layer(i):
        it = iter([p[i] for p in parts])
        return tree_map(lambda _: next(it), stage_params)

    return [layer(i) for i in range(count)]


#: matmuls without batch dims — the ops whose outputs ``remat="dots"``
#: keeps (``checkpoint_dots_with_no_batch_dims``); batched products and
#: the attention kernel are recomputed
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    if op in _DOT_OPS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _stage_body(cfg, codes, x, aux, lp, emb0, shared):
    for j, code in enumerate(codes):
        x, a = _apply_layer_train(cfg, code, lp[f"{j}{code}"], x, emb0, shared)
        if a is not None:
            aux = aux + a
    return x, aux


def _run_stages_train(cfg, params, x, remat: str):
    """Every layer in order -> (x, aux summed over the MoE layers in
    layer order, f32); ``remat`` = none | full | dots.  ``emb0`` (the
    embedding output, when the pattern has ``S`` layers) and the shared
    block's params go into every stage's checkpoint, as the reference's
    scans close over them; the aux sum is carried through each
    checkpoint, as through the reference's scan carry."""
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"remat {remat!r}")
    shared = params.get("shared_attn")
    emb0 = x if "S" in cfg.layer_pattern else None
    aux = x.new_zeros((), dtype=torch.float32)
    for (codes, count, _), stage_params in zip(cfg.stages(), params["stages"]):
        body = functools.partial(_stage_body, cfg, codes)
        for lp in _layer_slices(stage_params, count):
            if remat == "none":
                x, aux = body(x, aux, lp, emb0, shared)
            elif remat == "full":
                x, aux = checkpoint(body, x, aux, lp, emb0, shared, use_reentrant=False)
            else:
                x, aux = checkpoint(
                    body, x, aux, lp, emb0, shared, use_reentrant=False,
                    context_fn=functools.partial(
                        create_selective_checkpoint_contexts, _save_dots),
                )
    return x, aux


# ---------------------------------------------------------------------------
# Training over windows of a host-placed or ZeRO-3-sharded params tree
# ---------------------------------------------------------------------------

class ParamViews:
    """The windows of a params tree the training step computes on in place
    (``params=host``, RESIDENT: on a card CUDA tensors over the mapped view
    of a pinned arena), with a :class:`~repro_torch.core.placement.
    HostStream`'s sweep interface: nothing is staged or copied."""

    def __init__(self, windows: list):
        self.windows, self.n_windows = windows, len(windows)

    def begin(self, reverse: bool = False) -> None:
        pass

    def window(self, i: int):
        return self.windows[i]

    def finish(self) -> None:
        pass


class GatheredWindows:
    """ZeRO-3's window source: the windows of a params tree whose leaves
    are this rank's shards over the mesh's ``data`` axis, each gathered
    whole into one of two device slots when the step asks for it — the forward sweep, then the backward's re-fetch, last window
    first — by one all-gather of the window's packed bytes
    (:func:`~repro_torch.models.sharding.all_gather_leaves`); and
    :meth:`reduce`, which reduce-scatters a window's gradients into the
    rank's shards (a leaf the axis leaves whole is all-reduced), what the
    reference's ``shard_defs`` inside its scan bodies does.  The device
    holds the shards plus at most two gathered windows
    (:attr:`peak_bytes`) and the all-gather's receive buffer of one.

    ``dims`` has the windows' structure: per leaf the dim ``data`` splits,
    or None for a leaf every rank holds whole (used as it is).
    """

    #: the device slots; a window's slot is free again two windows later
    DEPTH = 2

    def __init__(self, windows: list, dims: list, mesh):
        self.windows, self.n_windows, self.mesh = windows, len(windows), mesh
        n = mesh_shape(mesh)["data"]
        self._leaves = [tree_leaves(w) for w in windows]
        # dims in each window's own leaf order (dict entries match by key)
        self._dims = [tree_leaves(tree_map(lambda _, d: d, w, dw))
                      for w, dw in zip(windows, dims, strict=True)]
        self._offsets, self.window_bytes = [], []
        for ls, ds in zip(self._leaves, self._dims, strict=True):
            offs, end = [], 0
            for t, d in zip(ls, ds, strict=True):
                offs.append(None if d is None else end)
                if d is not None:
                    end += padded(n * t.numel() * t.element_size())
            self._offsets.append(offs)
            self.window_bytes.append(end)
        self._n = n
        self._slots: list[torch.Tensor] | None = None
        self._held: dict[int, int] = {}
        #: the most gathered bytes held at once; the windows gathered
        self.peak_bytes, self.gathers = 0, 0

    def begin(self, reverse: bool = False) -> None:
        self._held.clear()

    def window(self, i: int):
        """Window ``i`` whole: its split leaves gathered into slot ``i %
        DEPTH`` (the window that held it before is done with)."""
        slot = i % self.DEPTH
        leaves, dims = self._leaves[i], self._dims[i]
        if self._slots is None:
            dev = self._leaves[0][0].device
            self._slots = [torch.empty(max(self.window_bytes), dtype=torch.uint8,
                                       device=dev) for _ in range(self.DEPTH)]
        outs = []
        for t, d, off in zip(leaves, dims, self._offsets[i]):
            if d is None:
                outs.append(None)
                continue
            shape = list(t.shape)
            shape[d] *= self._n
            nbytes = t.numel() * t.element_size() * self._n
            outs.append(self._slots[slot][off:off + nbytes].view(t.dtype).view(shape))
        got = all_gather_leaves(leaves, dims, self.mesh, "data", outs)
        self._held[slot] = self.window_bytes[i]
        self.peak_bytes = max(self.peak_bytes, sum(self._held.values()))
        self.gathers += 1
        it = iter(got)
        return tree_map(lambda _: next(it), self.windows[i])

    def reduce(self, i: int, grads: list) -> list:
        """Window ``i``'s gradients (whole leaves, this rank's rows) ->
        float32 sums over ``data``: each split leaf's shard, each whole
        leaf whole."""
        return reduce_scatter_leaves(grads, self._dims[i], self.mesh, "data")

    def finish(self) -> None:
        self._held.clear()


def _drop_saved(t):
    """The pack hook of a forward that saves nothing (its graph is never
    run backward)."""
    return None


def _never_unpacked(_):
    raise RuntimeError("a windowed forward's graph is never run backward")


def _live(tree) -> tuple[dict, list]:
    """``tree`` with every leaf a fresh graph leaf over the same storage,
    and those leaves in order."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(tree)]
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree), leaves


def lm_loss_windowed(source, tokens, labels, grads, cfg: ArchConfig, *,
                     extra_embeds=None, aux_weight: float = 0.01):
    """:func:`lm_loss` and its gradients over a params tree that the step
    reads window by window -> (loss, {"ce", "aux"}), the gradients written
    into ``grads`` (a device tree shaped like the params).

    ``source`` hands out the windows of :func:`param_windows` (the
    embedding, each stacked index of each stage with Zamba-2's shared
    block in each one that applies it, the tail): a
    :class:`~repro_torch.core.placement.HostStream` over a streamed host
    tree (``params=host:stream``), :class:`ParamViews` of a RESIDENT
    one (``params=host``), or :class:`GatheredWindows` of a ZeRO-3
    rank's shards.  Every layer runs as ``remat="full"`` does:
    the forward sweep keeps only each window's input (``x`` and ``aux``;
    its graph saves nothing, so no saved tensor points into a staging slot
    the next window overwrites), and the backward sweep asks for the
    windows again, last first, recomputes each with grad over its leaves
    and writes their gradients into ``grads`` at its slice.  A leaf in
    several windows (the shared block, the tied embedding) sums its
    gradients in the order the autograd engine sums them under
    ``hbm_resident``, and so does the embedding output that every ``S``
    layer reads, so the values are bit for bit those of :func:`lm_loss`
    under ``remat="full"`` and ``torch.autograd.grad``.  The loss and the
    metrics come back detached.  A source with a ``reduce(i, grads)``
    method (:class:`GatheredWindows`, ZeRO-3) maps each window's
    gradients to what ``grads`` holds before they are written (its
    shards, reduced over the data axis).
    """
    stages = [codes for (codes, count, _) in cfg.stages() for _ in range(count)]
    gw = param_windows(cfg, grads)
    reduce = getattr(source, "reduce", None)
    written: set[int] = set()

    def put(i, gs):
        if reduce is not None:
            gs = reduce(i, list(gs))
        for dst, g in zip(tree_leaves(gw[i]), gs, strict=True):
            if id(dst) in written:
                dst.add_(g)
            else:
                dst.copy_(g)
                written.add(id(dst))

    def body(codes, w, x, aux, emb0):
        return _stage_body(cfg, codes, x, aux, w, emb0, w.get("shared_attn"))

    source.begin()
    with torch.no_grad():
        x0 = _embed(source.window(0)["embed"], tokens, extra_embeds, cfg.vocab)
    emb0 = x0 if "S" in cfg.layer_pattern else None
    x, aux = x0, x0.new_zeros((), dtype=torch.float32)
    inputs = []
    for k, codes in enumerate(stages):
        inputs.append((x, aux))
        lw, _ = _live(source.window(1 + k))
        # with grad, as in hbm_resident's checkpoint, so every op takes the
        # path it takes there; the graph keeps nothing and is dropped
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
                _drop_saved, _never_unpacked):
            xi, ai = x.detach().requires_grad_(), aux.detach().requires_grad_()
            ei = None if emb0 is None else (xi if k == 0 else emb0)
            x, aux = body(codes, lw, xi, ai, ei)
        x, aux = x.detach(), aux.detach()
    n = len(stages) + 2
    tw, t_leaves = _live(source.window(n - 1))
    with torch.enable_grad():
        xl, al = x.requires_grad_(), aux.requires_grad_()
        h = apply_norm(tw["final_norm"], xl, cfg.norm)
        if extra_embeds is not None:
            h = h[:, extra_embeds.shape[1]:]
        ce = fused_cross_entropy(tw["head"], tw.get("embed"), h, labels, vocab=cfg.vocab)
        loss = ce + aux_weight * al
    dx, daux, *gs = torch.autograd.grad(loss, [xl, al] + t_leaves)
    put(n - 1, gs)

    source.begin(reverse=True)
    demb = None                 # the S layers' gradient of emb0, summed
    for k in reversed(range(len(stages))):
        lw, leaves = _live(source.window(1 + k))
        x_in, aux_in = inputs[k]
        with torch.enable_grad():
            xi, ai = x_in.detach().requires_grad_(), aux_in.detach().requires_grad_()
            ei = None if emb0 is None else (xi if k == 0 else emb0.detach().requires_grad_())
            xo, ao = body(stages[k], lw, xi, ai, ei)
            outs, gouts = [xo], [dx]
            if ao is not ai:
                outs.append(ao)
                gouts.append(daux)
            if k == 0 and demb is not None:
                # under hbm_resident the later S layers' gradients reach the
                # embedding output before the first window's: a view made
                # after the body is the engine's first node here too
                outs.append(xi.view_as(xi))
                gouts.append(demb)
        wrt = [xi, ai] + ([ei] if ei is not None and k > 0 else []) + leaves
        got = torch.autograd.grad(outs, wrt, gouts, allow_unused=True)
        dx = got[0]
        if ao is not ai:
            daux = got[1]
        if ei is not None and k > 0:
            g = got[2]
            if g is not None:
                demb = g if demb is None else demb + g
            got = got[:2] + got[3:]
        put(1 + k, got[2:])
    w, leaves = _live(source.window(0))
    with torch.enable_grad():
        x0r = _embed(w["embed"], tokens, extra_embeds, cfg.vocab)
    put(0, torch.autograd.grad(x0r, leaves, dx))
    source.finish()
    return loss.detach(), {"ce": ce.detach(), "aux": aux.detach()}


class ResidentFeed:
    """Where a serving step's params and caches come from, layer by layer,
    when neither is streamed: both in the compute device's memory
    (``hbm_resident``), or either RESIDENT in host memory, where the trees
    are CUDA tensors over the card's mapped view of it.  Each layer gets
    views of its slice of the stacked trees, and nothing is copied or
    launched.

    A feed is the model's one interface to placement: a streamed role's
    feed (``repro_torch.serve.engine.PlacedFeed``) answers the same calls
    with device staging windows instead, and writes back what a layer
    wrote in :meth:`layer_done`.
    """

    def __init__(self, params, caches):
        self.params, self.caches = params, caches

    def begin(self, pos, counts) -> None:
        """A step starts: row ``b`` will write ``counts[b]`` cache positions
        from ``pos[b]`` (``(B,)`` int32 device tensors; ``pos`` None means
        0 and an int ``counts`` the same count for every row)."""

    def top(self, part: str) -> dict:
        """The non-layer params the step needs first (``"embed"``) or last
        (``"tail"``: final norm and head, which reads the embedding when
        tied)."""
        return self.params

    def layer(self, stage: int, layer: int):
        """(params, cache) of one layer of a stage: views of its slice; the
        params carry the model's shared block (``shared_attn``) when it
        has one."""
        lp = tree_map(lambda t: t[layer], self.params["stages"][stage])
        if "shared_attn" in self.params:
            lp["shared_attn"] = self.params["shared_attn"]
        cache = tree_map(lambda t: t[layer], self.caches["stages"][stage])
        return lp, cache

    def layer_done(self, stage: int, layer: int, cache) -> None:
        """The layer's writes into ``cache`` are issued."""


def _run_stages_step(cfg, feed, x, lengths, mode, new_lens=None):
    """Every layer in order, fed by ``feed``.  ``emb0`` (the embedding
    output, only when the pattern has ``S`` layers) goes into every stage,
    as the reference's scans close over it; an ``S`` layer reads the
    shared block from the params ``feed`` hands out for its layer."""
    emb0 = x if "S" in cfg.layer_pattern else None
    for s, (codes, count, start) in enumerate(cfg.stages()):
        for layer in range(count):
            lp, cache = feed.layer(s, layer)
            for j, code in enumerate(codes):
                key = f"{j}{code}"
                x = _apply_layer_step(
                    cfg, code, lp[key], cache[key], x, emb0, lengths,
                    lp.get("shared_attn"), mode, new_lens,
                )
            feed.layer_done(s, layer, cache)
    return x


def leaf_windows(tree) -> list[dict]:
    """A params-shaped tree (params, grads, the optimizer's master and
    moments, or a cache tree) cut into windows that hold every leaf once:
    each top-level entry but the stages, then one window per stacked index
    of each stage (a layer of a dense model)."""
    windows = [{k: v} for k, v in tree.items() if k != "stages"]
    for stage in tree["stages"]:
        count = tree_leaves(stage)[0].shape[0]
        windows += [tree_map(lambda t: t[i], stage) for i in range(count)]
    return windows


def param_windows(cfg, params) -> list[dict]:
    """The windows in which a serving step reads ``params``, in step
    order: the embedding, each layer, then the tail (final norm and head,
    with the embedding again when the head is tied to it).
    ``cfg.n_layers + 2`` windows for a dense model.  A layer window of a
    stage with an ``S`` layer carries the shared block (``shared_attn``)
    too: each application reads it from host memory again (the planner
    counts its bytes once)."""
    tail = {k: params[k] for k in ("final_norm", "head")}
    if cfg.tie_embeddings:
        tail["embed"] = params["embed"]
    windows = [{"embed": params["embed"]}]
    for (codes, count, _), stage in zip(cfg.stages(), params["stages"]):
        for i in range(count):
            w = tree_map(lambda t: t[i], stage)
            if "S" in codes:
                w["shared_attn"] = params["shared_attn"]
            windows.append(w)
    return windows + [tail]


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def _embed(embed_params, tokens, extra_embeds, vocab=None):
    """The token embedding, with a frontend's stub embeddings (B,
    S_front, d) prepended in its dtype when given; ``vocab`` lets a
    ``model`` axis split the lookup."""
    x = apply_embed(embed_params, tokens, vocab=vocab)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    return x


def lm_forward(params, tokens, cfg: ArchConfig, *, extra_embeds=None,
               remat: str = "none"):
    """Training-mode forward -> (logits (B, S, vocab) f32, aux_loss);
    with ``extra_embeds`` (a VLM's patch embeddings, B x S_front x d)
    the logits cover S_front + S_text positions."""
    x = _embed(params["embed"], tokens, extra_embeds)
    x, aux = _run_stages_train(cfg, params, x, remat)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return apply_head(params["head"], params["embed"], x), aux


def lm_loss(params, tokens, labels, cfg: ArchConfig, *, extra_embeds=None,
            remat: str = "full", aux_weight: float = 0.01):
    """Mean next-token CE -> (loss, {"ce", "aux"}).

    The forward runs up to the final hidden states; head and CE are fused
    per sequence block, so the full (B, S, V) f32 logits never exist.
    ``extra_embeds`` (B, S_front, d) go in front of the tokens and their
    positions are dropped before the head: the labels cover the text.
    """
    x = _embed(params["embed"], tokens, extra_embeds, cfg.vocab)
    x, aux = _run_stages_train(cfg, params, x, remat)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    if extra_embeds is not None:
        x = x[:, extra_embeds.shape[1]:]
    loss = fused_cross_entropy(params["head"], params["embed"], x, labels,
                               vocab=cfg.vocab)
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


def _tail_logits(cfg, feed, x):
    """The last position's logits, whole rows on every rank of a ``model``
    axis that splits the vocab (gathered, ``apply_head(vocab=)``)."""
    top = feed.top("tail")
    x = apply_norm(top["final_norm"], x, cfg.norm)
    return apply_head(top["head"], top.get("embed"), x, vocab=cfg.vocab)[:, 0]


def lm_prefill(params, tokens, caches, cfg: ArchConfig, *, extra_embeds=None,
               feed=None):
    """Fill the caches from a prompt at position 0.

    Returns (last-token logits (B, vocab), caches filled in place).
    ``extra_embeds`` (B, S_front, d), a VLM's patch embeddings, fill the
    first S_front positions, the prompt the ones after them.  ``feed``
    (default: views of ``params`` and ``caches``) supplies each layer's
    params and cache; see :class:`ResidentFeed`.
    """
    feed = feed or ResidentFeed(params, caches)
    front = 0 if extra_embeds is None else extra_embeds.shape[1]
    feed.begin(None, front + tokens.shape[1])
    x = _embed(feed.top("embed")["embed"], tokens, extra_embeds, cfg.vocab)
    lengths = torch.full((tokens.shape[0],), x.shape[1], dtype=torch.int32,
                         device=x.device)
    x = _run_stages_step(cfg, feed, x, lengths, "prefill")
    return _tail_logits(cfg, feed, x[:, -1:]), caches


def lm_prefill_at(params, tokens, caches, offsets, new_lens, cfg: ArchConfig, *,
                  feed=None):
    """Chunked batched prefill: write one prompt chunk per row at an offset.

    ``tokens`` (B, S) holds one chunk of each row's prompt; row ``b``
    appends ``new_lens[b] <= S`` tokens at cache positions ``offsets[b]..``
    (``new_lens == 0`` leaves the row's cache untouched).  Returns the
    logits of each row's last *valid* chunk position — garbage for
    ``new_lens == 0`` rows — and ``caches``, updated in place.
    """
    feed = feed or ResidentFeed(params, caches)
    feed.begin(offsets, new_lens)
    x = apply_embed(feed.top("embed")["embed"], tokens, vocab=cfg.vocab)
    x = _run_stages_step(cfg, feed, x, offsets, "prefill_at", new_lens)
    last = torch.clamp(new_lens.long() - 1, 0, tokens.shape[1] - 1)
    x = torch.gather(x, 1, last[:, None, None].expand(-1, 1, x.shape[-1]))
    return _tail_logits(cfg, feed, x), caches


def lm_decode_step(params, tokens, caches, lengths, cfg: ArchConfig, *,
                   feed=None):
    """One decode step; tokens (B,1); lengths (B,) current cache fill.

    Returns (logits (B, vocab), caches updated in place).  The caller
    advances lengths.  Every row writes one cache position, at its length.
    """
    feed = feed or ResidentFeed(params, caches)
    feed.begin(lengths, 1)
    x = apply_embed(feed.top("embed")["embed"], tokens, vocab=cfg.vocab)
    x = _run_stages_step(cfg, feed, x, lengths, "decode")
    return _tail_logits(cfg, feed, x), caches
