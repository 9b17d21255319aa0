"""Encoder-decoder transformer (the SeamlessM4T backbone).

Counterpart of ``repro/models/encdec.py``.  The modality frontend is a
stub: the encoder takes precomputed frame embeddings (B, S_enc, d).
Decode caches both the decoder's self-attention KV and the cross-attention
KV, which prefill projects from the encoder memory once and every later
step only reads.

The params and caches keep the reference's pytree — ``encoder`` and
``decoder`` stacks beside the embedding, the tied head and the two final
norms; a cache is ``{"decoder": {"self": {k, v}, "cross": {k, v}}}``
stacked over the decoder layers, cross of (B, Hkv, ``frontend_tokens``,
D) — so ``repro_torch.convert`` carries weights and caches across as they
are.  The reference's ``scan`` over a stack becomes a Python loop; in the
serving steps a :class:`DecoderFeed` hands out each decoder layer's params
and cache as views of its slice, and the caches are written in place, as
the LM path's are.  Like the reference's, :func:`encdec_train_loss` takes
no ``remat``.
"""

from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf_mod
from repro_torch.models.attention import _heads, _merge_heads
from repro_torch.models.layers import (
    apply_embed,
    apply_head,
    apply_mlp,
    apply_norm,
    cross_entropy,
    embed_defs,
    head_defs,
    mlp_defs,
    norm_defs,
)
from repro_torch.models.sharding import Param, stack_defs, tree_leaves, tree_map


def _enc_layer_defs(cfg: ArchConfig) -> dict:
    return {
        "attn_norm": norm_defs(cfg.d_model, cfg.norm),
        "attn": attn.attention_defs(cfg.d_model, cfg.attention),
        "mlp_norm": norm_defs(cfg.d_model, cfg.norm),
        "mlp": mlp_defs(cfg.d_model, cfg.d_ff),
    }


def _dec_layer_defs(cfg: ArchConfig) -> dict:
    return {
        "self_norm": norm_defs(cfg.d_model, cfg.norm),
        "self_attn": attn.attention_defs(cfg.d_model, cfg.attention),
        "cross_norm": norm_defs(cfg.d_model, cfg.norm),
        "cross_attn": attn.attention_defs(cfg.d_model, cfg.attention),
        "mlp_norm": norm_defs(cfg.d_model, cfg.norm),
        "mlp": mlp_defs(cfg.d_model, cfg.d_ff),
    }


def encdec_defs(cfg: ArchConfig) -> dict:
    return {
        "embed": embed_defs(cfg.vocab, cfg.d_model),
        "head": head_defs(cfg.vocab, cfg.d_model, cfg.tie_embeddings),
        "enc_final_norm": norm_defs(cfg.d_model, cfg.norm),
        "dec_final_norm": norm_defs(cfg.d_model, cfg.norm),
        "encoder": stack_defs(_enc_layer_defs(cfg), cfg.n_encoder_layers),
        "decoder": stack_defs(_dec_layer_defs(cfg), cfg.n_layers),
    }


def encdec_cache_defs(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    a = cfg.attention
    cross = {
        name: Param(
            (batch, a.n_kv_heads, cfg.frontend_tokens, a.d_head),
            ("batch", "kv_heads", None, "head_dim"), init="zeros",
        )
        for name in ("k", "v")
    }
    layer = {"self": attn.cache_defs(batch, max_len, a, "F"), "cross": cross}
    return {"decoder": stack_defs(layer, cfg.n_layers)}


def param_windows(cfg: ArchConfig, params) -> list[dict]:
    """The windows in which a serving step reads ``params``, in step
    order: the embedding, each decoder layer, then the tail (the decoder's
    final norm and the head, with the embedding again when the head is
    tied to it): ``cfg.n_layers + 2`` windows.  The encoder's params are
    in none of them: only :func:`encode` reads them, which no serving step
    runs."""
    tail = {k: params[k] for k in ("dec_final_norm", "head")}
    if cfg.tie_embeddings:
        tail["embed"] = params["embed"]
    layers = [tree_map(lambda t: t[i], params["decoder"]) for i in range(cfg.n_layers)]
    return [{"embed": params["embed"]}] + layers + [tail]


def cache_windows(caches) -> list[dict]:
    """One window a decoder layer, ``{"self": {k, v}, "cross": {k, v}}``
    of its slice of the stacked cache."""
    n = tree_leaves(caches)[0].shape[0]
    return [tree_map(lambda t: t[i], caches["decoder"]) for i in range(n)]


class DecoderFeed(tf_mod.ResidentFeed):
    """The layer feed of the serving steps over the decoder stack: layer
    ``i``'s params and its ``{"self", "cross"}`` cache as views of slice
    ``i`` of the resident (or RESIDENT host) trees.  The decoder is one
    stack, so ``stage`` is always 0."""

    def layer(self, stage: int, layer: int):
        return (tree_map(lambda t: t[layer], self.params["decoder"]),
                tree_map(lambda t: t[layer], self.caches["decoder"]))


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def encode(params, frames: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """frames: (B, S_enc, d) stub embeddings -> encoder memory (B, S_enc,
    d): bidirectional self-attention (code ``X``) and a ``cfg.act`` MLP a
    layer, then the encoder's final norm."""
    x = frames
    for lp in tf_mod._layer_slices(params["encoder"], cfg.n_encoder_layers):
        h = apply_norm(lp["attn_norm"], x, cfg.norm)
        x = x + attn.gqa_train(lp["attn"], h, cfg.attention, "X")
        h = apply_norm(lp["mlp_norm"], x, cfg.norm)
        x = x + apply_mlp(lp["mlp"], h, cfg.act)
    return apply_norm(params["enc_final_norm"], x, cfg.norm)


def _cross_kv(lp, memory):
    """The cross-attention keys and values of the encoder memory: (B, Hkv,
    S_enc, D) each."""
    return _heads(memory, lp["w_k"]), _heads(memory, lp["w_v"])


def _cross_attend(lp, x, k, v):
    """Every query of ``x`` against every memory position (no mask, no
    rotary embedding)."""
    q = _heads(x, lp["w_q"])
    o = ops.attention(q, k, v, kind="bidirectional")
    return _merge_heads(o, lp["w_o"])


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def decode_train(params, tokens, memory, cfg: ArchConfig):
    """Teacher-forced decoder -> logits (B, S_dec, vocab) f32."""
    x = apply_embed(params["embed"], tokens)
    for lp in tf_mod._layer_slices(params["decoder"], cfg.n_layers):
        h = apply_norm(lp["self_norm"], x, cfg.norm)
        x = x + attn.gqa_train(lp["self_attn"], h, cfg.attention, "F")
        h = apply_norm(lp["cross_norm"], x, cfg.norm)
        k, v = _cross_kv(lp["cross_attn"], memory)
        x = x + _cross_attend(lp["cross_attn"], h, k, v)
        h = apply_norm(lp["mlp_norm"], x, cfg.norm)
        x = x + apply_mlp(lp["mlp"], h, cfg.act)
    x = apply_norm(params["dec_final_norm"], x, cfg.norm)
    return apply_head(params["head"], params["embed"], x)


def encdec_train_loss(params, frames, tokens, labels, cfg: ArchConfig):
    """Mean next-token CE of the decoder over the encoded ``frames`` ->
    (loss, {"ce", "aux"}); ``aux`` is 0 (no MoE)."""
    memory = encode(params, frames, cfg)
    logits = decode_train(params, tokens, memory, cfg)
    loss = cross_entropy(logits, labels)
    return loss, {"ce": loss, "aux": loss.new_zeros((), dtype=torch.float32)}


def _decoder_step(cfg, feed, x, lengths, mode, new_lens=None, memory=None):
    """Every decoder layer in order, fed by ``feed``; the self cache is
    written in place (``mode`` as ``transformer._attn_step``).  With
    ``memory`` (a prefill from position 0) each layer projects it into its
    cross cache and attends to that; otherwise the cross cache is only
    read."""
    for i in range(cfg.n_layers):
        lp, cache = feed.layer(0, i)
        h = apply_norm(lp["self_norm"], x, cfg.norm)
        x = x + tf_mod._attn_step(lp["self_attn"], h, cache["self"], lengths,
                                  cfg.attention, "F", mode, new_lens)
        cross = cache["cross"]
        if memory is None:
            k, v = cross["k"], cross["v"]
        else:
            k, v = _cross_kv(lp["cross_attn"], memory)
            cross["k"].copy_(k)
            cross["v"].copy_(v)
        h = apply_norm(lp["cross_norm"], x, cfg.norm)
        x = x + _cross_attend(lp["cross_attn"], h, k, v)
        h = apply_norm(lp["mlp_norm"], x, cfg.norm)
        x = x + apply_mlp(lp["mlp"], h, cfg.act)
        feed.layer_done(0, i, cache)
    return x


def _tail_logits(cfg, feed, x):
    top = feed.top("tail")
    x = apply_norm(top["dec_final_norm"], x, cfg.norm)
    return apply_head(top["head"], top.get("embed"), x)[:, 0]


def encdec_prefill(params, frames, tokens, caches, cfg: ArchConfig, *, feed=None):
    """Encode ``frames``, then prefill the decoder with the prompt
    ``tokens`` from position 0: both caches filled in place.  Returns
    (last-token logits (B, vocab), caches)."""
    feed = feed or DecoderFeed(params, caches)
    feed.begin(None, tokens.shape[1])
    memory = encode(params, frames, cfg)
    x = apply_embed(feed.top("embed")["embed"], tokens)
    lengths = torch.full((tokens.shape[0],), x.shape[1], dtype=torch.int32,
                         device=x.device)
    x = _decoder_step(cfg, feed, x, lengths, "prefill", memory=memory)
    return _tail_logits(cfg, feed, x[:, -1:]), caches


def encdec_prefill_at(params, tokens, caches, offsets, new_lens, cfg: ArchConfig,
                      *, feed=None):
    """Chunked decoder prefill against the self and cross caches.

    The serving counterpart of :func:`~repro_torch.models.transformer.
    lm_prefill_at`: row ``b`` appends ``new_lens[b] <= S`` prompt tokens at
    self-cache positions ``offsets[b]..`` in one dispatch.  Cross-attention
    is bidirectional per query over a fixed memory, so a whole chunk at once
    attends as its tokens would one at a time; the cross KV is read, never
    written (in serving it holds what the admission path projected: zeros
    for a token-only prompt).  Rows with ``new_lens == 0`` keep their
    caches.  Returns (last-valid-position logits, caches updated in place).
    """
    feed = feed or DecoderFeed(params, caches)
    feed.begin(offsets, new_lens)
    x = apply_embed(feed.top("embed")["embed"], tokens)
    x = _decoder_step(cfg, feed, x, offsets, "prefill_at", new_lens)
    last = torch.clamp(new_lens.long() - 1, 0, tokens.shape[1] - 1)
    x = torch.gather(x, 1, last[:, None, None].expand(-1, 1, x.shape[-1]))
    return _tail_logits(cfg, feed, x), caches


def encdec_decode_step(params, tokens, caches, lengths, cfg: ArchConfig, *,
                       feed=None):
    """One decoder step against the self and cross caches; tokens (B, 1),
    lengths (B,) the self cache's fill.  Returns (logits (B, vocab), caches
    updated in place); the caller advances lengths."""
    feed = feed or DecoderFeed(params, caches)
    feed.begin(lengths, 1)
    x = apply_embed(feed.top("embed")["embed"], tokens)
    x = _decoder_step(cfg, feed, x, lengths, "decode")
    return _tail_logits(cfg, feed, x), caches
