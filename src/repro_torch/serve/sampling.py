"""Per-request token sampling, computed on the device.

Counterpart of ``repro/serve/sampling.py``.  Every active slot carries its
own ``temperature`` / ``top_k`` / ``top_p`` / ``seed`` / stop-token set,
and the whole transform — filter, draw, stop detection — runs on the
batched ``(batch_slots, vocab)`` logits where they lie, so sampling adds no
host↔device traffic beyond the packed next-token/stopped vector.

Determinism contract: the draw for a request at absolute position ``t`` is
a function of *(seed, t)* only.  The reference draws with threefry
``fold_in(PRNGKey(seed), t)``, which torch cannot reproduce; the port uses
a counter-based integer hash of (seed, t, token id) as the uniform behind
a Gumbel-max draw — the same categorical distribution, keyed the same way,
other bits.  Greedy rows (``temperature == 0``) take the plain ``argmax``,
as the reference does.

Filter semantics (NumPy oracle :func:`filter_logits_ref`, copied from the
reference):

* **temperature** scales logits after filtering (masked entries stay
  ``-inf``); it never changes *which* tokens are eligible.
* **top_k** keeps every logit ``>=`` the k-th largest (ties at the
  threshold are all kept).  ``top_k <= 0`` disables the filter.
* **top_p** keeps the smallest prefix of the temperature-scaled,
  probability-sorted distribution whose mass reaches ``top_p`` — a token
  survives iff the mass *strictly before* it is ``< top_p``, so the
  argmax always survives and ``top_p >= 1`` keeps everything.
* **stop tokens** match against a ``-1``-padded ``(B, W)`` table; the
  matching token is still emitted, then the scheduler retires the request.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: widest stop-token set a request may carry (the match table is a
#: fixed-width, -1-padded (batch_slots, STOP_WIDTH) array).
STOP_WIDTH = 4

_NEG_INF = float("-inf")
_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding parameters.

    The default is greedy (``temperature=0``).  ``seed`` only matters when
    ``temperature > 0``; ``stop_tokens`` always apply.
    """

    temperature: float = 0.0
    top_k: int = 0           # 0 -> no top-k filter
    top_p: float = 1.0       # 1.0 -> no nucleus filter
    seed: int = 0
    stop_tokens: tuple[int, ...] = ()

    def validate(self) -> None:
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0 (0 = greedy), got "
                f"{self.temperature}"
            )
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(
                f"top_p must be in (0, 1], got {self.top_p}"
            )
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = off), got {self.top_k}")
        if not 0 <= self.seed < 2**32:
            raise ValueError(f"seed must be a uint32, got {self.seed}")
        if len(self.stop_tokens) > STOP_WIDTH:
            raise ValueError(
                f"at most {STOP_WIDTH} stop tokens per request, got "
                f"{len(self.stop_tokens)}"
            )
        if any(int(t) < 0 for t in self.stop_tokens):
            raise ValueError(
                f"stop tokens must be non-negative token ids, got "
                f"{self.stop_tokens}"
            )

    def stop_row(self) -> np.ndarray:
        """The request's ``(STOP_WIDTH,)`` -1-padded stop-token row."""
        row = np.full(STOP_WIDTH, -1, np.int32)
        row[: len(self.stop_tokens)] = np.asarray(self.stop_tokens, np.int32)
        return row


GREEDY = SamplingParams()


def filter_logits(logits, temperature, top_k, top_p):
    """``(B, V)`` logits -> temperature-scaled logits with every filtered
    entry at ``-inf``.  Row-wise ``temperature``/``top_k``/``top_p`` are
    ``(B,)`` tensors; thresholds come from one sort, so per-request values
    cost nothing extra."""
    V = logits.shape[-1]
    logits = logits.float()
    temperature = torch.clamp(temperature.float(), min=1e-6)
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values

    # top-k: keep logits >= k-th largest; k <= 0 disables
    k_eff = torch.where(top_k > 0, torch.clamp(top_k, 1, V), V).long()
    thr_k = torch.gather(sorted_desc, 1, (k_eff - 1)[:, None])

    # top-p on the temperature-scaled distribution: a sorted position
    # survives iff the probability mass strictly before it is < top_p
    probs = torch.softmax(sorted_desc / temperature[:, None], dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs
    n_keep = torch.sum(before < top_p[:, None], dim=-1)          # >= 1
    thr_p = torch.gather(sorted_desc, 1, (n_keep - 1).long()[:, None])
    # top_p >= 1 disables the filter outright: the cumulative mass can
    # saturate to exactly 1.0 in float32 and drop the underflowed tail
    thr_p = torch.where(top_p[:, None] >= 1.0, _NEG_INF, thr_p)

    keep = (logits >= thr_k) & (logits >= thr_p)
    return torch.where(keep, logits, _NEG_INF) / temperature[:, None]


def filter_logits_ref(logits, temperature, top_k, top_p):
    """NumPy oracle for :func:`filter_logits` (float64, one row at a time),
    copied from the reference."""
    logits = np.asarray(logits, np.float64).copy()
    B, V = logits.shape
    out = np.empty_like(logits, np.float32)
    for b in range(B):
        row = logits[b]
        temp = max(float(temperature[b]), 1e-6)
        order = np.argsort(-row, kind="stable")
        sorted_desc = row[order]
        k = int(top_k[b])
        thr_k = sorted_desc[min(k, V) - 1] if k > 0 else sorted_desc[-1]
        scaled = sorted_desc / temp
        probs = np.exp(scaled - scaled.max())
        probs /= probs.sum()
        before = np.cumsum(probs) - probs
        n_keep = max(int(np.sum(before < float(top_p[b]))), 1)
        thr_p = sorted_desc[n_keep - 1] if float(top_p[b]) < 1.0 \
            else -np.inf
        keep = (row >= thr_k) & (row >= thr_p)
        out[b] = np.where(keep, row, _NEG_INF) / temp
    return out


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit integer finalizer on int64 lanes holding values < 2**32.
    Multipliers are below 2**31, so no product leaves int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


def uniforms(seed: torch.Tensor, position: torch.Tensor, V: int) -> torch.Tensor:
    """(B, V) float32 uniforms in (0, 1), a function of (seed, position,
    token id) only — the port's counterpart of ``fold_in(seed, t)``."""
    key = _mix32(_mix32(seed.long() & _M32) ^ (position.long() & _M32))
    idx = torch.arange(V, dtype=torch.int64, device=seed.device)
    bits = _mix32(key[:, None] ^ idx[None, :])
    return ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))


def sample_tokens(logits, state):
    """Next-token draw for every row of ``(B, V)`` logits.

    ``state`` is the device serve state carrying the per-slot sampling
    tensors (``temp``/``top_k``/``top_p``/``seed``) and ``lengths``.
    Greedy rows take the plain argmax; sampled rows take the Gumbel-max
    draw over their filtered logits, keyed by (seed, position)."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    temp = state["temp"]
    filtered = filter_logits(logits, temp, state["top_k"], state["top_p"])
    u = uniforms(state["seed"], state["lengths"], logits.shape[-1])
    gumbel = -torch.log(-torch.log(u))
    sampled = torch.argmax(filtered + gumbel, dim=-1).to(torch.int32)
    return torch.where(temp > 0.0, sampled, greedy)


def hit_stop(tokens, stop_table):
    """``(B,)`` bool — did this row's new token match any entry of its
    ``(B, W)`` -1-padded stop set?"""
    return torch.any(tokens[:, None] == stop_table, dim=-1)
