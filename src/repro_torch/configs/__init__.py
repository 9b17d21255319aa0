"""Architecture configs + input-shape registry.

One module per assigned architecture (exact public-literature config);
this package holds the shared dataclasses, the shape registry, and the
``get_config`` / ``list_archs`` entry points used by ``--arch <id>``.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Mapping


@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    n_heads: int
    n_kv_heads: int
    d_head: int
    kind: str = "gqa"              # "gqa" | "mla"
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_theta_global: float = 0.0  # != 0 -> distinct theta for 'G' layers
    window: int = 0                # sliding-window size for 'L' layers
    chunk: int = 0                 # chunk size for 'C' layers
    # MLA (DeepSeek-V2):
    q_lora: int = 0
    kv_lora: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0
    v_head_dim: int = 0


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    first_k_dense: int = 0         # leading layers use the dense FFN
    dense_d_ff: int = 0            # FFN width of dense (non-MoE) layers
    moe_period: int = 1            # MoE every k-th layer (llama4: 2)
    capacity_factor: float = 1.25
    router_type: str = "softmax"   # softmax top-k (GShard-style)

    def is_moe_layer(self, idx: int) -> bool:
        if idx < self.first_k_dense:
            return False
        return (idx + 1) % self.moe_period == 0


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    layer_pattern: str = "F"       # cycled codes: F full, L sliding-local,
                                   # G global, C chunked-local, M mamba2,
                                   # S shared-attention (zamba)
    norm: str = "rmsnorm"          # rmsnorm | layernorm | nonparametric
    attention: AttentionSpec | None = None
    moe: MoESpec | None = None
    ssm: SSMSpec | None = None
    tie_embeddings: bool = True
    act: str = "silu"              # mlp activation (dense FFN is gated GLU)
    # enc-dec only:
    n_encoder_layers: int = 0
    # modality frontends are STUBS: input_specs provide embeddings directly.
    frontend: str = "none"         # none | vision_stub | audio_stub
    frontend_tokens: int = 0       # prepended embedding positions (stub)
    dtype: str = "bfloat16"
    # reference provenance
    source: str = ""

    # --- derived -----------------------------------------------------------
    def layer_codes(self) -> str:
        """Expand the cyclic pattern to exactly n_layers codes."""
        p = self.layer_pattern
        reps = math.ceil(self.n_layers / len(p))
        codes = (p * reps)[: self.n_layers]
        return codes

    def stages(self) -> list[tuple[str, int, int]]:
        """(codes, repeat, start_layer) stages; concatenation = layer_codes().

        A stage is scanned with stacked params: one `while` per stage in
        the lowered HLO, body = one pattern period.  Layers whose FFN kind
        differs from the rest of the period (``first_k_dense``) get their
        own leading stage so every scan body is homogeneous; within a
        stage, per-position MoE-ness is start-aligned (moe_period must
        divide the pattern length, asserted when the model defs are built).
        """
        codes = self.layer_codes()
        p = self.layer_pattern
        lead = self.moe.first_k_dense if self.moe else 0
        out: list[tuple[str, int, int]] = []
        if lead:
            out.append((codes[:lead], 1, 0))
            codes = codes[lead:]
        full, rem = divmod(len(codes), len(p))
        if full:
            out.append((p, full, lead))
        if rem:
            out.append((codes[-rem:], 1, lead + full * len(p)))
        return out

    def num_params(self) -> float:
        """Analytic parameter count (embedding + layers)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        total = float(v * d)                       # embedding
        if not self.tie_embeddings:
            total += v * d
        for i, code in enumerate(self.layer_codes()):
            total += self._layer_params(code, idx=i)
        total += self.shared_block_params()
        if self.n_encoder_layers:
            for _ in range(self.n_encoder_layers):
                total += self._layer_params("F")
            # decoder layers add cross-attention
            total += self.n_layers * self._attn_params()  # cross-attn
        return total

    def _attn_params(self) -> float:
        a = self.attention
        if a is None:
            return 0.0
        d = self.d_model
        if a.kind == "mla":
            qk_head = a.nope_head_dim + a.rope_head_dim
            q = (d * a.q_lora + a.q_lora * a.n_heads * qk_head) if a.q_lora \
                else d * a.n_heads * qk_head
            kv = d * (a.kv_lora + a.rope_head_dim)
            kv += a.kv_lora * a.n_heads * (a.nope_head_dim + a.v_head_dim)
            o = a.n_heads * a.v_head_dim * d
            return float(q + kv + o)
        q = d * a.n_heads * a.d_head
        kv = 2 * d * a.n_kv_heads * a.d_head
        o = a.n_heads * a.d_head * d
        return float(q + kv + o)

    def _ffn_params(self, idx: int) -> float:
        d = self.d_model
        if self.moe is not None and self.moe.is_moe_layer(idx):
            e = self.moe
            expert = 3 * d * e.d_ff_expert
            return float(
                (e.n_experts + e.n_shared) * expert + d * e.n_experts
            )
        ff = self.d_ff
        if self.moe is not None and self.moe.dense_d_ff:
            ff = self.moe.dense_d_ff
        return float(3 * d * ff)

    def _ssm_params(self) -> float:
        s = self.ssm
        d = self.d_model
        di = s.d_inner(d)
        h = s.n_heads(d)
        in_proj = d * (2 * di + 2 * s.d_state + h)
        conv = s.d_conv * (di + 2 * s.d_state)
        out = di * d
        return float(in_proj + conv + out + h + di)

    def _layer_params(self, code: str, idx: int = 0) -> float:
        if code == "M":
            return self._ssm_params()
        if code == "S":
            # zamba-style shared block: params counted ONCE globally; here
            # return only the per-application LoRA-free glue (proj in/out
            # are shared too) -> 0 marginal. Shared cost added below.
            return 0.0
        return self._attn_params() + self._ffn_params(idx)

    def shared_block_params(self) -> float:
        """Zamba-style shared attention block (counted once)."""
        if "S" not in self.layer_pattern or self.attention is None:
            return 0.0
        a = self.attention
        dc = 2 * self.d_model             # concat(hidden, emb0)
        attn = dc * a.n_heads * a.d_head * 2 \
            + 2 * dc * a.n_kv_heads * a.d_head
        out = a.n_heads * a.d_head * self.d_model
        return float(attn + out)

    def active_params(self) -> float:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.num_params()
        d = self.d_model
        e = self.moe
        total = float(self.vocab * d)
        for i, code in enumerate(self.layer_codes()):
            if code in ("M", "S"):
                total += self._layer_params(code, idx=i)
                continue
            total += self._attn_params()
            if not e.is_moe_layer(i):
                total += 3 * d * (e.dense_d_ff or self.d_ff)
            else:
                total += (e.top_k + e.n_shared) * 3 * d * e.d_ff_expert
                total += d * e.n_experts  # router
        return total


# ---------------------------------------------------------------------------
# Shapes (assigned): every arch runs the same 4 shapes, with documented skips
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str                      # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

#: archs whose every layer is unwindowed full attention: long_500k skipped
#: (sub-quadratic requirement; see DESIGN.md §Arch-applicability).
PURE_FULL_ATTENTION = frozenset(
    {"olmo-1b", "granite-8b", "yi-6b", "deepseek-v2-236b",
     "seamless-m4t-medium", "internvl2-1b"}
)


def shape_applicable(arch: str, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and arch in PURE_FULL_ATTENTION:
        return False, "pure full attention at 500k (see DESIGN.md)"
    return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_ARCH_MODULES = {
    "gemma3-27b": "gemma3_27b",
    "olmo-1b": "olmo_1b",
    "granite-8b": "granite_8b",
    "yi-6b": "yi_6b",
    "mamba2-780m": "mamba2_780m",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "zamba2-1.2b": "zamba2_1_2b",
    "internvl2-1b": "internvl2_1b",
}


def list_archs() -> list[str]:
    return list(_ARCH_MODULES)


def get_config(arch: str) -> ArchConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def smoke_config(arch: str) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.SMOKE_CONFIG
