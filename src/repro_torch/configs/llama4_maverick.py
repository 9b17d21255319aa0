"""Llama-4 Maverick 400B-A17B [hf:meta-llama/Llama-4-Scout-17B-16E family;
unverified].

48 layers, d_model 5120, 40 heads / 8 KV heads, MoE (every other
layer) with 128 routed experts top-1 + 1 shared expert, expert d_ff 8192;
dense layers d_ff 16384; vocab 202048.  iRoPE-style
3:1 chunked-local:global attention (chunk 8192; global layers NoPE-like
with large theta).  Early-fusion multimodal in the original; the modality
frontend here is the standard stub (text cells exercise the backbone).
"""
from repro_torch.configs import ArchConfig, AttentionSpec, MoESpec

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    d_ff=8192,
    vocab=202_048,
    layer_pattern="CCCG",
    norm="rmsnorm",
    attention=AttentionSpec(
        n_heads=40, n_kv_heads=8, d_head=128,
        rope_theta=500_000.0, chunk=8192,
    ),
    moe=MoESpec(n_experts=128, top_k=1, d_ff_expert=8192, n_shared=1,
                moe_period=2, dense_d_ff=16384),
    act="silu",
    source="hf:meta-llama/Llama-4-Scout-17B-16E (family); unverified",
)

SMOKE_CONFIG = ArchConfig(
    name="llama4-maverick-smoke",
    family="moe",
    n_layers=4,
    d_model=64,
    d_ff=128,
    vocab=512,
    layer_pattern="CCCG",
    norm="rmsnorm",
    attention=AttentionSpec(n_heads=4, n_kv_heads=2, d_head=16, chunk=64),
    moe=MoESpec(n_experts=4, top_k=1, d_ff_expert=128, n_shared=1,
                moe_period=2, dense_d_ff=256),
    act="silu",
)
