"""Gemma-3 27B [hf:google/gemma-3-27b-pt family; unverified].

62 layers, d_model 5376, 32 query heads / 16 KV heads (GQA), d_ff 21504,
vocab 262144.  5:1 local:global attention pattern — five sliding-window
(W=1024) layers per global layer, with distinct RoPE bases (10k local,
1M global) and QK-norm.
"""
from repro_torch.configs import ArchConfig, AttentionSpec

CONFIG = ArchConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    d_ff=21504,
    vocab=262_144,
    layer_pattern="LLLLLG",
    norm="rmsnorm",
    attention=AttentionSpec(
        n_heads=32, n_kv_heads=16, d_head=128,
        qk_norm=True, rope_theta=10_000.0, rope_theta_global=1_000_000.0,
        window=1024,
    ),
    act="gelu",
    source="hf:google/gemma-3-27b-pt (family card); 5:1 local:global, 128k ctx",
)

SMOKE_CONFIG = ArchConfig(
    name="gemma3-27b-smoke",
    family="dense",
    n_layers=8,                      # one full period + tail, order preserved
    d_model=64,
    d_ff=256,
    vocab=512,
    layer_pattern="LLLLLG",
    norm="rmsnorm",
    attention=AttentionSpec(
        n_heads=4, n_kv_heads=2, d_head=16,
        qk_norm=True, rope_theta=10_000.0, rope_theta_global=1_000_000.0,
        window=32,
    ),
    act="gelu",
)
