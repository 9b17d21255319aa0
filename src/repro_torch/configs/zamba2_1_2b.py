"""Zamba2 1.2B [arXiv:2411.15242; hf:Zyphra/Zamba2-1.2B].

38 layers, d_model 2048, Mamba-2 backbone (ssm_state 64) with a SHARED
attention block applied periodically (every 6th position here): the shared
block's parameters are reused at every application (the Zamba trick), and
its input is concat(hidden, original embedding) -> 2*d_model attention.
32 heads of d_head 128 over the 4096 concat width.
"""
from repro_torch.configs import ArchConfig, AttentionSpec, SSMSpec

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    d_ff=8192,
    vocab=32_000,
    layer_pattern="MMMMMS",
    norm="rmsnorm",
    attention=AttentionSpec(n_heads=32, n_kv_heads=32, d_head=128,
                            rope_theta=10_000.0),
    ssm=SSMSpec(d_state=64, d_conv=4, expand=2, head_dim=64),
    act="gelu",
    source="arXiv:2411.15242; hf:Zyphra/Zamba2-1.2B",
)

SMOKE_CONFIG = ArchConfig(
    name="zamba2-smoke",
    family="hybrid",
    n_layers=8,
    d_model=64,
    d_ff=128,
    vocab=512,
    layer_pattern="MMMMMS",
    norm="rmsnorm",
    attention=AttentionSpec(n_heads=4, n_kv_heads=4, d_head=32),
    ssm=SSMSpec(d_state=16, d_conv=4, expand=2, head_dim=32),
    act="gelu",
)
