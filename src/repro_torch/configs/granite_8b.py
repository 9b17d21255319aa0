"""Granite 8B Code [arXiv:2405.04324; hf:ibm-granite/granite-8b-code-base].

36 layers, d_model 4096, 32 heads / 8 KV heads (GQA), d_ff 14336,
vocab 49152.  Llama-architecture, code-oriented; large RoPE base.
"""
from repro_torch.configs import ArchConfig, AttentionSpec

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    d_ff=14336,
    vocab=49_152,
    layer_pattern="F",
    norm="rmsnorm",
    attention=AttentionSpec(n_heads=32, n_kv_heads=8, d_head=128,
                            rope_theta=10_000_000.0),
    act="silu",
    source="arXiv:2405.04324; hf:ibm-granite/granite-8b-code-base",
)

SMOKE_CONFIG = ArchConfig(
    name="granite-8b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    d_ff=256,
    vocab=512,
    layer_pattern="F",
    norm="rmsnorm",
    attention=AttentionSpec(n_heads=4, n_kv_heads=2, d_head=16),
    act="silu",
)
