"""Yi 6B [arXiv:2403.04652; hf:01-ai/Yi-6B].

32 layers, d_model 4096, 32 heads / 4 KV heads (GQA), d_ff 11008,
vocab 64000.  Llama-architecture with aggressive GQA (8:1).
"""
from repro_torch.configs import ArchConfig, AttentionSpec

CONFIG = ArchConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    d_ff=11008,
    vocab=64_000,
    layer_pattern="F",
    norm="rmsnorm",
    attention=AttentionSpec(n_heads=32, n_kv_heads=4, d_head=128,
                            rope_theta=5_000_000.0),
    act="silu",
    source="arXiv:2403.04652; hf:01-ai/Yi-6B",
)

SMOKE_CONFIG = ArchConfig(
    name="yi-6b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    d_ff=256,
    vocab=512,
    layer_pattern="F",
    norm="rmsnorm",
    attention=AttentionSpec(n_heads=8, n_kv_heads=1, d_head=16),
    act="silu",
)
