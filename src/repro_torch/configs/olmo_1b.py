"""OLMo 1B [arXiv:2402.00838; hf:allenai/OLMo-1B].

16 layers, d_model 2048, 16 heads (MHA: kv=16), d_ff 8192, vocab 50304.
Distinctive: non-parametric LayerNorm (no learned scale/bias).
"""
from repro_torch.configs import ArchConfig, AttentionSpec

CONFIG = ArchConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    d_ff=8192,
    vocab=50_304,
    layer_pattern="F",
    norm="nonparametric",
    attention=AttentionSpec(n_heads=16, n_kv_heads=16, d_head=128,
                            rope_theta=10_000.0),
    act="silu",
    source="arXiv:2402.00838; hf:allenai/OLMo-1B",
)

SMOKE_CONFIG = ArchConfig(
    name="olmo-1b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    d_ff=256,
    vocab=512,
    layer_pattern="F",
    norm="nonparametric",
    attention=AttentionSpec(n_heads=4, n_kv_heads=4, d_head=16),
    act="silu",
)
