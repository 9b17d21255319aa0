"""SeamlessM4T Medium [arXiv:2308.11596; hf:facebook/seamless-m4t-medium].

Encoder-decoder transformer backbone: 12 encoder + 12 decoder layers,
d_model 1024, 16 heads (MHA), d_ff 4096, vocab 256206, LayerNorm.
The audio frontend (w2v-BERT conformer stack) is a STUB per the task:
``input_specs()`` provides precomputed frame embeddings to the encoder.
"""
from repro_torch.configs import ArchConfig, AttentionSpec

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,                 # decoder layers
    n_encoder_layers=12,
    d_model=1024,
    d_ff=4096,
    vocab=256_206,
    layer_pattern="F",
    norm="layernorm",
    attention=AttentionSpec(n_heads=16, n_kv_heads=16, d_head=64,
                            rope_theta=10_000.0),
    act="relu",
    frontend="audio_stub",
    frontend_tokens=1024,        # encoder frame positions (stubbed)
    tie_embeddings=True,
    source="arXiv:2308.11596; hf:facebook/seamless-m4t-medium",
)

SMOKE_CONFIG = ArchConfig(
    name="seamless-m4t-smoke",
    family="audio",
    n_layers=2,
    n_encoder_layers=2,
    d_model=64,
    d_ff=128,
    vocab=512,
    layer_pattern="F",
    norm="layernorm",
    attention=AttentionSpec(n_heads=4, n_kv_heads=4, d_head=16),
    act="relu",
    frontend="audio_stub",
    frontend_tokens=32,
)
