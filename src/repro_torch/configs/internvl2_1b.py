"""InternVL2 1B [arXiv:2404.16821; hf:OpenGVLab/InternVL2-1B].

VLM: InternViT-300M vision encoder + Qwen2-0.5B language backbone.
The LM backbone (the assigned cells): 24 layers, d_model 896,
14 heads / 2 KV heads, d_ff 4864, vocab 151655.  The ViT frontend is a
STUB per the task: ``input_specs()`` provides precomputed patch
embeddings prepended to the token embeddings.
"""
from repro_torch.configs import ArchConfig, AttentionSpec

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    d_ff=4864,
    vocab=151_655,
    layer_pattern="F",
    norm="rmsnorm",
    attention=AttentionSpec(n_heads=14, n_kv_heads=2, d_head=64,
                            rope_theta=1_000_000.0),
    act="silu",
    frontend="vision_stub",
    frontend_tokens=256,         # ViT patch embeddings per image (stub)
    source="arXiv:2404.16821; hf:OpenGVLab/InternVL2-1B",
)

SMOKE_CONFIG = ArchConfig(
    name="internvl2-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    d_ff=128,
    vocab=512,
    layer_pattern="F",
    norm="rmsnorm",
    attention=AttentionSpec(n_heads=4, n_kv_heads=2, d_head=16),
    act="silu",
    frontend="vision_stub",
    frontend_tokens=16,
)
