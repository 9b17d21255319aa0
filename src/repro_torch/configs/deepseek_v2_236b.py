"""DeepSeek-V2 236B [arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2].

60 layers, d_model 5120, 128 heads with Multi-head Latent Attention
(kv_lora 512, q_lora 1536, 128 nope + 64 rope qk dims, v 128),
MoE: 2 shared + 160 routed experts, top-6, expert d_ff 1536; first layer
dense (d_ff 12288).  vocab 102400.

MLA is itself a data-movement optimization (the paper's theme): the decode
KV cache is the 512-dim latent + 64-dim rope key instead of
128 heads x 256 dims — 110x smaller reads per token.
"""
from repro_torch.configs import ArchConfig, AttentionSpec, MoESpec

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    d_ff=1536,                # routed-expert FFN width (assignment value)
    vocab=102_400,
    layer_pattern="F",
    norm="rmsnorm",
    attention=AttentionSpec(
        n_heads=128, n_kv_heads=128, d_head=192, kind="mla",
        q_lora=1536, kv_lora=512,
        rope_head_dim=64, nope_head_dim=128, v_head_dim=128,
        rope_theta=10_000.0,
    ),
    moe=MoESpec(
        n_experts=160, top_k=6, d_ff_expert=1536, n_shared=2,
        first_k_dense=1, dense_d_ff=12288,
    ),
    act="silu",
    source="arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2",
)

SMOKE_CONFIG = ArchConfig(
    name="deepseek-v2-236b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    d_ff=32,
    vocab=512,
    layer_pattern="F",
    norm="rmsnorm",
    attention=AttentionSpec(
        n_heads=4, n_kv_heads=4, d_head=24, kind="mla",
        q_lora=32, kv_lora=32, rope_head_dim=8, nope_head_dim=16,
        v_head_dim=16,
    ),
    moe=MoESpec(n_experts=8, top_k=2, d_ff_expert=32, n_shared=1,
                first_k_dense=1, dense_d_ff=128),
    act="silu",
)
