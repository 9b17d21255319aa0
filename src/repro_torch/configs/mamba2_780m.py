"""Mamba-2 780M [arXiv:2405.21060; hf:state-spaces/mamba2-780m].

48 layers, d_model 1536, attention-free SSD (state-space duality),
ssm_state 128, vocab 50280.  expand=2 -> d_inner 3072, head_dim 64
-> 48 SSD heads.
"""
from repro_torch.configs import ArchConfig, SSMSpec

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    d_ff=0,
    vocab=50_280,
    layer_pattern="M",
    norm="rmsnorm",
    ssm=SSMSpec(d_state=128, d_conv=4, expand=2, head_dim=64),
    source="arXiv:2405.21060; hf:state-spaces/mamba2-780m",
)

SMOKE_CONFIG = ArchConfig(
    name="mamba2-780m-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    d_ff=0,
    vocab=512,
    layer_pattern="M",
    norm="rmsnorm",
    ssm=SSMSpec(d_state=16, d_conv=4, expand=2, head_dim=32),
)
