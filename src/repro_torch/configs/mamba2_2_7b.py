"""Mamba2-2.7B — SSD (state-space duality), attention-free [arXiv:2405.21060].

d_inner = 2*2560 = 5120, 80 heads of head_dim 64, d_state 128. There is no
KV cache: what a TP switch has to carry is each sequence's SSD state and
conv tail.
"""
from repro_torch.configs.base import MambaSpec, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="mamba2-2.7b",
        family="ssm",
        num_layers=64,
        d_model=2560,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=50280,
        mamba=MambaSpec(version=2, d_state=128, d_conv=4, expand=2, head_dim=64, ngroups=1),
        subquadratic=True,
        source="arXiv:2405.21060",
    )
)
