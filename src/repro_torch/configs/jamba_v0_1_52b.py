"""Jamba-v0.1-52B — Mamba+attention 1:7 interleave with MoE 16e top-2
[arXiv:2403.19887].

Faithful period-8 block (HF: attn_layer_period=8 offset=4;
expert_layer_period=2 offset=1). Jamba uses Mamba-1 (selective scan,
d_state=16).
"""
from repro_torch.configs.base import (
    AttnSpec,
    LayerTemplate,
    MambaSpec,
    ModelConfig,
    MoESpec,
    register,
)

_PATTERN = tuple(
    LayerTemplate(
        mixer="attn" if i == 4 else "mamba",
        ffn="moe" if i % 2 == 1 else "dense",
    )
    for i in range(8)
)

CONFIG = register(
    ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=65536,
        attn=AttnSpec(kind="full", rope_theta=10_000.0),
        moe=MoESpec(num_experts=16, top_k=2, d_ff_expert=14336, moe_every=2),
        mamba=MambaSpec(version=1, d_state=16, d_conv=4, expand=2, chunk=64),
        pattern=_PATTERN,
        subquadratic=True,  # only 4/32 layers keep full KV
        source="arXiv:2403.19887; hf",
    )
)
