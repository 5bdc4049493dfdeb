"""Llama-3.1-8B, the paper's primary evaluation model [arXiv:2407.21783]."""
from repro_torch.configs.base import AttnSpec, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="llama3-8b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=128256,
        attn=AttnSpec(kind="full", rope_theta=500_000.0),
        source="arXiv:2407.21783",
    )
)
