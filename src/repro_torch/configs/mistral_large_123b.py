"""Mistral-Large-123B [hf:mistralai/Mistral-Large-Instruct-2407]."""
from repro_torch.configs.base import AttnSpec, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="mistral-large-123b",
        family="dense",
        num_layers=88,
        d_model=12288,
        num_heads=96,
        num_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab_size=32768,
        attn=AttnSpec(kind="full", rope_theta=1_000_000.0),
        subquadratic=False,
        source="hf:mistralai/Mistral-Large-Instruct-2407",
    )
)
