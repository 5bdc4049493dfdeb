"""H2O-Danube-1.8B: llama and mistral mixed, with sliding-window attention
[arXiv:2401.16818]."""
from repro_torch.configs.base import AttnSpec, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="h2o-danube-1.8b",
        family="dense",
        num_layers=24,
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,
        head_dim=80,
        d_ff=6912,
        vocab_size=32000,
        attn=AttnSpec(kind="swa", window=4096, rope_theta=10_000.0),
        subquadratic=True,  # SWA bounds the KV
        source="arXiv:2401.16818; hf",
    )
)
