"""Yi-34B — llama-architecture GQA dense [arXiv:2403.04652]."""
from repro_torch.configs.base import AttnSpec, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="yi-34b",
        family="dense",
        num_layers=60,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        d_ff=20480,
        vocab_size=64000,
        attn=AttnSpec(kind="full", rope_theta=5_000_000.0),
        subquadratic=False,
        source="arXiv:2403.04652; hf",
    )
)
