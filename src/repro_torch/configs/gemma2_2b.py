"""Gemma-2-2B: alternating local/global attention and logit softcaps
[arXiv:2408.00118]."""
from repro_torch.configs.base import AttnSpec, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="gemma2-2b",
        family="dense",
        num_layers=26,
        d_model=2304,
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab_size=256000,
        attn=AttnSpec(
            kind="local_global",
            window=4096,
            logit_softcap=50.0,
            rope_theta=10_000.0,
        ),
        final_logit_softcap=30.0,
        tie_embeddings=True,
        # 13 local + 13 global alternating layers
        subquadratic=True,
        source="arXiv:2408.00118; hf",
    )
)
