"""Chameleon-34B: early-fusion VLM backbone [arXiv:2405.09818].

Early fusion means image content arrives as VQ tokens inside the shared
vocabulary, so the backbone is a plain dense decoder fed token ids; it is
the one assigned model with qk-norm.
"""
from repro_torch.configs.base import AttnSpec, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="chameleon-34b",
        family="vlm",
        num_layers=48,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=22016,
        vocab_size=65536,
        attn=AttnSpec(kind="full", rope_theta=10_000.0, qk_norm=True),
        frontend="vq_image",
        subquadratic=False,
        source="arXiv:2405.09818",
    )
)
