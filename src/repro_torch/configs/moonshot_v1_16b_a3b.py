"""Moonlight-16B-A3B (kimi/moonshot) — MoE 64e top-6 [hf:moonshotai/Moonlight-16B-A3B]."""
from repro_torch.configs.base import AttnSpec, ModelConfig, MoESpec, register

CONFIG = register(
    ModelConfig(
        name="moonshot-v1-16b-a3b",
        family="moe",
        num_layers=48,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1408,  # per-expert
        vocab_size=163840,
        attn=AttnSpec(kind="full", rope_theta=50_000.0),
        moe=MoESpec(num_experts=64, top_k=6, d_ff_expert=1408),
        subquadratic=False,
        source="hf:moonshotai/Moonlight-16B-A3B",
    )
)
