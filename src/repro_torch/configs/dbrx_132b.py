"""DBRX-132B — 16-expert top-4 fine-grained MoE [hf:databricks/dbrx-base]."""
from repro_torch.configs.base import AttnSpec, ModelConfig, MoESpec, register

CONFIG = register(
    ModelConfig(
        name="dbrx-132b",
        family="moe",
        num_layers=40,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=10752,  # per-expert
        vocab_size=100352,
        attn=AttnSpec(kind="full", rope_theta=500_000.0),
        moe=MoESpec(num_experts=16, top_k=4, d_ff_expert=10752),
        subquadratic=False,
        source="arXiv:2405... hf:databricks/dbrx-base",
    )
)
