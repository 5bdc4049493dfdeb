"""MusicGen-large — decoder-only over EnCodec tokens [arXiv:2306.05284].

The EnCodec frontend is a stub: the backbone takes precomputed frame
embeddings (B, S, d_model) through ``forward``'s ``embeds``, or codebook ids
through the embedding (as the serving engine feeds it); the output head
predicts the 2048-entry codebook.
"""
from repro_torch.configs.base import AttnSpec, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="musicgen-large",
        family="audio",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,  # MHA
        head_dim=64,
        d_ff=8192,
        vocab_size=2048,
        attn=AttnSpec(kind="full", rope_theta=10_000.0),
        frontend="encodec",
        subquadratic=False,
        source="arXiv:2306.05284; hf",
    )
)
