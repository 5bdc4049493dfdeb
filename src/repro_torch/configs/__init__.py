from repro_torch.configs.base import (
    SHAPES,
    AttnSpec,
    LayerTemplate,
    MambaSpec,
    ModelConfig,
    MoESpec,
    ShapeSpec,
    ceil_to,
    get_config,
    list_configs,
    reduced,
    register,
    shape_applicable,
)

# the dry run's grid: every architecture of the reference's assignment
ASSIGNED_ARCHS = (
    "chameleon-34b",
    "musicgen-large",
    "moonshot-v1-16b-a3b",
    "dbrx-132b",
    "h2o-danube-1.8b",
    "mistral-large-123b",
    "gemma2-2b",
    "yi-34b",
    "mamba2-2.7b",
    "jamba-v0.1-52b",
)

__all__ = [
    "ASSIGNED_ARCHS",
    "SHAPES",
    "AttnSpec",
    "LayerTemplate",
    "MambaSpec",
    "ModelConfig",
    "MoESpec",
    "ShapeSpec",
    "ceil_to",
    "get_config",
    "list_configs",
    "reduced",
    "register",
    "shape_applicable",
]
