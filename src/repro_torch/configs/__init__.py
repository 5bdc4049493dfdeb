from repro_torch.configs.base import (
    AttnSpec,
    LayerTemplate,
    ModelConfig,
    ceil_to,
    get_config,
    reduced,
    register,
)

__all__ = [
    "AttnSpec",
    "LayerTemplate",
    "ModelConfig",
    "ceil_to",
    "get_config",
    "reduced",
    "register",
]
