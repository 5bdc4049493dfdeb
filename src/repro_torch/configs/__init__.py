from repro_torch.configs.base import (
    AttnSpec,
    LayerTemplate,
    MambaSpec,
    ModelConfig,
    MoESpec,
    ceil_to,
    get_config,
    list_configs,
    reduced,
    register,
)

__all__ = [
    "AttnSpec",
    "LayerTemplate",
    "MambaSpec",
    "ModelConfig",
    "MoESpec",
    "ceil_to",
    "get_config",
    "list_configs",
    "reduced",
    "register",
]
