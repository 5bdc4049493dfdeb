from repro_torch.models.model import forward, init_cache_defs, logits_for, model_param_defs
from repro_torch.models.params import ParamDef, count_params, init_params

__all__ = [
    "ParamDef",
    "count_params",
    "forward",
    "init_cache_defs",
    "init_params",
    "logits_for",
    "model_param_defs",
]
