"""Model configuration for the PyTorch port.

The port's own copy of the dense subset of ``repro.configs.base``: the same
field names and derived properties, so a configuration built from the same
numbers describes the same model in both packages. MoE and Mamba come with
the slices that port those families; ``frontend`` is carried as a field,
and a "vq_image" model (image content as VQ token ids in the shared
vocabulary) runs on the plain dense backbone.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional


@dataclass(frozen=True)
class AttnSpec:
    """kind: "full" | "swa" (sliding window) | "local_global" (alternating
    local/global layers, gemma-2)."""

    kind: str = "full"
    window: Optional[int] = None
    logit_softcap: Optional[float] = None  # attention-score softcap (gemma2)
    rope_theta: float = 10_000.0
    qk_norm: bool = False


@dataclass(frozen=True)
class LayerTemplate:
    mixer: str  # "attn" | "attn_local" | "attn_global"
    ffn: str  # "dense" | "none"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    attn: AttnSpec = field(default_factory=AttnSpec)
    pattern: Optional[tuple] = None
    norm_eps: float = 1e-6
    final_logit_softcap: Optional[float] = None
    tie_embeddings: bool = False
    frontend: Optional[str] = None  # "vq_image" | "encodec" (stub embeddings)
    subquadratic: bool = False  # eligible for long_500k
    source: str = ""  # citation tag

    @property
    def vocab_padded(self) -> int:
        return ceil_to(self.vocab_size, 256)

    @property
    def layer_pattern(self) -> tuple:
        if self.pattern is not None:
            return self.pattern
        if self.attn.kind == "local_global":
            return (LayerTemplate("attn_local", "dense"), LayerTemplate("attn_global", "dense"))
        return (LayerTemplate("attn", "dense"),)

    @property
    def num_periods(self) -> int:
        p = len(self.layer_pattern)
        if self.num_layers % p:
            raise ValueError(f"{self.name}: {self.num_layers} layers do not fill periods of {p}")
        return self.num_layers // p

    @property
    def n_attn_layers(self) -> int:
        per = sum(1 for t in self.layer_pattern if t.mixer.startswith("attn"))
        return per * self.num_periods


def ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def _load_all() -> None:
    from repro_torch.configs import chameleon_34b, gemma2_2b, h2o_danube_1_8b, llama3_8b  # noqa: F401


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Small same-family config: few layers, tiny dims, runnable on CPU."""
    period = len(cfg.layer_pattern)
    kw = dict(
        name=cfg.name + "-reduced",
        num_layers=period * (2 if period == 1 else 1),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2),
        head_dim=16,
        d_ff=128,
        vocab_size=256,
    )
    if cfg.attn.window is not None:
        kw["attn"] = replace(cfg.attn, window=16)
    return replace(cfg, **kw)
