"""Model configuration for the PyTorch port.

The port's own copy of ``repro.configs.base``'s model configuration: the
same field names and derived properties, so a configuration built from the
same numbers describes the same model in both packages (dense, MoE, the
Mamba state family and the hybrid of the two). ``frontend`` is carried as a
field:
a "vq_image" model (image content as VQ token ids in the shared vocabulary)
and an "encodec" model (audio codebook ids, or precomputed frame embeddings
through ``forward``'s ``embeds``) run on the plain dense backbone.
"""
from __future__ import annotations

import math
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
class MoESpec:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3
    moe_every: int = 1  # 1 = every FFN is MoE; 2 = alternate dense/MoE


@dataclass(frozen=True)
class MambaSpec:
    """Covers Mamba-1 (selective scan) and Mamba-2 (SSD)."""

    version: int = 2  # 1 | 2
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64  # mamba-2 only
    ngroups: int = 1  # mamba-2 only (B/C groups)
    chunk: int = 256  # SSD chunk length


@dataclass(frozen=True)
class LayerTemplate:
    mixer: str  # "attn" | "attn_local" | "attn_global" | "mamba"
    ffn: str  # "dense" | "moe" | "none"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    attn: AttnSpec = field(default_factory=AttnSpec)
    moe: Optional[MoESpec] = None
    mamba: Optional[MambaSpec] = None
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
        if self.family == "ssm":
            return (LayerTemplate("mamba", "none"),)
        ffn = "moe" if (self.moe and self.moe.moe_every == 1) else "dense"
        if self.attn.kind == "local_global":
            return (LayerTemplate("attn_local", ffn), LayerTemplate("attn_global", ffn))
        return (LayerTemplate("attn", ffn),)

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

    @property
    def n_mamba_layers(self) -> int:
        per = sum(1 for t in self.layer_pattern if t.mixer == "mamba")
        return per * self.num_periods

    @property
    def d_inner(self) -> int:
        if self.mamba is None:
            raise ValueError(f"{self.name}: d_inner of a model without a MambaSpec")
        return self.mamba.expand * self.d_model

    def param_count(self) -> int:
        """Total parameters (embedding included once if tied)."""
        n = self.vocab_padded * self.d_model  # embed
        if not self.tie_embeddings:
            n += self.vocab_padded * self.d_model  # lm head
        for t in self.layer_pattern:
            ln = 0
            if t.mixer.startswith("attn"):
                ln += self.d_model * self.num_heads * self.head_dim  # q
                ln += 2 * self.d_model * self.num_kv_heads * self.head_dim  # k, v
                ln += self.num_heads * self.head_dim * self.d_model  # o
            elif t.mixer == "mamba":
                m = self.mamba
                d_in = self.d_inner
                if m.version == 2:
                    nheads = d_in // m.head_dim
                    conv_dim = d_in + 2 * m.ngroups * m.d_state
                    ln += self.d_model * (2 * d_in + 2 * m.ngroups * m.d_state + nheads)
                    ln += conv_dim * m.d_conv
                    ln += d_in * self.d_model  # out proj
                    ln += 2 * nheads  # A_log, D
                else:
                    ln += self.d_model * 2 * d_in  # in_proj (x, z)
                    ln += d_in * m.d_conv  # conv
                    ln += d_in * (m.d_state * 2 + math.ceil(self.d_model / 16))
                    ln += d_in * m.d_state  # A
                    ln += d_in * 2  # D, dt bias
                    ln += d_in * self.d_model  # out proj
            if t.ffn == "dense":
                ln += 3 * self.d_model * self.d_ff  # swiglu
            elif t.ffn == "moe":
                m = self.moe
                ln += (m.num_experts + m.num_shared_experts) * 3 * self.d_model * m.d_ff_expert
                ln += self.d_model * m.num_experts  # router
            ln += 2 * self.d_model  # norms
            n += ln * self.num_periods
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        n_moe_layers = sum(1 for t in self.layer_pattern if t.ffn == "moe") * self.num_periods
        unused = (m.num_experts - m.top_k) * 3 * self.d_model * m.d_ff_expert
        return self.param_count() - n_moe_layers * unused


def ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Input shapes of the dry run's cells (seq_len x global_batch), the
# reference's (repro/configs/base.py). decode_* / long_* run a serve step
# (one token against a seq_len-deep cache), not a train step.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> bool:
    """long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k":
        return cfg.subquadratic
    return True


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


def list_configs() -> list:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all() -> None:
    from repro_torch.configs import (  # noqa: F401
        chameleon_34b,
        dbrx_132b,
        gemma2_2b,
        h2o_danube_1_8b,
        jamba_v0_1_52b,
        llama3_8b,
        mamba2_2_7b,
        mistral_large_123b,
        moonshot_v1_16b_a3b,
        musicgen_large,
        yi_34b,
    )


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
    if cfg.moe is not None:
        # capacity_factor high enough that nothing drops at test scale —
        # capacity dropping is batch-composition dependent and would break
        # exact prefill/decode-vs-full consistency checks.
        kw["moe"] = replace(cfg.moe, num_experts=4, top_k=2, d_ff_expert=64, capacity_factor=8.0)
    if cfg.mamba is not None:
        kw["mamba"] = replace(cfg.mamba, d_state=16, head_dim=16, expand=2, chunk=16)
    return replace(cfg, **kw)
