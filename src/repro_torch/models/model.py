"""Dense decoder stack (mirrors repro/models/model.py for the dense family).

``forward`` takes the *bound* parameters that ``WeightStore.rebind`` makes
for one TP level: a dict with ``embed``, ``layers`` (one dict per layer,
model-sharded weights as ``ShardView``s), ``final_norm`` and ``lm_head``.
The reference's scan over pattern periods is a Python loop over layers.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import attn_apply, attn_cache_defs, attn_param_defs
from repro_torch.models.layers import col_parallel, mlp_apply, mlp_param_defs, norm_def, rmsnorm, softcap, vocab_parallel_embed
from repro_torch.models.params import ParamDef, stack_defs
from repro_torch.parallel.sharding import ExecConfig


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what this slice of the port does not run yet."""
    unsupported = []
    if cfg.family != "dense":
        unsupported.append(f"family {cfg.family!r}")
    if cfg.attn.kind != "full" or cfg.attn.window is not None:
        unsupported.append(f"attention kind {cfg.attn.kind!r}")
    if cfg.attn.qk_norm:
        unsupported.append("qk_norm")
    if cfg.tie_embeddings:
        unsupported.append("tied embeddings")
    if any(t.mixer != "attn" or t.ffn != "dense" for t in cfg.layer_pattern):
        unsupported.append(f"layer pattern {cfg.layer_pattern}")
    if unsupported:
        raise NotImplementedError(f"{cfg.name}: " + ", ".join(unsupported))


def model_param_defs(cfg: ModelConfig, ec: ExecConfig) -> dict:
    check_supported(cfg)
    d = cfg.d_model
    per_period = {
        f"pos{i}": {
            "norm1": norm_def(d),
            "mixer": attn_param_defs(cfg, ec),
            "norm2": norm_def(d),
            "ffn": mlp_param_defs(d, cfg.d_ff),
        }
        for i, _ in enumerate(cfg.layer_pattern)
    }
    return {
        "embed": ParamDef((cfg.vocab_padded, d), ("vocab", "embed"), scale=1.0),
        "periods": stack_defs(per_period, cfg.num_periods),
        "final_norm": norm_def(d),
        "lm_head": ParamDef((d, cfg.vocab_padded), ("embed", "vocab")),
    }


def init_cache_defs(cfg: ModelConfig, ec: ExecConfig, batch: int, seq_len: int) -> List[dict]:
    """One {"k", "v"} cache def per layer."""
    check_supported(cfg)
    return [attn_cache_defs(cfg, ec, batch, seq_len) for _ in range(cfg.num_layers)]


def forward(
    params: dict,
    cfg: ModelConfig,
    ec: ExecConfig,
    *,
    tokens: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[List[dict]] = None,
    block_tables: Optional[torch.Tensor] = None,
    seq_lens: Optional[torch.Tensor] = None,
    mode: str = "prefill",
    block_q: int = 512,
    block_k: int = 512,
) -> Tuple[torch.Tensor, List[dict]]:
    """Returns (hidden (B,S,D) after the final norm, per-layer caches).

    prefill: tokens (B,S); returns each layer's (B,S,KV,hd) K/V.
    decode: tokens (B,1), positions (B,); writes each layer's new K/V into
    ``cache`` in place, attends through ``block_tables``/``seq_lens``.
    """
    if mode not in ("prefill", "decode"):
        raise ValueError(f"mode must be 'prefill' or 'decode', got {mode!r}")
    h = vocab_parallel_embed(tokens, params["embed"])
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
    new_cache = []
    for i, lp in enumerate(params["layers"]):
        y, nc = attn_apply(
            lp["mixer"], rmsnorm(h, lp["norm1"], cfg.norm_eps), cfg=cfg, ec=ec,
            positions=positions, mode=mode, cache=cache[i] if cache is not None else None,
            block_tables=block_tables, seq_lens=seq_lens, block_q=block_q, block_k=block_k,
        )
        h = h + y
        h = h + mlp_apply(lp["ffn"], rmsnorm(h, lp["norm2"], cfg.norm_eps))
        new_cache.append(nc)
    return rmsnorm(h, params["final_norm"], cfg.norm_eps), new_cache


def logits_for(params: dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """h: (B,S,D) -> logits (B,S,V_padded) in f32 (+ final softcap)."""
    B, S, d = h.shape
    parts = col_parallel(h.reshape(B * S, d), params["lm_head"], out_dtype=torch.float32)
    return softcap(torch.cat(parts, dim=-1).view(B, S, -1), cfg.final_logit_softcap)
