"""Decoder stack for the dense and MoE families (mirrors repro/models/model.py).

``forward`` takes the *bound* parameters that ``WeightStore.rebind`` makes
for one TP level: a dict with ``embed``, ``layers`` (one dict per layer,
model-sharded weights as ``ShardView``s), ``final_norm`` and, unless the
embeddings are tied, ``lm_head``. A tied head reads the embedding itself,
in place. The reference's scan over pattern periods is a Python loop over
layers; layer i runs the pattern's template i % period, which sets its
attention window (full, sliding, or gemma-2's alternating local/global) and
its FFN (dense SwiGLU, or MoE through ``models.moe``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import attn_apply, attn_cache_defs, attn_param_defs, live_blocks
from repro_torch.models.layers import (
    col_parallel, mlp_apply, mlp_param_defs, norm_def, rmsnorm, softcap, tied_head, vocab_parallel_embed,
)
from repro_torch.models.moe import moe_apply, moe_param_defs
from repro_torch.models.params import ParamDef, stack_defs
from repro_torch.parallel.sharding import ExecConfig


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port does not run yet."""
    unsupported = []
    if cfg.family not in ("dense", "vlm", "audio", "moe"):
        unsupported.append(f"family {cfg.family!r}")
    # vq_image feeds token ids to the dense backbone; encodec codebook ids or frame embeddings (``embeds``)
    if cfg.frontend not in (None, "vq_image", "encodec"):
        unsupported.append(f"frontend {cfg.frontend!r}")
    if cfg.attn.kind not in ("full", "swa", "local_global"):
        unsupported.append(f"attention kind {cfg.attn.kind!r}")
    if any(not t.mixer.startswith("attn") or t.ffn not in ("dense", "moe") for t in cfg.layer_pattern):
        unsupported.append(f"layer pattern {cfg.layer_pattern}")
    if any(t.ffn == "moe" for t in cfg.layer_pattern) and cfg.moe is None:
        unsupported.append("moe layers without a MoESpec")
    if unsupported:
        raise NotImplementedError(f"{cfg.name}: " + ", ".join(unsupported))


def _layer_window(cfg: ModelConfig, mixer: str) -> Optional[int]:
    if mixer == "attn_local" or (mixer == "attn" and cfg.attn.kind == "swa"):
        return cfg.attn.window
    return None


def layer_windows(cfg: ModelConfig) -> List[Optional[int]]:
    """The attention window of each layer, None for full attention."""
    pattern = cfg.layer_pattern
    return [_layer_window(cfg, pattern[i % len(pattern)].mixer) for i in range(cfg.num_layers)]


def model_param_defs(cfg: ModelConfig, ec: ExecConfig) -> dict:
    check_supported(cfg)
    d = cfg.d_model
    per_period = {
        f"pos{i}": {
            "norm1": norm_def(d),
            "mixer": attn_param_defs(cfg, ec),
            "norm2": norm_def(d),
            "ffn": moe_param_defs(cfg) if t.ffn == "moe" else mlp_param_defs(d, cfg.d_ff),
        }
        for i, t in enumerate(cfg.layer_pattern)
    }
    defs = {
        "embed": ParamDef((cfg.vocab_padded, d), ("vocab", "embed"), scale=1.0),
        "periods": stack_defs(per_period, cfg.num_periods),
        "final_norm": norm_def(d),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, cfg.vocab_padded), ("embed", "vocab"))
    return defs


def init_cache_defs(cfg: ModelConfig, ec: ExecConfig, batch: int, seq_len: int) -> List[dict]:
    """One {"k", "v"} cache def per layer, min(window, seq_len) rows long
    for a windowed layer."""
    check_supported(cfg)
    return [attn_cache_defs(cfg, ec, batch, seq_len, w) for w in layer_windows(cfg)]


def forward(
    params: dict,
    cfg: ModelConfig,
    ec: ExecConfig,
    *,
    tokens: Optional[torch.Tensor] = None,
    embeds: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[List[dict]] = None,
    block_tables: Optional[Sequence[torch.Tensor]] = None,
    seq_lens: Optional[Sequence[torch.Tensor]] = None,
    mode: str = "prefill",
    block_q: int = 512,
    block_k: int = 512,
    pool: Optional[int] = None,
    moe_drops: Optional[torch.Tensor] = None,
    moe_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, List[dict]]:
    """Returns (hidden (B,S,D) after the final norm, per-layer caches).

    The input is ``tokens`` (B,S), looked up in the embedding, or ``embeds``
    (B,S,D), taken as the first hidden state (a frontend's frame embeddings).
    prefill: returns each layer's (B,S,KV,hd) K/V, or for a windowed layer
    with S > window its rotating buffer of the last window positions,
    (B,window,KV,hd).
    decode: S = 1, positions (B,); writes each layer's new K/V into
    ``cache`` in place (slot position % window in a windowed layer) and
    attends through ``block_tables``/``seq_lens``, one of each per layer.
    MoE layers run as the reference does at the bound weights' TP level in a
    pool of ``pool`` ranks (default: that TP level); ``moe_drops``, a (1,)
    int64 tensor, gains the assignments they drop of the tokens ``moe_mask``
    (B,S) holds (every token without a mask).
    """
    if mode not in ("prefill", "decode"):
        raise ValueError(f"mode must be 'prefill' or 'decode', got {mode!r}")
    if (tokens is None) == (embeds is None):
        raise ValueError("forward takes exactly one of tokens and embeds")
    if embeds is None:
        h = vocab_parallel_embed(tokens, params["embed"])
        if cfg.tie_embeddings:  # gemma convention: scale tied embeddings
            h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype).item()  # the factor rounded to h's dtype
    else:
        h = embeds
    S = h.shape[1]
    windows = layer_windows(cfg)
    live = {}
    if mode == "prefill":  # the block pairs each window leaves live, from host positions: no sync per layer
        host_pos = torch.arange(S) if positions is None else positions.cpu()
        live = {w: live_blocks(host_pos, w, block_q, block_k) for w in set(windows)}
    else:
        block_tables, seq_lens = list(block_tables), list(seq_lens)
        if len(block_tables) != cfg.num_layers or len(seq_lens) != cfg.num_layers:
            raise ValueError(f"decode takes one block table and one seq_lens per layer ({cfg.num_layers}), got "
                             f"{len(block_tables)} and {len(seq_lens)}")
    if positions is None:
        positions = torch.arange(S, device=h.device)
    pattern = cfg.layer_pattern
    new_cache = []
    for i, (lp, window) in enumerate(zip(params["layers"], windows)):
        y, nc = attn_apply(
            lp["mixer"], rmsnorm(h, lp["norm1"], cfg.norm_eps), cfg=cfg, ec=ec,
            positions=positions, window=window, mode=mode, cache=cache[i] if cache is not None else None,
            block_tables=block_tables[i] if mode == "decode" else None,
            seq_lens=seq_lens[i] if mode == "decode" else None,
            live=live.get(window), block_q=block_q, block_k=block_k,
        )
        h = h + y
        hn = rmsnorm(h, lp["norm2"], cfg.norm_eps)
        if pattern[i % len(pattern)].ffn == "moe":
            y, _ = moe_apply(lp["ffn"], hn, cfg, pool, with_aux=False, drops=moe_drops, mask=moe_mask)
        else:
            y = mlp_apply(lp["ffn"], hn)
        h = h + y
        new_cache.append(nc)
    return rmsnorm(h, params["final_norm"], cfg.norm_eps), new_cache


def logits_for(params: dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """h: (B,S,D) -> logits (B,S,V_padded) in f32 (+ final softcap). A tied
    head is the embedding read transposed: rank r's logits are
    h @ embed[r's vocab rows].T."""
    B, S, d = h.shape
    x = h.reshape(B * S, d)
    if cfg.tie_embeddings:
        parts = tied_head(x, params["embed"])
    else:
        parts = col_parallel(x, params["lm_head"], out_dtype=torch.float32)
    return softcap(torch.cat(parts, dim=-1).view(B, S, -1), cfg.final_logit_softcap)
