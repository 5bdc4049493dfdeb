"""Decoder stack: dense, MoE, SSM and hybrid (mirrors repro/models/model.py).

``forward`` takes the *bound* parameters that ``WeightStore.rebind`` makes
for one TP level: a dict with ``embed``, ``layers`` (one dict per layer,
model-sharded weights as ``ShardView``s), ``final_norm`` and, unless the
embeddings are tied, ``lm_head``. A tied head reads the embedding itself,
in place. The reference's scan over pattern periods is a Python loop over
layers; layer i runs the pattern's template i % period, which sets its
mixer (attention with its window: full, sliding, or gemma-2's alternating
local/global; or a Mamba layer, ``models.mamba``) and its FFN (dense
SwiGLU, MoE through ``models.moe``, or none). Train mode recomputes each
layer in backward and returns the MoE aux losses; ``loss_fn`` is the
reference's chunked cross-entropy over it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerTemplate, ModelConfig
from repro_torch.models.attention import attn_apply, attn_cache_defs, attn_param_defs, live_blocks
from repro_torch.models.layers import (
    col_parallel, mlp_apply, mlp_param_defs, norm_def, rmsnorm, softcap, tied_head, vocab_parallel_embed, wide,
)
from repro_torch.models.mamba import (
    mamba1_apply, mamba1_cache_defs, mamba1_param_defs, mamba2_apply, mamba2_cache_defs, mamba2_param_defs,
)
from repro_torch.models.moe import moe_apply, moe_param_defs
from repro_torch.models.params import ParamDef, stack_defs
from repro_torch.models.rounding import norm_dtype, residual_sum, train_rounding
from repro_torch.parallel.collectives import Level, gather_ranks, join_sequence, split_sequence
from repro_torch.parallel.sharding import ExecConfig, gathered


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port does not run."""
    unsupported = []
    if cfg.family not in ("dense", "vlm", "audio", "moe", "ssm", "hybrid"):
        unsupported.append(f"family {cfg.family!r}")
    # vq_image feeds token ids to the dense backbone; encodec codebook ids or frame embeddings (``embeds``)
    if cfg.frontend not in (None, "vq_image", "encodec"):
        unsupported.append(f"frontend {cfg.frontend!r}")
    if cfg.attn.kind not in ("full", "swa", "local_global"):
        unsupported.append(f"attention kind {cfg.attn.kind!r}")
    if any(not (t.mixer.startswith("attn") or t.mixer == "mamba") or t.ffn not in ("dense", "moe", "none")
           for t in cfg.layer_pattern):
        unsupported.append(f"layer pattern {cfg.layer_pattern}")
    if any(t.ffn == "moe" for t in cfg.layer_pattern) and cfg.moe is None:
        unsupported.append("moe layers without a MoESpec")
    if any(t.mixer == "mamba" for t in cfg.layer_pattern) and (cfg.mamba is None or cfg.mamba.version not in (1, 2)):
        unsupported.append("mamba layers without a MambaSpec of version 1 or 2")
    if unsupported:
        raise NotImplementedError(f"{cfg.name}: " + ", ".join(unsupported))


def _layer_window(cfg: ModelConfig, mixer: str) -> Optional[int]:
    if mixer == "attn_local" or (mixer == "attn" and cfg.attn.kind == "swa"):
        return cfg.attn.window
    return None


def layer_windows(cfg: ModelConfig) -> List[Optional[int]]:
    """The attention window of each layer, None for full attention (and for
    a Mamba layer)."""
    pattern = cfg.layer_pattern
    return [_layer_window(cfg, pattern[i % len(pattern)].mixer) for i in range(cfg.num_layers)]


def layer_templates(cfg: ModelConfig) -> List:
    """The pattern's template of each layer."""
    pattern = cfg.layer_pattern
    return [pattern[i % len(pattern)] for i in range(cfg.num_layers)]


def _mamba_defs(cfg: ModelConfig):
    """(param defs, cache defs, apply) of the config's Mamba version."""
    if cfg.mamba.version == 2:
        return mamba2_param_defs, mamba2_cache_defs, mamba2_apply
    return mamba1_param_defs, mamba1_cache_defs, mamba1_apply


def model_param_defs(cfg: ModelConfig, ec: ExecConfig) -> dict:
    check_supported(cfg)
    d = cfg.d_model
    per_period = {}
    for i, t in enumerate(cfg.layer_pattern):
        layer = {"norm1": norm_def(d)}
        layer["mixer"] = attn_param_defs(cfg, ec) if t.mixer.startswith("attn") else _mamba_defs(cfg)[0](cfg)
        if t.ffn != "none":
            layer["norm2"] = norm_def(d)
            layer["ffn"] = moe_param_defs(cfg) if t.ffn == "moe" else mlp_param_defs(d, cfg.d_ff)
        per_period[f"pos{i}"] = layer
    defs = {
        "embed": ParamDef((cfg.vocab_padded, d), ("vocab", "embed"), scale=1.0),
        "periods": stack_defs(per_period, cfg.num_periods),
        "final_norm": norm_def(d),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, cfg.vocab_padded), ("embed", "vocab"))
    return defs


def init_cache_defs(cfg: ModelConfig, ec: ExecConfig, batch: int, seq_len: int) -> List[dict]:
    """One cache def per layer: an attention layer's {"k", "v"}, min(window,
    seq_len) rows long for a windowed layer; a Mamba layer's state and conv
    tail, {"ssd", "conv"} (v2) or {"h", "conv"} (v1)."""
    check_supported(cfg)
    return [attn_cache_defs(cfg, ec, batch, seq_len, w) if t.mixer.startswith("attn")
            else _mamba_defs(cfg)[1](cfg, batch)
            for t, w in zip(layer_templates(cfg), layer_windows(cfg))]


def decoder_layer(
    h: torch.Tensor,
    lp: dict,
    t: LayerTemplate,
    window: Optional[int],
    *,
    cfg: ModelConfig,
    ec: ExecConfig,
    mode: str,
    positions: torch.Tensor,
    live: Optional[torch.Tensor] = None,
    cache: Optional[dict] = None,
    block_table: Optional[torch.Tensor] = None,
    seq_len: Optional[torch.Tensor] = None,
    block_q: int = 512,
    block_k: int = 512,
    pool: Optional[int] = None,
    moe_drops: Optional[torch.Tensor] = None,
    moe_mask: Optional[torch.Tensor] = None,
    moe_replicated: bool = False,
):
    """One layer of template ``t`` (its mixer, attention over ``window`` or
    Mamba, and its FFN) on the residual stream ``h`` (B,S,D), from its
    bound weights ``lp`` (gathered): (h, the layer's cache, its MoE aux or
    None). The arguments are ``forward``'s for this layer (``live``: its
    window's live block pairs; ``cache``, ``block_table``, ``seq_len``: its
    own). Train mode runs prefill's arithmetic at the reference's train-step
    rounding points (``rounding.train_rounding``), set here so that the
    layer's recompute in backward sets them too."""
    train = mode == "train"
    with train_rounding(train):
        hn = rmsnorm(h, lp["norm1"], cfg.norm_eps, norm_dtype(t.mixer, h.dtype))
        if t.mixer.startswith("attn"):
            y, nc = attn_apply(lp["mixer"], hn, cfg=cfg, ec=ec, positions=positions, window=window, mode=mode,
                               cache=cache, block_tables=block_table, seq_lens=seq_len, live=live, block_q=block_q,
                               block_k=block_k)
        else:  # train runs prefill's scan; its cache is dropped
            y, nc = _mamba_defs(cfg)[2](lp["mixer"], hn, cfg=cfg, mode="prefill" if train else mode, cache=cache)
        h, s = residual_sum(h, y)  # s: the sum the second norm reads (unrounded at the rounding points)
        a = None
        if t.ffn != "none":
            hn = rmsnorm(s, lp["norm2"], cfg.norm_eps, norm_dtype(t.ffn, h.dtype))
            if t.ffn == "moe":
                y, a = moe_apply(lp["ffn"], hn, cfg, pool, with_aux=train, drops=moe_drops, mask=moe_mask,
                                 replicated=moe_replicated)
            else:
                y = mlp_apply(lp["ffn"], hn)
            h = h + y
    return h, nc, a


def embed_tokens(params: dict, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """The first hidden state of ``tokens`` (B,S): their rows of the
    embedding, scaled by sqrt(d_model) where the embeddings are tied."""
    h = vocab_parallel_embed(tokens, params["embed"])
    if cfg.tie_embeddings:  # gemma convention: scale tied embeddings
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype).item()  # the factor rounded to h's dtype
    return h


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
    moe_replicated: bool = False,
    seq_parallel: Optional[Level] = None,
) -> Tuple[torch.Tensor, Union[List[dict], Dict[str, torch.Tensor]]]:
    """Returns (hidden (B,S,D) after the final norm, per-layer caches), or
    in train mode (hidden, aux).

    The input is ``tokens`` (B,S), looked up in the embedding, or ``embeds``
    (B,S,D), taken as the first hidden state (a frontend's frame embeddings).
    prefill: returns each layer's (B,S,KV,hd) K/V, or for a windowed layer
    with S > window its rotating buffer of the last window positions,
    (B,window,KV,hd).
    A Mamba layer's prefill cache is its final state and conv tail.
    decode: S = 1, positions (B,); writes each attention layer's new K/V
    into ``cache`` in place (slot position % window in a windowed layer) and
    attends through ``block_tables``/``seq_lens``, one of each per layer
    (a Mamba layer's are not read; a model without attention layers needs
    none); a Mamba layer updates its state and conv window in place.
    MoE layers run as the reference does at the bound weights' TP level in a
    pool of ``pool`` ranks (default: that TP level); ``moe_drops``, a (1,)
    int64 tensor, gains the assignments they drop of the tokens ``moe_mask``
    (B,S) holds (every token without a mask). ``moe_replicated``: across
    processes, the rows are one batch replicated over the data groups (the
    engine's prefill of one prompt), not each data group's own.
    train: prefill's arithmetic, differentiable, with no cache; each layer
    is recomputed in backward (``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint`` around its period body). ``aux`` holds the MoE
    router's load-balancing and z losses summed over the layers, {"lb",
    "z"} (0-d f32, zero without MoE layers), as the reference's aux does.
    Weights a train step's rules shard over data (``DataShard``s) are
    gathered at use: a layer's inside its recomputed function, so that the
    recompute gathers them again and the gathered copies die with the
    layer. ``seq_parallel`` (train mode across processes, the rules'
    ``seq_res -> model``): the residual stream between periods is this
    rank's S/t positions (``collectives.split_sequence``), joined whole at
    the start of each period (``join_sequence``), so each period's saved
    input is the S/t rows; the layers inside a period keep theirs whole.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be 'train', 'prefill' or 'decode', got {mode!r}")
    if (tokens is None) == (embeds is None):
        raise ValueError("forward takes exactly one of tokens and embeds")
    if seq_parallel is not None and mode != "train":
        raise ValueError("sequence parallelism is a train mode's")
    params = gathered(params)
    h = embed_tokens(params, cfg, tokens) if embeds is None else embeds
    S = h.shape[1]
    windows = layer_windows(cfg)
    templates = layer_templates(cfg)
    attn_windows = {w for t, w in zip(templates, windows) if t.mixer.startswith("attn")}
    live = {}
    if mode != "decode":  # the block pairs each window leaves live, from host positions: no sync per layer
        host_pos = torch.arange(S) if positions is None else positions.cpu()
        live = {w: live_blocks(host_pos, w, block_q, block_k) for w in attn_windows}
    elif attn_windows:
        block_tables = list(block_tables) if block_tables is not None else []
        seq_lens = list(seq_lens) if seq_lens is not None else []
        if len(block_tables) != cfg.num_layers or len(seq_lens) != cfg.num_layers:
            raise ValueError(f"decode takes one block table and one seq_lens per layer ({cfg.num_layers}), got "
                             f"{len(block_tables)} and {len(seq_lens)}")
    if positions is None:
        positions = torch.arange(S, device=h.device)
    train = mode == "train"
    period = len(cfg.layer_pattern)

    def apply_layer(h, i, lp, t, window):
        """One layer: (h, its cache, its MoE aux or None)."""
        if seq_parallel is not None and i % period == 0:  # a period's first layer: the residual stream whole
            h = join_sequence(h, seq_parallel)
        h, nc, a = decoder_layer(
            h, gathered(lp), t, window, cfg=cfg, ec=ec, mode=mode, positions=positions, live=live.get(window),
            cache=cache[i] if cache is not None else None,
            block_table=block_tables[i] if mode == "decode" and t.mixer.startswith("attn") else None,
            seq_len=seq_lens[i] if mode == "decode" and t.mixer.startswith("attn") else None,
            block_q=block_q, block_k=block_k, pool=pool,
            moe_drops=moe_drops, moe_mask=moe_mask, moe_replicated=moe_replicated,
        )
        if seq_parallel is not None and i % period == period - 1:  # a period boundary: this rank's positions
            h = split_sequence(h, seq_parallel)
        return h, (None if train else nc), a

    new_cache = []
    aux = {"lb": torch.zeros((), dtype=torch.float32, device=h.device),
           "z": torch.zeros((), dtype=torch.float32, device=h.device)}
    if seq_parallel is not None:
        h = split_sequence(h, seq_parallel)
    for i, (lp, t, window) in enumerate(zip(params["layers"], templates, windows)):
        if train:  # recomputed in backward: only the layer boundaries are kept
            h, _, a = checkpoint(apply_layer, h, i, lp, t, window, use_reentrant=False, preserve_rng_state=False)
            if a is not None:
                aux = {k: aux[k] + a[k] for k in aux}
        else:
            h, nc, _ = apply_layer(h, i, lp, t, window)
            new_cache.append(nc)
    if seq_parallel is not None:
        h = join_sequence(h, seq_parallel)
    return rmsnorm(h, params["final_norm"], cfg.norm_eps), (aux if train else new_cache)


def _head(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x (M, D) -> logits (M, V_padded) in f32 (``wide``: f64 for f64 x;
    + final softcap). A tied
    head is the embedding read transposed: rank r's logits are
    x @ embed[r's vocab rows].T. The ranks' vocab shards are joined in rank
    order; across processes they are gathered over the model group, so
    every rank holds the same logits and takes the same argmax."""
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    if cfg.tie_embeddings:
        parts = tied_head(x, w)
    else:
        parts = col_parallel(x, w, out_dtype=wide(x.dtype))
    return softcap(gather_ranks(parts, w.level, -1), cfg.final_logit_softcap)


def logits_for(params: dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """h: (B,S,D) -> logits (B,S,V_padded) in f32 (+ final softcap)."""
    B, S, d = h.shape
    return _head(params, cfg, h.reshape(B * S, d)).view(B, S, -1)


def loss_fn(
    params: dict,
    cfg: ModelConfig,
    ec: ExecConfig,
    batch: Dict[str, torch.Tensor],
    *,
    seq_chunk: int = 512,
    block_q: int = 512,
    block_k: int = 512,
    pool: Optional[int] = None,
    seq_parallel: Optional[Level] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Chunked cross-entropy train loss (mirrors repro/models/model.py::loss_fn).

    ``batch``: "tokens" (B,S) (or "embeds" (B,S,D)), "targets" (B,S) and an
    optional f32 "mask" (B,S). The head's logits are made ``seq_chunk``
    positions of every sequence at a time, so the full (B,S,V) logits are
    never held; an MoE model adds the router's aux terms over the number of
    periods. Returns (loss, {"ce", "lb", "z"}). The embedding, the final
    norm and the head, where the rules shard them over data, are gathered
    once for the whole loss; ``seq_parallel`` goes to ``forward``.
    """
    embeds = batch.get("embeds")
    if embeds is not None and not cfg.tie_embeddings:  # the table is not read
        params = {k: v for k, v in params.items() if k != "embed"}
    params = gathered(params)
    targets = batch["targets"]
    B, S = targets.shape
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=targets.device)
    h, aux = forward(params, cfg, ec, tokens=None if embeds is not None else batch["tokens"], embeds=embeds,
                     mode="train", block_q=block_q, block_k=block_k, pool=pool, seq_parallel=seq_parallel)
    ck = min(seq_chunk, S)
    if S % ck:
        raise ValueError(f"seq_chunk {ck} does not divide the sequence length {S}")
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(S // ck):
        cols = slice(c * ck, (c + 1) * ck)
        logits = _head(params, cfg, h[:, cols].reshape(B * ck, -1))
        lse = torch.logsumexp(logits, -1)
        tgt = logits.gather(-1, targets[:, cols].reshape(-1, 1).long())[:, 0]
        tot = tot + ((lse - tgt) * mask[:, cols].reshape(-1)).sum()
    ce = tot / mask.sum().clamp_min(1.0)
    loss = ce
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux["lb"] / cfg.num_periods
        loss = loss + cfg.moe.router_z_weight * aux["z"] / cfg.num_periods
    return loss, {"ce": ce, **aux}
