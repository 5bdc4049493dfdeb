"""Quickstart: build a model, run prefill and one decode step, train a few
steps (mirrors examples/quickstart.py).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Reduced gemma2-2b (alternating local and global attention, tied
embeddings) at TP 1, on the card unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.weight_store import WeightStore
from repro_torch.device import resolve_device
from repro_torch.models import count_params, forward, init_params, logits_for, model_param_defs
from repro_torch.parallel.sharding import make_exec_config
from repro_torch.serving.kv_cache import SlotCache
from repro_torch.training.data import SyntheticDataset
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import TrainStepConfig, init_opt_state, make_train_step


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = reduced(get_config("gemma2-2b"))
    ec = make_exec_config(cfg, tp=1)
    defs = model_param_defs(cfg, ec)
    params = init_params(defs, torch.Generator(device=dev).manual_seed(0), torch.float32)
    print(f"model: {cfg.name} ({count_params(defs)/1e6:.2f} M params, "
          f"pattern={[t.mixer for t in cfg.layer_pattern]}) on {dev}")
    store = WeightStore(cfg, defs, [dev])
    bound = store.rebind(store.build(params), 1)

    B, S = 2, 32
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev)
    with torch.no_grad():
        # prefill, its K/V into a slot cache 8 rows deeper, then one decode step
        h, kv = forward(bound, cfg, ec, tokens=tokens, mode="prefill", block_q=16, block_k=16)
        logits = logits_for(bound, cfg, h[:, -1:].contiguous())
        nxt = logits[:, 0, : cfg.vocab_size].argmax(-1)
        print("prefill ok; first sampled tokens:", nxt.tolist())
        slots = SlotCache.create(cfg, ec, B, S + 8, torch.float32, dev)
        for layer, c in zip(slots.layers, kv):
            for name in ("k", "v"):
                layer[name][:, : c[name].shape[1]] = c[name]
        positions = torch.full((B,), S, dtype=torch.int64, device=dev)
        tables, lens = slots.page_tables(positions)
        h, _ = forward(bound, cfg, ec, tokens=nxt[:, None], positions=positions, cache=slots.layers,
                       block_tables=tables, seq_lens=lens, mode="decode")
    print("decode ok; hidden:", tuple(h.shape))

    # a few train steps
    tcfg = TrainStepConfig(opt=AdamWConfig(lr=3e-3, warmup_steps=5), seq_chunk=16, block_q=16, block_k=16)
    step_fn, _ = make_train_step(cfg, ec, params, tcfg)
    opt = init_opt_state(params, tcfg)
    ds = SyntheticDataset(cfg, batch=4, seq=32)
    for i in range(10):
        params, opt, m = step_fn(params, opt, ds.at(i))
        if i % 3 == 0:
            print(f"train step {i}: loss {float(m['loss']):.4f}")
    print("quickstart done")


if __name__ == "__main__":
    main()
