"""Serving engine with runtime-adaptive TP (mirrors repro/serving/engine.py).

Continuous batching over a dense slot cache, prefill in padded buckets,
greedy decode, and a TP switch that rebinds the weights without moving
them and migrates the KV cache. Greedy decoding keeps trajectories
deterministic, so a mid-stream switch must leave them unchanged.

The TP group's ranks are a list of devices, ``[device] * max(candidate_tps)``:
on one card all ranks are that card, and the reference's psum is a sum of
the ranks' partial products in rank order. Every projection runs once per
rank through the ``tp_shard_matmul`` kernel; decode attention runs through
the ``paged_decode_attention`` kernel.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.migration import migrate_cache
from repro_torch.core.tp_switch import TPSwitchController
from repro_torch.core.weight_store import WeightStore
from repro_torch.device import resolve_device
from repro_torch.models.model import forward, logits_for, model_param_defs
from repro_torch.parallel.sharding import make_exec_config
from repro_torch.serving.kv_cache import SlotCache
from repro_torch.serving.request import Request, RequestState


@dataclass
class EngineConfig:
    candidate_tps: Sequence[int] = (1, 2, 4, 8)
    n_slots: int = 16
    max_len: int = 256
    prefill_buckets: Sequence[int] = (32, 64, 128)
    dtype: torch.dtype = torch.float32  # KV cache dtype
    record_logits: bool = False


@dataclass
class StepStats:
    steps: int = 0
    switches: int = 0
    rebind_s: float = 0.0
    migrate_s: float = 0.0
    warmup_s: float = 0.0


class ServingEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        canonical_params: dict,
        econf: EngineConfig = EngineConfig(),
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.cfg = cfg
        self.econf = econf
        self.device = resolve_device(device)
        self.tps = list(econf.candidate_tps)
        if cfg.num_kv_heads < max(self.tps):
            raise ValueError("the engine keeps kv_exec constant across TP levels; use a config "
                             "with num_kv_heads >= the largest candidate TP")
        self.ranks = [self.device] * max(self.tps)
        defs = model_param_defs(cfg, make_exec_config(cfg, 1))
        self.store = WeightStore(cfg, defs, self.ranks, storage_tp=1)
        self.ctl = TPSwitchController(self.store, self.tps)
        self.ctl.install(canonical_params, self.tps[0])
        self.ec = make_exec_config(cfg, max(self.tps))  # cache layout fixed at max-TP kv_exec
        self.slots = SlotCache.create(cfg, self.ec, econf.n_slots, econf.max_len, econf.dtype, self.device)
        self.slot_req: List[Optional[Request]] = [None] * econf.n_slots
        self.next_tokens = np.zeros(econf.n_slots, np.int64)
        self.stats = StepStats()
        self.logit_trace: Dict[int, list] = {}  # req_id -> per-step logits (record_logits)

    @property
    def tp(self) -> int:
        return self.ctl.current_tp

    @property
    def storage(self) -> dict:
        return self.ctl.storage

    # ------------------------------------------------------------------
    def _prefill(self, params: dict, tokens: torch.Tensor, true_len: int):
        h, kv = forward(params, self.cfg, self.ec, tokens=tokens, mode="prefill", block_q=64, block_k=64)
        logits = logits_for(params, self.cfg, h[:, true_len - 1:true_len])[:, 0, : self.cfg.vocab_size]
        return logits.argmax(-1), logits, kv

    def _decode(self, params: dict, tokens: torch.Tensor, positions: torch.Tensor):
        tables, lens = self.slots.page_tables(positions)
        h, _ = forward(params, self.cfg, self.ec, tokens=tokens, positions=positions,
                       cache=self.slots.layers, block_tables=tables, seq_lens=lens, mode="decode")
        logits = logits_for(params, self.cfg, h)[:, 0, : self.cfg.vocab_size]
        return logits.argmax(-1), logits

    def warmup(self) -> float:
        """Run one decode step and one prefill per (TP level, bucket), the
        counterpart of the reference's AOT warm-up: it builds the kernels
        and warms the allocator. Returns the seconds taken."""
        t0 = time.perf_counter()
        n = self.econf.n_slots
        tok = torch.zeros((n, 1), dtype=torch.int64, device=self.device)
        pos = torch.zeros((n,), dtype=torch.int64, device=self.device)
        for tp in self.tps:
            params = self.ctl.bindings[tp]
            self._decode(params, tok, pos)
            for L in self.econf.prefill_buckets:
                self._prefill(params, torch.zeros((1, L), dtype=torch.int64, device=self.device), 1)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        self.stats.warmup_s += dt
        return dt

    def switch_tp(self, tp: int) -> dict:
        """Stop-and-migrate TP switch (paper §3.2): zero-copy weight rebind,
        then the KV cache to the new layout (on one card: no bytes move).
        A failed migration rolls back (``SwitchAborted``)."""
        if tp == self.tp:
            return {"rebind_s": 0.0, "migrate_s": 0.0}

        def migrate(_tp):
            return migrate_cache(self.slots.layers, self.device)

        self.slots.layers = self.ctl.switch(tp, migrate_fn=migrate)
        st = self.ctl.stats
        self.stats.switches += 1
        self.stats.rebind_s += st.last_rebind_s
        self.stats.migrate_s += st.last_migrate_s
        return {"rebind_s": st.last_rebind_s, "migrate_s": st.last_migrate_s}

    # ------------------------------------------------------------------
    def _bucket(self, n: int) -> int:
        for b in self.econf.prefill_buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds buckets")

    def admit(self, req: Request) -> bool:
        slot = self.slots.alloc()
        if slot is None:
            return False
        if req.arrival_s == 0.0:  # demo requests: arrival = admission
            req.arrival_s = time.perf_counter()
        L = self._bucket(req.prompt_len)
        tokens = torch.zeros((1, L), dtype=torch.int64)
        tokens[0, : req.prompt_len] = torch.from_numpy(np.asarray(req.prompt, np.int64))
        nxt, logits, kv = self._prefill(self.ctl.params, tokens.to(self.device), req.prompt_len)
        # insert in place: the slot's first rows take the prompt's K/V, L of
        # them, or a windowed layer's rotating buffer when L > window
        for layer, c in zip(self.slots.layers, kv):
            n = c["k"].shape[1]
            layer["k"][slot, :n] = c["k"][0]
            layer["v"][slot, :n] = c["v"][0]
        tok = int(nxt[0])
        req.slot = slot
        req.state = RequestState.DECODE
        req.generated.append(tok)
        req.first_token_s = time.perf_counter()
        self.slot_req[slot] = req
        self.slots.lengths[slot] = req.prompt_len
        self.next_tokens[slot] = tok
        if self.econf.record_logits:
            self.logit_trace.setdefault(req.req_id, []).append(logits[0].cpu().numpy())
        return True

    def step(self) -> List[Request]:
        """One decode iteration over all slots; returns the finished requests."""
        tokens = torch.from_numpy(self.next_tokens).to(self.device).view(-1, 1)
        positions = torch.from_numpy(self.slots.lengths).to(self.device)
        nxt, logits = self._decode(self.ctl.params, tokens, positions)
        nxt = nxt.cpu().numpy()
        if self.econf.record_logits:
            logits = logits.cpu().numpy()
        self.stats.steps += 1
        finished = []
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            self.slots.lengths[slot] += 1
            tok = int(nxt[slot])
            req.generated.append(tok)
            self.next_tokens[slot] = tok
            if self.econf.record_logits:
                self.logit_trace[req.req_id].append(logits[slot])
            if req.done or self.slots.lengths[slot] + 1 >= self.econf.max_len:
                req.state = RequestState.DONE
                req.finish_s = time.perf_counter()
                finished.append(req)
                self.slot_req[slot] = None
                self.slots.release(slot)
        return finished

    def run(
        self,
        requests: List[Request],
        switch_schedule: Optional[Dict[int, int]] = None,
        max_steps: int = 10_000,
    ) -> List[Request]:
        """Serve ``requests`` to completion; optionally switch TP at given
        step numbers ({step: tp})."""
        switch_schedule = switch_schedule or {}
        pending = list(requests)
        done: List[Request] = []
        step_no = 0
        while (pending or any(r is not None for r in self.slot_req)) and step_no < max_steps:
            if step_no in switch_schedule:
                self.switch_tp(switch_schedule[step_no])
            while pending and self.slots.free:
                self.admit(pending.pop(0))
            done.extend(self.step())
            step_no += 1
        return done
