"""Serving engine with runtime-adaptive TP (mirrors repro/serving/engine.py).

Continuous batching over a dense slot cache, prefill in padded buckets,
greedy decode, and a TP switch that rebinds the weights without moving
them and migrates the KV cache. Greedy decoding keeps trajectories
deterministic, so a mid-stream switch must leave them unchanged.

The TP group's ranks are a list of devices, ``[device] * max(candidate_tps)``:
on one card all ranks are that card, and the reference's psum is a sum of
the ranks' partial products in rank order. Every projection runs once per
rank through the ``tp_shard_matmul`` kernel; decode attention runs through
the ``paged_decode_attention`` kernel. The ranks are the reference's pool
of N devices: at TP t its mesh is (data = N/t, model = t), and an MoE layer
picks its dispatch path and capacity from t and N as the reference does
(``models.moe``), so its drops depend on the TP level as the reference's
do; ``moe_dropped`` reads the dropped assignments per (TP level, stage).

As the reference compiles one executable per TP level for decode and one
per (TP level, bucket) for prefill and warms them all up front, ``warmup``
captures one CUDA graph per (TP level, stage, bucket) into the
controller's ``ExecutableCache``; ``step`` and ``admit`` only copy their
inputs in and replay (on a CUDA device there is no eager path). The step
functions ``_decode`` and ``_prefill`` are what is captured; on the CPU the
cache calls them directly.
"""
from __future__ import annotations

import functools
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
        if cfg.moe is not None and cfg.moe.num_experts < max(self.tps):
            raise ValueError(f"{cfg.name}: {cfg.moe.num_experts} experts cannot shard over TP {max(self.tps)}")
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
        # (TP level, "prefill" | "decode") -> dropped MoE assignments, counted on the device
        self._drops = {(tp, stage): torch.zeros((1,), dtype=torch.int64, device=self.device)
                       for tp in self.tps for stage in ("prefill", "decode")} if cfg.moe is not None else {}

    @property
    def tp(self) -> int:
        return self.ctl.current_tp

    @property
    def storage(self) -> dict:
        return self.ctl.storage

    @property
    def cache(self):
        """The executables per (TP level, key): "decode", or a prefill bucket."""
        return self.ctl.cache

    # ------------------------------------------------------------------
    def _prefill(self, params: dict, tokens: torch.Tensor, last: torch.Tensor, slot: torch.Tensor,
                 drops: Optional[torch.Tensor] = None):
        """Prefill one prompt padded to its bucket and insert its K/V into a
        slot's first rows (L of them, or a windowed layer's rotating buffer
        when L > window), and each Mamba layer's final state and conv tail
        into the slot's row: the whole padded bucket's, as the reference
        inserts them (padding included). tokens (1, L); last (1,) the prompt's last
        position; slot (1,): index tensors, so that one captured graph
        serves every prompt length and slot of the bucket. ``drops`` gains
        the MoE assignments dropped of the prompt's tokens (not the
        padding's). Returns the next token (1,) and the logits (1, vocab)."""
        mask = None if drops is None else torch.arange(tokens.shape[1], device=tokens.device)[None] <= last[:, None]
        h, kv = forward(params, self.cfg, self.ec, tokens=tokens, mode="prefill", block_q=64, block_k=64,
                        pool=len(self.ranks), moe_drops=drops, moe_mask=mask)
        logits = logits_for(params, self.cfg, h.index_select(1, last))[:, 0, : self.cfg.vocab_size]
        for layer, c in zip(self.slots.layers, kv):
            if "k" not in c:  # a Mamba layer: the slot's state and conv tail
                for name, t in c.items():
                    layer[name][slot] = t.to(layer[name].dtype)
                continue
            n = c["k"].shape[1]
            for name in ("k", "v"):
                layer[name][slot, :n] = c[name][0].to(layer[name].dtype)
        return logits.argmax(-1), logits

    def _decode(self, params: dict, tokens: torch.Tensor, positions: torch.Tensor,
                drops: Optional[torch.Tensor] = None):
        """One decode step of every slot: tokens (n_slots, 1), positions
        (n_slots,); the block tables are fixed and seq_lens come from the
        positions on the device; Mamba layers update their slots' states in
        place. ``drops`` gains the MoE assignments
        dropped, idle slots' included (the reference dispatches them too)."""
        tables, lens = self.slots.page_tables(positions)
        h, _ = forward(params, self.cfg, self.ec, tokens=tokens, positions=positions,
                       cache=self.slots.layers, block_tables=tables, seq_lens=lens, mode="decode",
                       pool=len(self.ranks), moe_drops=drops)
        logits = logits_for(params, self.cfg, h)[:, 0, : self.cfg.vocab_size]
        return logits.argmax(-1), logits

    def warmup(self) -> float:
        """Make the executables: the decode step at every candidate TP level
        and prefill at every (TP level, bucket), one CUDA graph each on a
        CUDA device (each run once on the capture stream first), the
        counterpart of the reference's AOT warm-up. Raises if a capture
        fails. Returns the seconds taken; ``cache.capture_s`` has each.

        The warm-up runs write slot 0's rows and row 0 of every slot, so it
        is refused while a request holds a slot."""
        if any(r is not None for r in self.slot_req):
            raise RuntimeError("warmup() writes the KV cache: call it before admitting requests")
        t0 = time.perf_counter()
        n, dev = self.econf.n_slots, self.device
        for tp in self.tps:
            params = self.ctl.bindings[tp]
            decode = functools.partial(self._decode, params, drops=self._drops.get((tp, "decode")))
            prefill = functools.partial(self._prefill, params, drops=self._drops.get((tp, "prefill")))
            self.cache.put(tp, "decode", decode,
                           (torch.zeros((n, 1), dtype=torch.int64, device=dev),
                            torch.zeros((n,), dtype=torch.int64, device=dev)))
            for L in self.econf.prefill_buckets:
                self.cache.put(tp, L, prefill,
                               (torch.zeros((1, L), dtype=torch.int64, device=dev),
                                torch.zeros((1,), dtype=torch.int64, device=dev),
                                torch.zeros((1,), dtype=torch.int64, device=dev)))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        for count in self._drops.values():  # the warm-up runs on the card counted theirs
            count.zero_()
        dt = time.perf_counter() - t0
        self.stats.warmup_s += dt
        return dt

    def moe_dropped(self) -> Dict[tuple, int]:
        """MoE assignments dropped so far over capacity, per (TP level,
        "prefill" | "decode"); empty for a dense model."""
        return {key: int(n.item()) for key, n in self._drops.items()}

    def _executable(self, key):
        if not self.cache.has(self.tp, key):
            self.warmup()
        return self.cache.get(self.tp, key)

    def switch_tp(self, tp: int) -> dict:
        """Stop-and-migrate TP switch (paper §3.2): zero-copy weight rebind,
        then the KV cache to the new layout (on one card: no bytes move),
        then the new TP level's executables replay. A failed migration rolls
        back (``SwitchAborted``); so does one that hands back new storage
        while graphs exist, since they read the cache at its addresses."""
        if tp == self.tp:
            return {"rebind_s": 0.0, "migrate_s": 0.0}

        def migrate(_tp):
            moved, seconds = migrate_cache(self.slots.layers, self.device)
            if self.cache.graphs() and any(a[k].data_ptr() != b[k].data_ptr()
                                           for a, b in zip(self.slots.layers, moved) for k in a):
                raise RuntimeError("cache migration moved the KV cache while CUDA graphs read it in place")
            return moved, seconds

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
        L = self._bucket(req.prompt_len)
        prefill = self._executable(L)
        slot = self.slots.alloc()
        if slot is None:
            return False
        if req.arrival_s == 0.0:  # demo requests: arrival = admission
            req.arrival_s = time.perf_counter()
        tokens = torch.zeros((1, L), dtype=torch.int64)
        tokens[0, : req.prompt_len] = torch.from_numpy(np.asarray(req.prompt, np.int64))
        nxt, logits = prefill(tokens, torch.tensor([req.prompt_len - 1]), torch.tensor([slot]))
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
        tokens = torch.from_numpy(self.next_tokens).view(-1, 1)
        positions = torch.from_numpy(self.slots.lengths)
        nxt, logits = self._executable("decode")(tokens, positions)
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
