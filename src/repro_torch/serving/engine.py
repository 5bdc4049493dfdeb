"""Serving engine with runtime-adaptive TP (mirrors repro/serving/engine.py).

Continuous batching over a dense slot cache, prefill in padded buckets,
greedy decode, and a TP switch that rebinds the weights without moving
them and migrates the KV cache. Greedy decoding keeps trajectories
deterministic, so a mid-stream switch must leave them unchanged.

In one process (the default) the TP group's ranks are a list of devices,
``[device] * max(candidate_tps)``: on one card all ranks are that card, and
the reference's psum is a sum of the ranks' partial products in rank order.
Every projection runs once per rank through the ``tp_shard_matmul`` kernel;
decode attention runs through the ``paged_decode_attention`` kernel. The
ranks are the reference's pool of N devices: at TP t its mesh is (data =
N/t, model = t), and an MoE layer picks its dispatch path and capacity from
t and N as the reference does (``models.moe``), so its drops depend on the
TP level as the reference's do; ``moe_dropped`` reads the dropped
assignments per (TP level, stage).

Across processes (``pool``, a ``collectives.Pool`` of N processes, one card
each) the same engine runs on every rank (SPMD). The host logic (admission,
slots, lengths, the switch schedule) is replicated and deterministic. Each
rank holds its pool position's weights and, at TP t, its block of the slot
cache: its data group's n_slots/(N/t) slots x its model group's KV heads,
in buffers of its own per TP level, allocated once, which a switch
reshards into (``migrate_cache``) and graphs read in place. Each data group
decodes its own slots; the next tokens are gathered over the data groups,
so every rank's request state stays identical. Prefill runs the prompt on
every data group, as the reference's prefill of one sequence does; the
group that owns the slot inserts its K/V, and its token is the one every
rank takes. An MoE layer is told that the prompt's rows are one sequence
replicated over the data groups, so each (TP level, stage) takes the
reference's path and capacity (``models.moe``); a Mamba layer holds its
model group's d_inner/t channels of the slot's state and conv tail, which
the owner's masked write inserts as it does K/V. ``moe_dropped`` adds the
ranks' counts, each dispatch counted once.

As the reference compiles one executable per TP level for decode and one
per (TP level, bucket) for prefill and warms them all up front, ``warmup``
captures one CUDA graph per (TP level, stage, bucket) into the
controller's ``ExecutableCache``; ``step`` and ``admit`` only copy their
inputs in and replay (on a CUDA device there is no eager path). The step
functions ``_decode`` and ``_prefill`` are what is captured; on the CPU the
cache calls them directly. The executables hold the engine weakly, so an
engine and its graphs go when the last reference to the engine goes, with
no garbage collection (a graph that captured NCCL collectives must be gone
before the pool's communicators are).
"""
from __future__ import annotations

import time
import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.migration import cache_shardings, migrate_cache
from repro_torch.core.tp_switch import TPSwitchController
from repro_torch.core.weight_store import WeightStore
from repro_torch.device import resolve_device
from repro_torch.models.model import forward, logits_for, model_param_defs
from repro_torch.parallel.collectives import Pool, all_gather, all_reduce, check_replicated
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


def _weak(method, *args, **kw):
    """``functools.partial(method, *args, **kw)`` holding the method's
    object weakly: the executables it goes into belong to that object, and
    a strong reference back would keep the engine and its CUDA graphs alive
    in a reference cycle until a garbage collection."""
    ref = weakref.WeakMethod(method)

    def call(*a):
        return ref()(*args, *a, **kw)

    return call


class ServingEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        canonical_params: dict,
        econf: EngineConfig = EngineConfig(),
        device: Optional[Union[str, torch.device]] = None,
        pool: Optional[Pool] = None,
    ):
        self.cfg = cfg
        self.econf = econf
        self.pool = pool
        self.device = resolve_device(device) if pool is None else pool.device
        # the reference keeps the TP levels its pool of devices can run
        self.tps = list(econf.candidate_tps) if pool is None else [t for t in econf.candidate_tps if pool.world % t == 0]
        if cfg.num_kv_heads < max(self.tps):
            raise ValueError("the engine keeps kv_exec constant across TP levels; use a config "
                             "with num_kv_heads >= the largest candidate TP")
        if cfg.moe is not None and cfg.moe.num_experts < max(self.tps):
            raise ValueError(f"{cfg.name}: {cfg.moe.num_experts} experts cannot shard over TP {max(self.tps)}")
        if pool is None:
            self.ranks = [self.device] * max(self.tps)
        else:
            if econf.n_slots % pool.world:
                raise ValueError(f"{econf.n_slots} slots do not split over {pool.world} data groups")
            check_replicated(canonical_params, pool)
            self.ranks = list(pool.devices)
        defs = model_param_defs(cfg, make_exec_config(cfg, 1))
        self.store = WeightStore(cfg, defs, self.ranks, storage_tp=1, pool=pool)
        self.ctl = TPSwitchController(self.store, self.tps)
        if pool is not None:
            self.cache.capture_error_mode = "thread_local"
        self.ctl.install(canonical_params, self.tps[0])
        self.ec = make_exec_config(cfg, max(self.tps))  # cache layout fixed at max-TP kv_exec
        self.slots = SlotCache.create(cfg, self.ec, econf.n_slots, econf.max_len, econf.dtype, self.device,
                                      level=None if pool is None else pool.level(self.tps[0]))
        self.level_slots = {self.tps[0]: self.slots}  # across processes: each TP level's cache buffers
        if pool is not None:
            for tp in self.tps[1:]:
                c = SlotCache.create(cfg, self.ec, econf.n_slots, econf.max_len, econf.dtype, self.device,
                                     level=pool.level(tp))
                c.lengths, c.free = self.slots.lengths, self.slots.free  # one host bookkeeping for all levels
                self.level_slots[tp] = c
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
                 drops: Optional[torch.Tensor] = None, slots: Optional[SlotCache] = None):
        """Prefill one prompt padded to its bucket and insert its K/V into a
        slot's first rows (L of them, or a windowed layer's rotating buffer
        when L > window), and each Mamba layer's final state and conv tail
        into the slot's row: the whole padded bucket's, as the reference
        inserts them (padding included). tokens (1, L); last (1,) the prompt's last
        position; slot (1,): index tensors, so that one captured graph
        serves every prompt length and slot of the bucket. ``drops`` gains
        the MoE assignments dropped of the prompt's tokens (not the
        padding's). Returns the next token (1,) and the logits (1, vocab).

        Across processes every data group runs the prompt; only the group
        that owns the slot writes its rows (a masked write, the same graph
        on every rank), and the token and logits are the owner's, gathered
        over the data groups. ``slots``: the cache written (default: the
        current one; across processes each TP level's graphs get their
        level's)."""
        slots = self.slots if slots is None else slots
        mask = None if drops is None else torch.arange(tokens.shape[1], device=tokens.device)[None] <= last[:, None]
        h, kv = forward(params, self.cfg, self.ec, tokens=tokens, mode="prefill", block_q=64, block_k=64,
                        pool=len(self.ranks), moe_drops=drops, moe_mask=mask, moe_replicated=self.pool is not None)
        logits = logits_for(params, self.cfg, h.index_select(1, last))[:, 0, : self.cfg.vocab_size]
        lv = slots.level
        if lv is not None:
            lo, hi = slots.slot_range()
            own = (slot >= lo) & (slot < hi)
            row = (slot - lo).clamp(0, hi - lo - 1)
        for layer, c in zip(slots.layers, kv):
            if "k" not in c:  # a Mamba layer: the slot's state and conv tail (this rank's channels)
                for name, t in c.items():
                    new = t.to(layer[name].dtype)
                    if lv is None:
                        layer[name][slot] = new
                    else:
                        layer[name][row] = torch.where(own.view(-1, *[1] * (new.dim() - 1)), new, layer[name][row])
                continue
            n = c["k"].shape[1]
            for name in ("k", "v"):
                new = c[name][0].to(layer[name].dtype)
                if lv is None:
                    layer[name][slot, :n] = new
                else:
                    layer[name][row, :n] = torch.where(own.view(-1, 1, 1, 1), new, layer[name][row, :n])
        nxt = logits.argmax(-1)
        if lv is not None:
            owner = slot // (hi - lo)
            nxt = all_gather(nxt, lv.data).index_select(0, owner)
            if self.econf.record_logits:
                logits = all_gather(logits, lv.data).index_select(0, owner)
        return nxt, logits

    def _decode(self, params: dict, tokens: torch.Tensor, positions: torch.Tensor,
                drops: Optional[torch.Tensor] = None, slots: Optional[SlotCache] = None):
        """One decode step of every slot: tokens (n_slots, 1), positions
        (n_slots,); the block tables are fixed and seq_lens come from the
        positions on the device; Mamba layers update their slots' states in
        place. ``drops`` gains the MoE assignments
        dropped, idle slots' included (the reference dispatches them too).
        Across processes this rank steps its data group's slots and the
        next tokens (and, recording, the logits) are gathered over the data
        groups. ``slots`` as in ``_prefill``."""
        slots = self.slots if slots is None else slots
        lo, hi = slots.slot_range()
        tokens, positions = tokens[lo:hi], positions[lo:hi]
        tables, lens = slots.page_tables(positions)
        h, _ = forward(params, self.cfg, self.ec, tokens=tokens, positions=positions,
                       cache=slots.layers, block_tables=tables, seq_lens=lens, mode="decode",
                       pool=len(self.ranks), moe_drops=drops)
        logits = logits_for(params, self.cfg, h)[:, 0, : self.cfg.vocab_size]
        nxt = logits.argmax(-1)
        if slots.level is not None:
            nxt = all_gather(nxt, slots.level.data)
            if self.econf.record_logits:
                logits = all_gather(logits, slots.level.data)
        return nxt, logits

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
            params, slots = self.ctl.bindings[tp], self.level_slots.get(tp, self.slots)
            decode = _weak(self._decode, params, drops=self._drops.get((tp, "decode")), slots=slots)
            prefill = _weak(self._prefill, params, drops=self._drops.get((tp, "prefill")), slots=slots)
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
        "prefill" | "decode"); empty for a dense model. Across processes the
        pool's count, which every rank calls for together: each dispatch is
        counted on one rank (``models.moe``), and the ranks' counts are
        added over the pool."""
        keys = list(self._drops)
        if not keys:
            return {}
        counts = torch.cat([self._drops[k] for k in keys])
        if self.pool is not None:
            counts = all_reduce(counts, self.pool.world_group)
        return {k: int(n) for k, n in zip(keys, counts.tolist())}

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
        if self.pool is not None:
            return self._switch_pool(tp)

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

    def _switch_pool(self, tp: int) -> dict:
        """The switch across processes, on every rank together: the weights
        rebound (each card's own views), the slot cache resharded from this
        level's buffers into the new level's (one all-to-all over the pool;
        a failure on any rank rolls every rank back)."""
        defs = self.slots.cache_defs()
        src, dst = self.slots, self.level_slots[tp]

        def migrate(_tp):
            _, seconds = migrate_cache(src.layers, cache_shardings(defs, self.pool.world, tp),
                                       source=cache_shardings(defs, self.pool.world, self.tp), pool=self.pool,
                                       into=dst.layers)
            return dst, seconds

        self.slots = self.ctl.switch(tp, migrate_fn=migrate)
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
