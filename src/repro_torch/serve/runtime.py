"""Continuous-batching serving runtime — the port of `repro.serve.runtime`
(`RuntimeConfig`, `ContinuousEngine`).

Request lifecycle (the JAX package's, unchanged):

    submit() -> waiting -> admitted into a free slot when the family's
    capacity model accepts it (admission runs nothing on the device)
             -> chunked prefill: each step packs up to `chunk_tokens` of
                pending prompt work — segments from up to `chunk_segments`
                requests, oldest admission first — into the step's prefill
                lane, while the decode lane advances every in-flight request
             -> the chunk that completes a prompt samples its first token
             -> the request decodes one token per step from the next step
                on, growing its KV blocks on demand, and retires on eos or
                max_new_tokens.

`step()` is orchestration only — admit -> schedule chunks -> grow-or-preempt
-> dispatch -> retire — and every family question goes through the
adapter (`repro_torch.serve.family`): paged KV blocks for the decoder
family, slot-pooled state rows for the ssm family.  A step runs the unified step
program when prompt work is pending and the decode-only program otherwise:
exactly two step programs, at fixed shapes, each captured in a CUDA graph
at its first step on the GPU (`RuntimeConfig.cuda_graphs`) and replayed by
every later step; admission captures nothing.  The resume commit and the
copy-on-write are two more programs of one signature each.  A trace
records a `compile` event where a step or commit program captures (or, on
the CPU, first runs), as the JAX engine records one where a program
compiles.  Under pool
pressure the grow path preempts the scheduler's victim: its KV is copied to
host buffers, its slot and blocks are freed, and it re-enters ahead of new
arrivals with its KV scattered back (no token is recomputed).

The engine takes the rank's `device` (`None` means the GPU and raises
without one) and, like the JAX engine, an optional `mesh` and sharding
`rules` (DEFAULT_RULES when omitted).  The router folds its plan's
layout verdicts and the mesh's divisibility guards into the rules
(`PlanRouter.serve_rules`).  With no mesh, or a 1-wide model axis, the
engine is the single-device engine.  On a wider model axis (`tp_mesh(tp)`
in a world of tp ranks, each running the same engine on the same
requests) every rank serves from its own parameter shards and KV heads
(`DecoderLM.tp_local_params`), runs its steps eagerly and exchanges
partial sums and logits through `distributed.collectives`: every rank
runs the same host logic on the same inputs and draws the same tokens.
The dense decoder family only (ROADMAP.md queue 1, item 8b-ii for the
rest).  The
plan (`PlanRouter`) picks each lane's attention backend and matmul table:
with no plan every lane is the torch lane; a plan whose choices name the
kernels sends attention through the paged CUDA kernels and the
role-tagged matmuls (the decoder's four, the ssm family's three) through
the tiled GEMM.  A `TraceRecorder` passed as
`trace=` records the same typed events as the JAX engine, on the engine
clock.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np

from repro_torch.distributed.collectives import TensorParallel
from repro_torch.distributed.sharding import (DEFAULT_RULES, ShardingRules,
                                              axis_sizes, prune_for_mesh)
from repro_torch.platform import DeviceLike, resolve_device
from repro_torch.serve.family import resolve_family_adapter
from repro_torch.serve.kvcache import KVCacheConfig
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.router import DEFAULT_CHUNK_TOKENS, PlanRouter, serve_stages
from repro_torch.serve.sampling import (SamplingParams, slot_sampling_arrays,
                                        truncate_at_eos)
from repro_torch.serve.scheduler import ContinuousScheduler, ServeRequest
from repro_torch.serve.statecache import StateCacheConfig
from repro_torch.serve.trace import NULL_RECORDER, TraceRecorder


@dataclasses.dataclass
class RuntimeConfig:
    max_slots: int = 4                # decode batch width
    block_size: int = 16              # KV block granularity (token rows)
    max_blocks_per_seq: int = 8       # per-request table width
    num_blocks: Optional[int] = None  # pool size; default: slots*table + null
    max_new_tokens: int = 32          # default generation budget
    eos_id: int = -1                  # -1: never stop early
    # prompt tokens one step's prefill lane may carry (None = max_seq)
    chunk_tokens: Optional[int] = DEFAULT_CHUNK_TOKENS
    # prompt segments one step's chunk may pack (a plan may narrow it)
    chunk_segments: int = 4
    # state-row pool of the slot-pooled (ssm) family, including the null
    # row; None = max_slots + 1 (every slot can hold state at once).  A
    # smaller pool drives the grow-or-preempt path at first-chunk claim.
    # The paged family ignores it.
    state_slots: Optional[int] = None
    # prefix sharing (paged family): admission may adopt committed
    # full-block prefixes (refcounted, copy-on-write); off by default
    prefix_sharing: bool = False
    # on a CUDA device, capture each step program in a CUDA graph at its
    # first step and replay it after; False runs every step eagerly, kept
    # only to compare against (the counterpart of the reference's jit)
    cuda_graphs: bool = True

    @property
    def max_seq(self) -> int:
        return self.block_size * self.max_blocks_per_seq

    @property
    def chunk_width(self) -> int:
        """The prefill lane's width: chunk_tokens clamped to [1, max_seq],
        None meaning max_seq."""
        return max(1, min(self.chunk_tokens or self.max_seq, self.max_seq))

    def kv_config(self) -> KVCacheConfig:
        nb = self.num_blocks
        if nb is None:
            nb = self.max_slots * self.max_blocks_per_seq + 1
        return KVCacheConfig(num_blocks=nb, block_size=self.block_size,
                             max_blocks_per_seq=self.max_blocks_per_seq,
                             prefix_sharing=self.prefix_sharing)

    def state_config(self) -> StateCacheConfig:
        ns = self.state_slots
        if ns is None:
            ns = self.max_slots + 1
        return StateCacheConfig(num_slots=ns)


class ContinuousEngine:
    """Slot-based continuous-batching engine over a family state cache."""

    # family-owned attributes read off the engine, resolved via the adapter
    _ADAPTER_ATTRS = ("_unified", "_decode_only", "_commit", "_cow", "cache",
                      "kv_cfg")

    def __init__(self, model, params, cfg: RuntimeConfig,
                 router: Optional[PlanRouter] = None,
                 now_fn: Optional[Callable[[], float]] = None,
                 trace: Optional[TraceRecorder] = None,
                 device: DeviceLike = None, *, mesh=None,
                 rules: Optional[ShardingRules] = None):
        self.device = resolve_device(device)
        self.model = model
        self.cfg = cfg
        self.router = router or PlanRouter(None)
        self.now_fn = now_fn or time.perf_counter
        self.mesh = mesh
        self.trace = trace if trace is not None else NULL_RECORDER
        if self.trace.enabled and self.trace.now_fn is None:
            self.trace.now_fn = self.now_fn
        adapter_cls = resolve_family_adapter(model)
        # the rules the router's layout verdicts and the mesh's divisibility
        # guards leave (`PlanRouter.serve_rules`: the base rules themselves
        # on a 1-wide model axis), and the "<data>x<model>" tag the step
        # events carry ("1x1" with no mesh)
        self.rules = None
        self.tp = None
        self.mesh_tag = "1x1"
        if mesh is not None:
            self.rules = self.router.serve_rules(
                DEFAULT_RULES if rules is None else rules, mesh, model.cfg,
                adapter_cls.family)
            sizes = axis_sizes(mesh)
            self.mesh_tag = f"{sizes.get('data', 1)}x{sizes.get('model', 1)}"
            self.tp = TensorParallel.from_mesh(mesh, prune_for_mesh(self.rules, mesh))
        if self.tp is not None and adapter_cls.family != "decoder":
            raise NotImplementedError(
                f"tensor-parallel serving of the {adapter_cls.family} family is "
                "not ported yet: ROADMAP.md queue 1, item 8b-ii")
        self.params = model.serving_params(params, self.device)
        if self.tp is not None:
            self.params = model.tp_local_params(self.params, self.tp)
            self.adapter = adapter_cls(model, cfg, self.router, self.device, self.tp)
        else:
            self.adapter = adapter_cls(model, cfg, self.router, self.device)
        self.family = self.adapter.family
        self.adapter.alloc.trace = self.trace
        self.scheduler = ContinuousScheduler(
            cfg.max_slots, trace=self.trace, capacity=self.adapter.capacity())
        self.scheduler.family = self.family
        self.metrics = ServeMetrics(family=self.family)
        self._rid = 0
        self._step_idx = 0
        self._done: List[ServeRequest] = []
        self._chunk_width = self.adapter.chunk_width
        self._chunk_segments = self.adapter.chunk_segments
        # per-slot host state (decode lane; prefilling slots stay zeroed so
        # their dummy decode row writes to the null sink)
        self._lengths = np.zeros((cfg.max_slots,), np.int32)
        self._last_tok = np.zeros((cfg.max_slots,), np.int32)

    def __getattr__(self, name):
        if name in type(self)._ADAPTER_ATTRS:
            return getattr(self.adapter, name)
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}")

    # ------------------------------------------------------------ interface
    def submit(self, prompt: np.ndarray, max_new_tokens: Optional[int] = None,
               arrival_time: Optional[float] = None,
               sampling: Optional[SamplingParams] = None) -> int:
        self._rid += 1
        if max_new_tokens is None:
            max_new_tokens = self.cfg.max_new_tokens
        req = ServeRequest(
            rid=self._rid, prompt=np.asarray(prompt, np.int32),
            max_new_tokens=max_new_tokens,
            arrival_time=(arrival_time if arrival_time is not None
                          else self.now_fn()),
            sampling=sampling if sampling is not None else SamplingParams())
        self.scheduler.submit(req)
        return self._rid

    def run(self) -> List[ServeRequest]:
        """Step until every submitted request completes; returns them in
        completion order.  Idle steps back off briefly."""
        if self.metrics.start_time is None:
            self.metrics.start_time = self.now_fn()
        while self.scheduler.has_work:
            if not self.step():
                time.sleep(2e-4)
        self.metrics.end_time = self.now_fn()
        done, self._done = self._done, []
        return done

    def trace_metadata(self) -> dict:
        """Run metadata for `trace.write_trace` / the traceview audit: the
        pool, the lane geometry, the mesh tag and the router's per-stage
        layout table."""
        stages = serve_stages(self.family)
        meta = {"family": self.family, "mesh": self.mesh_tag,
                "max_slots": self.cfg.max_slots,
                "chunk_width": self._chunk_width,
                "chunk_segments": self._chunk_segments,
                "layouts": {st: self.router.layout_table(st) for st in stages
                            if st != "prefill"}}
        if self.family == "decoder":
            meta.update(usable_blocks=self.kv_cfg.num_blocks - 1,
                        block_size=self.kv_cfg.block_size)
        else:
            meta.update(usable_blocks=self.cache.cfg.usable)
        return meta

    def reset_metrics(self) -> None:
        """Fresh metrics (e.g. after a warm-up pass); the programs and the
        cache state are kept."""
        self.metrics = ServeMetrics(family=self.family)

    # ------------------------------------------------- preemption / resume
    def _ensure_blocks(self, req: ServeRequest) -> None:
        """Grow req's state to cover its next decode write, preempting
        victims while the pool is dry (terminates by the submit guard)."""
        need_rows = int(self._lengths[req.slot]) + 1
        while not self.adapter.grow_for_decode(req, need_rows):
            victim = self.scheduler.victim_for_preemption(
                exclude_rid=req.rid, eligible=self.adapter.victim_eligible)
            if victim is None:
                raise MemoryError(
                    f"request {req.rid} cannot grow to {need_rows} rows with "
                    "no victims left — submit() guard violated")
            self._preempt(victim)

    def _claim_chunk(self, req: ServeRequest, start: int, n: int) -> bool:
        while not self.adapter.claim_chunk(req, start, n):
            victim = self.scheduler.victim_for_preemption(
                exclude_rid=req.rid, eligible=self.adapter.victim_eligible)
            if victim is None:
                return False
            self._preempt(victim)
        return True

    def _preempt(self, victim: ServeRequest) -> None:
        slot = victim.slot
        nbytes = self.adapter.swap_out(victim.rid)
        self.scheduler.preempt(victim, self.now_fn())
        self._reset_slot(slot)
        self.metrics.record_preemption(nbytes)

    def _resume_all(self, reqs: List[ServeRequest]) -> None:
        width = self.adapter.resume_segments
        for i in range(0, len(reqs), width):
            self._resume_group(reqs[i:i + width])

    def _resume_group(self, group: List[ServeRequest]) -> None:
        """One packed commit of the group's swapped KV (the commit program,
        one signature), then each slot's host state; the batch's wall time
        is split evenly across the group."""
        t0 = time.perf_counter()
        n_commit = self._commit._cache_size()
        nbytes = self.adapter.resume_commit(group)
        batch_s = time.perf_counter() - t0
        swap_in_s = batch_s / len(group)
        self.metrics.record_resume_commit(len(group))
        if self.trace.enabled and self._commit._cache_size() > n_commit:
            self.trace.emit("compile", program="commit", device_s=batch_s)
        for req, nb in zip(group, nbytes):
            if self.trace.enabled:
                self.trace.emit("swap_in", rid=req.rid, nbytes=nb)
                self.trace.emit("resume", rid=req.rid,
                                stall_s=req.last_stall_s,
                                swap_in_s=swap_in_s)
            self.metrics.record_resume(nb, req.last_stall_s,
                                       swap_in_s=swap_in_s)
            slot = req.slot
            if req.prefilling:
                self._reset_slot(slot)
            else:
                self._lengths[slot] = req.prompt_len + len(req.output) - 1
                self._last_tok[slot] = req.output[-1]

    def _reset_slot(self, slot: int) -> None:
        self._lengths[slot] = 0
        self._last_tok[slot] = 0

    def _finished(self, req: ServeRequest) -> bool:
        if len(req.output) >= req.max_new_tokens:
            return True
        return self.cfg.eos_id >= 0 and self.cfg.eos_id in req.output

    def _retire(self, req: ServeRequest, now: float) -> None:
        slot = req.slot
        req.output = truncate_at_eos(req.output, self.cfg.eos_id)
        self.scheduler.retire(req, now)
        self._reset_slot(slot)
        self.metrics.record_completion(req.latency_s, len(req.output))
        self._done.append(req)

    # ----------------------------------------------------------- unified step
    def step(self) -> bool:
        """One engine step: admit (resumes swap back in), pack the step's
        prefill chunk, grow every decoding request's blocks and claim every
        packed segment's footprint (preempting if the pool is dry), then run
        the unified step or — with no prompt work — the decode-only step.
        Returns False when nothing ran."""
        now = self.now_fn()
        admitted = self.scheduler.admit(now)
        resuming = [r for r in admitted if self.adapter.is_swapped(r.rid)]
        if self.cfg.prefix_sharing:
            rs = {r.rid for r in resuming}
            for req in admitted:
                if req.rid not in rs and req.prefilled > 0:
                    self.metrics.record_prefix_hit(req.prefilled)
        if resuming:
            self._resume_all(resuming)

        chunks = self.scheduler.next_chunks(self._chunk_width,
                                            self._chunk_segments)
        for req in [r for r in self.scheduler.slots
                    if r is not None and not r.prefilling]:
            if req.slot is not None:
                self._ensure_blocks(req)
        chunks = [ch for ch in chunks
                  if ch[0].slot is not None and self._claim_chunk(*ch)]
        chunks = [ch for ch in chunks if ch[0].slot is not None]

        decoding = [r for r in self.scheduler.slots
                    if r is not None and not r.prefilling]
        if not decoding and not chunks:
            return bool(admitted)

        dec_rids = [r.rid if (r is not None and not r.prefilling) else None
                    for r in self.scheduler.slots]

        trace = self.trace
        kind = "unified" if chunks else "decode_only"
        step_idx = self._step_idx
        self._step_idx += 1
        step_fields = dict(step=step_idx, kind=kind, family=self.family,
                           mesh=self.mesh_tag,
                           lane_width=self._chunk_width if chunks else 0,
                           segments=len(chunks),
                           chunk_tokens=sum(n for _, _, n in chunks),
                           decode_rows=len(decoding))
        if trace.enabled:
            for req, start, n in chunks:
                trace.emit("chunk_scheduled", t=now, rid=req.rid,
                           start=start, n=n)
            trace.emit("step_begin", t=now, **step_fields)
            prog = self._unified if chunks else self._decode_only
            n_compiled = prog._cache_size()

        dec_sampling, dec_keys = slot_sampling_arrays(self.scheduler.slots)

        # device time: the dispatch ends in a synchronising copy of the
        # next tokens to the host
        t0 = time.perf_counter()
        nxt, seg_next = self.adapter.dispatch(
            self.params, dec_rids, self._lengths, self._last_tok, chunks,
            dec_sampling, dec_keys)
        step_s = time.perf_counter() - t0
        if trace.enabled and prog._cache_size() > n_compiled:
            trace.emit("compile", program=kind, device_s=step_s)
        if decoding:
            self.metrics.decode_time_s += step_s
        else:
            self.metrics.prefill_time_s += step_s

        now = self.now_fn()
        if trace.enabled:
            trace.emit("step_end", t=now, device_s=step_s, **step_fields)
        if chunks:
            self.metrics.record_chunk_step([n for _, _, n in chunks],
                                           self._chunk_width)
            for i, (req, start, n) in enumerate(chunks):
                req.prefilled = start + n
                self.adapter.register_prefix(req)
                if trace.enabled:
                    trace.emit("chunk_committed", t=now, rid=req.rid,
                               start=start, n=n, prefilled=req.prefilled)
                if not req.prefilling:        # this chunk finished the prompt
                    first = int(seg_next[i])
                    req.output.append(first)
                    req.first_token_time = now
                    trace.emit("first_token", t=now, rid=req.rid, token=first)
                    self.metrics.record_first_token(now - req.arrival_time)
                    self.metrics.prefills += 1
                    slot = req.slot
                    self._lengths[slot] = req.prompt_len
                    self._last_tok[slot] = first
                    if self._finished(req):
                        self._retire(req, now)
        elif decoding:
            self.metrics.record_decode_only_step()

        if decoding:
            self.metrics.record_step(len(decoding), self.cfg.max_slots,
                                     self.adapter.occupancy())
            emit_tokens = trace.enabled
            for req in decoding:
                slot = req.slot
                req.output.append(int(nxt[slot]))
                self._lengths[slot] += 1
                self._last_tok[slot] = nxt[slot]
                if emit_tokens:
                    trace.emit("decode_token", t=now, rid=req.rid,
                               token=int(nxt[slot]))
                if self._finished(req):
                    self._retire(req, now)
        # copy-on-write exists in the paged family only
        drain = getattr(self.adapter.alloc, "drain_cow_copies", None)
        if drain is not None:
            copied = drain()
            if copied:
                self.metrics.record_cow(copied)
        return True
