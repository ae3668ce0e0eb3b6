"""Continuous-batching scheduler: slot-based admission into in-flight batches.

The decode program is compiled once for a fixed slot count; a *slot* is one
row of that batch.  Each engine step the scheduler:

  1. retires finished requests (slots + KV blocks return to the pool),
  2. admits waiting requests into free slots — resumes first (a preempted
     request re-enters before any new arrival), then FIFO arrivals, gated
     on the paged KV-cache having enough free blocks for the request's
     *prompt* (not prompt+budget): KV grows on demand during decode
     (`BlockAllocator.extend`, one block at a time), so admission reserves
     only what prefill will actually write,
  3. picks the step's prefill *chunk* (`next_chunks`): alongside the slot
     accounting sits chunk accounting — each admitted request remembers how
     much of its prompt is committed (`ServeRequest.prefilled`) and the
     engine's `chunk_tokens` budget is greedily PACKED, oldest admission
     first, with prompt segments from up to `max_segments` requests per
     step (short prompts no longer leave the tail of the budget idle).
     Admission itself is therefore free
     (no prefill program runs at admission; the prompt is streamed through
     the unified step), and a request only joins the decode batch once its
     prompt is fully committed.

When the pool runs dry mid-decode — a growing request cannot extend — the
scheduler picks a preemption *victim*: the most recently admitted active
request (LIFO), preferring the one with the most remaining budget among
same-step admissions.  The victim's KV blocks are swapped out to a host
buffer by the engine and the request joins the resume queue; the submit-time
guard (a single request's worst case must fit the pool alone) makes this
loop always terminate — preempting every other active request frees enough
blocks for any admitted request to finish.

Requests that arrive while all slots are busy (or the pool is dry) simply
wait — overload degrades to queueing delay (plus preemption under pool
pressure), never to an error.  Per-slot position tracking is length-based
(no left-padding anywhere): slot i's next token lands at position
`lengths[i]`, independent of every other slot.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, List, Optional

import numpy as np

from repro_torch.serve.kvcache import BlockAllocator, KVCacheConfig
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.trace import NULL_RECORDER, stream_digest


@dataclasses.dataclass
class ServeRequest:
    rid: int
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int
    arrival_time: float = 0.0
    # submit-time sampling knobs; the default is greedy (temperature 0),
    # which is bitwise the pre-sampling argmax path.  The params ride on
    # the request through its whole life — slot residency, preemption,
    # resume — so per-token keys (seed, rid, token_index) never drift.
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    # lifecycle timestamps (engine clock)
    admitted_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    # generation state
    output: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    # chunked-prefill state: prompt tokens whose KV is committed to the pool.
    # A request joins the decode batch only once prefilled == prompt_len; the
    # unified step advances it by up to `chunk_tokens` per engine step.
    prefilled: int = 0
    # preemption state
    preemptions: int = 0
    preempted_time: Optional[float] = None  # set while off-slot awaiting resume
    stall_s: float = 0.0                    # total time spent preempted
    last_stall_s: float = 0.0               # stall of the most recent resume

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

    @property
    def prefilling(self) -> bool:
        """True while some prompt KV is still uncommitted — the request
        holds a slot but is not yet part of the decode batch."""
        return self.prefilled < self.prompt_len

    @property
    def done(self) -> bool:
        return self.finish_time is not None

    @property
    def remaining_budget(self) -> int:
        return self.max_new_tokens - len(self.output)

    @property
    def latency_s(self) -> float:
        """Completion latency; NaN until the request finishes (a finite
        value here for an unfinished request would silently poison any
        aggregate it lands in)."""
        if self.finish_time is None:
            return math.nan
        return self.finish_time - self.arrival_time

    @property
    def ttft_s(self) -> float:
        """Time to first token; NaN until the first token exists."""
        if self.first_token_time is None:
            return math.nan
        return self.first_token_time - self.arrival_time


class PagedCapacity:
    """The paged-KV family's admission/footprint model: the capacity-seam
    object the scheduler consults instead of hard-wiring block arithmetic.

    Submit guards, fresh/resume admission gates and the retire-time release
    are verbatim relocations of the scheduler's pre-seam logic (same order,
    same reject strings, same trace events), so extracting the seam is a
    provable no-op for DecoderLM.  `SlotStateCache`'s `SlotCapacity`
    (serve/statecache.py) is the other implementation — fixed one-row
    footprint, claimed lazily at first-chunk dispatch."""

    def __init__(self, kv_cfg: KVCacheConfig, alloc: BlockAllocator):
        self.kv_cfg = kv_cfg
        self.alloc = alloc

    def submit_reason(self, req: "ServeRequest") -> Optional[str]:
        rows = ContinuousScheduler.kv_rows(req)
        if rows > self.kv_cfg.max_seq:
            return (f"prompt {req.prompt_len} + max_new "
                    f"{req.max_new_tokens} exceeds max_seq "
                    f"{self.kv_cfg.max_seq}")
        need = self.kv_cfg.blocks_for(rows)
        usable = self.kv_cfg.num_blocks - 1
        if need > usable:
            # could never finish even running alone on an empty pool —
            # reject now instead of preempting everyone and still dying.
            # (This guard is also what makes preemption terminate: with
            # every other request evicted, any admitted request can always
            # extend to its worst case.)
            return f"needs {need} KV blocks but the pool only has {usable}"
        return None

    def _prefix_plan(self, req: "ServeRequest"):
        """(matched blocks, revived count, fresh blocks) for admitting req
        with prefix sharing: `matched` comes from the allocator's prefix
        index, `revived` counts the matched blocks currently parked on the
        free list (refcount 0 — adopting them shrinks the free pool), and
        `fresh` is what the prompt still needs beyond the match."""
        if not getattr(self.kv_cfg, "prefix_sharing", False):
            return [], 0, self.kv_cfg.blocks_for(req.prompt_len)
        matched = self.alloc.match_prefix(req.prompt)
        revived = sum(1 for b in matched if b not in self.alloc.refcount)
        fresh = self.kv_cfg.blocks_for(req.prompt_len) - len(matched)
        return matched, revived, fresh

    def can_admit_fresh(self, req: "ServeRequest") -> bool:
        # live matched blocks are free capacity-wise (refcount bump only);
        # revived ones leave the free list, so they count like fresh blocks
        _, revived, fresh = self._prefix_plan(req)
        return self.alloc.can_allocate(fresh + revived)

    def admit_fresh(self, req: "ServeRequest") -> None:
        matched, _, fresh = self._prefix_plan(req)
        if not matched:
            self.alloc.allocate(req.rid,
                                self.kv_cfg.blocks_for(req.prompt_len))
            return
        # adopt the shared prefix FIRST (reviving any free-listed matches),
        # THEN grow the fresh tail — allocation must not evict a block the
        # match is about to revive
        self.alloc.share(req.rid, matched)
        if fresh:
            ok = self.alloc.extend(req.rid, req.prompt_len)
            assert ok, "admission gate passed but the fresh tail failed"
        # prefill starts at the first unshared token; at least one prompt
        # token always runs through the chunk lane so the first output
        # token is sampled from the segment's logits exactly as unshared
        req.prefilled = min(len(matched) * self.kv_cfg.block_size,
                            req.prompt_len - 1)

    def can_admit_resume(self, req: "ServeRequest") -> bool:
        return self.alloc.can_allocate(self.alloc.swapped[req.rid])

    def admit_resume(self, req: "ServeRequest") -> None:
        self.alloc.swap_in(req.rid)

    def release(self, req: "ServeRequest") -> None:
        self.alloc.free(req.rid)

    def occupancy(self) -> float:
        return self.alloc.occupancy()


class ContinuousScheduler:
    """Admission control over `max_slots` decode slots + a capacity model.

    The scheduler owns WHO is resident (slots, queues, admission order,
    preemption policy); the capacity object owns the family's memory
    arithmetic (what a request's footprint is, whether the pool covers it,
    how admission/retire move it).  `PagedCapacity` is the DecoderLM
    implementation; passing `capacity=` explicitly plugs in another family
    (`SlotCapacity` for the state-cache families).  The legacy
    `(max_slots, kv_cfg, alloc)` construction builds a `PagedCapacity`
    internally and stays bit-identical."""

    def __init__(self, max_slots: int, kv_cfg: Optional[KVCacheConfig] = None,
                 alloc: Optional[BlockAllocator] = None, trace=NULL_RECORDER,
                 capacity=None):
        self.max_slots = max_slots
        if capacity is None:
            capacity = PagedCapacity(kv_cfg, alloc)
        self.capacity = capacity
        self.kv_cfg = kv_cfg
        self.alloc = alloc if alloc is not None else getattr(
            capacity, "alloc", None)
        # structured event recorder (`repro.serve.trace`); the engine passes
        # its own, the default no-op costs one attribute lookup per site
        self.trace = trace
        # family tag stamped on lifecycle events; the engine overwrites it
        # from its FamilyAdapter.  Pre-seam traces carried no field, so the
        # audit treats an absent tag as "decoder".
        self.family = "decoder"
        self.waiting: Deque[ServeRequest] = deque()
        self.resumed: Deque[ServeRequest] = deque()   # preempted, to re-admit
        self.slots: List[Optional[ServeRequest]] = [None] * max_slots

    # ------------------------------------------------------------- queries
    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self.slots)

    @property
    def num_waiting(self) -> int:
        return len(self.waiting)

    @property
    def num_preempted(self) -> int:
        return len(self.resumed)

    @property
    def has_work(self) -> bool:
        return (self.num_active > 0 or self.num_waiting > 0
                or self.num_preempted > 0)

    def slot_rids(self) -> List[Optional[int]]:
        return [r.rid if r is not None else None for r in self.slots]

    # ----------------------------------------------------------- lifecycle
    @staticmethod
    def kv_rows(req: ServeRequest) -> int:
        """KV rows a request can ever occupy: the prompt plus every
        generated token except the last (which is emitted but never fed
        back through a decode step, so its K/V row is never written)."""
        return req.prompt_len + req.max_new_tokens - 1

    def _reject(self, req: ServeRequest, reason: str) -> None:
        self.trace.emit("reject", rid=req.rid, reason=reason)
        raise ValueError(f"request {req.rid}: {reason}")

    def submit(self, req: ServeRequest) -> None:
        if req.max_new_tokens < 1:
            self._reject(req, "max_new_tokens must be >= 1")
        if req.prompt_len < 1:
            self._reject(req, "empty prompt")
        bad = req.sampling.invalid_reason()
        if bad is not None:
            self._reject(req, bad)
        reason = self.capacity.submit_reason(req)
        if reason is not None:
            self._reject(req, reason)
        self.waiting.append(req)
        # sampled submits carry their knobs (incl. the per-request seed) in
        # the trace, so a recorded run is exactly replayable; the audit
        # layer checks the seed is present whenever temperature > 0
        extra = {}
        if not req.sampling.greedy:
            s = req.sampling
            extra = dict(temperature=s.temperature, top_k=s.top_k,
                         top_p=s.top_p, seed=s.seed)
        self.trace.emit("submit", rid=req.rid, arrival=req.arrival_time,
                        prompt_len=req.prompt_len,
                        max_new=req.max_new_tokens, family=self.family,
                        **extra)

    def admit(self, now: float) -> List[ServeRequest]:
        """Move waiting/preempted requests into free slots; returns the
        newly admitted (resumes carry swapped-out KV the engine must commit
        before decoding; fresh admissions are prefilled).

        Resume-first with head-of-line blocking on BOTH queues: a preempted
        request re-enters before any newer arrival, and a request too large
        for the current free pool also holds back the requests behind it,
        preserving admission-order fairness.  Fresh admissions are gated on
        the *prompt* footprint only — decode KV grows on demand."""
        admitted: List[ServeRequest] = []
        for slot in range(self.max_slots):
            if self.slots[slot] is not None:
                continue
            if self.resumed:
                req = self.resumed[0]
                if not self.capacity.can_admit_resume(req):
                    break   # nobody jumps a preempted request's re-admission
                self.resumed.popleft()
                self.capacity.admit_resume(req)
                req.last_stall_s = now - req.preempted_time
                req.stall_s += req.last_stall_s
                req.preempted_time = None
                kind = "resume"
            elif self.waiting:
                req = self.waiting[0]
                if req.arrival_time > now:
                    break  # not yet arrived (simulated-arrival workloads)
                if not self.capacity.can_admit_fresh(req):
                    break
                self.waiting.popleft()
                self.capacity.admit_fresh(req)
                req.admitted_time = now
                kind = "fresh"
            else:
                break
            req.slot = slot
            self.slots[slot] = req
            admitted.append(req)
            self.trace.emit("admit", t=now, rid=req.rid, slot=slot, kind=kind,
                            family=self.family)
        return admitted

    def next_chunks(self, budget: int, max_segments: int = 1) -> List[tuple]:
        """Pick this step's prefill chunk as a PACKED list of segments:
        requests with uncommitted prompt tokens, oldest admission first
        (ties: lowest rid), greedily fill the budget — each takes
        min(remaining budget, remaining prompt), so the head request may
        split mid-prompt exactly as before and the tail segment may too
        (the split point just becomes that request's next chunk start).

        Returns up to `max_segments` tuples (request, start, n_tokens);
        empty when no prompt work is pending.  Head-of-line by admission
        time: an older prompt always receives budget before a younger one,
        so TTFT ordering follows admission ordering, while younger prompts
        may ride along in whatever budget the head leaves idle — that
        left-over budget is exactly what single-segment chunking wasted
        (the compiled chunk lane executes at full width regardless of
        fill).  The budget is the unified step's `chunk_tokens` — the
        token-budget counterpart of slot accounting: slots bound *who* is
        resident, the chunk budget bounds how much *prompt* work any
        single step may carry, which is what keeps prompt work from
        stalling the decode batch."""
        if budget < 1 or max_segments < 1:
            return []
        cands = sorted([r for r in self.slots
                        if r is not None and r.prefilling],
                       key=lambda r: (r.admitted_time, r.rid))
        out: List[tuple] = []
        for req in cands:
            if budget < 1 or len(out) >= max_segments:
                break
            n = min(budget, req.prompt_len - req.prefilled)
            out.append((req, req.prefilled, n))
            budget -= n
        return out

    def victim_for_preemption(
            self, exclude_rid: int,
            eligible=None) -> Optional[ServeRequest]:
        """Deterministic victim choice when the pool runs dry: the most
        recently admitted active request (LIFO — oldest work is never the
        one rolled back), preferring the largest remaining budget among
        requests admitted at the same instant (the long-tail request has
        the most KV growth still ahead of it), then the highest rid.

        `eligible` (optional predicate) narrows the candidates to requests
        whose eviction can actually free capacity — the state-cache family
        passes `holds-a-state-row`, since an admitted-but-unclaimed request
        owns nothing to reclaim.  The paged family leaves it unset (every
        resident holds blocks from admission), which preserves the pre-seam
        choice exactly."""
        cands = [r for r in self.slots
                 if r is not None and r.rid != exclude_rid
                 and (eligible is None or eligible(r))]
        if not cands:
            return None
        return max(cands, key=lambda r: (r.admitted_time,
                                         r.remaining_budget, r.rid))

    def preempt(self, req: ServeRequest, now: float) -> None:
        """Take `req` off its slot and queue it for resume.  The engine
        swaps the KV blocks out (see `PagedKVCache.swap_out`) BEFORE calling
        this; here is only the slot/queue bookkeeping.  Partially prefilled
        requests preempt exactly like decoding ones — `prefilled` rides on
        the request, so after the swap-in restores the committed KV the
        chunk accounting resumes the prompt mid-stream, recomputing
        nothing."""
        assert req.slot is not None and self.slots[req.slot] is req
        self.trace.emit("preempt", t=now, rid=req.rid, slot=req.slot,
                        family=self.family)
        self.slots[req.slot] = None
        req.slot = None
        req.preemptions += 1
        req.preempted_time = now
        self.resumed.append(req)

    def retire(self, req: ServeRequest, now: float) -> None:
        """Release the request's slot and its capacity holding (KV blocks /
        state row)."""
        req.finish_time = now
        self.capacity.release(req)
        assert req.slot is not None and self.slots[req.slot] is req
        self.slots[req.slot] = None
        req.slot = None
        # the finish event pins the whole token stream via a digest the
        # replay audit recomputes from first_token/decode_token events
        self.trace.emit("finish", t=now, rid=req.rid,
                        n_output=len(req.output),
                        digest=stream_digest(req.output), family=self.family)
