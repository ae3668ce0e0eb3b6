"""Serving metrics: latency percentiles, TTFT, throughput, cache occupancy.

Everything is recorded against the engine's own clock (wall time for real
serving, virtual time for simulated workloads) so the same metrics object
backs both the runtime and the benchmark harness.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional


def percentile(values: List[float], p: float) -> float:
    """Nearest-rank percentile (p in [0, 100]); 0.0 on empty input.

    True nearest-rank: the value at rank ceil(p/100 * n) (1-based), i.e. the
    smallest sample >= p percent of the distribution.  (The previous
    round(p/100 * (n-1)) was a rounded linear-interpolation index, which
    biased p95 toward the max on small samples.)"""
    if not values:
        return 0.0
    xs = sorted(values)
    rank = max(1, math.ceil(p / 100.0 * len(xs)))   # 1-based nearest rank
    return xs[min(len(xs), rank) - 1]


@dataclasses.dataclass
class ServeMetrics:
    # which model family served these requests ("decoder" | "ssm"): set by
    # the engine from its FamilyAdapter, embedded in trace snapshots so an
    # audit knows which step taxonomy to expect.  Kept out of `summary()`,
    # which is a flat float dict feeding CSV benches.
    family: str = "decoder"
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    ttfts_s: List[float] = dataclasses.field(default_factory=list)
    tokens_out: int = 0
    requests_done: int = 0
    decode_steps: int = 0
    prefills: int = 0          # prompts whose prefill completed
    # chunked-prefill accounting under the PACKED lifecycle: one *chunk* is
    # one request's contiguous prompt slice (a segment) committed in one
    # step, and one step may carry chunks from SEVERAL requests — so a
    # single step can retire several prefills at once (`prefills` advances
    # per request, when its final segment commits; TTFT spans all of that
    # request's chunks).  prefill_chunks > prefills means at least one
    # prompt was split across steps; prefill_chunks > chunk_steps means
    # segments were packed.  Lane utilization is tracked separately:
    # `chunk_steps` counts steps that carried prompt work,
    # `chunk_lane_tokens` the lane capacity those steps paid for
    # (steps x compiled chunk width — the lane always executes at full
    # width), `packed_segments` the chunks that shared their step with at
    # least one other request's, and `decode_only_steps` the steps that
    # skipped the chunk lane entirely via the compiled decode-only fast
    # path.
    prefill_chunks: int = 0
    chunk_tokens_committed: int = 0
    chunk_steps: int = 0
    chunk_lane_tokens: int = 0
    packed_segments: int = 0
    decode_only_steps: int = 0
    # device-compute time (always wall-clock, even under a virtual engine
    # clock) — comparable with FixedBatchEngine's prefill_s/decode_s split.
    # The unified program carries both lanes in one invocation, so a mixed
    # step's time goes to decode_time_s; prefill_time_s collects the steps
    # that carried ONLY chunk work (no decode rows), and decode-only fast-
    # path steps are pure decode_time_s.
    prefill_time_s: float = 0.0
    decode_time_s: float = 0.0
    # swap-in scatter time used to hide inside prefill_time_s; preemption
    # cost is its own line now
    swap_in_time_s: float = 0.0
    # per-decode-step samples
    slot_occupancy: List[float] = dataclasses.field(default_factory=list)
    cache_occupancy: List[float] = dataclasses.field(default_factory=list)
    # None = not started/ended yet.  (A 0.0 sentinel misfires for virtual
    # clock replays that legitimately start at t=0.0.)
    start_time: Optional[float] = None
    end_time: Optional[float] = None
    # preemption / swap accounting (on-demand KV growth under pool pressure)
    preemptions: int = 0
    swap_out_bytes: int = 0
    swap_in_bytes: int = 0
    stall_s: float = 0.0       # total off-slot time of preempted requests
    # prefix sharing: prompt tokens whose KV admission adopted from the
    # prefix index (chunk-lane work never done) and copy-on-write block
    # copies made when a write landed in a shared block
    prefix_hit_tokens: int = 0
    cow_copies: int = 0
    # packed resume commits: `resume_commits` counts commit-program
    # invocations (a burst of K swap-ins costs ceil(K / resume_segments)),
    # `packed_resumes` the swap-ins that shared their invocation with at
    # least one other (the resume-path mirror of `packed_segments`)
    resume_commits: int = 0
    packed_resumes: int = 0

    # ----------------------------------------------------------- recording
    def record_step(self, active_slots: int, max_slots: int,
                    cache_occ: float) -> None:
        self.decode_steps += 1
        self.slot_occupancy.append(active_slots / max(1, max_slots))
        self.cache_occupancy.append(cache_occ)

    def record_first_token(self, ttft_s: float) -> None:
        if math.isnan(ttft_s):
            raise ValueError(
                "TTFT of a request with no first token (NaN) cannot be "
                "aggregated")
        self.ttfts_s.append(ttft_s)

    def record_completion(self, latency_s: float, n_tokens: int) -> None:
        if math.isnan(latency_s):
            raise ValueError(
                "latency of an unfinished request (NaN) cannot be aggregated")
        self.requests_done += 1
        self.tokens_out += n_tokens
        self.latencies_s.append(latency_s)

    def record_chunk_step(self, seg_tokens: List[int], lane_width: int) -> None:
        """One unified step carried a packed chunk of `len(seg_tokens)`
        prompt segments (their token counts; committed to the paged pool
        in-program) through a `lane_width`-token compiled lane."""
        self.chunk_steps += 1
        self.chunk_lane_tokens += lane_width
        self.prefill_chunks += len(seg_tokens)
        self.chunk_tokens_committed += sum(seg_tokens)
        if len(seg_tokens) > 1:
            self.packed_segments += len(seg_tokens)

    def record_decode_only_step(self) -> None:
        """One engine step ran the compiled decode-only fast path (no
        prompt work pending — the chunk lane's cost was skipped, not
        masked)."""
        self.decode_only_steps += 1

    def chunk_fill_frac(self) -> float:
        """Mean utilization of the chunk lane over the steps that ran it:
        committed prompt tokens / lane capacity paid for.  1.0 means every
        token of every chunk step's budget did useful prompt work."""
        if self.chunk_lane_tokens <= 0:
            return 0.0
        return self.chunk_tokens_committed / self.chunk_lane_tokens

    def record_preemption(self, nbytes: int) -> None:
        self.preemptions += 1
        self.swap_out_bytes += nbytes

    def record_resume(self, nbytes: int, stall_s: float,
                      swap_in_s: float = 0.0) -> None:
        self.swap_in_bytes += nbytes
        self.stall_s += stall_s
        self.swap_in_time_s += swap_in_s

    def record_resume_commit(self, n_requests: int) -> None:
        """One commit-program invocation carried `n_requests` swap-ins."""
        self.resume_commits += 1
        if n_requests > 1:
            self.packed_resumes += n_requests

    def record_prefix_hit(self, n_tokens: int) -> None:
        """Admission adopted `n_tokens` prompt tokens' KV from the prefix
        index — chunk-lane work that will never run."""
        self.prefix_hit_tokens += n_tokens

    def record_cow(self, n_copies: int) -> None:
        self.cow_copies += n_copies

    # ------------------------------------------------------------- summary
    @property
    def wall_s(self) -> float:
        """Elapsed engine-clock time; 0.0 while `start_time`/`end_time` are
        unset.  (The old 1e-9 sentinel made `tokens_per_s()` absurdly huge
        — billions of tok/s — on an engine that never ran.)"""
        if self.start_time is None or self.end_time is None:
            return 0.0
        return max(1e-9, self.end_time - self.start_time)

    def tokens_per_s(self) -> float:
        w = self.wall_s
        return self.tokens_out / w if w > 0.0 else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "requests": float(self.requests_done),
            "tokens_out": float(self.tokens_out),
            "wall_s": self.wall_s,
            "tokens_per_s": self.tokens_per_s(),
            "latency_p50_s": percentile(self.latencies_s, 50),
            "latency_p95_s": percentile(self.latencies_s, 95),
            "ttft_p50_s": percentile(self.ttfts_s, 50),
            "ttft_p95_s": percentile(self.ttfts_s, 95),
            "decode_steps": float(self.decode_steps),
            "prefills": float(self.prefills),
            "prefill_chunks": float(self.prefill_chunks),
            "chunk_tokens_committed": float(self.chunk_tokens_committed),
            "chunk_steps": float(self.chunk_steps),
            "chunk_fill_frac": self.chunk_fill_frac(),
            "packed_segments": float(self.packed_segments),
            "decode_only_steps": float(self.decode_only_steps),
            "prefill_time_s": self.prefill_time_s,
            "decode_time_s": self.decode_time_s,
            "swap_in_time_s": self.swap_in_time_s,
            "slot_occupancy_mean": (sum(self.slot_occupancy)
                                    / max(1, len(self.slot_occupancy))),
            "cache_occupancy_mean": (sum(self.cache_occupancy)
                                     / max(1, len(self.cache_occupancy))),
            "cache_occupancy_max": max(self.cache_occupancy, default=0.0),
            "preemptions": float(self.preemptions),
            "swap_out_bytes": float(self.swap_out_bytes),
            "swap_in_bytes": float(self.swap_in_bytes),
            "stall_s": self.stall_s,
            "prefix_hit_tokens": float(self.prefix_hit_tokens),
            "cow_copies": float(self.cow_copies),
            "resume_commits": float(self.resume_commits),
            "packed_resumes": float(self.packed_resumes),
        }
