"""Structured event tracing for the continuous-batching serving runtime.

`ServeMetrics` answers "how did the run go" with end-of-run aggregates; this
module answers "where did request 17's nine seconds go" with a per-event
record of everything the scheduler, allocator and step dispatcher decided,
stamped against the ENGINE clock (wall time for real serving, virtual time
for deterministic replays — the same injectable `now_fn` the runtime already
uses, so a traced virtual replay is reproducible event-for-event).

Three pieces:

  * `TraceRecorder` — an append-only list of typed `TraceEvent`s.  The
    event taxonomy (`EVENT_TYPES`) covers the full request lifecycle
    (`submit` / `reject` / `admit` / `chunk_scheduled` / `chunk_committed` /
    `first_token` / `decode_token` / `finish`), preemption
    (`preempt` / `swap_out` / `swap_in` / `resume`), pool accounting
    (`block_alloc` / `block_extend` / `block_free` / `block_share` /
    `cow_copy`), and per-step dispatch
    (`step_begin` / `step_end` with step kind, lane width, segment count,
    fill and device time, plus `compile` when a step program traces).
    Unknown event names are rejected loudly — the audit layer
    (`repro.serve.traceview`) depends on the taxonomy being closed.
  * `NullTraceRecorder` / `NULL_RECORDER` — the disabled path.  Emission
    sites hold a recorder attribute and either call its no-op `emit` or
    guard per-token hot loops on the recorder's `enabled` flag, so serving
    with tracing off costs one attribute lookup per site and allocates
    nothing.
  * the Chrome-trace-event exporter (`to_chrome_trace` / `write_trace`) —
    a whole Poisson replay opens in `ui.perfetto.dev`: one track per
    request (queued / prefill / stall / decode phase spans plus lifecycle
    instants), a scheduler track of step spans (unified vs decode-only,
    lane fill in the args), and a KV-pool counter track of free blocks.
    `write_trace` also embeds the raw event stream and a `ServeMetrics`
    snapshot under the `reproServe` key — unknown top-level keys are
    ignored by Perfetto, and the audit CLI
    (`python -m repro.serve.traceview trace.json`) reads them back to
    cross-validate the trace against the recorded aggregates.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, List, Optional, Tuple

# The closed event taxonomy.  Grouped by the subsystem that emits them.
EVENT_TYPES = frozenset({
    # request lifecycle (scheduler.py / runtime.py)
    "submit",          # rid, arrival, prompt_len, max_new
                       #   [+ temperature, top_k, top_p, seed when sampled]
    "reject",          # rid, reason
    "admit",           # rid, slot, kind ("fresh"|"resume"[, stall_s])
    "chunk_scheduled",  # rid, start, n        (one per packed segment)
    "chunk_committed",  # rid, start, n, prefilled
    "first_token",     # rid, token
    "decode_token",    # rid, token
    "finish",          # rid, n_output, digest  (the terminal event; digest
                       #   = stream_digest of the full output stream)
    # preemption / swap (runtime.py / kvcache.py)
    "preempt",         # rid, slot
    "swap_out",        # rid, nbytes, n_blocks
    "swap_in",         # rid, nbytes
    "resume",          # rid, stall_s, swap_in_s
    # pool accounting (kvcache.py BlockAllocator).  `free_after` on every
    # event lets the audit replay pool conservation step by step; under
    # refcounting a free only `released` the blocks whose last owner let
    # go (absent on pre-sharing traces — then released == n).
    "block_alloc",     # rid, n, free_after
    "block_extend",    # rid, n, free_after
    "block_free",      # rid, n, released, free_after
    "block_share",     # rid, n, revived, free_after  (prefix adoption:
                       #   only the `revived` blocks left the free list)
    "cow_copy",        # rid, n, free_after  (copy-on-write: n fresh blocks
                       #   claimed; the old blocks keep their other owners)
    # step dispatch (runtime.py)
    "step_begin",      # step, kind ("unified"|"decode_only"), lane_width,
                       #   segments, chunk_tokens, decode_rows
    "step_end",        # step, kind, ... as begin, plus device_s
    "compile",         # program ("unified"|"decode_only"|"commit"), device_s
})


def stream_digest(tokens) -> str:
    """Order-sensitive 64-bit FNV-1a digest of a token stream, hex-encoded.

    Stamped on every `finish` event so a trace pins the exact bytes of each
    request's output, not just its length; the audit layer recomputes it
    from the per-token events (`first_token` + `decode_token` in stream
    order) and flags any divergence.  With keyed sampling this is what
    makes a recorded sampled run *checkably* replayable."""
    h = 0xCBF29CE484222325
    for t in tokens:
        for b in int(t).to_bytes(4, "little", signed=True):
            h ^= b
            h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return f"{h:016x}"


@dataclasses.dataclass
class TraceEvent:
    """One recorded event: taxonomy name, engine-clock timestamp, the
    request it concerns (None for scheduler/pool-scoped events), and the
    event type's extra fields."""
    name: str
    t: float
    rid: Optional[int] = None
    fields: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        out = {"name": self.name, "t": self.t}
        if self.rid is not None:
            out["rid"] = self.rid
        out.update(self.fields)
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TraceEvent":
        d = dict(d)
        name = d.pop("name")
        t = d.pop("t")
        rid = d.pop("rid", None)
        return cls(name, t, rid, d)


class TraceRecorder:
    """Append-only structured event recorder on the engine clock.

    `now_fn` defaults to None; the engine binds its own clock at
    construction (`ContinuousEngine(..., trace=rec)`), so events recorded
    under a virtual-clock replay carry virtual timestamps.  Pass `t=`
    explicitly to stamp an event at a known instant instead."""

    enabled = True

    def __init__(self, now_fn=None):
        self.now_fn = now_fn
        self.events: List[TraceEvent] = []

    def emit(self, name: str, t: Optional[float] = None,
             rid: Optional[int] = None, **fields) -> None:
        if name not in EVENT_TYPES:
            raise ValueError(f"unknown trace event type {name!r}; the "
                             f"taxonomy is closed (see trace.EVENT_TYPES)")
        if t is None:
            t = self.now_fn() if self.now_fn is not None else time.perf_counter()
        self.events.append(TraceEvent(name, t, rid, fields))

    def clear(self) -> None:
        """Drop recorded events (e.g. after an engine warm-up pass)."""
        self.events = []

    def __len__(self) -> int:
        return len(self.events)


class NullTraceRecorder:
    """The disabled recorder: every emission site's `self.trace.emit(...)`
    is a no-op call, and hot per-token loops skip even that by checking
    the `enabled` flag — one attribute lookup on the disabled path."""

    enabled = False
    events: Tuple = ()

    def emit(self, name: str, t: Optional[float] = None,
             rid: Optional[int] = None, **fields) -> None:
        pass

    def clear(self) -> None:
        pass

    def __len__(self) -> int:
        return 0


NULL_RECORDER = NullTraceRecorder()


# --------------------------------------------------------------- metrics I/O
def metrics_snapshot(metrics) -> Dict[str, Any]:
    """A JSON-serializable `ServeMetrics` snapshot for embedding next to a
    trace: the scalar summary plus the raw per-request sample lists the
    audit recomputes from events (TTFT, latency)."""
    snap = dict(metrics.summary())
    snap["family"] = getattr(metrics, "family", "decoder")
    snap["ttfts_s"] = list(metrics.ttfts_s)
    snap["latencies_s"] = list(metrics.latencies_s)
    return snap


# ------------------------------------------------------- Chrome trace export
# Perfetto/chrome://tracing process ids: one "process" per track family.
PID_REQUESTS = 1
PID_SCHEDULER = 2
PID_POOL = 3


def _us(t: float, t0: float) -> float:
    return (t - t0) * 1e6


def _request_track_events(events: List[TraceEvent], t0: float) -> List[dict]:
    """Per-request phase spans + lifecycle instants, one thread per rid."""
    out: List[dict] = []
    # minimal per-rid lifecycle for span building (the audit layer owns the
    # rigorous reconstruction; here we only need phase boundaries)
    arr: Dict[int, float] = {}
    first_admit: Dict[int, float] = {}
    first_token: Dict[int, float] = {}
    finish: Dict[int, float] = {}
    stalls: Dict[int, List[List[float]]] = {}
    for e in events:
        r = e.rid
        if e.name == "submit":
            arr[r] = e.fields.get("arrival", e.t)
        elif e.name == "admit":
            first_admit.setdefault(r, e.t)
            open_stalls = stalls.get(r, [])
            if open_stalls and len(open_stalls[-1]) == 1:
                open_stalls[-1].append(e.t)
        elif e.name == "preempt":
            stalls.setdefault(r, []).append([e.t])
        elif e.name == "first_token":
            first_token.setdefault(r, e.t)
        elif e.name == "finish":
            finish[r] = e.t

    def span(rid, name, a, b):
        if a is None or b is None or b < a:
            return
        out.append({"name": name, "ph": "X", "pid": PID_REQUESTS, "tid": rid,
                    "ts": _us(a, t0), "dur": max(0.0, (b - a) * 1e6)})

    for rid in sorted(arr):
        span(rid, "queued", arr.get(rid), first_admit.get(rid))
        span(rid, "prefill", first_admit.get(rid), first_token.get(rid))
        span(rid, "decode", first_token.get(rid), finish.get(rid))
        for iv in stalls.get(rid, []):
            if len(iv) == 2:
                span(rid, "stall", iv[0], iv[1])

    instant = {"submit", "admit", "first_token", "preempt", "swap_out",
               "swap_in", "resume", "chunk_committed", "finish", "reject"}
    for e in events:
        if e.rid is None or e.name not in instant:
            continue
        out.append({"name": e.name, "ph": "i", "s": "t",
                    "pid": PID_REQUESTS, "tid": e.rid,
                    "ts": _us(e.t, t0), "args": dict(e.fields)})
    return out


def _scheduler_track_events(events: List[TraceEvent], t0: float) -> List[dict]:
    """Step spans (unified / decode-only) + compile instants."""
    out: List[dict] = []
    begins: Dict[int, TraceEvent] = {}
    for e in events:
        if e.name == "step_begin":
            begins[e.fields["step"]] = e
        elif e.name == "step_end":
            b = begins.pop(e.fields["step"], None)
            ts = _us((b or e).t, t0)
            dur = (e.t - b.t) * 1e6 if b is not None else 0.0
            if dur <= 0.0:
                # virtual-clock replays advance the clock BETWEEN steps, so
                # begin/end coincide; fall back to measured device time
                dur = e.fields.get("device_s", 0.0) * 1e6
            out.append({"name": f"step:{e.fields.get('kind', '?')}",
                        "ph": "X", "pid": PID_SCHEDULER, "tid": 0,
                        "ts": ts, "dur": dur, "args": dict(e.fields)})
        elif e.name == "compile":
            out.append({"name": f"compile:{e.fields.get('program', '?')}",
                        "ph": "i", "s": "p", "pid": PID_SCHEDULER, "tid": 1,
                        "ts": _us(e.t, t0), "args": dict(e.fields)})
    return out


def _pool_track_events(events: List[TraceEvent], t0: float) -> List[dict]:
    """Free-block counter track from the allocator's accounting events."""
    out: List[dict] = []
    for e in events:
        if e.name in ("block_alloc", "block_extend", "block_free",
                      "block_share", "cow_copy"):
            out.append({"name": "free_blocks", "ph": "C",
                        "pid": PID_POOL, "tid": 0, "ts": _us(e.t, t0),
                        "args": {"free": e.fields.get("free_after", 0)}})
    return out


def to_chrome_trace(events: List[TraceEvent]) -> List[dict]:
    """Chrome-trace-event list (the `traceEvents` array): request tracks,
    scheduler step track, KV-pool counter track.  Timestamps are rebased to
    the earliest event so wall-clock and virtual-clock traces both open at
    t=0 in Perfetto."""
    if not events:
        return []
    t0 = min(e.t for e in events)
    for e in events:
        if e.name == "submit":
            t0 = min(t0, e.fields.get("arrival", e.t))
    out: List[dict] = []
    for pid, name in ((PID_REQUESTS, "requests"),
                      (PID_SCHEDULER, "scheduler"),
                      (PID_POOL, "kv pool")):
        out.append({"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                    "args": {"name": name}})
    for rid in sorted({e.rid for e in events if e.rid is not None}):
        out.append({"name": "thread_name", "ph": "M", "pid": PID_REQUESTS,
                    "tid": rid, "args": {"name": f"req {rid}"}})
    out.append({"name": "thread_name", "ph": "M", "pid": PID_SCHEDULER,
                "tid": 0, "args": {"name": "steps"}})
    out.append({"name": "thread_name", "ph": "M", "pid": PID_SCHEDULER,
                "tid": 1, "args": {"name": "compiles"}})
    out.extend(_request_track_events(events, t0))
    out.extend(_scheduler_track_events(events, t0))
    out.extend(_pool_track_events(events, t0))
    return out


def write_trace(path: str, events: List[TraceEvent], metrics=None,
                metadata: Optional[Dict[str, Any]] = None) -> None:
    """Write a Chrome-trace-event JSON file that also carries the raw event
    stream, a `ServeMetrics` snapshot, and run metadata under the
    `reproServe` key (ignored by Perfetto, consumed by the audit CLI)."""
    if metrics is not None and not isinstance(metrics, dict):
        metrics = metrics_snapshot(metrics)
    payload = {
        "traceEvents": to_chrome_trace(events),
        "displayTimeUnit": "ms",
        "reproServe": {
            "events": [e.to_dict() for e in events],
            "metrics": metrics,
            "metadata": metadata or {},
        },
    }
    with open(path, "w") as f:
        json.dump(payload, f)


def load_trace(path: str):
    """Read back a `write_trace` file: (events, metrics dict or None,
    metadata dict)."""
    with open(path) as f:
        payload = json.load(f)
    raw = payload.get("reproServe", {})
    events = [TraceEvent.from_dict(d) for d in raw.get("events", [])]
    return events, raw.get("metrics"), raw.get("metadata", {})
