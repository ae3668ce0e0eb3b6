"""Trace audit: reconstruct per-request lifecycles from a serve event trace
and cross-validate them against `ServeMetrics` aggregates — the port of
`repro.serve.traceview`, over the port's `serve.trace` (whose events and
file format are the reference's).

The differential tests pin that scheduling choices are invisible to the
TOKENS (byte-identical greedy streams); this module pins that they are
faithfully VISIBLE to the trace: every number `ServeMetrics` reports must be
recomputable from the event stream alone.  Checks:

  * **terminal** — every `admit`ed request reaches exactly one `finish`
    event, preceded by exactly one `first_token`;
  * **timing** — per-request TTFT / completion latency recomputed purely
    from events (`first_token.t - arrival`, `finish.t - arrival`) match the
    recorded `ServeMetrics` sample lists, and total stall time recomputed
    from `preempt` -> resume-`admit` intervals matches `stall_s`;
  * **tokens** — `first_token` + `decode_token` event counts reproduce
    `tokens_out`, per-request token events match each `finish` event's
    `n_output`, and committed `chunk_committed` tokens reproduce
    `chunk_tokens_committed` (each request's chunks covering exactly
    [0, prompt_len) in order);
  * **sampling** — each `finish` event's `digest` (FNV-1a over the token
    stream, stamped at retirement) matches the digest recomputed from the
    `first_token`/`decode_token` events' token values, pinning that the
    trace records the EXACT stream a replay must reproduce; and every
    sampled submit (temperature > 0) carries its `seed`, without which a
    recorded run is not replayable;
  * **pool** — replaying `block_alloc` / `block_extend` / `block_free` /
    `block_share` / `cow_copy` against a free-block counter reproduces
    every event's recorded `free_after`, no request's holding goes
    negative, and a completed run returns the pool to its initial free
    level.  The replay is REFCOUNT-aware: a share only removes its
    `revived` blocks from the free level (live matches just gain an
    owner), a free only returns its `released` blocks (co-owned blocks
    stay out), and a CoW claims one fresh block without releasing the old
    (its other owners keep it) — so a forged share (claiming more free
    blocks than it revived, or reviving blocks that were never free)
    breaks the `free_after` chain and fails the audit;
  * **dispatch** — `step_end` events with kind `decode_only` carried zero
    segments and zero chunk tokens, and their count matches
    `decode_only_steps` (same for `chunk_steps` / unified);
  * **family** — lifecycle and step events carry ONE consistent serving
    family tag ("decoder" | "ssm"; events from traces recorded before the
    family seam carry none and default to "decoder"), matching the
    snapshot's recorded family — the same audit holds for both engine
    families;
  * **export** — the Chrome-trace-event export is valid (JSON-serializable,
    required keys per event).

`attribution_rows` / `format_attribution` turn the lifecycles into the
per-request time-attribution table (queued / prefill / stalled / decode
fractions) `bench_serving.py --trace` prints.

CLI:

    PYTHONPATH=src python -m repro_torch.serve.traceview out.json
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.serve.trace import (TraceEvent, metrics_snapshot, stream_digest,
                               to_chrome_trace)

_TOL = 1e-6


@dataclasses.dataclass
class Lifecycle:
    """One request's reconstructed lifecycle, built purely from events."""
    rid: int
    arrival: Optional[float] = None
    submit_t: Optional[float] = None
    prompt_len: Optional[int] = None
    admits: List[Tuple[float, str]] = dataclasses.field(default_factory=list)
    preempts: List[float] = dataclasses.field(default_factory=list)
    stalls: List[Tuple[float, float]] = dataclasses.field(default_factory=list)
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    n_output: Optional[int] = None
    decode_tokens: int = 0
    first_tokens: int = 0
    chunks: List[Tuple[float, int, int]] = dataclasses.field(
        default_factory=list)   # (t, start, n) per chunk_committed
    # sampled-replay state: the token values in emission order, the finish
    # event's stream digest, and whether the submit carried sampling knobs
    tokens: List[int] = dataclasses.field(default_factory=list)
    digest: Optional[str] = None
    sampled: bool = False
    has_seed: bool = False
    shared_blocks: int = 0   # prefix blocks adopted via block_share events

    # ------------------------------------------------- event-derived timing
    @property
    def ttft_s(self) -> float:
        if self.first_token_t is None or self.arrival is None:
            return math.nan
        return self.first_token_t - self.arrival

    @property
    def latency_s(self) -> float:
        if self.finish_t is None or self.arrival is None:
            return math.nan
        return self.finish_t - self.arrival

    @property
    def stall_s(self) -> float:
        return sum(b - a for a, b in self.stalls)

    @property
    def queued_s(self) -> float:
        if not self.admits or self.arrival is None:
            return math.nan
        return self.admits[0][0] - self.arrival

    def _stall_split(self) -> Tuple[float, float]:
        """(stall during prefill, stall during decode): a preemption that
        began before the first token stalled the prompt, later ones stall
        decoding."""
        pre = dec = 0.0
        for a, b in self.stalls:
            if self.first_token_t is not None and a >= self.first_token_t:
                dec += b - a
            else:
                pre += b - a
        return pre, dec

    @property
    def prefill_s(self) -> float:
        if self.first_token_t is None or not self.admits:
            return math.nan
        return self.first_token_t - self.admits[0][0] - self._stall_split()[0]

    @property
    def decode_s(self) -> float:
        if self.finish_t is None or self.first_token_t is None:
            return math.nan
        return self.finish_t - self.first_token_t - self._stall_split()[1]


def build_lifecycles(events: List[TraceEvent]) -> Dict[int, Lifecycle]:
    """Fold the event stream into per-request lifecycles (pure function of
    the trace; `ServeMetrics` is never consulted)."""
    lcs: Dict[int, Lifecycle] = {}

    def lc(rid: int) -> Lifecycle:
        if rid not in lcs:
            lcs[rid] = Lifecycle(rid)
        return lcs[rid]

    for e in events:
        r = e.rid
        if e.name == "submit":
            x = lc(r)
            x.submit_t = e.t
            x.arrival = e.fields.get("arrival", e.t)
            x.prompt_len = e.fields.get("prompt_len")
            x.sampled = e.fields.get("temperature", 0.0) > 0.0
            x.has_seed = "seed" in e.fields
        elif e.name == "admit":
            x = lc(r)
            x.admits.append((e.t, e.fields.get("kind", "fresh")))
            if x.preempts and len(x.stalls) < len(x.preempts):
                x.stalls.append((x.preempts[len(x.stalls)], e.t))
        elif e.name == "preempt":
            lc(r).preempts.append(e.t)
        elif e.name == "first_token":
            x = lc(r)
            x.first_tokens += 1
            if x.first_token_t is None:
                x.first_token_t = e.t
            if "token" in e.fields:
                x.tokens.append(int(e.fields["token"]))
        elif e.name == "decode_token":
            x = lc(r)
            x.decode_tokens += 1
            if "token" in e.fields:
                x.tokens.append(int(e.fields["token"]))
        elif e.name == "chunk_committed":
            lc(r).chunks.append((e.t, e.fields.get("start", 0),
                                 e.fields.get("n", 0)))
        elif e.name == "block_share":
            lc(r).shared_blocks += e.fields.get("n", 0)
        elif e.name == "finish":
            x = lc(r)
            x.finish_t = e.t
            x.n_output = e.fields.get("n_output")
            x.digest = e.fields.get("digest")
    return lcs


@dataclasses.dataclass
class AuditReport:
    violations: List[str]
    lifecycles: Dict[int, Lifecycle]
    checks: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.violations

    def summary(self) -> str:
        head = (f"trace audit: {'PASS' if self.ok else 'FAIL'} — "
                f"{len(self.lifecycles)} requests, "
                + ", ".join(f"{k}={v}" for k, v in sorted(self.checks.items())))
        if self.violations:
            head += "\n" + "\n".join(f"  VIOLATION: {v}"
                                     for v in self.violations)
        return head


def _close(a: float, b: float, tol: float = _TOL) -> bool:
    return abs(a - b) <= tol * max(1.0, abs(a), abs(b))


def _match_samples(name: str, got: List[float], want: List[float],
                   violations: List[str]) -> None:
    got, want = sorted(got), sorted(want)
    if len(got) != len(want):
        violations.append(f"{name}: {len(got)} event-derived samples vs "
                          f"{len(want)} recorded")
        return
    for g, w in zip(got, want):
        if not _close(g, w):
            violations.append(f"{name}: event-derived {g!r} != recorded {w!r}")
            return


def _audit_lifecycles(lcs: Dict[int, Lifecycle], violations: List[str],
                      block_size: Optional[int] = None) -> None:
    for rid, x in sorted(lcs.items()):
        if x.submit_t is None:
            violations.append(f"req {rid}: events without a submit")
        if not x.admits:
            if x.finish_t is not None:
                violations.append(f"req {rid}: finished without an admit")
            continue
        if x.finish_t is None:
            violations.append(f"req {rid}: admitted but never reached a "
                              "terminal finish event")
            continue
        if x.first_tokens != 1:
            violations.append(f"req {rid}: {x.first_tokens} first_token "
                              "events (want exactly 1)")
        if x.n_output is not None \
                and x.first_tokens + x.decode_tokens != x.n_output:
            violations.append(
                f"req {rid}: {x.first_tokens}+{x.decode_tokens} token events "
                f"!= finish n_output {x.n_output}")
        # replay pin: the finish digest must match the digest of the token
        # VALUES the first_token/decode_token events recorded (only
        # checkable when every token event carried its value)
        if x.digest is not None \
                and len(x.tokens) == x.first_tokens + x.decode_tokens:
            got = stream_digest(x.tokens)
            if got != x.digest:
                violations.append(
                    f"req {rid}: token-event digest {got} != finish "
                    f"digest {x.digest} — trace does not pin the stream")
        if x.sampled and not x.has_seed:
            violations.append(
                f"req {rid}: sampled submit (temperature > 0) without a "
                "seed — run is not replayable from the trace")
        if len(x.stalls) != len(x.preempts):
            violations.append(f"req {rid}: {len(x.preempts)} preempts but "
                              f"{len(x.stalls)} resume intervals")
        resumes = sum(1 for _, kind in x.admits if kind == "resume")
        if resumes != len(x.preempts):
            violations.append(f"req {rid}: {len(x.preempts)} preempts but "
                              f"{resumes} resume admits")
        # chunk coverage: committed segments tile [adopted, prompt_len) in
        # order, where `adopted` is 0 unless the request shared prefix
        # blocks at admission (then its first chunk begins at the adoption
        # point — min(shared_blocks * block_size, prompt_len - 1) when the
        # trace metadata pins the block size, else wherever the first chunk
        # says, as long as a share justifies the skip)
        if x.chunks and x.prompt_len is not None:
            pos = 0
            if x.shared_blocks:
                if block_size is not None:
                    pos = min(x.shared_blocks * block_size,
                              x.prompt_len - 1)
                else:
                    first = x.chunks[0][1]
                    if 0 < first < x.prompt_len:
                        pos = first
            for _, start, n in x.chunks:
                if start != pos:
                    violations.append(f"req {rid}: chunk committed at "
                                      f"{start}, expected {pos}")
                    break
                pos += n
            else:
                if pos != x.prompt_len:
                    violations.append(
                        f"req {rid}: chunks committed {pos} of "
                        f"{x.prompt_len} prompt tokens")


def _pool_free_delta(e: TraceEvent) -> int:
    """How the event moved the free-block level, refcount-aware: frees
    return only the blocks whose last owner let go (`released`; absent on
    pre-sharing traces, where every freed block released), shares remove
    only their `revived` blocks (live matches just gain an owner), CoW
    claims `n` fresh blocks and releases none (the old blocks keep their
    other owners)."""
    n = e.fields["n"]
    if e.name == "block_free":
        return e.fields.get("released", n)
    if e.name == "block_share":
        return -e.fields.get("revived", 0)
    return -n   # block_alloc / block_extend / cow_copy


def _audit_pool(events: List[TraceEvent], metadata: Dict[str, Any],
                violations: List[str], checks: Dict[str, Any]) -> None:
    block_events = [e for e in events if e.name in
                    ("block_alloc", "block_extend", "block_free",
                     "block_share", "cow_copy")]
    if not block_events:
        return
    free = metadata.get("usable_blocks")
    if free is None:
        # infer the initial level from the first event's recorded state
        e0 = block_events[0]
        free = e0.fields["free_after"] - _pool_free_delta(e0)
    initial = free
    held: Dict[int, int] = {}
    for e in block_events:
        n = e.fields["n"]
        if n < 0:
            violations.append(f"{e.name} rid {e.rid}: negative count {n}")
            continue
        if e.name == "block_free":
            released = e.fields.get("released", n)
            if released > n:
                violations.append(f"block_free rid {e.rid}: released "
                                  f"{released} > freed {n}")
            held[e.rid] = held.get(e.rid, 0) - n
            if held[e.rid] < 0:
                violations.append(f"req {e.rid}: freed {n} blocks beyond "
                                  "its holding")
        elif e.name == "block_share":
            revived = e.fields.get("revived", 0)
            if revived > n:
                violations.append(f"block_share rid {e.rid}: revived "
                                  f"{revived} > adopted {n}")
            held[e.rid] = held.get(e.rid, 0) + n
        elif e.name == "cow_copy":
            # one fresh block swaps in for each shared one: the holding
            # count is unchanged and nothing returns to the free list
            pass
        else:
            held[e.rid] = held.get(e.rid, 0) + n
        free += _pool_free_delta(e)
        if free < 0:
            violations.append(f"{e.name} rid {e.rid}: free count went "
                              f"negative ({free})")
        if free != e.fields["free_after"]:
            violations.append(
                f"{e.name} rid {e.rid}: modeled free {free} != recorded "
                f"free_after {e.fields['free_after']}")
            free = e.fields["free_after"]   # resync to localize reports
    leaked = {r: h for r, h in held.items() if h != 0}
    if leaked:
        violations.append(f"pool accounting leaked blocks at end of trace: "
                          f"{leaked}")
    if free != initial:
        violations.append(f"pool free count ended at {free}, started at "
                          f"{initial}")
    checks["block_events"] = len(block_events)


def _audit_steps(events: List[TraceEvent], violations: List[str],
                 checks: Dict[str, Any]) -> Dict[str, int]:
    begins: Dict[int, TraceEvent] = {}
    kinds = {"unified": 0, "decode_only": 0}
    for e in events:
        if e.name == "step_begin":
            if e.fields["step"] in begins:
                violations.append(f"step {e.fields['step']}: duplicate "
                                  "step_begin")
            begins[e.fields["step"]] = e
        elif e.name == "step_end":
            b = begins.pop(e.fields["step"], None)
            if b is None:
                violations.append(f"step {e.fields['step']}: step_end "
                                  "without step_begin")
            elif b.fields.get("kind") != e.fields.get("kind"):
                violations.append(f"step {e.fields['step']}: kind changed "
                                  "between begin and end")
            kind = e.fields.get("kind")
            if kind in kinds:
                kinds[kind] += 1
            if kind == "decode_only" and (
                    e.fields.get("segments", 0) != 0
                    or e.fields.get("chunk_tokens", 0) != 0):
                violations.append(
                    f"step {e.fields['step']}: decode_only step carried "
                    f"{e.fields.get('segments')} segments / "
                    f"{e.fields.get('chunk_tokens')} chunk tokens")
    if begins:
        violations.append(f"{len(begins)} step_begin events never ended: "
                          f"{sorted(begins)[:5]}")
    checks.update(unified_steps=kinds["unified"],
                  decode_only_steps=kinds["decode_only"])
    return kinds


def audit(events: List[TraceEvent], metrics=None,
          metadata: Optional[Dict[str, Any]] = None) -> AuditReport:
    """Audit a trace's internal invariants and (when `metrics` is given —
    a `ServeMetrics` or its `metrics_snapshot` dict) cross-validate the
    event-derived request timings and counters against the recorded
    aggregates.  Assumes a COMPLETED run: every admitted request must have
    terminated."""
    if metrics is not None and not isinstance(metrics, dict):
        metrics = metrics_snapshot(metrics)
    metadata = metadata or {}
    violations: List[str] = []
    checks: Dict[str, Any] = {}

    lcs = build_lifecycles(events)
    _audit_lifecycles(lcs, violations, metadata.get("block_size"))
    _audit_pool(events, metadata, violations, checks)
    kinds = _audit_steps(events, violations, checks)
    checks["requests"] = len(lcs)
    checks["sampled_requests"] = sum(1 for x in lcs.values() if x.sampled)

    # family consistency: one engine serves one family; absent tags are
    # pre-seam traces, i.e. the decoder family
    fams = {e.fields.get("family", "decoder") for e in events
            if e.name in ("submit", "admit", "preempt", "finish",
                          "step_begin", "step_end")}
    if len(fams) > 1:
        violations.append(
            f"mixed serving families in one trace: {sorted(fams)}")
    checks["family"] = sorted(fams)[0] if fams else "decoder"
    if metrics is not None and isinstance(metrics, dict):
        mfam = metrics.get("family", "decoder")
        if fams and mfam not in fams:
            violations.append(f"metrics family {mfam!r} not among event "
                              f"families {sorted(fams)}")

    # mesh consistency: one engine runs one mesh for its whole life; absent
    # tags are pre-mesh traces, i.e. a single device ("<data>x<model>")
    meshes = {e.fields.get("mesh", "1x1") for e in events
              if e.name in ("step_begin", "step_end")}
    if len(meshes) > 1:
        violations.append(f"mixed meshes in one trace: {sorted(meshes)}")
    checks["mesh"] = sorted(meshes)[0] if meshes else "1x1"
    md_mesh = metadata.get("mesh")
    if md_mesh is not None and meshes and md_mesh not in meshes:
        violations.append(f"metadata mesh {md_mesh!r} not among step-event "
                          f"meshes {sorted(meshes)}")

    finished = [x for x in lcs.values() if x.finish_t is not None]
    if metrics is not None:
        _match_samples("ttft", [x.ttft_s for x in finished
                                if x.first_token_t is not None],
                       metrics.get("ttfts_s", []), violations)
        _match_samples("latency", [x.latency_s for x in finished],
                       metrics.get("latencies_s", []), violations)
        stall = sum(x.stall_s for x in lcs.values())
        if not _close(stall, metrics.get("stall_s", 0.0)):
            violations.append(f"stall: event-derived {stall!r} != recorded "
                              f"{metrics.get('stall_s')!r}")
        tokens = sum(x.first_tokens + x.decode_tokens for x in lcs.values())
        if tokens != int(metrics.get("tokens_out", 0)):
            violations.append(f"tokens_out: {tokens} token events vs "
                              f"recorded {metrics.get('tokens_out')}")
        if len(finished) != int(metrics.get("requests", len(finished))):
            violations.append(f"requests: {len(finished)} finish events vs "
                              f"recorded {metrics.get('requests')}")
        preempts = sum(len(x.preempts) for x in lcs.values())
        if preempts != int(metrics.get("preemptions", 0)):
            violations.append(f"preemptions: {preempts} preempt events vs "
                              f"recorded {metrics.get('preemptions')}")
        if "cow_copies" in metrics:   # absent on pre-sharing snapshots
            cows = sum(e.fields.get("n", 1) for e in events
                       if e.name == "cow_copy")
            if cows != int(metrics["cow_copies"]):
                violations.append(f"cow_copies: {cows} cow_copy events vs "
                                  f"recorded {metrics.get('cow_copies')}")
        committed = sum(n for x in lcs.values() for _, _, n in x.chunks)
        if committed != int(metrics.get("chunk_tokens_committed", 0)):
            violations.append(
                f"chunk_tokens_committed: {committed} from events vs "
                f"recorded {metrics.get('chunk_tokens_committed')}")
        firsts = sum(x.first_tokens for x in lcs.values())
        if firsts != int(metrics.get("prefills", 0)):
            violations.append(f"prefills: {firsts} first_token events vs "
                              f"recorded {metrics.get('prefills')}")
        for key, kind in (("decode_only_steps", "decode_only"),
                          ("chunk_steps", "unified")):
            if kinds[kind] != int(metrics.get(key, 0)):
                violations.append(f"{key}: {kinds[kind]} {kind} step_end "
                                  f"events vs recorded {metrics.get(key)}")

    # Chrome-trace-event export validity
    try:
        chrome = to_chrome_trace(events)
        json.dumps(chrome)
        for ev in chrome:
            if "ph" not in ev or "pid" not in ev or "name" not in ev:
                violations.append(f"chrome event missing required keys: {ev}")
                break
            if ev["ph"] != "M" and "ts" not in ev:
                violations.append(f"chrome event missing ts: {ev}")
                break
        checks["chrome_events"] = len(chrome)
    except (TypeError, ValueError, KeyError) as exc:
        violations.append(f"chrome trace export failed: {exc!r}")

    return AuditReport(violations, lcs, checks)


# --------------------------------------------------------------- attribution
def attribution_rows(lcs: Dict[int, Lifecycle]) -> List[Dict[str, float]]:
    """Per-request time attribution: where each finished request's latency
    went (queued / prefill / stalled / decode seconds and fractions)."""
    rows = []
    for rid in sorted(lcs):
        x = lcs[rid]
        if x.finish_t is None or x.arrival is None or not x.admits:
            continue
        parts = {"queued_s": x.queued_s, "prefill_s": x.prefill_s,
                 "stall_s": x.stall_s, "decode_s": x.decode_s}
        total = x.latency_s
        row = {"rid": rid, "total_s": total, **parts}
        for k, v in parts.items():
            row[k.replace("_s", "_frac")] = \
                (v / total) if total > 0 else 0.0
        rows.append(row)
    return rows


def format_attribution(lcs: Dict[int, Lifecycle]) -> str:
    """The per-request time-attribution table `bench_serving.py --trace`
    prints: one line per request, latency split into phases."""
    rows = attribution_rows(lcs)
    if not rows:
        return "(no finished requests in trace)"
    lines = [f"{'rid':>5} {'total_s':>8} {'queued':>7} {'prefill':>8} "
             f"{'stall':>7} {'decode':>7}"]
    for r in rows:
        lines.append(
            f"{r['rid']:>5} {r['total_s']:>8.3f} {r['queued_frac']:>6.0%} "
            f"{r['prefill_frac']:>7.0%} {r['stall_frac']:>6.0%} "
            f"{r['decode_frac']:>6.0%}")
    return "\n".join(lines)


# ----------------------------------------------------------------------- CLI
def main(argv: Optional[List[str]] = None) -> int:
    """Audit a trace file written by `serve.trace.write_trace`; any
    invariant violation is a non-zero exit."""
    import argparse

    from repro_torch.serve.trace import load_trace

    ap = argparse.ArgumentParser(
        description="audit a serve trace (Chrome JSON with embedded events)")
    ap.add_argument("trace", help="path written by serve.trace.write_trace")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the per-request attribution table")
    args = ap.parse_args(argv)
    events, metrics, metadata = load_trace(args.trace)
    if not events:
        print(f"{args.trace}: no embedded serve events (was it written by "
              "serve.trace.write_trace?)")
        return 1
    report = audit(events, metrics=metrics, metadata=metadata)
    if not args.quiet:
        print(format_attribution(report.lifecycles))
    print(report.summary())
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
