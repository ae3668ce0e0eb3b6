"""The port's step programs and captured engine against the JAX package's
jitted ones.

The JAX engine serves every step from two compiled programs
(`_unified`, `_decode_only`), compiles nothing at admission, and traces
each compile; its own suites pin that with `_cache_size()`
(`tests/test_chunked_prefill.py`, `test_packed_prefill.py`,
`test_preemption.py`, `test_prefix_sharing.py`).  The port's programs
(`repro_torch.launch.program.Program`) capture one CUDA graph per input
signature on the GPU; on the CPU they run eagerly and record the
signatures they saw.  Here the reference's workloads run on the f32
`tiny` model of `tests/test_torch_serving.py` through both engines, and
the port's `_cache_size()` counts and `compile` trace events must equal the
JAX engine's wherever the reference asserts them, its streams the JAX
engine's token for token.  The resume commit and the copy-on-write are
programs too (`_commit`, `_cow`): their `_cache_size()` counts and the
commit program's `compile` events are compared with the reference's as
well, and after a resume the pools' non-sink blocks must equal the JAX
engine's.

The JAX engines run on a mesh built with Auto axis types (see
`tests/test_torch_serving.py`).
"""

import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, Mesh

from repro.configs import get_config as jax_get_config
from repro.distributed.sharding import DEFAULT_RULES
from repro.models import build_model
from repro.serve.runtime import ContinuousEngine as JaxEngine
from repro.serve.runtime import RuntimeConfig as JaxRuntimeConfig
from repro.serve.sampling import SamplingParams as JaxSamplingParams
from repro.serve.trace import TraceRecorder as JaxTraceRecorder
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import Engine
from repro_torch.kernels import build
from repro_torch.launch import steps
from repro_torch.launch.program import Program
from repro_torch.models import DecoderLM
from repro_torch.models.resnet import resnet18_graph
from repro_torch.serve.runtime import ContinuousEngine, RuntimeConfig
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.trace import TraceRecorder

STEP_PROGRAMS = ("unified", "decode_only")
# the programs whose `compile` trace events the two engines must share
TRACED_PROGRAMS = STEP_PROGRAMS + ("commit",)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_get_config("qwen3-1.7b").reduced(n_layers=2, d_model=64, d_ff=128,
                                                vocab=97, dtype="float32")
    tcfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)})
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, DecoderLM(tcfg), tparams


def _engines(tiny, clock=None, **rcfg):
    """(framework, engine, context) for the JAX engine and the port's, each
    recording a trace (and on a clock of its own from `clock()`)."""
    jmodel, jparams, model, params = tiny
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"),
                axis_types=(AxisType.Auto, AxisType.Auto))
    jeng = JaxEngine(jmodel, jparams, mesh, DEFAULT_RULES, JaxRuntimeConfig(**rcfg),
                     now_fn=clock() if clock else None, trace=JaxTraceRecorder())
    teng = ContinuousEngine(model, params, RuntimeConfig(**rcfg),
                            now_fn=clock() if clock else None,
                            trace=TraceRecorder(), device="cpu")
    return [("jax", jeng, mesh), ("port", teng, contextlib.nullcontext())]


def _step_compiles(eng):
    """[(program, step)] of the step and commit programs' `compile` events,
    each with the step during (or, for a commit, before) which it compiled
    (or captured)."""
    out, step = [], None
    for e in eng.trace.events:
        if e.name == "step_begin":
            step = e.fields["step"]
        elif e.name == "compile" and e.fields["program"] in TRACED_PROGRAMS:
            out.append((e.fields["program"], step))
    return out


def _sizes(eng):
    return eng._unified._cache_size(), eng._decode_only._cache_size()


def _commit_cow(eng):
    return eng._commit._cache_size(), eng._cow._cache_size()


def _streams(eng):
    return {r.rid: [int(t) for t in r.output] for r in eng._done}


def _run_both(tiny, drive, clock=None, **rcfg):
    """Drive the JAX engine and the port's through `drive(eng)` (which
    returns the program counts it read on the way); both must give the
    same counts, step-program compile events and streams.  -> the port's
    engine and what its drive returned."""
    got = {}
    for fw, eng, ctx in _engines(tiny, clock, **rcfg):
        with ctx:
            record = drive(eng)
        record.append(_sizes(eng))
        got[fw] = (record, _step_compiles(eng), _streams(eng), eng)
    assert got["port"][0] == got["jax"][0]
    assert got["port"][1] == got["jax"][1]
    assert got["port"][2] == got["jax"][2]
    eng = got["port"][3]
    eng.cache.alloc.check_invariants()
    assert eng.cache.alloc.num_used == 0
    return eng, got["port"][0]


def _prompts(seed, n, lo, hi, blo, bhi, vocab=97):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, size=int(rng.integers(lo, hi))).astype(np.int32)
               for _ in range(n)]
    return prompts, [int(rng.integers(blo, bhi)) for _ in prompts]


# ------------------------------------------- tests/test_chunked_prefill.py
def test_chunked_vs_unchunked_no_admission_compiles(tiny):
    """test_chunked_prefill.py::test_chunked_vs_unchunked_identity_and_no_admission_compiles"""
    prompts, budgets = _prompts(0, 6, 4, 24, 2, 12)

    def drive(eng):
        eng.submit(prompts[0], max_new_tokens=budgets[0])
        eng.step()                              # the unified program
        n = eng._unified._cache_size()
        for p, b in zip(prompts[1:], budgets[1:]):
            eng.submit(p, max_new_tokens=b)     # admissions mid-flight
        while eng.scheduler.has_work:
            eng.step()
        return [n]

    outs, chunks = {}, {}
    for label, ct in (("chunked", 5), ("unlimited", None)):
        eng, record = _run_both(tiny, drive, max_slots=3, block_size=8,
                                max_blocks_per_seq=6, max_new_tokens=16,
                                chunk_tokens=ct)
        assert record[0] == 1 and record[1][0] == 1, label
        assert _step_compiles(eng)[0] == ("unified", 0), label
        outs[label], chunks[label] = _streams(eng), eng.metrics.prefill_chunks
    assert outs["chunked"] == outs["unlimited"]
    assert chunks["chunked"] > len(prompts) == chunks["unlimited"]


def test_mid_prefill_preemption_recompiles_nothing(tiny):
    """test_chunked_prefill.py::test_mid_prefill_preemption_resumes_token_identical"""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 97, size=3).astype(np.int32) for _ in range(2)]
    prompts.append(rng.integers(0, 97, size=30).astype(np.int32))

    def drive(eng):
        for p in prompts:
            eng.submit(p, arrival_time=0.0)
        eng._done = eng.run()
        return []

    outs = {}
    for num_blocks in (8, None):
        eng, record = _run_both(tiny, drive, max_slots=3, block_size=8,
                                max_blocks_per_seq=6, num_blocks=num_blocks,
                                max_new_tokens=14, chunk_tokens=3)
        assert record[0][0] == 1
        outs[num_blocks] = _streams(eng)
        if num_blocks == 8:
            long_req = next(r for r in eng._done if r.rid == 3)
            assert eng.metrics.preemptions >= 1 and long_req.preemptions >= 1
    assert outs[8] == outs[None]


# -------------------------------------------- tests/test_packed_prefill.py
def test_packed_vs_single_segment_two_step_programs(tiny):
    """test_packed_prefill.py::test_packed_vs_single_segment_identity_and_two_step_programs"""
    prompts, budgets = _prompts(0, 7, 3, 14, 2, 10)

    def drive(eng):
        for p, b in zip(prompts, budgets):
            eng.submit(p, max_new_tokens=b, arrival_time=0.0)
        eng.step()                              # the unified program
        n = eng._unified._cache_size()
        while eng.scheduler.has_work:
            eng.step()
        return [n]

    outs, metrics = {}, {}
    for label, ct, segs in (("packed", 8, 4), ("single", 8, 1),
                            ("unlimited", None, 4)):
        eng, record = _run_both(tiny, drive, max_slots=4, block_size=8,
                                max_blocks_per_seq=6, max_new_tokens=10,
                                chunk_tokens=ct, chunk_segments=segs)
        assert record == [1, (1, 1)], label
        assert eng.metrics.decode_only_steps > 0, label
        assert [p for p, _ in _step_compiles(eng)] == list(STEP_PROGRAMS), label
        outs[label], metrics[label] = _streams(eng), eng.metrics
    assert outs["packed"] == outs["single"] == outs["unlimited"]
    assert metrics["packed"].packed_segments > 0 == metrics["single"].packed_segments


def test_decode_only_fast_path_program(tiny):
    """test_packed_prefill.py::test_decode_only_fast_path_dispatches_on_chunkless_steps"""
    prompt = np.random.default_rng(4).integers(0, 97, size=5).astype(np.int32)

    def drive(eng):
        eng.submit(prompt, arrival_time=0.0)
        eng.step()
        first = [eng.metrics.chunk_steps, eng.metrics.decode_only_steps,
                 eng._decode_only._cache_size()]
        while eng.scheduler.has_work:
            eng.step()
        return [first, eng.metrics.decode_only_steps]

    eng, record = _run_both(tiny, drive, max_slots=4, block_size=8,
                            max_blocks_per_seq=6, max_new_tokens=6,
                            chunk_tokens=8)
    assert record == [[1, 0, 0], 5, (1, 1)]
    assert _step_compiles(eng) == [("unified", 0), ("decode_only", 1)]
    assert len(eng._done) == 1 and len(eng._done[0].output) == 6


# ----------------------------------------------- tests/test_preemption.py
def test_preemption_recompiles_nothing(tiny):
    """test_preemption.py::test_preemption_differential_identity: the step
    programs and the commit program (`_commit._cache_size() == 1` after a
    preempting run, 0 with none), with the commit's `compile` event"""
    prompts, budgets = _prompts(0, 6, 6, 20, 8, 16)

    def drive(eng):
        for p, b in zip(prompts, budgets):
            eng.submit(p, max_new_tokens=b, arrival_time=0.0)
        eng._done = eng.run()
        return [eng.metrics.preemptions > 0, _commit_cow(eng)]

    outs = {}
    for num_blocks in (7, None):
        eng, record = _run_both(tiny, drive, max_slots=3, block_size=8,
                                max_blocks_per_seq=6, num_blocks=num_blocks,
                                max_new_tokens=16)
        assert record[0] == (num_blocks is not None)
        assert record[1] == ((1, 0) if num_blocks else (0, 0))
        assert record[2][0] == 1
        commits = [c for c in _step_compiles(eng) if c[0] == "commit"]
        assert len(commits) == (1 if num_blocks else 0)
        assert eng.metrics.resume_commits > (0 if num_blocks else -1)
        outs[num_blocks] = _streams(eng)
    assert outs[7] == outs[None]


def test_pools_after_a_resume_commit_equal_the_jax_engine(tiny):
    """After every resume commit the pools' non-sink blocks equal the JAX
    engine's (f32: the K/V the two frameworks computed differ by rounding
    only); the sink's contents are unspecified."""
    prompts, budgets = _prompts(0, 6, 6, 20, 8, 16)
    pools = {}
    for fw, eng, ctx in _engines(tiny, max_slots=3, block_size=8,
                                 max_blocks_per_seq=6, num_blocks=7,
                                 max_new_tokens=16):
        snaps = pools.setdefault(fw, [])
        orig = eng.adapter.resume_commit

        def commit(group, orig=orig, eng=eng, snaps=snaps):
            out = orig(group)
            snaps.append([np.array(t, dtype=np.float32)[:, 1:]
                          for t in (eng.cache.k, eng.cache.v)])
            return out

        eng.adapter.resume_commit = commit
        with ctx:
            for p, b in zip(prompts, budgets):
                eng.submit(p, max_new_tokens=b, arrival_time=0.0)
            eng.run()
    assert len(pools["port"]) == len(pools["jax"]) > 0
    for got, want in zip(pools["port"], pools["jax"]):
        for g, w in zip(got, want):
            assert np.abs(g - w).max() <= 1e-5 * max(1.0, np.abs(w).max())


# -------------------------------------------- tests/test_prefix_sharing.py
def _system_prompt_workload(rng, vocab=97):
    """test_prefix_sharing.py::_system_prompt_workload"""
    system = rng.integers(0, vocab, size=24).astype(np.int32)
    tails = [rng.integers(0, vocab, size=n).astype(np.int32) for n in (6, 3, 5, 7, 4)]
    prompts = [np.concatenate([system, tails[0]]), system.copy()]
    prompts += [np.concatenate([system, t]) for t in tails[1:]]
    prompts.append(rng.integers(0, vocab, size=7).astype(np.int32))
    arrivals = [0.0, 0.3] + [2.0 + 0.01 * i for i in range(len(prompts) - 2)]
    budgets = [int(rng.integers(3, 9)) for _ in prompts]
    return prompts, arrivals, budgets


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_prefix_sharing_two_step_programs(tiny, sampled):
    """test_prefix_sharing.py::test_prefix_sharing_identity_and_chunk_token_savings:
    two step programs, no commit (`_commit == 0`), at most one CoW
    signature (`_cow <= 1`)"""
    prompts, arrivals, budgets = _system_prompt_workload(np.random.default_rng(3))

    def drive(eng):
        cls = SamplingParams if isinstance(eng, ContinuousEngine) else JaxSamplingParams
        for i, (p, a, b) in enumerate(zip(prompts, arrivals, budgets)):
            s = cls(temperature=0.9, top_k=8, seed=100 + i) if sampled and i % 2 else cls()
            eng.submit(p, max_new_tokens=b, arrival_time=a, sampling=s)
        while eng.scheduler.has_work:
            ran = eng.step()
            eng._clock["t"] += 0.2 if ran else 0.05
        return [eng._commit._cache_size(), eng._cow._cache_size() <= 1]

    def clock():
        state = {"t": 0.0}

        def now():
            return state["t"]
        now.state = state
        return now

    outs = {}
    for sharing in (False, True):
        def drive_clocked(eng):
            eng._clock = eng.now_fn.state
            return drive(eng)
        eng, record = _run_both(tiny, drive_clocked, clock=clock, max_slots=4,
                                block_size=8, max_blocks_per_seq=6,
                                max_new_tokens=10, chunk_tokens=16,
                                prefix_sharing=sharing)
        assert record == [0, True, (1, 1)]
        assert (eng.metrics.prefix_hit_tokens > 0) == sharing
        outs[sharing] = _streams(eng)
    assert outs[False] == outs[True]


# ------------------------------------------------ dispatch and programs
RUNTIME = dict(max_slots=3, block_size=8, max_blocks_per_seq=8, chunk_tokens=16,
               num_blocks=9, max_new_tokens=10)


def _serving_prompts():
    """tests/test_torch_serving.py's workload: chunking, packing and
    preemption, prompts sharing full-block prefixes."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 97, size=n).astype(np.int32)
               for n in (11, 30, 5, 40, 3, 22)]
    prompts[3][:24] = prompts[1][:24]
    prompts[5][:16] = prompts[1][:16]
    return prompts


class _Direct:
    """Calls a step function directly on tensors viewing the host arrays
    (the adapter's dispatch before it had step programs)."""

    def __init__(self, fn, model, lanes):
        self.fn, self.model, self.lanes = fn, model, lanes

    def __call__(self, bound, inputs):
        params, k_pool, v_pool = bound
        return self.fn(self.model, params, k_pool, v_pool,
                       *[torch.as_tensor(a) for a in inputs], **self.lanes)


def _serve_logged(tiny, direct, **overrides):
    _, _, model, params = tiny
    eng = ContinuousEngine(model, params, RuntimeConfig(**{**RUNTIME, **overrides}),
                           device="cpu")
    ad = eng.adapter
    if direct:
        ad._unified = _Direct(steps.unified_step, model,
                              {**ad._decode_kw, **ad._chunk_kw})
        ad._decode_only = _Direct(steps.decode_only_step, model, ad._decode_kw)
    logits = []
    orig = ad.dispatch

    def dispatch(*args):
        out = orig(*args)
        if args[4]:                              # chunks: a unified step
            logits.append(ad.last_seg_logits.clone())
        return out

    ad.dispatch = dispatch
    for p in _serving_prompts():
        eng.submit(p)
    done = eng.run()
    return {r.rid: r.output for r in done}, logits, eng


@pytest.mark.parametrize("sharing", [False, True], ids=["sharing_off", "sharing_on"])
def test_static_buffer_dispatch_equals_direct_step_calls(tiny, sharing):
    got, got_logits, eng = _serve_logged(tiny, direct=False, prefix_sharing=sharing)
    want, want_logits, _ = _serve_logged(tiny, direct=True, prefix_sharing=sharing)
    assert got == want
    assert len(got_logits) == len(want_logits) > 0
    assert all(torch.equal(a, b) for a, b in zip(got_logits, want_logits))
    assert eng.metrics.preemptions > 0
    # the CPU captures nothing; both programs saw one signature each
    assert _sizes(eng) == (1, 1)
    assert eng._unified.captures == eng._decode_only.captures == 0
    assert eng._unified.replays == eng._decode_only.replays == 0


def test_step_program_refuses_other_params_or_pools(tiny):
    _, _, model, params = tiny
    eng = ContinuousEngine(model, params, RuntimeConfig(**RUNTIME), device="cpu")
    eng.submit(_serving_prompts()[2], max_new_tokens=3)
    eng.run()
    prog = eng._decode_only
    k, v = eng.cache.k, eng.cache.v
    inputs = (np.zeros((3, 8), np.int32), np.zeros(3, np.int32),
              np.zeros((3, 1), np.int32), np.zeros((3, 3), np.float32),
              np.zeros((3, 3), np.int32))
    prog((eng.params, k, v), inputs)               # the bound tensors: fine
    other = model.serving_params(params, "cpu")
    with pytest.raises(ValueError, match="other parameters or pools"):
        prog((other, k, v), inputs)
    with pytest.raises(ValueError, match="other parameters or pools"):
        prog((eng.params, k.clone(), v), inputs)


def test_port_engine_emits_one_compile_per_program_with_graphs_off(tiny):
    """`cuda_graphs=False` runs the same programs (no capture on any
    device): the same two signatures and compile events."""
    _, _, model, params = tiny
    outs = {}
    for graphs in (True, False):
        eng = ContinuousEngine(model, params,
                               RuntimeConfig(**RUNTIME, cuda_graphs=graphs),
                               trace=TraceRecorder(), device="cpu")
        for p in _serving_prompts():
            eng.submit(p)
        outs[graphs] = ({r.rid: r.output for r in eng.run()}, _sizes(eng),
                        _step_compiles(eng))
    assert outs[True] == outs[False]
    assert outs[True][1] == (1, 1)
    # the workload preempts: the commit program compiles once too
    assert [p for p, _ in outs[True][2]] == ["unified", "decode_only", "commit"]


# -------------------------------------------------- the capture, on the CPU
class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph: a replay re-runs nothing and is
    counted."""

    def __init__(self):
        self.replayed = 0

    def replay(self):
        self.replayed += 1


@contextlib.contextmanager
def _fake_capture(graph, pool=None):
    yield


def _counting_kernel():
    def kernel(x):
        kernel.launches += 3                       # three launches a call
        return x * 2
    return kernel


def test_capture_counts_launches_per_replay(monkeypatch):
    """The capture path with the graph API stubbed: the warm-up's result
    is returned, the capture's launches are not executions, and every
    replay adds the launches it captured."""
    monkeypatch.setattr(build, "_counted", [])
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _fake_capture)
    kernel = build.counted(_counting_kernel())
    prog = Program(lambda w, x: (kernel(x) + w,), "fake", "cpu")
    prog.graphed = True                            # as on a CUDA device
    w = torch.ones(2)
    out = prog((w,), [np.arange(2, dtype=np.float32)])
    assert out[0].tolist() == [1.0, 3.0] and kernel.launches == 3
    assert prog.captures == 1 and prog._cache_size() == 1
    for i in range(2):
        got = prog((w,), [np.full(2, 5, np.float32)])
        assert got is prog._signatures[next(iter(prog._signatures))].outputs
    assert prog.replays == 2 and kernel.launches == 3 + 2 * 3
    sig = next(iter(prog._signatures.values()))
    assert sig.graph.replayed == 2
    assert sig.static[0].tolist() == [5.0, 5.0]    # inputs copied in
    prog((w,), [np.zeros(2, np.float64)])          # a second signature
    assert prog._cache_size() == 2 and prog.captures == 2


def test_failed_capture_raises_and_keeps_no_signature(monkeypatch):
    monkeypatch.setattr(build, "_counted", [])
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _fake_capture)
    kernel = build.counted(_counting_kernel())
    calls = []

    def fn(x):
        calls.append(1)
        y = kernel(x)
        if len(calls) == 2:                        # the capture
            raise RuntimeError("operation not permitted when stream is capturing")
        return y

    prog = Program(fn, "fake", "cpu")
    prog.graphed = True
    with pytest.raises(RuntimeError, match="capturing"):
        prog((), [np.ones(2, np.float32)])
    assert prog._cache_size() == 0 and prog.captures == 0
    assert kernel.launches == 3                    # the warm-up's only


# ------------------------------------------------------- counter buffers
def test_counter_buffers_outgrown_stay_alive(monkeypatch):
    """A counter buffer that a larger eager launch outgrows is replaced for
    eager launches and kept alive for the graphs that captured it."""
    monkeypatch.setattr(build, "_counters", {})
    monkeypatch.setattr(build, "_superseded", [])
    monkeypatch.setattr(build, "_zeroed_counters",
                        lambda n, device: torch.zeros(n, dtype=torch.int32))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    dev = torch.device("cuda", 0)
    first = build.counters("paged_decode", dev, 64)
    assert first.numel() == 1024
    assert build.counters("paged_decode", dev, 1024) is first
    grown = build.counters("paged_decode", dev, 4096)
    assert grown.numel() == 4096 and grown is not first
    assert build._superseded == [first]
    assert build.counters("paged_decode", dev, 8) is grown
    assert build.counters("matmul", dev, 8) is not grown   # one per library
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert build.counters("paged_decode", dev, 4096) is grown
    with pytest.raises(RuntimeError, match="before a CUDA graph capture"):
        build.counters("paged_decode", dev, 4097)
    assert build._superseded == [first]


# ----------------------------------------------------------------- Engine
def test_cpu_engine_is_unchanged_and_returns_fresh_outputs():
    g = resnet18_graph(batch=1, image=32, n_classes=10, seed=0)
    rng = np.random.default_rng(1)
    x1, x2 = (rng.standard_normal((1, 3, 32, 32)).astype(np.float32)
              for _ in range(2))
    eng = Engine(g, device="cpu")
    eager = Engine(g, device="cpu", cuda_graph=False)
    want1 = eng.run_env(x1)[g.outputs[0]]
    out1 = eng(x1)[0]
    assert torch.equal(out1, want1)
    assert torch.equal(eager(x1)[0], want1)
    snapshot = out1.clone()
    out2 = eng(x2)[0]
    assert torch.equal(out2, eng.run_env(x2)[g.outputs[0]])
    assert torch.equal(out1, snapshot) and out2.data_ptr() != out1.data_ptr()
    assert eng._program._cache_size() == 1 and eng._program.captures == 0
    with pytest.raises(ValueError, match="expected 1 inputs"):
        eng(x1, x2)
