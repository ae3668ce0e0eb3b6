"""The port's Mamba2 continuous serving against the JAX package's.

Mirrors `tests/test_ssm_serving.py` and `tests/test_state_cache_properties.py`
across the frameworks.  The port's `ContinuousEngine(device="cpu")` serves
a `MambaLM` through `SSMFamilyAdapter` (slot-pooled state rows, the three
ssm programs); the JAX `ContinuousEngine` and both packages'
`FixedBatchEngine` drains (batch 1, the per-request ground truth) serve the
same prompts from the same parameters: `mamba2-2.7b` reduced to 2 layers,
vocab 97, f32 (d_model 128, state 16, SSD chunk 16), prompts of
(5, 16, 32, 7, 16, 48) tokens — partial, exact and multi-chunk — with
16-token chunks, 3 slots and 8 new tokens.  Streams must be equal token
for token, greedy and sampled, with and without forced state-row
preemption (`state_slots=3`: 2 usable rows for 3 slots), and the program
signature counts and `compile` trace events equal the JAX engine's.

The JAX engines run on a mesh built with Auto axis types (see
`tests/test_torch_serving.py`): the reference's own suite, which builds
Explicit axes under jax 0.9, is red for that reason alone.
"""

import contextlib
import dataclasses
import gc

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.sharding import AxisType, Mesh

from repro.configs import get_config as jax_get_config
from repro.distributed.sharding import DEFAULT_RULES
from repro.models import build_model
from repro.serve import family as jfamily
from repro.serve import router as jrouter
from repro.serve.engine import FixedBatchEngine as JaxFixedBatchEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.runtime import ContinuousEngine as JaxEngine
from repro.serve.runtime import RuntimeConfig as JaxRuntimeConfig
from repro.serve.sampling import SamplingParams as JaxSamplingParams
from repro.serve.trace import TraceRecorder as JaxTraceRecorder
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import InferencePlan, OpChoice
from repro_torch.core.search.tuner import Tuner
from repro_torch.launch import steps
from repro_torch.models import DecoderLM, MambaLM
from repro_torch.serve import (ContinuousEngine, FixedBatchEngine, RuntimeConfig,
                               SSMFamilyAdapter, SamplingParams, ServeConfig,
                               ServeEngine, TraceRecorder, traceview, write_trace)
from repro_torch.serve.family import DecoderFamilyAdapter, resolve_family_adapter
from repro_torch.serve.router import (FAMILY_STAGES, SSM_MATMUL_ROLES, STAGES,
                                      PlanRouter, build_serve_graph, build_serve_plan)
from repro_torch.serve.statecache import (NULL_SLOT, SlotAllocator, SlotStateCache,
                                          StateCacheConfig)

MAX_NEW = 8
LENS = (5, 16, 32, 7, 16, 48)
RUNTIME = dict(max_slots=3, chunk_tokens=16, max_new_tokens=MAX_NEW)
PROGRAMS = ("unified", "decode_only", "commit")
COUNTERS = ("prefill_chunks", "decode_only_steps", "preemptions", "prefills",
            "chunk_steps", "tokens_out", "resume_commits")


@pytest.fixture(scope="module")
def mamba():
    jcfg = jax_get_config("mamba2-2.7b").reduced(n_layers=2, vocab=97, dtype="float32")
    tcfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)})
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 97, size=n).astype(np.int32) for n in LENS]
    return jmodel, jparams, MambaLM(tcfg), tparams, prompts


def _mesh():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"),
                axis_types=(AxisType.Auto, AxisType.Auto))


def _clock():
    c = iter(range(1 << 20))
    return lambda: float(next(c))


def _mix(i, cls):
    """The bench's mixed sampling cycle (benchmarks/bench_serving.py:158)."""
    r = i % 4
    if r == 0:
        return cls()
    if r == 1:
        return cls(temperature=0.8, seed=1000 + i)
    if r == 2:
        return cls(temperature=1.0, top_k=8, seed=1000 + i)
    return cls(temperature=0.9, top_p=0.85, seed=1000 + i)


def _compiles(eng):
    """[(program, step)] of the `compile` events, each with the step during
    (or, for a commit, before) which it compiled or captured."""
    out, step = [], None
    for e in eng.trace.events:
        if e.name == "step_begin":
            step = e.fields["step"]
        elif e.name == "compile" and e.fields["program"] in PROGRAMS:
            out.append((e.fields["program"], step))
    return out


def _sizes(eng):
    return tuple(getattr(eng, f"_{p}")._cache_size() for p in PROGRAMS)


def _jax_continuous(mamba, sampled=False, **rcfg):
    jmodel, jparams, _, _, prompts = mamba
    mesh = _mesh()
    eng = JaxEngine(jmodel, jparams, mesh, DEFAULT_RULES,
                    JaxRuntimeConfig(**RUNTIME, **rcfg), now_fn=_clock(),
                    trace=JaxTraceRecorder())
    for i, p in enumerate(prompts):
        eng.submit(p, arrival_time=0.0,
                   sampling=_mix(i, JaxSamplingParams) if sampled else None)
    with mesh:
        done = eng.run()
    return {r.rid: [int(t) for t in r.output] for r in done}, eng


def _port_continuous(mamba, sampled=False, router=None, trace=None, **rcfg):
    _, _, model, params, prompts = mamba
    eng = ContinuousEngine(model, params, RuntimeConfig(**RUNTIME, **rcfg),
                           router=router, now_fn=_clock(),
                           trace=trace if trace is not None else TraceRecorder(),
                           device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(p, arrival_time=0.0,
                   sampling=_mix(i, SamplingParams) if sampled else None)
    done = {r.rid: [int(t) for t in r.output] for r in eng.run()}
    eng.cache.alloc.check_invariants()
    assert eng.cache.alloc.num_used == 0 and not eng.cache.alloc.swapped
    return done, eng


def _jax_fixed(mamba, sampled=False):
    jmodel, jparams, _, _, prompts = mamba
    mesh = _mesh()
    eng = JaxFixedBatchEngine(jmodel, jparams, mesh, DEFAULT_RULES,
                              JaxServeConfig(batch_size=1, max_seq=64,
                                             max_new_tokens=MAX_NEW))
    for i, p in enumerate(prompts):
        eng.submit(p, sampling=_mix(i, JaxSamplingParams) if sampled else None)
    with mesh:
        return {r.rid: [int(t) for t in r.output] for r in eng.run()}


def _port_fixed(mamba, sampled=False):
    _, _, model, params, prompts = mamba
    eng = FixedBatchEngine(model, params,
                           ServeConfig(batch_size=1, max_seq=64, max_new_tokens=MAX_NEW),
                           device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(p, sampling=_mix(i, SamplingParams) if sampled else None)
    return {r.rid: [int(t) for t in r.output] for r in eng.run()}


@pytest.fixture(scope="module", params=[False, True], ids=["greedy", "mixed"])
def drains(mamba, request):
    """(sampled, the port's drain, the JAX drain)."""
    return request.param, _port_fixed(mamba, request.param), _jax_fixed(mamba, request.param)


# ------------------------------------------------------------ the streams
@pytest.mark.parametrize("state_slots", [None, 3], ids=["unconstrained", "preempting"])
def test_continuous_streams_equal_both_drains_and_the_jax_engine(mamba, drains,
                                                                 state_slots):
    """tests/test_ssm_serving.py's pins across the frameworks: the port's
    continuous streams equal its own drain, the JAX drain and the JAX
    continuous engine, greedy and sampled; the programs' signature counts,
    their `compile` events and the step counters equal the JAX engine's."""
    sampled, port_fixed, jax_fixed = drains
    assert port_fixed == jax_fixed
    got, eng = _port_continuous(mamba, sampled, state_slots=state_slots)
    want, jeng = _jax_continuous(mamba, sampled, state_slots=state_slots)
    assert got == want == port_fixed
    assert eng.family == "ssm" and isinstance(eng.adapter, SSMFamilyAdapter)
    assert eng.adapter.chunk_width % eng.model.cfg.ssm_chunk == 0
    assert _sizes(eng) == _sizes(jeng) == (1, 1, 1 if state_slots else 0)
    assert _compiles(eng) == _compiles(jeng)
    s, js = eng.metrics.summary(), jeng.metrics.summary()
    assert {k: s[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    assert (s["preemptions"] >= 1) == bool(state_slots)
    if sampled:
        greedy, _ = _port_continuous(mamba, False, state_slots=state_slots)
        assert any(got[r] != greedy[r] for r in got)
        assert all(got[r] == greedy[r] for r in got if (r - 1) % 4 == 0)


def test_kernel_lane_plan_serves_the_same_streams(mamba, drains):
    """A plan sending the three ssm projections of both stages to the GEMM
    (on the CPU: its plain version) serves the drain's streams."""
    sampled, port_fixed, _ = drains
    plan = InferencePlan("serve_ssm", "h100")
    for stage in FAMILY_STAGES["ssm"]:
        for role in SSM_MATMUL_ROLES:
            plan.choices[f"{stage}.{role}"] = OpChoice("cuda_matmul", {}, 0.0)
    got, eng = _port_continuous(mamba, sampled, router=PlanRouter(plan), state_slots=3)
    assert eng.adapter._decode_kw["decode_matmul_table"]["in_proj"][0] == "cuda_matmul"
    assert set(eng.adapter._chunk_kw["chunk_matmul_table"]) == set(SSM_MATMUL_ROLES)
    assert got == port_fixed


def test_forced_preemption_trace_audits_as_the_ssm_family(mamba, tmp_path):
    rec = TraceRecorder()
    got, eng = _port_continuous(mamba, trace=rec, state_slots=3)
    assert eng.metrics.preemptions >= 1 and eng.metrics.family == "ssm"
    swap_outs = [e for e in rec.events if e.name == "swap_out"]
    row_bytes = sum(t[:, 0].numel() * 4 for t in (eng.cache.conv, eng.cache.ssm))
    assert swap_outs and all(e.fields["nbytes"] == row_bytes for e in swap_outs)
    lifecycle = [e for e in rec.events
                 if e.name in ("submit", "admit", "preempt", "finish",
                               "step_begin", "step_end")]
    assert lifecycle and all(e.fields.get("family") == "ssm" for e in lifecycle)
    meta = {"usable_blocks": eng.cache.cfg.usable, "family": "ssm"}
    report = traceview.audit(rec.events, metrics=eng.metrics, metadata=meta)
    assert report.ok, report.summary()
    path = tmp_path / "ssm_trace.json"
    write_trace(str(path), rec.events, eng.metrics, metadata=dict(meta, block_size=1))
    assert traceview.main([str(path), "--quiet"]) == 0
    # each commit moved the swapped rows and the (resume_segments,) row ids
    assert eng.adapter.last_commit_h2d_bytes == row_bytes + 4 * eng.adapter.resume_segments


def test_serve_engine_drains_a_mamba_through_the_fixed_batch_loop(mamba, drains):
    """The reference's routing predicate: no paged decode path, so the
    fixed-batch loop (ssm continuous serving is an explicit
    ContinuousEngine)."""
    sampled, port_fixed, _ = drains
    _, _, model, params, prompts = mamba
    eng = ServeEngine(model, params, ServeConfig(batch_size=1, max_seq=64,
                                                 max_new_tokens=MAX_NEW), device="cpu")
    assert isinstance(eng._engine, FixedBatchEngine)
    for i, p in enumerate(prompts):
        eng.submit(p, sampling=_mix(i, SamplingParams) if sampled else None)
    assert {r.rid: r.output for r in eng.run()} == port_fixed


# ------------------------------------------------- state cache (host logic)
def run_op_sequence(cfg: StateCacheConfig, ops) -> SlotAllocator:
    """tests/test_state_cache_properties.py's interpreter, on the port's
    allocator: (kind, x) pairs, the invariants checked after every op."""
    alloc = SlotAllocator(cfg)
    live, swapped = [], []
    next_rid = 1

    def check():
        alloc.check_invariants()
        assert alloc.num_free + alloc.num_used == cfg.usable
        assert sorted(alloc.owners) == sorted(live)
        assert sorted(alloc.swapped) == sorted(swapped)
        assert 0.0 <= alloc.occupancy() <= 1.0

    for kind, x in ops:
        kind = kind % 4
        if kind == 0:                                   # allocate
            rid = next_rid
            next_rid += 1
            if alloc.num_free == 0:
                with pytest.raises(MemoryError):
                    alloc.allocate(rid)
            else:
                row = alloc.allocate(rid)
                assert row != NULL_SLOT
                assert alloc.slot_of(rid) == row and alloc.holds(rid)
                with pytest.raises(ValueError):
                    alloc.allocate(rid)
                live.append(rid)
        elif kind == 1 and live:                        # free (+ double-free)
            rid = live.pop(x % len(live))
            assert alloc.free(rid) == 1
            with pytest.raises(KeyError):
                alloc.free(rid)
        elif kind == 2 and live:                        # swap_out
            rid = live.pop(x % len(live))
            free_before = alloc.num_free
            assert alloc.swap_out(rid) == 1
            assert alloc.num_free == free_before + 1
            assert alloc.swapped[rid] == 1
            with pytest.raises(ValueError):
                alloc.allocate(rid)
            swapped.append(rid)
        elif kind == 3 and swapped:                     # swap_in
            rid = swapped[x % len(swapped)]
            if alloc.num_free == 0:
                with pytest.raises(MemoryError):
                    alloc.swap_in(rid)
                assert alloc.swapped[rid] == 1
            else:
                assert alloc.swap_in(rid) != NULL_SLOT
                swapped.remove(rid)
                live.append(rid)
        check()
    return alloc


ops_strategy = st.lists(st.tuples(st.integers(0, 3), st.integers(0, 1 << 16)),
                        max_size=150)


@given(num_slots=st.integers(2, 24), ops=ops_strategy)
@settings(deadline=None)
def test_slot_allocator_invariants_under_random_ops(num_slots, ops):
    run_op_sequence(StateCacheConfig(num_slots=num_slots), ops)


@given(ops=ops_strategy)
@settings(deadline=None)
def test_slot_allocator_drains_back_to_full_pool(ops):
    cfg = StateCacheConfig(num_slots=9)
    alloc = run_op_sequence(cfg, ops)
    for rid in list(alloc.owners):
        alloc.free(rid)
    for rid in list(alloc.swapped):
        del alloc.swapped[rid]
    alloc.check_invariants()
    assert alloc.num_free == cfg.usable and alloc.num_used == 0


def test_slot_allocator_emits_the_reference_events():
    """Event for event the JAX allocator's, over the same operations."""
    from repro.serve.statecache import SlotAllocator as JaxSlotAllocator

    logs = []
    for cls, rec in ((SlotAllocator, TraceRecorder()), (JaxSlotAllocator, JaxTraceRecorder())):
        alloc = cls(StateCacheConfig(num_slots=4))
        alloc.trace = rec
        rows = [alloc.allocate(1), alloc.allocate(2), alloc.allocate(3)]
        alloc.swap_out(2)
        alloc.free(1)
        rows += [alloc.swap_in(2), alloc.allocate(4)]
        logs.append((rows, [(e.name, dict(e.fields)) for e in rec.events]))
    assert logs[0] == logs[1]


def test_state_cache_swap_round_trip_is_byte_exact():
    cache = SlotStateCache(StateCacheConfig(num_slots=3), n_layers=2, conv_width=4,
                           conv_dim=3, nheads=2, head_dim=2, d_state=5, device="cpu")
    row = cache.alloc.allocate(7)
    conv_val = torch.arange(2 * 3 * 3, dtype=torch.float32).reshape(2, 3, 3) / 7
    ssm_val = torch.arange(2 * 2 * 2 * 5, dtype=torch.float32).reshape(2, 2, 2, 5) / 3
    cache.conv[:, row] = conv_val
    cache.ssm[:, row] = ssm_val
    nbytes = cache.swap_out(7)
    assert nbytes == (conv_val.numel() + ssm_val.numel()) * 4
    assert cache.is_swapped(7) and not cache.alloc.holds(7)
    conv_host, ssm_host = cache.take_swapped(7)
    assert torch.equal(conv_host.view(torch.int32), conv_val.view(torch.int32))
    assert torch.equal(ssm_host.view(torch.int32), ssm_val.view(torch.int32))
    assert not cache.is_swapped(7)


def test_index_array_points_absent_requests_at_the_null_row():
    cache = SlotStateCache(StateCacheConfig(num_slots=4), n_layers=1, conv_width=4,
                           conv_dim=2, nheads=1, head_dim=2, d_state=2, device="cpu")
    r1 = cache.alloc.allocate(1)
    r2 = cache.alloc.allocate(2)
    idx = cache.index_array([2, None, 1, 99])
    assert idx.dtype == np.int32
    assert list(idx) == [r2, NULL_SLOT, r1, NULL_SLOT]


# ------------------------------------------------------- the family seam
def test_resolve_family_adapter_picks_by_capability(mamba):
    _, _, model, _, _ = mamba
    dense = DecoderLM(get_config("qwen3-1.7b"))

    class SsmWithoutSlots:
        cfg = model.cfg

    class Neither:
        cfg = dense.cfg

    assert resolve_family_adapter(model) is SSMFamilyAdapter
    assert resolve_family_adapter(dense) is DecoderFamilyAdapter
    assert jfamily.resolve_family_adapter(model) is jfamily.SSMFamilyAdapter
    for obj in (SsmWithoutSlots(), Neither()):
        with pytest.raises(TypeError, match="fixed-batch ServeEngine"):
            resolve_family_adapter(obj)
        with pytest.raises(TypeError, match="fixed-batch ServeEngine"):
            jfamily.resolve_family_adapter(obj)


def test_runtime_state_config_is_the_reference_s():
    for kw in ({}, dict(max_slots=5), dict(max_slots=5, state_slots=3)):
        got, want = RuntimeConfig(**kw).state_config(), JaxRuntimeConfig(**kw).state_config()
        assert got.num_slots == want.num_slots and got.usable == want.usable


# ------------------------------------------------------ serve graph, router
def _structure(g):
    import json
    return ([(n.op, n.name, n.inputs, n.outputs, json.dumps(n.attrs, sort_keys=True))
             for n in g.nodes],
            {k: (tuple(v.shape), v.dtype) for k, v in g.tensors.items()},
            g.inputs, g.outputs)


@pytest.mark.parametrize("kw", [dict(prefill_len=700, slots=8, max_seq=1024,
                                     chunk_tokens=256, dtype="bfloat16"),
                                dict(prefill_len=32, slots=4, max_seq=64, chunk_tokens=40),
                                dict(prefill_len=32, slots=3, max_seq=64)],
                         ids=["serving_widths_bf16", "rounded_chunk", "default_chunk"])
@pytest.mark.parametrize("reduced", [False, True], ids=["published", "reduced"])
def test_ssm_serve_graph_is_the_jax_graph(kw, reduced):
    jcfg, cfg = jax_get_config("mamba2-2.7b"), get_config("mamba2-2.7b")
    if reduced:
        jcfg, cfg = jcfg.reduced(n_layers=2), cfg.reduced(n_layers=2)
    jg = jrouter.build_serve_graph(jcfg, **kw, family="ssm")
    pg = build_serve_graph(cfg, **kw, family="ssm")
    assert _structure(pg) == _structure(jg)
    assert [n.name for n in pg.nodes] == [
        f"{stage}.{role}" for stage in FAMILY_STAGES["ssm"] for role in SSM_MATMUL_ROLES]


def test_router_takes_the_ssm_roles_for_ssm_stages():
    assert STAGES == jrouter.STAGES
    assert SSM_MATMUL_ROLES == jrouter.SSM_MATMUL_ROLES
    plan = InferencePlan("serve_ssm", "h100")
    plan.choices["ssm_decode.in_proj"] = OpChoice("pallas_matmul", {"bm": 8}, 0.0)
    plan.choices["ssm_decode.lm_head"] = OpChoice("xla", {}, 0.0)
    router = PlanRouter(plan)
    assert router.matmul_table("ssm_decode") == {
        "in_proj": ("cuda_matmul", {"bm": 8}), "out_proj": ("torch", {}),
        "lm_head": ("torch", {})}
    assert set(router.matmul_table("ssm_prefill_chunk")) == set(SSM_MATMUL_ROLES)
    assert router.layout_table("ssm_decode") == dict.fromkeys(SSM_MATMUL_ROLES,
                                                              "replicated")
    assert "attention" in router.layout_table("decode")
    jtable = jrouter.PlanRouter(plan).matmul_table("ssm_decode")
    assert {r: c for r, (_, c) in jtable.items()} == \
        {r: c for r, (_, c) in router.matmul_table("ssm_decode").items()}


def test_build_serve_plan_races_the_six_ssm_nodes():
    from repro_torch.core.costmodel import roofline_bound
    from repro_torch.core.search.base import Fitness

    class KernelWinsDecode(Fitness):
        kind = "wallclock"

        def __init__(self):
            self.evals = 0

        def __call__(self, op, cfg):
            self.evals += 1
            return roofline_bound(op) * 3.0

        def vendor_time(self, op):
            return roofline_bound(op) * (4.0 if op.d["m"] <= 8 else 2.0)

    cfg = get_config("mamba2-2.7b")
    plan = build_serve_plan(cfg, prefill_len=700, slots=8, max_seq=1024,
                            chunk_tokens=256, family="ssm",
                            tuner=Tuner(fitness=KernelWinsDecode(),
                                        methods=("genetic",)))
    assert sorted(plan.choices) == sorted(
        f"{s}.{r}" for s in FAMILY_STAGES["ssm"] for r in SSM_MATMUL_ROLES)
    router = PlanRouter(plan)
    assert {r: b for r, (b, _) in router.matmul_table("ssm_decode").items()} == \
        dict.fromkeys(SSM_MATMUL_ROLES, "cuda_matmul")
    # the chunk lane's lm_head runs at M = 1, its projections at M = 256
    chunk = {r: b for r, (b, _) in router.matmul_table("ssm_prefill_chunk").items()}
    assert chunk == {"in_proj": "torch", "out_proj": "torch", "lm_head": "cuda_matmul"}


# -------------------------------------------------- the capture, on the CPU
class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph: a replay re-runs nothing."""

    def __init__(self):
        self.replayed = 0

    def replay(self):
        self.replayed += 1


def _ssm_inputs(model, seed, rows=4, slots=3):
    """Random pools and one signature's host inputs of each ssm program."""
    rng = np.random.default_rng(seed)
    from repro_torch.models import mamba as M
    cfg = model.cfg
    _, nh, conv_dim = M._dims(cfg)
    conv = torch.from_numpy(rng.standard_normal(
        (cfg.n_layers, rows, cfg.conv_width - 1, conv_dim)).astype(np.float32))
    ssm = torch.from_numpy(rng.standard_normal(
        (cfg.n_layers, rows, nh, cfg.ssm_head_dim, cfg.ssm_state)).astype(np.float32))
    dec = (np.array([2, 0, 3], np.int32), rng.integers(0, 97, (slots, 1)).astype(np.int32))
    chunk = (rng.integers(0, 97, (1, 16)).astype(np.int32), np.array([1], np.int32),
             np.array([11], np.int32), np.array([16], np.int32))
    samp = (np.zeros((slots, 3), np.float32), np.zeros((slots, 3), np.int32),
            np.zeros((1, 3), np.float32), np.zeros((1, 3), np.int32))
    return conv, ssm, dec, chunk, samp


def test_the_three_ssm_programs_capture_once_and_replay(mamba, monkeypatch):
    """The capture path with the graph API stubbed: each program's first
    call returns the warm-up's result (equal to a direct call of its body),
    captures once with the cyclic garbage collector off, and every later
    call loads the inputs and replays; the commit program too."""
    _, _, model, params, _ = mamba
    params = model.serving_params(params, "cpu")
    gc_during = []

    @contextlib.contextmanager
    def fake_capture(graph, pool=None):
        gc_during.append(gc.isenabled())
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", fake_capture)
    conv, ssm, dec, chunk, samp = _ssm_inputs(model, 1)
    uni = steps.graph_ssm_unified_step(model, "cpu")
    dec_only = steps.graph_ssm_decode_only_step(model, "cpu")
    commit = steps.graph_ssm_commit_state("cpu")
    for prog in (uni, dec_only, commit):
        prog.graphed = True                         # as on a CUDA device

    uni_in = (*dec, *chunk, *samp)
    want = steps.ssm_unified_step(model, params, conv.clone(), ssm.clone(),
                                  *(torch.from_numpy(a) for a in uni_in))
    got = uni((params, conv, ssm), uni_in)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    dec_in = (*dec, *samp[:2])
    want = steps.ssm_decode_only_step(model, params, conv.clone(), ssm.clone(),
                                      *(torch.from_numpy(a) for a in dec_in))
    assert torch.equal(dec_only((params, conv, ssm), dec_in), want)
    conv_in = torch.zeros((2, conv.shape[0], *conv.shape[2:])).transpose(0, 1)
    ssm_in = torch.zeros((2, ssm.shape[0], *ssm.shape[2:])).transpose(0, 1)
    commit((conv, ssm, conv_in, ssm_in), (np.array([3, 0], np.int32),))
    assert gc_during == [False, False, False] and gc.isenabled()

    for prog, inputs in ((uni, uni_in), (dec_only, dec_in)):
        for i in range(2):
            out = prog((params, conv, ssm), inputs)
            sig = next(iter(prog._signatures.values()))
            assert out is sig.outputs
        assert prog.captures == 1 and prog._cache_size() == 1
        assert prog.replays == 2 and sig.graph.replayed == 2
    commit((conv, ssm, conv_in, ssm_in), (np.array([1, 0], np.int32),))
    sig = next(iter(commit._signatures.values()))
    assert commit.replays == 1 and sig.static[0].tolist() == [1, 0]
    with pytest.raises(ValueError, match="first called with other"):
        dec_only((params, conv.clone(), ssm), dec_in)


def test_commit_scatters_the_swapped_rows_and_nothing_else(mamba):
    """`ssm_commit_state` writes each segment's state at its row and the
    padding at the null row only."""
    _, _, model, _, _ = mamba
    conv, ssm, _, _, _ = _ssm_inputs(model, 2)
    conv0, ssm0 = conv.clone(), ssm.clone()
    new_conv = torch.randn((conv.shape[0], 3, *conv.shape[2:]))
    new_ssm = torch.randn((ssm.shape[0], 3, *ssm.shape[2:]))
    steps.ssm_commit_state(conv, ssm, new_conv, new_ssm, torch.tensor([3, 1, 0]))
    assert torch.equal(conv[:, 3], new_conv[:, 0]) and torch.equal(ssm[:, 1], new_ssm[:, 1])
    assert torch.equal(conv[:, 2], conv0[:, 2]) and torch.equal(ssm[:, 2], ssm0[:, 2])
