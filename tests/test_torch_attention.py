"""The port's dense attention kernels and its serve-plan path on the CPU,
held against the JAX package on the same numpy-seeded inputs.

On CPU tensors `ops.attention` / `ops.attention_decode` run the plain
versions of `csrc/flash_attention.cu` / `csrc/dense_decode.cu`; the JAX side
runs its Pallas kernels in interpret mode, as its own tests do.  The CUDA
kernels are held against the same plain versions on the card by
`chip_smoke.py`.  The serve-plan path (`build_serve_graph` ->
`build_serve_plan` -> `PlanRouter` -> `ContinuousEngine`) is checked with
an injected fitness, or on plans the JAX package tuned with its own.

Tolerances: f32 throughout.  Attention 3e-4 (the JAX kernel tests' own);
whole graphs 1e-4 relative to the largest output.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import Engine as JEngine
from repro.core import Graph as JGraph
from repro.core import Tuner as JTuner
from repro.core import default_registry as jax_registry
from repro.core import select as j_select
from repro.core.plan import OpChoice as JOpChoice
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.serve import router as jrouter
from repro_torch import hw
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import (Engine, Graph, InferencePlan, TEMPLATES, Tuner,
                              WallClockFitness, default_registry, op_desc_of,
                              roofline_bound)
from repro_torch.core.schedules import OpDesc
from repro_torch.core.costmodel import Fitness
from repro_torch.distributed import DEFAULT_RULES
from repro_torch.kernels import attention as KA
from repro_torch.kernels import ops
from repro_torch.models import DecoderLM
from repro_torch.serve.router import (PlanRouter, build_serve_graph,
                                      build_serve_plan)
from repro_torch.serve.runtime import ContinuousEngine, RuntimeConfig

TOL = dict(rtol=3e-4, atol=3e-4)
NET_RTOL = 1e-4
# qwen3-1.7b's serve graph at the serving widths chip_smoke.py tunes
SERVE = dict(prefill_len=700, slots=8, max_seq=1024, chunk_tokens=256)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- kernels
@pytest.mark.parametrize("sq,skv,h,hkv,causal", [
    # tests/test_kernels.py::test_attention_sweep, causal and not
    *[(sq, skv, h, hkv, c) for sq, skv, h, hkv in [
        (256, 256, 4, 4), (256, 256, 4, 2), (200, 200, 4, 1), (128, 384, 2, 2)]
      for c in (True, False)],
    # causal Sq < Skv: the top-left alignment the JAX test skips
    (1, 300, 4, 2, True), (32, 300, 4, 2, True),
])
def test_attention_plain_matches_pallas_interpret(sq, skv, h, hkv, causal):
    rng = np.random.default_rng(4)
    q = (rng.standard_normal((2, sq, h, 64)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((2, skv, hkv, 64)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((2, skv, hkv, 64)) * 0.3).astype(np.float32)
    cfg = {"block_q": 128, "block_kv": 128}
    want = np.asarray(jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     causal=causal, config=cfg))
    got = ops.attention(_t(q), _t(k), _t(v), causal=causal, config=cfg).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if causal and sq < skv:
        # the JAX oracle aligns the mask at the bottom right: another function
        oracle = np.asarray(jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                               jnp.asarray(v), causal=True))
        assert np.abs(oracle - got).max() > 0.1
    if sq == 1:
        # row 0 sees key 0 alone: the output is that key's value row
        np.testing.assert_allclose(got[:, 0], np.repeat(v[:, 0], h // hkv, axis=1),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("lengths", [[64, 199], [1, 256], [256, 256]])
def test_attention_decode_plain_matches_pallas_interpret(lengths):
    # tests/test_kernels.py::test_attention_decode_lengths
    rng = np.random.default_rng(5)
    b, s, h, hkv, d = 2, 256, 4, 2, 64
    q = (rng.standard_normal((b, h, d)) * 0.3).astype(np.float32)
    kc = (rng.standard_normal((b, s, hkv, d)) * 0.3).astype(np.float32)
    vc = (rng.standard_normal((b, s, hkv, d)) * 0.3).astype(np.float32)
    ln = np.asarray(lengths, np.int32)
    want = np.asarray(jops.attention_decode(jnp.asarray(q), jnp.asarray(kc),
                                            jnp.asarray(vc), jnp.asarray(ln),
                                            config={"block_kv": 128}))
    got = ops.attention_decode(_t(q), _t(kc), _t(vc), _t(ln),
                               config={"block_kv": 128}).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_dense_decode_plain_version_masks_by_length():
    """A length of 0 gives zeros (the kernel's l = 0); lengths past S are
    taken as S; keys past the length do not matter."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((3, 2, 8), generator=g)
    k = torch.randn((1, 5, 1, 8), generator=g).expand(3, -1, -1, -1).clone()
    v = torch.randn((1, 5, 1, 8), generator=g).expand(3, -1, -1, -1).clone()
    q[2] = q[1]
    dec = ops.attention_decode(q, k, v, torch.tensor([0, 5, 9]))
    assert torch.equal(dec[0], torch.zeros_like(dec[0]))
    assert torch.equal(dec[1], dec[2])
    k[:, 3:], v[:, 3:] = 1e3, -1e3
    short = ops.attention_decode(q, k, v, torch.tensor([3, 3, 3]))
    want = ops.attention(q[:, None], k[:, :3], v[:, :3], causal=False)[:, 0]
    torch.testing.assert_close(short, want, rtol=1e-6, atol=1e-6)


def test_attention_wrappers_raise_off_the_cpu_instead_of_falling_back():
    q = torch.zeros((1, 4, 2, 16), device="meta")
    kv = torch.zeros((1, 4, 1, 16), device="meta")
    with pytest.raises(ValueError, match="GPU"):
        ops.attention(q, kv, kv)
    with pytest.raises(ValueError, match="GPU"):
        ops.attention_decode(q[:, 0], kv, kv, torch.zeros((1,), device="meta"))
    with pytest.raises(TypeError, match="dtype"):
        ops.attention(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="at most 32"):
        KA.flash_blocks(None, None, 16, 64, 128, 2)


# ---------------------------------------------------------------- template
def _serve_attention_ops():
    g = build_serve_graph(get_config("qwen3-1.7b"), **SERVE, dtype="bfloat16")
    return {n.name: op_desc_of(g, n, "bfloat16") for n in g.nodes if n.op == "attention"}


@pytest.mark.parametrize("node", ["prefill.attention", "decode.attention",
                                  "prefill_chunk.attention"])
def test_attention_template_space_is_what_the_kernel_launches(node):
    tmpl = TEMPLATES["pallas_attention"]
    op = _serve_attention_ops()[node]
    space = tmpl.space(op)
    configs = list(tmpl.enumerate_configs(op))
    assert len(configs) == tmpl.space_size(op) > 0
    assert ("max_segments" in space) == node.startswith("prefill_chunk")
    if "max_segments" in space:
        assert space["max_segments"] == [1, 2, 4, 8]
    d = op.d
    for cfg in configs:
        geo = KA.flash_geometry(cfg["block_q"], cfg["block_kv"], 1, d["d"], 2)
        assert geo.smem_bytes <= hw.H100.smem_per_block
        # the race's MHA inputs launch the configuration as it is (block_q
        # clamped to Sq only where Sq is shorter)
        assert KA.flash_blocks(cfg["block_q"], cfg["block_kv"], d["q"], 1, d["d"],
                               2) == KA.flash_geometry(min(cfg["block_q"], d["q"]),
                                                       cfg["block_kv"], 1, d["d"], 2)
    # a JAX plan's TPU-sized blocks shrink to the largest Hopper tile at G=2
    assert KA.flash_blocks(512, 1024, d["q"], 2, d["d"], 2).block_kv == 128
    assert KA.flash_blocks(512, 1024, d["q"], 2, d["d"], 2).block_q == min(16, d["q"])


def _mma_layout_bytes(nq, block_kv, d):
    """`mma::layout` of csrc/mma_attention.cuh, written out term for term:
    bf16 rows of DMAX + 8 elements (DMAX = 64, 128 or 256, the instance's
    head-dim bound); round16(nq) query rows; a two-stage ring of K and V
    rows; the merge of 2 query warps' (acc, m, l) in f32 over 32 lanes,
    which reuses the ring."""
    r16 = lambda x: (x + 15) // 16 * 16
    dmax = 64 if d <= 64 else 128 if d <= 128 else 256
    row = (dmax + 8) * 2
    q = r16(r16(nq) * row)
    ring = 2 * 2 * block_kv * row
    merge = 2 * (dmax // 8 * 4 + 4) * 32 * 4
    return q + r16(max(ring, merge))


@pytest.mark.parametrize("d", [64, 128, 256])
def test_tensor_core_tile_smem_mirrors_the_cpp_layout(d):
    tmpl = TEMPLATES["pallas_attention"]
    op = OpDesc.attention(1, 256, 1024, 16, d, label="prefill_chunk.attention")
    configs = list(tmpl.enumerate_configs(op))
    tiles = {(c["block_q"], c["block_kv"]) for c in configs}
    # the two-stage ring of 128 keys of D = 256 needs 264 KiB: only that tile
    # is refused
    want = {(bq, bkv) for bq in KA.FLASH_BLOCK_Q for bkv in KA.FLASH_BLOCK_KV
            if not (d == 256 and bkv == 128)}
    assert tiles == want
    for bq, bkv in tiles:
        for group in (1, 2, 4, 8):
            if bq * group > KA.FLASH_MAX_VECTORS:
                continue
            smem = KA.mma_tile_smem_bytes(bq * group, bkv, d)
            assert smem == _mma_layout_bytes(bq * group, bkv, d)
            assert smem <= hw.H100.smem_per_block
            assert KA.flash_geometry(bq, bkv, group, d, 2).smem_bytes == smem
    # paged prefill's bf16 tile, full
    prefill = KA.mma_tile_smem_bytes(KA.PREFILL_MAX_VECTORS, KA.PREFILL_BLOCK_KV, d)
    assert prefill == _mma_layout_bytes(32, KA.PREFILL_BLOCK_KV, d)
    assert prefill <= hw.H100.smem_per_block
    # f32 keeps the CUDA-core tile; the tensor-core tile takes block_kv from
    # FLASH_BLOCK_KV only (a tuned 48 launches 32)
    assert KA.flash_geometry(1, 64, 8, d, 4).smem_bytes == \
        KA.paged_tile_smem_bytes(8, 64, d, 4)
    assert KA.flash_geometry(4, 48, 1, d, 2) is None
    assert KA.flash_blocks(4, 48, 256, 1, d, 2).block_kv == 32


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("tuned", [None, 4, 8, 16, 32, 512])
def test_flash_and_prefill_launch_the_same_block_q(tuned, group, itemsize):
    """A chunk `block_q` tuned on the flash kernel launches as is on paged
    prefill, whatever the dtype's tile."""
    for rows in (256, 5):
        assert KA.flash_blocks(tuned, None, rows, group, 128, itemsize).block_q == \
            KA.prefill_block_q(tuned, rows, group)


def test_wallclock_fitness_times_attention_once_per_tile():
    fit = WallClockFitness(device="cpu", repeats=1, warmup=0)
    op = _serve_attention_ops()["prefill_chunk.attention"]
    op = dataclasses.replace(op, dims=tuple((k, 16 if k in ("q", "kv") else v)
                                            for k, v in op.dims), dtype="float32")
    t = [fit(op, {"block_q": 8, "block_kv": 16, "max_segments": m}) for m in (1, 2, 8)]
    assert t[0] == t[1] == t[2] > 0 and fit.measured == 1 and fit.evals == 3
    assert fit(op, {"block_q": 4, "block_kv": 16, "max_segments": 1}) > 0
    assert fit.measured == 2 and fit.vendor_time(op) > 0


# ------------------------------------------------------------------ engine
def small_graph(graph_cls):
    """tests/test_plan_select.py::_small_graph with its attention made MHA
    (the vendor lane's attention has no GQA in either package)."""
    g = graph_cls("unit")
    x = g.add_input("x", (4, 64, 128))
    w = g.add_input("w", (128, 256))
    mm = g.add_node("matmul", [x, w], (4, 64, 256), name="proj")
    q = g.add_input("q", (2, 64, 4, 32))
    k = g.add_input("k", (2, 64, 4, 32))
    att = g.add_node("attention", [q, k, k], (2, 64, 4, 32), name="attn")
    g.set_outputs([mm, att])
    return g


def test_engine_runs_a_jax_attention_plan_like_the_jax_engine(tmp_path):
    jg, pg = small_graph(JGraph), small_graph(Graph)
    jplan = j_select(jg, tuner=JTuner(methods=("random",), random_budget=8),
                     third_party=False)
    assert jplan.choices["attn"].backend == "pallas_attention"
    path = tmp_path / "plan.json"
    jplan.save(str(path))
    plan = InferencePlan.load(str(path))
    rng = np.random.default_rng(1)
    ins = [(rng.standard_normal(jg.tensors[n].shape) * 0.5).astype(np.float32)
           for n in jg.inputs]
    want = [np.asarray(o) for o in JEngine(jg, jplan, jax_registry(interpret=True))(
        *[jnp.asarray(a) for a in ins])]
    eng = Engine(pg, plan, default_registry(), device="cpu")
    got = [o.numpy() for o in eng(*[_t(a) for a in ins])]
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_, w_, rtol=0,
                                   atol=NET_RTOL * max(1.0, float(np.abs(w_).max())))
    assert eng.verify_against_reference(*[_t(a) for a in ins], rtol=0, atol=1e-4) <= 1e-4


# -------------------------------------------------------------- serve plan
def _structure(g):
    return ([(n.op, n.name, n.inputs, n.outputs, json.dumps(n.attrs, sort_keys=True))
             for n in g.nodes],
            {k: (tuple(v.shape), v.dtype) for k, v in g.tensors.items()},
            g.inputs, g.outputs)


@pytest.mark.parametrize("kw", [dict(SERVE, dtype="bfloat16"),
                                dict(prefill_len=32, slots=4, max_seq=64)],
                         ids=["serving_widths_bf16", "default_chunk_f32"])
def test_serve_graph_is_the_jax_serve_graph(kw):
    jg = jrouter.build_serve_graph(jax_get_config("qwen3-1.7b"), **kw)
    pg = build_serve_graph(get_config("qwen3-1.7b"), **kw)
    assert _structure(pg) == _structure(jg)
    assert len(pg.nodes) == 15


class FakeWallClock(Fitness):
    """A deterministic stand-in for the card: a kernel config priced off the
    roofline with a penalty per tile size, the vendor lane at a fixed
    factor (attention below the kernel, matmuls above it)."""

    kind = "wallclock"

    def __init__(self):
        self.evals = 0

    def __call__(self, op, cfg):
        self.evals += 1
        penalty = abs(np.log2(cfg.get("block_q", 16) / 16)) + \
            abs(np.log2(cfg.get("block_kv", 64) / 64))
        return roofline_bound(op) * (3.0 + penalty)

    def vendor_time(self, op):
        return roofline_bound(op) * (2.5 if op.kind == "attention" else 3.5)


def _ga_tuner(fitness):
    """The genetic search alone: the serve plan's structure does not depend
    on the method (RL-search: tests/test_torch_search_rl.py)."""
    return Tuner(fitness=fitness, methods=("genetic",))


class _OneWide:
    shape = {"data": 1, "model": 1}


def test_build_serve_plan_with_an_injected_fitness_covers_every_node(monkeypatch):
    cfg = get_config("qwen3-1.7b")
    plan = build_serve_plan(cfg, **SERVE, tuner=_ga_tuner(FakeWallClock()))
    graph = build_serve_graph(cfg, **SERVE, dtype="bfloat16")
    assert sorted(plan.choices) == sorted(n.name for n in graph.nodes)
    assert plan.chip == hw.H100.name
    for name, c in plan.choices.items():
        kernel = "pallas_attention" if name.endswith("attention") else "pallas_matmul"
        assert set(c.candidates) == {"xla", kernel}
        assert c.modeled_time_s == min(c.candidates.values())
        assert c.backend == ("xla" if kernel == "pallas_attention" else kernel)
    chunk = plan.choices["prefill_chunk.attention"]
    assert chunk.config == {}
    router = PlanRouter(plan)
    assert router.attention_backend("decode") == ("torch", {})
    backend, mm_cfg = router.matmul_table("decode")["mlp_up"]
    assert backend == "cuda_matmul" and set(mm_cfg) == {"tile_m", "split_k"}
    assert TEMPLATES["pallas_matmul"].validate(
        OpDesc.matmul(SERVE["slots"], cfg.d_ff, cfg.d_model), mm_cfg)
    assert router.layout_table("decode") == dict.fromkeys(
        ("qkv_proj", "mlp_up", "mlp_down", "lm_head", "attention"), "replicated")
    assert len(router.describe()) == 15
    # the layout race: every serving-stage node of qwen3-1.7b divides 2,
    # so each carries both layouts' times and the faster one's verdict
    tp_plan = build_serve_plan(cfg, **SERVE, tuner=_ga_tuner(FakeWallClock()),
                               model_parallel=2)
    for name, c in tp_plan.choices.items():
        assert set(c.layout_candidates) == {"replicated", "model_parallel"}, name
        lc = c.layout_candidates
        assert c.layout == min(lc, key=lc.get) or lc["replicated"] == lc[c.layout]
    # the ssm family's graph (its own stages, no attention) is ported too
    assert len(build_serve_graph(get_config("mamba2-2.7b"), **SERVE,
                                 family="ssm").nodes) == 6
    # serve_rules on a 1-wide model axis hands the base rules back untouched
    assert router.serve_rules(DEFAULT_RULES, _OneWide(), cfg) is DEFAULT_RULES
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        build_serve_plan(cfg, **SERVE)


def test_serve_plan_kernel_choices_carry_the_tuned_tile_and_packing():
    class KernelWins(FakeWallClock):
        def vendor_time(self, op):
            return roofline_bound(op) * 10.0

    plan = build_serve_plan(get_config("qwen3-1.7b"), **SERVE,
                            tuner=_ga_tuner(KernelWins()))
    assert set(plan.backend_histogram()) == {"pallas_attention", "pallas_matmul"}
    for stage in ("prefill", "decode", "prefill_chunk"):
        cfg = plan.choices[f"{stage}.attention"].config
        assert (cfg["block_q"], cfg["block_kv"]) == ((4, 64) if stage == "decode"
                                                     else (16, 64))
        assert ("max_segments" in cfg) == (stage == "prefill_chunk")
    router = PlanRouter(plan)
    backend, cfg = router.attention_backend("prefill_chunk")
    assert backend == "cuda_attention"
    assert router.chunk_segments(default=4) == cfg["max_segments"]


_LANES = {"xla": "torch", "pallas_attention": "cuda_attention",
          "pallas_matmul": "cuda_matmul"}


def _jax_plan(tmp_path, variant):
    """A serve plan the JAX package tuned (its model fitness) for the tiny
    config, saved and loaded by the port; 'alternate_xla' sends every other
    node to the vendor lane so both lanes of every query are exercised."""
    jcfg = jax_get_config("qwen3-1.7b").reduced(n_layers=2, d_model=64, d_ff=128,
                                                vocab=97, dtype="float32")
    jplan = jrouter.build_serve_plan(jcfg, prefill_len=40, slots=3, max_seq=64,
                                     chunk_tokens=16, dtype="float32",
                                     tuner=JTuner(methods=("random",), random_budget=8))
    if variant == "alternate_xla":
        for i, name in enumerate(sorted(jplan.choices)):
            if i % 2:
                jplan.choices[name] = JOpChoice("xla", {}, 1e-6, {"xla": 1e-6})
    path = tmp_path / "plan.json"
    jplan.save(str(path))
    return jcfg, jplan, InferencePlan.load(str(path))


@pytest.mark.parametrize("variant", ["as_tuned", "alternate_xla"])
def test_router_answers_a_jax_tuned_plan_like_the_jax_router(tmp_path, variant):
    _, jplan, plan = _jax_plan(tmp_path, variant)
    jr, pr = jrouter.PlanRouter(jplan), PlanRouter(plan)
    backends = set()
    for stage in ("prefill", "decode", "prefill_chunk"):
        jb, jc = jr.attention_backend(stage)
        assert pr.attention_backend(stage) == (_LANES[jb], jc)
        backends.add(jb)
        assert pr.matmul_table(stage) == {
            role: (_LANES[b], c) for role, (b, c) in jr.matmul_table(stage).items()}
        assert pr.layout_table(stage) == jr.layout_table(stage)
    for default in (1, 4):
        assert pr.chunk_segments(default=default) == jr.chunk_segments(default=default)
    assert pr.describe() == jr.describe()
    assert len(pr.describe()) == 15
    if variant == "alternate_xla":
        assert "xla" in set(pr.describe().values())


def test_tiny_engine_serves_under_a_jax_tuned_plan(tmp_path):
    jcfg, _, plan = _jax_plan(tmp_path, "alternate_xla")
    cfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(jcfg)})
    model = DecoderLM(cfg)
    params = model.serving_params(model.init(torch.Generator().manual_seed(0)), "cpu")
    rcfg = RuntimeConfig(max_slots=3, block_size=8, max_blocks_per_seq=8,
                         chunk_tokens=16, max_new_tokens=6)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 97, size=n).astype(np.int32) for n in (11, 30, 5, 40)]
    router = PlanRouter(plan)

    def run(router):
        eng = ContinuousEngine(model, params, rcfg, router=router, device="cpu")
        for p in prompts:
            eng.submit(p)
        done = eng.run()
        eng.cache.alloc.check_invariants()
        assert eng.cache.alloc.num_used == 0 and len(done) == len(prompts)
        return {r.rid: r.output for r in done}, eng

    tuned, eng = run(router)
    assert eng.adapter.chunk_segments == min(rcfg.chunk_segments,
                                             router.chunk_segments(rcfg.chunk_segments))
    untuned, _ = run(None)
    assert tuned == untuned
