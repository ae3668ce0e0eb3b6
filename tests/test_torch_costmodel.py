"""The port's search fitness: the analytic model of its H100 kernels
(`ModelFitness`), the measured fitness's capture path, and plans tuned on
the model with no GPU.

The model is held to
  * `roofline_bound` at every valid configuration of each template, at the
    reference's test shapes (`tests/test_search.py`'s MM and CONV, and an
    attention op with Sq = Skv), and to `kernel_bound` at every node of the
    qwen3-1.7b and mamba2-2.7b serve graphs;
  * every H100 device time PERF.md §6 records for rows 3, 4 and 6 and the
    row-3 table (NVIDIA H100 80GB HBM3, 700.00 W, CUDA-graph replay),
    within RECORD_FACTOR, ordering kernel against library as the card did
    at each shape;
  * the mechanism by which it prices `max_segments`
    (`tests/test_packed_prefill.py:305`'s counterpart).

With CUDA unavailable, `Tuner(fitness=ModelFitness())` runs GA and RL;
`select` / `build_serve_plan` build whole plans whose nodes are the JAX
package's; those plans run the port's `Engine` at
`tests/test_torch_wpk.py`'s tolerance against the JAX engine and serve the
JAX engine's streams; the search cache keeps model and measured entries
apart (`tests/test_search_cache.py`'s counterpart), and a JAX-written
cache's "tpu_v5e" model entries miss for the port's "h100_sxm" tuner.
"""

import contextlib
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, Mesh

from repro.configs import get_config as jax_get_config
from repro.core import Engine as JEngine
from repro.core import Tuner as JTuner
from repro.core import optimize_graph as j_optimize
from repro.core import select as j_select
from repro.core.schedules import OpDesc as JOpDesc
from repro.core.search import SearchCache as JSearchCache
from repro.distributed.sharding import DEFAULT_RULES
from repro.models import build_model
from repro.models.resnet import resnet18_graph as j_resnet18
from repro.serve import router as jrouter
from repro.serve.runtime import ContinuousEngine as JaxEngine
from repro.serve.runtime import RuntimeConfig as JaxRuntimeConfig
from repro_torch import hw
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import (Engine, ModelFitness, OpDesc, SearchCache, SearchTask,
                              TEMPLATES, Tuner, WallClockFitness, default_registry,
                              op_desc_of, optimize_graph, roofline_bound, select)
from repro_torch.core import costmodel as C
from repro_torch.kernels import matmul as KM
from repro_torch.models import DecoderLM
from repro_torch.models.resnet import conv_groups, resnet18_graph
from repro_torch.serve.router import PlanRouter, build_serve_graph, build_serve_plan
from repro_torch.serve.runtime import ContinuousEngine, RuntimeConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
# tests/test_search.py's shapes
MM = OpDesc.matmul(512, 1024, 768)
CONV = OpDesc.conv2d(1, 56, 56, 64, 128, 3, 3, stride=2)
ATT = OpDesc.attention(2, 1024, 1024, 8, 128)
# qwen3-1.7b's serve graph at the widths chip_smoke.py tunes
SERVE = dict(prefill_len=700, slots=8, max_seq=1024, chunk_tokens=256)
# every recorded device time within this factor of the model (the largest
# miss is torch.matmul at granite's k / v at M = 256: 0.0072 modeled
# against 0.0103 measured)
RECORD_FACTOR = 1.5
NET_RTOL = 1e-4                 # tests/test_torch_wpk.py's engine tolerance


# ------------------------------------------------------------ the records
# PERF.md §6, row 3's table at granite's and qwen2-moe's shapes and row 3's
# mamba2 shapes (device ms, the GEMM's default geometry / torch.matmul,
# bf16; + silu at mlp_up): (label, M, K, N, activation, kernel, library)
GEMM_RECORDS = [
    ("granite_qkv_m8", 8, 4096, 4096, None, .0177, .0138),
    ("granite_kv_m8", 8, 4096, 1024, None, .0108, .0080),
    ("granite_mlp_up_m8", 8, 4096, 12800, "silu", .0430, .0391),
    ("granite_mlp_down_m8", 8, 12800, 4096, None, .0412, .0386),
    ("granite_lm_head_m8", 8, 4096, 49155, None, .6077, .3372),
    ("moe_qkv_m8", 8, 2048, 2048, None, .0092, .0063),
    ("moe_shared_up_m8", 8, 2048, 5632, "silu", .0141, .0123),
    ("moe_shared_down_m8", 8, 5632, 2048, None, .0139, .0123),
    ("moe_lm_head_m8", 8, 2048, 151936, None, .2131, .2039),
    ("granite_qkv_m256", 256, 4096, 4096, None, .0521, .0178),
    ("granite_kv_m256", 256, 4096, 1024, None, .0242, .0103),
    ("granite_mlp_up_m256", 256, 4096, 12800, "silu", .1565, .0527),
    ("granite_mlp_down_m256", 256, 12800, 4096, None, .1418, .0481),
    ("granite_lm_head_m256", 256, 4096, 49155, None, 1.1597, .7207),
    ("moe_qkv_m256", 256, 2048, 2048, None, .0217, .0074),
    ("moe_shared_up_m256", 256, 2048, 5632, "silu", .0435, .0148),
    ("moe_shared_down_m256", 256, 5632, 2048, None, .0395, .0161),
    ("moe_lm_head_m256", 256, 2048, 151936, None, .5825, .2574),
    ("mamba_in_proj_m256", 256, 2560, 10576, None, .0943, .0260),
    ("mamba_out_proj_m256", 256, 5120, 2560, None, .0447, .0154),
    ("mamba_lm_head_m1", 1, 2560, 50280, None, .1097, .0865),
    ("mamba_in_proj_m8", 8, 2560, 10576, None, .0252, .0211),
    ("mamba_out_proj_m8", 8, 5120, 2560, None, .0152, .0134),
    ("mamba_lm_head_m8", 8, 2560, 50280, None, .1128, .0876),
    # qwen3 lm_head at M = 256: 265 against cuBLAS's 601 TFLOP/s
    ("qwen3_lm_head_m256", 256, 2048, 151936, None,
     2 * 256 * 2048 * 151936 / 265e12 * 1e3, 2 * 256 * 2048 * 151936 / 601e12 * 1e3),
]
# row 3's ResNet-18 fc in f32 + bias against torch.addmm
FC_RECORD = (1, 512, 1000, .0105, .0036)
# row 4: ResNet-18's 20 convs (f32, bias + relu) at their fastest
# configurations, and F.conv2d on cuDNN (TF32 off) + relu
CONV_RECORD = (.4621, 1.0567)
# row 6: the flash kernel at the serve graph's three attention shapes
# (H 16, D 128, bf16, default tiles): (label, B, Sq, Skv, kernel)
FLASH_RECORDS = [("prefill", 1, 700, 700, .0293), ("decode", 8, 1, 1024, .0037),
                 ("chunk", 1, 256, 1024, .0087)]


def _within(model_ms, record_ms):
    return 1 / RECORD_FACTOR <= model_ms / record_ms <= RECORD_FACTOR


@pytest.mark.parametrize("rec", GEMM_RECORDS + [("fc_f32", *FC_RECORD[:2], FC_RECORD[2],
                                                 None, *FC_RECORD[3:])],
                         ids=lambda r: r[0])
def test_model_meets_the_recorded_gemm_times(rec):
    label, m, k, n, act, kernel_ms, library_ms = rec
    dtype = "float32" if label == "fc_f32" else "bfloat16"
    op = OpDesc.matmul(m, n, k, dtype=dtype, activation=act)
    kernel = 1e3 * C.kernel_time(op, {})
    library = 1e3 * C.cublas_time(m, n, k, dtype)
    if act:
        library += 1e3 * C.elementwise_time(2 * m * n * hw.itemsize(dtype))
    assert _within(kernel, kernel_ms), (kernel, kernel_ms)
    assert _within(library, library_ms), (library, library_ms)
    assert (kernel > library) == (kernel_ms > library_ms)


def _resnet_convs():
    """[(f32 conv OpDesc with relu, occurrences in one forward)]."""
    gopt = optimize_graph(resnet18_graph(batch=1, image=224))
    dims = [op_desc_of(gopt, n).dims for n in gopt.nodes if n.op == "fused_conv2d"]
    return [(OpDesc.make("conv2d", op.d, "float32", "relu"), dims.count(op.dims))
            for _, op in conv_groups(1, 224)]


def test_model_meets_the_recorded_conv_times():
    convs = _resnet_convs()
    assert sum(n for _, n in convs) == 20
    tmpl = TEMPLATES["pallas_conv2d"]
    best = {op: min(C.kernel_time(op, c) for c in tmpl.enumerate_configs(op))
            for op, _ in convs}
    # the library call: F.conv2d with its bias, then relu
    library = {op: C.cudnn_time(op) + C.elementwise_time(
        2 * op.d["oh"] * op.d["ow"] * op.d["cout"] * 4) for op, _ in convs}
    kernel_ms = 1e3 * sum(n * best[op] for op, n in convs)
    library_ms = 1e3 * sum(n * library[op] for op, n in convs)
    assert _within(kernel_ms, CONV_RECORD[0]) and _within(library_ms, CONV_RECORD[1])
    assert kernel_ms < library_ms
    stem = convs[0][0]
    assert stem.d["cin"] == 3 and best[stem] > library[stem]   # PERF.md §5 (6)


@pytest.mark.parametrize("rec", FLASH_RECORDS, ids=lambda r: r[0])
def test_model_meets_the_recorded_flash_times(rec):
    _, b, sq, skv, kernel_ms = rec
    # the race prices the node on MHA-shaped K/V (an OpDesc has no Hkv)
    op = OpDesc.attention(b, sq, skv, 16, 128)
    assert _within(1e3 * C.kernel_time(op, {}), kernel_ms)
    # the vendor lane materializes the f32 logits: slower at every node
    assert C.vendor_model_time(op) > C.kernel_time(op, {})


# ------------------------------------------------------------- the bounds
@pytest.mark.parametrize("op", [MM, CONV, ATT], ids=["mm", "conv", "attention"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_model_is_never_below_the_roofline(op, dtype):
    """tests/test_search.py:128's counterpart, at every valid config."""
    op = OpDesc.make(op.kind, op.d, dtype)
    tmpl = [t for t in TEMPLATES.values() if op.kind in t.kinds][0]
    configs = list(tmpl.enumerate_configs(op))
    assert configs
    bound = roofline_bound(op)
    for cfg in configs:
        assert C.kernel_time(op, cfg) >= bound, cfg
    assert C.vendor_model_time(op) >= bound


def _serve_ops(name):
    family = "ssm" if name.startswith("mamba") else "decoder"
    g = build_serve_graph(get_config(name), **SERVE, dtype="bfloat16", family=family)
    return [op_desc_of(g, n, "bfloat16") for n in g.toposort()]


@pytest.mark.parametrize("name", ["qwen3-1.7b", "mamba2-2.7b"])
def test_model_is_never_below_the_kernel_bound_on_the_serve_graphs(name):
    for op in _serve_ops(name):
        tmpl = [t for t in TEMPLATES.values() if op.kind in t.kinds][0]
        bound = C.kernel_bound(op)
        assert bound <= roofline_bound(op)
        for cfg in tmpl.enumerate_configs(op):
            assert C.kernel_time(op, cfg) >= bound, (op.label, cfg)


def test_kernel_bound_counts_the_keys_the_top_left_mask_shows():
    decode = OpDesc.attention(8, 1, 1024, 16, 128)
    assert C.kernel_bound(decode) == roofline_bound(OpDesc.attention(8, 1, 1, 16, 128))
    # the recorded device time is below roofline_bound there, not kernel_bound
    assert C.kernel_bound(decode) < .0037e-3 < roofline_bound(decode)
    for op in (MM, CONV, ATT):
        assert C.kernel_bound(op) == roofline_bound(op)


# --------------------------------------------------------- max_segments
def test_max_segments_is_priced_by_the_packing_mechanism():
    """One launch shared by ns segments against a second pass per segment
    boundary: at the serve graph's chunk shape packing two segments pays
    and eight do not; on a tiny chunk no packing pays; a config without
    the key prices as width 1."""
    chunk = OpDesc.attention(1, 256, 1024, 16, 128, label="prefill_chunk.attention")
    base = {"block_q": 16, "block_kv": 64}
    t = {ns: C.kernel_time(chunk, dict(base, max_segments=ns)) for ns in (1, 2, 4, 8)}
    assert C.kernel_time(chunk, base) == t[1]
    assert t[2] < t[1] and t[8] > t[2]
    tiny = OpDesc.attention(1, 32, 96, 4, 64, label="prefill_chunk.attention")
    assert C.kernel_time(tiny, dict(base, max_segments=2)) > C.kernel_time(tiny, base)
    # the model ranks the widths; the measured fitness ties them
    fit = ModelFitness()
    assert len({fit(chunk, dict(base, max_segments=ns)) for ns in (1, 2, 4, 8)}) == 4
    assert C.UNPRICED_KEYS == ("max_segments",)


# ------------------------------------------- geometry read from the kernels
def test_gemm_threads_and_shared_memory_mirror_matmul_cu():
    src = open(os.path.join(CSRC, "matmul.cu")).read()
    tiles = re.findall(r"X\((\d+), (\d+), (\d+), (\d+), (\d+), (\d+)\)", src)
    assert {int(t[0]): int(t[4]) * int(t[5]) * 32 for t in tiles} == KM.GEMM_THREADS
    assert int(re.search(r"F_THREADS = (\d+)", src).group(1)) == KM.GEMM_THREADS_F32
    for bm, (bm_, bn, bk, stages) in KM.GEMM_TILES.items():
        geo = KM.GemmGeometry(bm_, bn, bk, stages, 1)
        ring = stages * (bm * (bk + 8) + bk * (bn + 8)) * 2
        assert KM.tile_smem_bytes(geo, 2) == max(ring, bm * (bn + 4) * 4)
        # two CTAs of every bf16 tile are resident on an SM
        assert hw.H100.resident_blocks(KM.tile_smem_bytes(geo, 2),
                                       KM.tile_threads(geo, 2)) == 2


def test_model_reads_the_launch_geometry_of_the_kernels(monkeypatch):
    """The model takes the GEMM's, the conv's and the flash kernel's
    geometry from their own modules: a config they refuse raises."""
    seen = []
    real = KM.geometry

    def spy(*a):
        seen.append(a)
        return real(*a)

    monkeypatch.setattr(KM, "geometry", spy)
    op = OpDesc.matmul(8, 4096, 2048)
    C.kernel_time(op, {"tile_m": 16, "split_k": 8})
    assert seen == [(8, 4096, 2048, torch.bfloat16, 16, 8)]
    with pytest.raises(ValueError, match="cannot launch"):
        C.kernel_time(op, {"tile_m": 32, "split_k": 8})
    with pytest.raises(ValueError, match="cannot launch"):
        C.kernel_time(CONV, {"bn": 48, "row_block": 1})
    # the default geometry where a config has no GEMM knobs (JAX plans)
    geo = KM.gemm_geometry(8, 4096, 2048, torch.bfloat16)
    assert C.kernel_time(op, {"bm": 128}) == C.kernel_time(
        op, {"tile_m": geo.bm, "split_k": geo.split})


# ------------------------------------------------ tuning with no GPU
@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def one_thread():
    """torch on one intra-op thread while the tuners run (restored after
    the file): their many small products gain nothing from a thread pool,
    and beside other test processes its threads oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_defaults_stay_measured_and_raise_without_a_gpu(no_gpu):
    for make in (Tuner, WallClockFitness,
                 lambda: SearchTask(MM, TEMPLATES["pallas_matmul"]),
                 lambda: build_serve_plan(get_config("qwen3-1.7b"), **SERVE)):
        with pytest.raises(RuntimeError, match="GPU"):
            make()
    tuner = Tuner(fitness=ModelFitness())
    assert tuner.fitness_kind == "model" and tuner.rl.device == torch.device("cpu")


@pytest.fixture(scope="module")
def resnet32():
    return j_optimize(j_resnet18(batch=1, image=32)), optimize_graph(
        resnet18_graph(batch=1, image=32))


def test_model_tuned_resnet_plan_runs_like_the_jax_engine(resnet32, monkeypatch,
                                                          one_thread):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jgopt, pgopt = resnet32
    tuner = Tuner(fitness=ModelFitness())                 # genetic and RL-search
    plan = select(pgopt, tuner=tuner, dtype="float32")
    assert {r.method for r in tuner.log} == {"genetic", "rl"}
    assert plan.chip == "h100_sxm"
    jplan = j_select(jgopt, tuner=JTuner(methods=("random",), random_budget=4),
                     dtype="float32")
    assert sorted(plan.choices) == sorted(jplan.choices)
    nodes = {n.name: n for n in pgopt.nodes}
    for name, c in plan.choices.items():
        assert c.modeled_time_s == min(c.candidates.values())
        if c.backend != "xla":
            assert TEMPLATES[c.backend].validate(
                op_desc_of(pgopt, nodes[name], "float32"), c.config)
    wpk = select(pgopt, tuner=tuner, dtype="float32", third_party=False)
    assert set(wpk.backend_histogram()) <= {"pallas_conv2d", "pallas_matmul"}
    x = np.random.default_rng(2).standard_normal((1, 3, 32, 32)).astype(np.float32)
    want = np.asarray(JEngine(jgopt)(jnp.asarray(x))[0])
    tol = NET_RTOL * max(1.0, float(np.abs(want).max()))
    for p in (plan, wpk):
        got = Engine(pgopt, p, default_registry(), device="cpu")(torch.from_numpy(x))[0]
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("name", ["qwen3-1.7b", "mamba2-2.7b"])
def test_model_tuned_serve_plans_cover_the_jax_graphs(name, no_gpu, one_thread):
    family = "ssm" if name.startswith("mamba") else "decoder"
    tuner = Tuner(fitness=ModelFitness())
    plan = build_serve_plan(get_config(name), **SERVE, tuner=tuner, family=family)
    jplan = jrouter.build_serve_plan(
        jax_get_config(name), **SERVE, family=family,
        tuner=JTuner(methods=("random",), random_budget=4))
    assert sorted(plan.choices) == sorted(jplan.choices)
    assert {r.method for r in tuner.log} == {"genetic", "rl"}
    for c in plan.choices.values():
        assert c.modeled_time_s == min(c.candidates.values()) > 0
    if family == "ssm":
        return
    router = PlanRouter(plan)
    backend, cfg = router.attention_backend("prefill_chunk")
    assert backend == "cuda_attention" and "max_segments" in cfg
    assert router.chunk_segments(default=4) == cfg["max_segments"]


# the serving differential of tests/test_torch_serving.py, under a plan
# tuned on the model for the tiny config
RUNTIME = dict(max_slots=3, block_size=8, max_blocks_per_seq=8, chunk_tokens=16,
               num_blocks=9, max_new_tokens=10)
PROMPT_LENS = (11, 30, 5, 40, 3, 22)


def test_model_tuned_plan_serves_the_jax_engines_streams(no_gpu, one_thread):
    jcfg = jax_get_config("qwen3-1.7b").reduced(n_layers=2, d_model=64, d_ff=128,
                                                vocab=97, dtype="float32")
    tcfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)})
    plan = build_serve_plan(tcfg, prefill_len=40, slots=3, max_seq=64, chunk_tokens=16,
                            dtype="float32", tuner=Tuner(fitness=ModelFitness()))
    router = PlanRouter(plan)
    segments = min(4, router.chunk_segments(default=4))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 97, size=n).astype(np.int32) for n in PROMPT_LENS]

    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"),
                axis_types=(AxisType.Auto, AxisType.Auto))
    jeng = JaxEngine(jmodel, jparams, mesh, DEFAULT_RULES,
                     JaxRuntimeConfig(**RUNTIME, chunk_segments=segments))
    for p in prompts:
        jeng.submit(p)
    with mesh:
        want = {r.rid: [int(t) for t in r.output] for r in jeng.run()}

    eng = ContinuousEngine(DecoderLM(tcfg), params_from_jax(
        jax.tree.map(np.asarray, jparams)), RuntimeConfig(**RUNTIME), router=router,
        device="cpu")
    assert eng.adapter.chunk_segments == segments
    for p in prompts:
        eng.submit(p)
    got = {r.rid: [int(t) for t in r.output] for r in eng.run()}
    assert got == want and len(got) == len(prompts)
    eng.cache.alloc.check_invariants()


# ------------------------------------------------------------- the cache
def test_cache_keeps_model_and_measured_entries_apart():
    """tests/test_search_cache.py's three regressions, on the port."""
    cache = SearchCache()
    cache.put("h100_sxm", MM, "pallas_matmul", {"tile_m": 64, "split_k": 1}, 1e-4,
              "genetic", fitness="model")
    assert cache.get("h100_sxm", MM, "pallas_matmul", fitness="model") is not None
    assert cache.get("h100_sxm", MM, "pallas_matmul", fitness="wallclock") is None
    legacy = f"h100_sxm|pallas_conv2d|{CONV.signature()}"
    cache._store[legacy] = {"config": {"bn": 64, "row_block": 1}, "runtime_s": 1e-4,
                            "method": "genetic"}
    assert cache.get("h100_sxm", CONV, "pallas_conv2d", fitness="model")["config"] == \
        {"bn": 64, "row_block": 1}
    assert cache.get("h100_sxm", CONV, "pallas_conv2d", fitness="wallclock") is None

    class Detuned(ModelFitness):
        kind = "wallclock"

        def __call__(self, op, cfg):
            self.evals += 1
            return 10.0 + C.kernel_time(op, cfg)

    cache = SearchCache()
    model = Tuner(fitness=ModelFitness(), methods=("genetic",), cache=cache)
    r_model = model.tune(MM)
    wall = Tuner(fitness=Detuned(), methods=("genetic",), cache=cache)
    r_wall = wall.tune(MM)
    assert "cache" not in r_wall.method and r_wall.runtime_s >= 10.0
    assert model.tune(MM).method.endswith("+cache")
    assert model.tune(MM).runtime_s == r_model.runtime_s
    assert wall.tune(MM).runtime_s == r_wall.runtime_s


def test_a_jax_cache_files_tpu_entries_miss_for_the_h100_tuner(tmp_path):
    path = str(tmp_path / "cache.json")
    jcache = JSearchCache(path)
    JTuner(methods=("genetic",), cache=jcache).tune(JOpDesc.matmul(512, 1024, 768))
    jcache.save()
    cache = SearchCache(path)
    assert cache.get("tpu_v5e", MM, "pallas_matmul", fitness="model") is not None
    tuner = Tuner(fitness=ModelFitness(), methods=("genetic",), cache=cache)
    res = tuner.tune(MM)
    assert "cache" not in res.method                   # searched, not served
    assert TEMPLATES["pallas_matmul"].validate(MM, res.config)
    assert cache.get("h100_sxm", MM, "pallas_matmul", fitness="model")["config"] == \
        res.config


# -------------------------------------------------- the measured fitness
def test_wallclock_fitness_on_the_cpu_keeps_the_host_clock(monkeypatch):
    fit = WallClockFitness(device="cpu", repeats=3, warmup=1)
    op = OpDesc.matmul(4, 8, 16, dtype="float32")
    assert len(fit.inputs(op)) == 1              # no L2 to defeat on the host
    ticks = []
    real = C.time.perf_counter
    monkeypatch.setattr(C.time, "perf_counter", lambda: ticks.append(1) or real())
    t = fit(op, {})
    assert t > 0 and len(ticks) == 2 * 3
    assert fit(op, {}) == t and fit.measured == 1 and fit.evals == 2
    # a scheduler knob shares the measurement
    chunk = OpDesc.attention(1, 4, 8, 2, 8, dtype="float32", label="prefill_chunk.a")
    a = fit(chunk, {"block_q": 4, "block_kv": 8, "max_segments": 1})
    assert fit(chunk, {"block_q": 4, "block_kv": 8, "max_segments": 4}) == a
    assert fit.measured == 2


def test_copies_for_defeats_l2():
    assert C.copies_for(1) == 16
    assert C.copies_for(hw.H100.l2_bytes) == 2
    assert C.copies_for(16 * 2**20) == 7         # a qwen3 qkv weight
    assert C.copies_for(10 * hw.H100.l2_bytes) == 1


class _FakeGraph:
    def __init__(self):
        self.replayed = 0

    def replay(self):
        self.replayed += 1


class _FakeEvent:
    clock = [0.0]

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        _FakeEvent.clock[0] += 1.0
        self.t = _FakeEvent.clock[0]

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t                    # ms


def test_wallclock_fitness_on_the_gpu_replays_one_captured_graph(monkeypatch):
    """The device-time path with the graph API stubbed: the calls cycle
    through the input copies inside one capture of `launch.program`'s
    (garbage collector off), after one eager warm-up; `warmup` untimed
    replays, then `repeats` replays between events; a replay's time is
    divided by the calls it holds."""
    graphs, gc_states = [], []

    def fake_graph(graph, pool=None):
        gc_states.append(C_gc.isenabled())
        graphs.append(graph)
        return contextlib.nullcontext()

    import gc as C_gc
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", fake_graph)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    fit = WallClockFitness(device="cpu", repeats=5, warmup=2)
    fit.device = torch.device("cuda")            # as on the card
    monkeypatch.setattr("repro_torch.launch.program._Signature.__init__",
                        lambda self, inputs, device: _plain_signature(self))
    calls = []
    fns = [lambda i=i: calls.append(i) for i in range(6)]
    ms = fit.time(fns)
    assert len(graphs) == 1 and gc_states == [False]
    assert graphs[0].replayed == 2 + 5
    # eager warm-up, then the capture: both walk the copies in turn
    assert calls == [0, 1, 2, 3, 4, 5] * 2
    assert ms == pytest.approx(1.0 / 1e3 / 6)    # one event tick a replay
    calls.clear()
    fit.time([lambda: calls.append("x")])
    assert calls == ["x"] * 2 * WallClockFitness.GRAPH_CALLS


def _plain_signature(sig):
    sig.static, sig.staging, sig.copied = [], [], None
    sig.graph = sig.outputs = None
    sig.launches = {}


def test_wallclock_inputs_keep_the_lanes_free_of_casts():
    fit = WallClockFitness(device="cpu")
    mm = OpDesc.matmul(4, 8, 16)
    x, w, b = fit.inputs(mm)[0]
    assert x.dtype == w.dtype == b.dtype == torch.bfloat16
    conv = OpDesc.conv2d(1, 8, 8, 4, 8, 3, 3, dtype="bfloat16")
    assert fit.inputs(conv)[0][2].dtype == torch.float32
    assert len(fit.kernel_runner(mm, {})) == len(fit.vendor_runner(mm)) == 1


def test_model_fitness_prices_both_lanes_on_the_host():
    fit = ModelFitness()
    assert fit.kind == "model" and fit.device == torch.device("cpu")
    for op in (MM, CONV, ATT):
        tmpl = [t for t in TEMPLATES.values() if op.kind in t.kinds][0]
        cfg = next(tmpl.enumerate_configs(op))
        assert fit(op, cfg) == C.kernel_time(op, cfg) > 0
        assert fit.vendor_time(op) == C.vendor_model_time(op) > 0
    assert fit.evals == 3
