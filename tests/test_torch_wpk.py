"""The port's WPK pipeline (graph, passes, ref_ops, kernels' plain
versions, search, selection, plan, Engine) on the CPU, held against the
JAX package on the same numpy-seeded inputs.

The JAX side runs as its own tests run it on the CPU: XLA for `ref_ops`,
Pallas in interpret mode for the kernels, the analytical TPU model as the
search fitness where a plan is needed.  The port's CUDA kernels are held
against the same plain versions on the card by `chip_smoke.py`.

Tolerances: f32 throughout.  Single ops agree to 1e-5 (different
reduction orders), convolutions to 1e-4 (the CPU conv libraries on the two
sides, oneDNN and XLA's, may each pick another algorithm, Winograd among
them, whose f32 error reaches 1e-5 to 1e-4 at these sizes — a padding or
layout fault is off by O(0.1)); whole networks to 1e-4 relative to the
largest logit.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Engine as JEngine
from repro.core import Graph as JGraph
from repro.core import Tuner as JTuner
from repro.core import default_registry as jax_registry
from repro.core import optimize_graph as j_optimize
from repro.core import ref_ops as jref_ops
from repro.core import select as j_select
from repro.core.schedules import OpDesc as JOpDesc
from repro.core.schedules import Template as JTemplate
from repro.core.search import GeneticSearch as JGeneticSearch
from repro.core.search import SearchCache as JSearchCache
from repro.core.search import SearchTask as JSearchTask
from repro.kernels import ops as jops
from repro.models.resnet import conv_groups as j_conv_groups
from repro.models.resnet import resnet18_graph as j_resnet18
from repro_torch import hw
from repro_torch.core import (Engine, Graph, InferencePlan, OpDesc, SearchCache,
                              SearchTask, TEMPLATES, Tuner, WallClockFitness,
                              default_registry, optimize_graph, roofline_bound,
                              select)
from repro_torch.core import ref_ops
from repro_torch.core.costmodel import Fitness
from repro_torch.core.schedules import Template
from repro_torch.core.search import GeneticSearch, RLSearch
from repro_torch.core.selection import VENDOR
from repro_torch.kernels import conv2d as KC
from repro_torch.kernels import ops
from repro_torch.models.resnet import conv_groups, resnet18_graph
from repro_torch.serve.kvcache import KVCacheConfig, PagedKVCache

OP_TOL = dict(rtol=1e-5, atol=1e-5)
CONV_TOL = dict(rtol=1e-4, atol=1e-4)
NET_RTOL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def mini_convnet(graph_cls):
    """The mini convnet of tests/test_engine_e2e.py, in either package."""
    rng = np.random.default_rng(0)
    g = graph_cls("mini")
    x = g.add_input("x", (2, 3, 16, 16))
    w1 = g.add_constant("w1", rng.standard_normal((8, 3, 3, 3)).astype(np.float32) * 0.2)
    c1 = g.add_node("conv2d", [x, w1], (2, 8, 16, 16), {"stride": 1, "padding": "SAME"})
    sc = g.add_constant("sc", (rng.random(8) + 0.5).astype(np.float32))
    sh = g.add_constant("sh", rng.standard_normal(8).astype(np.float32) * 0.1)
    b1 = g.add_node("batch_norm", [c1, sc, sh], (2, 8, 16, 16))
    r1 = g.add_node("relu", [b1], (2, 8, 16, 16))
    gp = g.add_node("global_avg_pool", [r1], (2, 8))
    wf = g.add_constant("wf", rng.standard_normal((8, 10)).astype(np.float32) * 0.3)
    mm = g.add_node("matmul", [gp, wf], (2, 10))
    g.set_outputs([mm])
    return g


def folding_graph(graph_cls):
    """A graph with a constant-only subgraph (add, transpose, relu of
    constants) feeding a matmul, so constant folding has work to do."""
    rng = np.random.default_rng(3)
    g = graph_cls("fold")
    x = g.add_input("x", (4, 6))
    a = g.add_constant("a", rng.standard_normal((5, 6)).astype(np.float32))
    b = g.add_constant("b", rng.standard_normal((5, 6)).astype(np.float32))
    s = g.add_node("add", [a, b], (5, 6))
    t = g.add_node("transpose", [s], (6, 5), {"perm": [1, 0]})
    r = g.add_node("gelu", [t], (6, 5))
    y = g.add_node("matmul", [x, r], (4, 5))
    y = g.add_node("tanh", [y], (4, 5))
    g.set_outputs([y])
    return g


GRAPHS = {
    "resnet18_32": (lambda: j_resnet18(batch=1, image=32),
                    lambda: resnet18_graph(batch=1, image=32)),
    "mini_convnet": (lambda: mini_convnet(JGraph), lambda: mini_convnet(Graph)),
    "folding": (lambda: folding_graph(JGraph), lambda: folding_graph(Graph)),
}


def _structure(g):
    return ([(n.op, n.name, n.inputs, n.outputs, json.dumps(n.attrs, sort_keys=True))
             for n in g.nodes],
            {k: (v.shape, v.dtype) for k, v in g.tensors.items()},
            g.inputs, g.outputs, sorted(g.constants))


# ----------------------------------------------------------------- graphs
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_constructors_are_bitwise_the_jax_graphs(name):
    jg, pg = GRAPHS[name][0](), GRAPHS[name][1]()
    assert _structure(pg) == _structure(jg)
    for k, v in jg.constants.items():
        assert pg.constants[k].dtype == v.dtype
        np.testing.assert_array_equal(pg.constants[k], v)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_optimize_graph_matches_jax(name):
    jg, pg = j_optimize(GRAPHS[name][0]()), optimize_graph(GRAPHS[name][1]())
    assert _structure(pg) == _structure(jg)
    for k, v in jg.constants.items():
        np.testing.assert_allclose(pg.constants[k], np.asarray(v), rtol=0, atol=1e-6)


def test_optimized_resnet18_keeps_the_jax_histogram_and_groups():
    gopt = optimize_graph(resnet18_graph(batch=1, image=224))
    assert gopt.op_histogram() == {"transpose": 25, "fused_conv2d": 20, "max_pool": 1,
                                   "fused_elementwise": 8, "global_avg_pool": 1,
                                   "fused_matmul": 1}
    chains = [n.attrs["chain"] for n in gopt.nodes if n.op == "fused_elementwise"]
    assert chains == [[{"op": "add"}, {"op": "relu"}]] * 8
    groups = conv_groups(batch=1, image=224)
    assert len(groups) == 11
    assert [op.signature() for _, op in groups] == [
        JOpDesc(op.kind, op.dims, op.dtype, op.activation, op.label).signature()
        for _, op in groups]


# ---------------------------------------------------------------- ref_ops
def _conv_case(k, stride, layout, padding="SAME", act=None, bias=True, hw_=(11, 12)):
    rng = np.random.default_rng(k * 10 + stride)
    cin, cout = 5, 7
    xs = (2, cin) + hw_ if layout == "NCHW" else (2,) + hw_ + (cin,)
    ws = (cout, cin, k, k) if layout == "NCHW" else (k, k, cin, cout)
    ins = [rng.standard_normal(xs), rng.standard_normal(ws) * 0.3]
    if bias:
        ins.append(rng.standard_normal(cout) * 0.1)
    attrs = {"stride": stride, "padding": padding, "layout": layout}
    if act:
        attrs["activation"] = act
    return "fused_conv2d", ins, attrs


def _cases():
    rng = np.random.default_rng(7)
    r = lambda *s: rng.standard_normal(s)
    cases = {}
    for k in (1, 3, 7):
        for stride in (1, 2):
            for layout in ("NCHW", "NHWC"):
                cases[f"conv_k{k}_s{stride}_{layout}"] = _conv_case(k, stride, layout)
    cases["conv_224_stem_asymmetric_pad"] = _conv_case(7, 2, "NHWC", hw_=(24, 24))
    cases["conv_valid_relu"] = _conv_case(3, 2, "NCHW", "VALID", "relu")
    cases["conv_nobias_gelu"] = _conv_case(3, 1, "NHWC", act="gelu", bias=False)
    rect = _conv_case(3, 2, "NCHW")
    rect[1][1] = rect[1][1][:, :, :, :2]                  # a 3 x 2 window
    cases["conv_3x2_window_s2"] = rect
    for op, layout, k, s, pad in [("max_pool", "NCHW", 3, 2, "SAME"),
                                  ("max_pool", "NHWC", 3, 2, "SAME"),
                                  ("max_pool", "NCHW", 2, 2, "VALID"),
                                  ("avg_pool", "NHWC", 3, 2, "SAME"),
                                  ("avg_pool", "NCHW", 3, 1, "SAME"),
                                  ("avg_pool", "NCHW", 2, 2, "VALID")]:
        x = r(2, 3, 10, 9) if layout == "NCHW" else r(2, 10, 9, 3)
        cases[f"{op}_{layout}_k{k}s{s}_{pad}"] = (
            op, [x], {"kernel": k, "stride": s, "padding": pad, "layout": layout})
    cases["matmul"] = ("matmul", [r(3, 4, 6), r(6, 5)], {})
    cases["fused_matmul_bias_silu"] = ("fused_matmul", [r(4, 6), r(6, 5), r(5)],
                                       {"activation": "silu"})
    cases["attention_causal"] = ("attention", [r(2, 5, 3, 8), r(2, 7, 3, 8), r(2, 7, 3, 8)], {})
    cases["attention_full"] = ("attention", [r(2, 5, 3, 8), r(2, 5, 3, 8), r(2, 5, 3, 8)],
                               {"causal": False})
    cases["bias_add_nchw"] = ("bias_add", [r(2, 4, 3, 3), r(4)], {})
    cases["bias_add_nhwc"] = ("bias_add", [r(2, 3, 3, 4), r(4)], {"layout": "NHWC"})
    cases["batch_norm_nchw"] = ("batch_norm", [r(2, 4, 3, 3), r(4), r(4)], {})
    cases["batch_norm_nhwc"] = ("batch_norm", [r(2, 3, 3, 4), r(4), r(4)], {"layout": "NHWC"})
    cases["layer_norm"] = ("layer_norm", [r(3, 8), r(8), r(8)], {"eps": 1e-5})
    cases["softmax"] = ("softmax", [r(3, 8)], {"axis": 0})
    cases["global_avg_pool_nchw"] = ("global_avg_pool", [r(2, 4, 3, 5)], {})
    cases["global_avg_pool_nhwc"] = ("global_avg_pool", [r(2, 3, 5, 4)], {"layout": "NHWC"})
    cases["reshape"] = ("reshape", [r(2, 3, 4)], {"shape": [6, 4]})
    cases["transpose"] = ("transpose", [r(2, 3, 4)], {"perm": [2, 0, 1]})
    cases["flatten"] = ("flatten", [r(2, 3, 4)], {})
    cases["concat"] = ("concat", [r(2, 3), r(2, 4)], {"axis": 1})
    cases["fused_elementwise"] = ("fused_elementwise", [r(3, 4), r(3, 4), r(3, 4) + 3.0],
                                  {"chain": [{"op": "add"}, {"op": "gelu"},
                                             {"op": "div"}, {"op": "exp"}]})
    for op in ("relu", "gelu", "silu", "tanh", "sigmoid", "identity", "dropout",
               "neg", "exp"):
        cases[op] = (op, [r(3, 5)], {})
    for op in ("add", "mul", "sub", "div"):
        cases[op] = (op, [r(3, 5), r(3, 5) + 4.0], {})
    return cases


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_ref_op_matches_jax(case):
    op, ins, attrs = CASES[case]
    ins = [np.asarray(a, np.float32) for a in ins]
    want = np.asarray(jref_ops.run_op(op, [jnp.asarray(a) for a in ins], attrs))
    got = ref_ops.run_op(op, [_t(a) for a in ins], attrs).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **(CONV_TOL if "conv" in op else OP_TOL))


def test_every_jax_ref_op_is_ported():
    assert set(ref_ops.REF_OPS) == set(jref_ops.REF_OPS)
    covered = {CASES[c][0] for c in CASES}
    assert covered >= set(ref_ops.REF_OPS) - {"conv2d"}


# ---------------------------------------------------------------- kernels
@pytest.mark.parametrize("k,stride,cin,cout", [
    (1, 1, 8, 16), (3, 1, 16, 32), (3, 2, 16, 32), (5, 2, 4, 8), (7, 2, 3, 16)])
def test_conv2d_plain_matches_pallas_interpret(k, stride, cin, cout):
    # the sweep of tests/test_kernels.py::test_conv2d_kernel_sweep
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 16, 16, cin)) * 0.3).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) * 0.2).astype(np.float32)
    b = (rng.standard_normal((cout,)) * 0.1).astype(np.float32)
    want = np.asarray(jops.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                  stride=stride, padding="SAME", layout="NHWC",
                                  activation="relu"))
    got = ops.conv2d(_t(x), _t(w), _t(b), stride=stride, padding="SAME",
                     layout="NHWC", activation="relu").numpy()
    np.testing.assert_allclose(got, want, **CONV_TOL)


@pytest.mark.parametrize("path", ["kernel", "patches_gemm"])
def test_conv2d_nchw_and_the_large_image_path_match_pallas(path, monkeypatch):
    # tests/test_kernels.py::test_conv2d_nchw_layout_matches; a vmem_limit of
    # 1 byte sends the JAX package down its patches + GEMM path, while the
    # port runs its conv kernel (here its plain version) at every image size
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((1, 8, 12, 12)) * 0.3).astype(np.float32)
    w = (rng.standard_normal((16, 8, 3, 3)) * 0.2).astype(np.float32)
    b = (rng.standard_normal((16,)) * 0.1).astype(np.float32)
    limit = {"kernel": 64 * 1024 * 1024, "patches_gemm": 1}[path]
    want = np.asarray(jops.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                  stride=2, padding="SAME", layout="NCHW",
                                  activation="silu", vmem_limit=limit))
    calls = []
    direct = KC.conv2d_direct
    monkeypatch.setattr(KC, "conv2d_direct",
                        lambda *a, **kw: calls.append(kw) or direct(*a, **kw))
    got = ops.conv2d(_t(x), _t(w), _t(b), stride=2, padding="SAME", layout="NCHW",
                     activation="silu").numpy()
    np.testing.assert_allclose(got, want, **CONV_TOL)
    assert len(calls) == 1


def test_conv2d_past_the_old_vmem_threshold_runs_the_conv_kernel(monkeypatch):
    """An image whose padded H x W x Cin passes the 64 MiB at which the JAX
    wrapper switches to patches + GEMM runs `conv2d_direct` (on the CPU
    its plain version) and matches ref_ops."""
    rng = np.random.default_rng(5)
    h = w = 1030                       # padded 1032 x 1032 x 16 f32: 68.2 MB
    assert (h + 2) * (w + 2) * 16 * 4 > 64 * 1024 * 1024
    x = _t(rng.standard_normal((1, h, w, 16), dtype=np.float32))
    wt = _t((rng.standard_normal((3, 3, 16, 4)) * 0.2).astype(np.float32))
    b = _t((rng.standard_normal((4,)) * 0.1).astype(np.float32))
    calls = []
    direct = KC.conv2d_direct
    monkeypatch.setattr(KC, "conv2d_direct",
                        lambda *a, **kw: calls.append(kw) or direct(*a, **kw))
    got = ops.conv2d(x, wt, b, stride=1, padding="SAME", layout="NHWC",
                     activation="relu")
    want = ref_ops.run_op("fused_conv2d", [x, wt, b],
                          {"stride": 1, "padding": "SAME", "layout": "NHWC",
                           "activation": "relu"})
    assert len(calls) == 1 and got.shape == (1, h, w, 4)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **CONV_TOL)


# the Hopper kernel's edge lengths: 1..17 around its 16-byte vectors and
# 2^k +- 1, whose tails are never a whole vector
FUSED_EDGE_LENGTHS = [1, 2, 3, 5, 7, 8, 9, 15, 16, 17, 1023, 1025, 65535, 65537]


@pytest.mark.parametrize("chain,shape,dtype", [
    pytest.param(["add", "gelu", "mul", "tanh"], (3, 50, 33), "float32",
                 id="chain0-shape0"),                     # tests/test_kernels.py
    pytest.param(["add", "relu"], (1, 64, 8, 8), "float32",
                 id="chain1-shape1"),                     # the residual chain
    pytest.param(["sub", "silu", "div", "sigmoid", "identity"], (7, 129), "float32",
                 id="chain2-shape2"),
] + [pytest.param(["mul", "add", "relu"], (n,), dtype, id=f"edge-{n}-{dtype}")
     for dtype in ("float32", "bfloat16") for n in FUSED_EDGE_LENGTHS])
def test_fused_elementwise_plain_matches_pallas_interpret(chain, shape, dtype):
    rng = np.random.default_rng(6)
    x = rng.standard_normal(shape).astype(np.float32)
    n_extra = sum(op in ("add", "mul", "sub", "div") for op in chain)
    extras = [(rng.standard_normal(shape) + 3.0).astype(np.float32)
              for _ in range(n_extra)]
    stages = [{"op": op} for op in chain]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jops.fused_elementwise(
        jnp.asarray(x, jdt), stages, [jnp.asarray(e, jdt) for e in extras]), np.float32)
    got = ops.fused_elementwise(_t(x).to(tdt), stages,
                                [_t(e).to(tdt) for e in extras]).float().numpy()
    # bf16: XLA may keep an intermediate stage in f32 (excess precision)
    # where the plain version rounds it, one bf16 rounding (2^-8 relative)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_fused_elementwise_rounds_bf16_after_every_stage():
    x = torch.tensor([1.0, 3.0, -2.0], dtype=torch.bfloat16)
    e = torch.tensor([2.0 ** -8, 2.0 ** -8, 0.5], dtype=torch.bfloat16)
    got = ops.fused_elementwise(x, [{"op": "add"}, {"op": "sub"}], [e, e])
    # 1 + 2^-8 rounds back to 1 in bf16 (a tie, to even) before the subtraction
    assert got.tolist() == [1.0 - 2.0 ** -8, 3.0, -2.0]
    with pytest.raises(KeyError):
        ops.fused_elementwise(x, [{"op": "exp"}])


def test_conv_template_space_is_what_the_kernel_launches():
    tmpl = TEMPLATES["pallas_conv2d"]
    for _, op in conv_groups(batch=1, image=224):
        op = OpDesc.make("conv2d", op.d, "float32")
        configs = list(tmpl.enumerate_configs(op))
        assert configs, op
        assert set(tmpl.space(op)) == {"bn", "row_block"}
        d = op.d
        for cfg in configs:
            geo = KC.geometry(d["n"], d["h"], d["w"], d["cin"], d["cout"], d["kh"],
                              d["kw"], d["stride"], "SAME", cfg["bn"], cfg["row_block"])
            assert geo.smem_bytes <= hw.H100.smem_per_block
            # a tile holds row_block whole output rows, padded to the next
            # tile height of 16s, and the tiles cover M
            assert geo.rows == min(cfg["row_block"] * d["ow"], d["n"] * geo.oh * geo.ow)
            assert (geo.bm, cfg["bn"]) in KC.CONV_TILES and geo.rows <= geo.bm < 2 * geo.rows + 16
            assert (geo.tiles_m - 1) * geo.rows < d["n"] * geo.oh * geo.ow <= geo.tiles_m * geo.rows
        default = KC.default_config(d["n"], d["h"], d["w"], d["cin"], d["cout"],
                                    d["kh"], d["kw"], d["stride"], "SAME")
        assert tmpl.validate(op, default)
    # the stem's 112-pixel rows do not fit 8 rows per tile at bn 128
    stem = OpDesc.make("conv2d", conv_groups()[0][1].d, "float32")
    assert not tmpl.validate(stem, {"bn": 128, "row_block": 8})
    # bn 16 needs a 64-row tile (four warps of 16 rows): 8-pixel rows take
    # row_block 8
    tall = (64, 2048, 8, 4, 16, 3, 3, 1, "SAME", 16)
    assert KC.geometry(*tall, 4) is None and KC.geometry(*tall, 8) is not None
    assert TEMPLATES["pallas_matmul"].space(OpDesc.matmul(1, 1000, 512, "float32")) == \
        {"tile_m": [64], "split_k": [1, 2, 3, 4, 6, 8, 12, 16, 24, 32]}
    assert set(TEMPLATES) == {"pallas_matmul", "pallas_conv2d", "pallas_attention"}
    assert TEMPLATES["pallas_attention"].kinds == ("attention",)


def test_wrappers_raise_off_the_cpu_instead_of_falling_back():
    x = torch.zeros((1, 8, 8, 4), device="meta")
    w = torch.zeros((3, 3, 4, 8), device="meta")
    with pytest.raises(ValueError, match="GPU"):
        ops.conv2d(x, w, config={"bn": 16, "row_block": 1})
    with pytest.raises(ValueError, match="outside the kernel's limits"):
        ops.conv2d(x, w, config={"bn": 48, "row_block": 1})
    with pytest.raises(ValueError, match="GPU"):
        ops.fused_elementwise(x, [{"op": "relu"}])


# ----------------------------------------------------------------- search
def _toy(base):
    class Toy(base):
        name = "toy"
        kinds = ("matmul",)

        def space(self, op):
            return {"a": [1, 2, 3, 4, 5, 6], "b": [8, 16, 32, 64],
                    "c": ["x", "y", "z"]}

        def validate(self, op, cfg, chip=None):
            return not (cfg["a"] == 6 and cfg["b"] == 64)

    return Toy()


def _toy_fitness(op, cfg):
    return 1.0 + (cfg["a"] - 3.3) ** 2 + (np.log2(cfg["b"]) - 4.2) ** 2 + \
        {"x": 0.7, "y": 0.0, "z": 0.4}[cfg["c"]]


@pytest.mark.parametrize("seed", [0, 5])
def test_genetic_search_is_the_jax_search(seed):
    kw = dict(population=10, elites=2, max_generations=6)
    jres = JGeneticSearch(**kw).run(JSearchTask(
        JOpDesc.matmul(8, 8, 8), _toy(JTemplate), _toy_fitness, seed=seed))
    pres = GeneticSearch(**kw).run(SearchTask(
        OpDesc.matmul(8, 8, 8), _toy(Template), _toy_fitness, seed=seed))
    assert pres.config == jres.config
    assert pres.evals == jres.evals
    assert pres.history == jres.history
    assert pres.runtime_s == jres.runtime_s


class FakeWallClock(Fitness):
    """A deterministic stand-in for the card: kernel configs priced off the
    roofline with a penalty per knob, the vendor lane at a fixed factor."""

    kind = "wallclock"

    def __init__(self):
        self.evals = 0

    def __call__(self, op, cfg):
        self.evals += 1
        penalty = abs(cfg.get("bn", 64) - 64) / 64 + cfg.get("row_block", 1) / 16
        return roofline_bound(op) * (3.0 + penalty)

    def vendor_time(self, op):
        return roofline_bound(op) * (2.5 if op.kind == "matmul" else 3.2)


def _tuner(seed=0, cache=None):
    return Tuner(fitness=FakeWallClock(), methods=("genetic",), seed=seed, cache=cache)


@pytest.fixture(scope="module")
def resnet_opt():
    return optimize_graph(resnet18_graph(batch=1, image=32))


@pytest.mark.parametrize("graph", ["resnet18_32", "mini_convnet"])
def test_select_covers_every_tunable_node_and_races_the_vendor(graph, resnet_opt):
    g = resnet_opt if graph == "resnet18_32" else optimize_graph(mini_convnet(Graph))
    plan = select(g, tuner=_tuner(), dtype="float32")
    tunable = [n.name for n in g.nodes
               if n.op in ("fused_conv2d", "conv2d", "matmul", "fused_matmul")]
    assert sorted(plan.choices) == sorted(tunable)
    for choice in plan.choices.values():
        assert VENDOR in choice.candidates
        assert choice.modeled_time_s == min(choice.candidates.values())
    assert plan.chip == hw.H100.name


def test_select_is_deterministic_per_seed_and_roundtrips(resnet_opt, tmp_path):
    p1 = select(resnet_opt, tuner=_tuner(seed=3), dtype="float32")
    p2 = select(resnet_opt, tuner=_tuner(seed=3), dtype="float32")
    assert p1.to_json() == p2.to_json()
    path = tmp_path / "plan.json"
    p1.save(str(path))
    assert InferencePlan.load(str(path)).to_json() == p1.to_json()


def test_wpk_only_ablation_is_never_faster(resnet_opt):
    tuner = _tuner()
    full = select(resnet_opt, tuner=tuner, dtype="float32", third_party=True)
    wpk_only = select(resnet_opt, tuner=tuner, dtype="float32", third_party=False)
    assert full.total_modeled_time_s() <= wpk_only.total_modeled_time_s() + 1e-15
    assert set(wpk_only.backend_histogram()) <= {"pallas_conv2d", "pallas_matmul"}
    # the fake prices the fc's vendor lane below the GEMM's best
    assert full.backend_histogram().get(VENDOR, 0) >= 1


def test_attention_nodes_race_the_vendor_lane_only():
    """Attention nodes race the vendor lane against the flash kernel's
    template now; the WPK-only ablation leaves the vendor lane out."""
    g = Graph("att")
    q = g.add_input("q", (2, 8, 4, 16))
    k = g.add_input("k", (2, 8, 4, 16))
    g.set_outputs([g.add_node("attention", [q, k, k], (2, 8, 4, 16), name="attn")])
    plan = select(g, tuner=_tuner(), third_party=True)
    assert set(plan.choices["attn"].candidates) == {VENDOR, "pallas_attention"}
    # the fake prices the kernel at 3.0625 x the roofline, the vendor at 3.2
    assert plan.choices["attn"].backend == "pallas_attention"
    plan = select(g, tuner=_tuner(), third_party=False)
    assert plan.choices["attn"].backend == "pallas_attention"
    assert list(plan.choices["attn"].candidates) == ["pallas_attention"]


def test_a_jax_search_cache_file_loads_with_the_same_keys(tmp_path):
    path = str(tmp_path / "cache.json")
    jcache = JSearchCache(path)
    tuner = JTuner(methods=("genetic",), cache=jcache)
    for op in [JOpDesc.matmul(64, 128, 256)] + [o for _, o in j_conv_groups(1, 32)[:3]]:
        tuner.tune(op)
    jcache.save()
    pcache = SearchCache(path)
    assert len(pcache) == len(jcache)
    assert set(pcache._store) == set(jcache._store)
    for _, op in conv_groups(1, 32)[:3]:
        hit = pcache.get("tpu_v5e", op, "pallas_conv2d", fitness="model")
        assert hit == jcache._store[JSearchCache.key("tpu_v5e", op, "pallas_conv2d")]
    # a wall-clock tuner of the port misses the model-fitness entries
    assert pcache.get("tpu_v5e", OpDesc.matmul(64, 128, 256), "pallas_matmul",
                      fitness="wallclock") is None


def test_tuner_cache_hit_skips_the_search():
    tuner = _tuner()
    op = OpDesc.make("conv2d", conv_groups(1, 32)[1][1].d, "float32")
    first = tuner.tune(op)
    evals = tuner.fitness.evals
    again = tuner.tune(op)
    assert again.method == first.method + "+cache"
    assert again.config == first.config and tuner.fitness.evals == evals


def test_rl_search_and_model_parallel_name_the_roadmap(resnet_opt):
    # RL-search is ported: both methods run, the faster wins and is cached
    tuner = Tuner(fitness=FakeWallClock(), methods=("genetic", "rl"),
                  rl=RLSearch(episodes=2, steps_per_episode=8, device="cpu"))
    op = OpDesc.make("conv2d", conv_groups(1, 32)[1][1].d, "float32")
    first = tuner.tune(op)
    assert [r.method for r in tuner.log] == ["genetic", "rl"]
    assert first.runtime_s == min(r.runtime_s for r in tuner.log)
    assert first.method == min(tuner.log, key=lambda r: r.runtime_s).method
    evals = tuner.fitness.evals
    again = tuner.tune(op)
    assert again.method == first.method + "+cache" and again.config == first.config
    assert tuner.fitness.evals == evals
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        select(resnet_opt, tuner=_tuner(), model_parallel=2)


def test_wallclock_fitness_on_the_cpu_measures_each_config_once():
    fit = WallClockFitness(device="cpu", repeats=2, warmup=1)
    op = OpDesc.conv2d(1, 8, 8, 4, 8, 3, 3, stride=1, dtype="float32")
    t1 = fit(op, {"bn": 16, "row_block": 1})
    t2 = fit(op, {"bn": 16, "row_block": 1})
    assert t1 == t2 > 0 and fit.evals == 2 and fit.measured == 1
    assert fit.vendor_time(op) > 0 and fit.measured == 2
    mm = OpDesc.matmul(4, 8, 16, dtype="float32")
    assert fit(mm, {}) > 0 and fit.vendor_time(mm) > 0
    assert fit.kind == "wallclock"


def test_roofline_bound_uses_the_peak_of_the_dtype():
    conv = conv_groups(1, 224)[1][1]
    f32 = OpDesc.make("conv2d", conv.d, "float32")
    assert roofline_bound(f32) == pytest.approx(
        max(f32.flops() / 67e12, f32.io_bytes() / 3.35e12))
    assert roofline_bound(conv) == pytest.approx(
        max(conv.flops() / 989e12, conv.io_bytes() / 3.35e12))
    assert (hw.H100.sms, hw.H100.smem_per_block, hw.H100.regs_per_sm) == \
        (132, 232_448, 65_536)
    assert hw.itemsize("bfloat16") == 2 and hw.bytes_of((3, 4), "float32") == 48


# ----------------------------------------------------------------- engine
def _jax_plan_json(jgopt, tmp_path):
    plan = j_select(jgopt, tuner=JTuner(methods=("genetic",)), dtype="float32")
    path = tmp_path / "jax_plan.json"
    plan.save(str(path))
    return plan, str(path)


@pytest.mark.parametrize("graph", ["resnet18_32", "mini_convnet"])
def test_engine_runs_a_jax_plan_like_the_jax_engine(graph, tmp_path):
    jg, pg = GRAPHS[graph][0](), GRAPHS[graph][1]()
    jgopt, pgopt = j_optimize(jg), optimize_graph(pg)
    jplan, path = _jax_plan_json(jgopt, tmp_path)
    plan = InferencePlan.load(path)
    assert plan.backend_histogram() == jplan.backend_histogram()
    shape = jg.tensors[jg.inputs[0]].shape
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    want = np.asarray(JEngine(jgopt, jplan, jax_registry(interpret=True))(
        jnp.asarray(x))[0])
    eng = Engine(pgopt, plan, default_registry(), device="cpu")
    got = eng(_t(x))[0].numpy()
    tol = NET_RTOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert eng.verify_against_reference(_t(x), rtol=0, atol=tol) <= tol
    # and the unoptimized graph on the vendor lane agrees with both
    unopt = Engine(pg, device="cpu")(_t(x))[0].numpy()
    np.testing.assert_allclose(unopt, want, rtol=0, atol=tol)


def test_engine_run_env_exposes_the_fused_chains_inputs(resnet_opt):
    x = _t(np.random.default_rng(4).standard_normal((1, 3, 32, 32)).astype(np.float32))
    env = Engine(resnet_opt, device="cpu").run_env(x)
    for node in resnet_opt.nodes:
        if node.op == "fused_elementwise":
            ins = [env[t] for t in node.inputs]
            got = ops.fused_elementwise(ins[0], node.attrs["chain"], ins[1:])
            assert torch.equal(got, env[node.outputs[0]])


def test_vendor_lane_conv_weights_are_laid_out_once(resnet_opt):
    """The weight of an NHWC conv on the vendor lane is stored so that the
    (O, I, Kh, Kw) view ref_ops hands cuDNN is channels_last (read as it
    is, no conversion per call); a weight a kernel lane reads stays
    contiguous HWIO; the values are the graph's either way."""
    w = torch.randn(3, 3, 4, 8)
    wv = ref_ops.nhwc_conv_weight(w)
    assert torch.equal(wv, w) and not wv.is_contiguous()
    assert wv.permute(3, 2, 0, 1).is_contiguous(memory_format=torch.channels_last)
    conv_w = [n.inputs[1] for n in resnet_opt.nodes
              if n.op == "fused_conv2d" and n.attrs.get("layout") == "NHWC"]
    assert len(conv_w) == 20
    vendor = Engine(resnet_opt, device="cpu")
    wpk_only = Engine(resnet_opt, select(resnet_opt, tuner=_tuner(), dtype="float32",
                                         third_party=False),
                      default_registry(), device="cpu")
    for t in conv_w:
        want = torch.from_numpy(resnet_opt.constants[t])
        assert torch.equal(vendor._consts[t], want)
        assert vendor._consts[t].permute(3, 2, 0, 1).is_contiguous(
            memory_format=torch.channels_last)
        assert wpk_only._consts[t].is_contiguous()


# ----------------------------------------------------------------- devices
def test_entry_points_without_a_device_raise_without_a_gpu(monkeypatch, resnet_opt):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kv = KVCacheConfig(num_blocks=4, block_size=2, max_blocks_per_seq=2)
    with pytest.raises(RuntimeError, match="GPU"):
        PagedKVCache(kv, 1, 1, 4)
    assert PagedKVCache(kv, 1, 1, 4, device="cpu").k.device.type == "cpu"
    with pytest.raises(RuntimeError, match="GPU"):
        Engine(resnet_opt)
    with pytest.raises(RuntimeError, match="GPU"):
        WallClockFitness()
    with pytest.raises(RuntimeError, match="GPU"):
        Tuner()
    with pytest.raises(RuntimeError, match="GPU"):
        select(resnet_opt)
    with pytest.raises(RuntimeError, match="GPU"):
        Engine(resnet_opt, device="cuda")
