"""The GEMM's tuned knobs (tile_m, split_k) on the CPU: the template's
space is exactly what `csrc/matmul.cu` launches, `ops.matmul` runs the
pair it is given (or raises), JAX plans' TPU keys keep the default
geometry, and `select` carries the knobs through `PlanRouter` to the
matmul lane.  The kernel itself runs only on the card; `chip_smoke.py`
phase 2 launches every admitted pair at three serving shapes against its
plain version.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import Tuner as JTuner
from repro.core.schedules import OpDesc as JOpDesc
from repro_torch import hw
from repro_torch.configs import get_config
from repro_torch.core import TEMPLATES, OpDesc, RLSearch, Tuner, op_desc_of
from repro_torch.core.costmodel import Fitness, roofline_bound
from repro_torch.kernels import dispatch
from repro_torch.kernels import matmul as KM
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.serve.router import PlanRouter, build_serve_graph, build_serve_plan

TMPL = TEMPLATES["pallas_matmul"]


def _shapes():
    """(label, M, K, N, dtype) of qwen3-1.7b's 10 serving GEMMs, mamba2-2.7b's
    6 and ResNet-18's fc."""
    q = get_config("qwen3-1.7b")
    d, hd = q.d_model, q.hd
    qwen = [("qkv", d, q.n_heads * hd), ("qkv(k,v)", d, q.n_kv_heads * hd),
            ("mlp_up", d, q.d_ff), ("mlp_down", q.d_ff, d), ("lm_head", d, q.vocab)]
    out = [(f"qwen3 {r} M={m}", m, k, n, "bfloat16") for m in (8, 256) for r, k, n in qwen]
    s = get_config("mamba2-2.7b")
    d = s.d_model
    d_in = s.ssm_expand * d
    proj = 2 * d_in + 2 * s.ssm_state + d_in // s.ssm_head_dim
    for lane, m in (("chunk", 256), ("decode", 8)):
        out += [(f"mamba2 {lane} in_proj", m, d, proj, "bfloat16"),
                (f"mamba2 {lane} out_proj", m, d_in, d, "bfloat16"),
                (f"mamba2 {lane} lm_head", 1 if lane == "chunk" else m, d, s.vocab,
                 "bfloat16")]
    return out + [("resnet18 fc", 1, 512, 1000, "float32")]


SHAPES = _shapes()


@pytest.mark.parametrize("label,m,k,n,dtype", SHAPES, ids=[s[0] for s in SHAPES])
def test_matmul_template_space_is_what_the_kernel_launches(label, m, k, n, dtype):
    op = OpDesc.matmul(m, n, k, dtype=dtype)
    tdtype = getattr(torch, dtype)
    space = TMPL.space(op)
    assert set(space) == {"tile_m", "split_k"}
    configs = list(TMPL.enumerate_configs(op))
    assert configs
    admitted = set()
    for cfg in configs:
        geo = KM.geometry(m, n, k, tdtype, cfg["tile_m"], cfg["split_k"])
        admitted.add((cfg["tile_m"], cfg["split_k"]))
        # a tile the library is built with
        tile = KM.GEMM_TILES[geo.bm] if tdtype.itemsize == 2 else KM.GEMM_TILE_F32
        assert (geo.bm, geo.bn, geo.bk, geo.stages) == tile and geo.bm == cfg["tile_m"]
        # whole k-steps, none empty, as matmul.cu checks them
        steps = -(-k // geo.bk)
        sps = geo.steps_per_split(k)
        assert 1 <= geo.split == cfg["split_k"] <= steps
        assert (geo.split - 1) * sps < steps <= geo.split * sps
        # the partials within the weights' bytes, the grid within its limits
        if geo.split > 1:
            assert geo.split * m * n * 4 <= k * n * tdtype.itemsize
        assert -(-n // geo.bn) <= hw.H100.max_grid_y and geo.split <= 65535
    # exactly the pairs of the space that geometry() accepts
    assert admitted == {(t, s) for t in space["tile_m"] for s in space["split_k"]
                        if KM.geometry(m, n, k, tdtype, t, s) is not None}
    # the default rule's choice is admitted and gives the same geometry
    default = KM.gemm_geometry(m, n, k, tdtype)
    assert (default.bm, default.split) in admitted
    assert KM.geometry(m, n, k, tdtype, default.bm, default.split) == default


def test_geometry_leaves_the_default_rules_cache_alone():
    KM.gemm_geometry.cache_clear()
    want = KM.gemm_geometry(256, 2048, 6144, torch.bfloat16)
    info = KM.gemm_geometry.cache_info()
    tuned = KM.geometry(256, 2048, 6144, torch.bfloat16, 16, 2)
    assert tuned == KM.GemmGeometry(16, 128, 64, 4, 2) != want
    assert KM.gemm_geometry.cache_info() == info
    assert KM.gemm_geometry(256, 2048, 6144, torch.bfloat16) == want


def _xw(m, k, n, dtype=torch.bfloat16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((m, k), generator=g).to(dtype),
            (torch.randn((k, n), generator=g) / k ** 0.5).to(dtype))


@pytest.mark.parametrize("config,why", [
    ({"tile_m": 16, "split_k": 33}, "a split past the 32 k-steps"),
    ({"tile_m": 16, "split_k": 24}, "an empty split: 24 splits of 2 steps cover 48"),
    ({"tile_m": 64, "split_k": 16}, "partials of 16 x 256 x N x 4 B past K x N x 2 B"),
    ({"tile_m": 32, "split_k": 1}, "a height the library is not built with"),
    ({"tile_m": 64}, "tile_m alone"),
    ({"split_k": 2}, "split_k alone"),
])
def test_ops_matmul_rejects_an_invalid_or_half_given_pair(config, why):
    x, w = _xw(256, 2048, 64)
    with pytest.raises(ValueError, match="matmul config"):
        ops.matmul(x, w, config=config)
    # so does the template, which the searches consult
    if len(config) == 2:
        assert not TMPL.validate(OpDesc.matmul(256, 64, 2048), config), why
    with pytest.raises(ValueError, match="matmul config"):
        ops.matmul(x.float(), w.float(), config={"tile_m": 16, "split_k": 1})


class _Spy:
    def __init__(self, monkeypatch, module, name):
        self.calls = []
        real = getattr(module, name)

        def spy(*args, **kwargs):
            self.calls.append(kwargs)
            return real(*args, **kwargs)

        monkeypatch.setattr(module, name, spy)


def test_ops_matmul_runs_the_pair_it_is_given(monkeypatch):
    spy = _Spy(monkeypatch, KM, "matmul_fused")
    x, w = _xw(8, 2048, 256)
    x3 = x.reshape(2, 4, 2048)
    want = ref.matmul_ref(x, w, None, "silu")
    for config, geo in (({"tile_m": 64, "split_k": 4}, KM.GemmGeometry(64, 128, 64, 4, 4)),
                        ({"tile_m": 128, "split_k": 1}, KM.GemmGeometry(128, 128, 64, 3, 1)),
                        (None, None), ({}, None)):
        out = ops.matmul(x3, w, config=config, activation="silu")
        assert spy.calls[-1]["geometry"] == geo
        assert torch.equal(out.reshape(8, 256), want)


def test_jax_plan_matmul_keys_run_on_the_default_geometry(monkeypatch):
    """A JAX-tuned matmul config (its TPU tile bm / bn / bk / order /
    k_unroll) reaches the GEMM without a geometry, through ops.matmul and
    through the plan's matmul lane."""
    jcfg = JTuner(methods=("genetic",)).tune(JOpDesc.matmul(8, 256, 2048)).config
    assert {"bm", "bn", "bk"} <= set(jcfg) and not set(jcfg) & set(ops.GEMM_KNOBS)
    spy = _Spy(monkeypatch, KM, "matmul_fused")
    x, w = _xw(8, 2048, 256)
    assert torch.equal(ops.matmul(x, w, config=jcfg), ref.matmul_ref(x, w, None, None))
    with dispatch.matmul_dispatch({"mlp_up": ("cuda_matmul", jcfg)}):
        dispatch.dispatch_dense("mlp_up", x, w)
    assert [c["geometry"] for c in spy.calls] == [None, None]


# ---------------------------------------------------------------- property
_PROPERTY_OPS = {
    "pallas_matmul": [OpDesc.matmul(512, 1024, 768), OpDesc.matmul(8, 151936, 2048),
                      OpDesc.matmul(1, 1000, 512, dtype="float32")],
    "pallas_conv2d": [OpDesc.conv2d(1, 56, 56, 64, 128, 3, 3, stride=2,
                                    dtype="float32"),
                      OpDesc.conv2d(1, 224, 224, 3, 64, 7, 7, stride=2)],
    "pallas_attention": [OpDesc.attention(2, 1024, 1024, 8, 128),
                         OpDesc.attention(1, 256, 1024, 16, 128,
                                          label="prefill_chunk.attention")],
}


@given(st.integers(0, 2**16), st.sampled_from(sorted(_PROPERTY_OPS)), st.integers(0, 2))
@settings(max_examples=60, deadline=None)
def test_random_configs_of_the_port_templates_are_valid_and_round_trip(seed, name, i):
    tmpl = TEMPLATES[name]
    ops_ = _PROPERTY_OPS[name]
    op = ops_[i % len(ops_)]
    cfg = tmpl.random_config(op, np.random.default_rng(seed))
    assert tmpl.validate(op, cfg)
    assert tmpl.decode(op, tmpl.encode(op, cfg)) == cfg


# ---------------------------------------------------------------- selection
class _KnobPrice(Fitness):
    """A matmul kernel priced off the roofline by its distance from (tile_m
    64, split_k 2), so one pair is the fastest; attention flat; the vendor
    lane slower."""

    kind = "wallclock"

    def __call__(self, op, cfg):
        if op.kind != "matmul":
            return roofline_bound(op) * 3.0
        return roofline_bound(op) * (2.0 + abs(np.log2(cfg["tile_m"] / 64))
                                     + abs(np.log2(cfg["split_k"] / 2)))

    def vendor_time(self, op):
        return roofline_bound(op) * 10.0


def test_select_carries_the_knobs_through_the_router_to_ops_matmul(monkeypatch):
    cfg = get_config("qwen3-1.7b")
    fit = _KnobPrice()
    serve = dict(prefill_len=700, slots=8, max_seq=1024, chunk_tokens=256)
    rl = RLSearch(episodes=1, steps_per_episode=6, device="cpu")
    plan = build_serve_plan(cfg, **serve, tuner=Tuner(fitness=fit, rl=rl))
    graph = build_serve_graph(cfg, **serve, dtype="bfloat16")
    matmuls = [n for n in graph.nodes if not n.name.endswith("attention")]
    assert len(matmuls) == 12
    for node in matmuls:
        c = plan.choices[node.name]
        assert c.backend == "pallas_matmul" and set(c.config) == {"tile_m", "split_k"}
        op = op_desc_of(graph, node, "bfloat16")
        best = min(TMPL.enumerate_configs(op), key=lambda k: fit(op, k))
        assert fit(op, c.config) == fit(op, best)
    seen = []
    real = ops.matmul
    monkeypatch.setattr(ops, "matmul", lambda x, w, **kw: seen.append(kw["config"])
                        or real(x, w, activation=kw.get("activation")))
    router = PlanRouter(plan)
    x, w = _xw(2, 16, 8)
    for stage in ("decode", "prefill_chunk"):
        table = router.matmul_table(stage)
        with dispatch.matmul_dispatch(table):
            for role in dispatch.MATMUL_ROLES:
                dispatch.dispatch_dense(role, x, w)
        assert seen[-4:] == [plan.choices[f"{stage}.{r}"].config
                             for r in dispatch.MATMUL_ROLES]
