"""The fused elementwise kernel of the port and the engine's route to it,
on the CPU.

`csrc/fused_elementwise.cu` runs only on the card.  What the CPU holds is
its launch geometry (`kernels/fused.py::geometry`, host integers alone:
the vector width, the scalar head and tail, threads, blocks, unroll),
checked against the C source's constants and emulated index by index to
show that a launch covers every element exactly once; the C signature
against `build.SIGNATURES`; and the engine's route, which sends every
`fused_elementwise` node through `kernels.ops.fused_elementwise` when the
engine has a registry (on the CPU the wrapper runs the plain version),
held against ref_ops, and against the JAX engine and the Pallas kernel in
interpret mode on the reference's ResNet-18 graph.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Engine as JEngine
from repro.core import Tuner as JTuner
from repro.core import default_registry as jax_registry
from repro.core import optimize_graph as j_optimize
from repro.core import select as j_select
from repro.kernels import ops as jops
from repro.models.resnet import resnet18_graph as j_resnet18
from repro_torch import hw
from repro_torch.core import Engine, InferencePlan, default_registry, optimize_graph
from repro_torch.kernels import build
from repro_torch.kernels import fused as KF
from repro_torch.kernels import ops as kops
from repro_torch.models.resnet import resnet18_graph

NET_RTOL = 1e-4     # tests/test_torch_wpk.py: the engine under a JAX plan
SMS = hw.H100.sms


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _source():
    return (build.CSRC / "fused_elementwise.cu").read_text()


# ---------------------------------------------------------------- geometry
def _constant(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_geometry_constants_mirror_the_cuda_source():
    src = _source()
    assert _constant(src, "MAX_THREADS") == KF.THREADS
    assert _constant(src, "MAX_UNROLL") == KF.MAX_UNROLL
    assert _constant(src, "VEC_BYTES") == KF.VEC_BYTES
    assert _constant(src, "MAX_STAGES") == KF.MAX_STAGES
    assert _constant(src, "MAX_EXTRAS") == KF.MAX_EXTRAS
    # the add -> relu instance takes the geometry's unroll, a generic chain
    # one vector at a time
    assert re.search(r"UNROLL_BOUND = ADD_RELU_ONLY \? MAX_UNROLL : 1;", src)
    assert "constexpr unsigned ADD_RELU = 6u | (1u << 4);" in src
    assert KF.chain_code(["add", "relu"])[1] == 6 | 1 << 4
    assert 1 <= KF.UNROLL <= KF.MAX_UNROLL and KF.THREADS * KF.RESIDENT <= 2048


def test_the_c_entry_takes_what_the_wrapper_passes():
    sig = re.search(r'extern "C" int fused_elementwise\((.*?)\)', _source(), re.S).group(1)
    kinds = {"const void*": build._P, "void*": build._P, "long long": build._L,
             "int": build._I, "unsigned int": build._U}
    params = [re.sub(r"\s+", " ", p).strip().rsplit(" ", 1) for p in sig.split(",")]
    types = [kinds[t.replace(" *", "*")] for t, _ in params]
    assert build.SIGNATURES["fused_elementwise"] == ("fused_elementwise", types)
    assert [name for _, name in params] == [
        "x", "e0", "e1", "e2", "e3", "out", "n", "n_stages", "code", "dtype", "vec",
        "unroll", "threads", "blocks", "head", "stream"]


@pytest.mark.parametrize("itemsize,vec", [(4, 4), (2, 8)])
def test_geometry_reads_16_bytes_an_access(itemsize, vec):
    for n in (1, 100, 200704, 2**24):
        geo = KF.geometry(n, itemsize, 0)
        assert geo.vec == vec and geo.head == 0
        assert geo.nvec == n // vec and geo.tail == n % vec
    assert KF.geometry(1000, itemsize, None).vec == 1


@pytest.mark.parametrize("itemsize", [4, 2])
def test_geometry_splits_head_and_tail_at_16_byte_boundaries(itemsize):
    for offset in range(16):
        if offset % itemsize:
            with pytest.raises(ValueError):
                KF.geometry(64, itemsize, offset)
            continue
        for n in (1, 3, 7, 8, 9, 33, 1000, 4099):
            geo = KF.geometry(n, itemsize, offset)
            assert geo.head == min(n, (16 - offset) % 16 // itemsize)
            if geo.head < n:        # the vectors start on a 16-byte boundary
                assert (offset + geo.head * itemsize) % 16 == 0
            assert 0 <= geo.tail < geo.vec
            assert geo.head + geo.nvec * geo.vec + geo.tail == n
    # pointers at different offsets: every element in the scalar body
    geo = KF.geometry(1001, itemsize, None)
    assert (geo.vec, geo.head, geo.nvec, geo.tail) == (1, 0, 1001, 0)


def _coverage(geo, n, unroll_bound):
    """How often the kernel's index math (csrc/fused_elementwise.cu,
    fused_chain) touches each of the n elements: the scalar head and tail
    by global thread id, the vectors by each block's share, walked in
    chunks of threads x unroll (the kernel clamps unroll to its instance's
    bound)."""
    hits = np.zeros(n, np.int64)
    g = np.arange(geo.blocks * geo.threads)
    hits[g[g < geo.head]] += 1
    tail0 = geo.head + geo.nvec * geo.vec
    np.add.at(hits, tail0 + g[g < geo.tail], 1)
    unroll = min(geo.unroll, unroll_bound)
    share, rem = divmod(geo.nvec, geo.blocks)
    b = np.arange(geo.blocks)[:, None, None, None]
    lo = b * share + np.minimum(b, rem)
    hi = lo + share + (b < rem)
    step = geo.threads * unroll
    k = np.arange(-(-(share + 1) // step))[None, :, None, None]
    j = np.arange(unroll)[None, None, :, None]
    t = np.arange(geo.threads)[None, None, None, :]
    base = lo + t + k * step
    v = np.broadcast_to(base + j * geo.threads, (geo.blocks, k.size, unroll, geo.threads))
    ok = (base < hi) & (v < hi)       # the chunk loop's bound, then each vector's
    v = v[ok]
    elems = (geo.head + v[:, None] * geo.vec + np.arange(geo.vec)).ravel()
    np.add.at(hits, elems, 1)
    return hits


LENGTHS = (list(range(1, 130)) + [2**k + d for k in range(8, 21) for d in (-3, -1, 0, 1, 3)]
           + [25_088, 50_176, 100_352, 200_704])


@pytest.mark.parametrize("itemsize,offset", [(4, 0), (4, 4), (4, None), (2, 0), (2, 6),
                                             (2, None)])
def test_geometry_covers_every_element_exactly_once(itemsize, offset):
    for n in LENGTHS:
        geo = KF.geometry(n, itemsize, offset)
        assert 32 <= geo.threads <= KF.THREADS and geo.threads % 32 == 0
        assert 1 <= geo.unroll <= KF.MAX_UNROLL
        for bound in (KF.MAX_UNROLL, 1):    # the add -> relu and generic instances
            hits = _coverage(geo, n, bound)
            assert hits.min() == 1 and hits.max() == 1, (n, geo, bound)


@pytest.mark.parametrize("itemsize", [4, 2])
def test_geometry_spreads_small_tensors_over_every_sm(itemsize):
    vec = 16 // itemsize
    streaming = SMS * KF.THREADS * KF.UNROLL
    for n in [1, 5, 64, 131 * vec, 133 * vec, 1000 * vec, 25_088, 50_176, 100_352,
              200_704, streaming * vec - 1]:
        geo = KF.geometry(n, itemsize, 0)
        assert geo.nvec < streaming
        assert geo.blocks >= min(SMS, n // vec) and geo.blocks <= SMS
        # one chunk a block: threads x unroll covers the largest share
        assert geo.threads * geo.unroll >= -(-geo.nvec // geo.blocks)
    # ResNet-18's residual shapes in f32 reach all 132 SMs
    for n, threads, unroll in ((200_704, 192, 2), (100_352, 192, 1), (50_176, 96, 1),
                               (25_088, 64, 1)):
        if itemsize == 4:
            assert KF.geometry(n, 4, 0)[1:4] == (unroll, threads, SMS)
    # at streaming sizes: SMs x RESIDENT blocks of THREADS, UNROLL vectors each
    geo = KF.geometry(streaming * vec, itemsize, 0)
    assert (geo.blocks, geo.threads, geo.unroll) == (SMS * KF.RESIDENT, KF.THREADS,
                                                     KF.UNROLL)


# ------------------------------------------------------------ engine route
@pytest.fixture(scope="module")
def resnet_opt():
    return optimize_graph(resnet18_graph(batch=1, image=32))


@pytest.fixture
def spy(monkeypatch):
    """Counts the chains `kernels.ops.fused_elementwise` is called with."""
    calls = []
    real = kops.fused_elementwise

    def fused(x, chain, extras=(), **kw):
        calls.append([s["op"] for s in chain])
        return real(x, chain, extras, **kw)

    monkeypatch.setattr(kops, "fused_elementwise", fused)
    return calls


def test_an_engine_with_a_registry_runs_its_chains_on_the_fused_kernel(resnet_opt, spy):
    x = _t(np.random.default_rng(4).standard_normal((1, 3, 32, 32)).astype(np.float32))
    routed = Engine(resnet_opt, None, default_registry(), device="cpu")
    got = routed(x)[0]
    assert spy == [["add", "relu"]] * 8
    assert sum(n.op == "fused_elementwise" for n in resnet_opt.nodes) == 8
    del spy[:]
    want = Engine(resnet_opt, device="cpu")(x)[0]
    assert spy == []                 # no registry: every chain on ref_ops
    assert torch.equal(got, want)
    # a registry without the fused entry keeps the chains on ref_ops too
    reg = {k: v for k, v in default_registry().items() if k != "fused_elementwise"}
    assert torch.equal(Engine(resnet_opt, None, reg, device="cpu")(x)[0], want)
    assert spy == []


def test_the_routed_chains_are_the_ref_ops_chains(resnet_opt):
    x = _t(np.random.default_rng(5).standard_normal((1, 3, 32, 32)).astype(np.float32))
    env = Engine(resnet_opt, None, default_registry(), device="cpu").run_env(x)
    ref_env = Engine(resnet_opt, device="cpu").run_env(x)
    for node in resnet_opt.nodes:
        assert torch.equal(env[node.outputs[0]], ref_env[node.outputs[0]]), node.name


def test_the_routed_engine_matches_the_jax_engine_and_pallas(tmp_path, spy):
    jg = j_optimize(j_resnet18(batch=1, image=32))
    pg = optimize_graph(resnet18_graph(batch=1, image=32))
    jplan = j_select(jg, tuner=JTuner(methods=("genetic",)), dtype="float32")
    path = tmp_path / "plan.json"
    jplan.save(str(path))
    plan = InferencePlan.load(str(path))
    assert all(plan.choice(n.name) is None for n in pg.nodes if n.op == "fused_elementwise")
    x = np.random.default_rng(2).standard_normal((1, 3, 32, 32)).astype(np.float32)
    want = np.asarray(JEngine(jg, jplan, jax_registry(interpret=True))(jnp.asarray(x))[0])
    eng = Engine(pg, plan, default_registry(), device="cpu")
    env = eng.run_env(_t(x))
    assert spy == [["add", "relu"]] * 8
    tol = NET_RTOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(env[pg.outputs[0]].numpy(), want, rtol=0, atol=tol)
    # each chain, on the inputs the engine fed it, against the Pallas kernel
    for node in pg.nodes:
        if node.op == "fused_elementwise":
            ins = [jnp.asarray(env[t].numpy()) for t in node.inputs]
            pallas = np.asarray(jops.fused_elementwise(ins[0], node.attrs["chain"], ins[1:]))
            np.testing.assert_array_equal(env[node.outputs[0]].numpy(), pallas)
