"""The port's model against the JAX package on the same parameters.

Parameters come from the JAX `model.init`, go through
`repro_torch.bridge.params_from_jax`, and both models run the paged serving
entry points (`prefill_packed_paged`, then `decode_step_paged`) on the same
pools and inputs, made with numpy from a seed.  Model: the `tiny_lm`
config of tests/test_serving_runtime.py (qwen3-1.7b reduced to 2 layers,
d_model 64, d_ff 128, vocab 97).

Tolerances: f32 logits within rtol 1e-4 / atol 1e-5 (two frameworks, the
same f32 algorithm: summation order and transcendental ulps only); bf16
logits within atol 6.25e-2, four bf16 ulps at the logits' magnitude (up to
~3.3, ulp 2^-6 below 4): XLA and PyTorch round the bf16 matmul and
attention products at the same points but accumulate in different orders,
so single roundings differ (two ulps is what this scenario shows).
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.dispatch import MATMUL_ROLES, matmul_dispatch
from repro_torch.models import DecoderLM

F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_ATOL = 6.25e-2


def _configs(dtype):
    jcfg = jax_get_config("qwen3-1.7b").reduced(n_layers=2, d_model=64, d_ff=128,
                                                vocab=97, dtype=dtype)
    tcfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)})
    return jcfg, tcfg


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _configs("float32")
    model = build_model(jcfg)
    return model.init(jax.random.PRNGKey(0))


def _to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------- bridge
def test_bridge_round_trip_is_exact_including_bf16(jax_params):
    tree = {"f32": _to_numpy(jax_params),
            "bf16": _to_numpy(jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                                           jax_params)),
            "i32": np.arange(7, dtype=np.int32)}
    out = params_from_jax(tree)
    flat_np = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat_np) == len(jax.tree_util.tree_leaves(out))
    for path, a in flat_np:
        t = out
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == a.shape
        if a.dtype == ml_dtypes.bfloat16:
            assert t.dtype == torch.bfloat16
            back = t.view(torch.int16).numpy().view(np.uint16)
            np.testing.assert_array_equal(back, a.view(np.uint16))
        else:
            assert t.numpy().dtype == a.dtype
            np.testing.assert_array_equal(t.numpy(), a)


def test_port_init_matches_jax_tree_structure_and_shapes(jax_params):
    _, tcfg = _configs("float32")
    port = DecoderLM(tcfg).init(torch.Generator().manual_seed(0))
    jp = jax.tree_util.tree_leaves_with_path(jax_params)
    tp = jax.tree_util.tree_leaves_with_path(port)
    assert [p for p, _ in jp] == [p for p, _ in tp]
    for (_, a), (_, t) in zip(jp, tp):
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32


# ----------------------------------------------------------------- logits
def _scenario():
    """Pools, a packed chunk of two segments (one resuming at kv_start 5)
    and a decode batch over the same blocks."""
    rng = np.random.default_rng(7)
    nb, bs, nbt = 16, 8, 4
    seg_tables = np.asarray([[3, 4, 0, 0], [7, 8, 9, 0]], np.int32)
    seg_info = np.asarray([[0, 6, 0], [6, 9, 5]], np.int32)
    c = 18                                     # 3 padding rows
    toks = rng.integers(0, 97, size=(1, c)).astype(np.int32)
    dec_tables = np.asarray([[3, 4, 0, 0], [7, 8, 9, 0], [0, 0, 0, 0]], np.int32)
    dec_lengths = np.asarray([6, 14, 0], np.int32)
    dec_tokens = rng.integers(0, 97, size=(3, 1)).astype(np.int32)
    return nb, bs, nbt, seg_tables, seg_info, toks, dec_tables, dec_lengths, dec_tokens


def _run_jax(jcfg, params, scenario):
    nb, bs, _, seg_tables, seg_info, toks, dec_tables, dec_lengths, dec_tokens = scenario
    model = build_model(jcfg)
    shape = (jcfg.n_layers, nb, bs, jcfg.n_kv_heads, jcfg.hd)
    rng = np.random.default_rng(3)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    dt = jnp.dtype(jcfg.dtype)
    ch_logits, kp, vp = model.prefill_packed_paged(
        params, jnp.asarray(k0, dt), jnp.asarray(v0, dt), jnp.asarray(seg_tables),
        jnp.asarray(toks), jnp.asarray(seg_info))
    dec_logits, kp, vp = model.decode_step_paged(
        params, kp, vp, jnp.asarray(dec_tables), jnp.asarray(dec_lengths),
        jnp.asarray(dec_tokens))
    f32 = lambda a: np.asarray(a.astype(jnp.float32))   # noqa: E731
    return f32(ch_logits), f32(dec_logits), f32(kp), (k0, v0)


def _run_port(tcfg, params, scenario, pools, lanes="torch"):
    _, _, _, seg_tables, seg_info, toks, dec_tables, dec_lengths, dec_tokens = scenario
    model = DecoderLM(tcfg)
    sp = model.serving_params(params, "cpu")
    dt = torch.float32 if tcfg.dtype == "float32" else torch.bfloat16
    kp = torch.from_numpy(pools[0]).to(dt)
    vp = torch.from_numpy(pools[1]).to(dt)
    t = torch.from_numpy
    attn = "cuda_attention" if lanes == "kernels" else "torch"
    table = ({r: ("cuda_matmul", {}) for r in MATMUL_ROLES}
             if lanes == "kernels" else None)
    with matmul_dispatch(table):
        ch = model.prefill_packed_paged(sp, kp, vp, t(seg_tables), t(toks),
                                        t(seg_info), attn_backend=attn,
                                        attn_config={"block_q": 4})
        dec = model.decode_step_paged(sp, kp, vp, t(dec_tables), t(dec_lengths),
                                      t(dec_tokens), attn_backend=attn)
    return ch.float().numpy(), dec.float().numpy(), kp.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_prefill_and_decode_logits_match_jax(jax_params, dtype):
    jcfg, tcfg = _configs(dtype)
    scenario = _scenario()
    j_ch, j_dec, j_pool, pools = _run_jax(jcfg, jax_params, scenario)
    t_ch, t_dec, t_pool = _run_port(tcfg, params_from_jax(_to_numpy(jax_params)),
                                    scenario, pools)
    assert t_ch.shape == j_ch.shape == (1, 2, 97)
    assert t_dec.shape == j_dec.shape == (3, 1, 97)
    if dtype == "float32":
        np.testing.assert_allclose(t_ch, j_ch, **F32_TOL)
        np.testing.assert_allclose(t_dec, j_dec, **F32_TOL)
        np.testing.assert_allclose(t_pool, j_pool, **F32_TOL)
    else:
        np.testing.assert_allclose(t_ch, j_ch, rtol=0, atol=BF16_ATOL)
        # the live decode rows (slot 2 is inactive: all-null table)
        np.testing.assert_allclose(t_dec[:2], j_dec[:2], rtol=0, atol=BF16_ATOL)


def test_kernel_lanes_match_torch_lanes_in_f32(jax_params):
    """The plan's kernel lanes (on the CPU: the kernels' plain versions,
    f32-accumulating) compute the torch lanes' function."""
    _, tcfg = _configs("float32")
    scenario = _scenario()
    _, _, _, pools = _run_jax(_configs("float32")[0], jax_params, scenario)
    params = params_from_jax(_to_numpy(jax_params))
    ref = _run_port(tcfg, params, scenario, pools, lanes="torch")
    got = _run_port(tcfg, params, scenario, pools, lanes="kernels")
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5)
