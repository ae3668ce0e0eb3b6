"""The port's mixture-of-experts layer and MoE decoder against the JAX
package's.

`repro_torch.models.mlp.moe_apply` and `repro.models.mlp.moe_apply` run the
same parameters (a JAX `moe_init` carried through `bridge`) on the same
inputs (numpy, seeded): a prefill group (B 2, S 16), decode grouping (S 1,
B 8: the batch is one group), forced drops (capacity factor 0.25), for
reduced qwen2-moe-a2.7b (4 shared experts, norm_topk off) and reduced
qwen3-moe-235b-a22b (none, norm_topk on), in f32 and bf16.  The routing
must be the reference's exactly: the same experts, queue positions and
set of dropped (token, choice) pairs, ties included (a zeroed router makes
every probability equal; `jax.lax.top_k` keeps the lower expert first).

Tolerances: f32 within 1e-5 x max(1, max |ref|) (the same algorithm,
summation order only); bf16 within 2e-2 x max(1, max |ref|): both
frameworks round every einsum / matmul output and the silu to bf16, but
XLA rounds silu's sigmoid and its product separately where PyTorch rounds
once, and the two sum in different orders, so single roundings (2^-8
relative) differ and pass through the down projection and the k-way sum.

`DecoderLM` for reduced qwen2-moe (2 layers, d_model 64, vocab 97, f32)
against the JAX `DecoderLM`: `prefill`, `decode_step`,
`decode_step_paged` and `prefill_packed_paged` logits within the f32
tolerance.  And the serving-dtype contracts: every expert stack leaves
`serving_params` in `cfg.dtype`, and `init_serving` equals
`serving_params(init())` bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import mlp as JF
from repro.models.common import dense as jax_dense
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import DecoderLM, MambaLM
from repro_torch.models import mlp as F

F32_RTOL = 1e-5
BF16_RTOL = 2e-2
CASES = {"prefill": ((2, 16), {}), "decode": ((8, 1), {}),
         "drops": ((2, 16), dict(capacity_factor=0.25))}


def _cfgs(arch, dtype, **overrides):
    jcfg = jax_get_config(arch).reduced(dtype=dtype, **overrides)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _close(got, want, rtol):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rtol * max(1.0, float(np.abs(want).max())), err


def _jax_route(p, cfg, x):
    """The reference's routing lines (`repro/models/mlp.py:100-121`): expert
    ids, queue positions and keep mask per (token, choice)."""
    b, s, d = x.shape
    if s == 1:
        x = x.reshape(1, b, d)
        b, s = 1, b
    probs = jax.nn.softmax(jax_dense(p["router"], x).astype(jnp.float32), -1)
    _, top_i = jax.lax.top_k(probs, cfg.top_k)
    flat_i = top_i.reshape(b, s * cfg.top_k)
    onehot = jax.nn.one_hot(flat_i, cfg.n_experts, dtype=jnp.int32)
    pos_all = jnp.cumsum(onehot, axis=1) - onehot
    pos = jnp.take_along_axis(pos_all, flat_i[..., None], -1)[..., 0]
    cap = JF.moe_capacity(cfg, s)
    return np.asarray(flat_i), np.asarray(pos), np.asarray(pos < cap)


def _layer(arch, dtype, case, zero_router=False):
    shape, overrides = CASES[case]
    jcfg, tcfg = _cfgs(arch, dtype, **overrides)
    jp = JF.moe_init(jax.random.PRNGKey(1), jcfg)
    if zero_router:
        jp = dict(jp, router={"w": jnp.zeros_like(jp["router"]["w"])})
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(5).standard_normal((*shape, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, jnp.asarray(x, dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"])
def test_moe_apply_matches_jax_with_the_same_routing_and_drops(arch, case, dtype):
    jcfg, tcfg, jp, tp, jx, tx = _layer(arch, dtype, case)
    assert (tcfg.n_shared_experts > 0) == (arch == "qwen2-moe-a2.7b")
    assert tcfg.norm_topk == (arch != "qwen2-moe-a2.7b")
    want = JF.moe_apply(jp, jcfg, jx).astype(jnp.float32)
    got = F.moe_apply(tp, tcfg, tx)
    assert got.shape == tx.shape and got.dtype == tx.dtype
    _close(got, want, F32_RTOL if dtype == "float32" else BF16_RTOL)

    ids, pos, keep = _jax_route(jp, jcfg, jx)
    b, s, d = tx.shape
    t_ids, t_pos, _ = F.moe_route(tp, tcfg, tx.reshape(1, b, d) if s == 1 else tx)
    cap = F.moe_capacity(tcfg, b if s == 1 else s)
    assert cap == JF.moe_capacity(jcfg, b if s == 1 else s)
    np.testing.assert_array_equal(t_ids.numpy(), ids)
    np.testing.assert_array_equal(t_pos.numpy(), pos)
    dropped = set(zip(*np.nonzero(~keep)))
    assert set(zip(*np.nonzero((t_pos >= cap).numpy()))) == dropped
    assert bool(dropped) == (case == "drops")


@pytest.mark.parametrize("case", ["decode", "drops"])
def test_tied_router_probabilities_keep_the_lower_expert_first(case):
    """A zeroed router gives every expert the same probability: top-k is
    experts 0..k-1 in both packages, and every token queues for them."""
    jcfg, tcfg, jp, tp, jx, tx = _layer("qwen2-moe-a2.7b", "float32", case,
                                        zero_router=True)
    ids, pos, keep = _jax_route(jp, jcfg, jx)
    b, s, d = tx.shape
    t_ids, t_pos, weights = F.moe_route(tp, tcfg, tx.reshape(1, b, d) if s == 1 else tx)
    k = tcfg.top_k
    assert (ids.reshape(-1, k) == np.arange(k)).all()
    np.testing.assert_array_equal(t_ids.numpy(), ids)
    np.testing.assert_array_equal(t_pos.numpy(), pos)
    assert torch.equal(weights, torch.full_like(weights, 1.0 / tcfg.n_experts))
    assert (~keep).any()
    _close(F.moe_apply(tp, tcfg, tx), JF.moe_apply(jp, jcfg, jx), F32_RTOL)


def test_capacity_rounds_up_to_four_with_a_floor_of_four():
    cfg = get_config("qwen2-moe-a2.7b")
    jcfg = jax_get_config("qwen2-moe-a2.7b")
    for tokens in (1, 8, 48, 49, 256, 700, 4096):
        cap = F.moe_capacity(cfg, tokens)
        assert cap == JF.moe_capacity(jcfg, tokens) and cap % 4 == 0 and cap >= 4
    assert F.moe_capacity(cfg, 8) == 4 and F.moe_capacity(cfg, 256) == 24


# ------------------------------------------------------------- the model
@pytest.fixture(scope="module")
def moe_lm():
    jcfg, tcfg = _cfgs("qwen2-moe-a2.7b", "float32", n_layers=2, d_model=64,
                       d_ff=128, vocab=97)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = DecoderLM(tcfg)
    params = model.serving_params(params_from_jax(jax.tree.map(np.asarray, jparams)),
                                  "cpu")
    return jmodel, jparams, model, params


def test_whole_prompt_prefill_and_decode_match_jax(moe_lm):
    jmodel, jparams, model, params = moe_lm
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 97, size=(2, 13)).astype(np.int32)
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, 32)
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(toks)}, 32)
    _close(logits, jlogits, F32_RTOL)
    _close(cache["k"][:, :, :13], np.asarray(jcache["k"])[:, :, :13], F32_RTOL)
    for _ in range(3):
        nxt = rng.integers(0, 97, size=(2, 1)).astype(np.int32)
        jlogits, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(nxt))
        logits, cache = model.decode_step(params, cache, torch.from_numpy(nxt))
        _close(logits, jlogits, F32_RTOL)
    assert cache["lengths"].tolist() == np.asarray(jcache["lengths"]).tolist()


def test_paged_prefill_and_decode_match_jax(moe_lm):
    """A packed chunk of two segments (one resuming at kv_start 5, 3
    padding rows that take capacity after the real rows) and a decode
    batch with an idle slot (its fill-token row routes too)."""
    jmodel, jparams, model, params = moe_lm
    cfg = model.cfg
    rng = np.random.default_rng(7)
    nb, bs = 16, 8
    seg_tables = np.asarray([[3, 4, 0, 0], [7, 8, 9, 0]], np.int32)
    seg_info = np.asarray([[0, 6, 0], [6, 9, 5]], np.int32)
    toks = rng.integers(0, 97, size=(1, 18)).astype(np.int32)
    dec_tables = np.asarray([[3, 4, 0, 0], [7, 8, 9, 0], [0, 0, 0, 0]], np.int32)
    dec_lengths = np.asarray([6, 14, 0], np.int32)
    dec_tokens = np.asarray([[5], [40], [0]], np.int32)
    shape = (cfg.n_layers, nb, bs, cfg.n_kv_heads, cfg.hd)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    j_ch, kp, vp = jmodel.prefill_packed_paged(
        jparams, jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(seg_tables),
        jnp.asarray(toks), jnp.asarray(seg_info))
    j_dec, kp, _ = jmodel.decode_step_paged(
        jparams, kp, vp, jnp.asarray(dec_tables), jnp.asarray(dec_lengths),
        jnp.asarray(dec_tokens))
    tk, tv = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    t = torch.from_numpy
    t_ch = model.prefill_packed_paged(params, tk, tv, t(seg_tables), t(toks),
                                      t(seg_info))
    t_dec = model.decode_step_paged(params, tk, tv, t(dec_tables), t(dec_lengths),
                                    t(dec_tokens))
    assert t_ch.shape == (1, 2, 97) and t_dec.shape == (3, 1, 97)
    _close(t_ch, j_ch, F32_RTOL)
    _close(t_dec, j_dec, F32_RTOL)
    _close(tk, kp, F32_RTOL)


# ----------------------------------------------------- serving dtypes, init
def test_expert_stacks_leave_serving_params_in_the_serving_dtype():
    _, cfg = _cfgs("qwen2-moe-a2.7b", "bfloat16", n_layers=2)
    model = DecoderLM(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    sp = model.serving_params(params, "cpu")
    moe = sp["blocks"]["moe"]
    for name in ("w_in", "w_gate", "w_out"):
        assert moe[name].dtype == torch.bfloat16
        # the rounding JAX applies at use: round to nearest even, once
        assert torch.equal(moe[name], params["blocks"]["moe"][name].to(torch.bfloat16))
    assert moe["router"]["w"].dtype == torch.bfloat16
    assert moe["shared"]["w_in"]["w"].dtype == torch.bfloat16
    assert moe["shared_gate"]["w"].dtype == torch.bfloat16
    assert sp["blocks"]["mlp_norm"]["scale"].dtype == torch.float32
    assert tuple(moe["w_out"].shape) == (2, cfg.n_experts, cfg.d_expert, cfg.d_model)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "granite-3-8b", "mamba2-2.7b"])
def test_init_serving_equals_serving_params_of_init_bitwise(arch):
    cfg = get_config(arch).reduced(n_layers=3)
    model = MambaLM(cfg) if cfg.family == "ssm" else DecoderLM(cfg)
    want = model.serving_params(model.init(torch.Generator().manual_seed(3)), "cpu")
    got = model.init_serving(torch.Generator().manual_seed(3))
    got_leaves, want_leaves = list(_leaves(got)), list(_leaves(want))
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert torch.equal(g, w), path


def test_colliding_pool_writes_take_the_last_rows_values():
    """Inactive decode slots (all-null tables, length 0) and chunk padding
    rows share the sink's row 0: each writes the last such row's values,
    so the sink holds the sequential scatter's outcome on any device."""
    from repro_torch.models.attention import decode_write_rows, packed_write_rows

    tables = torch.tensor([[3, 4], [0, 0], [7, 8], [0, 0], [0, 0]], dtype=torch.int32)
    lengths = torch.tensor([9, 0, 2, 0, 0], dtype=torch.int32)
    blk, off, src = decode_write_rows(tables, lengths, 8)
    assert blk.tolist() == [4, 0, 7, 0, 0] and off.tolist() == [1, 0, 2, 0, 0]
    assert src.tolist() == [0, 4, 2, 4, 4]
    seg_tables = torch.tensor([[5, 6], [0, 0]], dtype=torch.int32)
    seg_info = torch.tensor([[0, 3, 7], [3, 0, 0]], dtype=torch.int32)
    blk, off, src = packed_write_rows(seg_tables, seg_info, 6, 8)
    assert blk.tolist() == [5, 6, 6, 0, 0, 0] and off.tolist() == [7, 0, 1, 0, 0, 0]
    assert src.tolist() == [0, 1, 2, 5, 5, 5]
