"""The port's Mamba2 model against the JAX package's.

`repro_torch.models.mamba` and `zoo.MambaLM` run the same parameters (a
JAX `MambaLM.init` carried through `bridge`) and the same inputs (numpy,
seeded) as `repro.models.mamba` / `repro.models.zoo.MambaLM`, on the f32
config `mamba2-2.7b` reduced to 2 layers and vocab 97 (d_model 128,
16 heads x 16, state 16, SSD chunk 16).  Floats agree within 1e-5 x the
output's max |value| (summation order: the port's einsums are pairwise,
XLA's contraction order and its cumsum are its own); the port's own
chunked-prefill contract is bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model
from repro.models import mamba as JM
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import MambaLM
from repro_torch.models import mamba as M
from repro_torch.models.zoo import layer_params

RTOL = 1e-5
SEG = 16                    # the serve lane width in these tests: one ssm_chunk


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def mamba():
    jcfg = jax_get_config("mamba2-2.7b").reduced(n_layers=2, vocab=97, dtype="float32")
    tcfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)})
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    model = MambaLM(tcfg)
    return jcfg, jmodel, jparams, model, model.serving_params(tparams, "cpu")


def _layer(mamba, i=0):
    jcfg, _, jparams, model, params = mamba
    jp = jax.tree.map(lambda a: a[i], jparams["blocks"]["mamba"])
    return jcfg, jp, model.cfg, layer_params(params["blocks"], i)["mamba"]


# ------------------------------------------------------------------ config
@pytest.mark.parametrize("overrides", [None, {}, dict(n_layers=2, vocab=97, dtype="float32")],
                         ids=["published", "reduced", "reduced_test"])
def test_config_is_the_jax_config_field_for_field(overrides):
    jcfg = jax_get_config("mamba2-2.7b")
    cfg = get_config("mamba2-2.7b")
    if overrides is not None:
        jcfg, cfg = jcfg.reduced(**overrides), cfg.reduced(**overrides)
    assert [f.name for f in dataclasses.fields(cfg)] == \
        [f.name for f in dataclasses.fields(jcfg)]
    for f in dataclasses.fields(jcfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    if overrides is None:
        assert (cfg.n_layers, cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim,
                cfg.ssm_expand, cfg.conv_width, cfg.vocab, cfg.ssm_chunk, cfg.dtype,
                cfg.sub_quadratic) == (64, 2560, 128, 64, 2, 4, 50280, 256,
                                       "bfloat16", True)
        d_in, nh, conv_dim = M._dims(cfg)
        assert (d_in, nh, conv_dim) == (5120, 80, 5376)
        assert 2 * d_in + 2 * cfg.ssm_state + nh == 10576       # in_proj's N


# ------------------------------------------------------------ parameters
def test_bridge_carries_the_params_tree_as_it_is(mamba):
    _, _, jparams, model, _ = mamba
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    tleaves = jax.tree_util.tree_leaves_with_path(tparams)
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    for (_, j), (_, t) in zip(jleaves, tleaves):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
        assert np.array_equal(t.numpy(), np.asarray(j))
    # the port's own init draws the same tree
    own = model.init(torch.Generator().manual_seed(0))
    assert jax.tree.structure(jax.tree.map(lambda t: 0, own)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, jparams))
    for (_, j), (_, t) in zip(jleaves, jax.tree_util.tree_leaves_with_path(own)):
        assert tuple(t.shape) == j.shape


def test_serving_params_cast_projections_and_embedding_only():
    cfg = get_config("mamba2-2.7b").reduced(n_layers=1, vocab=97)
    model = MambaLM(cfg)
    params = model.serving_params(model.init(torch.Generator().manual_seed(0)), "cpu")
    dtypes = {"/".join(str(k.key) for k in path): t.dtype
              for path, t in jax.tree_util.tree_leaves_with_path(params)}
    for name, dt in dtypes.items():
        leaf = name.split("/")[-1]
        assert dt == (torch.bfloat16 if leaf in ("w", "emb") else torch.float32), name
    assert dtypes["blocks/mamba/conv_w"] == torch.float32


# ----------------------------------------------------- conv, SSD scan, softplus
def test_softplus_is_jax_logaddexp():
    x = np.concatenate([np.linspace(-40, 40, 801), [0.0, 20.0, 25.0, -1e-3]]
                       ).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(M.softplus(_t(x)).numpy(), want, rtol=2e-7, atol=1e-7)


def test_causal_conv_and_its_carry_match_jax(mamba):
    jcfg, jp, cfg, p = _layer(mamba)
    rng = np.random.default_rng(1)
    _, _, conv_dim = M._dims(cfg)
    xbc = rng.standard_normal((2, 24, conv_dim)).astype(np.float32)
    carry = rng.standard_normal((2, cfg.conv_width - 1, conv_dim)).astype(np.float32)
    got = M._causal_conv(p["conv_w"], p["conv_b"], _t(xbc))
    _close(got, JM._causal_conv(jp["conv_w"], jp["conv_b"], jnp.asarray(xbc)))
    _close(M._causal_conv_carry(p["conv_w"], p["conv_b"], _t(xbc), _t(carry)),
           JM._causal_conv_carry(jp["conv_w"], jp["conv_b"], jnp.asarray(xbc),
                                 jnp.asarray(carry)))
    # a zero carry is the from-scratch conv, bit for bit
    zero = torch.zeros((2, cfg.conv_width - 1, conv_dim))
    assert torch.equal(M._causal_conv_carry(p["conv_w"], p["conv_b"], _t(xbc), zero), got)


@pytest.mark.parametrize("seq", [16, 48], ids=["1_chunk", "3_chunks"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero_h0", "h0"])
def test_ssd_chunked_matches_jax(seq, with_h0):
    rng = np.random.default_rng(seq + with_h0)
    b, h, p, n = 2, 4, 8, 16
    x = rng.standard_normal((b, seq, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, seq, h)))).astype(np.float32)
    A = -np.linspace(1.0, 4.0, h).astype(np.float32)
    B = rng.standard_normal((b, seq, n)).astype(np.float32)
    C = rng.standard_normal((b, seq, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32) if with_h0 else None
    want_y, want_h = JM.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, B, C)), 16,
                                    h0=None if h0 is None else jnp.asarray(h0))
    got_y, got_h = M.ssd_chunked(_t(x), _t(dt), _t(A), _t(B), _t(C), 16,
                                 h0=None if h0 is None else _t(h0))
    _close(got_y, want_y)
    _close(got_h, want_h)


# ------------------------------------------------------------- the block
def _block_input(cfg, seq, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((1, seq, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("seq", [48, 64])
def test_chunk_forward_in_segments_is_the_whole_forward_bitwise(mamba, seq):
    """The reference's contract, inside the port: a prompt fed through
    `mamba_chunk_forward` in 16-token segments (zero carries first, each
    segment's carries into the next) gives `mamba_forward`'s outputs, final
    state and conv window bit for bit; each segment is within 1e-5 of the
    JAX package's."""
    jcfg, jp, cfg, p = _layer(mamba)
    x = _block_input(cfg, seq, 2)
    want, (want_conv, want_h) = M.mamba_forward(p, cfg, _t(x), return_state=True)
    conv, h = M.mamba_init_state(cfg, 1)
    jconv, jh = JM.mamba_init_state(jcfg, 1)
    ys = []
    for s0 in range(0, seq, SEG):
        seg = x[:, s0:s0 + SEG]
        y, conv, h = M.mamba_chunk_forward(p, cfg, _t(seg), conv, h, SEG)
        jy, jconv, jh = JM.mamba_chunk_forward(jp, jcfg, jnp.asarray(seg), jconv,
                                               jh, SEG)
        _close(y, jy)
        _close(conv, jconv)
        _close(h, jh)
        ys.append(y)
    assert torch.equal(torch.cat(ys, 1), want)
    assert torch.equal(h, want_h)
    assert torch.equal(conv, want_conv.float())


@pytest.mark.parametrize("seg_len", [1, 5, 11, 15])
def test_a_padded_segment_matches_jax_and_reads_the_carry_at_seg_len(mamba, seg_len):
    """A segment that underfills the window: rows past seg_len are exact
    identities of the recurrence, and the new conv carry holds the last
    W-1 real inputs (the carry's own rows where seg_len < W-1)."""
    jcfg, jp, cfg, p = _layer(mamba)
    rng = np.random.default_rng(seg_len)
    _, nh, conv_dim = M._dims(cfg)
    x = _block_input(cfg, SEG, 3 + seg_len)
    x[:, seg_len:] = rng.standard_normal((1, SEG - seg_len, cfg.d_model))
    carry = rng.standard_normal((1, cfg.conv_width - 1, conv_dim)).astype(np.float32)
    h0 = rng.standard_normal((1, nh, cfg.ssm_head_dim, cfg.ssm_state)).astype(np.float32)
    y, conv, h = M.mamba_chunk_forward(p, cfg, _t(x), _t(carry), _t(h0),
                                       torch.tensor(seg_len))
    jy, jconv, jh = JM.mamba_chunk_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(carry),
                                           jnp.asarray(h0), seg_len)
    _close(y[:, :seg_len], np.asarray(jy)[:, :seg_len])
    _close(conv, jconv)
    _close(h, jh)
    # the padding rows changed nothing: the same state from other padding
    x2 = x.copy()
    x2[:, seg_len:] = 0.0
    _, conv2, h2 = M.mamba_chunk_forward(p, cfg, _t(x2), _t(carry), _t(h0), seg_len)
    assert torch.equal(h2, h) and torch.equal(conv2, conv)


def test_decode_matches_jax(mamba):
    jcfg, jp, cfg, p = _layer(mamba)
    rng = np.random.default_rng(4)
    _, nh, conv_dim = M._dims(cfg)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((3, cfg.conv_width - 1, conv_dim)).astype(np.float32)
    h = rng.standard_normal((3, nh, cfg.ssm_head_dim, cfg.ssm_state)).astype(np.float32)
    y, c2, h2 = M.mamba_decode(p, cfg, _t(x), _t(conv), _t(h))
    jy, jc2, jh2 = JM.mamba_decode(jp, jcfg, jnp.asarray(x), jnp.asarray(conv),
                                   jnp.asarray(h))
    _close(y, jy)
    _close(c2, jc2)
    _close(h2, jh2)


# --------------------------------------------------------------- MambaLM
def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 97, size=shape).astype(np.int32)


@pytest.mark.parametrize("batch,plen", [(1, 16), (2, 48), (1, 5)])
def test_prefill_and_decode_steps_match_jax(mamba, batch, plen):
    _, jmodel, jparams, model, params = mamba
    toks = _tokens(plen, (batch, plen))
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, 64)
    tl, tc = model.prefill(params, {"tokens": _t(toks)}, 64)
    _close(tl, jl)
    for key in ("conv", "ssm"):
        _close(tc[key], jc[key])
    assert tc["lengths"].tolist() == [plen] * batch
    for step in range(3):
        nxt = _tokens(100 + step, (batch, 1))
        jl, jc = jmodel.decode_step(jparams, jc, jnp.asarray(nxt))
        tl, tc = model.decode_step(params, tc, _t(nxt))
        _close(tl, jl)
        for key in ("conv", "ssm"):
            _close(tc[key], jc[key])
        assert tc["lengths"].tolist() == np.asarray(jc["lengths"]).tolist()


def _pools(cfg, rows, seed):
    """Random conv / ssm pools (L, rows, ...) as numpy."""
    rng = np.random.default_rng(seed)
    _, nh, conv_dim = M._dims(cfg)
    conv = rng.standard_normal((cfg.n_layers, rows, cfg.conv_width - 1, conv_dim))
    ssm = rng.standard_normal((cfg.n_layers, rows, nh, cfg.ssm_head_dim, cfg.ssm_state))
    return conv.astype(np.float32), ssm.astype(np.float32)


@pytest.mark.parametrize("seg_len,seg_start", [(16, 0), (9, 0), (16, 32), (3, 48)])
def test_prefill_chunk_slots_matches_jax(mamba, seg_len, seg_start):
    """One segment into row 2 of a 4-row pool: the logits at its last real
    row and every pool row (the other rows untouched; seg_start 0 reads
    zero carries, not the row)."""
    _, jmodel, jparams, model, params = mamba
    conv, ssm = _pools(model.cfg, 4, seg_len + seg_start)
    toks = _tokens(seg_len, (1, SEG))
    jl, jconv, jssm = jmodel.prefill_chunk_slots(
        jparams, jnp.asarray(conv), jnp.asarray(ssm), np.int32(2), jnp.asarray(toks),
        np.int32(seg_len), np.int32(seg_start))
    tconv, tssm = _t(conv), _t(ssm)
    tl = model.prefill_chunk_slots(params, tconv, tssm, torch.tensor([2]), _t(toks),
                                   torch.tensor([seg_len]), torch.tensor([seg_start]))
    assert tl.shape == (1, 1, 97)
    _close(tl, jl)
    _close(tconv, jconv)
    _close(tssm, jssm)
    for r in (0, 1, 3):
        assert np.array_equal(tconv[:, r].numpy(), conv[:, r])
        assert np.array_equal(tssm[:, r].numpy(), ssm[:, r])


def test_decode_step_slots_matches_jax(mamba):
    """Four slots: two on real rows, two idle on the null row 0 (whose
    colliding write-backs are garbage: compared on the real rows only)."""
    _, jmodel, jparams, model, params = mamba
    conv, ssm = _pools(model.cfg, 5, 7)
    idx = np.array([3, 0, 1, 0], np.int32)
    toks = _tokens(8, (4, 1))
    jl, jconv, jssm = jmodel.decode_step_slots(
        jparams, jnp.asarray(conv), jnp.asarray(ssm), jnp.asarray(idx), jnp.asarray(toks))
    tconv, tssm = _t(conv), _t(ssm)
    tl = model.decode_step_slots(params, tconv, tssm, _t(idx), _t(toks))
    _close(tl, jl)
    for r in (1, 3):
        _close(tconv[:, r], np.asarray(jconv)[:, r])
        _close(tssm[:, r], np.asarray(jssm)[:, r])
    for r in (2, 4):
        assert np.array_equal(tconv[:, r].numpy(), conv[:, r])
        assert np.array_equal(tssm[:, r].numpy(), ssm[:, r])


def test_slot_lanes_continue_the_whole_prompt_prefill(mamba):
    """A 48-token prompt chunked through `prefill_chunk_slots` then decoded
    through `decode_step_slots` gives `prefill` / `decode_step`'s logits and
    carries bit for bit (the equivalence continuous serving rests on)."""
    _, _, _, model, params = mamba
    toks = _tokens(9, (1, 48))
    cfg = model.cfg
    conv = torch.full((cfg.n_layers, 3, cfg.conv_width - 1, M._dims(cfg)[2]), 7.0)
    ssm = torch.full((cfg.n_layers, 3, *M.mamba_init_state(cfg, 1)[1].shape[1:]), 7.0)
    for s0 in range(0, 48, SEG):
        lg = model.prefill_chunk_slots(params, conv, ssm, 1, _t(toks[:, s0:s0 + SEG]),
                                       SEG, s0)
    want, cache = model.prefill(params, {"tokens": _t(toks)}, 64)
    assert torch.equal(lg, want)
    assert torch.equal(conv[:, 1], cache["conv"][:, 0])
    assert torch.equal(ssm[:, 1], cache["ssm"][:, 0])
    nxt = _tokens(10, (1, 1))
    got = model.decode_step_slots(params, conv, ssm, torch.tensor([1]), _t(nxt))
    want, cache = model.decode_step(params, cache, _t(nxt))
    assert torch.equal(got, want)
    assert torch.equal(ssm[:, 1], cache["ssm"][:, 0])
