"""The port's long-KV attention and one-request paged prefill against the
JAX package.

`_kv_chunk_for` and the form `_sdpa` picks (direct or chunked) equal the
reference's at edge lengths and at seeded ones; `_sdpa` against JAX's
`_sdpa`, outputs and gradients (of a seeded cotangent), at causal Skv =
2048 / 4096 with Sq = Skv and Sq < Skv and non-causal Skv = 1500, all GQA
at G = 2, D = 8: f32 at 1e-5 x max (outputs) and 1e-4 x max (gradients), bf16 at
2^-8 x max (one bf16 ulp at the largest value) for both; whisper-base's
`EncDecLM.encode` at its real 1500 frames (2 layers, d_model 64) against
JAX's, through the chunked form; `ops.attention_prefill_paged` on the CPU
bitwise equal to the packed entry with one segment, and against the JAX
wrapper (Pallas in interpret mode) at the reference test's cases.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as JK
from repro.models import attention as JA
from repro.models import build_model
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as K
from repro_torch.models import EncDecLM
from repro_torch.models import attention as A

OUT_RTOL_F32, GRAD_RTOL_F32 = 1e-5, 1e-4
RTOL_BF16 = 2.0 ** -8

EDGE_SKV = (1, 63, 64, 1023, 1024, 1031, 1500, 2048, 4096, 32768)
SEEDED_SKV = tuple(int(s) for s in np.random.default_rng(0).integers(1, 70000, 50))

# (Sq, Skv, causal); every case H = 2, Hkv = 1 (G = 2), D = 8
SDPA_CASES = ((2048, 2048, True), (300, 2048, True), (4096, 4096, True),
              (300, 4096, True), (1500, 1500, False))
HEADS, KV_HEADS, HEAD_DIM = 2, 1, 8


@pytest.mark.parametrize("skv", EDGE_SKV + SEEDED_SKV)
def test_kv_chunk_and_form_match_the_reference(skv, monkeypatch):
    assert A._kv_chunk_for(skv) == JA._kv_chunk_for(skv)
    # `_sdpa` reads only k.shape[1] before it picks a form: spy on both
    picked = []
    for mod in (JA, A):
        monkeypatch.setattr(mod, "_sdpa_direct", lambda *a: picked.append("direct"))
        monkeypatch.setattr(mod, "_sdpa_chunked",
                            lambda *a, kv_chunk, **kw: picked.append(("chunked", kv_chunk)))
        mod._sdpa(None, types.SimpleNamespace(shape=(1, skv, 1, 1)), None, True, 1)
    assert picked[0] == picked[1]
    assert A._CHUNKED_KV_THRESHOLD == JA._CHUNKED_KV_THRESHOLD
    assert A._KV_CHUNK == JA._KV_CHUNK


def _inputs(sq, skv, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, sq, HEADS, HEAD_DIM)).astype(np.float32)
    k = rng.standard_normal((1, skv, KV_HEADS, HEAD_DIM)).astype(np.float32)
    v = rng.standard_normal((1, skv, KV_HEADS, HEAD_DIM)).astype(np.float32)
    ct = rng.standard_normal((1, sq, HEADS, HEAD_DIM)).astype(np.float32)
    return q, k, v, ct


def _jax_sdpa_and_grads(q, k, v, ct, causal, dtype):
    @jax.jit
    def run(q, k, v):
        def f(q, k, v):
            o = JA._sdpa(q, k, v, causal, HEADS // KV_HEADS)
            return jnp.sum(o.astype(jnp.float32) * ct), o
        return jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(q, k, v)

    jd = jnp.dtype(dtype)
    (_, out), grads = run(jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd))
    return [np.asarray(jnp.asarray(x, jnp.float32)) for x in (out, *grads)]


def _rel_err(got, want):
    return float(np.abs(got.detach().float().numpy() - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv,causal", SDPA_CASES)
def test_sdpa_matches_jax_outputs_and_gradients(sq, skv, causal, dtype):
    q, k, v, ct = _inputs(sq, skv)
    want = _jax_sdpa_and_grads(q, k, v, ct, causal, dtype)
    td = getattr(torch, dtype)
    tq, tk, tv = [torch.from_numpy(x).to(td).requires_grad_(True) for x in (q, k, v)]
    out = A._sdpa(tq, tk, tv, causal, HEADS // KV_HEADS)
    assert out.dtype == td and out.shape == tq.shape
    (out.float() * torch.from_numpy(ct)).sum().backward()
    out_tol, grad_tol = ((OUT_RTOL_F32, GRAD_RTOL_F32) if dtype == "float32"
                         else (RTOL_BF16, RTOL_BF16))
    assert _rel_err(out, want[0]) <= out_tol
    for got, w in zip((tq.grad, tk.grad, tv.grad), want[1:]):
        assert _rel_err(got, w) <= grad_tol


def test_chunked_form_holds_no_autograd_graph_without_grad():
    q, k, v, _ = _inputs(64, 2048)
    tq, tk, tv = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    with torch.no_grad():
        out = A._sdpa(tq, tk, tv, True, HEADS // KV_HEADS)
    assert out.grad_fn is None
    torch.testing.assert_close(out, A._sdpa_chunked(tq, tk, tv, True, 2, 1024).detach(),
                               rtol=0, atol=0)


def test_whisper_encoder_at_1500_frames_matches_jax(monkeypatch):
    jcfg = jax_get_config("whisper-base").reduced(d_model=64, d_ff=128, vocab=97,
                                                  dtype="float32", enc_seq=1500)
    tcfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)})
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    audio = np.random.default_rng(5).standard_normal((1, 1500, 64)).astype(np.float32)
    want = np.asarray(jax.jit(jmodel.encode)(jparams, jnp.asarray(audio)))
    calls = []
    chunked = A._sdpa_chunked

    def spy(*a, **kw):
        calls.append(kw["kv_chunk"])
        return chunked(*a, **kw)

    monkeypatch.setattr(A, "_sdpa_chunked", spy)
    with torch.no_grad():
        got = EncDecLM(tcfg).encode(params_from_jax(jax.tree.map(np.asarray, jparams)),
                                    torch.from_numpy(audio))
    assert calls == [750] * tcfg.n_enc_layers         # the reference's form
    assert _rel_err(got, want) <= OUT_RTOL_F32


def _pool_case(c=11, h=4, hkv=2, d=16, bs=8, nbt=6, nb=16, seed=7):
    """tests/test_chunked_prefill.py's case: one request's chunk of c rows
    through a permuted table of nbt blocks."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, c, h, d)).astype(np.float32)
    kp = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    table = rng.permutation(np.arange(1, nb))[:nbt].astype(np.int32)[None]
    return q, kp, vp, table


@pytest.mark.parametrize("chunk_start,block_q", [(0, None), (13, None), (13, 4),
                                                 (24, 8)])
def test_attention_prefill_paged_matches_packed_and_jax(chunk_start, block_q):
    q, kp, vp, table = _pool_case()
    c = q.shape[1]
    cfg = {"block_q": block_q} if block_q else None
    tq, tk, tv, tt = map(torch.from_numpy, (q, kp, vp, table))
    got = K.attention_prefill_paged(tq, tk, tv, tt, chunk_start, c, config=cfg)
    packed = K.attention_prefill_packed(
        tq, tk, tv, tt, torch.tensor([[0, c, chunk_start]], dtype=torch.int32),
        config=cfg)
    assert torch.equal(got, packed)
    # scalar tensors as the chunk's descriptors, as the reference takes them
    assert torch.equal(got, K.attention_prefill_paged(
        tq, tk, tv, tt, torch.tensor(chunk_start), torch.tensor(c), config=cfg))
    want = JK.attention_prefill_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(chunk_start, jnp.int32), jnp.asarray(c, jnp.int32), config=cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
