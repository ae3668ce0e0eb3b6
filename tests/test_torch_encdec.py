"""The port's encdec family (Whisper: an encoder over audio embeddings and
a cross-attending decoder) against the JAX package's `EncDecLM`.

whisper-base reduced to 2 + 2 layers, d_model 64, d_ff 128, vocab 97,
f32 (4 / 2 heads x 32, enc_seq 32, layer norm, tanh-gelu MLPs),
parameters from a JAX `init` through `bridge`.  `layer_norm` (f32 and
bf16), `encode`, `cross_kv`, `prefill` (the self-attention K / V and the
cross `ek` / `ev`) and `decode_step` at 1e-5 x max (bf16 at 2e-2 x max);
the parameter tree equal to JAX's; `FixedBatchEngine` with
`audio_embeds` streams equal to the JAX engine's, greedy and sampled.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, Mesh

from repro.configs import get_config as jax_get_config
from repro.distributed.sharding import DEFAULT_RULES
from repro.models import build_model
from repro.models import attention as JA
from repro.models.common import layer_norm as jax_layer_norm
from repro.serve.engine import FixedBatchEngine as JaxFixedBatchEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.sampling import SamplingParams as JaxSamplingParams
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import steps
from repro_torch.models import EncDecLM
from repro_torch.models import attention as A
from repro_torch.models.common import layer_norm
from repro_torch.models.zoo import layer_params
from repro_torch.serve import FixedBatchEngine, SamplingParams, ServeConfig, ServeEngine

VOCAB = 97
F32_RTOL, BF16_RTOL = 1e-5, 2e-2
REDUCTION = dict(d_model=64, d_ff=128, vocab=VOCAB, dtype="float32")


@pytest.fixture(scope="module")
def encdec():
    jcfg = jax_get_config("whisper-base").reduced(**REDUCTION)
    tcfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)})
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, EncDecLM(tcfg), tparams


def _mesh():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"),
                axis_types=(AxisType.Auto, AxisType.Auto))


def _close(got, want, rtol=F32_RTOL):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    err = np.abs(got.float().numpy() - want).max()
    assert err <= rtol * np.abs(want).max(), err


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tuple(tree.shape)}


def _audio(cfg, batch=None, seed=5):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return a if batch is None else np.broadcast_to(a, (batch, *a.shape)).copy()


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 7, 64)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    want = jax_layer_norm({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x, jnp.dtype(dtype)))
    got = layer_norm({k: torch.from_numpy(v) for k, v in p.items()},
                     torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, F32_RTOL if dtype == "float32" else BF16_RTOL)


def test_parameter_tree_equals_the_jax_tree(encdec):
    _, jparams, model, _ = encdec
    params = model.init(torch.Generator().manual_seed(0))
    assert _flat(params) == _flat(jax.tree.map(np.asarray, jparams))
    sp = model.init_serving(torch.Generator().manual_seed(0))
    assert sp["enc_pos"].dtype == torch.float32      # f32, cast where added
    assert sp["decoder"]["self_norm"]["bias"].dtype == torch.float32


def test_encode_and_cross_kv_match_jax(encdec):
    jmodel, jparams, model, params = encdec
    audio = _audio(model.cfg, batch=2)
    jenc = jmodel.encode(jparams, jnp.asarray(audio))
    sp = model.serving_params(params, "cpu")
    enc = model.encode(sp, torch.from_numpy(audio))
    assert enc.shape == (2, model.cfg.enc_seq, model.cfg.d_model)
    _close(enc, jenc)
    jbp = jax.tree.map(lambda a: a[1], jparams["decoder"])
    jk, jv = JA.cross_kv(jbp["cross_attn"], jmodel.cfg, jenc)
    k, v = A.cross_kv(layer_params(sp["decoder"], 1)["cross_attn"], model.cfg, enc)
    _close(k, jk)
    _close(v, jv)


@pytest.mark.parametrize("batch,plen", [(1, 6), (2, 11)])
def test_prefill_and_decode_match_jax(encdec, batch, plen):
    jmodel, jparams, model, params = encdec
    rng = np.random.default_rng(batch * 10 + plen)
    toks = rng.integers(0, VOCAB, size=(batch, plen)).astype(np.int32)
    audio = _audio(model.cfg, batch=batch, seed=plen)
    max_seq = 32
    jlogits, jcache = jmodel.prefill(
        jparams, {"tokens": jnp.asarray(toks), "audio_embeds": jnp.asarray(audio)},
        max_seq)
    sp = model.serving_params(params, "cpu")
    logits, cache = steps.prefill_step(model, sp, torch.as_tensor(toks), max_seq,
                                       {"audio_embeds": torch.from_numpy(audio)})
    assert logits.shape == (batch, 1, VOCAB)
    _close(logits, jlogits)
    assert set(cache) == set(jcache)
    for key in ("k", "v", "ek", "ev"):
        assert tuple(cache[key].shape) == jcache[key].shape, key
        _close(cache[key], jcache[key])
    for _ in range(3):
        nxt = rng.integers(0, VOCAB, size=(batch, 1)).astype(np.int32)
        jlogits, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(nxt))
        logits, cache = steps.serve_step(model, sp, cache, torch.as_tensor(nxt))
        _close(logits, jlogits)
    _close(cache["k"], jcache["k"])
    assert cache["lengths"].tolist() == np.asarray(jcache["lengths"]).tolist()


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "mixed"])
def test_fixed_batch_with_audio_equals_the_jax_engine(encdec, sampled):
    jmodel, jparams, model, params = encdec
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, VOCAB, size=n).astype(np.int32) for n in (4, 9, 7)]
    extras = {"audio_embeds": _audio(model.cfg)}
    mesh = _mesh()
    jeng = JaxFixedBatchEngine(jmodel, jparams, mesh, DEFAULT_RULES,
                               JaxServeConfig(batch_size=2, max_seq=32,
                                              max_new_tokens=8), extras)
    eng = ServeEngine(model, params, ServeConfig(batch_size=2, max_seq=32,
                                                 max_new_tokens=8),
                      extras=extras, device="cpu")
    assert isinstance(eng._engine, FixedBatchEngine)
    for i, p in enumerate(prompts):
        jeng.submit(p, sampling=_mix(i + 1, JaxSamplingParams) if sampled else None)
        eng.submit(p, sampling=_mix(i + 1, SamplingParams) if sampled else None)
    with mesh:
        want = {r.rid: [int(t) for t in r.output] for r in jeng.run()}
    got = {r.rid: [int(t) for t in r.output] for r in eng.run()}
    assert got == want
    assert eng.stats["requests"] == 3
