"""The port's hybrid family (Zamba2: Mamba2 layers and one shared
attention block) against the JAX package's `HybridLM`.

zamba2-1.2b reduced with `n_layers=5` (groups of 2, 2 and a remainder of
1 with no shared block after it), d_model 64, d_ff 128, vocab 97, f32
(ssm_state 16, ssm_head_dim 16, ssm_chunk 16, 4 / 2 heads x 32),
parameters from a JAX `init` through `bridge`.  The parameter tree's keys
and shapes equal JAX's; `prefill` logits and all four caches (conv, ssm,
k, v) and two `decode_step`s at 1e-5 x max; `init_serving` bitwise equal
to `serving_params(init())`; `FixedBatchEngine` greedy and sampled
streams equal to the JAX engine's, and `ServeEngine` routing the hybrid
to the loop.
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
from repro.serve.engine import FixedBatchEngine as JaxFixedBatchEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.sampling import SamplingParams as JaxSamplingParams
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import steps
from repro_torch.models import HybridLM
from repro_torch.serve import (FixedBatchEngine, SamplingParams, ServeConfig,
                               ServeEngine, resolve_family_adapter)

VOCAB = 97
F32_RTOL = 1e-5
REDUCTION = dict(n_layers=5, d_model=64, d_ff=128, vocab=VOCAB, dtype="float32")


@pytest.fixture(scope="module")
def hybrid():
    jcfg = jax_get_config("zamba2-1.2b").reduced(**REDUCTION)
    tcfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)})
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, HybridLM(tcfg), tparams


def _mesh():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"),
                axis_types=(AxisType.Auto, AxisType.Auto))


def _close(got, want, rtol=F32_RTOL):
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= rtol * np.abs(want).max(), err


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tuple(tree.shape)}


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


def test_groups_and_shared_uses(hybrid):
    _, _, model, _ = hybrid
    assert model._group_sizes() == [2, 2, 1] and model.n_shared_uses == 2
    full = HybridLM(get_config("zamba2-1.2b"))
    assert full._group_sizes() == [6] * 6 + [2] and full.n_shared_uses == 6


def test_parameter_tree_equals_the_jax_tree(hybrid):
    jmodel, jparams, model, _ = hybrid
    params = model.init(torch.Generator().manual_seed(0))
    assert _flat(params) == _flat(jax.tree.map(np.asarray, jparams))
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(
        params, is_leaf=lambda x: isinstance(x, torch.Tensor)))


@pytest.mark.parametrize("batch,plen", [(1, 12), (2, 16), (2, 32)])
def test_prefill_and_decode_match_jax(hybrid, batch, plen):
    jmodel, jparams, model, params = hybrid
    rng = np.random.default_rng(batch * 100 + plen)
    toks = rng.integers(0, VOCAB, size=(batch, plen)).astype(np.int32)
    max_seq = 48
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_seq)
    sp = model.serving_params(params, "cpu")
    logits, cache = steps.prefill_step(model, sp, torch.as_tensor(toks), max_seq)
    assert logits.shape == (batch, 1, VOCAB)
    _close(logits, jlogits)
    assert set(cache) == set(jcache)
    for key in ("conv", "ssm", "k", "v"):
        assert tuple(cache[key].shape) == jcache[key].shape, key
        _close(cache[key], jcache[key])
    assert cache["lengths"].tolist() == [plen] * batch
    for _ in range(2):
        nxt = rng.integers(0, VOCAB, size=(batch, 1)).astype(np.int32)
        jlogits, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(nxt))
        logits, cache = steps.serve_step(model, sp, cache, torch.as_tensor(nxt))
        _close(logits, jlogits)
    for key in ("conv", "ssm", "k", "v"):
        _close(cache[key], jcache[key])
    assert cache["lengths"].tolist() == np.asarray(jcache["lengths"]).tolist()


def test_init_serving_equals_serving_params_of_init(hybrid):
    cfg = dataclasses.replace(hybrid[2].cfg, dtype="bfloat16")
    model = HybridLM(cfg)
    want = model.serving_params(model.init(torch.Generator().manual_seed(7)), "cpu")
    got = model.init_serving(torch.Generator().manual_seed(7))
    assert list(got) == ["embed", "blocks", "shared", "final_norm", "lm_head"]
    flat_w, flat_g = _flat(want), _flat(got)
    assert flat_g == flat_w
    for path in flat_w:
        a, b = got, want
        for k in path.strip("/").split("/"):
            a, b = a[k], b[k]
        assert a.dtype == b.dtype and torch.equal(a, b), path
    assert got["shared"]["in_proj"]["w"].dtype == torch.bfloat16
    assert got["shared"]["attn_norm"]["scale"].dtype == torch.float32


def _prompts(lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, size=n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "mixed"])
def test_fixed_batch_streams_equal_the_jax_engine(hybrid, sampled):
    """Batch 2, left-padded to at most ssm_chunk (16) rows."""
    jmodel, jparams, model, params = hybrid
    prompts = _prompts((12, 9, 16, 5))
    mesh = _mesh()
    jeng = JaxFixedBatchEngine(jmodel, jparams, mesh, DEFAULT_RULES,
                               JaxServeConfig(batch_size=2, max_seq=48,
                                              max_new_tokens=8))
    eng = ServeEngine(model, params, ServeConfig(batch_size=2, max_seq=48,
                                                 max_new_tokens=8), device="cpu")
    assert isinstance(eng._engine, FixedBatchEngine)
    for i, p in enumerate(prompts):
        jeng.submit(p, sampling=_mix(i, JaxSamplingParams) if sampled else None)
        eng.submit(p, sampling=_mix(i, SamplingParams) if sampled else None)
    with mesh:
        want = {r.rid: [int(t) for t in r.output] for r in jeng.run()}
    got = {r.rid: [int(t) for t in r.output] for r in eng.run()}
    assert got == want
    assert eng.stats["tokens_out"] == len(prompts) * 8 and eng.throughput() > 0


def test_serve_engine_routes_the_hybrid_to_the_loop(hybrid):
    _, _, model, params = hybrid
    assert not hasattr(model, "decode_step_paged")
    with pytest.raises(TypeError, match="fixed-batch ServeEngine"):
        resolve_family_adapter(model)
    eng = ServeEngine(model, params, ServeConfig(batch_size=2, max_seq=48),
                      device="cpu")
    assert isinstance(eng._engine, FixedBatchEngine)
