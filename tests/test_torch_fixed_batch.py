"""The port's fixed-batch engine and its dense-cache model path against the
JAX package's.

`DecoderLM.prefill` / `decode_step` (the reference's XLA lane, plain
PyTorch in the port) must give the JAX model's logits within 1e-5 x max
|logit| on the f32 `tiny` model of `tests/test_torch_serving.py` (f32
rounding differs between the frameworks' matmuls and softmaxes).  The
port's `FixedBatchEngine` at batch 1 is the per-request ground truth, as
in `tests/test_sampling.py`: its streams, greedy and sampled with the
bench's mixed cycle, must equal the port's `ContinuousEngine` on a
chunked, packed and preempting schedule, and the JAX `FixedBatchEngine`
token for token; a left-padded batch of 2 must equal the JAX engine's
batch of 2.
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
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import steps
from repro_torch.models import DecoderLM
from repro_torch.serve import (ContinuousEngine, FixedBatchEngine, RuntimeConfig,
                               SamplingParams, ServeConfig, ServeEngine,
                               truncate_at_eos)

MAX_NEW = 10
LOGIT_RTOL = 1e-5


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_get_config("qwen3-1.7b").reduced(n_layers=2, d_model=64, d_ff=128,
                                                vocab=97, dtype="float32")
    tcfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)})
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, DecoderLM(tcfg), tparams


def _mesh():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"),
                axis_types=(AxisType.Auto, AxisType.Auto))


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


def _prompts(sizes=(12, 11, 13, 12)):
    rng = np.random.default_rng(7)
    return [rng.integers(0, 97, size=s).astype(np.int32) for s in sizes]


def _close(got, want):
    want = np.asarray(want, np.float32)
    err = np.abs(got.numpy() - want).max()
    assert err <= LOGIT_RTOL * np.abs(want).max(), err


# ------------------------------------------------------------- model path
@pytest.mark.parametrize("batch,plen", [(1, 5), (2, 13), (3, 1)])
def test_prefill_and_decode_logits_match_jax(tiny, batch, plen):
    jmodel, jparams, model, params = tiny
    rng = np.random.default_rng(batch * 100 + plen)
    toks = rng.integers(0, 97, size=(batch, plen)).astype(np.int32)
    max_seq = 32
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_seq)
    sp = model.serving_params(params, "cpu")
    logits, cache = steps.prefill_step(model, sp, torch.as_tensor(toks), max_seq)
    assert logits.shape == (batch, 1, 97)
    _close(logits, jlogits)
    _close(cache["k"][:, :, :plen], np.asarray(jcache["k"])[:, :, :plen])
    assert cache["lengths"].tolist() == [plen] * batch
    for _ in range(4):
        nxt = rng.integers(0, 97, size=(batch, 1)).astype(np.int32)
        jlogits, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(nxt))
        logits, cache = steps.serve_step(model, sp, cache, torch.as_tensor(nxt))
        _close(logits, jlogits)
    assert cache["lengths"].tolist() == np.asarray(jcache["lengths"]).tolist()


# ------------------------------------------------------------- engines
def _jax_fixed(tiny, prompts, samplings, batch_size=1, eos_id=-1):
    jmodel, jparams, _, _ = tiny
    mesh = _mesh()
    eng = JaxFixedBatchEngine(jmodel, jparams, mesh, DEFAULT_RULES,
                              JaxServeConfig(batch_size=batch_size, max_seq=64,
                                             max_new_tokens=MAX_NEW, eos_id=eos_id))
    for p, s in zip(prompts, samplings):
        eng.submit(p, sampling=s)
    with mesh:
        return {r.rid: [int(t) for t in r.output] for r in eng.run()}


def _port_fixed(tiny, prompts, samplings, batch_size=1, eos_id=-1):
    _, _, model, params = tiny
    eng = FixedBatchEngine(model, params,
                           ServeConfig(batch_size=batch_size, max_seq=64,
                                       max_new_tokens=MAX_NEW, eos_id=eos_id),
                           device="cpu")
    for p, s in zip(prompts, samplings):
        eng.submit(p, sampling=s)
    return {r.rid: [int(t) for t in r.output] for r in eng.run()}, eng


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "mixed"])
def test_fixed_batch_b1_equals_the_continuous_engine_and_jax(tiny, sampled):
    """tests/test_sampling.py::test_decoder_sampled_streams_match_fixed_drain,
    across the frameworks too."""
    _, _, model, params = tiny
    prompts = _prompts()
    samplings = [_mix(i, SamplingParams) if sampled else SamplingParams()
                 for i in range(len(prompts))]
    ref, fixed = _port_fixed(tiny, prompts, samplings)
    assert fixed.stats["tokens_out"] == len(prompts) * MAX_NEW
    assert fixed.stats["requests"] == len(prompts)
    jsamplings = [_mix(i, JaxSamplingParams) if sampled else JaxSamplingParams()
                  for i in range(len(prompts))]
    assert ref == _jax_fixed(tiny, prompts, jsamplings)

    # the family-seam preemption config: chunked, packed, block pressure
    eng = ContinuousEngine(model, params,
                           RuntimeConfig(max_slots=3, block_size=4,
                                         max_blocks_per_seq=8, num_blocks=10,
                                         chunk_tokens=8, chunk_segments=2,
                                         max_new_tokens=MAX_NEW), device="cpu")
    for p, s in zip(prompts, samplings):
        eng.submit(p, sampling=s)
    done = {r.rid: r.output for r in eng.run()}
    assert done == ref
    assert eng.metrics.preemptions >= 1
    assert eng._unified._cache_size() == eng._decode_only._cache_size() == 1
    if sampled:
        greedy, _ = _port_fixed(tiny, prompts, [SamplingParams()] * len(prompts))
        assert any(done[r] != greedy[r] for r in done)
        for rid, s in enumerate(samplings, start=1):
            if s.greedy:
                assert done[rid] == greedy[rid]


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "mixed"])
def test_left_padded_batch_of_two_equals_jax(tiny, sampled):
    prompts = _prompts((12, 7, 9))
    samplings = [_mix(i + 1, SamplingParams) if sampled else SamplingParams()
                 for i in range(len(prompts))]
    jsamplings = [_mix(i + 1, JaxSamplingParams) if sampled else JaxSamplingParams()
                  for i in range(len(prompts))]
    got, _ = _port_fixed(tiny, prompts, samplings, batch_size=2)
    assert got == _jax_fixed(tiny, prompts, jsamplings, batch_size=2)


def test_fixed_batch_eos_truncation_stats_and_latency(tiny):
    prompts = _prompts((12, 11))
    streams, _ = _port_fixed(tiny, prompts, [SamplingParams()] * 2, batch_size=2)
    eos = next(t for t in streams[1][:-1]
               if len(truncate_at_eos(streams[1], t)) < MAX_NEW)
    got, eng = _port_fixed(tiny, prompts, [SamplingParams()] * 2, batch_size=2,
                           eos_id=eos)
    lens = [len(truncate_at_eos(streams[r], eos)) for r in (1, 2)]
    assert [got[1], got[2]] == [truncate_at_eos(streams[r], eos) for r in (1, 2)]
    assert eng.stats["tokens_out"] == sum(lens) < 2 * MAX_NEW


def test_submit_rejects_invalid_sampling(tiny):
    _, _, model, params = tiny
    eng = FixedBatchEngine(model, params, ServeConfig(batch_size=1), device="cpu")
    with pytest.raises(ValueError, match="top_p"):
        eng.submit(np.arange(4, dtype=np.int32), sampling=SamplingParams(top_p=0.0))


def test_serve_engine_routes_decoders_to_the_continuous_engine(tiny):
    _, _, model, params = tiny
    cfg = ServeConfig(batch_size=2, max_seq=64, max_new_tokens=MAX_NEW)
    eng = ServeEngine(model, params, cfg, device="cpu")
    assert isinstance(eng._engine, ContinuousEngine)
    prompts = _prompts()
    for i, p in enumerate(prompts):
        eng.submit(p, sampling=_mix(i, SamplingParams))
    done = eng.run()
    want, _ = _port_fixed(tiny, prompts, [_mix(i, SamplingParams)
                                          for i in range(len(prompts))])
    assert {r.rid: r.output for r in done} == want
    assert [r.rid for r in done] == sorted(want)
    assert eng.stats["tokens_out"] == len(prompts) * MAX_NEW
    assert eng._engine.metrics.tokens_out == 0          # reset after the run
    assert eng.throughput() > 0


def test_extras_wait_for_the_families_slice(tiny, monkeypatch):
    """(The name is kept from when extras were refused.)  Modality extras
    send ServeEngine to the fixed-batch loop (the reference's predicate),
    and each batch's prefill_step receives every extra broadcast over the
    batch, on the engine's device."""
    _, _, model, params = tiny
    extras = {"vision_embeds": np.arange(4 * 64, dtype=np.float32).reshape(4, 64)}
    seen = []

    def prefill_step(model_, params_, tokens, max_seq, extras_=None):
        seen.append(extras_)
        return steps.prefill_step(model_, params_, tokens, max_seq)

    monkeypatch.setattr("repro_torch.serve.engine.prefill_step", prefill_step)
    cfg = ServeConfig(batch_size=2, max_seq=64, max_new_tokens=MAX_NEW)
    eng = ServeEngine(model, params, cfg, extras=extras, device="cpu")
    assert isinstance(eng._engine, FixedBatchEngine)
    for p in _prompts((12, 7, 9)):
        eng.submit(p)
    done = eng.run()
    assert len(done) == 3 and len(seen) == 2
    for got in seen:
        assert list(got) == ["vision_embeds"]
        v = got["vision_embeds"]
        assert v.shape == (2, 4, 64) and v.device.type == "cpu"
        assert all(torch.equal(v[i], torch.from_numpy(extras["vision_embeds"]))
                   for i in range(2))
    # a dense decoder takes no vision embeddings: the streams are the
    # extras-free loop's
    want, _ = _port_fixed(tiny, _prompts((12, 7, 9)), [SamplingParams()] * 3,
                          batch_size=2)
    assert {r.rid: r.output for r in done} == want
