"""The port's keyed sampling against the JAX package's.

`repro_torch.kernels.ref` writes jax.random's threefry2x32 generator as
uint32 arithmetic; its key derivation, bits and uniforms must equal
jax.random's bit for bit (integer ops: tolerance 0), and its Gumbel noise,
-log(-log(u)), is within 2 ulp of max(|g|, 1) of jax's: XLA's CPU `log` is
within 1 ulp of the rounded result (it differs from PyTorch's in ~14 % of
inputs), and near g = 0 one ulp of the inner log is many ulps of g itself.
The masks (`mask_top_k`, `mask_top_p`) equal the reference's, ties
included, on the cases of `tests/test_sampling.py`; `sample_tokens`
equals `repro.serve.sampling.sample_host` token for token.  Then the f32
`tiny` model of `tests/test_torch_serving.py` is served with the bench's
mixed sampling cycle by the JAX `ContinuousEngine` and the port's, under
sharing on and off and under preemption: sampled streams must be equal.
On the CPU the draw runs `ref.sample_draw_ref`; the CUDA kernel is held
against it on the card by `chip_smoke.py`.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng
from jax.sharding import AxisType, Mesh

import repro.serve as jax_serve
from repro.configs import get_config as jax_get_config
from repro.distributed.sharding import DEFAULT_RULES
from repro.kernels.sampling import derive_key as jax_derive_key
from repro.kernels.sampling import mask_top_k as jax_mask_top_k
from repro.kernels.sampling import mask_top_p as jax_mask_top_p
from repro.models import build_model
from repro.serve.runtime import ContinuousEngine as JaxEngine
from repro.serve.runtime import RuntimeConfig as JaxRuntimeConfig
from repro.serve.sampling import SamplingParams as JaxSamplingParams
from repro.serve.sampling import sample_host as jax_sample_host
import repro_torch.serve as port_serve
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ref
from repro_torch.kernels.sampling import (draw_splits, mask_top_k, mask_top_p,
                                          sample_draw, sample_tokens)
from repro_torch.models import DecoderLM
from repro_torch.serve import traceview
from repro_torch.serve.runtime import ContinuousEngine, RuntimeConfig
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.trace import TraceRecorder, write_trace

SEEDS = (0, 1, 2**31 - 1)
RIDS = (1, 1000)
TOKEN_INDICES = (0, 9)
VOCABS = (97, 151936)


def _port_key(seed, rid, index):
    return ref.derive_key(torch.tensor([[seed, rid, index]], dtype=torch.int32))


def _jax_key(seed, rid, index):
    return jax_derive_key(jnp.int32(seed), jnp.int32(rid), jnp.int32(index))


# ------------------------------------------------------------- threefry
@pytest.mark.parametrize("n", [1, 2, 7, 64])
def test_threefry2x32_equals_jax(n):
    rng = np.random.default_rng(n)
    key = rng.integers(0, 2**32, size=2, dtype=np.uint64).astype(np.uint32)
    count = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(prng.threefry_2x32(jnp.asarray(key), jnp.asarray(count)))
    got = ref.threefry2x32(torch.tensor(key.astype(np.int64)),
                           torch.tensor(count.astype(np.int64)))
    assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_seed_and_fold_in_equal_jax(seed):
    """PRNGKey of an int32 seed is [0, seed] (checked, not assumed), and
    fold_in hashes (0, data)."""
    jkey = jax.random.PRNGKey(jnp.int32(seed))
    want = np.asarray(jax.random.key_data(jkey) if jnp.issubdtype(
        jkey.dtype, jax.dtypes.prng_key) else jkey).astype(np.int64)
    got = ref.threefry_seed(torch.tensor([seed], dtype=torch.int32))[0]
    assert np.array_equal(got.numpy(), want)
    assert want[0] == 0 and want[1] == seed
    for data in RIDS:
        folded = np.asarray(jax.random.fold_in(jkey, data)).astype(np.int64)
        assert np.array_equal(
            ref.fold_in(got, torch.tensor(data)).numpy(), folded)


@pytest.mark.parametrize("v", VOCABS)
@pytest.mark.parametrize("index", TOKEN_INDICES)
@pytest.mark.parametrize("rid", RIDS)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniforms_equal_jax_bitwise(seed, rid, index, v):
    jkey = _jax_key(seed, rid, index)
    key = _port_key(seed, rid, index)
    assert np.array_equal(key[0].numpy(), np.asarray(jkey).astype(np.int64))
    bits = ref.random_bits(key, v)[0]
    assert np.array_equal(
        bits.numpy(), np.asarray(jax.random.bits(jkey, (v,), jnp.uint32)).astype(np.int64))
    u = ref.uniform_from_bits(bits)
    want = np.asarray(jax.random.uniform(jkey, (v,), jnp.float32,
                                         minval=np.finfo(np.float32).tiny, maxval=1.0))
    assert np.array_equal(u.numpy().view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("v", VOCABS)
@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_two_ulp_of_jax(seed, v):
    for rid, index in ((1, 0), (1000, 9)):
        want = np.asarray(jax.random.gumbel(_jax_key(seed, rid, index), (v,),
                                            jnp.float32)).astype(np.float64)
        got = ref.gumbel_from_uniform(
            ref.uniform_from_bits(ref.random_bits(_port_key(seed, rid, index), v)))
        ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
        assert (np.abs(got.numpy().astype(np.float64) - want) <= 2 * ulp).all()


# ------------------------------------------------------------- masks
@pytest.mark.parametrize("k", [0, 1, 2, 7, 40, 41, 1000])
def test_top_k_mask_equals_reference(k):
    rng = np.random.default_rng(0)
    x = rng.permutation(41).astype(np.float32)           # all distinct
    x2 = np.repeat(np.arange(8, dtype=np.float32), 5)[:41]  # ties at the k-th
    for row in (x, x2):
        want = np.asarray(jax_mask_top_k(jnp.asarray(row), jnp.int32(k)))
        got = mask_top_k(torch.tensor(row)[None], torch.tensor([k]))[0].numpy()
        assert np.array_equal(got, want)


@pytest.mark.parametrize("p", [0.05, 0.3, 0.72, 0.95, 1.0])
def test_top_p_mask_equals_reference(p):
    rng = np.random.default_rng(1)
    x = rng.normal(size=53).astype(np.float32)
    tied = np.asarray([2.0, 2.0, 1.0, 1.0, 1.0, 0.0, -1.0], np.float32)
    for row in (x, tied):
        want = np.asarray(jax_mask_top_p(jnp.asarray(row), jnp.float32(p)))
        got = mask_top_p(torch.tensor(row)[None], torch.tensor([p]))[0].numpy()
        assert np.array_equal(got, want)
    # p = 1.0 passes the logits through untouched
    assert np.array_equal(mask_top_p(torch.tensor(x)[None], torch.tensor([1.0]))[0].numpy(), x)


# ------------------------------------------------------------- sample_tokens
def _mixed_rows(rows, rng):
    sp = np.zeros((rows, 3), np.float32)
    sp[:, 2] = 1.0
    ks = np.zeros((rows, 3), np.int32)
    for i in range(rows):
        sp[i] = [(0.0, 0.8, 1.0, 0.9)[i % 4], (0, 0, 8, 0)[i % 4],
                 (1.0, 1.0, 1.0, 0.85)[i % 4]]
        ks[i] = [int(rng.integers(0, 2**31 - 1)), int(rng.integers(1, 5000)),
                 int(rng.integers(0, 40))]
    return sp, ks


@pytest.mark.parametrize("v", [31, 97, 4099])
def test_sample_tokens_equal_jax(v):
    rng = np.random.default_rng(v)
    logits = rng.normal(size=(64, v)).astype(np.float32) * 3
    sp, ks = _mixed_rows(64, rng)
    want = np.asarray(jax_sample_host(jnp.asarray(logits), sp, ks))
    got = sample_tokens(torch.tensor(logits), sp, ks).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, want)
    assert (got != logits.argmax(-1)).any()          # the draw is live


def test_temperature_zero_is_argmax_despite_knobs():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(6, 31)).astype(np.float32)
    logits[0, 3] = logits[0, 7] = logits[0].max() + 1   # a tie: first index
    sp = np.zeros((6, 3), np.float32)
    sp[:, 1] = 3.0
    sp[:, 2] = 0.4
    ks = np.stack([np.arange(6)] * 3, 1).astype(np.int32)
    got = sample_tokens(torch.tensor(logits), sp, ks).numpy()
    assert np.array_equal(got, logits.argmax(-1).astype(np.int32))
    assert got[0] == 3


def test_draw_is_a_pure_function_of_its_key_triple():
    """The same (seed, rid, token_index) draws the same token wherever its
    row sits and whatever shares the batch."""
    rng = np.random.default_rng(3)
    row = rng.normal(size=29).astype(np.float32)

    def at(position, width):
        logits = rng.normal(size=(width, 29)).astype(np.float32)
        logits[position] = row
        sp = np.tile(np.asarray([0.7, 0, 1.0], np.float32), (width, 1))
        sp[position] = [0.9, 0, 1.0]
        ks = np.stack([np.arange(width)] * 3, 1).astype(np.int32)
        ks[position] = [42, 7, 5]
        return int(sample_tokens(torch.tensor(logits), sp, ks)[position])

    assert len({at(0, 1), at(0, 4), at(3, 4), at(5, 8)}) == 1


def test_sample_draw_wrapper_routes_cpu_tensors_to_the_plain_version():
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.normal(size=(3, 50)).astype(np.float32))
    keys = torch.tensor([[1, 2, 3], [4, 5, 6], [7, 8, 9]], dtype=torch.int32)
    temps = torch.tensor([0.0, 1.0, 0.5])
    before = sample_draw.launches
    got = sample_draw(x, x, temps, keys)
    assert torch.equal(got, ref.sample_draw_ref(x, x, temps, keys))
    assert sample_draw.launches == before            # no kernel ran
    with pytest.raises(ValueError, match="uniforms"):
        sample_draw(x, x, temps, keys, uniforms=torch.empty(3, 50))


@pytest.mark.parametrize("rows,v", [(8, 151936), (4, 151936), (1, 97), (8, 97)])
def test_draw_splits_cover_the_card_and_leave_no_split_empty(rows, v):
    s = draw_splits(rows, v)
    assert 1 <= s <= v
    chunk = -(-v // s)
    assert (s - 1) * chunk < v                        # every split has work
    if v >= 256 * 132:
        assert rows * s >= 132


# ------------------------------------------------------------- engines
# the bench's mixed sampling cycle (benchmarks/bench_serving.py:158)
def _mix(i, cls):
    r = i % 4
    if r == 0:
        return cls()
    if r == 1:
        return cls(temperature=0.8, seed=1000 + i)
    if r == 2:
        return cls(temperature=1.0, top_k=8, seed=1000 + i)
    return cls(temperature=0.9, top_p=0.85, seed=1000 + i)


RUNTIME = dict(max_slots=3, block_size=8, max_blocks_per_seq=8, chunk_tokens=16,
               num_blocks=9, max_new_tokens=10)


def _prompts():
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 97, size=n).astype(np.int32)
               for n in (11, 30, 5, 40, 3, 22)]
    prompts[3][:24] = prompts[1][:24]
    prompts[5][:16] = prompts[1][:16]
    return prompts


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


def _serve_jax(tiny, **rcfg):
    jmodel, jparams, _, _ = tiny
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"),
                axis_types=(AxisType.Auto, AxisType.Auto))
    eng = JaxEngine(jmodel, jparams, mesh, DEFAULT_RULES, JaxRuntimeConfig(**rcfg))
    for i, p in enumerate(_prompts()):
        eng.submit(p, sampling=_mix(i, JaxSamplingParams))
    with mesh:
        done = eng.run()
    return {r.rid: [int(t) for t in r.output] for r in done}, eng.metrics.summary()


def _serve_port(tiny, trace=None, **rcfg):
    _, _, model, params = tiny
    eng = ContinuousEngine(model, params, RuntimeConfig(**rcfg), trace=trace,
                           device="cpu")
    for i, p in enumerate(_prompts()):
        eng.submit(p, sampling=_mix(i, SamplingParams))
    done = eng.run()
    eng.cache.alloc.check_invariants()
    assert eng.cache.alloc.num_used == 0
    return {r.rid: [int(t) for t in r.output] for r in done}, eng


@pytest.mark.parametrize("change", [{}, dict(prefix_sharing=True), dict(num_blocks=None)],
                         ids=["preempting", "sharing_on", "unconstrained"])
def test_sampled_streams_equal_the_jax_engine(tiny, change):
    rcfg = {**RUNTIME, **change}
    want, jax_summary = _serve_jax(tiny, **rcfg)
    got, eng = _serve_port(tiny, **rcfg)
    assert got == want
    summary = eng.metrics.summary()
    for k in ("preemptions", "prefix_hit_tokens", "cow_copies", "resume_commits"):
        assert summary[k] == jax_summary[k], k
    if "num_blocks" not in change:
        assert summary["preemptions"] > 0
    if change.get("prefix_sharing"):
        assert summary["prefix_hit_tokens"] > 0
    # sampling is traced data: still one signature per step program
    assert eng._unified._cache_size() == eng._decode_only._cache_size() == 1


def test_sampled_streams_differ_from_greedy_and_keep_greedy_rows_greedy(tiny):
    _, _, model, params = tiny
    sampled, _ = _serve_port(tiny, **RUNTIME)
    eng = ContinuousEngine(model, params, RuntimeConfig(**RUNTIME), device="cpu")
    for p in _prompts():
        eng.submit(p)
    greedy = {r.rid: r.output for r in eng.run()}
    for rid in sampled:
        if (rid - 1) % 4 == 0:
            assert sampled[rid] == greedy[rid]
    assert any(sampled[rid] != greedy[rid] for rid in sampled)


def test_traceview_audits_a_sampled_trace_and_detects_tampering(tiny, tmp_path):
    rec = TraceRecorder()
    _, eng = _serve_port(tiny, trace=rec, **RUNTIME)
    report = traceview.audit(rec.events, metrics=eng.metrics,
                             metadata={"usable_blocks": eng.kv_cfg.num_blocks - 1})
    assert report.ok, report.summary()
    n_sampled = sum(1 for i in range(len(_prompts()))
                    if not _mix(i, SamplingParams).greedy)
    assert report.checks["sampled_requests"] == n_sampled
    path = tmp_path / "trace.json"
    write_trace(str(path), rec.events, eng.metrics,
                metadata={"usable_blocks": RUNTIME["num_blocks"] - 1,
                          "block_size": RUNTIME["block_size"], "mesh": "1x1"})
    assert traceview.main([str(path), "--quiet"]) == 0

    evs = copy.deepcopy(rec.events)
    tok = next(e for e in evs if e.name == "decode_token")
    tok.fields["token"] = (tok.fields["token"] + 1) % 97
    bad = traceview.audit(evs)
    assert any("digest" in v for v in bad.violations), bad.summary()

    evs = copy.deepcopy(rec.events)
    sub = next(e for e in evs if e.name == "submit" and "seed" in e.fields)
    del sub.fields["seed"]
    bad = traceview.audit(evs)
    assert any("seed" in v for v in bad.violations), bad.summary()


def test_serve_exports_the_decoder_half_of_the_reference():
    # and, since the ssm family is ported, the other half too
    assert set(port_serve.__all__) == set(jax_serve.__all__)
    for name in port_serve.__all__:
        assert getattr(port_serve, name) is not None
