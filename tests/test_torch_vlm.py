"""The port's vlm family (qwen2-vl: M-RoPE, vision embeddings) against the
JAX package's.

qwen2-vl-2b reduced to 2 layers, d_model 64, d_ff 128, vocab 97, f32
(head_dim 32, M-RoPE sections (4, 6, 6), 8 vision tokens on a 2 x 2
grid), parameters from a JAX `init` through `bridge`.  `apply_mrope`
against the JAX function at sections (4, 6, 6) and the published
(16, 24, 24), f32 at 1e-5 x max and bf16 at 2e-2 x max, over positions
that cross the vision span; `_position_ids` equal at offset 0 and mid
chunk; `DecoderLM.prefill` (with and without `vision_embeds`),
`decode_step`, `prefill_packed_paged` and `decode_step_paged` logits at
1e-5 x max |logit|; `ContinuousEngine` streams equal to the JAX engine's
(the RUNTIME and prompts of `tests/test_torch_serving.py`: chunking,
packing, preemption; greedy with sharing off, the mixed sampling cycle
with sharing on), chunked = unchunked and packed = single-segment bitwise
in the port; the M-RoPE step programs through the stubbed capture path
with every host-to-device copy refused; `FixedBatchEngine` with vision
extras equal to the JAX engine's, a batch shorter than the vision span
included.
"""

import contextlib
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
from repro.models.common import apply_mrope as jax_apply_mrope
from repro.serve.engine import FixedBatchEngine as JaxFixedBatchEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.runtime import ContinuousEngine as JaxEngine
from repro.serve.runtime import RuntimeConfig as JaxRuntimeConfig
from repro.serve.sampling import SamplingParams as JaxSamplingParams
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import steps
from repro_torch.models import DecoderLM
from repro_torch.models.common import apply_mrope
from repro_torch.serve import (ContinuousEngine, FixedBatchEngine, RuntimeConfig,
                               SamplingParams, ServeConfig, ServeEngine)

VOCAB = 97
F32_RTOL, BF16_RTOL = 1e-5, 2e-2
# tests/test_torch_serving.py's workload: long prompts chunk, short ones
# pack, and decode growth preempts
RUNTIME = dict(max_slots=3, block_size=8, max_blocks_per_seq=8, chunk_tokens=16,
               num_blocks=9, max_new_tokens=10)
PROMPT_LENS = (11, 30, 5, 40, 3, 22)


@pytest.fixture(scope="module")
def vlm():
    jcfg = jax_get_config("qwen2-vl-2b").reduced(n_layers=2, d_model=64, d_ff=128,
                                                 vocab=VOCAB, dtype="float32")
    tcfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)})
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, DecoderLM(tcfg), tparams


def _mesh():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"),
                axis_types=(AxisType.Auto, AxisType.Auto))


def _close(got, want, rtol=F32_RTOL):
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= rtol * np.abs(want).max(), err


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


def _prompts(lens=PROMPT_LENS, seed=0):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, VOCAB, size=n).astype(np.int32) for n in lens]
    if lens == PROMPT_LENS:      # full blocks for prefix sharing to adopt
        prompts[3][:24] = prompts[1][:24]
        prompts[5][:16] = prompts[1][:16]
    return prompts


def _vision(cfg, seed=5):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)


# ------------------------------------------------------------- M-RoPE
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sections,nv", [((4, 6, 6), 8), ((16, 24, 24), 256)])
def test_apply_mrope_matches_jax(vlm, sections, nv, dtype):
    jmodel = vlm[0]
    d = 2 * sum(sections)
    s, h = nv + 24, 3
    rng = np.random.default_rng(sum(sections))
    x = rng.standard_normal((2, s, h, d)).astype(np.float32)
    jcfg = dataclasses.replace(jmodel.cfg, mrope_sections=sections, n_vision_tokens=nv)
    pos = np.array(type(jmodel)(jcfg)._position_ids(2, jnp.arange(s)))
    pos[1] = pos[1][::-1]                     # a second stream order
    jx = jnp.asarray(x, jnp.dtype(dtype))
    want = jax_apply_mrope(jx, jnp.asarray(pos), sections, 1e6)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = apply_mrope(tx, torch.from_numpy(pos), sections, 1e6)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want.astype(jnp.float32),
           F32_RTOL if dtype == "float32" else BF16_RTOL)


def test_apply_mrope_rejects_sections_that_miss_the_head_dim():
    with pytest.raises(ValueError, match="sections"):
        apply_mrope(torch.zeros((1, 2, 1, 32)), torch.zeros((1, 2, 3)), (4, 6, 4))


@pytest.mark.parametrize("offset", [0, 5, 16])
def test_position_ids_match_jax(vlm, offset):
    jmodel, _, model, _ = vlm
    idx = np.arange(offset, offset + 16)
    want = np.asarray(jmodel._position_ids(3, jnp.asarray(idx)))
    got = model._position_ids(3, torch.from_numpy(idx))
    assert got.shape == (3, 16, 3)
    assert got.numpy().tolist() == want.tolist()


# ------------------------------------------------------------- model paths
@pytest.mark.parametrize("images", [False, True], ids=["text", "vision"])
@pytest.mark.parametrize("batch,plen", [(1, 13), (2, 9)])
def test_prefill_and_decode_match_jax(vlm, images, batch, plen):
    jmodel, jparams, model, params = vlm
    rng = np.random.default_rng(batch * 10 + plen)
    toks = rng.integers(0, VOCAB, size=(batch, plen)).astype(np.int32)
    jbatch, tbatch = {"tokens": jnp.asarray(toks)}, {}
    if images:
        vis = np.broadcast_to(_vision(model.cfg), (batch, 8, 64)).copy()
        jbatch["vision_embeds"] = jnp.asarray(vis)
        tbatch["vision_embeds"] = torch.from_numpy(vis)
    max_seq = 32
    jlogits, jcache = jmodel.prefill(jparams, jbatch, max_seq)
    sp = model.serving_params(params, "cpu")
    logits, cache = steps.prefill_step(model, sp, torch.as_tensor(toks), max_seq,
                                       tbatch)
    assert logits.shape == (batch, 1, VOCAB)
    _close(logits, jlogits)
    _close(cache["k"][:, :, :plen], np.asarray(jcache["k"])[:, :, :plen])
    for _ in range(3):
        nxt = rng.integers(0, VOCAB, size=(batch, 1)).astype(np.int32)
        jlogits, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(nxt))
        logits, cache = steps.serve_step(model, sp, cache, torch.as_tensor(nxt))
        _close(logits, jlogits)
    _close(cache["k"], jcache["k"])
    assert cache["lengths"].tolist() == np.asarray(jcache["lengths"]).tolist()


def test_images_reach_the_prefill(vlm):
    _, _, model, params = vlm
    sp = model.serving_params(params, "cpu")
    toks = torch.as_tensor(_prompts((12,))[0][None])
    vis = torch.from_numpy(_vision(model.cfg))[None]
    with_img, _ = steps.prefill_step(model, sp, toks, 32, {"vision_embeds": vis})
    text, _ = steps.prefill_step(model, sp, toks, 32)
    assert not torch.equal(with_img, text)


def test_paged_paths_match_jax(vlm):
    """A packed chunk of two segments (one crossing the vision span, one
    resumed at kv_start 8) and an idle one, then a decode step over three
    slots, against the JAX paged methods on its XLA lane: logits at 1e-5 x
    max, the pools' written rows too."""
    jmodel, jparams, model, params = vlm
    cfg = model.cfg
    sp = model.serving_params(params, "cpu")
    rng = np.random.default_rng(3)
    nb, bs = 10, 8
    shape = (cfg.n_layers, nb, bs, cfg.n_kv_heads, cfg.hd)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    tables = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [0, 0, 0, 0]], np.int32)
    info = np.array([[0, 11, 0], [11, 5, 8], [16, 0, 0]], np.int32)
    toks = rng.integers(0, VOCAB, size=(1, 18)).astype(np.int32)
    jl, jk, jv = jmodel.prefill_packed_paged(jparams, jnp.asarray(k0), jnp.asarray(v0),
                                             jnp.asarray(tables), jnp.asarray(toks),
                                             jnp.asarray(info))
    kp, vp = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    got = model.prefill_packed_paged(sp, kp, vp, torch.from_numpy(tables),
                                     torch.from_numpy(toks), torch.from_numpy(info))
    _close(got[:, :2], np.asarray(jl)[:, :2])
    for blk in (1, 2, 4, 5):
        _close(kp[:, blk], np.asarray(jk)[:, blk])
        _close(vp[:, blk], np.asarray(jv)[:, blk])

    dec_tables = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [0, 0, 0, 0]], np.int32)
    lengths = np.array([11, 13, 0], np.int32)
    dtoks = rng.integers(0, VOCAB, size=(3, 1)).astype(np.int32)
    jl, jk, _ = jmodel.decode_step_paged(jparams, jk, jv, jnp.asarray(dec_tables),
                                         jnp.asarray(lengths), jnp.asarray(dtoks))
    got = model.decode_step_paged(sp, kp, vp, torch.from_numpy(dec_tables),
                                  torch.from_numpy(lengths), torch.from_numpy(dtoks))
    _close(got[:2], np.asarray(jl)[:2])
    _close(kp[:, 2], np.asarray(jk)[:, 2])


# ------------------------------------------------------------- engines
def _jax_continuous(vlm, sampled, **change):
    jmodel, jparams, _, _ = vlm
    mesh = _mesh()
    eng = JaxEngine(jmodel, jparams, mesh, DEFAULT_RULES,
                    JaxRuntimeConfig(**{**RUNTIME, **change}))
    for i, p in enumerate(_prompts()):
        eng.submit(p, sampling=_mix(i, JaxSamplingParams) if sampled else None)
    with mesh:
        done = eng.run()
    return {r.rid: [int(t) for t in r.output] for r in done}


def _port_continuous(vlm, sampled, **change):
    _, _, model, params = vlm
    eng = ContinuousEngine(model, params, RuntimeConfig(**{**RUNTIME, **change}),
                           device="cpu")
    for i, p in enumerate(_prompts()):
        eng.submit(p, sampling=_mix(i, SamplingParams) if sampled else None)
    done = eng.run()
    eng.cache.alloc.check_invariants()
    assert eng.cache.alloc.num_used == 0
    return {r.rid: [int(t) for t in r.output] for r in done}, eng


@pytest.mark.parametrize("sampled,sharing", [(False, False), (True, True)],
                         ids=["greedy", "mixed_sharing_on"])
def test_continuous_streams_equal_the_jax_engine(vlm, sampled, sharing):
    got, eng = _port_continuous(vlm, sampled, prefix_sharing=sharing)
    assert got == _jax_continuous(vlm, sampled, prefix_sharing=sharing)
    m = eng.metrics
    assert m.preemptions >= 1 and m.packed_segments >= 1
    assert eng._unified._cache_size() == eng._decode_only._cache_size() == 1
    if sharing:
        assert m.prefix_hit_tokens > 0


@pytest.mark.parametrize("change", [dict(chunk_tokens=48), dict(chunk_segments=1)],
                         ids=["unchunked", "single_segment"])
def test_schedules_are_bitwise_identities(vlm, change):
    """Chunked = unchunked and packed = single-segment: each row's M-RoPE
    positions come from its own request's positions, whatever the
    packing."""
    want, _ = _port_continuous(vlm, False)
    got, _ = _port_continuous(vlm, False, **change)
    assert got == want


# --------------------------------------------- the capture, on the CPU
class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph: a replay re-runs nothing."""

    def __init__(self):
        self.replayed = 0

    def replay(self):
        self.replayed += 1


def _refuse(name):
    def refuse(*a, **k):
        raise AssertionError(f"{name} inside a captured step program")
    return refuse


@contextlib.contextmanager
def _no_host_copies(monkeypatch):
    """While capturing: a tensor made from host data, a read back to the
    host or a host-built copy raises (each would be a host-device copy in
    the graph, which a CUDA capture forbids)."""
    with monkeypatch.context() as m:
        as_tensor = torch.as_tensor

        def guarded_as_tensor(data, *a, **k):
            if not isinstance(data, torch.Tensor):
                raise AssertionError("torch.as_tensor of host data inside a capture")
            return as_tensor(data, *a, **k)

        m.setattr(torch, "tensor", _refuse("torch.tensor"))
        m.setattr(torch, "from_numpy", _refuse("torch.from_numpy"))
        m.setattr(torch, "as_tensor", guarded_as_tensor)
        for meth in ("item", "tolist", "numpy", "cpu"):
            m.setattr(torch.Tensor, meth, _refuse(f"Tensor.{meth}"))
        yield


def test_mrope_step_programs_capture_without_host_copies(vlm, monkeypatch):
    """The unified and decode-only programs of the vlm through the capture
    path with the graph API stubbed and every host copy refused inside the
    model's two lanes while capturing (the draw's plain version, which
    the CPU runs in place of the draw kernel, is outside them): the
    warm-up's outputs equal a direct call of the body, and later calls
    replay."""
    _, _, model, params = vlm
    cfg = model.cfg
    sp = model.serving_params(params, "cpu")
    captures = []

    def guarded(fn):
        def call(*a, **k):
            if not capturing:
                return fn(*a, **k)
            with _no_host_copies(monkeypatch):
                return fn(*a, **k)
        return call

    capturing = []
    for lane in ("prefill_packed_paged", "decode_step_paged"):
        monkeypatch.setattr(model, lane, guarded(getattr(model, lane)))

    @contextlib.contextmanager
    def fake_capture(graph, pool=None):
        captures.append(graph)
        capturing.append(True)
        try:
            yield
        finally:
            capturing.clear()

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", fake_capture)
    rng = np.random.default_rng(4)
    shape = (cfg.n_layers, 10, 8, cfg.n_kv_heads, cfg.hd)
    kp = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    dec = (np.array([[1, 2, 0, 0], [3, 0, 0, 0], [0, 0, 0, 0]], np.int32),
           np.array([12, 5, 0], np.int32),
           rng.integers(0, VOCAB, (3, 1)).astype(np.int32))
    chunk = (rng.integers(0, VOCAB, (1, 16)).astype(np.int32),
             np.array([[4, 5, 0, 0], [6, 0, 0, 0]], np.int32),
             np.array([[0, 10, 0], [10, 4, 3]], np.int32))
    samp = (np.zeros((3, 3), np.float32), np.zeros((3, 3), np.int32),
            np.zeros((2, 3), np.float32), np.zeros((2, 3), np.int32))
    uni = steps.graph_unified_step(model, "cpu")
    dec_only = steps.graph_decode_only_step(model, "cpu")
    for prog in (uni, dec_only):
        prog.graphed = True                       # as on a CUDA device

    uni_in = (*dec, *chunk, *samp)
    want = steps.unified_step(model, sp, kp.clone(), vp.clone(),
                              *(torch.from_numpy(a) for a in uni_in))
    got = uni((sp, kp, vp), uni_in)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    dec_in = (*dec, *samp[:2])
    want = steps.decode_only_step(model, sp, kp.clone(), vp.clone(),
                                  *(torch.from_numpy(a) for a in dec_in))
    assert torch.equal(dec_only((sp, kp, vp), dec_in), want)
    assert len(captures) == 2
    for prog, inputs in ((uni, uni_in), (dec_only, dec_in)):
        for _ in range(2):
            prog((sp, kp, vp), inputs)
        assert prog.captures == 1 and prog.replays == 2


def test_the_host_copy_guard_catches_a_host_built_section_map(monkeypatch):
    """The guard above sees the pattern it exists for: a section map built
    on the host and copied to the device."""
    with _no_host_copies(monkeypatch):
        with pytest.raises(AssertionError, match="inside a capture"):
            torch.as_tensor(np.repeat(np.arange(3), (4, 6, 6)))
        with pytest.raises(AssertionError, match="inside a captured"):
            torch.tensor([0, 1, 2])


def _jax_fixed(vlm, prompts, samplings, extras, batch_size=2):
    jmodel, jparams, _, _ = vlm
    mesh = _mesh()
    eng = JaxFixedBatchEngine(jmodel, jparams, mesh, DEFAULT_RULES,
                              JaxServeConfig(batch_size=batch_size, max_seq=64,
                                             max_new_tokens=8), extras)
    for p, s in zip(prompts, samplings):
        eng.submit(p, sampling=s)
    with mesh:
        return {r.rid: [int(t) for t in r.output] for r in eng.run()}


def _port_fixed(vlm, prompts, samplings, extras, batch_size=2):
    """ServeEngine with extras (routed to the loop), FixedBatchEngine
    without."""
    _, _, model, params = vlm
    cfg = ServeConfig(batch_size=batch_size, max_seq=64, max_new_tokens=8)
    if extras:
        eng = ServeEngine(model, params, cfg, extras=extras, device="cpu")
        assert isinstance(eng._engine, FixedBatchEngine)
    else:
        eng = FixedBatchEngine(model, params, cfg, device="cpu")
    for p, s in zip(prompts, samplings):
        eng.submit(p, sampling=s)
    return {r.rid: [int(t) for t in r.output] for r in eng.run()}


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "mixed"])
def test_fixed_batch_with_vision_equals_the_jax_engine(vlm, sampled):
    _, _, model, _ = vlm
    prompts = _prompts((12, 9, 14), seed=2)
    extras = {"vision_embeds": _vision(model.cfg)}
    got = _port_fixed(vlm, prompts, [_mix(i + 1, SamplingParams) if sampled
                                     else SamplingParams() for i in range(3)], extras)
    want = _jax_fixed(vlm, prompts, [_mix(i + 1, JaxSamplingParams) if sampled
                                     else JaxSamplingParams() for i in range(3)], extras)
    assert got == want
    text = _port_fixed(vlm, prompts, [SamplingParams()] * 3, None)
    assert sampled or text != got                 # the images change the streams


def test_a_batch_shorter_than_the_vision_span_follows_the_reference(vlm):
    """Prompts of 5 and 3 tokens under 8 vision embeddings: the reference's
    concatenation makes the sequence 8 rows long (every token replaced),
    and the port's does the same."""
    _, _, model, _ = vlm
    prompts = _prompts((5, 3), seed=3)
    extras = {"vision_embeds": _vision(model.cfg)}
    got = _port_fixed(vlm, prompts, [SamplingParams()] * 2, extras)
    assert got == _jax_fixed(vlm, prompts, [JaxSamplingParams()] * 2, extras)
    assert got[1] == got[2]
