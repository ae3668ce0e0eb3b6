"""The split GEMM and the split-KV paged decode of the port, on the CPU.

`csrc/matmul.cu` (split-K) and `csrc/split_decode.cuh` (split-KV) run only
on the card; what the CPU can hold is their launch geometry — a function
of host integers alone, checked here against the C sources' constants —
and their arithmetic, emulated in plain torch step for step (per-split
partials, combined in split order) and held against the plain versions
and, through them, the JAX package's Pallas kernels in interpret mode.
"""

import inspect
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch import hw
from repro_torch.configs import get_config
from repro_torch.kernels import attention as KA
from repro_torch.kernels import build
from repro_torch.kernels import matmul as KM
from repro_torch.kernels import ref

F32_TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _serving_shapes():
    """(role, K, N) of qwen3-1.7b's serving GEMMs."""
    cfg = get_config("qwen3-1.7b")
    d, hd = cfg.d_model, cfg.hd
    return [("wq", d, cfg.n_heads * hd), ("wk/wv", d, cfg.n_kv_heads * hd),
            ("w_in/w_gate", d, cfg.d_ff), ("w_out", cfg.d_ff, d),
            ("lm_head", d, cfg.vocab)]


# ------------------------------------------------------------ GEMM geometry
def _ssm_shapes():
    """(role, K, N) of mamba2-2.7b's serving GEMMs: N 10,576 (82.6 tiles of
    128) and 50,280 (392.8 tiles, not a multiple of 16) are ragged."""
    cfg = get_config("mamba2-2.7b")
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    return [("in_proj", d, 2 * d_in + 2 * cfg.ssm_state + d_in // cfg.ssm_head_dim),
            ("out_proj", d_in, d), ("lm_head", d, cfg.vocab)]


GEOMETRY_SHAPES = [(m, k, n) for m in (1, 4, 8, 16, 17, 64, 255, 256, 700)
                   for _, k, n in _serving_shapes() + _ssm_shapes()] + \
    [(37, 70, 53), (8, 2056, 1000), (255, 2000, 1000), (8, 6144, 2047),
     (1, 1000, 260), (255, 6200, 1020), (3, 4096, 50), (1, 512, 1000)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("m,k,n", GEOMETRY_SHAPES)
def test_gemm_geometry_splits_k_into_whole_steps_within_the_weight_bytes(m, k, n, dtype):
    geo = KM.gemm_geometry(m, n, k, dtype)
    steps = -(-k // geo.bk)
    sps = geo.steps_per_split(k)
    # whole k-steps, none empty, covering K exactly
    assert 1 <= geo.split <= steps
    assert (geo.split - 1) * sps < steps <= geo.split * sps
    ranges = [(s * sps * geo.bk, min(k, (s + 1) * sps * geo.bk)) for s in range(geo.split)]
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a < b and (a % geo.bk) == 0 for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(geo.split - 1))
    # the f32 partials take no more than the weights
    if geo.split > 1:
        assert geo.split * m * n * 4 <= k * n * dtype.itemsize
    # a split only where the tile grid alone leaves SMs idle, and never a
    # grid past two CTAs per SM because of it
    tiles = geo.ctas(m, n) // geo.split
    if tiles >= hw.H100.sms:
        assert geo.split == 1
    else:
        assert geo.ctas(m, n) <= KM.SPLIT_WAVES * hw.H100.sms
    # the shape decides, nothing else: the same call gives the same answer
    assert KM.gemm_geometry(m, n, k, dtype) == geo


@pytest.mark.parametrize("m", [1, 2, 4, 8, 256, 700])
def test_lm_head_never_splits(m):
    _, k, n = _serving_shapes()[-1]
    assert KM.gemm_geometry(m, n, k, torch.bfloat16).split == 1


@pytest.mark.parametrize("role,k,n", _serving_shapes())
def test_every_decode_step_gemm_fills_the_card(role, k, n):
    geo = KM.gemm_geometry(8, n, k, torch.bfloat16)
    assert geo.bm == 16
    assert geo.ctas(8, n) >= hw.H100.sms
    if role != "lm_head":
        assert geo.split > 1


def _cuda_source(name):
    return (build.CSRC / name).read_text()


def test_gemm_tiles_mirror_the_cuda_source():
    src = _cuda_source("matmul.cu")
    tiles = [tuple(int(v) for v in t) for t in re.findall(
        r"^\s*X\((\d+), (\d+), (\d+), (\d+), (\d+), (\d+)\)", src, re.M)]
    assert len(tiles) == len(KM.GEMM_TILES)
    assert {t[0]: t[:4] for t in tiles} == KM.GEMM_TILES
    for bm, bn, bk, stages, wm, wn in tiles:
        threads = wm * wn * 32
        assert threads in (128, 256)
        assert (bn // wn) % 16 == 0 and (bm // wm) % 16 == 0
        # every thread copies whole 16-byte pieces of both tiles each k-step
        assert (bm * bk // 8) % threads == 0 and (bk * bn // 8) % threads == 0
        # the ring fits a CTA, two of them an SM's 228 KB
        ring = stages * (bm * (bk + 8) + bk * (bn + 8)) * 2
        assert 2 * (ring + 1024) <= 228 * 1024
    f32 = re.search(r"constexpr int F_BM = (\d+), F_BN = (\d+), F_BK = (\d+)", src)
    assert tuple(int(v) for v in f32.groups()) + (1,) == KM.GEMM_TILE_F32
    assert {g.bm for g in (KM.gemm_geometry(m, n, k, torch.bfloat16)
                           for m, k, n in GEOMETRY_SHAPES)} <= set(KM.GEMM_TILES)


def test_the_c_launchers_take_the_geometry_the_wrappers_pass():
    # matmul_fused(x, w, bias, out, M, N, K, act, dtype, bm, bn, bk, stages,
    # split, ws, counters, stream)
    sig = re.search(r'extern "C" int matmul_fused\((.*?)\)', _cuda_source("matmul.cu"),
                    re.S).group(1)
    assert len(sig.split(",")) == len(build.SIGNATURES["matmul"][1]) == 17
    sig = re.search(r'extern "C" int paged_decode_attention\((.*?)\)',
                    _cuda_source("paged_decode.cu"), re.S).group(1)
    assert len(sig.split(",")) == len(build.SIGNATURES["paged_decode"][1]) == 19
    for h in ("ptx.cuh", "split_decode.cuh"):
        assert h in build.HEADERS


# --------------------------------------------------------- decode geometry
def test_split_counters_are_not_allocated_inside_a_graph_capture(monkeypatch):
    # zeroing a new counter buffer inside a capture would only be recorded,
    # leaving eager launches after it with counters that were never zeroed
    monkeypatch.setattr(build, "_counters", {})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="before a CUDA graph capture"):
        build.counters("matmul", torch.device("cuda", 0), 64)


def test_decode_split_count_is_a_function_of_the_table_shape_alone():
    assert list(inspect.signature(KA.decode_splits).parameters) == ["nbt", "block_size"]
    assert KA.decode_splits(64, 16) == (8, 128)       # the serving tables
    assert KA.decode_splits(1, 16) == (1, 128)


@pytest.mark.parametrize("nbt", [1, 2, 4, 7, 8, 9, 40, 64, 65, 4096])
@pytest.mark.parametrize("bs", [1, 8, 16, 24, 32, 48, 128, 256])
def test_decode_splits_cover_the_table_in_whole_blocks(nbt, bs):
    nsplit, kps = KA.decode_splits(nbt, bs)
    assert kps % bs == 0 and kps >= KA.DECODE_SPLIT_KEYS
    assert kps < KA.DECODE_SPLIT_KEYS + bs or kps == bs
    assert (nsplit - 1) * kps < nbt * bs <= nsplit * kps
    assert 1 <= nsplit <= KA.MAX_GRID_Z


def test_split_decode_constants_mirror_the_cuda_source():
    src = _cuda_source("split_decode.cuh")
    val = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert val("STAGE_BYTES") == KA.SPLIT_STAGE_BYTES
    assert val("MAX_CHUNK") == KA.SPLIT_MAX_CHUNK
    assert val("THREADS") == KA.THREADS
    # the serving shape: 64-key chunks (four 16-row blocks), 32 KB of K+V a
    # stage; every instance fits a CTA, at least three a Hopper SM
    assert KA.split_chunk_keys(128, 2) == 64
    for g in (1, 2, 3, 4, 8, 16):
        for d in (8, 16, 64, 128, 136, 256):
            for itemsize in (2, 4):
                smem = KA.split_decode_smem_bytes(g, d, itemsize)
                assert smem <= hw.H100.smem_per_block
                if itemsize == 2 and d <= 128 and g <= 2:
                    assert 3 * (smem + 1024) <= 228 * 1024


# ------------------------------------------- plain emulation of split-KV
def split_decode_emulation(q, k_pool, v_pool, lengths, tables, kps, chunk, scale=None):
    """`split_decode.cuh` in plain torch: per (slot, split), an online
    softmax over chunks of `chunk` keys (probabilities rounded to the value
    dtype before P·V), giving (m, l, acc); then the splits combined in
    split order, each weighted by exp(m_s - m), empty ones (l = 0) skipped,
    one division by the combined l (0 -> zeros)."""
    b, h, d = q.shape
    bs, hkv = k_pool.shape[1], k_pool.shape[2]
    nbt = tables.shape[1]
    g = h // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    nsplit = -(-nbt * bs // kps)
    out = torch.zeros((b, h, d), dtype=torch.float32)
    for bi in range(b):
        length = min(int(lengths[bi]), nbt * bs)
        rows = tables[bi].long()[torch.arange(length) // bs] * bs + torch.arange(length) % bs
        kk = k_pool.reshape(-1, hkv, d)[rows].float()          # (len, Hkv, D)
        vv = v_pool.reshape(-1, hkv, d)[rows]
        qq = q[bi].float().reshape(hkv, g, d)
        parts = []
        for s in range(nsplit):
            m = torch.full((hkv, g), ref.NEG_INF)
            l = torch.zeros((hkv, g))
            acc = torch.zeros((hkv, g, d))
            lo, hi = s * kps, min(length, (s + 1) * kps)
            for t0 in range(lo, hi, chunk):
                t1 = min(hi, t0 + chunk)
                sc = torch.einsum("hgd,thd->hgt", qq, kk[t0:t1]) * scale
                m_new = torch.maximum(m, sc.max(-1).values)
                p = torch.exp(sc - m_new[..., None])
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(-1)
                p = p.to(vv.dtype).float()
                acc = acc * alpha[..., None] + torch.einsum("hgt,thd->hgd", p,
                                                            vv[t0:t1].float())
                m = m_new
            parts.append((m, l, acc))
        m_all = torch.full((hkv, g), ref.NEG_INF)
        for m, l, _ in parts:
            m_all = torch.where(l > 0, torch.maximum(m_all, m), m_all)
        l_all = torch.zeros((hkv, g))
        o = torch.zeros((hkv, g, d))
        for m, l, acc in parts:                                  # split order
            w = torch.where(l > 0, torch.exp(m - m_all), torch.zeros_like(m))
            l_all = l_all + l * w
            o = o + acc * w[..., None]
        o = o / torch.where(l_all == 0, torch.ones_like(l_all), l_all)[..., None]
        out[bi] = o.reshape(h, d)
    return out.to(q.dtype)


def _decode_inputs():
    # the inputs of test_torch_kernels.py::test_paged_decode_plain_matches_pallas_interpret
    # (tests/test_serving_runtime.py::test_paged_pallas_matches_xla_gather's shapes)
    rng = np.random.default_rng(0)
    b, h, hkv, d, bs, nbt, nb = 3, 4, 2, 16, 8, 4, 16
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    tables = rng.permutation(np.arange(1, nb))[: b * nbt].reshape(b, nbt).astype(np.int32)
    lengths = np.asarray([5, 19, 32], np.int32)
    return q, kp, vp, lengths, tables


@pytest.mark.parametrize("kps,chunk", [(8, 8), (16, 8), (24, 16), (32, 64),
                                       (128, 64)])
def test_split_decode_emulation_matches_pallas_interpret(kps, chunk):
    q, kp, vp, lengths, tables = _decode_inputs()
    want = np.asarray(jops.attention_decode_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(lengths),
        jnp.asarray(tables)))
    got = split_decode_emulation(_t(q), _t(kp), _t(vp), _t(lengths), _t(tables),
                                 kps, chunk)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def _split_edge_case(nbt, bs, lengths, seed=0, g=2, d=16, hkv=2):
    rng = np.random.default_rng(seed)
    b = len(lengths)
    nb = b * nbt + 1
    q = rng.standard_normal((b, g * hkv, d)).astype(np.float32)
    kp = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    tables = (rng.permutation(np.arange(1, nb))[: b * nbt] + 0).reshape(b, nbt)
    return (_t(q), _t(kp), _t(vp), torch.tensor(lengths, dtype=torch.int32),
            torch.tensor(tables.astype(np.int32)))


# block_size 8, kps 32 (4 blocks): lengths 0, 1, 16, 17, one block short of
# a split edge (24), at one (32), one past (33), two edges (64) and full
# (nbt * bs), with every split count from 1 to the table's (incl. all-empty
# splits past short lengths)
@pytest.mark.parametrize("nbt,kps", [(4, 32), (8, 32), (8, 16), (8, 64), (16, 32),
                                     (1, 8)])
def test_split_decode_emulation_matches_the_plain_version(nbt, kps):
    bs = 8
    full = nbt * bs
    lengths = sorted({min(full, x) for x in (0, 1, 16, 17, 24, 32, 33, 64)} | {full})
    q, kp, vp, ln, tables = _split_edge_case(nbt, bs, lengths, seed=nbt + kps)
    got = split_decode_emulation(q, kp, vp, ln, tables, kps, chunk=16)
    want = ref.paged_decode_attention_ref(q, kp, vp, ln, tables)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)
    assert not got[0].any()              # length 0: no key, zeros


@pytest.mark.parametrize("nbt,bs", [(64, 16), (40, 16), (3, 32), (5, 8)])
def test_split_decode_emulation_at_the_geometry_the_wrapper_picks(nbt, bs):
    nsplit, kps = KA.decode_splits(nbt, bs)
    full = nbt * bs
    lengths = [0, 1, 17, min(full, kps - bs), min(full, kps), min(full, kps + 1), full]
    q, kp, vp, ln, tables = _split_edge_case(nbt, bs, lengths, seed=nbt, g=2, d=32)
    got = split_decode_emulation(q, kp, vp, ln, tables, kps,
                                 chunk=KA.split_chunk_keys(32, 4))
    want = ref.paged_decode_attention_ref(q, kp, vp, ln, tables)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)


def test_split_decode_emulation_rounds_p_like_the_plain_version_in_bf16():
    q, kp, vp, ln, tables = _split_edge_case(8, 8, [5, 33, 64], seed=3, d=32)
    q, kp, vp = q.bfloat16(), kp.bfloat16(), vp.bfloat16()
    got = split_decode_emulation(q, kp, vp, ln, tables, 32, chunk=16)
    exact = ref.paged_decode_attention_ref(q.float(), kp.float(), vp.float(), ln, tables)
    # p and the output rounded to bf16 (2^-9 relative each)
    np.testing.assert_allclose(got.float().numpy(), exact.numpy(), atol=2e-2, rtol=0)


# ---------------------------------------------- plain emulation of split-K
def split_k_emulation(x, w, bias, activation, geo, per_partial=False):
    """`matmul.cu`'s split-K in plain torch: f32 partials over the splits'
    K ranges (whole k-steps), summed in split order, then bias, activation
    and one rounding — or, with `per_partial`, the activation applied to
    each partial before the sum (what the kernel must never do)."""
    k = x.shape[1]
    sps = geo.steps_per_split(k) * geo.bk
    parts = [x[:, s * sps:(s + 1) * sps].float() @ w[s * sps:(s + 1) * sps].float()
             for s in range(geo.split)]
    if per_partial:
        parts = [ref.apply_activation(p + (bias.float() if bias is not None else 0), activation)
                 for p in parts]
        return sum(parts[1:], parts[0]).to(x.dtype)
    acc = torch.zeros_like(parts[0])
    for p in parts:                      # split order
        acc = acc + p
    if bias is not None:
        acc = acc + bias.float()
    return ref.apply_activation(acc, activation).to(x.dtype)


@pytest.mark.parametrize("activation", ["silu", "gelu"])
@pytest.mark.parametrize("m,k,n", [(8, 2056, 100), (17, 640, 96), (255, 2000, 40),
                                   (1, 1000, 260), (8, 1024, 64)])
def test_split_k_emulation_applies_the_epilogue_once(m, k, n, activation):
    rng = np.random.default_rng(m + k + n)
    x = _t(rng.standard_normal((m, k)).astype(np.float32))
    w = _t((rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32))
    b = _t(rng.standard_normal((n,)).astype(np.float32))
    geo = KM.gemm_geometry(m, n, k, torch.bfloat16)
    assert geo.split > 1
    want = ref.matmul_ref(x, w, b, activation)
    got = split_k_emulation(x, w, b, activation, geo)
    scale = max(1.0, want.abs().max().item())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5 * scale)
    # an activation applied per partial is another function
    wrong = split_k_emulation(x, w, b, activation, geo, per_partial=True)
    assert (wrong - want).abs().max().item() > 1e-2 * scale


# ----------------------------------------- the ssm serving shapes (ragged N)
def test_ssm_gemm_geometry_at_the_serving_shapes():
    """mamba2-2.7b's GEMMs on the H100: at M = 8, in_proj splits K 3 ways
    over 83 column tiles and out_proj 12 ways over 20; lm_head (393 tiles)
    never splits; the chunk lane's M = 256 takes 64-row tiles."""
    (_, ki, ni), (_, ko, no), (_, kl, nl) = _ssm_shapes()
    assert (ni, no, nl) == (10576, 2560, 50280)
    bf16 = torch.bfloat16
    assert KM.gemm_geometry(8, ni, ki, bf16) == KM.GemmGeometry(16, 128, 64, 4, 3)
    assert KM.gemm_geometry(8, no, ko, bf16) == KM.GemmGeometry(16, 128, 64, 4, 12)
    for m in (1, 8):
        assert KM.gemm_geometry(m, nl, kl, bf16).split == 1
        assert KM.gemm_geometry(m, nl, kl, bf16).ctas(m, nl) == 393
    assert KM.gemm_geometry(256, ni, ki, bf16) == KM.GemmGeometry(64, 128, 64, 4, 1)
    assert KM.gemm_geometry(256, no, ko, bf16) == KM.GemmGeometry(64, 128, 64, 4, 3)


# K cut to a few k-steps a split (CPU time), N as served
SSM_CUT_K = {"in_proj": 640, "out_proj": 1280, "lm_head": 128}


@pytest.mark.parametrize("m", [1, 8, 256])
@pytest.mark.parametrize("role,n", [(r, n) for r, _, n in _ssm_shapes()])
def test_split_k_emulation_at_the_ssm_shapes_matches_ref_and_pallas(role, n, m):
    """The split-K emulation with the geometry `gemm_geometry` picks at each
    ssm N (K cut), against the plain version and the Pallas kernel in
    interpret mode."""
    k = SSM_CUT_K[role]
    geo = KM.gemm_geometry(m, n, k, torch.bfloat16)
    rng = np.random.default_rng(m + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    want = ref.matmul_ref(_t(x), _t(w), None, None)
    got = split_k_emulation(_t(x), _t(w), None, None, geo)
    scale = max(1.0, want.abs().max().item())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5 * scale)
    pallas = np.asarray(jops.matmul(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=1e-5 * scale)
    if m == 8 and role != "lm_head":
        assert geo.split > 1                      # split-K over ragged tiles
