"""The implicit-GEMM conv and the split-KV dense decode of the port, on the CPU.

`csrc/conv2d.cu` and `csrc/dense_decode.cu` run only on the card; what the
CPU can hold is their launch geometry — a function of host integers alone,
checked here against the C sources' constants and the schedule template —
and their arithmetic, emulated in plain torch step for step (3xTF32
products; per-split partials combined in split order) and held against the
plain versions and, through them, the JAX package's Pallas kernels in
interpret mode.
"""

import dataclasses
import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch import hw
from repro_torch.core.schedules import TEMPLATES, OpDesc
from repro_torch.kernels import attention as KA
from repro_torch.kernels import build
from repro_torch.kernels import conv2d as KC
from repro_torch.kernels import ops, ref
from repro_torch.models.resnet import conv_groups
from test_torch_gemm_decode import split_decode_emulation

F32_TOL = dict(rtol=2e-5, atol=2e-5)
CONV_RTOL_F32 = 5e-5          # chip_smoke.py's f32 conv tolerance


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _cuda_source(name):
    return (build.CSRC / name).read_text()


# ------------------------------------------------------ dense decode geometry
def test_dense_decode_split_count_is_a_function_of_s_alone():
    assert list(inspect.signature(KA.dense_decode_splits).parameters) == ["s"]
    assert KA.dense_decode_splits(1024) == (8, 128)      # the decode stage's S
    assert KA.dense_decode_splits(256) == (2, 128)
    assert KA.dense_decode_splits(100) == (1, 128)


@pytest.mark.parametrize("s", [1, 7, 127, 128, 129, 256, 700, 1024, 4097, 10 ** 7])
def test_dense_decode_splits_cover_s_in_whole_chunks(s):
    nsplit, kps = KA.dense_decode_splits(s)
    assert kps % KA.DECODE_SPLIT_KEYS == 0
    assert (nsplit - 1) * kps < s <= nsplit * kps
    assert 1 <= nsplit <= KA.MAX_GRID_Z
    # the largest number of splits a grid's z dimension holds, no fewer
    assert nsplit * 2 > KA.MAX_GRID_Z or kps == KA.DECODE_SPLIT_KEYS


def test_dense_decode_constants_mirror_the_cuda_source():
    src = _cuda_source("dense_decode.cu")
    assert '#include "split_decode.cuh"' in src and "split::DenseRows" in src
    assert "paged::Tile" not in src
    # the launcher checks the split geometry the wrapper passes
    assert "nsplit != (s + kps - 1) / kps" in src
    assert f"n_heads / hkv > {KA.DECODE_MAX_GROUP}" in src
    sig = re.search(r'extern "C" int dense_decode_attention\((.*?)\)', src, re.S).group(1)
    assert len(sig.split(",")) == len(build.SIGNATURES["dense_decode"][1]) == 17
    rows = re.search(r"struct DenseRows \{(.*?)\n\};", _cuda_source("split_decode.cuh"),
                     re.S).group(1)
    # no table to read: key t is row t of the sequence's (S, Hkv, D) slab
    assert "return 0;" in rows and "((size_t)t * hkv + h) * (size_t)d" in rows


def _dense_as_pool(k, v):
    """A dense (B, S, Hkv, D) cache as a pool of B·S one-row blocks with
    identity tables."""
    b, s, hkv, d = k.shape
    tables = torch.arange(b * s, dtype=torch.int32).reshape(b, s)
    return k.reshape(b * s, 1, hkv, d), v.reshape(b * s, 1, hkv, d), tables


def _dense_inputs(lengths, s, h=4, hkv=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    b = len(lengths)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    return q, k, v, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("s", [256, 384, 1024])
def test_dense_split_decode_emulation_matches_pallas_interpret(s):
    nsplit, kps = KA.dense_decode_splits(s)
    assert nsplit > 1
    lengths = [0, 1, kps - 1, kps, kps + 1, s]
    q, k, v, ln = _dense_inputs(lengths, s, seed=s)
    want = np.asarray(jops.attention_decode(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), jnp.asarray(ln)))
    kp, vp, tables = _dense_as_pool(_t(k), _t(v))
    got = split_decode_emulation(_t(q), kp, vp, _t(ln), tables, kps,
                                 chunk=KA.split_chunk_keys(16, 4))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    plain = ref.dense_decode_attention_ref(_t(q), _t(k), _t(v), _t(ln))
    np.testing.assert_allclose(plain.numpy(), want, **F32_TOL)
    assert not got[0].any()              # length 0: no key, zeros


@pytest.mark.parametrize("g,d", [(1, 64), (8, 32), (16, 256)])
def test_dense_split_decode_emulation_matches_the_plain_version(g, d):
    s = 512
    nsplit, kps = KA.dense_decode_splits(s)
    # lengths 0, 1, a split edge - 1 / at it / + 1, S, and past S (taken as S)
    lengths = [0, 1, kps - 1, kps, kps + 1, 3 * kps + 1, s, s + 9]
    q, k, v, ln = _dense_inputs(lengths, s, h=2 * g, hkv=2, d=d, seed=g + d)
    kp, vp, tables = _dense_as_pool(_t(k), _t(v))
    got = split_decode_emulation(_t(q), kp, vp, _t(ln), tables, kps,
                                 chunk=KA.split_chunk_keys(d, 4))
    want = ref.dense_decode_attention_ref(_t(q), _t(k), _t(v), _t(ln))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)
    assert not got[0].any()              # length 0: no key, zeros


def test_dense_decode_wrapper_ignores_a_tuned_block_kv_on_the_cpu():
    q, k, v, ln = _dense_inputs([5, 300], 384)
    base = ops.attention_decode(_t(q), _t(k), _t(v), _t(ln))
    for cfg in ({"block_kv": 16}, {"block_kv": 2048}, None):
        assert torch.equal(ops.attention_decode(_t(q), _t(k), _t(v), _t(ln), config=cfg),
                           base)


# ------------------------------------------------------------- 3xTF32
def tf32(a: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 explicit mantissa bits, ties away from zero:
    `cvt.rna.tf32.f32`)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_product(x: torch.Tensor, w: torch.Tensor, terms: int) -> torch.Tensor:
    """x @ w on TF32 tensor cores with f32 sums: one term (hi·hi) or the
    3xTF32 split (lo·hi + hi·lo + hi·hi; each product of two TF32 values
    is exact in f32)."""
    xh, wh = tf32(x), tf32(w)
    if terms == 1:
        return xh @ wh
    xl, wl = tf32(x - xh), tf32(w - wh)
    return xl @ wh + xh @ wl + xh @ wh


# (M, K, N) of ResNet-18's K extremes at batch 1: the stem (7x7x3), the
# first stage (3x3x64) and the last (3x3x512)
RESNET_K = [(12544, 147, 64), (3136, 576, 64), (49, 4608, 512)]


@pytest.mark.parametrize("m,k,n", RESNET_K)
def test_3xtf32_meets_the_f32_conv_tolerance_where_one_tf32_product_misses(m, k, n):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    exact = torch.from_numpy(x.astype(np.float64) @ w.astype(np.float64))
    scale = max(1.0, exact.abs().max().item())
    err = {t: (tf32_product(_t(x), _t(w), t).double() - exact).abs().max().item() / scale
           for t in (1, 3)}
    assert err[1] > CONV_RTOL_F32            # why the kernel splits its operands
    assert err[3] < CONV_RTOL_F32 / 20
    f32 = (_t(x) @ _t(w)).double()
    assert err[3] < 4 * (f32 - exact).abs().max().item() / scale + 1e-7


def test_tf32_rounding_keeps_ten_mantissa_bits():
    a = torch.tensor([1.0, 1 + 2.0 ** -10, 1 + 2.0 ** -11, 1 + 3 * 2.0 ** -12, -(1 + 2.0 ** -11)])
    assert tf32(a).tolist() == [1.0, 1 + 2.0 ** -10, 1 + 2.0 ** -10, 1 + 2.0 ** -10,
                                -(1 + 2.0 ** -10)]
    x = torch.randn(1000)
    hi = tf32(x)
    lo = tf32(x - hi)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((x - hi).abs() <= x.abs() * 2.0 ** -11).all()
    assert ((x - hi - lo).abs() <= x.abs() * 2.0 ** -21).all()


# ------------------------------------------------------------ split-K conv
def conv_split_k_emulation(x, w, bias, stride, padding, activation, geo):
    """`conv2d.cu` in plain torch: the implicit GEMM's A (output pixels x
    (tap, channel)) gathered with SAME zeros, f32 partials over the
    splits' k-step ranges (K padded to whole steps of BK), summed in split
    order, then bias, activation and one rounding."""
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    xf = x.float()
    if padding == "SAME":
        (pt, pb), (pl, pr) = ref.same_pads(h, kh, stride), ref.same_pads(wd, kw, stride)
        xf = torch.nn.functional.pad(xf, (0, 0, pl, pr, pt, pb))
    cols = [xf[:, dh:dh + (geo.oh - 1) * stride + 1:stride,
               dw:dw + (geo.ow - 1) * stride + 1:stride, :]
            for dh in range(kh) for dw in range(kw)]
    a = torch.cat(cols, dim=-1).reshape(n * geo.oh * geo.ow, kh * kw * cin)
    k = a.shape[1]
    a = torch.nn.functional.pad(a, (0, geo.steps * KC.BK - k))
    b = torch.nn.functional.pad(w.float().reshape(k, cout), (0, 0, 0, geo.steps * KC.BK - k))
    sps = -(-geo.steps // geo.split) * KC.BK
    acc = torch.zeros((a.shape[0], cout))
    for s in range(geo.split):                                  # split order
        acc = acc + a[:, s * sps:(s + 1) * sps] @ b[s * sps:(s + 1) * sps]
    if bias is not None:
        acc = acc + bias.float()
    out = ref.apply_activation(acc, activation).to(x.dtype)
    return out.reshape(n, geo.oh, geo.ow, cout)


# (n, h, cin, cout, k, stride): each splits K at some (bn, row_block);
# Cout 40 is ragged against every bn
SPLIT_CONVS = [(1, 7, 128, 64, 3, 1), (1, 14, 64, 32, 3, 2), (2, 6, 96, 40, 3, 1),
               (1, 9, 256, 128, 1, 1)]


@pytest.mark.parametrize("n,h,cin,cout,k,stride", SPLIT_CONVS)
def test_conv_split_k_emulation_matches_ref_and_pallas_interpret(n, h, cin, cout, k, stride):
    rng = np.random.default_rng(cin + cout)
    x = (rng.standard_normal((n, h, h, cin)) * 0.3).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32)
    b = (rng.standard_normal((cout,)) * 0.1).astype(np.float32)
    want = ref.conv2d_ref(_t(x), _t(w), _t(b), stride, "SAME", "relu")
    pallas = np.asarray(jops.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                    stride=stride, padding="SAME", layout="NHWC",
                                    activation="relu"))
    np.testing.assert_allclose(want.numpy(), pallas, rtol=1e-4, atol=1e-4)
    split = 0
    for bn in KC.BN_CHOICES:
        for rb in KC.ROW_BLOCKS:
            geo = KC.geometry(n, h, h, cin, cout, k, k, stride, "SAME", bn, rb)
            if geo is None or geo.split < 2:
                continue
            got = conv_split_k_emulation(_t(x), _t(w), _t(b), stride, "SAME", "relu", geo)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-4, atol=1e-4)
            split = max(split, geo.split)
    assert split > 1


def test_conv_split_k_applies_the_epilogue_after_the_sum():
    rng = np.random.default_rng(5)
    x = _t(rng.standard_normal((1, 7, 7, 128)).astype(np.float32))
    w = _t((rng.standard_normal((3, 3, 128, 64)) / 34).astype(np.float32))
    b = _t((rng.standard_normal((64,)) * 0.1).astype(np.float32))
    geo = KC.geometry(1, 7, 7, 128, 64, 3, 3, 1, "SAME", 64, 8)
    assert geo.split > 1
    want = ref.conv2d_ref(x, w, b, 1, "SAME", "gelu")
    got = conv_split_k_emulation(x, w, b, 1, "SAME", "gelu", geo)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    one = dataclasses.replace(geo, split=1)
    np.testing.assert_allclose(conv_split_k_emulation(x, w, b, 1, "SAME", "gelu", one).numpy(),
                               want.numpy(), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ conv geometry
def _resnet_ops(dtype="float32"):
    return [(name, OpDesc.make("conv2d", op.d, dtype)) for name, op in conv_groups(1, 224)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_geometry_launches_every_resnet18_conv_group_with_a_shape_split(dtype):
    assert list(inspect.signature(KC.split_count).parameters) == ["tiles", "steps", "sms"]
    itemsize = hw.itemsize(dtype)
    for name, op in _resnet_ops(dtype):
        d = op.d
        best = 0
        for bn in KC.BN_CHOICES:
            for rb in KC.ROW_BLOCKS:
                geo = KC.geometry(d["n"], d["h"], d["w"], d["cin"], d["cout"], d["kh"],
                                  d["kw"], d["stride"], "SAME", bn, rb, itemsize=itemsize)
                if geo is None:
                    continue
                tiles = geo.tiles_m * geo.tiles_n
                assert geo.steps == -(-d["kh"] * d["kw"] * d["cin"] // KC.BK)
                # the shape decides the split: whole k-steps, none empty
                assert geo.split == KC.split_count(tiles, geo.steps)
                sps = -(-geo.steps // geo.split)
                assert (geo.split - 1) * sps < geo.steps <= geo.split * sps
                assert 1 <= geo.split <= KC.MAX_SPLIT
                if tiles >= hw.H100.sms:
                    assert geo.split == 1
                else:
                    assert tiles * geo.split <= KC.SPLIT_WAVES * hw.H100.sms
                    assert geo.split == 1 or sps >= KC.MIN_SPLIT_STEPS
                best = max(best, tiles * geo.split)
        # every group but the 1x1 downsamples (K = 64 / 128 / 256) can fill
        # the card's 132 SMs at batch 1
        assert best >= hw.H100.sms or d["kh"] == 1, (name, best)
    # the default configuration launches every group
    for name, op in _resnet_ops(dtype):
        d = op.d
        cfg = KC.default_config(d["n"], d["h"], d["w"], d["cin"], d["cout"], d["kh"],
                                d["kw"], d["stride"], "SAME")
        assert KC.geometry(d["n"], d["h"], d["w"], d["cin"], d["cout"], d["kh"], d["kw"],
                           d["stride"], "SAME", itemsize=itemsize, **cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_template_space_is_exactly_what_geometry_accepts(dtype):
    tmpl = TEMPLATES["pallas_conv2d"]
    for name, op in _resnet_ops(dtype) + [("tiny", OpDesc.make("conv2d", dict(
            n=2, h=5, w=5, cin=3, cout=8, kh=3, kw=3, stride=1, pad=1), dtype))]:
        d = op.d
        space = tmpl.space(op)
        assert space["row_block"] == list(KC.ROW_BLOCKS)
        assert space["bn"] == [b for b in KC.BN_CHOICES if b <= max(16, 2 * d["cout"])]
        accepted = {(bn, rb) for bn in space["bn"] for rb in space["row_block"]
                    if KC.geometry(d["n"], d["h"], d["w"], d["cin"], d["cout"], d["kh"],
                                   d["kw"], d["stride"], "SAME", bn, rb,
                                   itemsize=hw.itemsize(dtype)) is not None}
        assert {(c["bn"], c["row_block"]) for c in tmpl.enumerate_configs(op)} == accepted
        assert accepted, name


def test_wide_rows_take_128_pixel_tiles_at_row_block_1():
    # a 224-pixel output row is cut into 128-pixel ranges of M
    geo = KC.geometry(1, 224, 224, 64, 64, 3, 3, 1, "SAME", 64, 1)
    assert (geo.bm, geo.rows, geo.tiles_m) == (128, 128, 224 * 224 // 128)
    assert KC.geometry(1, 224, 224, 64, 64, 3, 3, 1, "SAME", 64, 2) is None


def test_conv_tiles_mirror_the_cuda_source():
    src = _cuda_source("conv2d.cu")
    macro = re.search(r"#define CONV_TILES\(X\)(.*?)\n\n", src, re.S).group(1)
    tiles = tuple((int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", macro))
    assert tiles == KC.CONV_TILES
    val = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert (val("THREADS"), val("BK"), val("STAGES")) == (KC.THREADS, KC.BK, KC.STAGES)
    for bm, bn in tiles:
        wn = min(4, bn // 16)
        wm = 4 // wn
        # four warps, each owning whole 16 x 16 fragment pairs
        assert bm in KC.BM_CHOICES and bn in KC.BN_CHOICES
        assert (bm // wm) % 16 == 0 and (bn // wn) % 16 == 0
        for itemsize in (2, 4):
            assert KC.tile_smem_bytes(bm, bn, itemsize) <= hw.H100.smem_per_block
    sig = re.search(r'extern "C" int conv2d_direct\((.*?)\)', src, re.S).group(1)
    assert len(sig.split(",")) == len(build.SIGNATURES["conv2d"][1]) == 25
    # the f32 instances run 3xTF32 on the tensor cores, the bf16 ones mma.sync
    assert "mma1688_tf32" in src and "split_tf32" in src and "mma16816" in src
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in _cuda_source("ptx.cuh")


def test_conv_wrapper_rejects_unknown_knobs_before_the_device():
    x = torch.zeros((1, 8, 8, 64), device="meta")
    w = torch.zeros((3, 3, 64, 64), device="meta")
    with pytest.raises(ValueError, match="outside the kernel's limits"):
        KC.conv2d_direct(x, w, bn=24, row_block=1)
    with pytest.raises(ValueError, match="outside the kernel's limits"):
        KC.conv2d_direct(x, w, bn=64, row_block=3)
    with pytest.raises(ValueError, match="GPU"):
        KC.conv2d_direct(x, w, bn=64, row_block=1)
