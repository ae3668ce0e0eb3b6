"""The port's kernels on the CPU, held against the JAX package.

On a CPU tensor every wrapper of `repro_torch.kernels` runs its kernel's
plain PyTorch version; these tests hold those against the JAX package's
Pallas kernels (interpret mode) and gather references on the same
numpy-seeded inputs, at the JAX tests' own shapes and tolerances.  The CUDA
kernels themselves are held against the same plain versions on the card by
`chip_smoke.py`.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.attention import packed_row_map as jax_packed_row_map
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.attention import prefill_block_q
from repro_torch.kernels.dispatch import dispatch_dense, matmul_dispatch

TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------- decode
def _decode_inputs():
    # the shapes of tests/test_serving_runtime.py::test_paged_pallas_matches_xla_gather
    rng = np.random.default_rng(0)
    b, h, hkv, d, bs, nbt, nb = 3, 4, 2, 16, 8, 4, 16
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    tables = rng.permutation(np.arange(1, nb))[: b * nbt].reshape(b, nbt).astype(np.int32)
    lengths = np.asarray([5, 19, 32], np.int32)
    return q, kp, vp, lengths, tables


def _numpy_gather_decode(q, kp, vp, lengths, tables):
    b, h, d = q.shape
    bs, hkv = kp.shape[1], kp.shape[2]
    nbt = tables.shape[1]
    k_ctx = kp[tables].reshape(b, nbt * bs, hkv, d)
    v_ctx = vp[tables].reshape(b, nbt * bs, hkv, d)
    qn = q.reshape(b, hkv, h // hkv, d)
    s = np.einsum("bhgd,bkhd->bhgk", qn, k_ctx) / np.sqrt(d)
    pos = np.arange(nbt * bs)[None, None, None]
    s = np.where(pos < lengths[:, None, None, None], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    return np.einsum("bhgk,bkhd->bhgd", p, v_ctx).reshape(b, h, d)


def test_paged_decode_plain_matches_pallas_interpret():
    q, kp, vp, lengths, tables = _decode_inputs()
    # the JAX tests' lengths, then a row of length 0 (no key: zeros)
    for lens in (lengths, np.asarray([0, 19, 32], np.int32)):
        want = np.asarray(jops.attention_decode_paged(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(lens),
            jnp.asarray(tables)))
        got = ops.attention_decode_paged(_t(q), _t(kp), _t(vp), _t(lens), _t(tables))
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got[0].any()


def test_paged_decode_plain_matches_gather_reference():
    q, kp, vp, lengths, tables = _decode_inputs()
    got = ref.paged_decode_attention_ref(_t(q), _t(kp), _t(vp), _t(lengths),
                                         _t(tables))
    np.testing.assert_allclose(got.numpy(),
                               _numpy_gather_decode(q, kp, vp, lengths, tables),
                               **TOL)


# --------------------------------------------------------------- prefill
@pytest.mark.parametrize("seg_lens,kv_starts,block_q", [
    ((5, 9), (7, 0), None),          # 2 segments, one resuming mid-prompt
    ((3, 4, 2), (0, 11, 5), 4),      # 3 ragged segments, tiles straddle
    ((6, 1, 8, 3), (2, 0, 9, 0), 8),  # 4 segments incl. a 1-token one
    ((11,), (13,), 4),               # single segment
])
def test_packed_prefill_plain_matches_pallas_interpret(seg_lens, kv_starts,
                                                       block_q):
    # the cases of tests/test_packed_prefill.py
    rng = np.random.default_rng(11)
    h, hkv, d, bs, nbt, nb = 4, 2, 16, 8, 6, 32
    c = sum(seg_lens) + 2                      # two trailing padding rows
    ns = len(seg_lens)
    q = rng.standard_normal((1, c, h, d)).astype(np.float32)
    kp = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    perm = rng.permutation(np.arange(1, nb))
    seg_tables = perm[:ns * nbt].reshape(ns, nbt).astype(np.int32)
    q0s = np.concatenate([[0], np.cumsum(seg_lens)[:-1]])
    seg_info = np.stack([q0s, seg_lens, kv_starts], axis=1).astype(np.int32)
    cfg = {"block_q": block_q} if block_q else None

    want = np.asarray(jops.attention_prefill_packed(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(seg_tables), jnp.asarray(seg_info), config=cfg))[0]
    got = ops.attention_prefill_packed(_t(q), _t(kp), _t(vp), _t(seg_tables),
                                       _t(seg_info), config=cfg)[0].numpy()
    assert np.isfinite(got).all()
    for q0, qn, _ in seg_info:                 # compare real rows only
        np.testing.assert_allclose(got[q0:q0 + qn], want[q0:q0 + qn], **TOL)


def test_packed_row_map_matches_jax():
    seg_info = np.asarray([[0, 3, 7], [3, 2, 0], [5, 0, 0], [5, 0, 0]], np.int32)
    want = [np.asarray(a) for a in jax_packed_row_map(jnp.asarray(seg_info), 8)]
    got = [a.numpy() for a in ref.packed_row_map(_t(seg_info), 8)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_prefill_block_q_caps_the_tile_at_32_query_vectors():
    assert prefill_block_q(None, 256, 2) == 16
    assert prefill_block_q(64, 256, 2) == 16
    assert prefill_block_q(4, 256, 2) == 4
    assert prefill_block_q(None, 5, 2) == 5
    assert prefill_block_q(None, 256, 64) == 1


# ---------------------------------------------------------------- matmul
@pytest.mark.parametrize("shape", [(37, 70, 53), (64, 128, 256)],
                         ids=["ragged", "aligned"])
@pytest.mark.parametrize("activation", [None, "silu", "gelu"])
def test_matmul_plain_matches_pallas_interpret(shape, activation):
    m, k, n = shape
    rng = np.random.default_rng(5)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    b = rng.standard_normal((n,)).astype(np.float32)
    want = np.asarray(jops.matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                  activation=activation))
    got = ops.matmul(_t(x), _t(w), _t(b), activation=activation).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("activation", [None, "relu", "gelu", "silu", "tanh",
                                        "sigmoid"])
def test_apply_activation_matches_jax(activation):
    x = np.linspace(-6.0, 6.0, 97).astype(np.float32)
    want = np.asarray(jref.apply_activation(jnp.asarray(x), activation))
    got = ref.apply_activation(_t(x), activation).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_torch_lane_rounds_like_the_xla_lane_in_bf16():
    """The vendor lane rounds the product to bf16 before the activation
    (JAX's xla lane); the kernel lane applies it in f32 and rounds once."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 32)) / 8).astype(np.float32)
    want = np.asarray(jref.apply_activation(
        jnp.asarray(x, jnp.bfloat16) @ jnp.asarray(w, jnp.bfloat16), "silu"),
        np.float32)
    xb, wb = _t(x).bfloat16(), _t(w).bfloat16()
    got = dispatch_dense("mlp_up", xb, wb, activation="silu").float().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)
    with matmul_dispatch({"mlp_up": ("cuda_matmul", {})}):
        fused = dispatch_dense("mlp_up", xb, wb, activation="silu")
    np.testing.assert_array_equal(
        fused.float().numpy(), ref.matmul_ref(xb, wb, None, "silu").float().numpy())


def test_unknown_lane_raises():
    with matmul_dispatch({"lm_head": ("no_such_lane", {})}):
        with pytest.raises(KeyError):
            dispatch_dense("lm_head", torch.zeros(2, 4), torch.zeros(4, 3))


# ------------------------------------------------- no fallback off the CPU
def test_wrappers_raise_on_a_non_cpu_tensor_instead_of_falling_back():
    q = torch.zeros((2, 4, 16), device="meta")
    pool = torch.zeros((4, 8, 2, 16), device="meta")
    idx = torch.zeros((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="GPU"):
        ops.attention_decode_paged(q, pool, pool, idx, idx.reshape(2, 1))
    with pytest.raises(ValueError, match="GPU"):
        ops.attention_prefill_packed(q[None], pool, pool, idx.reshape(2, 1),
                                     torch.zeros((2, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="GPU"):
        ops.matmul(torch.zeros((2, 4), device="meta"),
                   torch.zeros((4, 3), device="meta"))


def test_build_names_libraries_by_source_digest(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    for name in build.SOURCES:
        p = build.lib_path(name)
        assert p.parent == tmp_path and p.name.startswith(name + "-")
        assert p == build.lib_path(name)
    # an edit of a shared header rebuilds the libraries that include it
    src = tmp_path / "csrc"
    shutil.copytree(build.CSRC, src)
    before = {n: build.lib_path(n).name for n in ("flash_attention", "paged_prefill")}
    monkeypatch.setattr(build, "CSRC", src)
    assert {n: build.lib_path(n).name for n in before} == before
    with open(src / "mma_attention.cuh", "a") as f:
        f.write("// edited\n")
    for name, old in before.items():
        assert build.lib_path(name).name != old
    monkeypatch.setenv("PATH", str(tmp_path))
    if not __import__("os").path.exists("/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc"):
            build.build_all(["matmul"])
