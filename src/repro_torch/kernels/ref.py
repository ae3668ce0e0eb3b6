"""Plain PyTorch versions of the port's kernels.

Each function computes what one hand-written CUDA kernel computes, in the
most obvious way: CPU tensors take these instead of the kernel, the tests
hold them against the JAX package, and `chip_smoke.py` holds the kernels
against them on the card.

Rounding points follow the JAX package's default lanes:

  * `matmul_ref` is `repro.kernels.ref.matmul_ref`: an f32 product of the
    inputs, bias and activation in f32, one rounding to the output dtype —
    the arithmetic of the tiled GEMM kernel.
  * the two paged attention references are the XLA *gather* lanes of
    `repro.models.attention` (`attn_decode_paged`, `attn_prefill_packed`):
    Q·Kᵀ is computed in the working dtype and only then cast to f32 and
    scaled; the softmax runs in f32 and the probabilities are rounded to
    the value dtype before the P·V product (also in the working dtype).
    The CUDA kernels accumulate Q·Kᵀ and P·V in f32 instead, as the Pallas
    kernels do, so in bf16 the two agree only to a tolerance; in f32 they
    agree to rounding.
  * the two dense attention references (`attention_ref`,
    `dense_decode_attention_ref`) follow the Pallas kernels
    `flash_attention_padded` / `flash_decode_padded` instead, whose
    counterparts they are: Q·Kᵀ accumulated in f32, probabilities rounded
    to V's dtype before an f32 P·V, one global max in place of the online
    one.  `attention_ref`'s causal mask is aligned at the top left, as the
    Pallas kernel's is (query row i sees keys 0..i); the JAX oracle
    `repro.kernels.ref.attention_ref` aligns it at the bottom right, and
    the two agree only where Sq == Skv.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def apply_activation(x: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
    """`repro.kernels.ref.apply_activation`; `jax.nn.gelu` defaults to the
    tanh approximation, so "gelu" here is `approximate="tanh"`."""
    if activation in (None, "none", "identity"):
        return x
    if activation == "relu":
        return F.relu(x)
    if activation == "gelu":
        return F.gelu(x, approximate="tanh")
    if activation == "silu":
        return F.silu(x)
    if activation == "tanh":
        return torch.tanh(x)
    if activation == "sigmoid":
        return torch.sigmoid(x)
    raise KeyError(activation)


def matmul_ref(x: torch.Tensor, w: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               activation: Optional[str] = None,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(..., K) @ (K, N) with an f32 accumulator, bias + activation in f32,
    rounded once to `out_dtype` (default: x's dtype)."""
    out_dtype = out_dtype or x.dtype
    out = torch.matmul(x.float(), w.float())
    if bias is not None:
        out = out + bias.float()
    return apply_activation(out, activation).to(out_dtype)


def same_pads(size: int, k: int, stride: int):
    """(low, high) SAME padding of one spatial dim, TensorFlow's split (as
    `jax.lax` pads): the odd element goes to the high side."""
    total = max(0, (-(-size // stride) - 1) * stride + k - size)
    return total // 2, total - total // 2


def conv2d_ref(x: torch.Tensor, w: torch.Tensor,
               bias: Optional[torch.Tensor] = None, stride: int = 1,
               padding: str = "SAME",
               activation: Optional[str] = None) -> torch.Tensor:
    """NHWC x (N, H, W, Cin) * HWIO w (Kh, Kw, Cin, Cout) -> NHWC, f32
    accumulation, bias + activation in f32, rounded once to x's dtype."""
    kh, kw = w.shape[0], w.shape[1]
    xf = x.float().permute(0, 3, 1, 2)
    if padding == "SAME":
        xf = F.pad(xf, same_pads(x.shape[2], kw, stride) + same_pads(x.shape[1], kh, stride))
    elif padding != "VALID":
        raise ValueError(f"padding {padding!r}")
    out = F.conv2d(xf, w.float().permute(3, 2, 0, 1), stride=stride)
    if bias is not None:
        out = out + bias.float().reshape(1, -1, 1, 1)
    out = apply_activation(out, activation).to(x.dtype)
    return out.permute(0, 2, 3, 1).contiguous()


_BINARY = {"add": torch.add, "mul": torch.mul, "sub": torch.sub, "div": torch.div}


def fused_elementwise_ref(x: torch.Tensor, chain, extras=()) -> torch.Tensor:
    """Chain of elementwise stages; binary stages pop from `extras`.  A
    stage is a {'op': name} dict or a bare name."""
    extras = list(extras)
    for stage in chain:
        op = stage["op"] if isinstance(stage, dict) else stage
        xf = x.float()
        if op in _BINARY:
            xf = _BINARY[op](xf, extras.pop(0).float())
        else:
            xf = apply_activation(xf, op)
        x = xf.to(x.dtype)
    return x


def _softmax_pv(logits: torch.Tensor, v_dtype: torch.dtype) -> torch.Tensor:
    return torch.softmax(logits, dim=-1).to(v_dtype)


def paged_decode_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, lengths: torch.Tensor,
                               block_tables: torch.Tensor,
                               scale: Optional[float] = None) -> torch.Tensor:
    """Paged decode attention, the gather lane of `attn_decode_paged`.

    q (B, H, D); pools (num_blocks, block_size, Hkv, D); lengths (B,) valid
    context lengths INCLUDING the new token (positions >= length masked);
    block_tables (B, nbt).  Returns (B, H, D) in q's dtype.  A row with
    length 0 has no valid key and gives zeros, as the Pallas kernel does;
    the serving path never consumes it (inactive slots pass length 1)."""
    b, h, d = q.shape
    bs, hkv = k_pool.shape[1], k_pool.shape[2]
    nbt = block_tables.shape[1]
    g = h // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    tables = block_tables.long()
    k_ctx = k_pool[tables].reshape(b, nbt * bs, hkv, d)
    v_ctx = v_pool[tables].reshape(b, nbt * bs, hkv, d)
    qg = q.reshape(b, hkv, g, d)
    logits = torch.einsum("bhgd,bkhd->bhgk", qg, k_ctx).float() * scale
    pos = torch.arange(nbt * bs, device=q.device)[None, None, None, :]
    logits = torch.where(pos < lengths.long()[:, None, None, None], logits,
                         torch.full_like(logits, NEG_INF))
    probs = _softmax_pv(logits, v_ctx.dtype)
    out = torch.einsum("bhgk,bkhd->bhgd", probs, v_ctx).reshape(b, h, d)
    out = torch.where(lengths.long()[:, None, None] > 0, out, torch.zeros_like(out))
    return out.to(q.dtype)


def packed_row_map(seg_info: torch.Tensor, c: int):
    """Per-row segment assignment of a packed chunk
    (`repro.models.attention.packed_row_map`): returns (sid, pos, valid),
    each (C,) — the row's segment (clamped), its absolute position in its
    own request (0 on padding rows) and whether it carries a prompt token."""
    info = seg_info.long()
    ns = info.shape[0]
    q0, qn, kv0 = info[:, 0], info[:, 1], info[:, 2]
    r = torch.arange(c, device=info.device)
    seg_end = q0 + qn
    sid = torch.clamp((r[:, None] >= seg_end[None, :]).long().sum(1), max=ns - 1)
    valid = (r >= q0[sid]) & (r < seg_end[sid])
    pos = kv0[sid] + (r - q0[sid])
    return sid, torch.where(valid, pos, torch.zeros_like(pos)), valid


def packed_prefill_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor, seg_tables: torch.Tensor,
                                 seg_info: torch.Tensor,
                                 scale: Optional[float] = None) -> torch.Tensor:
    """Segment-packed paged prefill attention, the gather lane of
    `attn_prefill_packed`.

    q (1, C, H, D) packed chunk; pools (num_blocks, block_size, Hkv, D);
    seg_tables (S, nbt); seg_info (S, 3) [row_offset, seg_len, kv_start].
    Each row gathers its own segment's full table and attends to key
    positions <= its own absolute position.  Returns (1, C, H, D); rows past
    the packed fill hold finite values the caller discards."""
    _, c, h, d = q.shape
    bs, hkv = k_pool.shape[1], k_pool.shape[2]
    nbt = seg_tables.shape[1]
    g = h // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    sid, pos, _ = packed_row_map(seg_info, c)
    row_tables = seg_tables.long()[sid]                          # (C, nbt)
    k_ctx = k_pool[row_tables].reshape(c, nbt * bs, hkv, d)
    v_ctx = v_pool[row_tables].reshape(c, nbt * bs, hkv, d)
    qg = q[0].reshape(c, hkv, g, d)
    logits = torch.einsum("qhgd,qkhd->hgqk", qg, k_ctx).float() * scale
    kpos = torch.arange(nbt * bs, device=q.device)[None, None, None, :]
    logits = torch.where(kpos <= pos[None, None, :, None], logits,
                         torch.full_like(logits, NEG_INF))
    probs = _softmax_pv(logits, v_ctx.dtype)
    out = torch.einsum("hgqk,qkhd->qhgd", probs, v_ctx)
    return out.reshape(1, c, h, d).to(q.dtype)


def _rounded_pv(logits: torch.Tensor, valid: torch.Tensor, v: torch.Tensor,
                eq: str) -> torch.Tensor:
    """softmax(logits over `valid` keys) · V with the dense kernels'
    rounding points: p = exp(s - max) in f32, rounded to V's dtype before
    an f32 P·V (einsum `eq`), divided by the f32 sum of the unrounded p.  A
    row with no valid key gives zeros (l = 0, as in the kernels)."""
    logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = torch.where(valid, p, torch.zeros_like(p))
    denom = p.sum(-1)
    acc = torch.einsum(eq, p.to(v.dtype).float(), v.float())
    return acc / torch.where(denom == 0, torch.ones_like(denom), denom)[..., None]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Dense attention, (B, Sq, H, D) x (B, Skv, Hkv, D) -> (B, Sq, H, D),
    query head h on KV head h // (H / Hkv); causal rows see keys 0..i (the
    mask aligned at the top left, as in the Pallas kernel)."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.float().reshape(b, sq, hkv, h // hkv, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    valid = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        valid = (torch.arange(skv, device=q.device)[None, :]
                 <= torch.arange(sq, device=q.device)[:, None])
    out = _rounded_pv(logits, valid, v, "bhgqk,bkhd->bhgqd")   # (B, Hkv, G, Sq, D)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def dense_decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, lengths: torch.Tensor,
                               scale: Optional[float] = None) -> torch.Tensor:
    """One new token per sequence, q (B, H, D), against the first
    `lengths[b]` rows of dense caches (B, S, Hkv, D) -> (B, H, D); a length
    of 0 gives zeros."""
    b, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.float().reshape(b, hkv, h // hkv, d)
    logits = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) * scale
    pos = torch.arange(s, device=q.device)
    valid = (pos[None, :] < lengths.to(q.device).long()[:, None])[:, None, None, :]
    out = _rounded_pv(logits, valid, v_cache, "bhgk,bkhd->bhgd")
    return out.reshape(b, h, d).to(q.dtype)


# ------------------------------------------------------------ keyed sampling
# jax.random's threefry2x32 generator as uint32 arithmetic on int64 tensors
# masked to 32 bits (`jax/_src/prng.py`, `jax/_src/random.py`, jax 0.9 with
# `jax_threefry_partitionable` on, its default).  A key is a pair of
# uint32 words, held as the last dim of an int64 tensor.
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
F32_TINY = 1.1754943508222875e-38          # np.finfo(np.float32).tiny


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry_hash(k0, k1, x0, x1):
    """The Threefry-2x32 block (`prng._threefry2x32_lowering`): 20 rounds
    over the counter pair (x0, x1) under the key (k0, k1), every argument
    an int64 tensor of uint32 values (broadcast together).  -> (y0, y1)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def threefry2x32(key: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """`prng.threefry_2x32`: hash a flat uint32 `count` under `key` (2,),
    its first half as x0 and its second as x1 (an odd count padded with
    one 0); the two outputs concatenated, cut to count's shape."""
    flat = count.reshape(-1).long() & _M32
    n = flat.numel()
    if n % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    x0, x1 = flat.chunk(2)
    y0, y1 = threefry_hash(key[0], key[1], x0, x1)
    return torch.cat([y0, y1])[:n].reshape(count.shape)


def threefry_seed(seed: torch.Tensor) -> torch.Tensor:
    """`prng.threefry_seed` of int32 seeds (...,) -> keys (..., 2): the
    high word is the seed shifted right by 32 (0 for a 32-bit seed), the
    low word the seed's 32 bits."""
    seed = seed.long() & _M32
    return torch.stack([torch.zeros_like(seed), seed], -1)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """`prng.threefry_fold_in`: keys (..., 2) and uint32 data (...,) ->
    the hash of the counter pair (0, data) under each key, (..., 2)."""
    data = data.long() & _M32
    y0, y1 = threefry_hash(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([y0, y1], -1)


def derive_key(keys: torch.Tensor) -> torch.Tensor:
    """`repro.kernels.sampling.derive_key` per row: (rows, 3) int32 [seed,
    rid, token_index] -> (rows, 2) keys fold_in(fold_in(PRNGKey(seed),
    rid), token_index)."""
    keys = keys.long()
    return fold_in(fold_in(threefry_seed(keys[:, 0]), keys[:, 1]), keys[:, 2])


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """`prng._threefry_random_bits_partitionable` at 32 bits over the shape
    (n,), one row per key: keys (rows, 2) -> (rows, n) uint32 values in
    int64.  Element i hashes the counter pair (i >> 32, i & 0xFFFFFFFF)
    and keeps the xor of the two outputs."""
    idx = torch.arange(n, dtype=torch.int64, device=key.device)[None, :]
    y0, y1 = threefry_hash(key[:, :1], key[:, 1:], idx >> 32, idx & _M32)
    return y0 ^ y1


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """`random._uniform` in f32 on [tiny, 1): the top 23 bits as the
    mantissa of a float in [1, 2), minus 1, scaled by (1 - tiny) (1.0 in
    f32), plus tiny, floored at tiny."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    floats = mant - 1.0
    minval = torch.tensor(F32_TINY, dtype=torch.float32, device=bits.device)
    scale = torch.tensor(1.0, dtype=torch.float32, device=bits.device) - minval
    return torch.maximum(minval, floats * scale + minval)


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """`random._gumbel`, mode "low": -log(-log(u))."""
    return -torch.log(-torch.log(u))


def sample_draw_ref(x: torch.Tensor, logits: torch.Tensor, temps: torch.Tensor,
                    keys: torch.Tensor) -> torch.Tensor:
    """The draw of `repro.kernels.sampling._sample_row` over rows: x (rows,
    V) the masked, temperature-scaled f32 logits, `logits` (rows, V) the
    raw ones, temps (rows,), keys (rows, 3) int32 [seed, rid, token_index].
    -> (rows,) int32: argmax(gumbel + x) under the row's derived key where
    the temperature is > 0, else argmax(logits); both take the first index
    on ties."""
    v = x.shape[-1]
    u = uniform_from_bits(random_bits(derive_key(keys), v))
    sampled = torch.argmax(gumbel_from_uniform(u) + x, dim=-1)
    greedy = torch.argmax(logits, dim=-1)
    return torch.where(temps > 0, sampled, greedy).to(torch.int32)
