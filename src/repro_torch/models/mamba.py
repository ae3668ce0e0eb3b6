"""Mamba2 (state-space duality) block — the port of `repro.models.mamba`:
chunked SSD for prefill, the O(1)-state recurrence for decode.

The SSD scan follows the minimal reference of Dao & Gu (arXiv:2405.21060,
Listing 1) as the JAX package writes it: the sequence is cut into chunks
of Q tokens; within a chunk the output is a masked quadratic form, across
chunks a short recurrence carries the (n_heads, head_dim, d_state)
states.  Every heavy op is a matrix product (`torch.einsum` of two
operands, so the contraction order is fixed here and not chosen by a path
optimiser) or one of the three projections `in_proj` / `out_proj` /
`lm_head`, which the serving paths route by role through the plan's
matmul lanes (`models.common.dense`).  The inter-chunk `lax.scan` of the
reference is a Python loop over the static chunk count.

Decode keeps two carries per layer: the depthwise conv's window (the last
`conv_width - 1` raw inputs) and the SSM state,
h' = exp(dt·A) h + dt · x ⊗ B.

`mamba_logical_axes` names each parameter's logical axes, as the
reference's does.

Tensor parallelism over "ssm_heads" / "conv_dim" (the serving engines on
a mesh, the whole-prompt prefill of the fixed-batch loop included;
`zoo.MambaLM.tp_local_params` cuts the shards).  Two traps:

  * in_proj's output is the concatenation [z | x | B | C | dt], not one
    dimension: a contiguous 1/tp block of its columns would mix z, x and
    dt.  A rank holds a head-aligned slice instead (`tp_columns`): z and
    x of its heads, ALL of B and C (every head reads them) and dt of its
    heads; the conv weights take its x channels and all of B and C.  The
    layer then computes `tp_dims` (d_in / tp, nh / tp, d_in / tp + 2n);
  * the gated RMSNorm spans all of d_in (its scale's axis is replicated,
    so the reference's norm reduces across the heads): the rank's gated
    activations are all-gathered over the heads (exact) and normalised
    at full width, as on one device.  Where "conv_dim" is split, out_proj
    then runs on the rank's K slice of them and the partial outputs are
    summed over the ranks; otherwise it is the whole product.

In training, in_proj's input and the normed activations out_proj's K
slice is cut from enter the split region through
`distributed.collectives`' `enter` (their gradients summed over the
ranks); B and C, whole on every rank, get a partial gradient on each,
which the train step sums (`zoo.tp_layout` marks their columns and conv
channels as held by every rank).

The SSM state's columns split ("ssm_state" over "data" for a batch of
one, the decode step; `distributed.collectives.split_group("ssm_state")`):
a rank holds its block of the state's N columns.  The conv window still
yields all of B and C on every rank, each rank updates its columns with
its slices of them, and y = C · h, a sum over N, is summed over the group
in rank order in f32 (`mamba_decode`); a prefill's final state is cut to
the rank's columns (`local_state`).

The sequence split ("seq" over "data", the sequence-parallel prefill of a
batch of one): a rank runs its block of the prompt (`mamba_forward(...,
seq=)`).  The conv continues from the raw inputs just before its block,
gathered from the lower ranks (`_conv_halo`), and the scan from a zero
state, its result corrected by the state the lower ranks' blocks leave
(`ssd_split`: one all-gather of every block's final state and total
decay, folded in rank order).  The carries it returns are the whole
prompt's on every rank.

Softplus is `jax.nn.softplus` as JAX computes it, logaddexp(x, 0) =
max(x, 0) + log1p(exp(-|x|)), with no threshold branch: the dt of a padded
row is forced to 0.0 after it (`mamba_chunk_forward`), which is what makes
a chunked prompt equal the whole-prompt prefill.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import current, enter_if_sharded, split_group
from repro_torch.distributed.sharding import local_block
from repro_torch.models.common import Params, dense, dense_init, norm_init, rms_norm


def _dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_head_dim
    conv_dim = d_in + 2 * cfg.ssm_state
    return d_in, nheads, conv_dim


def tp_dims(cfg: ModelConfig, tp=None):
    """(d_in, nheads, conv channels) one rank computes: the whole layer's
    with no `tp` (a `distributed.collectives.TensorParallel`) or where it
    does not split "ssm_heads"; else its heads' d_in / tp and nh / tp, and
    its conv channels, its x channels plus all of B and C: d_in / tp + 2n
    (not conv_dim / tp)."""
    d_in, nh, conv_dim = _dims(cfg)
    if tp is None or not tp.sharded("ssm_heads"):
        return d_in, nh, conv_dim
    return d_in // tp.size, nh // tp.size, d_in // tp.size + 2 * cfg.ssm_state


def tp_columns(cfg: ModelConfig, rank: int, size: int, device=None):
    """The head-aligned slice of rank `rank` of `size` (see the module
    docstring): (in_proj's output columns [z_r | x_r | B | C | dt_r],
    the conv channels [x_r | B | C]), as index tensors."""
    d_in, nh, _ = _dims(cfg)
    n = cfg.ssm_state
    dl, hl = d_in // size, nh // size
    ar = functools.partial(torch.arange, device=device)
    z = ar(rank * dl, (rank + 1) * dl)
    bc = ar(2 * d_in, 2 * d_in + 2 * n)
    dt = ar(2 * d_in + 2 * n + rank * hl, 2 * d_in + 2 * n + (rank + 1) * hl)
    cols = torch.cat([z, d_in + z, bc, dt])
    chans = torch.cat([z, ar(d_in, d_in + 2 * n)])
    return cols, chans


def mamba_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """f32 parameters of one block on `gen.device`, drawn from the JAX
    init's distributions."""
    d = cfg.d_model
    d_in, nh, conv_dim = _dims(cfg)
    dev = gen.device
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand((nh,), generator=gen, device=dev) * (hi - lo) + lo
    return {
        "in_proj": dense_init(gen, d, 2 * d_in + 2 * cfg.ssm_state + nh),
        "conv_w": torch.randn((cfg.conv_width, conv_dim), generator=gen,
                              device=dev) * 0.2,
        "conv_b": torch.zeros((conv_dim,), device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device=dev)),
        "D": torch.ones((nh,), device=dev),
        "dt_bias": torch.log(torch.expm1(torch.exp(u))),
        "norm": norm_init(d_in, dev),
        "out_proj": dense_init(gen, d_in, d),
    }


def mamba_logical_axes(cfg: ModelConfig) -> Params:
    return {
        "in_proj": {"w": ("embed", "conv_dim")},
        "conv_w": (None, "conv_dim"),
        "conv_b": ("conv_dim",),
        "A_log": ("ssm_heads",),
        "D": ("ssm_heads",),
        "dt_bias": ("ssm_heads",),
        "norm": {"scale": (None,)},
        "out_proj": {"w": ("conv_dim", "embed")},
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    d_in, _, _ = tp_dims(cfg, current())
    n = cfg.ssm_state
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:2 * d_in + 2 * n]
    dt = zxbcdt[..., 2 * d_in + 2 * n:]
    return z, xbc, dt


def _causal_conv(w: torch.Tensor, b: torch.Tensor, xbc: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv (B, S, C) by static shifts, then SiLU."""
    width = w.shape[0]
    s = xbc.shape[1]
    out = xbc * w[-1].to(xbc.dtype)
    for i in range(1, width):
        shifted = F.pad(xbc, (0, 0, i, 0))[:, :s]
        out = out + shifted * w[-1 - i].to(xbc.dtype)
    return F.silu(out + b.to(xbc.dtype))


def _causal_conv_carry(w: torch.Tensor, b: torch.Tensor, xbc: torch.Tensor,
                       carry: torch.Tensor) -> torch.Tensor:
    """`_causal_conv` continued from a previous segment: `carry` (B, W-1,
    C), the last W-1 raw inputs before it, stands in for the zero
    left-padding.  The same shift-and-accumulate order, so a zero carry is
    bitwise the from-scratch conv."""
    width = w.shape[0]
    s = xbc.shape[1]
    ext = torch.cat([carry.to(xbc.dtype), xbc], dim=1)
    out = xbc * w[-1].to(xbc.dtype)
    for i in range(1, width):
        shifted = ext[:, width - 1 - i:width - 1 - i + s]
        out = out + shifted * w[-1 - i].to(xbc.dtype)
    return F.silu(out + b.to(xbc.dtype))


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., Q) -> (..., Q, Q): out[i, j] = sum_{j < t <= i} x[t], -inf
    above the diagonal."""
    q = x.shape[-1]
    cs = torch.cumsum(x, -1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, -math.inf)


def ssd_chunked(x, dt, A, B, C, chunk: int, h0=None):
    """SSD scan.  x (b, s, h, p); dt (b, s, h); A (h,); B, C (b, s, n);
    optional h0 (b, h, p, n) seeds the inter-chunk recurrence (zeros by
    default).  Returns y (b, s, h, p) and the final state (b, h, p, n)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, s)
    assert s % q == 0, (s, q)
    nc = s // q

    xc = x.reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h)
    Bc = B.reshape(b, nc, q, n)
    Cc = C.reshape(b, nc, q, n)
    dA = dtc * A                                             # (b, nc, q, h)
    dA_cs = torch.cumsum(dA, dim=2)

    # 1. intra-chunk: the masked quadratic form
    L = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))          # (b, nc, h, q, q)
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)         # (b, nc, q, q)
    xdt = xc * dtc[..., None]                                # (b, nc, q, h, p)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores[:, :, None] * L, xdt)
    # 2. each chunk's state
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)    # (b, nc, q, h)
    states = torch.einsum("bckn,bckhp->bchpn", Bc, xdt * decay_states[..., None])

    # 3. the recurrence over chunks
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])              # (b, nc, h)
    h_prev = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device) \
        if h0 is None else h0
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h_prev)
        h_prev = h_prev * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                    # (b, nc, h, p, n)

    # 4. what the previous chunks' states contribute
    state_decay = torch.exp(dA_cs)                           # (b, nc, q, h)
    y_off = torch.einsum("bcqn,bchpn->bcqhp", Cc, h_prevs) * state_decay[..., None]

    y = (y_diag + y_off).reshape(b, s, h, p)
    return y, h_prev


def ssd_split(seq, x, dt, A, B, C, chunk: int):
    """`ssd_chunked` of a whole sequence split over ranks, run on this
    rank's block (`distributed.collectives.SeqSplit` `seq`; x (b, n, h, p),
    dt (b, n, h), B, C (b, n, N)): -> (y of the block (b, n, h, p), the
    whole sequence's final state (b, h, p, N), the same bits on every
    rank).

    The block is scanned from a zero state, in chunks of `chunk` (a block
    of at most `chunk` rows is one chunk; a longer one is padded at its end
    with dt = 0 rows, exact identities of the recurrence, to a whole number
    of chunks).  SSD is exact under any chunking, so the block's own
    chunks stand in for the whole sequence's.  Then one all-gather of every
    rank's (final state S_j, total log-decay a_j = sum of dt·A over its
    block) and the fold, in rank order, h <- h·exp(a_j) + S_j: over the
    lower ranks it gives the block's true initial state h0, over all of
    them the final state.  h0's term, C_t · (exp(cumsum of dt·A up to t)
    h0), the term the scan's step 4 adds for a carried state, is added to
    the block's outputs: the scan runs once.

    Under autograd the gather is `AxisGroup.stacked`: the gradients of the
    lower ranks' (S_j, a_j) go back to them.  h0 is read from the stack of
    every prefix of the fold, so every rank's graph reaches the gather
    and runs its backward (rank 0's own h0 is the zero state)."""
    b, n, h, p = x.shape
    if n:
        q = min(chunk, n)
        pad = -n % q
        if pad:
            x, dt, B, C = (torch.cat([t, t.new_zeros((b, pad, *t.shape[2:]))], 1)
                           for t in (x, dt, B, C))
        y, state = ssd_chunked(x, dt, A, B, C, chunk)
        y, dt, C = y[:, :n], dt[:, :n], C[:, :n]
        cum = torch.cumsum(dt * A, dim=1)                   # (b, n, h)
        total = cum[:, -1]
    else:
        # an empty block: zeros on x's graph, so that under autograd this
        # rank's backward reaches the gather as every other rank's does
        tie = x.sum() * 0 if x.requires_grad else 0.0
        y = x.new_zeros(x.shape)
        state = x.new_zeros((b, h, p, B.shape[-1])) + tie
        cum, total = dt.new_zeros((b, 0, h)), dt.new_zeros((b, h)) + tie
    parts = seq.group.stacked(torch.cat([state.reshape(b, -1), total], -1))
    runs = [torch.zeros_like(state)]
    for part in parts.unbind(0):
        runs.append(runs[-1] * torch.exp(part[:, -h:])[..., None, None]
                    + part[:, :-h].reshape(state.shape))
    h0 = torch.stack(runs[:-1])[seq.group.rank]
    y = y + torch.einsum("bsn,bhpn->bshp", C, h0) * torch.exp(cum)[..., None]
    return y, runs[-1]


def _conv_halo(seq, xbc_raw: torch.Tensor, w1: int):
    """(the last `w1` raw conv inputs before this rank's block, those of
    the whole sequence), each (B, w1, C), zero-padded at the front where
    fewer precede: from one all-gather of every rank's last `w1` rows (a
    halo may reach back over several short blocks).  Both are read from
    one run of every rank's rows, so under autograd every rank's graph
    reaches the gather, whose backward returns the gradients of the rows
    read to their holders (`SeqSplit.parts`)."""
    b, n, c = xbc_raw.shape
    tail = xbc_raw[:, max(0, n - w1):]
    parts = seq.parts(tail, 1).unbind(0)
    held = [min(w1, cnt) for cnt in seq.counts]
    rows = torch.cat([xbc_raw.new_zeros((b, w1, c)),
                      *[part[:, :m] for part, m in zip(parts, held)]], 1)
    end = w1 + sum(held[:seq.group.rank])
    return rows[:, end - w1:end], rows[:, -w1:]


def _ssd_inputs(p: Params, cfg: ModelConfig, xbc: torch.Tensor):
    d_in, nh, _ = tp_dims(cfg, current())
    n, hd = cfg.ssm_state, cfg.ssm_head_dim
    b, s, _ = xbc.shape
    xs = xbc[..., :d_in].reshape(b, s, nh, hd)
    Bm = xbc[..., d_in:d_in + n]
    Cm = xbc[..., d_in + n:]
    A = -torch.exp(p["A_log"].float())
    return xs, Bm, Cm, A


def _gated_out(p: Params, cfg: ModelConfig, y: torch.Tensor, xs: torch.Tensor,
               z: torch.Tensor, dtype: torch.dtype, role) -> torch.Tensor:
    """y + D·x, the gated RMSNorm over all of d_in and the output
    projection (under tensor parallelism: see the module docstring)."""
    b, s = z.shape[:2]
    y = y + xs.float() * p["D"].float()[:, None]
    y = y.reshape(b, s, z.shape[-1]).to(dtype) * F.silu(z)
    tp = current()
    if tp is not None and tp.sharded("ssm_heads"):
        y = tp.all_gather(y, -1)
    y = rms_norm(p["norm"], y)
    if tp is not None and tp.sharded("conv_dim"):
        k = y.shape[-1] // tp.size
        y = tp.enter(y)[..., tp.rank * k:(tp.rank + 1) * k].contiguous()
        return tp.all_reduce(dense(p["out_proj"], y, role=role))
    return dense(p["out_proj"], y, role=role)


def mamba_forward(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  return_state: bool = False, seq=None):
    """x (B, S, d) -> (B, S, d), and with `return_state` the decode carries
    (conv window (B, W-1, conv channels), SSM state (B, nh, hd, n) f32).
    Under tensor parallelism the layer runs at `tp_dims` on the rank's
    head-aligned slice and the carries are the rank's.

    With `seq` (a `distributed.collectives.SeqSplit`: the sequence-parallel
    prefill) x is the rank's block of the sequence: the conv reads the
    W-1 raw inputs before the block through `_causal_conv_carry` (zeros
    before position 0; `_conv_halo`), the scan is `ssd_split`, and the
    carries are the whole sequence's, the same on every rank."""
    zxbcdt = dense(p["in_proj"], enter_if_sharded(x, "ssm_heads"))
    z, xbc_raw, dt = _split_proj(cfg, zxbcdt)
    w1 = cfg.conv_width - 1
    if seq is None:
        xbc = _causal_conv(p["conv_w"], p["conv_b"], xbc_raw)
        conv = xbc_raw[:, -w1:, :]
    else:
        halo, conv = _conv_halo(seq, xbc_raw, w1)
        xbc = _causal_conv_carry(p["conv_w"], p["conv_b"], xbc_raw, halo)
    xs, Bm, Cm, A = _ssd_inputs(p, cfg, xbc)
    dt = softplus(dt.float() + p["dt_bias"].float())
    scan = ssd_chunked if seq is None else functools.partial(ssd_split, seq)
    y, h_final = scan(xs.float(), dt, A, Bm.float(), Cm.float(), cfg.ssm_chunk)
    out = _gated_out(p, cfg, y, xs, z, x.dtype, None)
    if return_state:
        return out, (conv, h_final)
    return out


def mamba_chunk_forward(p: Params, cfg: ModelConfig, x: torch.Tensor,
                        conv_carry: torch.Tensor, h0: torch.Tensor, seg_len):
    """One resumable serve-time prefill segment: `mamba_forward` over a
    fixed-width window x (B, C, d) of which the first `seg_len` rows are
    real, continuing from `conv_carry` (B, W-1, conv_dim) and `h0`
    (B, nh, hd, n).  `seg_len` may be a device tensor: nothing here reads
    it on the host.

    Fed a prompt in C-token segments (zero carries first, each segment's
    carries into the next, C a multiple of `cfg.ssm_chunk`) this gives
    `mamba_forward`'s outputs and final state: padded rows get dt = 0.0
    after the softplus (exact identities of the recurrence), the conv
    continues through `_causal_conv_carry`, and the scan starts from h0.

    Returns y (B, C, d), the new conv carry (B, W-1, conv_dim) f32 — the
    last W-1 real raw inputs, read at offset `seg_len` of the
    carry-extended input — and the final state (B, nh, hd, n) f32."""
    b, s, _ = x.shape
    zxbcdt = dense(p["in_proj"], x, role="in_proj")
    z, xbc_raw, dt = _split_proj(cfg, zxbcdt)
    xbc = _causal_conv_carry(p["conv_w"], p["conv_b"], xbc_raw, conv_carry)
    xs, Bm, Cm, A = _ssd_inputs(p, cfg, xbc)
    seg_len = torch.as_tensor(seg_len, device=x.device).reshape(())
    dtv = softplus(dt.float() + p["dt_bias"].float())
    row = torch.arange(s, device=x.device)[None, :, None]
    dtv = torch.where(row < seg_len, dtv, 0.0)
    y, h_final = ssd_chunked(xs.float(), dtv, A, Bm.float(), Cm.float(),
                             cfg.ssm_chunk, h0=h0.float())
    out = _gated_out(p, cfg, y, xs, z, x.dtype, "out_proj")
    ext = torch.cat([conv_carry.to(xbc_raw.dtype), xbc_raw], dim=1)
    rows = seg_len.long() + torch.arange(cfg.conv_width - 1, device=x.device)
    return out, ext.index_select(1, rows).float(), h_final


def _state_block(cfg: ModelConfig) -> Tuple[int, int]:
    """(start, count) of the rank's SSM state columns of `cfg.ssm_state`."""
    return local_block(cfg.ssm_state, split_group("ssm_state"), "the SSM state's width")


def local_state(cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """A whole SSM state (..., n) cut to the rank's columns (itself where
    "ssm_state" is not split)."""
    start, n = _state_block(cfg)
    return h if n == h.shape[-1] else h[..., start:start + n].contiguous()


def mamba_init_state(cfg: ModelConfig, batch: int, device=None,
                     tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zeroed decode carries, conv window (B, W-1, conv channels) and SSM
    state (B, nh, hd, n), f32, at the widths one device computes
    (`tp_dims`: the rank's under `tp`; n the rank's columns where
    "ssm_state" is split)."""
    _, nh, conv_dim = tp_dims(cfg, tp)
    conv = torch.zeros((batch, cfg.conv_width - 1, conv_dim), device=device)
    h = torch.zeros((batch, nh, cfg.ssm_head_dim, _state_block(cfg)[1]), device=device)
    return conv, h


def mamba_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 conv_cache: torch.Tensor, h: torch.Tensor):
    """One token.  x (B, 1, d); conv_cache (B, W-1, conv_dim); h (B, nh,
    hd, n) -> (y (B, 1, d), new conv_cache f32, new h f32).  Where
    "ssm_state" is split, h holds the rank's columns and C · h is summed
    over the group."""
    d_in, nh, _ = tp_dims(cfg, current())
    n, hd = cfg.ssm_state, cfg.ssm_head_dim
    b = x.shape[0]
    zxbcdt = dense(p["in_proj"], x, role="in_proj")
    z, xbc_raw, dt = _split_proj(cfg, zxbcdt)
    window = torch.cat([conv_cache.to(xbc_raw.dtype), xbc_raw], dim=1)
    xbc = F.silu(torch.einsum("bwc,wc->bc", window, p["conv_w"].to(window.dtype))
                 + p["conv_b"].to(window.dtype))
    new_conv = window[:, 1:, :].float()

    xs = xbc[:, :d_in].reshape(b, nh, hd).float()
    Bm = xbc[:, d_in:d_in + n].float()                       # (B, n)
    Cm = xbc[:, d_in + n:].float()
    A = -torch.exp(p["A_log"].float())
    dtv = softplus(dt[:, 0].float() + p["dt_bias"].float())  # (B, nh)

    group = split_group("ssm_state")
    if group is not None:
        start, cols = _state_block(cfg)
        Bm, Cm = Bm[:, start:start + cols], Cm[:, start:start + cols]
    dA = torch.exp(dtv * A)
    h = h * dA[..., None, None] + (xs * dtv[..., None])[..., None] * Bm[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", h, Cm)
    if group is not None:
        y = group.all_reduce(y)
    out = _gated_out(p, cfg, y[:, None], xs[:, None], z, x.dtype, "out_proj")
    return out, new_conv, h
