"""The sequence-parallel prefill's pieces as plain functions over split
blocks, in one process: each "rank" of a world of 2-4 runs in a thread
and their all-gathers meet at a barrier (`_ThreadWorld`), so no process
group is built.

  * `uneven_block` / `SeqSplit`: GSPMD's uneven blocks (ceil(S / d) each,
    the last short or empty), `gather` / `last` over them;
  * the SSD fold (`mamba.ssd_split`): every rank's block scanned from a
    zero state, the blocks' (final state, total decay) folded in rank
    order, held at many splits (hypothesis; f64) against the plain
    recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t, y_t = C_t h_t and
    against the JAX `ssd_chunked` of the whole sequence;
  * the query-offset causal mask (`attention._sdpa_direct` /
    `_sdpa_chunked` with `q_offset`): a block of queries at any offset
    against the whole keys equals the whole computation's rows, in both
    forms;
  * the layers over split blocks against the whole sequence: the conv
    halo and the fold through `mamba_forward(..., seq=)` (outputs, the
    whole prompt's conv window and state on every rank), `attn_forward(...,
    seq=)` (outputs and the whole K / V, the chunked form at 2048 keys
    included), `moe_apply(..., seq=)` (outputs and every kept pair).
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.models import mamba as jax_mamba
from repro_torch.configs import get_config
from repro_torch.distributed.collectives import AxisGroup, SeqSplit
from repro_torch.distributed.sharding import uneven_block
from repro_torch.models import attention as A
from repro_torch.models import mamba as M
from repro_torch.models import mlp as F

RTOL_F64 = 1e-10
RTOL_F32 = 1e-5                  # x max |value|
WAIT_S = 120                     # a barrier wait or a rank's join


class _ThreadWorld:
    """The ranks of one world as threads: `exchange` is an all-gather."""

    def __init__(self, size):
        self.size = size
        self.slots = [None] * size
        self.barrier = threading.Barrier(size, timeout=WAIT_S)

    def exchange(self, rank, x):
        self.slots[rank] = x.detach().clone()
        self.barrier.wait()
        out = torch.stack(self.slots)
        self.barrier.wait()
        return out

    def run(self, fn):
        """[fn(group) for every rank], each rank's call in its own thread."""
        out, errors = [None] * self.size, []

        def one(r):
            try:
                out[r] = fn(_ThreadGroup(self, r))
            except BaseException as e:      # noqa: BLE001 - re-raised below
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=one, args=(r,)) for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
        if errors:
            raise errors[0]
        assert not any(t.is_alive() for t in threads), "a rank did not finish"
        return out


class _ThreadGroup(AxisGroup):
    """One rank's `AxisGroup` of a `_ThreadWorld`."""

    def __init__(self, world, rank):
        self.world, self.rank, self.size, self.backend = world, rank, world.size, "gloo"
        self.group = None

    def _gather(self, x, kind="all-gather"):
        return self.world.exchange(self.rank, x)


def _split(world, total, fn):
    """[fn(SeqSplit of `total` over the rank)] for every rank of `world`."""
    return _ThreadWorld(world).run(lambda g: fn(SeqSplit(g, total)))


def _err(got, want):
    got, want = (torch.as_tensor(np.array(t) if isinstance(t, np.ndarray) else t).double()
                 for t in (got, want))
    assert got.shape == want.shape, (got.shape, want.shape)
    return float((got - want).abs().max() / max(float(want.abs().max()), 1e-30))


# ------------------------------------------------------------ the blocks
class _Stub:
    def __init__(self, rank, size):
        self.rank, self.size = rank, size


@given(n=st.integers(0, 70), size=st.integers(1, 5))
@settings(max_examples=60, deadline=None)
def test_uneven_blocks_are_gspmd_blocks(n, size):
    """ceil(n / size) rows a block, rank order, contiguous, covering n; a
    block may be short or empty; `SeqSplit.counts` agrees."""
    width = -(-n // size) if n else 0
    blocks = [uneven_block(n, _Stub(r, size)) for r in range(size)]
    assert sum(c for _, c in blocks) == n
    pos = 0
    for r, (start, count) in enumerate(blocks):
        assert start == min(n, r * width) and count <= max(width, 0)
        assert start == pos
        pos += count
    if size > 1 and n:
        world = _ThreadWorld(size)
        counts = world.run(lambda g: SeqSplit(g, n).counts)
        assert counts[0] == [c for _, c in blocks]


@pytest.mark.parametrize("total,world", [(13, 2), (7, 4), (3, 4), (1, 2), (64, 3)])
def test_seq_gather_and_last_row(total, world):
    x = torch.randn(2, total, 3)
    outs = _split(world, total, lambda seq: (seq.gather(x[:, seq.start:seq.start + seq.count]),
                                             seq.last(x[:, seq.start:seq.start + seq.count])))
    for whole, last in outs:
        assert torch.equal(whole, x)
        assert torch.equal(last, x[:, -1:])


# --------------------------------------------------------------- the SSD
def _ssd_inputs(rng, b, s, h, p, n, dtype=torch.float64):
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape)).to(dtype)  # noqa: E731
    x, B, C = t(b, s, h, p), t(b, s, n), t(b, s, n)
    dt = torch.nn.functional.softplus(t(b, s, h))
    A = -torch.exp(torch.linspace(0.0, 2.0, h, dtype=dtype))
    return x, dt, A, B, C


def _recurrence(x, dt, A, B, C):
    """The plain recurrence, one step a position."""
    b, s, h, p = x.shape
    state = torch.zeros((b, h, p, B.shape[-1]), dtype=x.dtype)
    ys = []
    for t in range(s):
        state = state * torch.exp(dt[:, t] * A)[..., None, None] + \
            (x[:, t] * dt[:, t, :, None])[..., None] * B[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", state, C[:, t]))
    return torch.stack(ys, 1), state


def _ssd_over(world, x, dt, A, B, C, chunk):
    s = x.shape[1]

    def rank(seq):
        sl = slice(seq.start, seq.start + seq.count)
        return M.ssd_split(seq, x[:, sl], dt[:, sl], A, B[:, sl], C[:, sl], chunk)

    outs = _split(world, s, rank)
    return torch.cat([y for y, _ in outs], 1), [h for _, h in outs]


@given(s=st.integers(1, 40), world=st.integers(2, 4), chunk=st.sampled_from([4, 8, 16]),
       seed=st.integers(0, 2 ** 16))
@settings(max_examples=40, deadline=None)
def test_ssd_fold_equals_the_recurrence_at_any_split(s, world, chunk, seed):
    """At any length, world and chunk (blocks a whole number of chunks or
    not, short, empty): the blocks' outputs and every rank's final state
    equal the plain recurrence's, f64, and every rank's state the same
    bits."""
    x, dt, A, B, C = _ssd_inputs(np.random.default_rng(seed), 2, s, 3, 4, 5)
    y_want, h_want = _recurrence(x, dt, A, B, C)
    y, hs = _ssd_over(world, x, dt, A, B, C, chunk)
    assert _err(y, y_want) <= RTOL_F64
    for h in hs:
        assert torch.equal(h, hs[0])
        assert _err(h, h_want) <= RTOL_F64


@pytest.mark.parametrize("s,world,chunk", [(64, 2, 16), (48, 2, 16), (48, 4, 16),
                                           (13, 2, 16), (96, 3, 32)])
def test_ssd_fold_equals_the_jax_scan_of_the_whole_sequence(s, world, chunk):
    """f32, against the JAX `ssd_chunked` of the whole sequence (blocks
    of 32, 24 (1.5 chunks), 12, 7 / 6 and 32 rows)."""
    args = _ssd_inputs(np.random.default_rng(s), 2, s, 4, 8, 16, torch.float32)
    y_want, h_want = jax_mamba.ssd_chunked(*(jnp.asarray(t.numpy()) for t in args), chunk)
    y, hs = _ssd_over(world, *args, chunk)
    assert _err(y, np.asarray(y_want)) <= RTOL_F32
    assert _err(hs[-1], np.asarray(h_want)) <= RTOL_F32


# ------------------------------------------------ the query-offset mask
@given(skv=st.integers(1, 48), data=st.data())
@settings(max_examples=40, deadline=None)
def test_query_offset_mask_is_the_whole_computations_rows(skv, data):
    """A block of queries [off, off + sq) against all the keys, causal:
    the direct form equals the whole computation's rows, and so does the
    chunked form (chunks of 8 over a key length padded to a multiple of 8,
    the chunks past the block skipped), within 1e-6 x max."""
    off = data.draw(st.integers(0, skv - 1))
    sq = data.draw(st.integers(1, skv - off))
    g = torch.Generator().manual_seed(skv * 131 + off)
    q = torch.randn(2, skv, 4, 8, generator=g)
    k, v = torch.randn(2, skv, 2, 8, generator=g), torch.randn(2, skv, 2, 8, generator=g)
    whole = A._sdpa_direct(q, k, v, True, 2)
    got = A._sdpa_direct(q[:, off:off + sq], k, v, True, 2, q_offset=off)
    assert _err(got, whole[:, off:off + sq]) <= 1e-6
    pad = -skv % 8
    kp = torch.cat([k, torch.zeros(2, pad, 2, 8)], 1)
    vp = torch.cat([v, torch.zeros(2, pad, 2, 8)], 1)
    whole = A._sdpa_chunked(q, kp, vp, True, 2, kv_chunk=8, q_offset=0)
    got = A._sdpa_chunked(q[:, off:off + sq], kp, vp, True, 2, kv_chunk=8, q_offset=off)
    assert _err(got, whole[:, off:off + sq]) <= 1e-6


def test_default_offset_is_the_bottom_right():
    g = torch.Generator().manual_seed(0)
    q, k, v = torch.randn(1, 3, 2, 8, generator=g), torch.randn(1, 9, 2, 8, generator=g), \
        torch.randn(1, 9, 2, 8, generator=g)
    assert torch.equal(A._sdpa_direct(q, k, v, True, 1),
                       A._sdpa_direct(q, k, v, True, 1, q_offset=6))


# ------------------------------------------------------------ the layers
def _mamba_cfg(**kw):
    return get_config("mamba2-2.7b").reduced(dtype="float32", **kw)


def _mamba_params(cfg, seed=0):
    p = M.mamba_init(torch.Generator().manual_seed(seed), cfg)
    p["conv_b"] = torch.randn(p["conv_b"].shape, generator=torch.Generator().manual_seed(1))
    return p


@pytest.mark.parametrize("s,world", [(32, 2), (48, 2), (13, 2), (5, 2), (4, 2), (9, 4),
                                     (48, 3)])
def test_mamba_forward_over_split_blocks(s, world):
    """Outputs within 1e-5 x max of the whole sequence's; the conv window
    and the state the whole prompt's, the same bits on every rank (blocks
    of 16, 24, 7 / 6, 3 / 2 and 2 / 2 rows at a conv width of 4: the
    halo of a block shorter than W-1 reaches over the block before it and
    the zeros before the prompt)."""
    cfg = _mamba_cfg()
    p = _mamba_params(cfg)
    x = torch.randn(2, s, cfg.d_model, generator=torch.Generator().manual_seed(s))
    y_want, (conv_want, h_want) = M.mamba_forward(p, cfg, x, return_state=True)

    def rank(seq):
        return M.mamba_forward(p, cfg, x[:, seq.start:seq.start + seq.count],
                               return_state=True, seq=seq)

    outs = _split(world, s, rank)
    assert _err(torch.cat([y for y, _ in outs], 1), y_want) <= RTOL_F32
    for _, (conv, h) in outs:
        assert torch.equal(conv, outs[0][1][0]) and torch.equal(h, outs[0][1][1])
        assert torch.equal(conv, conv_want)
        assert _err(h, h_want) <= RTOL_F32


def _attn_cfg():
    return get_config("qwen3-1.7b").reduced(dtype="float32", n_layers=1, d_model=64)


@pytest.mark.parametrize("s,world", [(13, 2), (32, 2), (7, 4), (2048, 2)])
def test_attn_forward_over_split_blocks(s, world):
    """Each block's queries at their global positions over every rank's
    K / V: outputs within 1e-5 x max of the whole sequence's, the K / V
    returned the whole sequence's (2048 keys: the chunked form)."""
    cfg = _attn_cfg()
    p = A.attn_init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(1, s, cfg.d_model, generator=torch.Generator().manual_seed(s))
    pos = torch.arange(s)[None]
    y_want, (k_want, v_want) = A.attn_forward(p, cfg, x, positions=pos, causal=True,
                                              return_kv=True)

    def rank(seq):
        sl = slice(seq.start, seq.start + seq.count)
        return A.attn_forward(p, cfg, x[:, sl], positions=pos[:, sl], causal=True,
                              return_kv=True, seq=seq)

    outs = _split(world, s, rank)
    assert _err(torch.cat([y for y, _ in outs], 1), y_want) <= RTOL_F32
    for _, (k, v) in outs:
        assert _err(k, k_want) <= RTOL_F32 and _err(v, v_want) <= RTOL_F32


@pytest.mark.parametrize("s,world", [(32, 2), (13, 2), (21, 4)])
def test_moe_apply_over_split_blocks(s, world):
    """A prefill group spanning the ranks: the capacity of the whole
    sequence, each pair's queue place after the lower ranks' pairs of its
    expert, row by row; the kept pairs (recorded, gathered) and the
    outputs equal the whole sequence's, and pairs do drop."""
    cfg = get_config("qwen2-moe-a2.7b").reduced(dtype="float32", capacity_factor=0.5)
    p = F.moe_init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(3, s, cfg.d_model, generator=torch.Generator().manual_seed(s))
    with F.record_drops(prefill=True) as want_keep:
        y_want = F.moe_apply(p, cfg, x)
    assert (~want_keep[0]).any(), "no pair dropped: the check is vacuous"

    def rank(seq):
        return F.moe_apply(p, cfg, x[:, seq.start:seq.start + seq.count], seq=seq)

    with F.record_drops(prefill=True) as keeps:        # one entry a rank
        outs = _split(world, s, rank)
    assert _err(torch.cat(outs, 1), y_want) <= RTOL_F32
    assert len(keeps) == world
    for keep in keeps:
        assert torch.equal(keep, want_keep[0])
