"""Sequence-parallel training against the JAX package: "seq" over "data"
with the batch replicated, as the reference's `rules_for_shape` gives it
where the global batch does not split over the data ranks.

  * (a) the split's pieces under autograd, in one process: each "rank" of
    a world of 2-4 runs its forward and backward in a thread and the
    all-gathers meet at a barrier (`test_torch_seq_split._ThreadWorld`).
    At any length and world (blocks aligned, uneven, empty; hypothesis,
    f64) `SeqSplit.gather`, the SSD fold (`mamba.ssd_split`) and the conv
    halo (`mamba._conv_halo` into `_causal_conv_carry`) give every rank the
    gradients of its block that the whole-sequence function gives those
    positions, for a loss each rank reads its own way (its block's
    outputs and the whole sequence's final state or window under weights
    of its own), and the replicated inputs' gradients summed over the
    ranks are the whole function's;
  * (b) one gloo world of 4 CPU processes, (data 2, model 2), one sequence
    of 32 tokens a family (dense, moe, ssm, hybrid, and the vlm / encdec
    with their extras; dense and moe again under remat "full", whose
    backward recomputes the K / V gather and the MoE's queue offsets as
    collectives), a mask whose counts differ between the blocks:
    every rank's block of positions through the step
    (`test_torch_train_layouts.CHILD`), the step-1 loss and gathered
    gradients against `jax.value_and_grad` of the whole sequence, three
    steps' parameters against JAX's, every rank's bits equal; the
    reference's `jit_train_step` runs the same layout on a forced-8-device
    Auto mesh to the same step-1 loss (the dense and hybrid families: SSD,
    the conv and attention in one step).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.distributed.collectives import SeqSplit
from repro_torch.models import mamba as M
from test_torch_seq_split import _err, _recurrence, _ssd_inputs, _ThreadWorld
from test_torch_train_layouts import check_params, check_ranks, check_step1, run_worlds

RTOL_F64 = 1e-10
LAYOUTS = {"seq22": ((2, 2), ["dense", "moe", "ssm", "hybrid", "vlm", "encdec",
                               "dense_remat", "moe_remat"], 1, 32, 1,
                     {"seq": "data", "batch": None, "zero": "data"})}


# ------------------------------------------------- (a) the pieces' backward
def _leaf(t):
    return t.detach().clone().requires_grad_()


def _grads(leaves):
    """Each leaf's gradient (zeros where the rank's loss does not reach it:
    an empty block's)."""
    return {k: v.grad if v.grad is not None else torch.zeros_like(v)
            for k, v in leaves.items()}


def _per_rank(world, total, fn):
    """[fn(SeqSplit) for every rank], each in its own thread."""
    return _ThreadWorld(world).run(lambda g: fn(SeqSplit(g, total)))


def _blocks_grad(outs, key):
    """The ranks' gradients of their blocks, concatenated in rank order."""
    return torch.cat([o[key] for o in outs], 1)


@given(total=st.integers(1, 24), world=st.integers(2, 4), seed=st.integers(0, 2 ** 16))
@settings(max_examples=25, deadline=None)
def test_seq_gather_backward_sums_every_ranks_reads(total, world, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((2, total, 3)))
    w = torch.from_numpy(rng.standard_normal((world, 2, total, 3)))

    def rank(seq):
        xb = _leaf(x[:, seq.start:seq.start + seq.count])
        (seq.gather(xb) * w[seq.group.rank]).sum().backward()
        return _grads({"x": xb})

    outs = _per_rank(world, total, rank)
    want = w.sum(0)
    assert _err(_blocks_grad(outs, "x"), want) <= RTOL_F64


@given(total=st.integers(1, 24), world=st.integers(2, 4), chunk=st.sampled_from([4, 8]),
       seed=st.integers(0, 2 ** 16))
@settings(max_examples=25, deadline=None)
def test_ssd_fold_backward_equals_the_whole_sequence(total, world, chunk, seed):
    rng = np.random.default_rng(seed)
    x, dt, A, B, C = _ssd_inputs(rng, 2, total, 3, 4, 5)
    gy = torch.from_numpy(rng.standard_normal(x.shape))
    gh = torch.from_numpy(rng.standard_normal((world, 2, 3, 4, 5)))

    def rank(seq):
        sl = slice(seq.start, seq.start + seq.count)
        leaves = {"x": _leaf(x[:, sl]), "dt": _leaf(dt[:, sl]), "A": _leaf(A),
                  "B": _leaf(B[:, sl]), "C": _leaf(C[:, sl])}
        y, h = M.ssd_split(seq, leaves["x"], leaves["dt"], leaves["A"], leaves["B"],
                           leaves["C"], chunk)
        ((y * gy[:, sl]).sum() + (h * gh[seq.group.rank]).sum()).backward()
        return _grads(leaves)

    outs = _per_rank(world, total, rank)
    whole = {"x": _leaf(x), "dt": _leaf(dt), "A": _leaf(A), "B": _leaf(B), "C": _leaf(C)}
    y, h = _recurrence(whole["x"], whole["dt"], whole["A"], whole["B"], whole["C"])
    ((y * gy).sum() + (h * gh.sum(0)).sum()).backward()
    for key in ("x", "dt", "B", "C"):
        assert _err(_blocks_grad(outs, key), whole[key].grad) <= RTOL_F64, key
    assert _err(sum(o["A"] for o in outs), whole["A"].grad) <= RTOL_F64


@given(total=st.integers(1, 24), world=st.integers(2, 4), seed=st.integers(0, 2 ** 16))
@settings(max_examples=25, deadline=None)
def test_conv_halo_backward_equals_the_whole_sequence(total, world, seed):
    """The block's conv continued from its halo, and the whole sequence's
    last W-1 raw inputs (zero-padded at the front) read under each rank's
    own weights: the halo's rows' gradients reach the ranks that hold them
    (a halo may span several short blocks and the zeros before position
    0)."""
    rng = np.random.default_rng(seed)
    width, c = 4, 3
    w1 = width - 1
    xbc = torch.from_numpy(rng.standard_normal((2, total, c)))
    cw, cb = (torch.from_numpy(rng.standard_normal(s)) for s in ((width, c), (c,)))
    go = torch.from_numpy(rng.standard_normal((2, total, c)))
    gw = torch.from_numpy(rng.standard_normal((world, 2, w1, c)))

    def rank(seq):
        sl = slice(seq.start, seq.start + seq.count)
        leaves = {"x": _leaf(xbc[:, sl]), "w": _leaf(cw), "b": _leaf(cb)}
        halo, window = M._conv_halo(seq, leaves["x"], w1)
        out = M._causal_conv_carry(leaves["w"], leaves["b"], leaves["x"], halo)
        ((out * go[:, sl]).sum() + (window * gw[seq.group.rank]).sum()).backward()
        return _grads(leaves)

    outs = _per_rank(world, total, rank)
    whole = {"x": _leaf(xbc), "w": _leaf(cw), "b": _leaf(cb)}
    out = M._causal_conv(whole["w"], whole["b"], whole["x"])
    window = torch.cat([torch.zeros(2, w1, c, dtype=xbc.dtype), whole["x"]], 1)[:, -w1:]
    ((out * go).sum() + (window * gw.sum(0)).sum()).backward()
    assert _err(_blocks_grad(outs, "x"), whole["x"].grad) <= RTOL_F64
    for key in ("w", "b"):
        assert _err(sum(o[key] for o in outs), whole[key].grad) <= RTOL_F64, key


# ------------------------------------------------------------- (b) the world
CASES = [(name, fam) for name, (_, fams, *_) in LAYOUTS.items() for fam in fams]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return run_worlds(tmp_path_factory.mktemp("train_seq"), LAYOUTS, (("seq22",),),
                      {"seq22": ["dense", "hybrid"]})


@pytest.mark.parametrize("name,fam", CASES)
def test_step1_loss_and_gradients_match_jax(name, fam, worlds):
    check_step1(worlds, name, fam, LAYOUTS)


@pytest.mark.parametrize("name,fam", CASES)
def test_params_after_three_steps_match_jax(name, fam, worlds):
    check_params(worlds, name, fam)


@pytest.mark.parametrize("name,fam", CASES)
def test_ranks_agree_bitwise(name, fam, worlds):
    check_ranks(worlds, name, fam)
