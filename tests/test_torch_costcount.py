"""`repro_torch.launch.costcount.CostCounter` (the dry run's bytes accessed
and transcendentals) against XLA's `cost_analysis()` on the CPU.

  * transcendentals: each op of the table, on small shapes, equals what
    XLA counts for its `jnp` / `jax.nn` counterpart, exactly.  A backward
    op is paired with JAX's vjp, which XLA reduces to the backward's own
    work: where the aten backward recomputes from the input (silu, gelu,
    log_softmax, logsumexp, pow), the backward alone is counted; where it reads the
    forward's output (softmax, tanh, sigmoid, exp, rsqrt, sqrt), the vjp
    recomputes that output, so the forward is counted with it;
  * bytes accessed: single unfused ops (elementwise, a broadcast add, a
    conversion, `mm`, a reduction) equal XLA's "bytes accessed" exactly;
  * bytes of the conventions XLA cannot show unfused, against hand counts:
    views move nothing; a broadcast input is read once per element it
    addresses; gathers read their indices and as many source bytes as they
    write; scatters read their indices and updates and write only the rows
    they touch; `copy_` reads the source and writes the destination; an
    in-place op reads and writes the tensor it mutates; fills only write;
  * under the dry run's other dispatch modes (FlopCounterMode, the order
    `launch.dryrun.Meters` enters them in) each counter counts what it
    counts alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.launch.costcount import CostCounter


def _xla(fn, *args):
    cost = jax.jit(fn).lower(*args).compile().cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    return cost


def _count(fn, *args) -> CostCounter:
    with CostCounter() as counter:
        fn(*args)
    return counter


RNG = np.random.default_rng(0)
X = RNG.uniform(0.5, 2.0, (4, 8)).astype(np.float32)     # in every op's domain
G = RNG.standard_normal((4, 8)).astype(np.float32)

# name -> (torch op, its jnp counterpart); each takes (x, g)
OPS = {
    "exp": (torch.exp, jnp.exp),
    "expm1": (torch.expm1, jnp.expm1),
    "exp2": (torch.exp2, jnp.exp2),
    "log": (torch.log, jnp.log),
    "log1p": (torch.log1p, jnp.log1p),
    "log2": (torch.log2, jnp.log2),
    "log10": (torch.log10, jnp.log10),
    "sigmoid": (torch.sigmoid, jax.nn.sigmoid),
    "silu": (F.silu, jax.nn.silu),
    "tanh": (torch.tanh, jnp.tanh),
    "rsqrt": (torch.rsqrt, jax.lax.rsqrt),
    "sqrt": (torch.sqrt, jnp.sqrt),
    "sin": (torch.sin, jnp.sin),
    "cos": (torch.cos, jnp.cos),
    "erf": (torch.erf, jax.scipy.special.erf),
    "gelu": (F.gelu, lambda a: jax.nn.gelu(a, approximate=False)),
    "gelu_tanh": (lambda a: F.gelu(a, approximate="tanh"),
                  lambda a: jax.nn.gelu(a, approximate=True)),
    "softplus": (F.softplus, jax.nn.softplus),
    "softmax": (lambda a: torch.softmax(a, -1), lambda a: jax.nn.softmax(a, axis=-1)),
    "log_softmax": (lambda a: torch.log_softmax(a, -1),
                    lambda a: jax.nn.log_softmax(a, axis=-1)),
    "logsumexp": (lambda a: torch.logsumexp(a, -1), lambda a: jax.nn.logsumexp(a, axis=-1)),
    "pow_2": (lambda a: a ** 2, lambda a: a ** 2),
    "pow_3": (lambda a: a ** 3, lambda a: a ** 3),
    "pow_-1": (lambda a: a ** -1, lambda a: a ** -1),
    "pow_0.5": (lambda a: a ** 0.5, lambda a: a ** 0.5),
    "pow_-0.5": (lambda a: a ** -0.5, lambda a: a ** -0.5),
    "pow_1.5": (lambda a: a ** 1.5, lambda a: a ** 1.5),
    "pow_scalar_base": (lambda a: 10000.0 ** a, lambda a: 10000.0 ** a),
    "reciprocal": (torch.reciprocal, jnp.reciprocal),
}
UNARY = {k: (lambda f: (lambda a, g: f(a)))(t) for k, (t, _) in OPS.items()}
UNARY_JAX = {k: (lambda f: (lambda a, g: f(a)))(j) for k, (_, j) in OPS.items()}
# the ops that take a second tensor, as (torch, jnp) on (x, g)
BINARY = {
    "pow_tensor": (lambda a, g: a ** g, lambda a, g: a ** g),
    "softplus_backward": (lambda a, g: torch.ops.aten.softplus_backward(g, a, 1.0, 20.0),
                          lambda a, g: g * jax.nn.sigmoid(a)),
}
# backward ops: (name in OPS, whether the forward is counted with it)
BACKWARD = [("silu", False), ("gelu", False), ("gelu_tanh", False), ("log_softmax", False),
            ("logsumexp", False), ("pow_1.5", False), ("softmax", True), ("tanh", True), ("sigmoid", True),
            ("exp", True), ("rsqrt", True), ("sqrt", True)]

CASES = ([(k, UNARY[k], UNARY_JAX[k], None) for k in OPS]
         + [(k, t, j, None) for k, (t, j) in BINARY.items()]
         + [(f"{k}_backward" + ("_with_forward" if fwd else ""), OPS[k][0],
             OPS[k][1], fwd) for k, fwd in BACKWARD])


@pytest.mark.parametrize("name,torch_fn,jax_fn,with_forward", CASES,
                         ids=[c[0] for c in CASES])
def test_transcendentals_equal_xla(name, torch_fn, jax_fn, with_forward):
    x, g = torch.from_numpy(X), torch.from_numpy(G)
    if with_forward is None:
        got = _count(torch_fn, x, g)
        want = _xla(jax_fn, jnp.asarray(X), jnp.asarray(G))
    else:   # the cotangent: g's first elements in the output's shape
        def vjp(a, gg):
            out, back = jax.vjp(jax_fn, a)
            return back(gg.reshape(-1)[:out.size].reshape(out.shape))[0]

        want = _xla(vjp, jnp.asarray(X), jnp.asarray(G))
        x.requires_grad_(True)
        cot = lambda y: g.reshape(-1)[:y.numel()].reshape(y.shape)

        def forward_backward():
            y = torch_fn(x)
            return torch.autograd.grad(y, x, cot(y))

        if with_forward:
            got = _count(forward_backward)
        else:
            y = torch_fn(x)
            gy = cot(y)
            got = _count(lambda: torch.autograd.grad(y, x, gy))
    assert got.total_transcendentals() == int(want.get("transcendentals", 0)), (
        dict(got.transcendentals_by_op))


# name -> (torch op, its jnp counterpart, shapes and dtypes of its inputs)
SINGLE_OPS = {
    "add": (torch.add, jnp.add, [((4, 8), np.float32), ((4, 8), np.float32)]),
    "broadcast_add": (torch.add, jnp.add, [((4, 8), np.float32), ((8,), np.float32)]),
    "exp_bf16": (torch.exp, jnp.exp, [((4, 8), jnp.bfloat16)]),
    "to_bf16": (lambda a: a.to(torch.bfloat16), lambda a: a.astype(jnp.bfloat16),
                [((4, 8), np.float32)]),
    "mm": (torch.mm, jnp.matmul, [((4, 8), np.float32), ((8, 16), np.float32)]),
    # an unfused XLA reduce also reads its 4-byte init value; a mean fuses
    # it away, as every reduction of a real program does
    "mean": (lambda a: a.mean(-1), lambda a: a.mean(-1), [((4, 8), np.float32)]),
}


@pytest.mark.parametrize("name", list(SINGLE_OPS))
def test_single_op_bytes_equal_xla(name):
    torch_fn, jax_fn, specs = SINGLE_OPS[name]
    arrays = [jnp.asarray(RNG.standard_normal(shape), dtype) for shape, dtype in specs]
    got = _count(torch_fn, *[torch.from_numpy(np.array(a, np.float32)).to(
        torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32) for a in arrays])
    assert got.total_bytes() == int(_xla(jax_fn, *arrays)["bytes accessed"])


def test_views_move_nothing():
    x = torch.zeros(4, 8)
    got = _count(lambda: x.view(2, 16).t().unsqueeze(0).expand(3, 16, 2)[..., 1:]
                 .permute(2, 0, 1).detach().select(0, 0).reshape(3, 16))
    assert got.total_bytes() == 0 and dict(got.bytes_by_op) == {}


def test_a_broadcast_input_is_read_once_per_element():
    """(B, T, D) + bias (D,): the bias' D elements, not B T D of them,
    whether it broadcasts or is `expand`ed (stride 0) first."""
    x, bias = torch.zeros(2, 3, 8), torch.zeros(8)
    want = 2 * 3 * 8 * 4 + 8 * 4 + 2 * 3 * 8 * 4
    assert _count(torch.add, x, bias).total_bytes() == want
    assert _count(lambda: x + bias.expand_as(x)).total_bytes() == want


def test_gathers_read_indices_and_what_they_write():
    """embedding / index_select / indexing by a tensor of 5 rows of a
    (64, 8) f32 table: the int64 indices (40 B) and the 5 rows twice, read
    from the table and written (2 x 160 B), never the whole table."""
    table, idx = torch.zeros(64, 8), torch.tensor([3, 1, 4, 1, 5])
    want = 5 * 8 + 2 * 5 * 8 * 4
    assert _count(F.embedding, idx, table).total_bytes() == want
    assert _count(lambda: table.index_select(0, idx)).total_bytes() == want
    assert _count(lambda: table[idx]).total_bytes() == want


def test_scatters_write_only_the_rows_they_touch():
    """index_copy_ / index_put_ of 3 rows into a (64, 8) f32 pool: the
    int64 indices (24 B), the updates read (96 B) and the 3 rows written
    (96 B), not the pool's 2048 B."""
    pool, idx, rows = torch.zeros(64, 8), torch.tensor([1, 5, 7]), torch.ones(3, 8)
    want = 3 * 8 + 3 * 8 * 4 + 3 * 8 * 4
    assert _count(lambda: pool.index_copy_(0, idx, rows)).total_bytes() == want
    assert _count(lambda: pool.__setitem__(idx, rows)).total_bytes() == want
    assert _count(lambda: pool.index_put_((idx,), rows)).total_bytes() == want


def test_copies_in_place_ops_and_fills():
    """copy_ reads the source and writes the destination (a slice: its
    elements only); add_ reads both operands and writes the one it
    mutates; fills write their output."""
    pool, x, y = torch.zeros(64, 8), torch.ones(4, 8), torch.ones(4, 8)
    assert _count(lambda: pool[:4].copy_(x)).total_bytes() == 2 * 128
    assert _count(lambda: x.add_(y)).total_bytes() == 3 * 128
    assert _count(lambda: torch.zeros(4, 8)).total_bytes() == 128
    assert _count(lambda: x.fill_(2.0)).total_bytes() == 128
    assert _count(torch.zeros_like, x).total_bytes() == 128


def test_counts_hold_under_the_dry_runs_other_modes():
    a = torch.from_numpy(RNG.standard_normal((8, 16)).astype(np.float32)).requires_grad_()
    b = torch.from_numpy(RNG.standard_normal((16, 4)).astype(np.float32))
    step = lambda: torch.autograd.grad(torch.softmax(F.silu(a @ b), -1).sum(), a)
    alone = _count(step)
    flops_alone = FlopCounterMode(display=False)
    with flops_alone:
        step()
    flops, cost = FlopCounterMode(display=False), CostCounter()
    with flops, cost:
        step()
    assert flops.get_total_flops() == flops_alone.get_total_flops() > 0
    assert dict(cost.bytes_by_op) == dict(alone.bytes_by_op)
    assert dict(cost.transcendentals_by_op) == dict(alone.transcendentals_by_op)
    assert alone.total_transcendentals() > 0
