"""The port's mesh, sharding rules and logical axes against the JAX
package's, entry for entry.

The default rule table, `lookup` / `spec` / `replace` / `prune_for_mesh`;
`rules_for_shape` for the ten archs x the four SHAPES x six meshes; every
family's logical-axes trees (parameters, fixed-batch cache, paged pools,
slot pools), each leaf as long as the port's parameter's ndim.  The JAX
side runs on `jax.sharding.AbstractMesh`, which needs no devices.  On the
fake process group (a world of 512 ranks, torn down after the file) the
(16, 16) and (2, 16, 16) meshes: each parameter's placements and the local
shape of a meta tensor distributed by them equal the shard shape of the
JAX spec (`NamedSharding.shard_shape`); `constrain` redistributes a
DTensor to the rules' placements.  `single_device_mesh()` in a bare
process; `tp_mesh` past the world size raising.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JaxNamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.distributed import sharding as JS
from repro.launch import mesh as jax_mesh
from repro.launch import steps as jax_steps
from repro.models import build_model as jax_build_model
from repro.models import zoo as jax_zoo
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config
from repro_torch.distributed import sharding as S
from repro_torch.launch import mesh as M
from repro_torch.launch import steps
from repro_torch.models import build_model, zoo
from repro_torch.tree import tree_flatten_with_paths

MESHES = {(1, 1): ("data", "model"), (1, 2): ("data", "model"),
          (1, 4): ("data", "model"), (1, 8): ("data", "model"),
          (16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model")}
FAKE_MESHES = ((16, 16), (2, 16, 16))
WORLD = 512
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _abstract(shape):
    return AbstractMesh(shape, MESHES[shape])


def _axes_leaves(tree, prefix=()):
    """("a/b", axes) pairs of a logical-axes tree."""
    if S.is_axes(tree):
        return [("/".join(prefix), tree)]
    out = []
    for k, v in tree.items():
        out += _axes_leaves(v, prefix + (k,))
    return out


def _tcfg(jcfg):
    return type(get_config(jcfg.name))(**{f.name: getattr(jcfg, f.name)
                                          for f in dataclasses.fields(jcfg)})


# ------------------------------------------------------------- rule tables
def test_default_rule_table_and_lookup_equal_the_reference():
    assert S.DEFAULT_RULES.rules == JS.DEFAULT_RULES.rules
    for name, _ in JS.DEFAULT_RULES.rules:
        assert S.DEFAULT_RULES.lookup(name) == JS.DEFAULT_RULES.lookup(name)
    assert S.DEFAULT_RULES.lookup(None) is None
    with pytest.raises(KeyError):
        S.DEFAULT_RULES.lookup("no_such_axis")
    with pytest.raises(KeyError):
        JS.DEFAULT_RULES.lookup("no_such_axis")


REPLACEMENTS = ({}, {"heads": None, "vocab": None}, {"embed_vec": "model"},
                {"batch": None, "seq": "data", "kv_seq": "data"},
                {"expert_ffn": "model", "new_axis": ("data", "model")})


@pytest.mark.parametrize("kw", REPLACEMENTS)
@pytest.mark.parametrize("shape", list(MESHES))
def test_replace_spec_and_prune_equal_the_reference(kw, shape):
    ours, ref = S.DEFAULT_RULES.replace(**kw), JS.DEFAULT_RULES.replace(**kw)
    assert ours.rules == ref.rules
    pruned = S.prune_for_mesh(ours, _abstract(shape))
    assert pruned.rules == JS.prune_for_mesh(ref, _abstract(shape)).rules
    logical = [("batch", "seq", "embed"), ("layers", "embed", "heads"),
               ("experts", "embed", "expert_ffn"), (None, "vocab"), ()]
    for rules, jrules in ((ours, ref), (pruned, JS.prune_for_mesh(ref, _abstract(shape)))):
        for ax in logical:
            spec = rules.spec(ax)
            assert isinstance(spec, tuple)
            assert tuple(spec) == tuple(jrules.spec(ax))
            assert tuple(S.logical_to_spec(rules, ax)) == tuple(JS.logical_to_spec(jrules, ax))


@pytest.mark.parametrize("shape", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_rules_for_shape_equal_the_reference(arch, shape):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    mesh = _abstract(shape)
    for name in SHAPES:
        ours = steps.rules_for_shape(cfg, SHAPES[name], mesh)
        ref = jax_steps.rules_for_shape(jcfg, JAX_SHAPES[name], mesh)
        assert ours.rules == ref.rules, name
        assert (S.prune_for_mesh(ours, mesh).rules
                == JS.prune_for_mesh(ref, mesh).rules), name
    assert M.mesh_axis_size(mesh, "model") == jax_mesh.mesh_axis_size(mesh, "model")
    assert M.mesh_axis_size(mesh, "pod") == jax_mesh.mesh_axis_size(mesh, "pod")


def test_batch_logical_axes_equal_the_reference():
    specs = {"tokens": np.zeros((4, 9)), "labels": np.zeros((4, 9)),
             "audio_embeds": np.zeros((4, 30, 8)), "lengths": np.zeros((4,))}
    assert steps.batch_logical_axes(specs) == jax_steps.batch_logical_axes(specs)


# ------------------------------------------------------------ logical axes
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_logical_axes_trees_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    model, jmodel = build_model(cfg), jax_build_model(jcfg)
    assert model.logical_axes() == jmodel.logical_axes()
    assert model.cache_logical_axes() == jmodel.cache_logical_axes()
    if cfg.family in ("dense", "moe", "vlm"):
        assert model.paged_cache_logical_axes() == jmodel.paged_cache_logical_axes()
        assert zoo.block_logical_axes(cfg) == jax_zoo.block_logical_axes(jcfg)
    if cfg.family == "ssm":
        assert model.slot_state_logical_axes() == jmodel.slot_state_logical_axes()

    # each leaf names every dim of the port's parameter, at a reduced size
    red = build_model(_tcfg(jcfg.reduced()))
    params = dict(tree_flatten_with_paths(red.init(torch.Generator().manual_seed(0))))
    axes = dict(_axes_leaves(red.logical_axes()))
    assert set(axes) == set(params)
    for key, ax in axes.items():
        assert len(ax) == params[key].dim(), key
    cache = dict(tree_flatten_with_paths(red.init_cache(2, 16)))
    cache_axes = dict(_axes_leaves(red.cache_logical_axes()))
    assert set(cache_axes) == set(cache)
    for key, ax in cache_axes.items():
        assert len(ax) == cache[key].dim(), key


def test_tp_mesh_raises_past_a_world_of_one():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="tp=2 needs 2 devices but the process has 1"):
        M.tp_mesh(2, device_type="cpu")
    assert not dist.is_initialized()


# ------------------------------------------------------- fake (16, 16) meshes
@pytest.fixture(scope="module")
def fake_world():
    """A fake process group of WORLD ranks (this process rank 0) and the
    two production meshes on it; destroyed after the file's tests."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=WORLD)
    meshes = {(16, 16): M.make_production_mesh(device_type="cpu"),
              (2, 16, 16): M.make_production_mesh(multi_pod=True, device_type="cpu")}
    yield meshes
    dist.destroy_process_group()
    assert not dist.is_initialized()


@functools.lru_cache(maxsize=None)
def _jax_param_shapes(jcfg):
    shapes = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    return {"/".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}


def _check_local(sharding, jax_spec, amesh, shape, label):
    assert tuple(sharding.spec) == tuple(jax_spec), label
    want = JaxNamedSharding(amesh, P(*jax_spec)).shard_shape(shape)
    local = sharding.distribute(torch.empty(shape, device="meta")).to_local().shape
    assert tuple(local) == tuple(want), label


@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("mesh_shape", FAKE_MESHES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_placements_shard_as_the_jax_spec(arch, mesh_shape, shape_name, fake_world):
    from torch.distributed.tensor import Replicate, Shard

    cfg, jcfg = get_config(arch), jax_get_config(arch)
    mesh, amesh = fake_world[mesh_shape], _abstract(mesh_shape)
    rules = S.prune_for_mesh(steps.rules_for_shape(cfg, SHAPES[shape_name], mesh), mesh)
    jrules = JS.prune_for_mesh(
        jax_steps.rules_for_shape(jcfg, JAX_SHAPES[shape_name], amesh), amesh)
    model = build_model(cfg)
    shard = dict(tree_flatten_with_paths(
        S.params_shardings(mesh, rules, model.logical_axes())))
    shapes = _jax_param_shapes(jcfg)
    assert set(shard) == set(shapes)
    for key, logical in _axes_leaves(model.logical_axes()):
        sh = shard[key]
        names = mesh.mesh_dim_names
        for axis, placement in zip(names, sh.placements):
            dims = [i for i, e in enumerate(sh.spec)
                    if e == axis or (isinstance(e, tuple) and axis in e)]
            sharded = dims and mesh.size(names.index(axis)) > 1
            assert placement == (Shard(dims[0]) if sharded else Replicate()), key
        _check_local(sh, jrules.spec(logical), amesh, shapes[key], key)

    spec = SHAPES[shape_name]
    if cfg.family in ("dense", "moe", "vlm"):
        pool = steps.paged_pool_sharding(model, mesh, rules)
        jpool = jrules.spec(jax_build_model(jcfg).paged_cache_logical_axes()["k"])
        _check_local(pool, jpool, amesh,
                     (cfg.n_layers, 1024, 16, cfg.n_kv_heads, cfg.hd), "pool")
    if cfg.family == "ssm":
        conv, ssm = steps.slot_state_shardings(model, mesh, rules)
        jax_axes = jax_build_model(jcfg).slot_state_logical_axes()
        assert tuple(conv.spec) == tuple(jrules.spec(jax_axes["conv"]))
        assert tuple(ssm.spec) == tuple(jrules.spec(jax_axes["ssm"]))
    if spec.kind == "decode" and cfg.family != "encdec":
        batch = spec.global_batch
        cache = dict(tree_flatten_with_paths(
            steps.cache_shardings(model, mesh, rules, batch, spec.seq_len)))
        meta = dict(tree_flatten_with_paths(
            model.init_cache(batch, spec.seq_len, device="meta")))
        for key, ax in _axes_leaves(model.cache_logical_axes()):
            ax = ax + (None,) * (meta[key].dim() - len(ax))
            _check_local(cache[key], jrules.spec(ax), amesh, tuple(meta[key].shape), key)


def test_batch_shardings_and_constrain_on_the_fake_mesh(fake_world):
    from torch.distributed.tensor import Replicate, Shard

    mesh = fake_world[(2, 16, 16)]
    rules = S.prune_for_mesh(S.DEFAULT_RULES, mesh)
    b = steps.make_batch_shardings(mesh, rules, {"tokens": torch.empty((64, 128))})
    assert b["tokens"].placements == (Shard(0), Shard(0), Replicate())
    assert b["tokens"].distribute(
        torch.empty((64, 128), device="meta")).to_local().shape == (2, 128)

    x = b["tokens"].distribute(torch.empty((64, 128, 32), device="meta"))
    assert S.constrain(x, ("batch", None, "heads")) is x          # no rules
    plain = torch.ones(3)
    with S.activation_rules(rules):
        assert S.constrain(plain, ("batch",)) is plain            # not a DTensor
        y = S.constrain(x, ("batch", None, "heads"))
        assert y.placements == (Shard(0), Shard(0), Shard(2))
        assert y.to_local().shape == (2, 128, 2)
        assert S.constrain(y, ("batch", None, "heads")) is y      # already laid out
    with pytest.raises(ValueError, match="order"):
        S.placements(mesh, (("data", "pod"), None))
    with pytest.raises(ValueError, match="twice"):
        S.placements(mesh, ("data", "data"))
    with pytest.raises(ValueError, match="not in the mesh"):
        S.placements(fake_world[(16, 16)], ("pod",))


def test_meshes_on_the_fake_world(fake_world):
    for shape, mesh in fake_world.items():
        assert tuple(mesh.shape) == shape
        assert tuple(mesh.mesh_dim_names) == MESHES[shape]
        for axis in ("pod", "data", "model"):
            assert (M.mesh_axis_size(mesh, axis)
                    == jax_mesh.mesh_axis_size(_abstract(shape), axis))
    tp = M.tp_mesh(4, device_type="cpu")
    assert tuple(tp.shape) == (1, 4) and tp.mesh.tolist() == [[0, 1, 2, 3]]
    with pytest.raises(ValueError, match=f"has {WORLD}"):
        M.tp_mesh(WORLD + 1, device_type="cpu")
    one = M.single_device_mesh("cpu")                 # uses the world that is up
    assert tuple(one.shape) == (1, 1) and dist.get_world_size() == WORLD
    mesh = M.make_mesh((4, 8, 16), device_type="cpu")
    assert tuple(mesh.mesh_dim_names) == ("pod", "data", "model")


SINGLE_DEVICE_SCRIPT = """
import torch.distributed as dist
from repro_torch.configs import SHAPES, get_config
from repro_torch.distributed import params_shardings, prune_for_mesh
from repro_torch.launch.mesh import single_device_mesh
from repro_torch.launch.steps import rules_for_shape
from repro_torch.models import build_model
from repro_torch.tree import tree_leaves
from torch.distributed.tensor import Replicate

assert not dist.is_initialized()
mesh = single_device_mesh("cpu")
assert dist.is_initialized() and dist.get_world_size() == 1
assert tuple(mesh.shape) == (1, 1) and tuple(mesh.mesh_dim_names) == ("data", "model")
cfg = get_config("qwen3-1.7b")
rules = prune_for_mesh(rules_for_shape(cfg, SHAPES["decode_32k"], mesh), mesh)
leaves = list(tree_leaves(params_shardings(mesh, rules, build_model(cfg).logical_axes())))
assert leaves and all(p == Replicate() for s in leaves for p in s.placements)
print("OK", len(leaves))
"""


def test_single_device_mesh_in_a_bare_process():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", SINGLE_DEVICE_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")
