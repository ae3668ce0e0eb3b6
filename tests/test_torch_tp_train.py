"""Training on a mesh against the JAX package.

  * (a) tables, no processes: `zero1_axes` / `make_state_shardings` equal
    the JAX functions entry for entry for the ten configs on data 2 / 16 x
    model 1 / 2 / 16 meshes (the port's on a fake process group, JAX's on
    AbstractMesh); `tp_layout`'s cut of every family is `tp_local_params`
    position for position; `train_rules` refuses the splits the train
    step does not run; the bridge lands a JAX train state as a rank's cut;
  * (b) gloo worlds of CPU processes, one per mesh ((1, 2) and (1, 4)
    with the six families' tiny f32 configs, (2, 1) and (2, 2) with the
    dense one, 2 microbatches, a mask on the dense batch whose counts
    differ between data ranks, whisper's batch with `audio_embeds` and an
    odd vocabulary): every rank restores the JAX-initialised state from a
    checkpoint the JAX manager wrote (its cut), computes the step-1
    gradients (gathered: equal to the JAX gradients per leaf within 1e-4
    x max, the leaves read whole inside a split region named), runs three
    steps (the parameters against JAX's single-device steps in units of
    the steps' learning-rate budget, `_params_close`, which the port's
    single-device step meets too), and reports its loss / grad_norm bits
    and its replicated leaves' hashes (equal across ranks); ZeRO-1 on and off give
    the same bits; `compressed_allgather_mean` on 2 and 4 ranks equals the
    JAX function under `shard_map` (int8 payloads and scales bitwise, the
    mean within 1 ulp);
  * (c) elastic restart: a state saved at (2, 2) restores at no mesh and
    one saved at no mesh at (1, 2), each continuing within those bounds
    of an uninterrupted run; a checkpoint the JAX `Trainer` wrote on an
    Auto (2, 2) mesh restores in the (1, 2) world; the JAX manager reads
    the (2, 2) checkpoint bitwise equal to the gathered state; a PREEMPT
    file one rank sees stops every rank at the same step with one
    checkpoint; a restore that fails on one rank starts every rank from
    the seed.

The worlds start once (one module fixture, every child a script written
to tmp_path, a FileStore rendezvous, killed past CHILD_TIMEOUT_S), four
ranks at a time below the run's priority; the JAX references and a
forced-4-device JAX subprocess run while they do.
"""

import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys
import textwrap
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, AxisType, Mesh

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.distributed.sharding import prune_for_mesh as jax_prune
from repro.launch import steps as jax_steps
from repro.models import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro_torch.bridge import train_state_from_jax
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_NAMES, SHAPES, ShapeSpec, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.distributed import DEFAULT_RULES
from repro_torch.distributed import sharding as S
from repro_torch.distributed.sharding import LeafCut
from repro_torch.launch import mesh as M
from repro_torch.launch import steps
from repro_torch.launch.steps import TrainConfig
from repro_torch.models import build_model
from repro_torch.models.zoo import MetaGenerator
from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.tree import tree_flatten_with_paths, tree_map
from test_torch_tp_serving import FakeMesh, _TP
from test_torch_train import TRAIN_PARAM_SHARE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 300
GRAD_RTOL = 1e-4             # x the leaf's max |g|: tests/test_torch_train_models.py's
B, S_LEN, K = 4, 16, 2       # global batch rows, sequence, microbatches
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=4)
STEPS = 3
PARAM_LR_MAX, PARAM_LR_TIGHT = 0.1, 0.01     # x the steps' learning-rate budget
FAMILIES = {
    "dense": ("qwen3-1.7b", {}),
    "moe": ("qwen2-moe-a2.7b", {}),
    "vlm": ("qwen2-vl-2b", {}),
    "ssm": ("mamba2-2.7b", {}),
    "hybrid": ("zamba2-1.2b", {"n_layers": 2}),          # one group, one shared use
    "encdec": ("whisper-base", {"vocab": 193}),      # odd: the LM head's rows split
}
MESHES = {"1x2": ((1, 2), list(FAMILIES)), "1x4": ((1, 4), list(FAMILIES)),
          "2x1": ((2, 1), ["dense"]), "2x2": ((2, 2), ["dense"])}
# four ranks at a time; the (1, 2) world last, as it waits for the JAX
# subprocess's checkpoint
WAVES = (("1x4",), ("2x2",), ("2x1", "1x2"))
CASES = [(fam, m) for m, (_, fams) in MESHES.items() for fam in fams]
# leaves whole on a rank but read inside a split region, or held by several
# ranks: their gradients are partial sums the step must add up (module 3)
TRAP_LEAVES = {
    "dense": ["blocks/attn/q_norm/scale", "blocks/attn/k_norm/scale"],
    "moe": ["blocks/moe/router/w", "blocks/moe/shared_gate/w"],
    "vlm": ["blocks/attn/wk/w", "blocks/attn/wv/w"],
    "ssm": ["blocks/mamba/in_proj/w", "blocks/mamba/conv_w", "blocks/mamba/conv_b"],
    "hybrid": ["blocks/mamba/in_proj/w", "blocks/mamba/conv_w", "shared/attn/wk/w"],
    "encdec": ["decoder/cross_attn/wk/w", "encoder/attn/wv/w", "lm_head/w"],
}
# the Trainer runs of (c): tiny dense, the pipeline's batches
LOOP_RED = dict(n_layers=2, d_model=64, d_ff=128, vocab=96, dtype="float32")
LOOP_DATA = dict(vocab=96, seq_len=16, global_batch=4)


def _jcfg(fam):
    arch, red = FAMILIES[fam]
    return jax_get_config(arch).reduced(dtype="float32", **red)


def _tcfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def _batch_np(cfg):
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S_LEN)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S_LEN)).astype(np.int32)}
    if cfg.family == "dense":
        # the data ranks of (2, x) hold rows {0, 2} and {1, 3}: unequal counts
        mask = np.ones((B, S_LEN), np.float32)
        mask[1, 3:] = 0.0
        mask[2, :5] = 0.0
        batch["mask"] = mask
    if cfg.family == "vlm":
        batch["vision_embeds"] = (0.02 * rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model))).astype(np.float32)
    if cfg.family == "encdec":
        batch["audio_embeds"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def _auto_mesh(shape=(1, 1)):
    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), ("data", "model"),
                axis_types=(AxisType.Auto, AxisType.Auto))


# ---------------------------------------------------------- (a) the tables
@pytest.fixture(scope="module")
def fake_world():
    """A fake process group of 256 ranks (this process rank 0) and the six
    meshes on it; destroyed after the file's table tests."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
    meshes = {(d, m): M.make_mesh((d, m), device_type="cpu")
              for d in (2, 16) for m in (1, 2, 16)}
    yield meshes
    dist.destroy_process_group()


_EVAL_SHAPE = jax.eval_shape


@functools.lru_cache(maxsize=None)
def _jax_shapes(arch):
    return _EVAL_SHAPE(jax_build_model(jax_get_config(arch)).init, jax.random.PRNGKey(0))


@pytest.mark.parametrize("mesh_shape", [(d, m) for d in (2, 16) for m in (1, 2, 16)])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_zero1_axes_and_state_shardings_equal_the_reference(arch, mesh_shape, fake_world,
                                                           monkeypatch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    # the reference's make_state_shardings traces model.init each call: the
    # arch's shapes once instead
    monkeypatch.setattr(jax, "eval_shape", lambda fn, *a: _jax_shapes(arch)
                        if getattr(fn, "__name__", "") == "init" else _EVAL_SHAPE(fn, *a))
    mesh, amesh = fake_world[mesh_shape], AbstractMesh(mesh_shape, ("data", "model"))
    rules = S.prune_for_mesh(steps.rules_for_shape(cfg, SHAPES["train_4k"], mesh), mesh)
    jrules = jax_prune(jax_steps.rules_for_shape(jcfg, JAX_SHAPES["train_4k"], amesh), amesh)
    assert rules.rules == tuple((k, v) for k, v in jrules.rules)
    model, jmodel = build_model(cfg), jax_build_model(jcfg)
    # zero1_axes on the logical trees
    want = jax_steps.zero1_axes(jmodel.logical_axes(), _jax_shapes(arch), amesh, jrules)
    got = steps.zero1_axes(model.logical_axes(), model.param_shapes(), mesh, rules)
    assert dict(_axes_items(got)) == dict(_axes_items(want))
    # the NamedShardings of (params, opt_state)
    jp, jo = jax_steps.make_state_shardings(jmodel, amesh, jrules, jax_steps.TrainConfig())
    p, o = steps.make_state_shardings(model, mesh, rules, TrainConfig())
    for tree, jtree in ((p, jp), (o["m"], jo["m"]), (o["v"], jo["v"])):
        jflat = {"/".join(str(k.key) for k in path): leaf.spec for path, leaf in
                 jax.tree_util.tree_flatten_with_path(jtree)[0]}
        flat = dict(tree_flatten_with_paths(tree))
        assert set(flat) == set(jflat)
        for key, sh in flat.items():
            assert sh.spec == tuple(jflat[key]) + (None,) * (len(sh.spec) - len(jflat[key])), key
            assert sh.mesh is mesh
    assert o["step"].spec == () and tuple(jo["step"].spec) == ()
    # zero1=False keeps the parameters' layout for the moments
    _, o_off = steps.make_state_shardings(model, mesh, rules, TrainConfig(zero1=False))
    assert all(a.spec == b.spec for (_, a), (_, b) in zip(
        tree_flatten_with_paths(o_off["m"]), tree_flatten_with_paths(p)))
    assert steps.make_state_shardings(model, mesh, rules)[1] is None


def _axes_items(tree, prefix=()):
    """("a/b", axes) pairs of a logical-axes tree."""
    if S.is_axes(tree):
        return [("/".join(prefix), tree)]
    out = []
    for k, v in tree.items():
        out += _axes_items(v, prefix + (k,))
    return out


def _expected_cut(model, rules, coded, rank, tp):
    """What rank `rank` of `tp` should hold of each position-coded leaf,
    written out from the serving layout's rules: the logical axes' blocks
    ("conv_dim" replicated), then wk / wv at the KV heads
    `attention.tp_kv_heads` names where "heads" is split and "kv_heads" is
    not, mamba's in_proj columns and conv channels at `mamba.tp_columns`
    where "ssm_heads" is split, and out_proj's d_in rows in blocks where
    "conv_dim" is."""
    from repro_torch.models import attention as port_attention
    from repro_torch.models import mamba as port_mamba

    cfg, split = model.cfg, lambda a: rules.lookup(a) == "model"
    want = dict(tree_flatten_with_paths(S.local_params(
        coded, model.logical_axes(), rules.replace(conv_dim=None), {"model": tp},
        {"model": rank})))
    whole = dict(tree_flatten_with_paths(coded))
    for key in want:
        path = key.split("/")
        if path[-2:-1] in (["wk"], ["wv"]) and split("heads") and not split("kv_heads"):
            first, n = port_attention.tp_kv_heads(cfg, rules, rank, tp)
            want[key] = whole[key][..., first * cfg.hd:(first + n) * cfg.hd]
        if "mamba" in path and split("ssm_heads"):
            cols, chans = port_mamba.tp_columns(cfg, rank, tp)
            if path[-2:] == ["in_proj", "w"]:
                want[key] = whole[key].index_select(-1, cols)
            if path[-1] in ("conv_w", "conv_b"):
                want[key] = whole[key].index_select(-1, chans)
        if "mamba" in path and path[-2:] == ["out_proj", "w"] and split("conv_dim"):
            n = whole[key].shape[-2] // tp
            want[key] = whole[key][..., rank * n:(rank + 1) * n, :]
    return want


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_tp_layout_is_tp_local_params(fam, tp):
    """Each leaf encoded by its positions: `tp_local_params`' shard and
    `LeafCut.local` of the whole leaf are the cut written out from the
    rules (`_expected_cut`), on every rank; the owners cover each position
    once; `partial` exactly on the split heads' q / k norms."""
    cfg = _tcfg(_jcfg(fam))
    model = build_model(cfg)
    rules = steps.rules_for_shape(cfg, ShapeSpec("t", "train", S_LEN, B), FakeMesh(model=tp))
    shapes = model.init(torch.Generator().manual_seed(0))
    coded = tree_map(lambda t: torch.arange(t.numel(), dtype=torch.float64).reshape(t.shape),
                     shapes)
    seen = {}
    for r in range(tp):
        stub = _TP(rules, r, tp)
        layout = dict(tree_flatten_with_paths(model.tp_layout(stub)))
        local = dict(tree_flatten_with_paths(model.tp_local_params(coded, stub)))
        want = _expected_cut(model, rules, coded, r, tp)
        for key, whole in tree_flatten_with_paths(coded):
            cut = layout[key]
            assert torch.equal(local[key], want[key]), (key, r)
            assert torch.equal(cut.local(whole), want[key]), (key, r)
            assert cut.partial == (key.split("/")[-2:-1] in (["q_norm"], ["k_norm"])
                                   and rules.lookup("heads") == "model"), key
            if cut.dim is not None:
                seen.setdefault(key, []).extend(
                    cut.index[cut.owned()].tolist())
    for key, owned in seen.items():
        assert sorted(owned) == sorted(set(owned)), key        # owned once
        full = layout[key].full
        assert set(owned) == set(range(full)), key              # every position


def test_train_rules_refuse_what_the_step_does_not_run():
    cfg = get_config("qwen3-1.7b")
    mesh = FakeMesh(model=2, data=2)
    rules = steps.train_rules(steps.rules_for_shape(cfg, SHAPES["train_4k"], mesh), mesh)
    assert rules.lookup("batch") == "data" and rules.lookup("zero") == "data"
    # sequence-parallel training where the reference runs it: the batch
    # replicated (global batch 1 < 2 data ranks), "seq" over "data"
    long = steps.train_rules(
        steps.rules_for_shape(cfg, ShapeSpec("l", "train", 16_384, 1), mesh), mesh)
    assert long.lookup("seq") == "data" and long.lookup("batch") is None
    # the batch and the sequence both over "data": the reference's
    # DuplicateSpecError, a ValueError here
    both = steps.rules_for_shape(cfg, ShapeSpec("l", "train", 16_384, 16), mesh)
    with pytest.raises(ValueError, match="'batch' and 'seq'.*'data'"):
        steps.train_rules(both, mesh)
    with pytest.raises(NotImplementedError, match="'kv_seq'"):
        steps.train_rules(DEFAULT_RULES.replace(kv_seq="model"), mesh)
    with pytest.raises(NotImplementedError, match="neither the batch nor the sequence"):
        steps.train_rules(DEFAULT_RULES.replace(batch=None), mesh)
    # a pod axis: the batch over pod x data, ZeRO-1 over data
    pod = FakeMesh(model=2, data=2)
    pod.shape = {"pod": 2, "data": 2, "model": 2}
    on_pod = steps.train_rules(DEFAULT_RULES, pod)
    assert on_pod.lookup("batch") == ("pod", "data") and on_pod.lookup("zero") == "data"
    with pytest.raises(NotImplementedError, match="'pod'"):
        steps.train_rules(DEFAULT_RULES.replace(batch="data"), pod)
    # TP inside the experts (60 experts over model 8: indivisible)
    moe = get_config("qwen2-moe-a2.7b")
    tp8 = FakeMesh(model=8)
    efn = steps.train_rules(steps.rules_for_shape(moe, SHAPES["train_4k"], tp8), tp8)
    assert efn.lookup("expert_ffn") == "model" and efn.lookup("experts") is None
    # a 1-wide data axis: nothing to split, nothing refused
    assert steps.train_rules(DEFAULT_RULES, FakeMesh(model=4)).lookup("batch") == "data"


def test_bridge_lands_a_jax_state_as_a_rank_cut():
    jcfg = _jcfg("ssm")
    jmodel = jax_build_model(jcfg)
    jparams = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    jstate = {"params": jparams, "opt": jax.tree.map(np.asarray, jax_adamw.adamw_init(jparams))}
    model = build_model(_tcfg(jcfg))
    rules = steps.rules_for_shape(model.cfg, ShapeSpec("t", "train", S_LEN, B),
                                  FakeMesh(model=2))
    whole = train_state_from_jax(jstate)
    for r in range(2):
        cuts = model.tp_layout(_TP(rules, r, 2))
        got = train_state_from_jax(jstate, {"params": cuts, "opt": {
            "m": cuts, "v": cuts, "step": LeafCut()}})
        want = dict(tree_flatten_with_paths(
            model.tp_local_params(whole["params"], _TP(rules, r, 2))))
        for k, a in tree_flatten_with_paths(got["params"]):
            assert torch.equal(a, want[k]), k
        assert got["opt"]["step"].dtype == torch.int32


# ------------------------------------------------------------- the worlds
_CHILD = textwrap.dedent("""
    import hashlib, json, os, sys, time
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import latest_step
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.distributed.collectives import mesh_axes
    from repro_torch.launch.mesh import init_file_world, make_mesh
    from repro_torch.launch.steps import (TrainConfig, gather_state, mesh_train_step,
                                          rules_for_shape)
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, compressed_allgather_mean, int8_compress
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.tree import tree_flatten_with_paths, tree_map

    rank, world, store, job_path, out_path = sys.argv[1:6]
    rank, world = int(rank), int(world)
    job = json.load(open(job_path))
    init_file_world(store, rank, world)
    mesh = make_mesh(tuple(job["shape"]), device_type="cpu")
    tmp = job["tmp"]
    res = {}

    def sha(t):
        return hashlib.sha256(t.detach().contiguous().numpy().tobytes()).hexdigest()

    def flat_np(tree):
        return {k: v.detach().numpy() for k, v in tree_flatten_with_paths(tree)}

    def template_of(model):
        from repro_torch.models.zoo import MetaGenerator
        from repro_torch.optim import adamw_init
        p = model.init(MetaGenerator())
        return {"params": p, "opt": adamw_init(p)}

    for fam in job["families"]:
        spec = job["models"][fam]
        cfg = get_config(spec["arch"]).reduced(**spec["red"])
        model = build_model(cfg)
        batch = {k: torch.from_numpy(v) for k, v in np.load(spec["batch"]).items()}
        rules = rules_for_shape(cfg, ShapeSpec("t", "train", job["seq"], job["rows"]), mesh)
        out = res[fam] = {}
        for zero1 in job["zero1"]:
            tcfg = TrainConfig(microbatches=job["k"], zero1=zero1,
                               opt=AdamWConfig(**job["opt"]))
            step = mesh_train_step(model, mesh, rules, tcfg)
            lay = step.layouts
            state = CheckpointManager(spec["init"]).restore(0, template_of(model), lay)
            run = out[str(zero1)] = {}
            if zero1 == job["zero1"][0]:
                loss, _, grads = step.grads(state["params"], batch)
                g = gather_state(model, grads, lay["params"], step.rank_mesh)
                run["g1_loss"] = float(loss).hex()
                if rank == 0:
                    np.savez(os.path.join(tmp, f"g1_{job['name']}_{fam}.npz"), **flat_np(g))
            losses, norms = [], []
            for i in range(job["steps"]):
                state["params"], state["opt"], met = step(state["params"], state["opt"],
                                                          batch)
                losses.append(float(met["loss"]).hex())
                norms.append(float(met["grad_norm"]).hex())
            run["losses"], run["norms"] = losses, norms
            cuts = dict(tree_flatten_with_paths(lay["params"]))
            run["replicated"] = {k: sha(t) for k, t in tree_flatten_with_paths(state["params"])
                                 if cuts[k].dim is None}
            full = gather_state(model, state, lay, step.rank_mesh)
            run["full"] = {k: sha(t) for k, t in tree_flatten_with_paths(full)}
            if rank == 0 and zero1 == job["zero1"][0]:
                np.savez(os.path.join(tmp, f"p3_{job['name']}_{fam}.npz"),
                         **flat_np(full["params"]))

    if job.get("compress"):
        x = np.random.default_rng(100 + rank).standard_normal((64, 33)).astype(np.float32) * 3
        with mesh_axes(step.rank_mesh.axes):
            mean = compressed_allgather_mean(torch.from_numpy(x), "model")
            grp = step.rank_mesh.axes["model"]
            q, s = int8_compress(torch.from_numpy(x))
            qs, ss = grp._gather(q), grp._gather(s.reshape(1))
        if rank == 0:
            np.savez(os.path.join(tmp, f"compress_{job['name']}.npz"), mean=mean.numpy(),
                     qs=qs.numpy(), ss=ss.numpy())

    def loop_trainer(ckpt_dir, steps, ckpt_every, preempt_file=None):
        cfg = get_config("qwen3-1.7b").reduced(**job["loop_red"])
        data = SyntheticLMData(DataConfig(**job["loop_data"]))
        rules = rules_for_shape(cfg, ShapeSpec("t", "train", job["loop_data"]["seq_len"],
                                               job["loop_data"]["global_batch"]), mesh)
        return Trainer(build_model(cfg), mesh, rules, data, TrainerConfig(
            steps=steps, ckpt_every=ckpt_every, ckpt_dir=ckpt_dir, log_every=1000,
            preempt_file=preempt_file,
            train=TrainConfig(microbatches=2, opt=AdamWConfig(**job["opt"]))))

    if job["name"] == "2x2":
        # saved here at step 2 (checkpoint), run on to 4 uninterrupted
        tr = loop_trainer(os.path.join(tmp, "ckpt_2x2"), 4, 2)
        held = {}

        def at(step, row):
            if step == 2:
                held["s2"] = tr.full_state(state_ref[0])

        state_ref = [None]
        start, st = tr.restore_or_init()
        state_ref[0] = st
        _, st, _ = tr.run(start_step=start, state=st, on_step=at)
        full4 = tr.full_state(st)
        if rank == 0:
            np.savez(os.path.join(tmp, "loop_2x2_s2.npz"), **flat_np(held["s2"]))
            np.savez(os.path.join(tmp, "loop_2x2_s4.npz"), **flat_np(full4))
        # a PREEMPT file only rank 1 sees
        pre = loop_trainer(os.path.join(tmp, "ckpt_preempt"), 6, 100,
                           preempt_file=os.path.join(tmp, f"PREEMPT_{rank}"))

        def trip(step, row):
            if step == 2 and rank == 1:
                open(pre.preempt_file, "w").close()

        stop, _, info = pre.run(on_step=trip)
        res["preempt"] = {"step": stop, "preempted": info["preempted"],
                          "latest": latest_step(os.path.join(tmp, "ckpt_preempt"))}
        # a restore that raises on rank 1 only (the others restore step 4)
        bad = loop_trainer(os.path.join(tmp, "ckpt_2x2"), 4, 100)
        if rank == 1:
            def unreadable(*args, **kwargs):
                raise OSError("unreadable checkpoint")

            bad.ckpt.restore = unreadable
        start_b, st_b = bad.restore_or_init()
        res["restore_fault"] = {
            "step": start_b,
            "state": {k: sha(t) for k, t in tree_flatten_with_paths(bad.full_state(st_b))},
            "seed": {k: sha(t) for k, t in tree_flatten_with_paths(
                bad.full_state(bad.init_state(0)))}}

    if job["name"] == "1x2":
        # resumed here from the no-mesh checkpoint of step 2, run on to 4
        tr = loop_trainer(os.path.join(tmp, "ckpt_nomesh"), 4, 100)
        start, st = tr.restore_or_init()
        res["resumed_at"] = start
        _, st, _ = tr.run(start_step=start, state=st)
        full = tr.full_state(st)
        if rank == 0:
            np.savez(os.path.join(tmp, "loop_1x2_s4.npz"), **flat_np(full))
        # the JAX Trainer's checkpoint from an Auto (2, 2) mesh
        jdir = os.path.join(tmp, "ckpt_jax")
        t0 = time.time()
        while latest_step(jdir) is None and time.time() - t0 < 240:
            time.sleep(0.5)
        jt = loop_trainer(jdir, 4, 100)
        step_j, st = jt.restore_or_init()
        res["jax_step"] = step_j
        full = jt.full_state(st)
        if rank == 0:
            np.savez(os.path.join(tmp, "jax_restored.npz"), **flat_np(full))

    json.dump(res, open(out_path, "w"))
""")

_JAX_SUB = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, Mesh, PartitionSpec as P
    from repro.configs import get_config
    from repro.data import DataConfig, SyntheticLMData
    from repro.distributed.sharding import DEFAULT_RULES
    from repro.launch.steps import TrainConfig
    from repro.models import build_model
    from repro.optim import AdamWConfig
    from repro.optim.compress import compressed_allgather_mean, int8_compress
    from repro.train.trainer import Trainer, TrainerConfig

    job = json.load(open(sys.argv[1]))
    tmp = job["tmp"]
    for n in (2, 4):
        mesh = Mesh(np.asarray(jax.devices()[:n]), ("model",),
                    axis_types=(AxisType.Explicit,))
        xs = np.stack([np.random.default_rng(100 + r).standard_normal((64, 33)).astype(
            np.float32) * 3 for r in range(n)])
        f = jax.shard_map(lambda a: compressed_allgather_mean(a[0], "model")[None],
                          mesh=mesh, in_specs=P("model"), out_specs=P("model"),
                          check_vma=False)
        mean = np.asarray(f(jnp.asarray(xs)))[0]
        qs, ss = zip(*[int8_compress(jnp.asarray(x)) for x in xs])
        np.savez(os.path.join(tmp, f"jax_compress_{n}.npz"), mean=mean,
                 qs=np.stack([np.asarray(q) for q in qs]),
                 ss=np.stack([np.asarray(s) for s in ss]))
    cfg = get_config("qwen3-1.7b").reduced(**job["loop_red"])
    mesh = Mesh(np.asarray(jax.devices()).reshape(2, 2), ("data", "model"),
                axis_types=(AxisType.Auto, AxisType.Auto))
    tr = Trainer(build_model(cfg), mesh, DEFAULT_RULES, SyntheticLMData(
        DataConfig(**job["loop_data"])), TrainerConfig(
            steps=2, ckpt_every=2, ckpt_dir=os.path.join(tmp, "ckpt_jax"), log_every=1000,
            train=TrainConfig(microbatches=2, opt=AdamWConfig(**job["opt"]))))
    tr.run()
    print("JAX_DONE")
""")


def _nice():
    """The command prefix that runs a child below the test run's own
    priority (the tier-1 run's other workers share the machine); none
    where `nice` is missing."""
    return ["nice", "-n", "10"] if shutil.which("nice") else []


def _launch(tmp, name, shape, fams, extra):
    """Start one world's ranks; -> [(rank, out path, Popen)]."""
    job = {"name": name, "shape": list(shape), "families": fams, "tmp": str(tmp),
           "seq": S_LEN, "rows": B, "k": K, "steps": STEPS, "opt": OPT,
           "zero1": [True, False] if shape[0] > 1 else [True],
           "compress": shape[0] == 1, "loop_red": LOOP_RED, "loop_data": LOOP_DATA,
           **extra}
    job_path = tmp / f"job_{name}.json"
    job_path.write_text(json.dumps(job))
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "OMP_NUM_THREADS": "1"}
    world = int(np.prod(shape))
    procs = []
    for r in range(world):
        out = tmp / f"out_{name}.{r}.json"
        procs.append((r, out, subprocess.Popen(
            [*_nice(), sys.executable, str(tmp / "child.py"), str(r), str(world),
             str(tmp / f"store_{name}"), str(job_path), str(out)], env=env, cwd=str(tmp),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    return procs


def _jax_reference(fam, tmp, params):
    """The JAX side of one family on one device: the step-1 gradients (the
    microbatches' mean, as `jit_train_step` accumulates them) and the
    parameters after STEPS steps of that accumulation and
    `optim.adamw_update` from the JAX-initialised `params` (the children's
    checkpoint of step 0).  The forward is compiled without remat (the
    same values; the port's children run the config's)."""
    jcfg = dataclasses.replace(_jcfg(fam), remat="none")
    model = jax_build_model(jcfg)
    batch = {k: jnp.asarray(v) for k, v in np.load(tmp / f"batch_{fam}.npz").items()}
    ocfg = jax_adamw.AdamWConfig(**OPT)
    vg = jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b)[0]))
    update = jax.jit(lambda p, g, o: jax_adamw.adamw_update(p, g, o, ocfg)[:2])
    n = B // K

    def grads_of(p):
        parts = [vg(p, {k: v[i * n:(i + 1) * n] for k, v in batch.items()})
                 for i in range(K)]
        return (sum(float(l) for l, _ in parts) / K,
                jax.tree.map(lambda *g: sum(g) / K, *[g for _, g in parts]))

    with _auto_mesh():
        opt = jax_adamw.adamw_init(params)
        loss, grads = grads_of(params)
        p, o, g = params, opt, grads
        for i in range(STEPS):
            p, o = update(p, g, o)
            if i + 1 < STEPS:
                g = grads_of(p)[1]
    flat = lambda t: {"/".join(str(k.key) for k in path): np.asarray(v)
                      for path, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    return {"loss": loss, "grads": flat(grads), "params3": flat(p)}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_train")
    (tmp / "child.py").write_text(_CHILD)
    models, inits = {}, {}
    for fam in FAMILIES:
        jcfg = _jcfg(fam)
        np.savez(tmp / f"batch_{fam}.npz", **_batch_np(jcfg))
        jmodel = jax_build_model(jcfg)
        params = inits[fam] = jmodel.init(jax.random.PRNGKey(0))
        JaxCheckpointManager(str(tmp / f"init_{fam}")).save(
            0, {"params": params, "opt": jax_adamw.adamw_init(params)})
        models[fam] = {"arch": FAMILIES[fam][0],
                       "red": dict(dtype="float32", **FAMILIES[fam][1]),
                       "batch": str(tmp / f"batch_{fam}.npz"),
                       "init": str(tmp / f"init_{fam}")}
    # the no-mesh run saves step 2 before the worlds start; it runs on
    # to step 4 while they do (the uninterrupted run of (c))
    nomesh = _loop_trainer(tmp / "ckpt_nomesh", 2, 2)
    _, st_nomesh, _ = nomesh.run()
    nomesh.ckpt = CheckpointManager(str(tmp / "ckpt_nomesh_on"))
    job = tmp / "jax_job.json"
    job.write_text(json.dumps({"tmp": str(tmp), "loop_red": LOOP_RED,
                               "loop_data": LOOP_DATA, "opt": OPT}))
    jsub = subprocess.Popen([*_nice(), sys.executable, "-c", _JAX_SUB, str(job)],
                            env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
                                 "JAX_PLATFORMS": "cpu"},
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs, failures, stop = {}, [], threading.Event()

    def run_waves():
        # a few ranks at a time: the tier-1 run shares the machine
        for wave in WAVES:
            if stop.is_set():
                return
            for name in wave:
                shape, fams = MESHES[name]
                procs[name] = _launch(tmp, name, shape, fams, {"models": models})
            for name in wave:
                for r, _, p in procs[name]:
                    try:
                        _, err = p.communicate(timeout=CHILD_TIMEOUT_S)
                    except subprocess.TimeoutExpired:
                        failures.append(f"world {name} rank {r}: timed out")
                        stop.set()
                        return
                    if p.returncode != 0:
                        failures.append(f"world {name} rank {r}: rc {p.returncode}\n"
                                        f"{err[-3000:]}")

    waves = threading.Thread(target=run_waves)
    waves.start()
    try:
        refs = {fam: _jax_reference(fam, tmp, inits[fam]) for fam in FAMILIES}
        single = {fam: _port_single(fam, tmp) for fam in FAMILIES}
        nomesh.cfg.steps = 4
        _, st_nomesh, _ = nomesh.run(start_step=2, state=st_nomesh)
        waves.join()
        jout, jerr = jsub.communicate(timeout=CHILD_TIMEOUT_S)
        if "JAX_DONE" not in jout:
            failures.append(f"JAX subprocess: rc {jsub.returncode}\n{jerr[-3000:]}")
    finally:
        stop.set()
        for p in [p for ps in list(procs.values()) for _, _, p in ps] + [jsub]:
            if p.poll() is None:
                p.kill()
                p.wait()
        waves.join()
    assert not failures, "\n".join(failures)
    assert set(procs) == set(MESHES)
    outs = {name: [json.loads(out.read_text()) for _, out, _ in ps]
            for name, ps in procs.items()}
    return {"tmp": tmp, "outs": outs, "refs": refs, "single": single, "nomesh4": st_nomesh}


def _port_single(fam, tmp):
    """The port's single-device step: STEPS steps from the children's
    initial state -> {leaf: parameters}."""
    model = build_model(_tcfg(_jcfg(fam)))
    shapes = model.init(MetaGenerator())
    state = CheckpointManager(str(tmp / f"init_{fam}")).restore(
        0, {"params": shapes, "opt": adamw_init(shapes)})
    batch = {k: torch.from_numpy(v) for k, v in np.load(tmp / f"batch_{fam}.npz").items()}
    step = steps.make_train_step(model, TrainConfig(microbatches=K, opt=AdamWConfig(**OPT)),
                                 DEFAULT_RULES)
    for _ in range(STEPS):
        state["params"], state["opt"], _ = step(state["params"], state["opt"], batch)
    return {k: t.numpy() for k, t in tree_flatten_with_paths(state["params"])}


def _loop_trainer(ckpt_dir, steps, ckpt_every):
    cfg = get_config("qwen3-1.7b").reduced(**LOOP_RED)
    return Trainer(build_model(cfg), None, DEFAULT_RULES,
                   SyntheticLMData(DataConfig(**LOOP_DATA)),
                   TrainerConfig(steps=steps, ckpt_every=ckpt_every, ckpt_dir=str(ckpt_dir),
                                 log_every=1000,
                                 train=TrainConfig(microbatches=2, opt=AdamWConfig(**OPT))),
                   device="cpu")


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _lr_budget(steps_run, first=0):
    """The sum of the learning rates of steps first+1 .. steps_run: how far
    AdamW can move an element (|update| <= ~1 a step)."""
    cfg = AdamWConfig(**OPT)
    return sum(float(cosine_schedule(cfg, t)) for t in range(first + 1, steps_run + 1))


def _params_close(got, want, budget, label):
    """Parameters after AdamW steps against a reference, in units of the
    steps' learning-rate budget (`_lr_budget`): every element within
    PARAM_LR_MAX of it, at most TRAIN_PARAM_SHARE (PR 25's share) of a
    leaf's elements past PARAM_LR_TIGHT of it.  A wrong update moves most
    elements by ~the budget; f32 roundoff of the gradients, divided by
    AdamW's eps where a gradient is near zero, moved the worst element by
    0.039 of it on the CPU (the single-device port against JAX: 0.035).
    PR 25's bounds (x each leaf's max |value|) are not met here by the
    single-device port either: zero-initialised biases have a max of
    ~2e-3 after three steps."""
    assert set(got) == set(want), label
    for key, w in want.items():
        d = np.abs(got[key] - w)
        assert float(d.max()) <= PARAM_LR_MAX * budget, (label, key, float(d.max()) / budget)
        far = (d > PARAM_LR_TIGHT * budget).mean()
        assert far <= TRAIN_PARAM_SHARE, (label, key, far)


# ---------------------------------------------------- (b) the differentials
@pytest.mark.parametrize("fam,mesh", CASES)
def test_step1_gradients_match_jax(fam, mesh, worlds):
    ref = worlds["refs"][fam]
    got = _npz(worlds["tmp"] / f"g1_{mesh}_{fam}.npz")
    want = ref["grads"]
    assert set(got) == set(want)
    for key, w in want.items():
        tol = GRAD_RTOL * max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[key] - w).max())
        assert err <= tol, f"{key}: max |dg| {err:.3e} > {tol:.3e}"
    for key in TRAP_LEAVES[fam]:
        # named: a leaf whose gradient is a partial on each rank
        w = want[key]
        assert float(np.abs(got[key] - w).max()) <= GRAD_RTOL * float(np.abs(w).max()), key
    loss = float.fromhex(worlds["outs"][mesh][0][fam]["True"]["g1_loss"])
    assert abs(loss - ref["loss"]) <= 1e-5 * abs(ref["loss"])


@pytest.mark.parametrize("fam,mesh", CASES)
def test_params_after_three_steps_match_jax(fam, mesh, worlds):
    """The gathered parameters after STEPS steps against the JAX step (see
    `_params_close`); the port's single-device step meets the same
    bounds."""
    want, budget = worlds["refs"][fam]["params3"], _lr_budget(STEPS)
    _params_close(_npz(worlds["tmp"] / f"p3_{mesh}_{fam}.npz"), want, budget, f"{fam} {mesh}")
    _params_close(worlds["single"][fam], want, budget, f"{fam} one device")


@pytest.mark.parametrize("fam,mesh", CASES)
def test_ranks_agree_bitwise(fam, mesh, worlds):
    """Loss and grad_norm of every step, the gathered state and every
    replicated leaf: the same bits on every rank."""
    runs = [out[fam]["True"] for out in worlds["outs"][mesh]]
    for key in ("g1_loss", "losses", "norms", "replicated", "full"):
        assert all(r[key] == runs[0][key] for r in runs), key
    assert runs[0]["replicated"], "no replicated leaf"


@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
def test_zero1_on_equals_off_bitwise(mesh, worlds):
    for out in worlds["outs"][mesh]:
        on, off = out["dense"]["True"], out["dense"]["False"]
        assert on["losses"] == off["losses"] and on["norms"] == off["norms"]
        assert {k: v for k, v in on["full"].items() if k.startswith("params/")} == \
            {k: v for k, v in off["full"].items() if k.startswith("params/")}


@pytest.mark.parametrize("mesh,n", [("1x2", 2), ("1x4", 4)])
def test_compressed_allgather_mean_matches_shard_map(mesh, n, worlds):
    got = _npz(worlds["tmp"] / f"compress_{mesh}.npz")
    want = _npz(worlds["tmp"] / f"jax_compress_{n}.npz")
    assert np.array_equal(got["qs"], want["qs"])               # int8 on the wire
    assert np.array_equal(got["ss"].reshape(-1), want["ss"].reshape(-1))
    ulp = np.spacing(np.abs(want["mean"]).astype(np.float32))
    assert np.all(np.abs(got["mean"] - want["mean"]) <= ulp)


# ------------------------------------------------------ (c) elastic restart
def test_state_saved_at_2x2_restores_at_no_mesh(worlds, tmp_path):
    tmp = worlds["tmp"]
    tr = _loop_trainer(tmp / "ckpt_2x2", 4, 100)
    s2 = tr.ckpt.restore(2, tr.state_template(), "cpu")
    held = _npz(tmp / "loop_2x2_s2.npz")
    for key, t in tree_flatten_with_paths(s2):
        assert np.array_equal(t.numpy(), held[key]), key
    resumed = _loop_trainer(tmp_path, 4, 100)
    _, st, _ = resumed.run(start_step=2, state=s2)
    want = _npz(tmp / "loop_2x2_s4.npz")
    got = {k: t.numpy() for k, t in tree_flatten_with_paths(st)}
    _params_close({k: v for k, v in got.items() if k.startswith("params/")},
                  {k: v for k, v in want.items() if k.startswith("params/")},
                  _lr_budget(4), "2x2 -> none")


def test_state_saved_at_no_mesh_restores_at_1x2(worlds):
    outs = worlds["outs"]["1x2"]
    assert all(o["resumed_at"] == 2 for o in outs)
    got = _npz(worlds["tmp"] / "loop_1x2_s4.npz")
    want = {k: t.numpy() for k, t in tree_flatten_with_paths(worlds["nomesh4"])}
    _params_close({k: v for k, v in got.items() if k.startswith("params/")},
                  {k: v for k, v in want.items() if k.startswith("params/")},
                  _lr_budget(4), "none -> 1x2")
    assert int(got["opt/step"]) == int(want["opt/step"]) == 4


def test_jax_checkpoint_from_an_auto_2x2_mesh_restores_at_1x2(worlds):
    assert all(o["jax_step"] == 2 for o in worlds["outs"]["1x2"])
    jm = JaxCheckpointManager(str(worlds["tmp"] / "ckpt_jax"))
    with np.load(worlds["tmp"] / "ckpt_jax" / "step_2" / "state.npz") as z:
        saved = {k: z[k] for k in z.files}
    got = _npz(worlds["tmp"] / "jax_restored.npz")
    assert set(got) == set(saved) and jm.meta(2)["step"] == 2
    for key, want in saved.items():
        assert got[key].dtype == want.dtype and np.array_equal(got[key], want), key


def test_port_checkpoint_at_2x2_reads_in_jax_bitwise(worlds):
    tmp = worlds["tmp"]
    held = _npz(tmp / "loop_2x2_s2.npz")
    like = {}
    for key, v in held.items():
        node = like
        *parts, last = key.split("/")
        for p in parts:
            node = node.setdefault(p, {})
        node[last] = np.zeros_like(v)
    back = JaxCheckpointManager(str(tmp / "ckpt_2x2")).restore(2, like)
    for path, leaf in jax.tree_util.tree_flatten_with_path(back)[0]:
        key = "/".join(str(k.key) for k in path)
        assert np.array_equal(np.asarray(leaf), held[key]), key


def test_restore_failing_on_one_rank_starts_every_rank_from_the_seed(worlds):
    """Rank 1's restore raises, ranks 0, 2 and 3 restore step 4: every rank
    starts at step 0 from the seed's state, none runs on from step 4."""
    outs = [o["restore_fault"] for o in worlds["outs"]["2x2"]]
    assert [o["step"] for o in outs] == [0, 0, 0, 0]
    assert all(o["state"] == outs[0]["seed"] for o in outs)


def test_preempt_seen_by_one_rank_stops_every_rank(worlds):
    outs = [o["preempt"] for o in worlds["outs"]["2x2"]]
    assert all(o == {"step": 2, "preempted": True, "latest": 2} for o in outs), outs
    ckpt = worlds["tmp"] / "ckpt_preempt"
    assert sorted(os.listdir(ckpt)) == ["step_2"]
    assert json.loads((ckpt / "step_2" / "meta.json").read_text())["preempted"] is True
