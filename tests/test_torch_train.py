"""The port's training stack against the JAX package on the CPU.

The data pipeline bit for bit; `cosine_schedule`, `global_norm`,
`clip_by_global_norm` and `adamw_update` fed the same trees (parameters,
m, v, lr and grad_norm at 1e-6 x each leaf's max |value|, step exactly);
int8 compression (ints equal, scale at 1e-7 relative); the checkpoint's
atomicity, garbage collection, async snapshot and format (each package
restores what the other wrote, leaf for leaf); the `Trainer`'s falling
loss, bitwise resume, preemption and straggler record (the counterparts of
`tests/test_fault_tolerance.py`); three port `Trainer` steps against three
JAX `Trainer` steps from the same parameters (the JAX trainer on an
Auto-typed mesh, as `tests/test_torch_serving.py` builds it); the bridge's
round trip; the config dataclasses field for field; `python -m
repro_torch.train`; and a scan of the port's sources for imports of `jax`
or `repro`.
"""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, Mesh
from jax.sharding import PartitionSpec as P

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import get_config as jax_get_config
from repro.data import pipeline as jax_pipeline
from repro.distributed.sharding import DEFAULT_RULES
from repro.launch import steps as jax_steps
from repro.models import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro.optim import compress as jax_compress
from repro.train import trainer as jax_trainer
from repro_torch.bridge import train_state_from_jax, train_state_to_numpy
from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.data import pipeline as port_pipeline
from repro_torch.distributed import DEFAULT_RULES as PORT_RULES
from repro_torch.distributed.collectives import mesh_axes
from repro_torch.launch.steps import TrainConfig
from repro_torch.models import build_model
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               clip_by_global_norm, compressed_allgather_mean,
                               cosine_schedule, global_norm, int8_compress,
                               int8_decompress)
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.tree import tree_flatten_with_paths, tree_map

ROOT = pathlib.Path(__file__).resolve().parents[1]
OPT_RTOL = 1e-6          # x each leaf's max |value|
# Three f32 Trainer steps of reduced qwen3, port against JAX (measured on
# the CPU): losses 7.1e-8 / 0 / 0 relative; m and v at most 1.3e-5 x the
# leaf's max; parameters at most 1.5e-4 x the leaf's max, from the few
# elements whose step-1 gradient is near AdamW's eps (there the update
# g / (|g| + eps) turns f32 roundoff of g into a visible step), at most
# 0.031 % of a leaf's elements beyond 1e-6 x its max.  The bounds below
# keep 3-14x margin; the element share catches an update wrong on every
# element (weight decay alone moves each by lr * wd * p ~ 5e-5 p).
TRAIN_LOSS_RTOL = 1e-6
TRAIN_MOMENT_RTOL = 1e-4
TRAIN_PARAM_RTOL = 1e-3
TRAIN_PARAM_TIGHT, TRAIN_PARAM_SHARE = 1e-6, 1e-3


def _np_tree(rng, shapes, scale=1.0):
    return {k: (_np_tree(rng, v, scale) if isinstance(v, dict)
                else (rng.standard_normal(v) * scale).astype(np.float32))
            for k, v in shapes.items()}


SHAPES = {"embed": {"emb": (11, 8)}, "blocks": {"w": (3, 8, 5), "scale": (3, 5)},
          "final_norm": {"scale": (8,)}}


def _leaf_close(got, want, rtol, key=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, key
    tol = rtol * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{key}: {err:.3e} > {tol:.3e}"


def _trees_close(got, want, rtol):
    g, w = dict(tree_flatten_with_paths(got)), dict(tree_flatten_with_paths(want))
    assert set(g) == set(w)
    for key in w:
        _leaf_close(g[key], w[key], rtol, key)


def _trees_equal(a, b):
    fa, fb = dict(tree_flatten_with_paths(a)), dict(tree_flatten_with_paths(b))
    assert set(fa) == set(fb)
    for key in fa:
        assert torch.equal(fa[key], fb[key]), key


def _auto_mesh():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"),
                axis_types=(AxisType.Auto, AxisType.Auto))


# ---------------------------------------------------------------- data
@pytest.mark.parametrize("learnable", [True, False])
@pytest.mark.parametrize("step,shard,n_shards,seed",
                         [(0, 0, 1, 0), (3, 1, 4, 0), (7, 3, 4, 5), (12, 0, 2, 2**31 - 1)])
def test_data_pipeline_bit_for_bit(learnable, step, shard, n_shards, seed):
    kw = dict(vocab=151936, seq_len=33, global_batch=8, seed=seed, learnable=learnable)
    want = jax_pipeline.SyntheticLMData(jax_pipeline.DataConfig(**kw)).batch(
        step, shard, n_shards)
    got = SyntheticLMData(DataConfig(**kw)).batch(step, shard, n_shards)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    # a shard is the global batch's slice
    whole = SyntheticLMData(DataConfig(**kw)).batch(step)
    rows = kw["global_batch"] // n_shards
    assert np.array_equal(got["tokens"], whole["tokens"][shard * rows:(shard + 1) * rows])


def test_data_pipeline_state_and_splitmix():
    x = np.arange(1000, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    assert np.array_equal(port_pipeline._splitmix(x), jax_pipeline._splitmix(x))
    data = SyntheticLMData(DataConfig(vocab=7, seq_len=4, global_batch=2, seed=3))
    state = data.state_dict(17)
    assert state == jax_pipeline.SyntheticLMData(jax_pipeline.DataConfig(
        vocab=7, seq_len=4, global_batch=2, seed=3)).state_dict(17)
    assert SyntheticLMData.restore_step(state) == 17
    with pytest.raises(ValueError, match="shards"):
        data.batch(0, 0, 3)


# ---------------------------------------------------------------- optim
@pytest.mark.parametrize("cfg", [AdamWConfig(), AdamWConfig(warmup_steps=0, total_steps=7),
                                 AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=200,
                                             min_lr_ratio=0.0)])
def test_cosine_schedule_matches(cfg):
    jcfg = jax_adamw.AdamWConfig(**dataclasses.asdict(cfg))
    for step in (0, 1, 5, 19, 20, 21, 99, 100, 101, 150, 199, 200, 5000, 10_000, 20_000):
        want = float(jax_adamw.cosine_schedule(jcfg, jnp.asarray(step, jnp.int32)))
        got = float(cosine_schedule(cfg, torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) <= 1e-6 * max(abs(want), 1e-30), (step, got, want)


@pytest.mark.parametrize("scale", [1e-3, 10.0])
def test_global_norm_and_clip_match(scale):
    tree = _np_tree(np.random.default_rng(0), SHAPES, scale)
    want_norm = float(jax_adamw.global_norm(tree))
    got_norm = float(global_norm(tree_map(torch.from_numpy, tree)))
    assert abs(got_norm - want_norm) <= 1e-6 * want_norm
    want, wn = jax_adamw.clip_by_global_norm(tree, 1.0)
    got, gn = clip_by_global_norm(tree_map(torch.from_numpy, tree), 1.0)
    assert abs(float(gn) - float(wn)) <= 1e-6 * float(wn)
    _trees_close(tree_map(lambda t: t.numpy(), got),
                 jax.tree.map(np.asarray, want), OPT_RTOL)


@pytest.mark.parametrize("step0,gscale", [(0, 0.01), (7, 3.0), (150, 0.5)])
def test_adamw_update_matches(step0, gscale):
    """The same params, gradients and moments through both updates; the
    port's writes in place and returns the same tensors."""
    rng = np.random.default_rng(step0)
    params = _np_tree(rng, SHAPES)
    grads = _np_tree(rng, SHAPES, gscale)
    m = _np_tree(rng, SHAPES, 0.01)
    v = tree_map(np.abs, _np_tree(rng, SHAPES, 1e-4))
    cfg = AdamWConfig(warmup_steps=10, total_steps=200)
    jstate = {"m": m, "v": v, "step": jnp.asarray(step0, jnp.int32)}
    wp, ws, wm = jax_adamw.adamw_update(params, grads, jstate,
                                        jax_adamw.AdamWConfig(**dataclasses.asdict(cfg)))
    tp = tree_map(lambda a: torch.from_numpy(a.copy()), params)
    tstate = {"m": tree_map(lambda a: torch.from_numpy(a.copy()), m),
              "v": tree_map(lambda a: torch.from_numpy(a.copy()), v),
              "step": torch.tensor(step0, dtype=torch.int32)}
    tg = tree_map(lambda a: torch.from_numpy(a.copy()), grads)
    tg_before = tree_map(torch.clone, tg)
    gp, gs, gm = adamw_update(tp, tg, tstate, cfg)
    assert gp is tp and gs is tstate
    _trees_equal(tg, tg_before)                       # gradients untouched
    assert gs["step"].dtype == torch.int32 and int(gs["step"]) == step0 + 1 == int(ws["step"])
    for key in ("lr", "grad_norm"):
        _leaf_close(gm[key], wm[key], OPT_RTOL, key)
    np_ = lambda t: tree_map(lambda x: x.numpy(), t)
    _trees_close(np_(gp), jax.tree.map(np.asarray, wp), OPT_RTOL)
    _trees_close(np_(gs["m"]), jax.tree.map(np.asarray, ws["m"]), OPT_RTOL)
    _trees_close(np_(gs["v"]), jax.tree.map(np.asarray, ws["v"]), OPT_RTOL)


def test_adamw_init_shapes():
    params = tree_map(torch.from_numpy, _np_tree(np.random.default_rng(1), SHAPES))
    st = adamw_init(params)
    assert st["step"].dtype == torch.int32 and st["step"].shape == ()
    for (k, p), (_, m) in zip(tree_flatten_with_paths(params),
                              tree_flatten_with_paths(st["m"])):
        assert m.shape == p.shape and m.dtype == torch.float32 and not m.any(), k


def test_int8_compression_matches():
    x = (np.random.default_rng(2).standard_normal((64, 33)) * 3).astype(np.float32)
    wq, ws = jax_compress.int8_compress(jnp.asarray(x))
    q, s = int8_compress(torch.from_numpy(x))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(wq))
    assert abs(float(s) - float(ws)) <= 1e-7 * float(ws)
    _leaf_close(int8_decompress(q, s).numpy(),
                np.asarray(jax_compress.int8_decompress(wq, ws)), 1e-7)
    # the mean over a mesh axis: an unbound name raises, as outside
    # shard_map; on a 1-wide axis it is the JAX function under shard_map
    # on one device (the wider axes: tests/test_torch_tp_train.py)
    with pytest.raises(NameError, match="pod"):
        compressed_allgather_mean(torch.from_numpy(x), "pod")
    with mesh_axes({"pod": None}):
        got = compressed_allgather_mean(torch.from_numpy(x), "pod")
    pod = Mesh(np.asarray(jax.devices()[:1]), ("pod",), axis_types=(AxisType.Explicit,))
    want = jax.shard_map(lambda a: jax_compress.compressed_allgather_mean(a, "pod"),
                         mesh=pod, in_specs=P(), out_specs=P(), check_vma=False)(jnp.asarray(x))
    assert np.array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------- checkpoint
def _state(seed=0):
    p = tree_map(torch.from_numpy, _np_tree(np.random.default_rng(seed), SHAPES))
    return {"params": p, "opt": adamw_init(p)}


def test_checkpoint_roundtrip_layout_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = _state()
    for step in (1, 2, 3):
        mgr.save(step, state, {"data": {"step": step}})
    assert sorted(os.listdir(tmp_path)) == ["step_2", "step_3"]
    assert sorted(os.listdir(tmp_path / "step_3")) == ["meta.json", "state.npz"]
    with np.load(tmp_path / "step_3" / "state.npz") as z:
        assert "params/blocks/w" in z.files and "opt/m/embed/emb" in z.files
        assert z["opt/step"].dtype == np.int32
    assert mgr.meta(3) == {"step": 3, "n_leaves": 13, "data": {"step": 3}}
    template = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), state)
    step, restored = mgr.restore_latest(template)
    assert step == 3
    _trees_equal(restored, state)
    # the template's dtype is what comes back
    half = tree_map(lambda t: t.to(torch.float64), template)
    assert mgr.restore(3, half)["params"]["blocks"]["w"].dtype == torch.float64


def test_checkpoint_atomicity(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, _state())
    # a save that dies before its commit leaves only its .tmp directory
    def die(*a, **k):
        raise OSError("disk gone")
    monkeypatch.setattr(np, "savez", die)
    with pytest.raises(OSError):
        mgr.save(8, _state())
    monkeypatch.undo()
    assert os.path.isdir(tmp_path / "step_8.tmp")
    # a directory without meta.json is not a checkpoint either
    os.makedirs(tmp_path / "step_9")
    assert latest_step(str(tmp_path)) == 4
    assert latest_step(str(tmp_path / "missing")) is None


def test_checkpoint_async_snapshots_before_returning(tmp_path):
    """save_async copies every leaf before it returns: a step that
    updates the parameters in place right after must not reach the file
    (on the CPU `.cpu()` would share the storage)."""
    mgr = CheckpointManager(str(tmp_path))
    state = _state()
    want = tree_map(torch.clone, state)
    for _ in range(5):
        mgr.save_async(1, state)
        for _, leaf in tree_flatten_with_paths(state["params"]):
            leaf.add_(1.0)
        mgr.wait()
        _trees_equal(mgr.restore(1, want), want)
        state = tree_map(torch.clone, want)


def test_checkpoint_refuses_bf16_and_missing_leaves(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    bad = {"params": {"w": torch.zeros(3, dtype=torch.bfloat16)}}
    with pytest.raises(ValueError, match="params/w"):
        mgr.save(1, bad)
    with pytest.raises(ValueError, match="params/w"):
        mgr.save_async(1, bad)
    with pytest.raises(KeyError, match="params/extra"):
        mgr.save(2, {"params": {"w": torch.zeros(3)}})
        mgr.restore(2, {"params": {"w": torch.zeros(3), "extra": torch.zeros(1)}})


def _jax_state(seed=0):
    rng = np.random.default_rng(seed)
    p = _np_tree(rng, SHAPES)
    return {"params": p, "opt": {"m": _np_tree(rng, SHAPES), "v": _np_tree(rng, SHAPES),
                                 "step": np.asarray(5, np.int32)}}


def test_checkpoint_cross_reads_with_jax(tmp_path):
    """The port restores what the JAX manager wrote and the JAX manager
    restores what the port wrote, leaf for leaf."""
    jstate = _jax_state()
    JaxCheckpointManager(str(tmp_path / "jax")).save(5, jstate)
    port = CheckpointManager(str(tmp_path / "jax"))
    template = tree_map(lambda a: torch.empty(a.shape, dtype=torch.from_numpy(a).dtype,
                                              device="meta"), jstate)
    got = train_state_to_numpy(port.restore(5, template))
    for key, want in tree_flatten_with_paths(jstate):
        assert np.array_equal(dict(tree_flatten_with_paths(got))[key], want), key

    state = train_state_from_jax(_jax_state(1))
    CheckpointManager(str(tmp_path / "port")).save(6, state, {"data": {"step": 6}})
    jm = JaxCheckpointManager(str(tmp_path / "port"))
    back = jm.restore(6, _jax_state(2))
    assert jm.meta(6)["data"] == {"step": 6}
    flat = dict(tree_flatten_with_paths(train_state_to_numpy(state)))
    for key, leaf in tree_flatten_with_paths(jax.tree.map(np.asarray, back)):
        assert leaf.dtype == flat[key].dtype and np.array_equal(leaf, flat[key]), key


def test_bridge_train_state_round_trip():
    jstate = _jax_state(3)
    state = train_state_from_jax(jstate)
    assert state["opt"]["step"].dtype == torch.int32 and state["opt"]["step"].shape == ()
    back = dict(tree_flatten_with_paths(train_state_to_numpy(state)))
    for key, want in tree_flatten_with_paths(jstate):
        assert back[key].dtype == want.dtype and np.array_equal(back[key], want), key


# -------------------------------------------------------------- trainer
def _small_cfg():
    return get_config("qwen3-1.7b").reduced(n_layers=1, d_model=64, d_ff=128, vocab=101,
                                            n_heads=2, n_kv_heads=2, head_dim=32)


def _mk_trainer(tmp_path, steps, ckpt_every=4, seq=16, batch=4, total_steps=None):
    cfg = _small_cfg()
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch))
    tc = TrainerConfig(
        steps=steps, ckpt_every=ckpt_every, ckpt_dir=str(tmp_path), log_every=1000,
        train=TrainConfig(microbatches=1, zero1=False,
                          opt=AdamWConfig(lr=1e-3, warmup_steps=2,
                                          total_steps=total_steps or steps)))
    return Trainer(build_model(cfg), None, PORT_RULES, data, tc, device="cpu")


def test_trainer_loss_decreases(tmp_path):
    tr = _mk_trainer(tmp_path, steps=12)
    step, state, info = tr.run()
    assert step == 12
    losses = [m["loss"] for m in tr.metrics_log]
    assert losses[-1] < losses[0]
    assert not info["preempted"]
    assert latest_step(str(tmp_path)) == 12


def test_trainer_resume_bitwise_equivalent(tmp_path):
    """Train 8 straight vs train 4 (checkpoint) + a fresh trainer resuming
    4: every parameter and optimizer leaf bitwise equal."""
    _, state_full, _ = _mk_trainer(tmp_path / "a", steps=8, ckpt_every=100).run()
    _mk_trainer(tmp_path / "b", steps=4, ckpt_every=4, total_steps=8).run()
    assert latest_step(str(tmp_path / "b")) == 4
    t2 = _mk_trainer(tmp_path / "b", steps=8, ckpt_every=100)
    step0, state = t2.restore_or_init()
    assert step0 == 4
    _, state_resumed, _ = t2.run(start_step=step0, state=state)
    _trees_equal(state_resumed, state_full)


def test_trainer_preemption_checkpoint_and_exit(tmp_path):
    tr = _mk_trainer(tmp_path, steps=50, ckpt_every=100)

    def trip_preemption(step, row):
        if step == 3:
            open(tr.preempt_file, "w").close()

    step, state, info = tr.run(on_step=trip_preemption)
    assert info["preempted"] and step == 3
    assert latest_step(str(tmp_path)) == 3
    assert tr.ckpt.meta(3)["preempted"] is True
    _, restored = tr.ckpt.restore_latest(tr.state_template())
    _trees_equal(restored, state)


def test_trainer_records_stragglers(tmp_path):
    tr = _mk_trainer(tmp_path, steps=10)
    orig = tr._step_fn

    def slow_step(p, o, b, _n=[0]):
        _n[0] += 1
        if _n[0] == 7:
            # injected straggler: sleep well past 3x the rolling median even
            # under CPU contention from parallel jobs
            time.sleep(max(5.0, 4.0 * float(np.median(tr.step_times[-8:]))))
        return orig(p, o, b)

    tr._step_fn = slow_step
    tr.run()
    assert 6 in tr.stragglers or 7 in tr.stragglers


def test_trainer_restore_or_init_falls_back(tmp_path):
    tr = _mk_trainer(tmp_path, steps=2)
    os.makedirs(tmp_path / "step_5")
    (tmp_path / "step_5" / "meta.json").write_text("{}")
    (tmp_path / "step_5" / "state.npz").write_bytes(b"not a zip file")
    step, state = tr.restore_or_init(seed=0)
    assert step == 0
    _trees_equal(state, tr.init_state(0))
    # the template is the model's tree of shapes, allocating nothing
    template = tr.state_template()
    assert {t.device.type for _, t in tree_flatten_with_paths(template)} == {"meta"}
    for (k, a), (_, b) in zip(tree_flatten_with_paths(template),
                              tree_flatten_with_paths(state)):
        assert a.shape == b.shape and a.dtype == b.dtype, k


def test_trainer_defaults_to_the_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _small_cfg()
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=2))
    with pytest.raises(RuntimeError, match="GPU"):
        Trainer(build_model(cfg), None, PORT_RULES, data, TrainerConfig(ckpt_dir=str(tmp_path)))


def test_three_trainer_steps_match_jax(tmp_path):
    """Reduced qwen3 in f32 (2 layers, d 128, vocab 512; seq 16, batch 4,
    2 microbatches): the port's Trainer and the JAX Trainer from the same
    initial state, one step at a time; the loss and every parameter and
    moment after each step at the TRAIN_* bounds."""
    jcfg = jax_get_config("qwen3-1.7b").reduced(dtype="float32")
    tcfg = ModelConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
    data_kw = dict(vocab=jcfg.vocab, seq_len=16, global_batch=4)
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=3)
    jtr = jax_trainer.Trainer(
        jax_build_model(jcfg), _auto_mesh(), DEFAULT_RULES,
        jax_pipeline.SyntheticLMData(jax_pipeline.DataConfig(**data_kw)),
        jax_trainer.TrainerConfig(
            steps=1, ckpt_every=100, ckpt_dir=str(tmp_path / "jax"), log_every=1000,
            train=jax_steps.TrainConfig(microbatches=2, opt=jax_adamw.AdamWConfig(**opt))))
    ttr = Trainer(build_model(tcfg), None, PORT_RULES, SyntheticLMData(DataConfig(**data_kw)),
                  TrainerConfig(steps=1, ckpt_every=100, ckpt_dir=str(tmp_path / "port"),
                                log_every=1000,
                                train=TrainConfig(microbatches=2, opt=AdamWConfig(**opt))),
                  device="cpu")
    jstate = jtr.init_state(0)
    state = train_state_from_jax(jax.tree.map(np.array, jstate))
    for i in range(3):
        jtr.cfg.steps = ttr.cfg.steps = i + 1
        _, jstate, _ = jtr.run(start_step=i, state=jstate)
        _, state, _ = ttr.run(start_step=i, state=state)
        want = jax.tree.map(np.array, jstate)
        got = train_state_to_numpy(state)
        wl, gl = jtr.metrics_log[-1]["loss"], ttr.metrics_log[-1]["loss"]
        assert abs(gl - wl) <= TRAIN_LOSS_RTOL * abs(wl), (i, gl, wl)
        assert int(got["opt"]["step"]) == int(want["opt"]["step"]) == i + 1
        _trees_close(got["params"], want["params"], TRAIN_PARAM_RTOL)
        _trees_close(got["opt"]["m"], want["opt"]["m"], TRAIN_MOMENT_RTOL)
        _trees_close(got["opt"]["v"], want["opt"]["v"], TRAIN_MOMENT_RTOL)
        want_p = dict(tree_flatten_with_paths(want["params"]))
        for key, g in tree_flatten_with_paths(got["params"]):
            w = want_p[key]
            far = np.abs(g - w) > TRAIN_PARAM_TIGHT * np.abs(w).max()
            assert far.mean() <= TRAIN_PARAM_SHARE, (i, key, far.mean())


def test_train_module_runs_and_resumes(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src")]))
    cmd = [sys.executable, "-m", "repro_torch.train", "--device", "cpu", "--d-model", "64",
           "--layers", "1", "--seq", "16", "--batch", "4", "--ckpt-dir", str(tmp_path)]
    out = subprocess.run(cmd + ["--steps", "2"], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "finished at step 2; preempted=False" in out.stdout
    out = subprocess.run(cmd + ["--steps", "3"], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "resuming from checkpoint at step 2" in out.stdout
    assert "finished at step 3" in out.stdout


# -------------------------------------------------------------- configs
def _fields(cls):
    return [(f.name, f.default if f.default is not dataclasses.MISSING
             else (f.default_factory() if f.default_factory is not dataclasses.MISSING
                   else dataclasses.MISSING)) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("port,ref", [
    (AdamWConfig, jax_adamw.AdamWConfig),
    (DataConfig, jax_pipeline.DataConfig),
    (TrainConfig, jax_steps.TrainConfig),
    (TrainerConfig, jax_trainer.TrainerConfig),
])
def test_config_fields_and_defaults_match(port, ref):
    got, want = _fields(port), _fields(ref)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        if dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        if name == "ckpt_dir":
            # the reference's /tmp/repro_ckpt under the process's temp dir
            assert b == "/tmp/repro_ckpt"
            assert a == os.path.join(tempfile.gettempdir(), "repro_ckpt")
            continue
        assert a == b, name
    assert port.__dataclass_params__.frozen == ref.__dataclass_params__.frozen


# -------------------------------------------------------------- sources
def _imported_roots(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_sources_import_neither_jax_nor_repro():
    """Every import statement of the port and of chip_smoke.py, at module
    level or inside a function."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 50
    bad = {str(f.relative_to(ROOT)): sorted(r for r in set(_imported_roots(f))
                                            if r in ("jax", "jaxlib", "repro"))
           for f in files}
    assert {f: r for f, r in bad.items() if r} == {}
    for mod in ("data/pipeline.py", "optim/adamw.py", "checkpoint/manager.py",
                "train/trainer.py", "train/__main__.py"):
        assert (ROOT / "src" / "repro_torch" / mod).exists(), mod
