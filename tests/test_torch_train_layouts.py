"""The training layouts of the production meshes against the JAX package:
a "pod" axis wider than 1 and TP inside the experts.

  * (a) rules, no processes: the reference's `jit_train_step` lowers the
    batch and the sequence both over "data" to a DuplicateSpecError, and
    the port's `train_rules` raises ValueError naming both axes;
  * (b) gloo worlds of CPU processes, one per mesh, at tiny f32 configs
    with 2 microbatches: (pod 2, data 2, model 1) and (pod 2, data 1,
    model 2) for the dense and moe families (the batch over pod x data,
    ranked pod-major; ZeRO-1 over "data"), and (data 1, model 4) with 6
    experts, which model 4 does not divide ("expert_ffn" over "model": each
    rank holds its quarter of every expert's width).  Every rank restores
    the JAX-initialised state from a checkpoint the JAX manager wrote (its
    cut), computes the step-1 gradients (gathered: against
    `jax.value_and_grad` per leaf within 1e-4 x max), runs three steps (the
    parameters against JAX's single-device steps in units of the
    learning-rate budget) and reports its loss / grad_norm bits and its
    replicated leaves' hashes (equal across ranks).  A JAX subprocess on
    8 forced host devices runs the reference's `jit_train_step` on each
    layout's Auto-typed mesh (one family a layout, `JAX_MESH_CASES`): its
    step-1 loss equals the single-device one, so the reference runs what
    the port is held to.

`tests/test_torch_train_seq.py` holds the sequence-parallel worlds; both
files share this one's child script and references.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import steps
from test_torch_tp_serving import FakeMesh
from test_torch_tp_train import (GRAD_RTOL, OPT, STEPS, _auto_mesh, _lr_budget, _nice,
                                 _npz, _params_close)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 300
FAMILIES = {
    "dense": ("qwen3-1.7b", {}),
    "moe": ("qwen2-moe-a2.7b", {}),
    "moe6": ("qwen2-moe-a2.7b", {"n_experts": 6}),      # 6 % 4: "expert_ffn"
    "vlm": ("qwen2-vl-2b", {}),
    "ssm": ("mamba2-2.7b", {}),
    "hybrid": ("zamba2-1.2b", {"n_layers": 2}),          # one group, one shared use
    "encdec": ("whisper-base", {"vocab": 193}),
    # remat "full": the block's gathers (K / V, the MoE's queue offsets)
    # run again as collectives in the backward's recompute
    "dense_remat": ("qwen3-1.7b", {"remat": "full"}),
    "moe_remat": ("qwen2-moe-a2.7b", {"remat": "full"}),
}
# world name -> (mesh shape, families, global batch, sequence, microbatches,
# the rules each rank must run: logical axis -> mesh axes)
LAYOUTS = {
    "pod221": ((2, 2, 1), ["dense", "moe"], 8, 16, 2,
               {"batch": ("pod", "data"), "zero": "data", "seq": None}),
    "pod212": ((2, 1, 2), ["dense", "moe"], 8, 16, 2,
               {"batch": ("pod", "data"), "zero": "data", "seq": None}),
    "efn14": ((1, 4), ["moe6"], 4, 16, 2,
              {"batch": "data", "expert_ffn": "model", "experts": None}),
}
WAVES = (("pod221",), ("pod212", "efn14"))
# the cases the JAX subprocess also runs on the layout's Auto mesh (one a
# layout: each compile of a sharded step costs seconds of the tier-1 run)
JAX_MESH_CASES = {"pod221": ["dense"], "pod212": ["moe"], "efn14": ["moe6"]}


def _jcfg(fam):
    arch, red = FAMILIES[fam]
    return jax_get_config(arch).reduced(dtype="float32", **red)


def _batch_np(cfg, b, s, seed=7):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    mask = np.ones((b, s), np.float32)
    mask[:, :3] = 0.0                                   # counts differ between blocks
    mask[b - 1, s // 2:] = 0.0                          # and between rows
    batch["mask"] = mask
    if cfg.family == "vlm":
        batch["vision_embeds"] = (0.02 * rng.standard_normal(
            (b, cfg.n_vision_tokens, cfg.d_model))).astype(np.float32)
    if cfg.family == "encdec":
        batch["audio_embeds"] = rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


CHILD = textwrap.dedent("""
    import hashlib, json, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch.mesh import init_file_world, make_mesh
    from repro_torch.launch.steps import (TrainConfig, gather_state, mesh_train_step,
                                          rules_for_shape)
    from repro_torch.models import build_model
    from repro_torch.models.zoo import MetaGenerator
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.tree import tree_flatten_with_paths

    rank, world, store, job_path, out_path = sys.argv[1:6]
    rank, world = int(rank), int(world)
    job = json.load(open(job_path))
    init_file_world(store, rank, world)
    mesh = make_mesh(tuple(job["shape"]), device_type="cpu")
    tmp, res = job["tmp"], {}

    def sha(t):
        return hashlib.sha256(t.detach().contiguous().numpy().tobytes()).hexdigest()

    def flat_np(tree):
        return {k: v.detach().numpy() for k, v in tree_flatten_with_paths(tree)}

    for fam in job["families"]:
        spec = job["models"][fam]
        cfg = get_config(spec["arch"]).reduced(**spec["red"])
        model = build_model(cfg)
        batch = {k: torch.from_numpy(v) for k, v in np.load(spec["batch"]).items()}
        rules = rules_for_shape(cfg, ShapeSpec("t", "train", job["seq"], job["rows"]), mesh)
        step = mesh_train_step(model, mesh, rules, TrainConfig(
            microbatches=job["k"], opt=AdamWConfig(**job["opt"])))
        lay = step.layouts
        p = model.init(MetaGenerator())
        state = CheckpointManager(spec["init"]).restore(
            0, {"params": p, "opt": adamw_init(p)}, lay)
        run = res[fam] = {"rules": {a: step.rank_mesh.rules.lookup(a)
                                    for a in job["expect"]}}
        loss, _, grads = step.grads(state["params"], batch)
        g = gather_state(model, grads, lay["params"], step.rank_mesh)
        run["g1_loss"] = float(loss).hex()
        if rank == 0:
            np.savez(os.path.join(tmp, f"g1_{job['name']}_{fam}.npz"), **flat_np(g))
        losses, norms = [], []
        for i in range(job["steps"]):
            state["params"], state["opt"], met = step(state["params"], state["opt"], batch)
            losses.append(float(met["loss"]).hex())
            norms.append(float(met["grad_norm"]).hex())
        run["losses"], run["norms"] = losses, norms
        cuts = dict(tree_flatten_with_paths(lay["params"]))
        run["replicated"] = {k: sha(t) for k, t in tree_flatten_with_paths(state["params"])
                             if cuts[k].dim is None}
        full = gather_state(model, state, lay, step.rank_mesh)
        run["full"] = {k: sha(t) for k, t in tree_flatten_with_paths(full)}
        if rank == 0:
            np.savez(os.path.join(tmp, f"p3_{job['name']}_{fam}.npz"),
                     **flat_np(full["params"]))
    json.dump(res, open(out_path, "w"))
""")

# the reference's jit_train_step on each layout's Auto-typed mesh: one step
# from the JAX init, its loss; and the batch and the sequence both over
# "data" lowered to the error the reference raises
JAX_MESH = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, Mesh
    from repro.configs import ShapeSpec, get_config
    from repro.launch.steps import TrainConfig, jit_train_step, rules_for_shape
    from repro.models import build_model
    from repro.optim import AdamWConfig, adamw_init

    job = json.load(open(sys.argv[1]))
    res = {}

    def mesh_of(shape):
        names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
        n = int(np.prod(shape))
        return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names,
                    axis_types=(AxisType.Auto,) * len(shape))

    def step_of(cfg, mesh, seq, rows, k, batch):
        rules = rules_for_shape(cfg, ShapeSpec("t", "train", seq, rows), mesh)
        specs = {n: jax.ShapeDtypeStruct(v.shape, v.dtype) for n, v in batch.items()}
        return jit_train_step(build_model(cfg), mesh, rules, TrainConfig(
            microbatches=k, opt=AdamWConfig(**job["opt"])), specs), rules

    for case in job["cases"]:
        cfg = get_config(case["arch"]).reduced(**case["red"])
        mesh = mesh_of(case["shape"])
        batch = {n: jnp.asarray(v) for n, v in np.load(case["batch"]).items()}
        try:
            with mesh:
                step, rules = step_of(cfg, mesh, case["seq"], case["rows"], case["k"], batch)
                params = build_model(cfg).init(jax.random.PRNGKey(0))
                _, _, met = step(params, adamw_init(params), batch)
        except Exception as e:                     # noqa: BLE001 - recorded, then held
            res[case["key"]] = {"error": f"{type(e).__name__}: {e}"[:2000]}
            continue
        res[case["key"]] = {"loss": float(met["loss"]),
                            "rules": {a: rules.lookup(a) for a in ("batch", "seq")}}
    if job.get("both"):
        cfg = get_config("qwen3-1.7b").reduced(dtype="float32")
        mesh = mesh_of((2, 2))
        seq, rows = 16384, 2
        batch = {"tokens": jax.ShapeDtypeStruct((rows, seq), jnp.int32),
                 "labels": jax.ShapeDtypeStruct((rows, seq), jnp.int32)}
        with mesh:
            rules = rules_for_shape(cfg, ShapeSpec("t", "train", seq, rows), mesh)
            step = jit_train_step(build_model(cfg), mesh, rules, TrainConfig(), batch)
            params = jax.eval_shape(build_model(cfg).init, jax.random.PRNGKey(0))
            try:
                step.lower(params, jax.eval_shape(adamw_init, params), batch)
                res["both"] = "lowered"
            except Exception as e:                 # noqa: BLE001 - the reference's error
                res["both"] = f"{type(e).__name__}: {e}"
    json.dump(res, open(sys.argv[2], "w"))
""")


def _launch(tmp, name, layout, models):
    shape, fams, rows, seq, k, expect = layout
    job = {"name": name, "shape": list(shape), "families": fams, "tmp": str(tmp),
           "seq": seq, "rows": rows, "k": k, "steps": STEPS, "opt": OPT,
           "expect": list(expect), "models": models}
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


def _values_key(fam):
    """A family's config less its remat policy, which changes no value: the
    families with one key share a JAX init and reference."""
    arch, red = FAMILIES[fam]
    return arch, tuple(sorted((k, v) for k, v in red.items() if k != "remat"))


def jax_reference(fam, batch_np, params, k):
    """The JAX side of one family on one device: the step-1 loss and
    gradients (the microbatches' mean, as `jit_train_step` accumulates
    them) and the parameters after STEPS steps of that accumulation and
    `optim.adamw_update` from `params`.  Compiled without remat (the same
    values; the port's children run the config's)."""
    model = jax_build_model(dataclasses.replace(_jcfg(fam), remat="none"))
    batch = {n: jnp.asarray(v) for n, v in batch_np.items()}
    ocfg = jax_adamw.AdamWConfig(**OPT)
    vg = jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b)[0]))
    update = jax.jit(lambda p, g, o: jax_adamw.adamw_update(p, g, o, ocfg)[:2])
    n = next(iter(batch.values())).shape[0] // k

    def grads_of(p):
        parts = [vg(p, {name: v[i * n:(i + 1) * n] for name, v in batch.items()})
                 for i in range(k)]
        return (sum(float(l) for l, _ in parts) / k,
                jax.tree.map(lambda *g: sum(g) / k, *[g for _, g in parts]))

    with _auto_mesh():
        loss, grads = grads_of(params)
        p, o, g = params, jax_adamw.adamw_init(params), grads
        for i in range(STEPS):
            p, o = update(p, g, o)
            if i + 1 < STEPS:
                g = grads_of(p)[1]
    flat = lambda t: {"/".join(str(key.key) for key in path): np.asarray(v)
                      for path, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    return {"loss": loss, "grads": flat(grads), "params3": flat(p)}


def run_worlds(tmp, layouts, waves, mesh_cases, both=False):
    """Start the worlds of `layouts` (a few ranks at a time, `waves`) and the
    JAX mesh subprocess (the families `mesh_cases` names a layout); compute
    the single-device JAX references while they run, once a (family,
    batch).  -> {"tmp", "outs": {world: [rank result]}, "refs": {(world,
    fam): reference}, "mesh": the JAX subprocess' results}."""
    (tmp / "child.py").write_text(CHILD)
    models, inits, init_dirs, batches, cases = {}, {}, {}, {}, []
    for name, (shape, fams, rows, seq, k, _) in layouts.items():
        for fam in fams:
            jcfg = _jcfg(fam)
            path = tmp / f"batch_{name}_{fam}.npz"
            batches[name, fam] = _batch_np(jcfg, rows, seq)
            np.savez(path, **batches[name, fam])
            vkey = _values_key(fam)
            if vkey not in inits:
                params = inits[vkey] = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
                JaxCheckpointManager(str(tmp / f"init_{fam}")).save(
                    0, {"params": params, "opt": jax_adamw.adamw_init(params)})
                init_dirs[vkey] = str(tmp / f"init_{fam}")
            arch, red = FAMILIES[fam]
            models.setdefault(name, {})[fam] = {
                "arch": arch, "red": dict(dtype="float32", **red), "batch": str(path),
                "init": init_dirs[vkey]}
            if fam in mesh_cases.get(name, ()):
                cases.append({"key": f"{name}/{fam}", "arch": arch,
                              "red": dict(dtype="float32", **red), "shape": list(shape),
                              "seq": seq, "rows": rows, "k": k, "batch": str(path)})
    (tmp / "jax_mesh.json").write_text(json.dumps({"cases": cases, "opt": OPT, "both": both}))
    jsub = subprocess.Popen(
        [*_nice(), sys.executable, "-c", JAX_MESH, str(tmp / "jax_mesh.json"),
         str(tmp / "jax_mesh_out.json")],
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "JAX_PLATFORMS": "cpu"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs, failures, stop = {}, [], threading.Event()

    def run_waves():
        for wave in waves:
            if stop.is_set():
                return
            for name in wave:
                procs[name] = _launch(tmp, name, layouts[name], models[name])
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

    waves_t = threading.Thread(target=run_waves)
    waves_t.start()
    try:
        refs, once = {}, {}
        for name, (_, fams, rows, seq, k, _) in layouts.items():
            for fam in fams:
                key = (_values_key(fam), rows, seq, k)
                if key not in once:
                    once[key] = jax_reference(fam, batches[name, fam],
                                              inits[_values_key(fam)], k)
                refs[name, fam] = once[key]
        waves_t.join()
        _, jerr = jsub.communicate(timeout=CHILD_TIMEOUT_S)
        if jsub.returncode != 0:
            failures.append(f"JAX mesh subprocess: rc {jsub.returncode}\n{jerr[-3000:]}")
    finally:
        stop.set()
        for p in [p for ps in list(procs.values()) for _, _, p in ps] + [jsub]:
            if p.poll() is None:
                p.kill()
                p.wait()
        waves_t.join()
    assert not failures, "\n".join(failures)
    outs = {name: [json.loads(out.read_text()) for _, out, _ in ps]
            for name, ps in procs.items()}
    return {"tmp": tmp, "outs": outs, "refs": refs, "mesh_cases": mesh_cases,
            "mesh": json.loads((tmp / "jax_mesh_out.json").read_text())}


def check_step1(worlds, name, fam, layouts):
    """The step-1 loss and per-leaf gradients of world `name` against the
    single-device JAX reference; the reference's own mesh step agrees."""
    ref = worlds["refs"][name, fam]
    got = _npz(worlds["tmp"] / f"g1_{name}_{fam}.npz")
    assert set(got) == set(ref["grads"])
    for key, w in ref["grads"].items():
        tol = GRAD_RTOL * max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[key] - w).max())
        assert err <= tol, f"{key}: max |dg| {err:.3e} > {tol:.3e}"
    loss = float.fromhex(worlds["outs"][name][0][fam]["g1_loss"])
    assert abs(loss - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    if fam in worlds["mesh_cases"].get(name, ()):
        jmesh = worlds["mesh"][f"{name}/{fam}"]
        assert "error" not in jmesh, jmesh
        assert abs(jmesh["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    for out in worlds["outs"][name]:
        rules = out[fam]["rules"]
        for axis, want in layouts[name][5].items():
            got_axis = tuple(rules[axis]) if isinstance(rules[axis], list) else rules[axis]
            assert got_axis == want, (axis, got_axis, want)


def check_params(worlds, name, fam):
    want, budget = worlds["refs"][name, fam]["params3"], _lr_budget(STEPS)
    _params_close(_npz(worlds["tmp"] / f"p3_{name}_{fam}.npz"), want, budget,
                  f"{fam} {name}")


def check_ranks(worlds, name, fam):
    runs = [out[fam] for out in worlds["outs"][name]]
    for key in ("g1_loss", "losses", "norms", "replicated", "full"):
        assert all(r[key] == runs[0][key] for r in runs), key
    assert runs[0]["replicated"], "no replicated leaf"


CASES = [(name, fam) for name, (_, fams, *_) in LAYOUTS.items() for fam in fams]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return run_worlds(tmp_path_factory.mktemp("train_layouts"), LAYOUTS, WAVES,
                      JAX_MESH_CASES, both=True)


# ---------------------------------------------------------------- (a) rules
def test_batch_and_seq_on_one_axis_raise_as_the_reference_refuses(worlds):
    """The reference lowers the batch and the sequence both over "data" to
    a DuplicateSpecError (the spec names "data" twice); the port raises
    ValueError naming both logical axes, for the same rules."""
    assert worlds["mesh"]["both"].startswith("DuplicateSpecError"), worlds["mesh"]["both"]
    mesh = FakeMesh(model=2, data=2)
    rules = steps.rules_for_shape(get_config("qwen3-1.7b"),
                                  ShapeSpec("t", "train", 16_384, 2), mesh)
    assert rules.lookup("batch") == ("pod", "data") and rules.lookup("seq") == "data"
    with pytest.raises(ValueError, match="'batch' and 'seq'.*'data'"):
        steps.train_rules(rules, mesh)


# --------------------------------------------------------- (b) the worlds
@pytest.mark.parametrize("name,fam", CASES)
def test_step1_loss_and_gradients_match_jax(name, fam, worlds):
    check_step1(worlds, name, fam, LAYOUTS)


@pytest.mark.parametrize("name,fam", CASES)
def test_params_after_three_steps_match_jax(name, fam, worlds):
    check_params(worlds, name, fam)


@pytest.mark.parametrize("name,fam", CASES)
def test_ranks_agree_bitwise(name, fam, worlds):
    check_ranks(worlds, name, fam)
