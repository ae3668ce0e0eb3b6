"""The port's examples (`repro_torch.examples`) against the JAX package's
`examples/`, each `main` run with `--device cpu` at its JAX example's size:

  * quickstart: the same graph, `optimize_graph`'s op histogram equal to
    the JAX one's, the engine's output under the port's plan within 2e-2
    of the JAX `Engine`'s under the JAX plan (Pallas in interpret mode) on
    the same input, and `verify_against_reference` passed;
  * tune_resnet18: the conv groups equal `repro.models.resnet.conv_groups(1,
    224)` shape for shape; under `ModelFitness` (no host clock is timed) one
    row a group and the warm re-tune one cache hit a group, with RL-search
    too (`--rl`);
  * serve_inference: warm-up training, the plan, the continuous engine:
    12/12 requests continue the learned sequence exactly; with `--tp 2`
    under torchrun (two gloo processes, rank 0 trains and broadcasts)
    every rank serves 12/12 exactly.

The quickstart's plan is tuned at `select`'s bf16 default, as the JAX
example's is, and runs on the f32 graph: a GEMM pair the f32 GEMM cannot
launch runs on its default geometry in the engine.
"""

import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Engine as JaxEngine
from repro.core import Tuner as JaxTuner
from repro.core import default_registry as jax_registry
from repro.core import optimize_graph as jax_optimize
from repro.core import select as jax_select
from repro.models.resnet import conv_groups as jax_conv_groups
from repro_torch.core import Engine, ModelFitness, Tuner, default_registry, select
from repro_torch.core import optimize_graph
from repro_torch.core.plan import InferencePlan, OpChoice
from repro_torch.examples import quickstart, serve_inference, tune_resnet18
from repro_torch.kernels import matmul as KM
from repro_torch.kernels import ops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE_TOL = 2e-2


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_matches_the_jax_pipeline(capsys):
    got = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "engine     : optimized plan == reference graph" in out
    assert "modeled for the H100" in out and "TPU" not in out
    jg = _jax_example("quickstart").build_graph()
    assert got["graph"].op_histogram() == jg.op_histogram()
    jopt = jax_optimize(jg)
    assert got["optimized"].op_histogram() == jopt.op_histogram()
    jplan = jax_select(jopt, tuner=JaxTuner(methods=("genetic",)))
    x = got["input"].numpy()
    want = np.asarray(JaxEngine(jopt, jplan, jax_registry(interpret=True))(jnp.asarray(x))[0])
    have = got["engine"](got["input"])[0].numpy()
    assert have.shape == want.shape
    assert float(np.abs(have - want).max()) <= ENGINE_TOL
    assert got["max_err"] <= ENGINE_TOL


def test_a_plan_tuned_at_bf16_runs_on_the_f32_graph(monkeypatch):
    """The JAX example's `select` default (bf16) through the port's Engine:
    the fc's tuned pair is one only the bf16 GEMM launches, so the engine
    runs it on the default geometry (ops.matmul called alone still refuses
    it), to the vendor lane's output; a pair no dtype launches still
    raises in the engine."""
    gopt = optimize_graph(quickstart.build_graph())
    plan = select(gopt, tuner=Tuner(methods=("genetic",), fitness=ModelFitness()))
    fc = next(n for n in gopt.toposort() if n.op == "matmul")
    choice = plan.choice(fc.name)
    cfg = choice.config
    assert choice.backend == "pallas_matmul" and set(ops.GEMM_KNOBS) <= set(cfg)
    m, k = gopt.tensors[fc.inputs[0]].shape
    n = gopt.tensors[fc.inputs[1]].shape[-1]
    assert KM.geometry(m, n, k, torch.bfloat16, cfg["tile_m"], cfg["split_k"]) is not None
    assert KM.geometry(m, n, k, torch.float32, cfg["tile_m"], cfg["split_k"]) is None
    with pytest.raises(ValueError, match="matmul config"):
        ops.matmul(torch.zeros(m, k), torch.zeros(k, n), config=cfg)

    calls, real = [], KM.matmul_fused
    monkeypatch.setattr(KM, "matmul_fused",
                        lambda *a, **kw: calls.append(kw["geometry"]) or real(*a, **kw))
    x = np.random.default_rng(1).standard_normal((4, 3, 32, 32)).astype(np.float32)
    engine = Engine(gopt, plan, default_registry(), device="cpu")
    assert engine.verify_against_reference(x) <= ENGINE_TOL
    assert calls and all(geo is None for geo in calls)

    bad = InferencePlan(plan.graph_name, plan.chip)
    bad.choices = {**plan.choices, fc.name: OpChoice(
        "pallas_matmul", {"tile_m": 32, "split_k": 1}, choice.modeled_time_s, {})}
    with pytest.raises(ValueError, match="matmul config"):
        Engine(gopt, bad, default_registry(), device="cpu", cuda_graph=False)(x)


def test_tune_resnet18_tunes_the_jax_groups_and_reuses_the_cache(capsys):
    got = tune_resnet18.main(["--device", "cpu", "--rl"], fitness=ModelFitness())
    out = capsys.readouterr().out
    want = jax_conv_groups(1, 224)
    assert [r[0] for r in got["rows"]] == [name for name, _ in want]
    from repro_torch.models.resnet import conv_groups
    for (name, op), (jname, jop) in zip(conv_groups(1, 224), want):
        assert name == jname and op.kind == jop.kind and op.d == dict(jop.d), name
    assert got["groups"] == len(want) and got["hits"] == len(want)
    assert all(r[2] > 0 and r[3] > 0 for r in got["rows"])
    assert "paper, on a P100: 2.54x mean, 5.40x max over cuDNN" in out
    assert f"({len(want)} hits)" in out


def test_serve_inference_continues_every_request(capsys):
    got = serve_inference.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert got["served"] == got["correct"] == 12
    assert "12/12 requests continued the learned sequence exactly" in out


TP_CHILD = textwrap.dedent("""
    import json, os, sys
    import torch
    torch.set_num_threads(1)
    from repro_torch.examples import serve_inference
    got = serve_inference.main(["--tp", "2", "--device", "cpu"])
    with open(os.path.join(sys.argv[1], "rank%s.json" % os.environ["RANK"]), "w") as f:
        json.dump({"correct": got["correct"], "served": got["served"]}, f)
""")


def test_serve_inference_tp2_under_torchrun_continues_every_request_on_every_rank(
        tmp_path):
    """The README's `torchrun --nproc-per-node 2 -m
    repro_torch.examples.serve_inference --tp 2 --device cpu`, each rank's
    `main` result written out: rank 0 trains, broadcasts the parameters,
    and both ranks serve their shards of the (1, 2) mesh to 12/12 exact
    continuations."""
    (tmp_path / "child.py").write_text(TP_CHILD)
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "OMP_NUM_THREADS": "1"}
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", str(tmp_path / "child.py"), str(tmp_path)],
        env=env, cwd=str(tmp_path), capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "serving mesh 1x2" in run.stdout
    assert "12/12 requests continued the learned sequence exactly" in run.stdout
    for rank in (0, 1):
        got = json.loads((tmp_path / f"rank{rank}.json").read_text())
        assert got == {"correct": 12, "served": 12}, (rank, got)
