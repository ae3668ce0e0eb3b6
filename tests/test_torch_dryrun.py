"""The dry run (`repro_torch.launch.dryrun`, ROADMAP item 8d) against the
JAX package's, on the CPU.

  * `input_specs` gives the reference's keys, shapes and dtypes for the ten
    archs x four shapes (meta tensors);
  * `runmode.layer_scan` equals `jax.lax.scan` on a small body (carry and
    stacked outputs, xs as a pytree, and a length with no xs), and
    `cost_mode` nests;
  * the collective tally (`distributed.collectives.count_collectives`) is
    exact for a known sequence of calls on a 2-rank gloo world;
  * in one subprocess (a fake world cannot share a worker with gloo
    tests): qwen3-1.7b train_4k on the 16 x 16 mesh against the reference's
    artifact (`artifacts/dryrun/qwen3-1.7b__train_4k__16x16.json`): params,
    active params and tokens exact, the state under the reference's
    placements exactly its argument bytes, the port's own cut less by the
    K / V projections it does not hold, FLOPs within 1 % of an analytic
    count of the step's products and attention and at most 1.05 x the
    reference's, transcendentals within [0.8, 1.25] of the reference's,
    bytes accessed logged beside the reference's and at least the
    argument and output bytes, collectives logged beside the reference's;
    qwen3-1.7b decode_32k at 16 x 16 lowering with the batch over "data"
    and the KV cache's positions over "model" (1,879,048,192 bytes of K / V
    a device, which with the parameters the step's bytes accessed cover);
    whisper-base decode_32k refused as the reference's placement
    refuses it (1500 encoder positions do not split over 16); two cells
    the port refused under ROADMAP item 8c-ii lowering at one layer
    (qwen3-1.7b train across pods, qwen2-moe-a2.7b train with TP inside
    the experts); a miniature (reduced qwen3: train at (data 2, model 2)
    and at (pod 2, data 2, model 2), prefill and decode at (1, 2) and at
    (data 2, model 2), decode with the KV positions over "model" at (1, 4);
    reduced zamba2: the batch-1 decode at (data 2, model 1), its KV
    positions and SSM state columns over "data") whose params, tokens and
    argument bytes equal XLA's `memory_analysis` of the JAX steps compiled
    on 8 forced host devices in a second subprocess (Auto-typed meshes),
    the FLOP ratio logged and at most 1.05, the transcendentals within
    10 % of XLA's `cost_analysis` less the named terms only the port
    computes, the bytes accessed logged beside XLA's and at least the
    argument and output bytes; and every module of
    `repro_torch` imported with neither `jax` nor `repro` loaded.
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import input_specs as jax_input_specs
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config, input_specs
from repro_torch.models import runmode

ROOT = pathlib.Path(__file__).resolve().parents[1]
REFERENCE = json.loads((ROOT / "artifacts" / "dryrun" /
                        "qwen3-1.7b__train_4k__16x16.json").read_text())
CHILD_TIMEOUT_S = 600
# the miniature's cells, each a reduced arch: (key, shape name, mesh, seq,
# batch, arch)
MINI = [("train", "train_4k", (2, 2), 32, 8, "qwen3-1.7b"),
        ("prefill", "prefill_32k", (1, 2), 32, 2, "qwen3-1.7b"),
        ("decode", "decode_32k", (1, 2), 64, 2, "qwen3-1.7b"),
        ("prefill_dp", "prefill_32k", (2, 2), 32, 4, "qwen3-1.7b"),
        ("decode_dp", "decode_32k", (2, 2), 64, 4, "qwen3-1.7b"),
        ("decode_kv_seq", "decode_32k", (1, 4), 64, 2, "qwen3-1.7b"),
        ("decode_batch1", "long_500k", (2, 1), 64, 1, "zamba2-1.2b"),
        # the reference's (pod 2, data 2, model 2) miniature
        # (tests/test_distributed.py): the batch over pod x data
        ("train_pod", "train_4k", (2, 2, 2), 32, 8, "qwen3-1.7b")]
# the miniature's decode cells whose KV positions are split over g ranks
# ("kv_seq"; zamba2's SSM state columns too, over "data"): key -> g
KV_SEQ = {"decode_kv_seq": 4, "decode_batch1": 2}
# cells the port refused until training ran the pod axis and TP inside the
# experts (ROADMAP item 8c-ii), lowered at one layer (REPRO_LAYERS=1; the
# production run lowers every layer into artifacts/dryrun_torch/)
LOWERED = [("qwen3-1.7b", "train_4k", True), ("qwen2-moe-a2.7b", "train_4k", False)]
# the production cells the port now lowers or refuses as the reference does
CELLS = [("qwen3-1.7b", "decode_32k", False), ("whisper-base", "decode_32k", False)]


# ------------------------------------------------------------ input_specs
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_equal_the_reference(arch, shape):
    for for_loss in (True, False):
        want = jax_input_specs(jax_get_config(arch), JAX_SHAPES[shape], for_loss)
        got = input_specs(get_config(arch), SHAPES[shape], for_loss)
        assert list(got) == list(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), k
            assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype), k


# ---------------------------------------------------------------- runmode
def test_layer_scan_equals_lax_scan():
    rng = np.random.default_rng(0)
    xs = {"w": rng.standard_normal((3, 4, 4)).astype(np.float32),
          "b": (rng.standard_normal((3, 4)).astype(np.float32),)}
    h0 = rng.standard_normal(4).astype(np.float32)

    def body(lib):
        def f(h, x):
            h = lib.tanh(h @ x["w"] + x["b"][0])
            return h, {"s": h.sum(), "twice": (h * 2,)}
        return f

    jc, jy = jax.lax.scan(body(jnp), jnp.asarray(h0), jax.tree.map(jnp.asarray, xs))
    tc, ty = runmode.layer_scan(body(torch), torch.from_numpy(h0),
                                {"w": torch.from_numpy(xs["w"]),
                                 "b": (torch.from_numpy(xs["b"][0]),)})
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ty["s"].numpy(), np.asarray(jy["s"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ty["twice"][0].numpy(), np.asarray(jy["twice"][0]),
                               rtol=1e-6, atol=1e-6)
    assert ty["twice"][0].shape == (3, 4)

    count = lambda c, _: (c + 1, c * 10)
    jc, jy = jax.lax.scan(count, 0, None, length=5)
    tc, ty = runmode.layer_scan(lambda c, _: (c + 1, torch.tensor(c * 10)), 0, None, length=5)
    assert tc == int(jc) and ty.tolist() == np.asarray(jy).tolist()
    assert runmode.layer_scan(lambda c, x: (c + x, None), torch.tensor(0.),
                              torch.arange(4.))[1] is None
    with pytest.raises(ValueError):
        runmode.layer_scan(count, 0, None)


def test_cost_mode_nests():
    assert runmode.COST_MODE is False
    with runmode.cost_mode():
        assert runmode.COST_MODE is True
        with runmode.cost_mode(False):
            assert runmode.COST_MODE is False
            with runmode.cost_mode(True):
                assert runmode.COST_MODE is True
            assert runmode.COST_MODE is False
        assert runmode.COST_MODE is True
    assert runmode.COST_MODE is False


# ------------------------------------------------------- collective tally
_TALLY_CHILD = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.collectives import AxisGroup, count_collectives
    from repro_torch.distributed.sharding import LeafCut
    from repro_torch.launch.mesh import init_file_world
    from repro_torch.launch.steps import _gather_zero

    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    init_file_world(store, rank, 2)
    g = AxisGroup(dist.group.WORLD, rank, 2)
    x = torch.full((3, 4), float(rank + 1))
    g.all_reduce(x)                                   # untallied
    with count_collectives() as outer:
        s = g.all_reduce(x)                           # all-reduce 48
        a = g.all_gather(torch.ones(2, 3, dtype=torch.bfloat16), 0)   # all-gather 12
        m = g.max(torch.arange(5, dtype=torch.float64) * (rank + 1))  # all-reduce 40
        g.sum_in_place(torch.ones(10), chunk=4)       # all-reduce 16 + 16 + 8
        g.barrier()                                   # all-gather 4
        leaf = torch.ones(6, 2, requires_grad=True)
        g.enter(leaf).sum().backward()                # all-reduce 48 in backward
        z = _gather_zero(LeafCut(zero_dim=0, zero_rank=rank, zero_size=2),
                         torch.ones(3, 5), g)         # all-gather 60
        with count_collectives() as inner:
            g.all_reduce(x)
    checks = {"sum": s.tolist(), "gather": list(a.shape), "max": m.tolist(),
              "grad": leaf.grad.tolist()[0], "zero": list(z.shape)}
    json.dump({"outer": outer.as_dict(), "inner": inner.as_dict(), "checks": checks},
              open(out, "w"))
    dist.destroy_process_group()
""")


def _env():
    src = str(ROOT / "src")
    return {**os.environ, "PYTHONPATH": src + os.pathsep + os.environ.get("PYTHONPATH", ""),
            "OMP_NUM_THREADS": "1"}


def test_collective_tally_is_exact_on_a_gloo_world(tmp_path):
    (tmp_path / "child.py").write_text(_TALLY_CHILD)
    procs = [subprocess.Popen([sys.executable, str(tmp_path / "child.py"), str(r),
                               str(tmp_path / "store"), str(tmp_path / f"out{r}.json")],
                              env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
    kinds = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
    want_bytes = dict.fromkeys(kinds, 0)
    want_counts = dict.fromkeys(kinds, 0)
    want_bytes.update({"all-reduce": 48 + 40 + 16 + 16 + 8 + 48, "all-gather": 12 + 4 + 60})
    want_counts.update({"all-reduce": 6, "all-gather": 3})
    for r in range(2):
        got = json.loads((tmp_path / f"out{r}.json").read_text())
        assert got["outer"] == {"per_kind_bytes": want_bytes, "counts": want_counts,
                                "total_bytes": 252}
        assert got["inner"]["counts"]["all-reduce"] == 1
        assert got["inner"]["per_kind_bytes"]["all-reduce"] == 48
        assert got["inner"]["total_bytes"] == 48
        assert got["checks"] == {"sum": [[3.0] * 4] * 3, "gather": [4, 3],
                                 "max": [0.0, 2.0, 4.0, 6.0, 8.0], "grad": [2.0, 2.0],
                                 "zero": [6, 5]}


# ------------------------------------------- the cells and the miniature
_PORT_CHILD = textwrap.dedent("""
    import dataclasses, importlib, json, os, pkgutil, sys
    import torch
    torch.set_num_threads(1)
    import repro_torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import TrainConfig

    mini, lowered, cells, out = (json.loads(sys.argv[1]), json.loads(sys.argv[2]),
                                 json.loads(sys.argv[3]), sys.argv[4])
    res = {"mini": {}, "cells": {}}
    for key, name, mesh, seq, b, arch in mini:
        cfg = get_config(arch).reduced()
        shape = dataclasses.replace(SHAPES[name], seq_len=seq, global_batch=b)
        rec = dryrun.lower_cell(arch, name, False,
                                TrainConfig(microbatches=2, zero1=True), cfg=cfg,
                                shape=shape, mesh_shape=mesh)
        res["mini"][key] = rec
    for arch, shape, mp in [("qwen3-1.7b", "train_4k", False)] + [c[:3] for c in cells]:
        res["cells"][f"{arch}__{shape}__{mp}"] = dryrun.cell_record(arch, shape, mp)
    os.environ["REPRO_LAYERS"] = "1"
    for arch, shape, mp in lowered:
        res["cells"][f"{arch}__{shape}__{mp}"] = dryrun.cell_record(arch, shape, mp)
    del os.environ["REPRO_LAYERS"]
    for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        if not m.name.endswith("__main__"):
            importlib.import_module(m.name)
    res["modules"] = sorted(m for m in sys.modules if m.startswith("repro_torch"))
    res["foreign"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    json.dump(res, open(out, "w"))
""")

_JAX_CHILD = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json, sys
    import jax, numpy as np
    from jax.sharding import AxisType, Mesh
    from repro.configs import SHAPES, get_config, input_specs
    from repro.launch.steps import (TrainConfig, cost_dict, jit_prefill_step,
                                    jit_serve_step, jit_train_step, rules_for_shape)
    from repro.models import build_model, runmode
    from repro.optim import adamw_init

    mini, out = json.loads(sys.argv[1]), sys.argv[2]
    res = {}
    for key, name, mshape, seq, b, arch in mini:
        kind = SHAPES[name].kind
        cfg = get_config(arch).reduced()
        if kind == "train":
            cfg = dataclasses.replace(cfg, remat="full")
        shape = dataclasses.replace(SHAPES[name], seq_len=seq, global_batch=b)
        n = int(np.prod(mshape))
        names = ("data", "model") if len(mshape) == 2 else ("pod", "data", "model")
        mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(mshape), names,
                    axis_types=(AxisType.Auto,) * len(mshape))
        model = build_model(cfg)
        rules = rules_for_shape(cfg, shape, mesh)
        with mesh:
            params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
            batch = input_specs(cfg, shape)

            def lower(cost):
                with runmode.cost_mode(cost):
                    if kind == "train":
                        opt = jax.eval_shape(adamw_init, params)
                        tc = TrainConfig(microbatches=1 if cost else 2, zero1=True)
                        return jit_train_step(model, mesh, rules, tc, batch).lower(
                            params, opt, batch)
                    if kind == "prefill":
                        return jit_prefill_step(model, mesh, rules, batch, max_seq=seq,
                                                batch=b).lower(params, batch)
                    cache = jax.eval_shape(lambda: model.init_cache(b, seq))
                    tok = jax.ShapeDtypeStruct((b, 1), np.int32)
                    return jit_serve_step(model, mesh, rules, b, seq).lower(
                        params, cache, tok)

            mem = lower(False).compile().memory_analysis()
            cost = cost_dict(lower(True).compile().cost_analysis())
        res[key] = {"argument_bytes": int(mem.argument_size_in_bytes),
                     "output_bytes": int(mem.output_size_in_bytes),
                     "flops": float(cost["flops"]),
                     "transcendentals": float(cost.get("transcendentals", 0.0)),
                     "bytes_accessed": float(cost.get("bytes accessed", 0.0)),
                     "params": cfg.param_count(),
                     "n_params": int(sum(x.size for x in jax.tree.leaves(params)))}
    json.dump(res, open(out, "w"))
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's child (the miniature, the 16 x 16 cells, the imports) and
    the JAX child, side by side."""
    tmp = tmp_path_factory.mktemp("dryrun")
    jobs = {"port": (_PORT_CHILD, [json.dumps(MINI), json.dumps(LOWERED), json.dumps(CELLS)]),
            "jax": (_JAX_CHILD, [json.dumps(MINI)])}
    procs = {}
    for name, (script, args) in jobs.items():
        (tmp / f"child_{name}.py").write_text(script)
        env = _env()
        if name == "jax":
            env["JAX_PLATFORMS"] = "cpu"
        procs[name] = subprocess.Popen(
            [sys.executable, str(tmp / f"child_{name}.py"), *args, str(tmp / f"{name}.json")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for name, p in procs.items():
        try:
            _, err = p.communicate(timeout=CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            raise
        assert p.returncode == 0, f"{name} child:\n{err[-4000:]}"
        out[name] = json.loads((tmp / f"{name}.json").read_text())
    return out


def _qwen3_train_flops(cfg, rows: int, tp: int) -> int:
    """The products and attention one rank of qwen3-1.7b's train_4k step
    runs on the 16 x 16 mesh (remat full, the loss in checkpointed chunks),
    as FlopCounterMode counts them (2 m n k a product, attention's two
    products over every (query, key) pair: the causal mask is applied, not
    skipped):
      * each token's projections at the rank's widths: its query head(s),
        the one KV head those read (8 KV heads do not split over 16 ranks:
        the port keeps, of the replicated K / V projections, the columns
        of the head its query head reads), wo's rows, the MLP's ffn / tp
        columns, and the LM head's vocab / tp columns;
      * four passes of every product: the forward, remat's recompute of
        the layer (the loss chunk's of the LM head) and the two products of
        its backward (the gradients of the input and of the weight);
      * five of attention's: the forward, the layer's recompute, each KV
        chunk's own recompute inside the layer's backward (the chunked
        form's checkpoints), and the two backward products."""
    d, hd, seq = cfg.d_model, cfg.hd, SHAPES["train_4k"].seq_len
    heads = cfg.n_heads // tp
    kv_cols = hd                              # the one KV head its query head reads
    per_token = (2 * d * (heads * hd + 2 * kv_cols) + 2 * heads * hd * d
                 + 3 * 2 * d * (cfg.d_ff // tp))
    lm_head = 2 * d * (cfg.vocab // tp)
    tokens = rows * seq
    products = 4 * tokens * (cfg.n_layers * per_token + lm_head)
    attention = 5 * cfg.n_layers * rows * heads * 2 * (2 * seq * seq * hd)
    return products + attention


def test_qwen3_train_4k_meets_the_reference_artifact(runs):
    cell = runs["port"]["cells"]["qwen3-1.7b__train_4k__False"]
    assert cell["status"] == "ok", cell.get("traceback")
    ref = REFERENCE
    for k in ("params", "active_params", "tokens", "n_devices", "kind", "mesh"):
        assert cell[k] == ref[k], k
    assert cell["cost_method"] == "meta" and cell["kernels"] == "none"
    mem = cell["memory"]
    # the state under the reference's placements is its argument bytes; the
    # port's cut holds, of wk / wv (replicated over model 16), the one KV
    # head its query head reads: params, m and v each that much less
    assert abs(mem["argument_bytes_placements"] / ref["memory"]["argument_bytes"] - 1) <= 5e-3
    assert mem["argument_bytes_placements"] == ref["memory"]["argument_bytes"]
    cfg = get_config("qwen3-1.7b")
    kv_held_less = cfg.n_layers * 2 * cfg.d_model * (cfg.n_kv_heads - 1) * cfg.hd * 4
    diff = {k: mem["argument_bytes_by_group"][k] - v
            for k, v in mem["placement_bytes_by_group"].items()}
    print("argument bytes, port minus the reference's placements, by group:", diff)
    assert diff == {"params": -kv_held_less, "m": -kv_held_less, "v": -kv_held_less,
                    "step": 0, "batch": 0}
    assert mem["argument_bytes"] == ref["memory"]["argument_bytes"] - 3 * kv_held_less
    assert mem["peak_bytes_per_device"] > mem["argument_bytes"]

    flops = cell["cost"]["flops_per_device"]
    want = _qwen3_train_flops(cfg, rows=256 // 16, tp=16)
    ratio = flops / ref["cost"]["flops_per_device"]
    print(f"flops/device {flops:.6e}, analytic {want:.6e}, reference "
          f"{ref['cost']['flops_per_device']:.6e}, ratio {ratio:.4f}")
    assert abs(flops / want - 1) <= 0.01
    assert ratio <= 1.05

    # CostCounter's two counters: the reference's transcendentals within
    # [0.8, 1.25]; its bytes fuse, the port's count every op's
    cost, ref_cost = cell["cost"], ref["cost"]
    assert cost["transcendentals"] == sum(cell["transcendentals_by_op"].values())
    assert cost["bytes_accessed_per_device"] == sum(cell["bytes_by_op"].values())
    t_ratio = cost["transcendentals"] / ref_cost["transcendentals"]
    print(f"transcendentals/device {cost['transcendentals']:.6e}, reference "
          f"{ref_cost['transcendentals']:.6e}, ratio {t_ratio:.4f}; bytes accessed/device "
          f"{cost['bytes_accessed_per_device']:.6e}, reference "
          f"{ref_cost['bytes_accessed_per_device']:.6e}, ratio "
          f"{cost['bytes_accessed_per_device'] / ref_cost['bytes_accessed_per_device']:.4f}")
    assert 0.8 <= t_ratio <= 1.25
    assert cost["bytes_accessed_per_device"] >= mem["argument_bytes"] + mem["output_bytes"]

    coll = cell["collectives"]
    print("collectives, port:", coll["counts"], coll["total_bytes"],
          "reference:", ref["collectives"]["counts"], ref["collectives"]["total_bytes"],
          "CommDebugMode saw", cell["comm_debug_mode_count"])
    assert set(coll["counts"]) == set(ref["collectives"]["counts"])
    assert coll["counts"]["all-reduce"] > 0 and coll["counts"]["all-gather"] > 0
    assert coll["total_bytes"] == sum(coll["per_kind_bytes"].values()) > 0
    # every group of the 16 x 16 mesh has 16 ranks, and every collective is
    # one all-gather: CostCounter's operand and result bytes are the tally's
    # operand bytes and 16 times them
    assert cell["bytes_by_op"]["c10d._allgather_base_"] == 17 * coll["total_bytes"]


@pytest.mark.parametrize("arch,shape,multi_pod", LOWERED,
                         ids=[f"{a}-{s}-{'2x16x16' if m else '16x16'}"
                              for a, s, m in LOWERED])
def test_refused_cells_name_their_roadmap_item(runs, arch, shape, multi_pod):
    """The name is kept from when these cells were refused naming ROADMAP
    item 8c-ii; it now asserts the opposite: the cells lower with status
    "ok".  qwen3-1.7b's train cell across pods (the batch over pod x data)
    and qwen2-moe-a2.7b's at 16 x 16 (60 experts over model 16: TP inside
    the experts), at one layer: a FLOP count, the argument bytes and the
    collectives of the step."""
    cell = runs["port"]["cells"][f"{arch}__{shape}__{multi_pod}"]
    assert cell["status"] == "ok", cell.get("error")
    assert cell["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert cell["n_devices"] == (512 if multi_pod else 256)
    assert cell["tokens"] == SHAPES[shape].seq_len * SHAPES[shape].global_batch
    assert cell["cost"]["flops_per_device"] > 0
    assert cell["memory"]["argument_bytes"] > 0
    assert cell["collectives"]["counts"]["all-reduce"] > 0


def test_qwen3_decode_32k_lowers_with_the_kv_positions_over_model(runs):
    """The batch over "data" (8 of the 128 rows a rank) and, the 8 KV heads
    not dividing model 16, the cache's positions over "model" (2,048 of
    32,768) with every KV head: 8 x 2,048 x 8 x 128 x 2 tensors x 28 layers
    of bf16 K / V a device."""
    cell = runs["port"]["cells"]["qwen3-1.7b__decode_32k__False"]
    assert cell["status"] == "ok", cell.get("traceback")
    cfg = get_config("qwen3-1.7b")
    kv = 8 * 2048 * cfg.n_kv_heads * cfg.hd * 2 * cfg.n_layers * 2
    assert kv == 1_879_048_192
    cache = cell["memory"]["argument_bytes_by_group"]
    assert cache["k"] + cache["v"] == kv, cache
    assert cache["tokens"] == 8 * 4 and cache["lengths"] == 8 * 4
    assert cell["tokens"] == 128 and cell["kind"] == "decode"
    # the step reads at least the rank's parameters and its K / V
    moved = cell["cost"]["bytes_accessed_per_device"]
    print(f"decode_32k bytes accessed/device {moved:.6e}, parameters + K / V "
          f"{cache['params'] + kv:.6e}")
    assert moved >= cache["params"] + kv
    assert cell["collectives"]["counts"]["all-gather"] > 0


def test_whisper_decode_32k_is_refused_as_the_reference_refuses_it(runs):
    """whisper-base decode_32k at 16 x 16: its 8 KV heads do not divide
    model 16, so the cache's positions take the model axis, the cross
    K / V's 1500 encoder positions with them; they do not split into 16,
    and the reference's placement (`jax.jit`'s in_shardings) raises
    ValueError there, as the port does."""
    cell = runs["port"]["cells"]["whisper-base__decode_32k__False"]
    assert cell["status"] == "error"
    assert cell["error"].startswith("ValueError: "), cell["error"]
    assert "1500" in cell["error"] and "16 blocks" in cell["error"]


def _port_only_transcendentals(kind, cfg, rows, train):
    """The transcendentals the port's step computes and XLA's program does
    not, each derived from the config:
      * the RoPE frequency table `theta ** (2i / hd)`, hd / 2 elements: the
        port computes it at every rotation (q and k, each attention layer,
        in training each microbatch's forward and remat's recompute), XLA
        folds it into a constant;
      * where "kv_seq" splits the KV positions over g ranks, the decode's
        log-sum-exp merge of the ranks' partials: one exp per (attention
        layer, row, head, rank), where GSPMD's partitioned softmax has none;
      * zamba2's batch-1 decode, "ssm_state" over the same g ranks: the port
        runs each mamba layer's elementwise work whole on every rank (silu
        of the conv output and of z, softplus's exp and log1p, exp(A_log),
        exp(dt A)), where GSPMD spreads it over the g ranks: (1 - 1/g) of
        it a rank."""
    attn_layers = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else cfg.n_layers
    passes = 2 * 2 if train else 1            # the miniature's 2 microbatches x 2
    rope = 2 * attn_layers * passes * cfg.hd // 2
    g = KV_SEQ.get(kind, 1)
    if g == 1:
        return rope
    merge = attn_layers * rows * cfg.n_heads * g
    if cfg.family != "hybrid":
        return rope + merge
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim
    per_layer = (d_in + 2 * cfg.ssm_state) + d_in + 4 * nh
    return rope + merge + cfg.n_layers * rows * per_layer * (g - 1) // g


@pytest.mark.parametrize("kind", [m[0] for m in MINI])
def test_miniature_matches_xla_memory_analysis(runs, kind):
    got, want = runs["port"]["mini"][kind], runs["jax"][kind]
    _, name, mesh, seq, b, arch = next(m for m in MINI if m[0] == kind)
    assert got["status"] == "ok" and got["mesh"] == "x".join(map(str, mesh))
    assert got["params"] == want["params"] == get_config(arch).reduced().param_count()
    assert got["tokens"] == (b * seq if SHAPES[name].kind != "decode" else b)
    # the step counter is an argument on both sides; XLA counts nothing else
    # the port does not
    assert got["memory"]["argument_bytes"] == want["argument_bytes"]
    ratio = got["cost"]["flops_per_device"] / want["flops"]
    cost = got["cost"]
    port_only = _port_only_transcendentals(kind, get_config(arch).reduced(), b,
                                           SHAPES[name].kind == "train")
    t_ratio = (cost["transcendentals"] - port_only) / want["transcendentals"]
    b_ratio = cost["bytes_accessed_per_device"] / want["bytes_accessed"]
    print(f"{kind}: flops port {got['cost']['flops_per_device']:.6e}, XLA "
          f"{want['flops']:.6e}, ratio {ratio:.4f}; output bytes port "
          f"{got['memory']['output_bytes']}, XLA {want['output_bytes']}; "
          f"transcendentals port {cost['transcendentals']:.0f} less {port_only} "
          f"port-only, XLA {want['transcendentals']:.0f}, ratio {t_ratio:.4f}; bytes "
          f"accessed port {cost['bytes_accessed_per_device']:.6e}, XLA "
          f"{want['bytes_accessed']:.6e}, ratio {b_ratio:.4f}")
    assert 0 < ratio <= 1.05
    assert abs(t_ratio - 1) <= 0.1
    mem = got["memory"]
    assert cost["bytes_accessed_per_device"] >= mem["argument_bytes"] + mem["output_bytes"]


def test_no_module_of_the_port_imports_jax_or_repro(runs):
    assert len(runs["port"]["modules"]) > 50
    assert "repro_torch.launch.dryrun" in runs["port"]["modules"]
    assert runs["port"]["foreign"] == []
