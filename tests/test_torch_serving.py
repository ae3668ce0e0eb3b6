"""The port's continuous-batching server against the JAX package's.

The port's `ContinuousEngine(device="cpu")` and the JAX `ContinuousEngine`
serve the same workload from the same parameters: the f32 `tiny_lm` config
(qwen3-1.7b reduced to 2 layers, d_model 64, d_ff 128, vocab 97), mixed
prompt lengths, a 16-token chunk budget (chunking and packing) and a pool
small enough to preempt, with prefix sharing off and on.  Greedy streams
must be equal token for token and the step counters equal.  (The random-init model's top-2 margins on this
workload are far above the f32 differences between the two frameworks, so
no briefly trained model is needed.)

The JAX engine runs on a mesh built with Auto axis types: under jax 0.9
`jax.make_mesh` (and so `launch.mesh.single_device_mesh`) returns Explicit
axes, with which the reference's serving path fails.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, Mesh

from repro.configs import get_config as jax_get_config
from repro.distributed.sharding import DEFAULT_RULES
from repro.models import build_model
from repro.serve.runtime import ContinuousEngine as JaxEngine
from repro.serve.runtime import RuntimeConfig as JaxRuntimeConfig
from repro.serve.traceview import main as traceview_main
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import InferencePlan, OpChoice
from repro_torch.kernels.dispatch import MATMUL_ROLES
from repro_torch.kernels.sampling import sample_tokens
from repro_torch.models import DecoderLM
from repro_torch.serve.router import PlanRouter
from repro_torch.serve.runtime import ContinuousEngine, RuntimeConfig
from repro_torch.serve.trace import TraceRecorder, write_trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# 3 slots, 8-row blocks, 16-token chunks, 8 usable blocks: long prompts
# chunk, short ones pack, and decode growth preempts
RUNTIME = dict(max_slots=3, block_size=8, max_blocks_per_seq=8, chunk_tokens=16,
               num_blocks=9, max_new_tokens=10)
PROMPT_LENS = (11, 30, 5, 40, 3, 22)
COUNTERS = ("prefill_chunks", "packed_segments", "decode_only_steps",
            "preemptions", "prefills", "chunk_steps", "tokens_out",
            "prefix_hit_tokens", "cow_copies", "resume_commits")


def _prompts():
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 97, size=n).astype(np.int32) for n in PROMPT_LENS]
    # prompts 3 and 5 open with prompt 1's first 3 and 2 blocks, so prefix
    # sharing has full blocks to adopt
    prompts[3][:24] = prompts[1][:24]
    prompts[5][:16] = prompts[1][:16]
    return prompts


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_get_config("qwen3-1.7b").reduced(n_layers=2, d_model=64, d_ff=128,
                                                vocab=97, dtype="float32")
    tcfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)})
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, DecoderLM(tcfg), tparams


@pytest.fixture(scope="module", params=[False, True],
                ids=["sharing_off", "sharing_on"])
def jax_run(tiny, request):
    jmodel, jparams, _, _ = tiny
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"),
                axis_types=(AxisType.Auto, AxisType.Auto))
    eng = JaxEngine(jmodel, jparams, mesh, DEFAULT_RULES,
                    JaxRuntimeConfig(**RUNTIME, prefix_sharing=request.param))
    for p in _prompts():
        eng.submit(p)
    with mesh:
        done = eng.run()
    return ({r.rid: [int(t) for t in r.output] for r in done},
            eng.metrics.summary(), request.param)


def _serve_port(tiny, router=None, trace=None, prefix_sharing=False):
    _, _, model, params = tiny
    eng = ContinuousEngine(model, params,
                           RuntimeConfig(**RUNTIME, prefix_sharing=prefix_sharing),
                           router=router, trace=trace, device="cpu")
    for p in _prompts():
        eng.submit(p)
    done = eng.run()
    eng.cache.alloc.check_invariants()
    assert eng.cache.alloc.num_used == 0
    return {r.rid: [int(t) for t in r.output] for r in done}, eng


def _kernel_plan() -> InferencePlan:
    plan = InferencePlan("serve", "h100")
    for stage in ("decode", "prefill_chunk"):
        plan.choices[f"{stage}.attention"] = OpChoice(
            "cuda_attention", {"block_q": 4, "max_segments": 4}, 0.0)
        for role in MATMUL_ROLES:
            plan.choices[f"{stage}.{role}"] = OpChoice("cuda_matmul", {}, 0.0)
    return plan


def test_port_engine_streams_and_counters_match_jax(tiny, jax_run):
    want, jax_summary, sharing = jax_run
    got, eng = _serve_port(tiny, prefix_sharing=sharing)
    assert got == want
    summary = eng.metrics.summary()
    assert {k: summary[k] for k in COUNTERS} == {k: jax_summary[k] for k in COUNTERS}
    # the workload exercises what it claims to
    assert summary["preemptions"] > 0
    assert summary["packed_segments"] > 0
    assert summary["prefill_chunks"] > len(PROMPT_LENS)
    assert summary["decode_only_steps"] > 0
    assert (summary["prefix_hit_tokens"] > 0) == sharing


def test_kernel_lane_plan_serves_the_same_streams(tiny, jax_run):
    """A plan choosing the kernel lanes (on the CPU: the kernels' plain
    versions) serves the JAX engine's streams."""
    want, _, sharing = jax_run
    got, eng = _serve_port(tiny, router=PlanRouter(_kernel_plan()),
                           prefix_sharing=sharing)
    assert eng.adapter._decode_kw["decode_attn_backend"] == "cuda_attention"
    assert eng.adapter._chunk_kw["chunk_matmul_table"]["mlp_up"][0] == "cuda_matmul"
    assert got == want


@pytest.mark.parametrize("change", [
    dict(chunk_tokens=None),            # unchunked: whole prompts per step
    dict(chunk_segments=1),             # single-segment chunks
    dict(num_blocks=None),              # pool that never preempts
    dict(prefix_sharing=True),          # adopted prefixes + copy-on-write
], ids=["unchunked", "single_segment", "unconstrained", "sharing_on"])
def test_port_streams_do_not_depend_on_the_schedule(tiny, change):
    """The port pins inside itself what the reference pins: chunked ≡
    unchunked, packed ≡ single-segment, preempted ≡ unconstrained,
    sharing-on ≡ sharing-off (greedy streams)."""
    _, _, model, params = tiny

    def serve(**overrides):
        eng = ContinuousEngine(model, params, RuntimeConfig(**{**RUNTIME, **overrides}),
                               device="cpu")
        for p in _prompts():
            eng.submit(p)
        return {r.rid: r.output for r in eng.run()}, eng.metrics.summary()

    base, base_summary = serve()
    got, summary = serve(**change)
    assert got == base
    assert base_summary["preemptions"] > 0
    if "num_blocks" in change:
        assert summary["preemptions"] == 0


def test_port_trace_passes_the_reference_audit(tiny, tmp_path):
    rec = TraceRecorder()
    _, eng = _serve_port(tiny, trace=rec)
    path = tmp_path / "trace.json"
    write_trace(str(path), rec.events, eng.metrics,
                metadata={"usable_blocks": RUNTIME["num_blocks"] - 1,
                          "block_size": RUNTIME["block_size"], "mesh": "1x1"})
    assert traceview_main([str(path)]) == 0


# ------------------------------------------------------------- router
def test_router_maps_plan_backends_to_port_lanes():
    plan = InferencePlan("serve", "tpu_v5e")
    plan.choices["decode.attention"] = OpChoice("pallas_attention", {}, 0.0)
    plan.choices["prefill.attention"] = OpChoice("xla", {}, 0.0)
    plan.choices["decode.mlp_up"] = OpChoice("pallas_matmul", {"bm": 8}, 0.0)
    plan.choices["decode.lm_head"] = OpChoice("xla", {}, 0.0)
    r = PlanRouter(plan)
    assert r.attention_backend("decode") == ("cuda_attention", {})
    # prefill_chunk falls back to the whole-prompt prefill stage's choice
    assert r.attention_backend("prefill_chunk") == ("torch", {})
    table = r.matmul_table("decode")
    assert table["mlp_up"] == ("cuda_matmul", {"bm": 8})
    assert table["lm_head"] == ("torch", {})
    assert table["qkv_proj"] == ("torch", {})
    assert r.chunk_segments(default=4) == 4
    assert PlanRouter(None).attention_backend("decode") == ("torch", {})


def test_router_chunk_segments_follows_the_tuned_kernel_choice():
    plan = InferencePlan("serve", "h100")
    plan.choices["prefill_chunk.attention"] = OpChoice(
        "cuda_attention", {"block_q": 16, "max_segments": 2}, 0.0)
    assert PlanRouter(plan).chunk_segments(default=4) == 2
    plan.choices["prefill_chunk.attention"] = OpChoice("cuda_attention", {}, 0.0)
    assert PlanRouter(plan).chunk_segments(default=4) == 1


# ------------------------------------------------------------- sampling
def test_greedy_sampling_is_argmax_first_index_on_ties():
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [5.0, 5.0, 5.0, 5.0]])
    sp = np.zeros((2, 3), np.float32)
    sp[:, 2] = 1.0
    ks = np.zeros((2, 3), np.int32)
    assert sample_tokens(logits, sp, ks).tolist() == [1, 0]


# ------------------------------------------------------------- devices
def test_engine_without_a_device_raises_without_a_gpu(tiny, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, model, params = tiny
    with pytest.raises(RuntimeError, match="GPU"):
        ContinuousEngine(model, params, RuntimeConfig(**RUNTIME))
    with pytest.raises(RuntimeError, match="GPU"):
        ContinuousEngine(model, params, RuntimeConfig(**RUNTIME), device="cuda")


_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"modules": names, "leaked": leaked}))
"""


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("repro_torch.serve.runtime", "repro_torch.kernels.build",
                 "repro_torch.hw", "repro_torch.models.resnet",
                 "repro_torch.kernels.conv2d", "repro_torch.kernels.fused",
                 "repro_torch.core.graph", "repro_torch.core.ref_ops",
                 "repro_torch.core.passes.fusion", "repro_torch.core.passes.layout",
                 "repro_torch.core.schedules", "repro_torch.core.costmodel",
                 "repro_torch.core.search.genetic", "repro_torch.core.search.tuner",
                 "repro_torch.core.selection", "repro_torch.core.engine",
                 "repro_torch.serve.router"):
        assert name in report["modules"], name
    assert report["leaked"] == []
