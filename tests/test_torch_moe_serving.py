"""The port's continuous engine serving the MoE family and the newly
registered dense configurations, against the JAX package's engines.

The port's `ContinuousEngine(device="cpu")` and the JAX `ContinuousEngine`
(on an Auto-typed mesh, as in `tests/test_torch_serving.py`) serve the
same workload — that file's RUNTIME and prompts: 3 slots, 16-token chunks
(chunking and packing), a 9-block pool (preemption), prefix sharing off
and on — from the same parameters (a JAX `init` through `bridge`), f32.
Models: qwen2-moe-a2.7b reduced to 2 layers, d_model 64, d_ff 128, vocab 97
(8 experts top-2, 4 shared, d_expert 64), and at the same reduction
granite-3-8b, internlm2-20b and starcoder2-15b.  Greedy streams, the bench's
mixed sampling cycle (`benchmarks/bench_serving.py:158`) and the step
counters must be equal: exact, because each random-init model's top-2
margins on this workload lie far above the f32 differences between the
two frameworks.

Capacity grouping makes the MoE's streams depend on the schedule, in the
reference too: decode groups the whole slot batch, idle slots' fill-token
rows included, and a chunk groups its padding rows with its real ones.
At this workload none of the reference's identities holds for the MoE
(unchunked, single-segment, unconstrained pool and sharing-on each change
some stream); the port reproduces each variant's streams, so it holds the
same verdicts.  `FixedBatchEngine` at batch 1 equals the JAX one, and a
kernel-lane plan (on the CPU: the kernels' plain versions) serves the torch
lanes' streams.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, Mesh

from repro.configs import get_config as jax_get_config
from repro.distributed.sharding import DEFAULT_RULES
from repro.models import build_model as jax_build_model
from repro.serve.engine import FixedBatchEngine as JaxFixedBatchEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.runtime import ContinuousEngine as JaxEngine
from repro.serve import router as jrouter
from repro.serve.runtime import RuntimeConfig as JaxRuntimeConfig
from repro.serve.sampling import SamplingParams as JaxSamplingParams
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import InferencePlan, OpChoice
from repro_torch.core.schedules import TEMPLATES
from repro_torch.core.selection import op_desc_of
from repro_torch.kernels import matmul as KM
from repro_torch.kernels.dispatch import MATMUL_ROLES
from repro_torch.models import DecoderLM, build_model
from repro_torch.serve import (ContinuousEngine, FixedBatchEngine, RuntimeConfig,
                               SamplingParams, ServeConfig)
from repro_torch.serve.router import PlanRouter, build_serve_graph

RUNTIME = dict(max_slots=3, block_size=8, max_blocks_per_seq=8, chunk_tokens=16,
               num_blocks=9, max_new_tokens=10)
PROMPT_LENS = (11, 30, 5, 40, 3, 22)
COUNTERS = ("prefill_chunks", "packed_segments", "decode_only_steps",
            "preemptions", "prefills", "chunk_steps", "tokens_out",
            "prefix_hit_tokens", "cow_copies", "resume_commits")
REDUCTION = dict(n_layers=2, d_model=64, d_ff=128, vocab=97, dtype="float32")
MOE = "qwen2-moe-a2.7b"
# the schedule variants of tests/test_torch_serving.py, and whether the
# reference's MoE streams stay those of the base schedule under each
VARIANTS = {"unchunked": dict(chunk_tokens=None),
            "single_segment": dict(chunk_segments=1),
            "unconstrained": dict(num_blocks=None),
            "sharing_on": dict(prefix_sharing=True)}
MOE_IDENTITY_HOLDS = {"unchunked": False, "single_segment": False,
                      "unconstrained": False, "sharing_on": False}


def _prompts():
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 97, size=n).astype(np.int32) for n in PROMPT_LENS]
    prompts[3][:24] = prompts[1][:24]
    prompts[5][:16] = prompts[1][:16]
    return prompts


def _mix(i, cls):
    """The bench's mixed sampling cycle (benchmarks/bench_serving.py:158)."""
    r = i % 4
    if r == 0:
        return cls()
    if r == 1:
        return cls(temperature=0.8, seed=1000 + i)
    if r == 2:
        return cls(temperature=1.0, top_k=8, seed=1000 + i)
    return cls(temperature=0.9, top_p=0.85, seed=1000 + i)


_MODELS = {}


def _models(arch):
    """(JAX model, JAX params, port model, port params), built once."""
    if arch not in _MODELS:
        jcfg = jax_get_config(arch).reduced(**REDUCTION)
        jmodel = jax_build_model(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        model = build_model(ModelConfig(**dataclasses.asdict(jcfg)))
        _MODELS[arch] = (jmodel, jparams, model,
                         params_from_jax(jax.tree.map(np.asarray, jparams)))
    return _MODELS[arch]


def _mesh():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"),
                axis_types=(AxisType.Auto, AxisType.Auto))


def _serve_jax(arch, sampled=False, **change):
    jmodel, jparams, _, _ = _models(arch)
    mesh = _mesh()
    eng = JaxEngine(jmodel, jparams, mesh, DEFAULT_RULES,
                    JaxRuntimeConfig(**{**RUNTIME, **change}))
    for i, p in enumerate(_prompts()):
        eng.submit(p, sampling=_mix(i, JaxSamplingParams) if sampled else None)
    with mesh:
        done = eng.run()
    return {r.rid: [int(t) for t in r.output] for r in done}, eng.metrics.summary()


def _serve_port(arch, sampled=False, router=None, **change):
    _, _, model, params = _models(arch)
    eng = ContinuousEngine(model, params, RuntimeConfig(**{**RUNTIME, **change}),
                           router=router, device="cpu")
    for i, p in enumerate(_prompts()):
        eng.submit(p, sampling=_mix(i, SamplingParams) if sampled else None)
    done = eng.run()
    eng.cache.alloc.check_invariants()
    assert eng.cache.alloc.num_used == 0
    assert eng._unified._cache_size() == eng._decode_only._cache_size() == 1
    return {r.rid: [int(t) for t in r.output] for r in done}, eng.metrics.summary()


def _counters(summary):
    return {k: summary[k] for k in COUNTERS}


@pytest.fixture(scope="module")
def moe_base():
    return _serve_jax(MOE)


@pytest.mark.parametrize("arch", [MOE, "granite-3-8b", "internlm2-20b",
                                  "starcoder2-15b"])
@pytest.mark.parametrize("sharing,sampled", [(False, False), (True, True)],
                         ids=["sharing_off-greedy", "sharing_on-mixed"])
def test_streams_and_counters_match_the_jax_engine(arch, sharing, sampled):
    want, jax_summary = _serve_jax(arch, sampled, prefix_sharing=sharing)
    got, summary = _serve_port(arch, sampled, prefix_sharing=sharing)
    assert got == want
    assert _counters(summary) == _counters(jax_summary)
    # the workload exercises what it claims to
    assert summary["preemptions"] > 0 and summary["packed_segments"] > 0
    assert summary["prefill_chunks"] > len(PROMPT_LENS)
    assert summary["decode_only_steps"] > 0
    assert (summary["prefix_hit_tokens"] > 0) == sharing


def test_moe_mixed_sampling_without_sharing_matches_jax(moe_base):
    want, jax_summary = _serve_jax(MOE, sampled=True)
    got, summary = _serve_port(MOE, sampled=True)
    assert got == want and _counters(summary) == _counters(jax_summary)
    greedy = moe_base[0]
    assert any(got[r] != greedy[r] for r in got)
    for i in range(0, len(PROMPT_LENS), 4):          # the cycle's greedy rows
        assert got[i + 1] == greedy[i + 1]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_moe_schedule_variants_reproduce_the_reference(moe_base, variant):
    """Each schedule variant's streams are the reference's at that
    schedule; so the port holds (or breaks) each identity exactly where
    the reference does."""
    change = VARIANTS[variant]
    want, jax_summary = _serve_jax(MOE, **change)
    got, summary = _serve_port(MOE, **change)
    assert got == want and _counters(summary) == _counters(jax_summary)
    base = _serve_port(MOE)[0]
    assert base == moe_base[0]
    assert (got == base) == (want == moe_base[0]) == MOE_IDENTITY_HOLDS[variant]


def _kernel_plan() -> InferencePlan:
    plan = InferencePlan("serve", "h100")
    for stage in ("decode", "prefill_chunk"):
        plan.choices[f"{stage}.attention"] = OpChoice(
            "cuda_attention", {"block_q": 4, "max_segments": 4}, 0.0)
        for role in MATMUL_ROLES:
            plan.choices[f"{stage}.{role}"] = OpChoice("cuda_matmul", {}, 0.0)
    return plan


def test_kernel_lane_plan_serves_the_torch_lanes_streams(moe_base):
    """The kernel lanes run the attention and every role-tagged matmul
    (qkv, the shared expert's mlp_up / mlp_down, lm_head) on the kernels'
    plain versions; the router and the routed experts stay torch ops."""
    got, summary = _serve_port(MOE, router=PlanRouter(_kernel_plan()))
    torch_lanes = _serve_port(MOE)
    assert got == torch_lanes[0] == moe_base[0]
    assert _counters(summary) == _counters(torch_lanes[1])


def test_fixed_batch_engine_matches_jax():
    jmodel, jparams, model, params = _models(MOE)
    prompts = _prompts()[:4]
    mesh = _mesh()
    jeng = JaxFixedBatchEngine(jmodel, jparams, mesh, DEFAULT_RULES,
                               JaxServeConfig(batch_size=1, max_seq=64,
                                              max_new_tokens=10))
    eng = FixedBatchEngine(model, params,
                           ServeConfig(batch_size=1, max_seq=64, max_new_tokens=10),
                           device="cpu")
    for i, p in enumerate(prompts):
        jeng.submit(p, sampling=_mix(i, JaxSamplingParams))
        eng.submit(p, sampling=_mix(i, SamplingParams))
    with mesh:
        want = {r.rid: [int(t) for t in r.output] for r in jeng.run()}
    got = {r.rid: [int(t) for t in r.output] for r in eng.run()}
    assert got == want and len(got) == len(prompts)
    assert isinstance(model, DecoderLM)


# ------------------------------------------------------------- serve graph
SERVE = dict(prefill_len=700, slots=8, max_seq=1024, chunk_tokens=256,
             dtype="bfloat16")


def _structure(g):
    return ([(n.op, n.name, n.inputs, n.outputs, json.dumps(n.attrs, sort_keys=True))
             for n in g.nodes],
            {k: (tuple(v.shape), v.dtype) for k, v in g.tensors.items()},
            g.inputs, g.outputs)


@pytest.mark.parametrize("arch", [MOE, "granite-3-8b"])
def test_serve_graph_is_the_jax_graph_mlp_nodes_at_d_ff(arch):
    """The reference builds the MLP nodes at `cfg.d_ff`: for the MoE that
    is the expert width (1408 at full size), not the 4 x 1408 shared
    expert that runs on the GEMM.  The port mirrors it."""
    g = build_serve_graph(get_config(arch), **SERVE)
    assert _structure(g) == _structure(
        jrouter.build_serve_graph(jax_get_config(arch), **SERVE))
    assert g.tensors["w_up"].shape == (get_config(arch).d_model, get_config(arch).d_ff)


def test_pairs_tuned_at_the_expert_width_launch_at_the_shared_expert_width():
    """Every (tile_m, split_k) the GEMM template admits at a serve-graph
    mlp node of qwen2-moe (N or K = d_ff = 1408) is one `geometry`
    admits at the shape the shared expert runs (N or K = 5632), so a plan
    tuned on the graph never raises in serving."""
    cfg = get_config(MOE)
    wide = cfg.n_shared_experts * cfg.d_expert
    tmpl = TEMPLATES["pallas_matmul"]
    g = build_serve_graph(cfg, **SERVE)
    checked = 0
    for node in g.nodes:
        role = node.name.split(".")[1]
        if role not in ("mlp_up", "mlp_down"):
            continue
        op = op_desc_of(g, node, "bfloat16")
        m, n, k = op.gemm_view()
        n2, k2 = (wide, k) if role == "mlp_up" else (n, wide)
        assert (n if role == "mlp_up" else k) == cfg.d_ff
        for c in tmpl.enumerate_configs(op):
            if tmpl.validate(op, c):
                checked += 1
                assert KM.geometry(m, n2, k2, torch.bfloat16, c["tile_m"],
                                   c["split_k"]) is not None, (node.name, c)
    assert checked > 0
