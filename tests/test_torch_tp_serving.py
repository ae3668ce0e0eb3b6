"""Tensor-parallel serving of the port against the JAX package.

Four layers of pinning, as `tests/test_tp_serving.py` pins the reference:

  * `PlanRouter.serve_rules` is a pure function of the mesh's axis sizes,
    the config and the plan: every case of the reference's rule tests on
    the port's router with a stub mesh, then the port's rules axis by axis
    against the reference's on the same fabricated plans (decoder and ssm
    families);
  * the layout race: `sharded_op_desc` node for node against the
    reference's, `collective_time` against the reference's formula on the
    reference's chip fields, `select(model_parallel=n)`'s structural pins
    with the analytic fitness, plans with layouts through save / load
    (JAX-written files too);
  * the layers one by one: `embed`, `mlp_apply`, the paged attention's
    output and `lm_head_logits` on each rank's shards, held against the
    single-device module (f32, 1e-6 x max) and the JAX module (1e-5 x
    max), the collective helper bitwise equal on every rank;
  * the cross-mesh differential: the reference's tiny qwen3 trained 60
    steps in JAX (f32), exported, served by the JAX engine at tp = 1 and by
    the port with no mesh and at tp = 1 / 2 / 4 (and tp = 4 under a plan
    tuned with `model_parallel=4`), the port's widths as gloo worlds of 1,
    2 and 4 CPU processes over a `FileStore` (no port), each child with a
    timeout.  Every stream equals the JAX tp = 1 stream, under preemption
    and prefix sharing, with one signature per program and no capture at
    admission.  The multi-seed fuzz is marked slow, as the reference marks
    its own; one world of each width serves the fast differential's seed
    and the fuzz's together, and the JAX side runs while the worlds do.
    Each world also drains the fast seed's workload through
    `FixedBatchEngine` on its mesh, held to the JAX FixedBatchEngine.

The JAX engine and trainer run on a mesh built with Auto axis types (under
jax 0.9 `jax.make_mesh` gives Explicit axes, with which the reference's
serving path fails).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, Mesh

from repro import hw as jax_hw
from repro.configs import get_config as jax_get_config
from repro.core import costmodel as jax_costmodel
from repro.core.plan import InferencePlan as JaxPlan
from repro.core.plan import OpChoice as JaxChoice
from repro.core.selection import op_desc_of as jax_op_desc_of
from repro.data import DataConfig, SyntheticLMData
from repro.distributed.sharding import DEFAULT_RULES as JAX_RULES
from repro.distributed.sharding import prune_for_mesh as jax_prune_for_mesh
from repro.launch.steps import TrainConfig, jit_train_step, make_state_shardings
from repro.models import attention as jax_attention
from repro.models import build_model
from repro.models import common as jax_common
from repro.models import mlp as jax_mlp
from repro.optim import AdamWConfig, adamw_init
from repro.serve.engine import FixedBatchEngine as JaxFixedBatchEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.router import PlanRouter as JaxRouter
from repro.serve.router import build_serve_graph as jax_serve_graph
from repro.serve.runtime import ContinuousEngine as JaxEngine
from repro.serve.runtime import RuntimeConfig as JaxRuntimeConfig
from repro.serve.sampling import SamplingParams as JaxSampling
from repro_torch import hw
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import costmodel
from repro_torch.core.costmodel import ModelFitness
from repro_torch.core.plan import InferencePlan, OpChoice
from repro_torch.core.search.tuner import Tuner
from repro_torch.core.selection import op_desc_of, select
from repro_torch.distributed import DEFAULT_RULES
from repro_torch.kernels.dispatch import MATMUL_ROLES
from repro_torch.models import DecoderLM
from repro_torch.models import build_model as port_build_model
from repro_torch.models import attention as port_attention
from repro_torch.models import common as port_common
from repro_torch.models import mlp as port_mlp
from repro_torch.models.zoo import _StackedLM
from repro_torch.serve.router import PlanRouter, build_serve_graph, build_serve_plan
from repro_torch.tree import tree_flatten_with_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 240
LAYER_RTOL_PORT = 1e-6        # x max |.|: the tp = 1 module, f32
LAYER_RTOL_JAX = 1e-5         # x max |.|: the JAX module, f32


class FakeMesh:
    def __init__(self, model: int, data: int = 1):
        self.shape = {"data": data, "model": model}


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def _decoder_cfg(vocab: int = 97):
    # n_heads 4, n_kv_heads 2, head_dim 32 (reduced defaults)
    return get_config("qwen3-1.7b").reduced(n_layers=2, d_model=64, d_ff=128, vocab=vocab)


def _raced(layout: str, raced: bool = True, cls=OpChoice):
    cands = {"replicated": 1e-6, "model_parallel": 2e-6} if raced else {}
    return cls("xla", {}, 1e-6, layout=layout, layout_candidates=cands)


def _plan_with(verdicts, plan_cls=InferencePlan, choice_cls=OpChoice):
    plan = plan_cls("serve", "h100")
    for name, (layout, raced) in verdicts.items():
        plan.choices[name] = _raced(layout, raced, choice_cls)
    return plan


def _auto_mesh():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"),
                axis_types=(AxisType.Auto, AxisType.Auto))


# -------------------------------------------------------------- serve_rules
def test_serve_rules_single_device_is_identity():
    router = PlanRouter(_plan_with({"decode.mlp_up": ("replicated", True)}))
    assert router.serve_rules(DEFAULT_RULES, FakeMesh(model=1), _decoder_cfg()) \
        is DEFAULT_RULES


def test_serve_rules_no_plan_applies_divisibility_guards():
    cfg = _decoder_cfg(vocab=97)
    r = PlanRouter(None).serve_rules(DEFAULT_RULES, FakeMesh(model=2), cfg)
    assert r.lookup("heads") == "model" and r.lookup("kv_heads") == "model"
    assert r.lookup("ffn") == "model"
    assert r.lookup("vocab") is None and r.lookup("embed_vec") == "model"
    r4 = PlanRouter(None).serve_rules(DEFAULT_RULES, FakeMesh(model=4), cfg)
    assert r4.lookup("kv_heads") is None and r4.lookup("heads") == "model"


def test_serve_rules_demotes_only_on_explicit_replicated_verdict():
    cfg, mesh = _decoder_cfg(vocab=128), FakeMesh(model=2)
    r = PlanRouter(_plan_with({"decode.mlp_up": ("replicated", True)})).serve_rules(
        DEFAULT_RULES, mesh, cfg)
    assert r.lookup("ffn") is None
    assert r.lookup("heads") == "model" and r.lookup("vocab") == "model"
    r = PlanRouter(_plan_with({"prefill_chunk.attention": ("replicated", True)})
                   ).serve_rules(DEFAULT_RULES, mesh, cfg)
    assert r.lookup("heads") is None and r.lookup("kv_heads") is None
    assert r.lookup("ffn") == "model"
    r = PlanRouter(_plan_with({"decode.lm_head": ("replicated", True)})).serve_rules(
        DEFAULT_RULES, mesh, cfg)
    assert r.lookup("vocab") is None and r.lookup("embed_vec") is None


def test_serve_rules_old_plans_and_nonserve_stages_never_demote():
    cfg, mesh = _decoder_cfg(vocab=128), FakeMesh(model=2)
    r = PlanRouter(_plan_with({"decode.mlp_up": ("replicated", False)})).serve_rules(
        DEFAULT_RULES, mesh, cfg)
    assert r.lookup("ffn") == "model"
    r = PlanRouter(_plan_with({"prefill.mlp_up": ("replicated", True)})).serve_rules(
        DEFAULT_RULES, mesh, cfg)
    assert r.lookup("ffn") is None
    r = PlanRouter(_plan_with({
        "prefill.mlp_up": ("replicated", True),
        "decode.mlp_up": ("model_parallel", True),
        "prefill_chunk.mlp_up": ("model_parallel", True),
        "decode.mlp_down": ("model_parallel", True),
        "prefill_chunk.mlp_down": ("model_parallel", True),
    })).serve_rules(DEFAULT_RULES, mesh, cfg)
    assert r.lookup("ffn") == "model"


def test_serve_rules_ssm_guards_and_demotion():
    cfg = get_config("mamba2-2.7b").reduced(n_layers=2)
    d_in = cfg.ssm_expand * cfg.d_model
    nh, conv_dim = d_in // cfg.ssm_head_dim, d_in + 2 * cfg.ssm_state
    r = PlanRouter(None).serve_rules(DEFAULT_RULES, FakeMesh(model=2), cfg, family="ssm")
    assert r.lookup("ssm_heads") == ("model" if nh % 2 == 0 else None)
    assert r.lookup("conv_dim") == ("model" if conv_dim % 2 == 0 else None)
    r = PlanRouter(_plan_with({"ssm_decode.in_proj": ("replicated", True)})).serve_rules(
        DEFAULT_RULES, FakeMesh(model=2), cfg, family="ssm")
    assert r.lookup("ssm_heads") is None and r.lookup("conv_dim") is None


RULE_PLANS = {
    "none": None,
    "mlp_rep": {"decode.mlp_up": ("replicated", True)},
    "attn_rep": {"prefill_chunk.attention": ("replicated", True)},
    "lm_rep": {"decode.lm_head": ("replicated", True)},
    "old_plan": {"decode.mlp_up": ("replicated", False),
                 "decode.qkv_proj": ("replicated", False)},
    "prefill_only": {"prefill.mlp_up": ("replicated", True)},
    "all_mp": {f"{s}.{r}": ("model_parallel", True) for s in ("decode", "prefill_chunk")
               for r in MATMUL_ROLES + ("attention",)},
    "ssm_rep": {"ssm_decode.in_proj": ("replicated", True),
                "ssm_prefill_chunk.lm_head": ("replicated", True)},
    "ssm_old": {"ssm_decode.out_proj": ("replicated", False)},
}


@pytest.mark.parametrize("family,arch,vocab", [
    ("decoder", "qwen3-1.7b", 97), ("decoder", "qwen3-1.7b", 128),
    ("decoder", "granite-3-8b", None), ("ssm", "mamba2-2.7b", None)])
@pytest.mark.parametrize("plan", sorted(RULE_PLANS))
def test_serve_rules_equal_the_reference_axis_by_axis(family, arch, vocab, plan):
    over = {"vocab": vocab} if vocab else {}
    jcfg = jax_get_config(arch).reduced(n_layers=2, **over)
    cfg = _port_cfg(jcfg)
    verdicts = RULE_PLANS[plan]
    prouter = PlanRouter(None if verdicts is None else _plan_with(verdicts))
    jrouter = JaxRouter(None if verdicts is None else _plan_with(verdicts, JaxPlan, JaxChoice))
    for m in (1, 2, 4, 8, 16):
        got = prouter.serve_rules(DEFAULT_RULES, FakeMesh(model=m), cfg, family=family)
        want = jrouter.serve_rules(JAX_RULES, FakeMesh(model=m), jcfg, family=family)
        assert dict(got.rules) == dict(want.rules), (m, plan)


# ------------------------------------------------------------ layout race
@pytest.mark.parametrize("arch,over", [("qwen3-1.7b", {}),
                                       ("qwen3-1.7b", dict(n_layers=2, d_model=128,
                                                           d_ff=256, vocab=192))])
def test_sharded_op_desc_equals_the_reference_on_every_serve_node(arch, over):
    jcfg = jax_get_config(arch)
    if over:
        jcfg = jcfg.reduced(**over)
    cfg = _port_cfg(jcfg)
    kw = dict(prefill_len=64, slots=8, max_seq=1024, chunk_tokens=256, dtype="bfloat16")
    jg, pg = jax_serve_graph(jcfg, **kw), build_serve_graph(cfg, **kw)
    for jn, pn in zip(jg.toposort(), pg.toposort()):
        assert jn.name == pn.name
        jop, pop = jax_op_desc_of(jg, jn, "bfloat16"), op_desc_of(pg, pn, "bfloat16")
        if jop is None:
            assert pop is None
            continue
        role = pn.name.rsplit(".", 1)[-1]
        for tp in (1, 2, 4, 8):
            want = jax_costmodel.sharded_op_desc(jop, role, tp)
            got = costmodel.sharded_op_desc(pop, role, tp)
            if want is None:
                assert got is None, (pn.name, tp)
            else:
                assert (got.kind, dict(got.d), got.dtype, got.activation) == (
                    want.kind, dict(want.d), want.dtype, want.activation), (pn.name, tp)


def test_collective_time_is_the_reference_formula_on_its_chip_fields():
    ref_chip = jax_hw.TPU_V5E
    chip = dataclasses.replace(hw.H100,
                               link_bw=ref_chip.ici_link_bw * ref_chip.ici_links_per_axis,
                               link_hop_s=jax_costmodel.LAUNCH_OVERHEAD_S)
    for kind in ("all_reduce", "all_gather", "reduce_scatter"):
        for tp in (1, 2, 4, 8, 16):
            for nbytes in (1, 4096, 3 * 2**20, 2.5e9):
                want = jax_costmodel.collective_time(nbytes, tp, ref_chip, kind)
                got = costmodel.collective_time(nbytes, tp, chip, kind)
                assert abs(got - want) <= 1e-12 * abs(want), (kind, tp, nbytes)
    # the H100's figures: 450 GB/s a direction, the assumed hop latency
    t = costmodel.collective_time(450e6, 2, hw.H100, "all_gather")
    assert t == pytest.approx(0.5e-3 + hw.H100.link_hop_s, rel=1e-12)


def test_layout_collective_time_prices_what_the_port_runs():
    op = costmodel.OpDesc.matmul(8, 2048, 6144, dtype="bfloat16")
    out = 8 * 2048 * 2
    assert costmodel.layout_collective_time(op, "mlp_up", 4) == 0.0
    assert costmodel.layout_collective_time(op, "attention", 4) == 0.0
    # the all-reduce: an all-gather of the 4 partial outputs, one cast of
    # them to f32, 3 adds in f32, one cast back: 5 elementwise kernels
    f32 = 8 * 2048 * 4
    ew = costmodel.elementwise_time
    want = (costmodel.collective_time(4 * out, 4, hw.H100, "all_gather")
            + ew(4 * (out + f32)) + 3 * ew(3 * f32) + ew(f32 + out))
    assert costmodel.layout_collective_time(op, "mlp_down", 4) == pytest.approx(want, rel=1e-12)
    # at f32 there is nothing to cast
    op32 = costmodel.OpDesc.matmul(8, 2048, 6144, dtype="float32")
    want32 = (costmodel.collective_time(4 * f32, 4, hw.H100, "all_gather")
              + 3 * ew(3 * f32))
    assert costmodel.layout_collective_time(op32, "mlp_down", 4) == pytest.approx(
        want32, rel=1e-12)
    lm = costmodel.OpDesc.matmul(8, 151936, 2048, dtype="bfloat16")
    assert costmodel.layout_collective_time(lm, "lm_head", 2) == pytest.approx(
        costmodel.collective_time(8 * 151936 * 2, 2, hw.H100, "all_gather"), rel=1e-12)


def _model_tuner():
    return Tuner(fitness=ModelFitness(), methods=("random",), random_budget=4)


def test_plan_race_covers_both_layouts_per_matmul_stage():
    cfg = _decoder_cfg(vocab=128)
    plan = build_serve_plan(cfg, prefill_len=32, slots=4, max_seq=64,
                            tuner=_model_tuner(), model_parallel=2)
    for stage in ("decode", "prefill_chunk"):
        for role in MATMUL_ROLES + ("attention",):
            c = plan.choice(f"{stage}.{role}")
            assert set(c.layout_candidates) == {"replicated", "model_parallel"}, (stage, role)
            lc = c.layout_candidates
            fastest = min(lc, key=lc.get)
            assert c.layout == fastest or lc["replicated"] == lc[fastest]
            assert c.modeled_time_s == lc[c.layout]
    flat = build_serve_plan(cfg, prefill_len=32, slots=4, max_seq=64, tuner=_model_tuner())
    assert all(not c.layout_candidates for c in flat.choices.values())
    assert all(c.layout == "replicated" for c in flat.choices.values())


def test_indivisible_dims_are_never_raced():
    cfg = _decoder_cfg(vocab=97)
    plan = build_serve_plan(cfg, prefill_len=32, slots=4, max_seq=64,
                            tuner=_model_tuner(), model_parallel=8)
    for stage in ("decode", "prefill_chunk"):
        assert not plan.choice(f"{stage}.lm_head").layout_candidates
        assert not plan.choice(f"{stage}.attention").layout_candidates
        assert plan.choice(f"{stage}.mlp_up").layout_candidates
        assert plan.choice(f"{stage}.qkv_proj").layout_candidates


def test_select_races_the_shard_shape_on_the_tuners_fitness():
    """A model-parallel verdict carries the backend and config raced at
    the shard shape: its time is that shape's plus the collective."""
    cfg = get_config("qwen3-1.7b")
    graph = build_serve_graph(cfg, prefill_len=64, slots=8, max_seq=1024,
                              chunk_tokens=256, dtype="bfloat16")
    tuner = _model_tuner()
    plan = select(graph, tuner=tuner, model_parallel=4)
    node = next(n for n in graph.toposort() if n.name == "decode.mlp_down")
    op = op_desc_of(graph, node)
    shard = costmodel.sharded_op_desc(op, "mlp_down", 4)
    assert shard.d["k"] == cfg.d_ff // 4
    c = plan.choice("decode.mlp_down")
    hit = tuner.cache.get(hw.H100.name, shard, "pallas_matmul", fitness="model")
    mp = min(hit["runtime_s"], ModelFitness().vendor_time(shard)) + \
        costmodel.layout_collective_time(op, "mlp_down", 4)
    assert c.layout_candidates["model_parallel"] == pytest.approx(mp, rel=1e-12)


def test_layout_verdicts_roundtrip_through_plan_save_jax_files_too(tmp_path):
    verdicts = {"decode.mlp_up": ("model_parallel", True),
                "decode.lm_head": ("replicated", True)}
    for name, (plan_cls, choice_cls) in {"port": (InferencePlan, OpChoice),
                                         "jax": (JaxPlan, JaxChoice)}.items():
        plan = _plan_with(verdicts, plan_cls, choice_cls)
        plan.choices["decode.qkv_proj"] = choice_cls("xla", {}, 1e-6)   # pre-layout
        path = str(tmp_path / f"{name}.json")
        plan.save(path)
        loaded = InferencePlan.load(path)
        assert loaded.choice("decode.mlp_up").layout == "model_parallel"
        assert loaded.choice("decode.mlp_up").layout_candidates == {
            "replicated": 1e-6, "model_parallel": 2e-6}
        assert loaded.choice("decode.lm_head").layout == "replicated"
        assert loaded.choice("decode.qkv_proj").layout == "replicated"
        assert loaded.choice("decode.qkv_proj").layout_candidates == {}
        router = PlanRouter(loaded)
        assert router.layout_table("decode")["mlp_up"] == "model_parallel"
        assert router.layout_table("decode")["lm_head"] == "replicated"
        r = router.serve_rules(DEFAULT_RULES, FakeMesh(model=2), _decoder_cfg(128))
        assert r.lookup("vocab") is None and r.lookup("ffn") == "model"


# ------------------------------------------------ local shards and heads
class _TP:
    """A stand-in for `TensorParallel` without a process group."""

    def __init__(self, rules, rank, size):
        self.rules, self.rank, self.size = rules, rank, size

    def sharded(self, axis):
        return self.size > 1 and self.rules.lookup(axis) == "model"


@pytest.mark.parametrize("h,hkv,tp,want", [
    (16, 8, 2, [(0, 4), (4, 4)]),
    (16, 8, 8, [(r, 1) for r in range(8)]),
    (16, 8, 16, [(r // 2, 1) for r in range(16)]),          # kv_heads demoted
    (4, 2, 4, [(0, 1), (0, 1), (1, 1), (1, 1)]),             # the tests' tiny qwen3
    (12, 4, 6, [(0, 1), (0, 2), (1, 1), (2, 1), (2, 2), (3, 1)]),
])
def test_tp_kv_heads_maps_each_rank_to_the_kv_heads_it_reads(h, hkv, tp, want):
    cfg = get_config("qwen3-1.7b").reduced(n_heads=h, n_kv_heads=hkv, head_dim=16)
    rules = PlanRouter(None).serve_rules(DEFAULT_RULES, FakeMesh(model=tp), cfg)
    got = [port_attention.tp_kv_heads(cfg, rules, r, tp) for r in range(tp)]
    assert got == want
    for r, (first, n) in enumerate(got):
        hl = h // tp
        for j in range(hl):       # local query head j reads local KV head j // (hl / n)
            assert first + j // (hl // n) == (r * hl + j) // (h // hkv)


def test_tp_kv_heads_raises_on_unequal_groups():
    cfg = get_config("qwen3-1.7b").reduced(n_heads=6, n_kv_heads=3, head_dim=16)
    rules = PlanRouter(None).serve_rules(DEFAULT_RULES, FakeMesh(model=2), cfg)
    assert rules.lookup("kv_heads") is None and rules.lookup("heads") == "model"
    with pytest.raises(ValueError, match="equal groups"):
        port_attention.tp_kv_heads(cfg, rules, 0, 2)


def test_tp_local_params_are_the_blocks_each_rank_holds():
    cfg = get_config("qwen3-1.7b").reduced(n_layers=2, d_model=64, d_ff=128, vocab=96,
                                           dtype="float32")
    model = DecoderLM(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    rules = PlanRouter(None).serve_rules(DEFAULT_RULES, FakeMesh(model=4), cfg)
    shards = [model.tp_local_params(params, _TP(rules, r, 4)) for r in range(4)]
    attn = [s["blocks"]["attn"] for s in shards]
    whole = params["blocks"]["attn"]
    assert torch.equal(torch.cat([a["wq"]["w"] for a in attn], -1), whole["wq"]["w"])
    assert torch.equal(torch.cat([a["wo"]["w"] for a in attn], 1), whole["wo"]["w"])
    # kv_heads demoted (2 % 4): rank r keeps KV head r // 2 only
    for r, a in enumerate(attn):
        lo = (r // 2) * cfg.hd
        assert torch.equal(a["wk"]["w"], whole["wk"]["w"][..., lo:lo + cfg.hd])
    assert torch.equal(torch.cat([s["embed"]["emb"] for s in shards], 0),
                       params["embed"]["emb"])
    assert torch.equal(torch.cat([s["lm_head"]["w"] for s in shards], 1),
                       params["lm_head"]["w"])
    assert torch.equal(torch.cat([s["blocks"]["mlp"]["w_out"]["w"] for s in shards], 1),
                       params["blocks"]["mlp"]["w_out"]["w"])
    assert all(torch.equal(s["final_norm"]["scale"], params["final_norm"]["scale"])
               for s in shards)
    # the moe and vlm shard too (tests/test_torch_tp_families.py), and so do
    # the families only the fixed-batch loop serves
    # (tests/test_torch_tp_fixed_batch.py): the hybrid's shared attention
    # here; a model class without its own shards points at the engines
    hybrid = port_build_model(get_config("zamba2-1.2b").reduced(n_layers=2))
    hp = hybrid.init(torch.Generator().manual_seed(0))
    hd = hybrid.cfg.hd
    local = hybrid.tp_local_params(hp, _TP(rules, 1, 4))
    assert torch.equal(local["shared"]["attn"]["wk"]["w"],
                       hp["shared"]["attn"]["wk"]["w"][..., :hd])
    assert torch.equal(local["shared"]["attn"]["wq"]["w"],
                       hp["shared"]["attn"]["wq"]["w"][..., hd:2 * hd])
    with pytest.raises(NotImplementedError, match="FixedBatchEngine / ServeEngine"):
        _StackedLM(hybrid.cfg).tp_local_params({}, _TP(rules, 0, 4))


# ------------------------------------------- the cross-mesh differential
# The child: one rank of a gloo world over a FileStore, torch only.  It
# serves each seed's workload (world 1: with no mesh and on tp_mesh(1);
# wider: on tp_mesh(world), and at 4 also under the tuned plan), runs the
# layers on its shards, and writes its results as JSON.
_CHILD = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.core.plan import InferencePlan
    from repro_torch.distributed import DEFAULT_RULES
    from repro_torch.distributed.collectives import TensorParallel, tensor_parallel
    from repro_torch.distributed.sharding import local_params, prune_for_mesh
    from repro_torch.launch.mesh import init_file_world, tp_mesh
    from repro_torch.models import DecoderLM
    from repro_torch.models import attention as A
    from repro_torch.models import common as C
    from repro_torch.models import mlp as F
    from repro_torch.serve.engine import FixedBatchEngine, ServeConfig
    from repro_torch.serve.router import PlanRouter
    from repro_torch.serve.runtime import ContinuousEngine, RuntimeConfig
    from repro_torch.serve.sampling import SamplingParams

    rank, world, store, job_path, out_path = sys.argv[1:6]
    rank, world = int(rank), int(world)
    job = json.load(open(job_path))
    init_file_world(store, rank, world)
    cfg = get_config("qwen3-1.7b").reduced(**job["cfg"])
    model = DecoderLM(cfg)
    params = {}
    with np.load(job["params"]) as z:
        for key in z.files:
            node = params
            *path, leaf = key.split("/")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = torch.from_numpy(z[key])
    rcfg = RuntimeConfig(**job["runtime"])

    def workload(seed):
        rng = np.random.RandomState(seed)
        s_hot = int(rng.randint(0, cfg.vocab))
        prompts, samp = [], []
        for i, n in enumerate((48, 23, 64, 12, 48, 3)):
            start = s_hot if i % 2 == 0 else int(rng.randint(0, cfg.vocab))
            prompts.append(((start + 17 * np.arange(n)) % cfg.vocab).astype(np.int32))
            samp.append([None, SamplingParams(temperature=0.7, top_k=8, seed=11 + seed),
                         None, SamplingParams(temperature=0.5, top_p=0.9,
                                              seed=5 + seed)][i % 4])
        return prompts, samp

    def serve(seed, mesh, router):
        eng = ContinuousEngine(model, params, rcfg, router=router, device="cpu",
                               mesh=mesh, rules=None if mesh is None else DEFAULT_RULES)
        prompts, samp = workload(seed)
        for p, s in zip(prompts, samp):
            eng.submit(p, sampling=s)
        pre = eng._unified._cache_size() + eng._decode_only._cache_size()
        done = eng.run()
        eng.cache.alloc.check_invariants()
        s = eng.metrics.summary()
        meta = eng.trace_metadata()
        return {"streams": {str(r.rid): [int(t) for t in r.output] for r in done},
                "admission_compiles": pre, "unified": eng._unified._cache_size(),
                "decode_only": eng._decode_only._cache_size(),
                "preemptions": int(s["preemptions"]),
                "prefix_hits": int(s.get("prefix_hit_tokens", 0)),
                "drained": eng.cache.alloc.num_used == 0,
                "rules": None if eng.rules is None else
                         {a: eng.rules.lookup(a) for a in
                          ("heads", "kv_heads", "ffn", "vocab", "embed_vec")},
                "mesh": eng.mesh_tag, "meta_mesh": meta["mesh"],
                "layouts": meta["layouts"]["decode"],
                "kv_heads": int(eng.cache.k.shape[3])}

    def drain_fixed(seed, mesh):
        rules = (None if mesh is None else
                 PlanRouter(None).serve_rules(DEFAULT_RULES, mesh, cfg))
        eng = FixedBatchEngine(model, params, ServeConfig(**job["fixed"]), device="cpu",
                               mesh=mesh, rules=rules)
        prompts, samp = workload(seed)
        for p, s in zip(prompts, samp):
            eng.submit(p, sampling=s)
        return {str(r.rid): [int(t) for t in r.output] for r in eng.run()}

    out = {"runs": {}, "fixed": {}}
    if world == 1:
        out["fixed"]["none"] = drain_fixed(job["seeds"][0], None)
    out["fixed"][f"tp{world}"] = drain_fixed(job["seeds"][0], tp_mesh(world, "cpu"))
    tuned = (PlanRouter(InferencePlan.load(job["plan"]))
             if job.get("plan") and world == 4 else None)
    for seed in job["seeds"]:
        if world == 1:
            out["runs"][f"none/{seed}"] = serve(seed, None, PlanRouter(None))
        out["runs"][f"tp{world}/{seed}"] = serve(seed, tp_mesh(world, "cpu"),
                                                 PlanRouter(None))
        if tuned is not None:
            out["runs"][f"tp4_tuned/{seed}"] = serve(seed, tp_mesh(4, "cpu"), tuned)

    if job.get("layers") and world > 1:
        z = dict(np.load(job["layers"]))
        t = lambda k: torch.from_numpy(z[k])
        mesh = tp_mesh(world, "cpu")
        rules = prune_for_mesh(PlanRouter(None).serve_rules(
            DEFAULT_RULES, mesh, cfg), mesh)
        tp = TensorParallel.from_mesh(mesh, rules)
        local = model.tp_local_params(model.serving_params(params, "cpu"), tp)
        blk = local["blocks"]
        layer = {"attn": {n: {"w": blk["attn"][n]["w"][0]} for n in ("wq", "wk", "wv", "wo")},
                 "mlp": {n: {"w": blk["mlp"][n]["w"][0]} for n in blk["mlp"]}}
        layer["attn"]["q_norm"] = {"scale": blk["attn"]["q_norm"]["scale"][0]}
        layer["attn"]["k_norm"] = {"scale": blk["attn"]["k_norm"]["scale"][0]}
        first, n = model.tp_kv_heads(tp)
        kp = t("k_pool")[:, :, first:first + n].contiguous()
        vp = t("v_pool")[:, :, first:first + n].contiguous()
        res = {}
        with tensor_parallel(tp):
            res["embed"] = C.embed(local["embed"], t("tokens"), torch.float32)
            res["mlp"] = F.mlp_apply(layer["mlp"], t("x"), cfg.act)
            rows = A.decode_write_rows(t("tables"), t("lengths"), kp.shape[1])
            res["attn"] = A.attn_decode_paged(layer["attn"], cfg, t("x_dec"), kp, vp,
                                              t("tables"), t("lengths"), rows=rows)
            res["lm_head"] = C.lm_head_logits(local["lm_head"], t("x"))
        # the lm_head's fallback where the vocabulary does not divide: w's
        # rows split ("embed_vec"), the partial logits summed
        ev = rules.replace(vocab=None, embed_vec="model")
        tp_ev = TensorParallel(mesh.get_group("model"), tp.rank, tp.size, ev)
        lm_ev = local_params({"lm_head": model.serving_params(params, "cpu")["lm_head"]},
                             {"lm_head": model.logical_axes()["lm_head"]}, ev,
                             {"model": world}, {"model": tp.rank})["lm_head"]
        with tensor_parallel(tp_ev):
            res["lm_head_embed_vec"] = C.lm_head_logits(lm_ev, t("x"))
        # the helper itself: rank-dependent partials, f32 and bf16
        g = torch.Generator().manual_seed(100 + tp.rank)
        part = torch.randn((5, 7), generator=g)
        res["reduce_f32"] = tp.all_reduce(part)
        res["reduce_bf16"] = tp.all_reduce(part.to(torch.bfloat16)).float()
        res["gather"] = tp.all_gather(part, 1)
        out["layers"] = {k: v.float().numpy().tolist() for k, v in res.items()}
        out["partial"] = part.numpy().tolist()
    json.dump(out, open(out_path, "w"))
""")


def _worlds(tmp, job, meanwhile, widths=(1, 2, 4), child=_CHILD):
    """Run the `child` script in gloo worlds of each width side by side,
    and `meanwhile()` here while they run; -> ({width: [each rank's
    JSON]}, meanwhile's result).  A child that fails or outlives
    CHILD_TIMEOUT_S fails the test (every child is killed first)."""
    script = tmp / "child.py"
    script.write_text(child)
    job_path = tmp / "job.json"
    job_path.write_text(json.dumps(job))
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    procs = []
    for w in widths:
        for r in range(w):
            out = tmp / f"out{w}.{r}.json"
            p = subprocess.Popen(
                [sys.executable, str(script), str(r), str(w), str(tmp / f"store{w}"),
                 str(job_path), str(out)], env=env, cwd=str(tmp),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            procs.append((w, r, out, p))
    failures = []
    try:
        local = meanwhile()
        for w, r, _, p in procs:
            try:
                _, err = p.communicate(timeout=CHILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                failures.append(f"world {w} rank {r}: timed out")
                break
            if p.returncode != 0:
                failures.append(f"world {w} rank {r}: rc {p.returncode}\n{err[-3000:]}")
    finally:
        for _, _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not failures, "\n".join(failures)
    return {w: [json.loads(out.read_text()) for ww, _, out, _ in procs if ww == w]
            for w in widths}, local


def _workload(seed, vocab):
    rng = np.random.RandomState(seed)
    s_hot = int(rng.randint(0, vocab))
    prompts, samp = [], []
    for i, n in enumerate((48, 23, 64, 12, 48, 3)):
        start = s_hot if i % 2 == 0 else int(rng.randint(0, vocab))
        prompts.append(((start + 17 * np.arange(n)) % vocab).astype(np.int32))
        samp.append([None, JaxSampling(temperature=0.7, top_k=8, seed=11 + seed), None,
                     JaxSampling(temperature=0.5, top_p=0.9, seed=5 + seed)][i % 4])
    return prompts, samp


TINY = dict(n_layers=2, d_model=128, d_ff=256, vocab=192, dtype="float32")
RUNTIME = dict(max_slots=3, max_new_tokens=12, chunk_tokens=16, num_blocks=8,
               prefix_sharing=True)
# the fixed-batch loop on the same workload: batches of 3, left-padded
FIXED = dict(batch_size=3, max_seq=80, max_new_tokens=12)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The reference's tiny qwen3 (f32) trained 60 steps in JAX, exported
    to an .npz of the port's tree (`bridge.params_from_jax`'s leaves)."""
    jcfg = jax_get_config("qwen3-1.7b").reduced(**TINY)
    model = build_model(jcfg)
    mesh = _auto_mesh()
    data = SyntheticLMData(DataConfig(vocab=jcfg.vocab, seq_len=32, global_batch=8))
    steps = 60
    train_cfg = TrainConfig(opt=AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=steps))
    with mesh:
        params = model.init(jax.random.PRNGKey(0))
        opt = adamw_init(params)
        # placed in the step's own layout, so its first call compiles the
        # one executable every later call runs
        params, opt = jax.device_put((params, opt), make_state_shardings(
            model, mesh, jax_prune_for_mesh(JAX_RULES, mesh), train_cfg))
        specs = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in data.batch(0).items()}
        step = jit_train_step(model, mesh, JAX_RULES, train_cfg, specs)
        for i in range(steps):
            params, opt, _ = step(params, opt, {k: jnp.asarray(v)
                                                for k, v in data.batch(i).items()})
    tmp = tmp_path_factory.mktemp("tp_trained")
    flat = dict(tree_flatten_with_paths(jax.tree.map(np.asarray, params)))
    np.savez(tmp / "params.npz", **flat)
    return jcfg, model, params, mesh, str(tmp / "params.npz")


def _jax_streams(trained, seed):
    jcfg, model, params, mesh, _ = trained
    eng = JaxEngine(model, params, mesh, JAX_RULES, JaxRuntimeConfig(**RUNTIME))
    prompts, samp = _workload(seed, jcfg.vocab)
    for p, s in zip(prompts, samp):
        eng.submit(p, sampling=s)
    with mesh:
        done = eng.run()
    return {str(r.rid): [int(t) for t in r.output] for r in done}


def _jax_fixed_streams(trained, seed):
    jcfg, model, params, mesh, _ = trained
    eng = JaxFixedBatchEngine(model, params, mesh, JAX_RULES, JaxServeConfig(**FIXED))
    prompts, samp = _workload(seed, jcfg.vocab)
    for p, s in zip(prompts, samp):
        eng.submit(p, sampling=s)
    with mesh:
        done = eng.run()
    return {str(r.rid): [int(t) for t in r.output] for r in done}


def _tuned_plan(tmp):
    """The serve plan tuned with model_parallel=4 on the analytic fitness,
    as the reference's differential tunes it (at the model's f32, where
    the GEMM's tile heights differ from bf16's)."""
    cfg = get_config("qwen3-1.7b").reduced(**TINY)
    plan = build_serve_plan(cfg, prefill_len=64, slots=RUNTIME["max_slots"], max_seq=128,
                            chunk_tokens=RUNTIME["chunk_tokens"], tuner=_model_tuner(),
                            dtype=cfg.dtype, model_parallel=4)
    path = str(tmp / "plan4.json")
    plan.save(path)
    return plan, path


def _layer_inputs(trained, tmp):
    """Seeded inputs of the four layers, written to an .npz for the
    children; -> (its path, the inputs)."""
    jcfg = trained[0]
    rng = np.random.default_rng(5)
    nb, bs, nbt = 12, 8, 4
    z = {"tokens": rng.integers(0, jcfg.vocab, size=(2, 5)).astype(np.int32),
         "x": rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32),
         "x_dec": rng.standard_normal((3, 1, jcfg.d_model)).astype(np.float32),
         "k_pool": rng.standard_normal((nb, bs, jcfg.n_kv_heads, jcfg.hd)).astype(np.float32),
         "v_pool": rng.standard_normal((nb, bs, jcfg.n_kv_heads, jcfg.hd)).astype(np.float32),
         "tables": np.asarray([[3, 4, 5, 0], [7, 8, 9, 10], [0, 0, 0, 0]], np.int32),
         "lengths": np.asarray([19, 30, 0], np.int32)}
    path = tmp / "layers.npz"
    np.savez(path, **z)
    return str(path), z


def _jax_layers(trained, z):
    """The JAX modules' outputs on the trained layer 0 (and embedding, LM
    head) at the inputs `z`."""
    jcfg, _, params, _, _ = trained
    layer = jax.tree.map(lambda a: a[0], params["blocks"])
    want = {
        "embed": jax_common.embed(params["embed"], jnp.asarray(z["tokens"]), jnp.float32),
        "mlp": jax_mlp.mlp_apply(layer["mlp"], jnp.asarray(z["x"]), jcfg.act),
        # jitted: op by op it dispatches a few hundred small programs
        "attn": jax.jit(lambda p, *a: jax_attention.attn_decode_paged(p, jcfg, *a))(
            layer["attn"], jnp.asarray(z["x_dec"]), jnp.asarray(z["k_pool"]),
            jnp.asarray(z["v_pool"]), jnp.asarray(z["tables"]),
            jnp.asarray(z["lengths"]))[0],
        "lm_head": jax_common.lm_head_logits(params["lm_head"], jnp.asarray(z["x"])),
    }
    want["lm_head_embed_vec"] = want["lm_head"]
    return {k: np.asarray(v) for k, v in want.items()}


def _port_layers(trained, z):
    """The single-device port modules on the same inputs."""
    jcfg, _, params, _, _ = trained
    cfg = _port_cfg(jcfg)
    from repro_torch.bridge import params_from_jax
    tp = DecoderLM(cfg).serving_params(params_from_jax(jax.tree.map(np.asarray, params)),
                                       "cpu")
    layer = tp["blocks"]
    layer = {"attn": {n: {"w": layer["attn"][n]["w"][0]} for n in ("wq", "wk", "wv", "wo")}
             | {n: {"scale": layer["attn"][n]["scale"][0]} for n in ("q_norm", "k_norm")},
             "mlp": {n: {"w": layer["mlp"][n]["w"][0]} for n in layer["mlp"]}}
    t = lambda k: torch.from_numpy(z[k])  # noqa: E731
    kp, vp = t("k_pool").clone(), t("v_pool").clone()
    rows = port_attention.decode_write_rows(t("tables"), t("lengths"), kp.shape[1])
    out = {"embed": port_common.embed(tp["embed"], t("tokens"), torch.float32),
           "mlp": port_mlp.mlp_apply(layer["mlp"], t("x"), cfg.act),
           "attn": port_attention.attn_decode_paged(layer["attn"], cfg, t("x_dec"), kp, vp,
                                                    t("tables"), t("lengths"), rows=rows),
           "lm_head": port_common.lm_head_logits(tp["lm_head"], t("x"))}
    out["lm_head_embed_vec"] = out["lm_head"]
    return {k: v.numpy() for k, v in out.items()}


def _close(got, want, rtol, label):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, label
    err = float(np.abs(got - want).max())
    tol = rtol * float(np.abs(want).max())
    assert err <= tol, f"{label}: {err:.3e} > {tol:.3e}"


def _check_runs(outs, want_by_seed, seeds):
    """Every rank of every width gives the JAX tp = 1 streams, with the
    reference's program-count, schedule and rule pins."""
    for w, ranks in outs.items():
        for r in ranks[1:]:
            assert r["runs"] == ranks[0]["runs"], f"world {w}: ranks differ"
    runs = {k: v for ranks in outs.values() for k, v in ranks[0]["runs"].items()}
    for seed in seeds:
        legs = [f"{leg}/{seed}" for leg in ("none", "tp1", "tp2", "tp4", "tp4_tuned")]
        assert set(legs) <= set(runs), sorted(runs)
        for leg in legs:
            info = runs[leg]
            assert info["streams"] == want_by_seed[seed], f"{leg}: stream differs from JAX"
            assert info["admission_compiles"] == 0, (leg, info)
            assert info["unified"] == 1 and info["decode_only"] == 1, (leg, info)
            assert info["preemptions"] > 0 and info["prefix_hits"] > 0, (leg, info)
            assert info["drained"], leg
        assert runs[f"none/{seed}"]["rules"] is None
        r1 = runs[f"tp1/{seed}"]
        assert r1["rules"]["heads"] == "model" and r1["rules"]["vocab"] == "model"
        assert r1["mesh"] == r1["meta_mesh"] == "1x1" and r1["kv_heads"] == 2
        r4 = runs[f"tp4/{seed}"]
        assert r4["mesh"] == r4["meta_mesh"] == "1x4"
        assert r4["rules"] == {"heads": "model", "kv_heads": None, "ffn": "model",
                               "vocab": "model", "embed_vec": None}, r4["rules"]
        assert r4["kv_heads"] == 1                  # the one KV head its query head reads
        assert runs[f"tp2/{seed}"]["kv_heads"] == 1
    return runs


FAST_SEED, FUZZ_SEEDS = 7, (0, 1, 2)


@pytest.fixture(scope="module")
def worlds(trained, tmp_path_factory):
    """One gloo world of each width serves every seed (the fast
    differential's and the fuzz's) and runs the layers; the JAX engine's
    streams and the JAX layers are computed while the worlds run."""
    tmp = tmp_path_factory.mktemp("tp_worlds")
    plan, plan_path = _tuned_plan(tmp)
    layers_path, z = _layer_inputs(trained, tmp)
    seeds = (FAST_SEED,) + FUZZ_SEEDS
    job = {"cfg": TINY, "params": trained[4], "runtime": RUNTIME, "seeds": list(seeds),
           "plan": plan_path, "layers": layers_path, "fixed": FIXED}
    outs, (streams, jax_layers, fixed) = _worlds(
        tmp, job, lambda: ({s: _jax_streams(trained, s) for s in seeds},
                           _jax_layers(trained, z), _jax_fixed_streams(trained, FAST_SEED)))
    return outs, plan, z, jax_layers, streams, fixed


def test_cross_mesh_streams_byte_identical_fast(worlds):
    """Greedy and keyed-sampled streams of the port with no mesh, on
    tp_mesh(1), in gloo worlds of 2 and 4 ranks and at 4 under the tuned
    plan equal the JAX engine's at tp = 1, token for token, under
    preemption and prefix sharing; one signature per program at every
    width, nothing captured at admission."""
    outs, plan, _, _, streams, _ = worlds
    runs = _check_runs(outs, streams, [FAST_SEED])
    # the tuned plan's verdicts reach the engine's rules and its trace
    # metadata's layout table
    tuned = runs[f"tp4_tuned/{FAST_SEED}"]
    assert tuned["layouts"] == PlanRouter(plan).layout_table("decode")
    assert tuned["rules"] == {a: v for a, v in PlanRouter(plan).serve_rules(
        DEFAULT_RULES, FakeMesh(model=4), get_config("qwen3-1.7b").reduced(**TINY)
    ).rules if a in tuned["rules"]}


def test_tp_layers_match_the_single_device_and_jax_modules(trained, worlds):
    """embed (vocab rows split, masked, summed), mlp_apply (ffn split, the
    down projection's partials summed), the paged decode attention's
    output (local heads, wo's partials summed; at 4 the replicated-KV
    mapping) and lm_head_logits (vocab columns gathered, or w's rows split
    and summed) at tp = 2 and 4: every rank's result bitwise equal, within
    1e-6 x max of the tp = 1 module and 1e-5 x max of the JAX module; the
    helper's all-reduce is the f32 sum in rank order, rounded once."""
    outs, _, z, jax_layers, _, _ = worlds
    port = _port_layers(trained, z)
    for w in (2, 4):
        ranks = outs[w]
        for r in ranks[1:]:
            assert r["layers"] == ranks[0]["layers"], f"world {w}: ranks differ"
        got = ranks[0]["layers"]
        for name in ("embed", "mlp", "attn", "lm_head", "lm_head_embed_vec"):
            _close(got[name], port[name], LAYER_RTOL_PORT, f"tp{w} {name} vs tp=1")
            _close(got[name], jax_layers[name], LAYER_RTOL_JAX, f"tp{w} {name} vs JAX")
        assert np.array_equal(np.asarray(got["embed"], np.float32), port["embed"])
        parts = [np.asarray(r["partial"], np.float32) for r in ranks]
        acc = parts[0].copy()
        for p in parts[1:]:
            acc = acc + p
        assert np.array_equal(np.asarray(got["reduce_f32"], np.float32), acc)
        acc16 = torch.from_numpy(parts[0]).bfloat16().float()
        for p in parts[1:]:
            acc16 = acc16 + torch.from_numpy(p).bfloat16().float()
        assert np.array_equal(np.asarray(got["reduce_bf16"], np.float32),
                              acc16.bfloat16().float().numpy())
        assert np.array_equal(np.asarray(got["gather"], np.float32),
                              np.concatenate(parts, 1))


@pytest.mark.slow
def test_cross_mesh_streams_byte_identical_fuzz(worlds):
    """The seeded fuzz: three more workloads (prompt mixes, keys and
    preemption patterns) through the same cross-mesh differential."""
    outs, _, _, _, streams, _ = worlds
    _check_runs(outs, streams, list(FUZZ_SEEDS))


def test_fixed_batch_engine_streams_equal_the_jax_engine_on_every_mesh(worlds):
    """FixedBatchEngine (batches of 3, left-padded, the fast seed's greedy
    and keyed-sampled workload) with no mesh, on tp_mesh(1) and in the
    worlds of 2 and 4 ranks under the guarded rules (at 4 the KV heads
    replicated, each rank reading its one): every rank's streams equal
    the JAX FixedBatchEngine's at tp = 1."""
    outs, _, _, _, _, fixed = worlds
    legs = {}
    for w, ranks in outs.items():
        for r, res in enumerate(ranks):
            for leg, streams in res["fixed"].items():
                legs[f"{leg}@{r}"] = streams
    assert {k.split("@")[0] for k in legs} == {"none", "tp1", "tp2", "tp4"}
    assert len(legs) == 1 + 1 + 2 + 4
    for leg, streams in legs.items():
        assert streams == fixed, f"{leg}: fixed-batch stream differs from JAX"
