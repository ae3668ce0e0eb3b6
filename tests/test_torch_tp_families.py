"""Tensor-parallel serving of the moe, vlm and ssm families against the JAX
package.

`tests/test_torch_tp_serving.py` pins the dense decoder on a mesh; this
file pins the other families `ContinuousEngine` serves:

  * (a) the rank shards: `tp_local_params` of a MoE (the expert stacks
    split on E), a vlm (M-RoPE; at tp = 4 its 2 KV heads do not divide,
    so a rank keeps the one its query head reads) and a Mamba2 (in_proj's
    [z | x | B | C | dt] columns and the conv channels head-aligned, B and
    C whole on every rank; not the contiguous block of its "conv_dim"
    axis), `init_serving(..., tp=)` bitwise equal to cutting the whole
    model, and the slot pools at the rank's widths;
  * (b) the layers on each rank's shards with the collectives: `moe_apply`
    (bitwise the tp = 1 module where only the experts split; 1e-6 x max
    with the shared expert's "ffn" split too), `mamba_chunk_forward` and
    `mamba_decode` (1e-6 x max, their carries the rank's slices), each
    within 1e-5 x max of the JAX module;
  * (c) the cross-mesh differential: each family's tiny config (f32),
    trained briefly in JAX so that argmax margins are large, served by
    the JAX engine at tp = 1 and by the port with no mesh, on tp_mesh(1)
    and in gloo worlds of 2 and 4 CPU processes over a `FileStore`, each
    child with a timeout.  Every stream equals the JAX stream, under
    preemption (and prefix sharing for the decoder families), with one
    signature per program and nothing run at admission;
  * (d) the MoE at a width its experts do not divide: the reference's
    engine refuses it (a ValueError where it places the expert stacks,
    checked on a 4-device host platform in a subprocess), and so does the
    port's, naming the axis;
  * (e) the fixed-batch loop on a mesh: each world also drains the three
    families through `FixedBatchEngine` (the vlm with its vision
    embeddings), every rank's streams equal to the JAX FixedBatchEngine's;
    the families only the fixed-batch loop serves are refused by
    ContinuousEngine on a mesh, pointing at the fixed-batch engines.

One world of each width serves all three families (one module fixture);
the JAX engines' streams and the JAX layers run while the worlds do.
"""

import dataclasses
import inspect
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import DataConfig, SyntheticLMData
from repro.distributed.sharding import DEFAULT_RULES as JAX_RULES
from repro.distributed.sharding import prune_for_mesh as jax_prune_for_mesh
from repro.launch.steps import TrainConfig, jit_train_step, make_state_shardings
from repro.models import build_model as jax_build_model
from repro.models import mamba as jax_mamba
from repro.models import mlp as jax_mlp
from repro.optim import AdamWConfig, adamw_init
from repro.serve.engine import FixedBatchEngine as JaxFixedBatchEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.runtime import ContinuousEngine as JaxEngine
from repro.serve.runtime import RuntimeConfig as JaxRuntimeConfig
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import DEFAULT_RULES
from repro_torch.models import build_model
from repro_torch.models import mamba as port_mamba
from repro_torch.models import mlp as port_mlp
from repro_torch.serve.engine import FixedBatchEngine, ServeConfig, ServeEngine
from repro_torch.serve.router import PlanRouter
from repro_torch.serve.runtime import ContinuousEngine, RuntimeConfig
from repro_torch.serve.statecache import SlotStateCache, StateCacheConfig
from repro_torch.tree import tree_flatten_with_paths, tree_map
from test_torch_tp_serving import (CHILD_TIMEOUT_S, LAYER_RTOL_JAX, LAYER_RTOL_PORT,
                                   ROOT, FakeMesh, _auto_mesh, _close, _TP, _workload,
                                   _worlds)

TRAIN_STEPS = 40
SEED = 7

DECODER_RUNTIME = dict(max_slots=3, max_new_tokens=12, chunk_tokens=16, num_blocks=8,
                       prefix_sharing=True)
# 2 usable state rows for 3 slots: the first-chunk claim preempts
SSM_RUNTIME = dict(max_slots=3, max_new_tokens=12, chunk_tokens=16, state_slots=3)
# the fixed-batch loop on the same workload: batches of 3, left-padded (the
# ssm's batches 64 and 48 long: multiples of ssm_chunk); the vlm's with
# vision embeddings
FIXED = dict(batch_size=3, max_seq=80, max_new_tokens=12)
# family -> (arch, reduction, runtime).  The MoE: 8 experts top-2 x 64, 4
# shared (256 wide), 4 / 2 heads; the vlm: M-RoPE (4, 6, 6), 4 / 2 heads;
# the mamba2: d_in 256 = 16 heads x 16, state 16, conv_dim 288
FAMILIES = {
    "moe": ("qwen2-moe-a2.7b", dict(n_layers=2, vocab=192, dtype="float32"),
            DECODER_RUNTIME),
    "vlm": ("qwen2-vl-2b", dict(n_layers=2, vocab=192, dtype="float32"),
            DECODER_RUNTIME),
    "ssm": ("mamba2-2.7b", dict(n_layers=2, vocab=192, dtype="float32"), SSM_RUNTIME),
}


def _cfg(fam, **kw) -> ModelConfig:
    arch, red, _ = FAMILIES[fam]
    return get_config(arch).reduced(**{**red, **kw})


def _rules(cfg, tp):
    family = "ssm" if cfg.family == "ssm" else "decoder"
    return PlanRouter(None).serve_rules(DEFAULT_RULES, FakeMesh(model=tp), cfg, family)


# --------------------------------------------------- (a) the rank shards
def _shards(fam, tp):
    cfg = _cfg(fam)
    model = build_model(cfg)
    params = model.serving_params(model.init(torch.Generator().manual_seed(0)), "cpu")
    rules = _rules(cfg, tp)
    return cfg, model, params, [model.tp_local_params(params, _TP(rules, r, tp))
                                for r in range(tp)]


@pytest.mark.parametrize("tp", [2, 4])
def test_moe_shards_split_the_experts(tp):
    cfg, _, params, shards = _shards("moe", tp)
    whole = params["blocks"]["moe"]
    e = cfg.n_experts // tp
    for r, s in enumerate(shards):
        moe = s["blocks"]["moe"]
        for name in ("w_in", "w_gate", "w_out"):
            assert torch.equal(moe[name], whole[name][:, r * e:(r + 1) * e]), (r, name)
        assert torch.equal(moe["router"]["w"], whole["router"]["w"])
        assert torch.equal(moe["shared_gate"]["w"], whole["shared_gate"]["w"])
        f = whole["shared"]["w_in"]["w"].shape[-1] // tp          # "ffn" split
        assert torch.equal(moe["shared"]["w_in"]["w"],
                           whole["shared"]["w_in"]["w"][..., r * f:(r + 1) * f])
        assert torch.equal(moe["shared"]["w_out"]["w"],
                           whole["shared"]["w_out"]["w"][:, r * f:(r + 1) * f])


@pytest.mark.parametrize("tp", [2, 4])
def test_vlm_shards_keep_the_kv_heads_their_query_heads_read(tp):
    cfg, _, params, shards = _shards("vlm", tp)
    whole = params["blocks"]["attn"]
    hd, hl = cfg.hd, cfg.n_heads // tp
    for r, s in enumerate(shards):
        attn = s["blocks"]["attn"]
        assert torch.equal(attn["wq"]["w"], whole["wq"]["w"][..., r * hl * hd:(r + 1) * hl * hd])
        # the KV heads of query heads r * hl ..: the 2 split at tp = 2; at
        # tp = 4 (2 % 4) rank r keeps KV head r // 2 alone
        kv = r if tp == 2 else r // 2
        assert torch.equal(attn["wk"]["w"], whole["wk"]["w"][..., kv * hd:(kv + 1) * hd])
        assert torch.equal(attn["wv"]["w"], whole["wv"]["w"][..., kv * hd:(kv + 1) * hd])
        assert torch.equal(s["embed"]["emb"], params["embed"]["emb"].chunk(tp, 0)[r])


@pytest.mark.parametrize("tp", [2, 4])
def test_mamba_shards_are_head_aligned_with_b_and_c_whole(tp):
    """in_proj's columns are [z | x | B | C | dt]: a rank holds z and x of
    its heads, all of B and C and dt of its heads, written out here
    block by block; the contiguous 1/tp block of the columns (what the
    "conv_dim" axis alone would cut) is not what it holds."""
    cfg, _, params, shards = _shards("ssm", tp)
    whole = params["blocks"]["mamba"]
    d_in = cfg.ssm_expand * cfg.d_model
    n, nh = cfg.ssm_state, d_in // cfg.ssm_head_dim
    dl, hl = d_in // tp, nh // tp
    w, conv_w, conv_b = whole["in_proj"]["w"], whole["conv_w"], whole["conv_b"]
    for r, s in enumerate(shards):
        mp = s["blocks"]["mamba"]
        z, x = w[..., r * dl:(r + 1) * dl], w[..., d_in + r * dl:d_in + (r + 1) * dl]
        bc = w[..., 2 * d_in:2 * d_in + 2 * n]
        dt = w[..., 2 * d_in + 2 * n + r * hl:2 * d_in + 2 * n + (r + 1) * hl]
        assert torch.equal(mp["in_proj"]["w"], torch.cat([z, x, bc, dt], -1)), r
        block = w.shape[-1] // tp
        assert not torch.equal(mp["in_proj"]["w"][..., :block],
                               w[..., r * block:(r + 1) * block])
        for got, full in ((mp["conv_w"], conv_w), (mp["conv_b"], conv_b)):
            want = torch.cat([full[..., r * dl:(r + 1) * dl], full[..., d_in:]], -1)
            assert torch.equal(got, want), r
        for name in ("A_log", "D", "dt_bias"):
            assert torch.equal(mp[name], whole[name][:, r * hl:(r + 1) * hl]), name
        assert torch.equal(mp["out_proj"]["w"], whole["out_proj"]["w"][:, r * dl:(r + 1) * dl])
        assert torch.equal(mp["norm"]["scale"], whole["norm"]["scale"])
        assert port_mamba.tp_dims(cfg, _TP(_rules(cfg, tp), r, tp)) == (dl, hl, dl + 2 * n)


@pytest.mark.parametrize("fam", ["moe", "vlm", "ssm"])
def test_init_serving_draws_the_rank_shards_directly(fam):
    """`init_serving(gen, tp=)` cuts each part as it is drawn: bitwise the
    shards of the whole model drawn from the same seed."""
    cfg = _cfg(fam)
    model = build_model(cfg)
    whole = model.init_serving(torch.Generator().manual_seed(3))
    rules = _rules(cfg, 4)
    for r in (0, 3):
        tp = _TP(rules, r, 4)
        want = dict(tree_flatten_with_paths(model.tp_local_params(whole, tp)))
        got = dict(tree_flatten_with_paths(
            model.init_serving(torch.Generator().manual_seed(3), tp=tp)))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), (r, k)


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_slot_pools_have_the_rank_widths(tp):
    """conv (L, rows, W-1, d_in / tp + 2n) — not conv_dim / tp — and ssm
    (L, rows, nh / tp, hd, n)."""
    cfg = _cfg("ssm")
    d_in = cfg.ssm_expand * cfg.d_model
    n, nh = cfg.ssm_state, d_in // cfg.ssm_head_dim
    cache = SlotStateCache.for_model(StateCacheConfig(num_slots=3), cfg, "cpu",
                                     tp=_TP(_rules(cfg, tp), tp - 1, tp) if tp > 1 else None)
    assert tuple(cache.conv.shape) == (2, 3, cfg.conv_width - 1, d_in // tp + 2 * n)
    assert tuple(cache.ssm.shape) == (2, 3, nh // tp, cfg.ssm_head_dim, n)
    if tp > 1:
        assert cache.conv.shape[-1] != (d_in + 2 * n) // tp


# ---------------------------------------------- the fixed-batch families
def test_fixed_batch_families_take_no_mesh():
    """(The name is kept from when the fixed-batch engines took no mesh.)
    hybrid (zamba2) and encdec (whisper) have no state-cache adapter, so
    ContinuousEngine on a mesh still refuses them, pointing at the
    fixed-batch engines; FixedBatchEngine and ServeEngine take `mesh` /
    `rules` as the reference's engines do and serve them there
    (tests/test_torch_tp_fixed_batch.py), their models cut their shards,
    and a split the loop does not run raises naming the axis ("kv_seq"
    over "model" runs since the serving layouts of the production meshes,
    but not beside "kv_heads" on the same axis)."""
    for arch in ("zamba2-1.2b", "whisper-base"):
        cfg = get_config(arch).reduced(n_layers=2, dtype="float32")
        model = build_model(cfg)
        with pytest.raises(NotImplementedError,
                           match=r"FixedBatchEngine\(\.\.\., mesh=, rules=\)"):
            ContinuousEngine(model, {}, RuntimeConfig(), device="cpu",
                             mesh=FakeMesh(model=2), rules=DEFAULT_RULES)
        params = model.init(torch.Generator().manual_seed(0))
        local = model.tp_local_params(params, _TP(_rules(cfg, 2), 1, 2))
        assert local["lm_head"]["w"].shape[-1] == cfg.vocab // 2
        for engine in (FixedBatchEngine, ServeEngine):
            sig = inspect.signature(engine).parameters
            assert sig["mesh"].default is None and sig["rules"].default is None
            with pytest.raises(NotImplementedError, match="'ssm_state'"):
                engine(model, params, ServeConfig(), device="cpu", mesh=FakeMesh(model=2),
                       rules=DEFAULT_RULES.replace(ssm_state="model"))
            with pytest.raises(ValueError, match="'kv_seq' and 'kv_heads'"):
                engine(model, params, ServeConfig(), device="cpu", mesh=FakeMesh(model=2),
                       rules=DEFAULT_RULES.replace(kv_seq="model"))


# ------------------------------------------------------ the cross-mesh worlds
# The child: one rank of a gloo world over a FileStore, torch only.  It
# serves each family's workload (world 1: with no mesh and on tp_mesh(1);
# wider: on tp_mesh(world)), runs the layers on its shards (wider worlds)
# and at world 4 builds an engine for a MoE whose 6 experts do not divide
# the axis; it writes its results as JSON.
_CHILD = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.distributed import DEFAULT_RULES
    from repro_torch.distributed.collectives import TensorParallel, tensor_parallel
    from repro_torch.distributed.sharding import prune_for_mesh
    from repro_torch.launch.mesh import init_file_world, tp_mesh
    from repro_torch.models import build_model
    from repro_torch.models import mamba as M
    from repro_torch.models import mlp as F
    from repro_torch.serve.engine import FixedBatchEngine, ServeConfig
    from repro_torch.serve.router import PlanRouter
    from repro_torch.serve.runtime import ContinuousEngine, RuntimeConfig
    from repro_torch.serve.sampling import SamplingParams
    from repro_torch.tree import tree_map

    rank, world, store, job_path, out_path = sys.argv[1:6]
    rank, world = int(rank), int(world)
    job = json.load(open(job_path))
    init_file_world(store, rank, world)
    AXES = ("heads", "kv_heads", "ffn", "experts", "vocab", "ssm_heads", "conv_dim")

    def load(path):
        params = {}
        with np.load(path) as z:
            for key in z.files:
                node = params
                *path_, leaf = key.split("/")
                for k in path_:
                    node = node.setdefault(k, {})
                node[leaf] = torch.from_numpy(z[key])
        return params

    def workload(vocab, seed):
        rng = np.random.RandomState(seed)
        s_hot = int(rng.randint(0, vocab))
        prompts, samp = [], []
        for i, n in enumerate((48, 23, 64, 12, 48, 3)):
            start = s_hot if i % 2 == 0 else int(rng.randint(0, vocab))
            prompts.append(((start + 17 * np.arange(n)) % vocab).astype(np.int32))
            samp.append([None, SamplingParams(temperature=0.7, top_k=8, seed=11 + seed),
                         None, SamplingParams(temperature=0.5, top_p=0.9,
                                              seed=5 + seed)][i % 4])
        return prompts, samp

    def serve(model, params, rcfg, mesh):
        eng = ContinuousEngine(model, params, rcfg, device="cpu", mesh=mesh,
                               rules=None if mesh is None else DEFAULT_RULES)
        prompts, samp = workload(model.cfg.vocab, job["seed"])
        for p, s in zip(prompts, samp):
            eng.submit(p, sampling=s)
        pre = eng._unified._cache_size() + eng._decode_only._cache_size()
        done = eng.run()
        eng.cache.alloc.check_invariants()
        s = eng.metrics.summary()
        pools = ((eng.cache.conv, eng.cache.ssm) if eng.family == "ssm"
                 else (eng.cache.k, eng.cache.v))
        return {"streams": {str(r.rid): [int(t) for t in r.output] for r in done},
                "admission_compiles": pre, "unified": eng._unified._cache_size(),
                "decode_only": eng._decode_only._cache_size(),
                "preemptions": int(s["preemptions"]),
                "prefix_hits": int(s.get("prefix_hit_tokens", 0)),
                "drained": eng.cache.alloc.num_used == 0,
                "rules": None if eng.rules is None else
                         {a: eng.rules.lookup(a) for a in AXES},
                "mesh": eng.mesh_tag, "pools": [list(p.shape) for p in pools]}

    def drain_fixed(fam, model, params, mesh, extras):
        family = "ssm" if fam == "ssm" else "decoder"
        rules = (None if mesh is None else
                 PlanRouter(None).serve_rules(DEFAULT_RULES, mesh, model.cfg, family))
        eng = FixedBatchEngine(model, params, ServeConfig(**job["fixed"]), extras,
                               device="cpu", mesh=mesh, rules=rules)
        prompts, samp = workload(model.cfg.vocab, job["seed"])
        for p, s in zip(prompts, samp):
            eng.submit(p, sampling=s)
        return {str(r.rid): [int(t) for t in r.output] for r in eng.run()}

    def layers(fam, model, params, mesh, z):
        cfg = model.cfg
        family = "ssm" if fam == "ssm" else "decoder"
        rules = prune_for_mesh(PlanRouter(None).serve_rules(
            DEFAULT_RULES, mesh, cfg, family), mesh)
        tp = TensorParallel.from_mesh(mesh, rules)
        sp = model.serving_params(params, "cpu")
        first = lambda tree: tree_map(lambda t: t[0], tree)
        t = lambda k: torch.from_numpy(z[k])
        res = {}
        if fam == "moe":
            layer = first(model.tp_local_params({"blocks": sp["blocks"]}, tp)["blocks"])
            with tensor_parallel(tp):
                res["moe"] = F.moe_apply(layer["moe"], cfg, t("x"), cfg.act)
                res["moe_dec"] = F.moe_apply(layer["moe"], cfg, t("x_dec"), cfg.act)
            # the shared expert replicated (the layout race's verdict on the
            # card): expert parallelism alone
            tp_ep = TensorParallel(mesh.get_group("model"), tp.rank, tp.size,
                                   rules.replace(ffn=None))
            layer = first(model.tp_local_params({"blocks": sp["blocks"]}, tp_ep)["blocks"])
            with tensor_parallel(tp_ep):
                res["moe_ep"] = F.moe_apply(layer["moe"], cfg, t("x"), cfg.act)
                res["moe_ep_dec"] = F.moe_apply(layer["moe"], cfg, t("x_dec"), cfg.act)
        else:
            layer = first(model.tp_local_params({"blocks": sp["blocks"]}, tp)["blocks"])
            _, chans = M.tp_columns(cfg, tp.rank, tp.size)
            _, hl, _ = M.tp_dims(cfg, tp)
            cc = t("conv").index_select(-1, chans)
            h0 = t("h")[:, tp.rank * hl:(tp.rank + 1) * hl]
            with tensor_parallel(tp):
                y, c1, h1 = M.mamba_chunk_forward(layer["mamba"], cfg, t("x"), cc, h0,
                                                  int(z["seg_len"]))
                yd, c2, h2 = M.mamba_decode(layer["mamba"], cfg, t("x_dec"), cc, h0)
            res.update(chunk_y=y, chunk_conv=c1, chunk_h=h1, decode_y=yd,
                       decode_conv=c2, decode_h=h2)
        return {k: v.float().numpy().tolist() for k, v in res.items()}

    out = {"runs": {}, "layers": {}, "fixed": {}}
    for fam, spec in job["families"].items():
        cfg = get_config(spec["arch"]).reduced(**spec["cfg"])
        model = build_model(cfg)
        params = load(spec["params"])
        rcfg = RuntimeConfig(**spec["runtime"])
        extras = {"vision_embeds": np.load(spec["vision"])} if "vision" in spec else None
        if world == 1:
            out["runs"][f"{fam}/none"] = serve(model, params, rcfg, None)
            out["fixed"][f"{fam}/none"] = drain_fixed(fam, model, params, None, extras)
        mesh = tp_mesh(world, "cpu")
        out["runs"][f"{fam}/tp{world}"] = serve(model, params, rcfg, mesh)
        out["fixed"][f"{fam}/tp{world}"] = drain_fixed(fam, model, params, mesh, extras)
        if world > 1 and fam in ("moe", "ssm"):
            out["layers"][fam] = layers(fam, model, params, mesh, dict(np.load(spec["layers"])))
    if world == 4:
        spec = job["families"]["moe"]
        cfg = get_config(spec["arch"]).reduced(**{**spec["cfg"], "n_experts": 6})
        model = build_model(cfg)
        try:
            ContinuousEngine(model, model.init(torch.Generator().manual_seed(0)),
                             RuntimeConfig(**spec["runtime"]), device="cpu",
                             mesh=tp_mesh(4, "cpu"), rules=DEFAULT_RULES)
            out["indivisible"] = None
        except ValueError as e:
            out["indivisible"] = str(e)
    json.dump(out, open(out_path, "w"))
""")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Each family's tiny config (f32) trained TRAIN_STEPS steps in JAX and
    exported to an .npz of the port's tree; -> ({family: (jcfg, model,
    params, npz path)}, the mesh)."""
    tmp = tmp_path_factory.mktemp("tp_families_trained")
    mesh = _auto_mesh()
    out = {}
    for fam, (arch, red, _) in FAMILIES.items():
        jcfg = jax_get_config(arch).reduced(**red)
        model = jax_build_model(jcfg)
        data = SyntheticLMData(DataConfig(vocab=jcfg.vocab, seq_len=32, global_batch=8))
        train_cfg = TrainConfig(opt=AdamWConfig(lr=3e-3, warmup_steps=5,
                                                total_steps=TRAIN_STEPS))
        with mesh:
            params = model.init(jax.random.PRNGKey(0))
            opt = adamw_init(params)
            params, opt = jax.device_put((params, opt), make_state_shardings(
                model, mesh, jax_prune_for_mesh(JAX_RULES, mesh), train_cfg))
            specs = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                     for k, v in data.batch(0).items()}
            step = jit_train_step(model, mesh, JAX_RULES, train_cfg, specs)
            for i in range(TRAIN_STEPS):
                params, opt, _ = step(params, opt, {k: jnp.asarray(v)
                                                    for k, v in data.batch(i).items()})
        flat = dict(tree_flatten_with_paths(jax.tree.map(np.asarray, params)))
        np.savez(tmp / f"{fam}.npz", **flat)
        out[fam] = (jcfg, model, params, str(tmp / f"{fam}.npz"))
    return out, mesh


def _jax_streams(trained, fam):
    models, mesh = trained
    jcfg, model, params, _ = models[fam]
    eng = JaxEngine(model, params, mesh, JAX_RULES, JaxRuntimeConfig(**FAMILIES[fam][2]))
    prompts, samp = _workload(SEED, jcfg.vocab)
    for p, s in zip(prompts, samp):
        eng.submit(p, sampling=s)
    with mesh:
        done = eng.run()
    return {str(r.rid): [int(t) for t in r.output] for r in done}


def _vision(jcfg):
    return np.random.default_rng(4).standard_normal(
        (jcfg.n_vision_tokens, jcfg.d_model)).astype(np.float32)


def _jax_fixed_streams(trained, fam):
    models, mesh = trained
    jcfg, model, params, _ = models[fam]
    extras = {"vision_embeds": _vision(jcfg)} if fam == "vlm" else None
    eng = JaxFixedBatchEngine(model, params, mesh, JAX_RULES, JaxServeConfig(**FIXED),
                              extras)
    prompts, samp = _workload(SEED, jcfg.vocab)
    for p, s in zip(prompts, samp):
        eng.submit(p, sampling=s)
    with mesh:
        done = eng.run()
    return {str(r.rid): [int(t) for t in r.output] for r in done}


def _layer_inputs(jcfg, tmp, fam):
    """Seeded inputs of the family's layers, written to an .npz for the
    children; -> (its path, the inputs)."""
    rng = np.random.default_rng(5)
    d = jcfg.d_model
    z = {"x": rng.standard_normal((2, 32 if fam == "ssm" else 9, d)).astype(np.float32),
         "x_dec": rng.standard_normal((3 if fam == "moe" else 2, 1, d)).astype(np.float32)}
    if fam == "ssm":
        d_in = jcfg.ssm_expand * d
        nh, conv_dim = d_in // jcfg.ssm_head_dim, d_in + 2 * jcfg.ssm_state
        z["conv"] = rng.standard_normal((2, jcfg.conv_width - 1, conv_dim)).astype(np.float32)
        z["h"] = rng.standard_normal((2, nh, jcfg.ssm_head_dim, jcfg.ssm_state)
                                     ).astype(np.float32)
        z["seg_len"] = np.asarray(20, np.int32)
    path = tmp / f"layers_{fam}.npz"
    np.savez(path, **z)
    return str(path), z


def _reference_layers(trained, fam, z):
    """The JAX modules' and the single-device port modules' outputs on
    the trained layer 0 at the inputs `z`: -> (jax, port)."""
    models, _ = trained
    jcfg, _, params, _ = models[fam]
    jlayer = jax.tree.map(lambda a: a[0], params["blocks"])
    cfg = ModelConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
    model = build_model(cfg)
    sp = model.serving_params(params_from_jax(jax.tree.map(np.asarray, params)), "cpu")
    layer = tree_map(lambda t: t[0], sp["blocks"])
    t = lambda k: torch.from_numpy(z[k])  # noqa: E731
    j = lambda k: jnp.asarray(z[k])       # noqa: E731
    if fam == "moe":
        want = {"moe": jax_mlp.moe_apply(jlayer["moe"], jcfg, j("x"), jcfg.act),
                "moe_dec": jax_mlp.moe_apply(jlayer["moe"], jcfg, j("x_dec"), jcfg.act)}
        port = {"moe": port_mlp.moe_apply(layer["moe"], cfg, t("x"), cfg.act),
                "moe_dec": port_mlp.moe_apply(layer["moe"], cfg, t("x_dec"), cfg.act)}
        for d in (want, port):        # one reference for both rank layouts
            d.update(moe_ep=d["moe"], moe_ep_dec=d["moe_dec"])
    else:
        seg = int(z["seg_len"])
        y, c1, h1 = jax_mamba.mamba_chunk_forward(jlayer["mamba"], jcfg, j("x"), j("conv"),
                                                  j("h"), seg)
        yd, c2, h2 = jax_mamba.mamba_decode(jlayer["mamba"], jcfg, j("x_dec"), j("conv"),
                                            j("h"))
        want = dict(chunk_y=y, chunk_conv=c1, chunk_h=h1, decode_y=yd, decode_conv=c2,
                    decode_h=h2)
        y, c1, h1 = port_mamba.mamba_chunk_forward(layer["mamba"], cfg, t("x"), t("conv"),
                                                   t("h"), seg)
        yd, c2, h2 = port_mamba.mamba_decode(layer["mamba"], cfg, t("x_dec"), t("conv"),
                                             t("h"))
        port = dict(chunk_y=y, chunk_conv=c1, chunk_h=h1, decode_y=yd, decode_conv=c2,
                    decode_h=h2)
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in port.items()})


_JAX_INDIVISIBLE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    from jax.sharding import AxisType, Mesh
    from repro.configs import get_config
    from repro.distributed.sharding import DEFAULT_RULES
    from repro.models import build_model
    from repro.serve.runtime import ContinuousEngine, RuntimeConfig
    cfg = get_config("qwen2-moe-a2.7b").reduced(n_layers=1, n_experts=6, vocab=192,
                                                dtype="float32")
    model = build_model(cfg)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(1, 4), ("data", "model"),
                axis_types=(AxisType.Auto, AxisType.Auto))
    try:
        ContinuousEngine(model, model.init(jax.random.PRNGKey(0)), mesh, DEFAULT_RULES,
                         RuntimeConfig(max_slots=3, chunk_tokens=16))
        print("SERVED")
    except ValueError as e:
        print("VALUEERROR", str(e).replace(chr(10), " "))
""")


@pytest.fixture(scope="module")
def worlds(trained, tmp_path_factory):
    """One gloo world of each width serves the three families and runs the
    layers; the JAX engine's streams and the reference layers are
    computed while the worlds run, and the reference's engine is built
    for an indivisible MoE in a subprocess (test (d))."""
    tmp = tmp_path_factory.mktemp("tp_families_worlds")
    models, _ = trained
    job = {"seed": SEED, "families": {}, "fixed": FIXED}
    inputs = {}
    for fam, (arch, red, runtime) in FAMILIES.items():
        spec = {"arch": arch, "cfg": red, "runtime": runtime, "params": models[fam][3]}
        if fam in ("moe", "ssm"):
            spec["layers"], inputs[fam] = _layer_inputs(models[fam][0], tmp, fam)
        if fam == "vlm":
            spec["vision"] = str(tmp / "vision.npy")
            np.save(spec["vision"], _vision(models[fam][0]))
        job["families"][fam] = spec

    def meanwhile():
        streams = {fam: _jax_streams(trained, fam) for fam in FAMILIES}
        refs = {fam: _reference_layers(trained, fam, z) for fam, z in inputs.items()}
        fixed = {fam: _jax_fixed_streams(trained, fam) for fam in FAMILIES}
        return streams, refs, fixed

    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "JAX_PLATFORMS": "cpu"}
    ref = subprocess.Popen([sys.executable, "-c", _JAX_INDIVISIBLE], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        outs, (streams, refs, fixed) = _worlds(tmp, job, meanwhile, child=_CHILD)
        ref_out, ref_err = ref.communicate(timeout=CHILD_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    return outs, streams, refs, (ref.returncode, ref_out, ref_err), fixed


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_cross_mesh_streams_equal_the_jax_engine(worlds, fam):
    """Greedy and keyed-sampled streams of the port with no mesh, on
    tp_mesh(1) and in gloo worlds of 2 and 4 ranks equal the JAX engine's
    at tp = 1, token for token, under preemption (and prefix sharing for
    the decoders); every rank draws the same tokens; one signature per
    program, nothing run at admission; the pools hold the rank's KV heads
    or state widths."""
    outs, streams, _, _, _ = worlds
    for w, ranks in outs.items():
        for r in ranks[1:]:
            assert r["runs"][f"{fam}/tp{w}"] == ranks[0]["runs"][f"{fam}/tp{w}"], \
                f"world {w}: ranks differ"
    runs = {k: v for ranks in outs.values() for k, v in ranks[0]["runs"].items()
            if k.startswith(fam + "/")}
    assert sorted(runs) == sorted(f"{fam}/{leg}" for leg in ("none", "tp1", "tp2", "tp4"))
    for leg, info in runs.items():
        assert info["streams"] == streams[fam], f"{leg}: stream differs from JAX"
        assert info["admission_compiles"] == 0, (leg, info)
        assert info["unified"] == 1 and info["decode_only"] == 1, (leg, info)
        assert info["preemptions"] > 0 and info["drained"], (leg, info)
        if fam != "ssm":
            assert info["prefix_hits"] > 0, (leg, info)
    cfg = _cfg(fam)
    assert runs[f"{fam}/none"]["rules"] is None
    r2, r4 = runs[f"{fam}/tp2"], runs[f"{fam}/tp4"]
    assert r2["mesh"] == "1x2" and r4["mesh"] == "1x4"
    if fam == "ssm":
        d_in = cfg.ssm_expand * cfg.d_model
        n, nh = cfg.ssm_state, d_in // cfg.ssm_head_dim
        for tp, r in ((1, runs[f"{fam}/tp1"]), (2, r2), (4, r4)):
            if tp > 1:
                assert r["rules"]["ssm_heads"] == r["rules"]["conv_dim"] == "model"
            conv, ssm = r["pools"]
            assert conv[-1] == d_in // tp + 2 * n and ssm[2] == nh // tp, (tp, r["pools"])
    else:
        assert r4["rules"]["heads"] == "model" and r4["rules"]["kv_heads"] is None
        assert r2["pools"][0][3] == cfg.n_kv_heads // 2 and r4["pools"][0][3] == 1
        if fam == "moe":
            assert r2["rules"]["experts"] == r4["rules"]["experts"] == "model"


@pytest.mark.parametrize("fam", ["moe", "ssm"])
def test_tp_layers_match_the_single_device_and_jax_modules(worlds, fam):
    """moe_apply (experts split; the shared expert's "ffn" too) and
    mamba_chunk_forward / mamba_decode (heads and conv channels split, the
    gated norm over all of d_in) on the rank's shards at tp = 2 and 4:
    every rank's output bitwise equal, within 1e-6 x max of the tp = 1
    module — bitwise where only the experts split — and 1e-5 x max of the
    JAX module; mamba's carries are the rank's channels and heads of the
    tp = 1 carries."""
    outs, _, refs, _, _ = worlds
    jax_out, port = refs[fam]
    cfg = _cfg(fam)
    for w in (2, 4):
        ranks = outs[w]
        if fam == "moe":
            for r in ranks[1:]:
                assert r["layers"]["moe"] == ranks[0]["layers"]["moe"], f"world {w}"
            got = ranks[0]["layers"]["moe"]
            for name in ("moe", "moe_dec", "moe_ep", "moe_ep_dec"):
                _close(got[name], port[name], LAYER_RTOL_PORT, f"tp{w} {name} vs tp=1")
                _close(got[name], jax_out[name], LAYER_RTOL_JAX, f"tp{w} {name} vs JAX")
            for name in ("moe_ep", "moe_ep_dec"):
                assert np.array_equal(np.asarray(got[name], np.float32), port[name]), name
            continue
        for r, res in enumerate(ranks):
            got = res["layers"]["ssm"]
            _, chans = port_mamba.tp_columns(cfg, r, w)
            hl = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim // w
            for name in ("chunk_y", "decode_y"):
                assert got[name] == ranks[0]["layers"]["ssm"][name], f"world {w} rank {r}"
                _close(got[name], port[name], LAYER_RTOL_PORT, f"tp{w} {name} vs tp=1")
                _close(got[name], jax_out[name], LAYER_RTOL_JAX, f"tp{w} {name} vs JAX")
            for name in ("chunk_conv", "decode_conv"):
                want = port[name][..., chans.numpy()]
                _close(got[name], want, LAYER_RTOL_PORT, f"tp{w} rank {r} {name}")
                _close(got[name], jax_out[name][..., chans.numpy()], LAYER_RTOL_JAX, name)
            for name in ("chunk_h", "decode_h"):
                _close(got[name], port[name][:, r * hl:(r + 1) * hl], LAYER_RTOL_PORT,
                       f"tp{w} rank {r} {name}")
                _close(got[name], jax_out[name][:, r * hl:(r + 1) * hl], LAYER_RTOL_JAX,
                       name)


def test_moe_at_an_indivisible_width_fails_as_the_reference(worlds):
    """6 experts on a 4-wide model axis: the reference's engine raises
    ValueError where it places the expert stacks (its serve rules keep
    'experts' on the axis; no fallback to 'expert_ffn'), checked on a
    4-device host platform; the port's engine raises ValueError naming
    the axis, and so does cutting the shards directly."""
    outs, _, _, (rc, ref_out, ref_err), _ = worlds
    assert rc == 0, ref_err[-3000:]
    assert ref_out.startswith("VALUEERROR") and "divisible by 4" in ref_out, ref_out
    for res in outs[4]:
        assert res["indivisible"] is not None and "'experts'" in res["indivisible"]
    cfg = _cfg("moe", n_experts=6)
    model = build_model(cfg)
    with pytest.raises(ValueError, match="'experts'"):
        model.tp_local_params(model.init(torch.Generator().manual_seed(0)),
                              _TP(_rules(cfg, 4), 0, 4))


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_fixed_batch_engine_streams_equal_the_jax_engine_on_every_mesh(worlds, fam):
    """FixedBatchEngine (batches of 3, left-padded; the vlm with its vision
    embeddings broadcast over the batch) with no mesh, on tp_mesh(1) and in
    the worlds of 2 and 4 ranks under the guarded rules: every rank's
    greedy and keyed-sampled streams equal the JAX FixedBatchEngine's at
    tp = 1."""
    outs, _, _, _, fixed = worlds
    legs = {f"{leg}@{r}": streams for ranks in outs.values()
            for r, res in enumerate(ranks) for leg, streams in res["fixed"].items()
            if leg.startswith(fam + "/")}
    assert {k.split("@")[0] for k in legs} == {f"{fam}/{w}"
                                               for w in ("none", "tp1", "tp2", "tp4")}
    assert len(legs) == 1 + 1 + 2 + 4
    for leg, streams in legs.items():
        assert streams == fixed[fam], f"{leg}: fixed-batch stream differs from JAX"
