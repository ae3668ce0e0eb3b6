"""The training halves of the port's six families against the JAX package.

For one architecture of each family (dense qwen3-1.7b, moe qwen2-moe-a2.7b,
vlm qwen2-vl-2b, ssm mamba2-2.7b, hybrid zamba2-1.2b, encdec whisper-base)
at `reduced(dtype="float32")`, parameters from a JAX `init` through
`bridge`: `model.loss` and every gradient leaf against
`jax.value_and_grad(model.loss)` on the same batch (B 2, S 16, with the
vlm's `vision_embeds` and whisper's `audio_embeds` as
`tests/test_models_smoke.py` builds them) — the loss at 1e-5 relative,
each leaf at 1e-4 x that leaf's max |g|.  Also: the MoE at a capacity that
drops pairs; `remat` none / dots / full bitwise equal; `microbatches=2`
against 1 at 1e-6; the bf16 qwen3 loss within 1e-2 relative of JAX's
bf16 loss; `chunked_softmax_xent` on its direct and chunked branches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models.common import chunked_softmax_xent as jax_chunked_xent
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import build_model
from repro_torch.models import mlp as F
from repro_torch.models.common import chunked_softmax_xent
from repro_torch.tree import tree_flatten_with_paths

FAMILY_ARCHS = ["qwen3-1.7b", "qwen2-moe-a2.7b", "qwen2-vl-2b", "mamba2-2.7b",
                "zamba2-1.2b", "whisper-base"]
LOSS_RTOL = 1e-5      # f32 end to end: summation order only
GRAD_RTOL = 1e-4      # x max |g| of the leaf
BF16_LOSS_RTOL = 1e-2
B, S = 2, 16


def _batch_np(cfg, b=B, s=S):
    batch = {
        "tokens": (np.arange(b * s).reshape(b, s) % min(cfg.vocab, 97)).astype(np.int32),
        "labels": ((np.arange(b * s).reshape(b, s) + 1) % min(cfg.vocab, 97)).astype(np.int32),
    }
    if cfg.family == "vlm":
        batch["vision_embeds"] = np.full((b, cfg.n_vision_tokens, cfg.d_model), 0.02,
                                         np.float32)
    if cfg.family == "encdec":
        batch["audio_embeds"] = np.full((b, cfg.enc_seq, cfg.d_model), 0.02, np.float32)
    return batch


def _pair(arch, **overrides):
    """(JAX model, JAX params, port model, port params) on the same
    parameters."""
    jcfg = jax_get_config(arch).reduced(dtype="float32", **overrides)
    tcfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)})
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, build_model(tcfg), tparams


def _jax_loss_grads(jmodel, jparams, batch_np):
    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jmodel.loss(p, batch)[0]))(jparams)
    return float(loss), dict(tree_flatten_with_paths(jax.tree.map(np.asarray, grads)))


def _torch_batch(batch_np):
    return {k: torch.from_numpy(v) for k, v in batch_np.items()}


def _assert_grads_close(got, want):
    assert set(got) == set(want)
    for key, g in got.items():
        w = want[key]
        tol = GRAD_RTOL * max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= tol, f"{key}: max |dg| {err:.3e} > {tol:.3e}"


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_and_grads_match_jax(arch):
    jmodel, jparams, model, params = _pair(arch)
    batch_np = _batch_np(model.cfg)
    want_loss, want_grads = _jax_loss_grads(jmodel, jparams, batch_np)
    loss, metrics, grads = loss_and_grads(model, params, _torch_batch(batch_np))
    assert metrics["loss"] is not None and float(metrics["loss"]) == float(loss)
    assert abs(float(loss) - want_loss) <= LOSS_RTOL * abs(want_loss)
    _assert_grads_close(dict(tree_flatten_with_paths(grads)), want_grads)
    # the parameters are left without autograd state
    assert all(not p.requires_grad and p.grad is None
               for _, p in tree_flatten_with_paths(params))


def test_moe_dropping_pairs_matches_jax(monkeypatch):
    """capacity_factor 0.25: 4 slots an expert for 32 (token, choice)
    pairs over 8 experts, so crowded experts drop pairs; a dropped pair
    adds zero and gets zero gradient in both packages."""
    jmodel, jparams, model, params = _pair("qwen2-moe-a2.7b", capacity_factor=0.25)
    dropped = []
    route = F.moe_route

    def spy(p, cfg, x):
        flat_i, pos, w = route(p, cfg, x)
        dropped.append(int((pos >= F.moe_capacity(cfg, x.shape[1])).sum()))
        return flat_i, pos, w

    monkeypatch.setattr(F, "moe_route", spy)
    batch_np = _batch_np(model.cfg)
    want_loss, want_grads = _jax_loss_grads(jmodel, jparams, batch_np)
    loss, _, grads = loss_and_grads(model, params, _torch_batch(batch_np))
    assert sum(dropped) > 0, "no pair was dropped"
    assert abs(float(loss) - want_loss) <= LOSS_RTOL * abs(want_loss)
    _assert_grads_close(dict(tree_flatten_with_paths(grads)), want_grads)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_remat_policies_bitwise_equal(arch):
    """none, dots and full recompute the same operations on the CPU, so
    the loss and every gradient are bitwise equal."""
    _, _, model, params = _pair(arch)
    batch = _torch_batch(_batch_np(model.cfg))
    out = {}
    for remat in ("none", "dots", "full"):
        m = build_model(dataclasses.replace(model.cfg, remat=remat))
        loss, _, grads = loss_and_grads(m, params, batch)
        out[remat] = (loss, dict(tree_flatten_with_paths(grads)))
    loss0, grads0 = out["none"]
    for remat in ("dots", "full"):
        loss, grads = out[remat]
        assert torch.equal(loss, loss0), remat
        for key, g in grads.items():
            assert torch.equal(g, grads0[key]), (remat, key)


def test_microbatches_match_whole_batch():
    _, _, model, params = _pair("qwen3-1.7b")
    batch = _torch_batch(_batch_np(model.cfg, b=4))
    loss1, m1, g1 = loss_and_grads(model, params, batch, microbatches=1)
    loss2, m2, g2 = loss_and_grads(model, params, batch, microbatches=2)
    assert set(m2) == {"loss"} and set(m1) == {"loss"}
    assert abs(float(loss2) - float(loss1)) <= 1e-6 * abs(float(loss1))
    for (key, a), (_, b) in zip(tree_flatten_with_paths(g1), tree_flatten_with_paths(g2)):
        tol = 1e-6 * max(float(a.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= tol, key


def test_microbatches_must_split_the_batch():
    _, _, model, params = _pair("qwen3-1.7b")
    with pytest.raises(ValueError, match="microbatches"):
        loss_and_grads(model, params, _torch_batch(_batch_np(model.cfg, b=3)),
                       microbatches=2)


def test_bf16_loss_matches_jax_bf16():
    jcfg = jax_get_config("qwen3-1.7b").reduced()
    assert jcfg.dtype == "bfloat16"
    jmodel, jparams, model, params = _pair("qwen3-1.7b")
    jmodel = jax_build_model(jcfg)
    model = build_model(dataclasses.replace(model.cfg, dtype="bfloat16"))
    batch_np = _batch_np(model.cfg)
    want = float(jmodel.loss(jparams, {k: jnp.asarray(v) for k, v in batch_np.items()})[0])
    got = float(model.loss(params, _torch_batch(batch_np))[0])
    assert abs(got - want) <= BF16_LOSS_RTOL * abs(want), (got, want)


@pytest.mark.parametrize("s", [512, 1024, 1536])
def test_chunked_softmax_xent_both_branches(s):
    """S = 512 takes the direct branch (S <= chunk), 1024 / 1536 the
    chunked one (2 / 3 checkpointed chunks); loss and the gradients of x
    and w against JAX's, masked."""
    rng = np.random.default_rng(s)
    b, d, v = 2, 16, 37
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) * 0.5).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.8).astype(np.float32)
    want, (wgx, wgw) = jax.value_and_grad(
        lambda a, c: jax_chunked_xent(a, c, jnp.asarray(labels), jnp.asarray(mask)),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    got = chunked_softmax_xent(tx, tw, torch.from_numpy(labels), torch.from_numpy(mask))
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= LOSS_RTOL * abs(float(want))
    for g, wg in ((tx.grad, wgx), (tw.grad, wgw)):
        wg = np.asarray(wg)
        assert float(np.abs(g.numpy() - wg).max()) <= GRAD_RTOL * float(np.abs(wg).max())
