"""The port's architecture registry against the JAX package's.

All ten configurations of `repro_torch.configs` equal
`repro.configs.get_config`'s field for field, published and `reduced()`,
and so do `param_count()` / `active_param_count()` (exact integers),
`SHAPES`, `runnable` for every (arch, shape) pair and the unknown-arch
`KeyError`.  `build_model` dispatches each of the six families to the
class `repro.models.build_model` picks.  Pure data: no tolerance.
"""

import dataclasses

import pytest

from repro import configs as J
from repro_torch import configs as T
from repro.models import build_model as build_jax_model
from repro_torch.models import DecoderLM, EncDecLM, HybridLM, MambaLM, build_model

ARCHS = list(J.REGISTRY)


def test_registry_holds_the_ten_archs_in_the_reference_order():
    assert T.ARCH_NAMES == J.ARCH_NAMES
    assert len(T.ARCH_NAMES) == 10


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True], ids=["published", "reduced"])
def test_config_equals_the_jax_config_field_for_field(arch, reduced):
    jcfg, cfg = J.get_config(arch), T.get_config(arch)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    assert [f.name for f in dataclasses.fields(cfg)] == \
        [f.name for f in dataclasses.fields(jcfg)]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.q_per_kv == jcfg.q_per_kv
    if jcfg.n_heads:                     # attention-free: no head dim
        assert cfg.hd == jcfg.hd
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()


def test_shapes_and_runnable_match_for_every_pair():
    assert {k: dataclasses.asdict(v) for k, v in T.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J.SHAPES.items()}
    skipped = 0
    for arch in ARCHS:
        for name in J.SHAPES:
            want = J.runnable(J.get_config(arch), J.SHAPES[name])
            assert T.runnable(T.get_config(arch), T.SHAPES[name]) == want
            skipped += want is not None
    assert 0 < skipped < len(ARCHS)      # long_500k: full-attention archs only


def test_unknown_arch_raises_keyerror():
    with pytest.raises(KeyError, match="unknown arch"):
        T.get_config("gpt-5")


def test_the_two_new_serving_configs_carry_their_published_numbers():
    moe, granite = T.get_config("qwen2-moe-a2.7b"), T.get_config("granite-3-8b")
    assert (moe.family, moe.n_layers, moe.d_model, moe.n_heads, moe.n_kv_heads,
            moe.hd, moe.n_experts, moe.top_k, moe.d_expert, moe.n_shared_experts,
            moe.norm_topk, moe.vocab) == ("moe", 24, 2048, 16, 16, 128, 60, 4,
                                          1408, 4, False, 151936)
    assert (granite.family, granite.n_layers, granite.d_model, granite.n_heads,
            granite.n_kv_heads, granite.d_ff, granite.vocab) == \
        ("dense", 40, 4096, 32, 8, 12800, 49155)
    assert granite.vocab % 8 != 0 and granite.q_per_kv == 4


@pytest.mark.parametrize("arch", ARCHS)
def test_build_model_dispatches_as_the_reference(arch):
    cfg = T.get_config(arch)
    model = build_model(cfg)
    want = {"dense": DecoderLM, "moe": DecoderLM, "vlm": DecoderLM, "ssm": MambaLM,
            "hybrid": HybridLM, "encdec": EncDecLM}[cfg.family]
    assert type(model) is want and model.cfg is cfg
    assert type(model).__name__ == type(build_jax_model(J.get_config(arch))).__name__


def test_build_model_rejects_an_unknown_family():
    cfg = dataclasses.replace(T.get_config("qwen3-1.7b"), family="rnn")
    with pytest.raises(ValueError, match="unknown family"):
        build_model(cfg)
