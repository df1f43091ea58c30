"""The port's configs against the JAX package's: every architecture's
dataclass, the assigned-shapes table, and the analytical parameter and
FLOP counts of every family; an unknown family raises as the JAX
registry's does."""
import dataclasses

import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import list_configs as jax_list_configs
from repro.configs import shapes as jax_shapes
from repro.models import registry as jax_registry
from repro_torch.configs import get_config, list_configs, shapes
from repro_torch.models import registry

ARCHS = ["granite-moe-3b-a800m", "grok-1-314b", "llama3-405b",
         "mamba2-1.3b", "pixtral-12b", "qwen2-0.5b", "qwen2.5-3b",
         "smollm-360m", "whisper-tiny", "zamba2-1.2b"]
COUNTED = ["qwen2-0.5b", "qwen2.5-3b", "smollm-360m", "llama3-405b",
           "mamba2-1.3b", "granite-moe-3b-a800m", "grok-1-314b",
           "zamba2-1.2b", "whisper-tiny", "pixtral-12b"]


def test_every_arch_is_registered():
    assert list_configs() == jax_list_configs() == ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_jax(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_get_config(arch))


def test_shapes_table_equals_jax():
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jax_shapes.SHAPES.items()}
    for name in shapes.SHAPES:
        assert dataclasses.asdict(shapes.get_shape(name)) == \
            dataclasses.asdict(jax_shapes.get_shape(name))
        for arch in ARCHS:
            assert shapes.shape_applicable(get_config(arch),
                                           shapes.get_shape(name)) == \
                jax_shapes.shape_applicable(jax_get_config(arch),
                                            jax_shapes.get_shape(name))
    with pytest.raises(KeyError, match="unknown shape"):
        shapes.get_shape("train_1k")


@pytest.mark.parametrize("arch", COUNTED)
def test_param_counts_equal_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    for active in (False, True):
        assert registry.param_count(cfg, active) == \
            jax_registry.param_count(jcfg, active)
        assert registry.non_embedding_param_count(cfg, active) == \
            jax_registry.non_embedding_param_count(jcfg, active)
    for kw in (dict(training=True, seq_len=1024),
               dict(training=False, decode_cache_len=512),
               dict(training=True, include_attention=False)):
        assert registry.model_flops(cfg, 8192, **kw) == \
            jax_registry.model_flops(jcfg, 8192, **kw)


def test_qwen2_5_3b_size():
    """3.09 B parameters, 311 M of them the (tied) embedding."""
    cfg = get_config("qwen2.5-3b")
    total = cfg.param_count()
    assert total == 3_085_938_688
    assert total - registry.non_embedding_param_count(cfg) == 151936 * 2048


def test_unknown_family_raises_value_error_as_jax():
    bad = dict(family="bogus")
    with pytest.raises(ValueError, match="^bogus$"):
        jax_registry.module_for(
            jax_get_config("qwen2-0.5b").with_overrides(**bad))
    cfg = get_config("qwen2-0.5b").with_overrides(**bad)
    with pytest.raises(ValueError, match="^bogus$"):
        registry.module_for(cfg)
    with pytest.raises(ValueError, match="^bogus$"):
        registry.param_count(cfg)
