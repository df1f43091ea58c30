"""The port's configs and dense model against the JAX package: config
dataclasses, parameter trees, and ``decode_step_paged`` logits and pool
on bridged weights, in f32, over several steps with mixed positions and
scattered block tables."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduce_cfg
from repro.configs import get_config as jax_get_config
from repro.models import registry as jax_registry
from repro_torch.configs import get_config
from repro_torch.models import bridge, registry, transformer

ARCHS = ["qwen2-0.5b", "smollm-360m"]
# f32 summation order differs between XLA's and PyTorch's CPU matmuls
TOL = dict(atol=1e-4, rtol=1e-4)


def port_cfg(jcfg):
    """The port's config with the same fields as a (reduced) JAX config."""
    return get_config(jcfg.name).with_overrides(
        **{f.name: getattr(jcfg, f.name)
           for f in dataclasses.fields(jcfg)})


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_jax(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_equals_jax(arch):
    jcfg = reduce_cfg(jax_get_config(arch))
    cfg = port_cfg(jcfg)
    shapes = jax.tree.map(lambda s: tuple(s.shape),
                          jax_registry.param_shapes(jcfg))
    params = registry.init_params(cfg, torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda t: tuple(t.shape), params) == shapes
    assert all(t.dtype == torch.float32
               for t in jax.tree.leaves(params))       # cfg.param_dtype


def _setup(arch, B=3, bs=4, max_blocks=4):
    jcfg = reduce_cfg(jax_get_config(arch), dtype="float32")
    jparams = jax_registry.init_params(jcfg, jax.random.PRNGKey(0))
    num_blocks = 1 + B * max_blocks
    jcache = jax_registry.init_paged_cache(jcfg, B, num_blocks, bs)
    cfg = port_cfg(jcfg)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    cache = bridge.cache_from_numpy(jax.tree.map(np.asarray, jcache),
                                    device="cpu")
    # scattered physical blocks: lane i owns a shuffled slice of the pool
    perm = 1 + np.random.RandomState(0).permutation(B * max_blocks)
    tables = perm.reshape(B, max_blocks).astype(np.int32)
    return jcfg, jparams, jcache, cfg, params, cache, tables


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_paged_matches_jax(arch):
    jcfg, jparams, jcache, cfg, params, cache, tables = _setup(arch)
    B = tables.shape[0]
    rs = np.random.RandomState(1)
    pos = np.array([0, 3, 7], np.int32)         # lanes at mixed positions
    step = jax.jit(lambda p, c, t, q, bt: jax_registry.decode_step_paged(
        p, jcfg, c, t, q, bt, None))
    for _ in range(6):
        toks = rs.randint(0, cfg.vocab_size, size=(B, 1)).astype(np.int32)
        jl, jcache = step(jparams, jcache, jnp.asarray(toks),
                          jnp.asarray(pos), jnp.asarray(tables))
        logits, cache = registry.decode_step_paged(
            params, cfg, cache, torch.from_numpy(toks),
            torch.from_numpy(pos), torch.from_numpy(tables))
        assert logits.dtype == torch.float32
        assert logits.shape == (B, 1, cfg.vocab_size)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(cache[key].numpy(),
                                       np.asarray(jcache[key]), **TOL)
        pos = pos + rs.randint(1, 3, size=B).astype(np.int32)


def test_cast_once_equals_per_op_casts():
    """Weights cast to bf16 at load give the same bf16 decode as f32
    weights cast inside each op (attn_qkv, mlp_apply, unembed)."""
    _, _, _, cfg, params, _, tables = _setup("qwen2-0.5b")
    cfg = cfg.with_overrides(dtype="bfloat16")
    B = tables.shape[0]
    toks = torch.tensor([[5], [9], [200]], dtype=torch.int32)
    pos = torch.tensor([0, 2, 5], dtype=torch.int32)
    outs = []
    for p in (params, registry.cast_params(cfg, params)):
        cache = transformer.init_paged_cache(cfg, B, 13, 4, "cpu")
        logits, cache = registry.decode_step_paged(
            p, cfg, cache, toks, pos, torch.from_numpy(tables))
        outs.append((logits, cache["k"]))
    assert registry.cast_params(cfg, params)["layers"]["ln1"].dtype == \
        torch.float32                           # norm scales stay f32
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


# ---------------------------------------------------------------------------
# The training forward, loss and gradients
# ---------------------------------------------------------------------------

def _train_setup(remat, B=2, S=24):
    jcfg = reduce_cfg(jax_get_config("smollm-360m"), dtype="float32",
                      remat_policy=remat)
    jparams = jax_registry.init_params(jcfg, jax.random.PRNGKey(1))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    rs = np.random.RandomState(2)
    toks = rs.randint(0, jcfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return jcfg, jparams, port_cfg(jcfg), params, batch


def test_forward_and_loss_match_jax():
    jcfg, jparams, cfg, params, batch = _train_setup("full")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jlogits, _ = jax_registry.forward(jparams, jcfg, jbatch)
    logits, aux = registry.forward(params, cfg, tbatch)
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    jloss, jm = jax_registry.loss_fn(jparams, jcfg, jbatch)
    loss, m = registry.loss_fn(params, cfg, tbatch)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    np.testing.assert_allclose(float(m["nll"]), float(jm["nll"]), **TOL)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_gradients_match_jax(remat):
    """Every leaf of the port's autograd gradient against jax.grad of the
    JAX loss, from the same bridged weights; under "full" each layer is
    checkpointed and recomputed in the backward."""
    jcfg, jparams, cfg, params, batch = _train_setup(remat)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jgrads = jax.grad(lambda p: jax_registry.loss_fn(p, jcfg, jbatch)[0])(
        jparams)
    leaves = [t.requires_grad_() for t in jax.tree.leaves(params)]
    loss, _ = registry.loss_fn(params, cfg,
                               {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    jleaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(jleaves)
    for g, jg in zip(grads, jleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)


def test_unported_training_options_raise(tmp_path):
    """Ring attention, which raised before it was ported, is held
    against the JAX model: smollm-360m's "ring" loss without a mesh
    (plain attention) and under a (1, 4) mesh (the ring around 4 model
    ranks) equals the JAX loss of the same config, without a mesh and
    under JAX's (1, 4) mesh, within 1e-5.  The checkpoint policies and
    the chunked loss are held in tests/test_torch_options.py, the logit
    softcap and the moe family in tests/test_torch_moe.py, and the ring's
    gradients in tests/test_torch_ring.py."""
    from tests.test_torch_ring import jax_ring_losses, port_ring_losses
    jcfg, jparams, cfg, params, batch = _train_setup("none", S=8)
    got = port_ring_losses(params, cfg, batch)
    want = jax_ring_losses(
        'reduce_cfg(get_config("smollm-360m"), dtype="float32", '
        'remat_policy="none", attention_impl="ring")', jparams, batch,
        tmp_path)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_model_flops_and_param_count_match_jax():
    for arch in ARCHS:
        jcfg = jax_get_config(arch)
        cfg = get_config(arch)
        assert registry.param_count(cfg) == jax_registry.param_count(jcfg)
        for kw in (dict(training=True, seq_len=1024),
                   dict(training=False, decode_cache_len=512),
                   dict(training=True, include_attention=False)):
            assert registry.model_flops(cfg, 8192, **kw) == \
                jax_registry.model_flops(jcfg, 8192, **kw)
