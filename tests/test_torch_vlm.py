"""The port's vlm backbone (pixtral-12b, its vision frontend a stub of
precomputed patch embeddings) against the JAX package on the CPU, in
f32 with bridged weights and numpy-made inputs, at
``tests/conftest.reduce_cfg``'s size with 4/2 heads and with 4/4
(G = 1): the patches before the text, the logits, the loss over the text
positions and every gradient leaf under "none", "full" and "dots", with
the plain and the vocab-chunked loss (the untied ``lm_head``).

Tolerance (f32; XLA and PyTorch sum in other orders): 1e-4 absolute and
relative, as ``tests/test_torch_mamba.py`` holds the mamba family."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduce_cfg
from repro.configs import get_config as jax_get_config
from repro.models import registry as jax_registry
from repro.models import transformer as jax_transformer
from repro_torch.configs import get_config
from repro_torch.models import bridge, registry, transformer

ARCH = "pixtral-12b"
TOL = dict(atol=1e-4, rtol=1e-4)
VARIANTS = {"gqa": {}, "g1": dict(num_kv_heads=4)}
POLICIES = ["none", "full", "dots"]
PATCHES = 6                      # vision positions before the 10 text ones


def port_cfg(jcfg):
    return get_config(jcfg.name).with_overrides(
        **{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def setup(variant="gqa", **kw):
    jcfg = reduce_cfg(jax_get_config(ARCH), dtype="float32",
                      **VARIANTS[variant], **kw)
    jparams = jax_registry.init_params(jcfg, jax.random.PRNGKey(2))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    rs = np.random.RandomState(3)
    toks = rs.randint(0, jcfg.vocab_size, size=(2, 11)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "vision_embeds": rs.randn(2, PATCHES, jcfg.d_model)
             .astype(np.float32)}
    return jcfg, jparams, port_cfg(jcfg), params, batch


def test_config_and_the_stub():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jax_get_config(ARCH))
    assert transformer.VISION_PATCHES == jax_transformer.VISION_PATCHES
    jcfg, jparams, cfg, params, batch = setup()
    assert registry.module_for(cfg) is transformer
    assert "lm_head" in params and not cfg.tie_embeddings
    x = transformer.embed_tokens(params, cfg,
                                 torch.from_numpy(batch["tokens"]),
                                 torch.from_numpy(batch["vision_embeds"]))
    jx = jax_transformer.embed_tokens(jparams, jcfg,
                                      jnp.asarray(batch["tokens"]),
                                      jnp.asarray(batch["vision_embeds"]))
    assert x.shape == (2, PATCHES + 10, cfg.d_model)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(x[:, :PATCHES].numpy(),
                                  batch["vision_embeds"])


@pytest.fixture(scope="module", params=list(VARIANTS))
def family(request):
    jcfg, jparams, cfg, params, batch = setup(request.param)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jlogits, _ = jax_registry.forward(jparams, jcfg, jbatch)
    grads = {}
    for remat in POLICIES:
        for impl in ("plain", "chunked_vocab"):
            jc = jcfg.with_overrides(remat_policy=remat, loss_impl=impl,
                                     loss_vocab_chunk=64)
            grads[remat, impl] = jax.jit(jax.value_and_grad(
                lambda p, jc=jc: jax_registry.loss_fn(p, jc, jbatch)[0]))(
                    jparams)
    return cfg, params, batch, np.asarray(jlogits), grads


@pytest.mark.parametrize("impl", ["plain", "chunked_vocab"])
@pytest.mark.parametrize("remat", POLICIES)
def test_loss_and_every_gradient_with_vision_embeds_match_jax(family, remat,
                                                              impl):
    """The logits over patches and text, the loss over the text positions
    and every gradient leaf against jax.grad, under the policy and with
    the plain or the vocab-chunked loss; the two losses agree."""
    cfg, params, batch, jlogits, grads = family
    cfg = cfg.with_overrides(remat_policy=remat, loss_impl=impl,
                             loss_vocab_chunk=64)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        logits, _ = registry.forward(params, cfg, tbatch)
    assert logits.shape == (2, PATCHES + 10, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), jlogits, **TOL)
    leaves = [t.detach().clone().requires_grad_()
              for t in jax.tree.leaves(params)]
    tree = jax.tree.unflatten(jax.tree.structure(params), leaves)
    loss, _ = registry.loss_fn(tree, cfg, tbatch)
    g = torch.autograd.grad(loss, leaves)
    jloss, jgrads = grads[remat, impl]
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    np.testing.assert_allclose(float(jloss),
                               float(grads[remat, "plain"][0]), **TOL)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jgrads)[0]]
    assert len(g) == len(paths) and "['lm_head']" in paths
    for path, got, want in zip(paths, g, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=path, **TOL)


def test_without_vision_embeds_the_text_alone():
    """A batch without ``vision_embeds`` runs the text alone, as the JAX
    registry's forward does."""
    jcfg, jparams, cfg, params, batch = setup()
    jl, _ = jax_registry.forward(jparams, jcfg,
                                 {"tokens": jnp.asarray(batch["tokens"])})
    with torch.no_grad():
        logits, _ = registry.forward(params, cfg, {
            "tokens": torch.from_numpy(batch["tokens"])})
    assert logits.shape == (2, 10, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
