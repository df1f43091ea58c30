"""The port's encoder-decoder family (whisper-tiny) against the JAX
package on the CPU, in f32 with bridged weights and numpy-made inputs,
at ``tests/conftest.reduce_cfg``'s size (2 encoder and 2 decoder layers,
12 frames) with 4/2 heads and with 4/4 (G = 1, as whisper's 6/6): the
encoder, the training forward, loss and every gradient leaf under
"none", "full" and "dots"; the slot decode with its cross K/V filled
from the encoder (``encode``, then ``_enc_kv`` per decoder layer); the
tanh GELU; the launch counts; the entries the family lacks; the train
launcher, and the serve launcher's refusal.

Tolerance (f32; XLA and PyTorch sum in other orders): 1e-4 absolute and
relative, as ``tests/test_torch_mamba.py`` holds the mamba family."""
import contextlib
import dataclasses
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from conftest import reduce_cfg
from repro.configs import get_config as jax_get_config
from repro.models import encdec as jax_encdec
from repro.models import registry as jax_registry
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.models import bridge, encdec, layers, registry
from repro_torch.models.layers import tree_leaves

ARCH = "whisper-tiny"
TOL = dict(atol=1e-4, rtol=1e-4)
VARIANTS = {"gqa": {}, "g1": dict(num_kv_heads=4)}
POLICIES = ["none", "full", "dots"]


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_cfg(jcfg):
    return get_config(jcfg.name).with_overrides(
        **{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def with_biases(jparams, seed=5):
    """Every zero-initialised bias and LayerNorm bias made nonzero, so
    that each one's place in the arithmetic is held."""
    rs = np.random.RandomState(seed)

    def fill(path, a):
        name = jax.tree_util.keystr(path)
        if name.endswith("['bias']") or name[-6:-2] in ("'bq", "'bk", "'bv"):
            return jnp.asarray((0.1 * rs.randn(*a.shape)).astype(np.float32))
        return a

    return jax.tree_util.tree_map_with_path(fill, jparams)


@functools.lru_cache(maxsize=None)
def jax_params(variant, vocab_size):
    """The JAX weights of a variant (drawn once: the JAX init is slow on
    the CPU), biases made nonzero."""
    jcfg = reduce_cfg(jax_get_config(ARCH), dtype="float32",
                      vocab_size=vocab_size, **VARIANTS[variant])
    return with_biases(jax_registry.init_params(jcfg, jax.random.PRNGKey(1)))


def setup(variant="gqa", vocab_size=256, **kw):
    """The JAX config and weights, and the port's twins (a fresh copy:
    a train step updates the port's in place)."""
    jcfg = reduce_cfg(jax_get_config(ARCH), dtype="float32",
                      vocab_size=vocab_size, **VARIANTS[variant], **kw)
    jparams = jax_params(variant, vocab_size)
    params = bridge.params_from_numpy(np_tree(jparams), device="cpu")
    return jcfg, jparams, port_cfg(jcfg), params


def batch_of(cfg, B=2, S=10, seed=3):
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    frames = rs.randn(B, cfg.encoder_frames, cfg.d_model).astype(np.float32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "encoder_embeds": frames}


def test_config_and_param_tree_equal_jax():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jax_get_config(ARCH))
    jcfg, _, cfg, _ = setup()
    assert registry.module_for(cfg) is encdec
    assert jax.tree.map(lambda t: tuple(t.shape), registry.init_params(
        cfg, torch.Generator().manual_seed(0))) == \
        jax.tree.map(lambda s: tuple(s.shape),
                     jax_registry.param_shapes(jcfg))
    np.testing.assert_array_equal(layers.sinusoidal_positions(12, 64),
                                  jax_encdec.L.sinusoidal_positions(12, 64))


def test_cast_params_keeps_the_layernorms_f32():
    _, _, cfg, params = setup()
    cast = registry.cast_params(cfg.with_overrides(dtype="bfloat16"), params)
    for path, t in tree_leaves(cast):
        ln = any(p in encdec.LN_KEYS for p in path)
        assert t.dtype == (torch.float32 if ln else torch.bfloat16), path


def test_layernorm_matches_jax():
    rs = np.random.RandomState(0)
    x, s, b = (rs.randn(3, 5, 64).astype(np.float32),
               rs.randn(64).astype(np.float32),
               rs.randn(64).astype(np.float32))
    want = jax_encdec.L.layernorm(jnp.asarray(x), jnp.asarray(s),
                                  jnp.asarray(b), 1e-5)
    got = layers.layernorm(torch.from_numpy(x), torch.from_numpy(s),
                           torch.from_numpy(b), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.fixture(scope="module", params=list(VARIANTS))
def family(request):
    """Per variant: the JAX encoder output and logits, and the JAX loss
    and gradients under each policy, computed once."""
    jcfg, jparams, cfg, params = setup(request.param)
    batch = batch_of(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jenc = jax_encdec.encode(jparams, jcfg, jbatch["encoder_embeds"])
    jlogits, _ = jax_registry.forward(jparams, jcfg, jbatch)
    grads = {}
    for remat in POLICIES:
        jc = jcfg.with_overrides(remat_policy=remat)
        grads[remat] = jax.jit(jax.value_and_grad(
            lambda p, jc=jc: jax_registry.loss_fn(p, jc, jbatch)[0]))(jparams)
    return cfg, params, batch, np.asarray(jenc), np.asarray(jlogits), grads


def test_encode_matches_jax(family):
    cfg, params, batch, jenc, _, _ = family
    with torch.no_grad():
        enc = encdec.encode(params, cfg,
                            torch.from_numpy(batch["encoder_embeds"]))
    assert enc.shape == (2, cfg.encoder_frames, cfg.d_model)
    np.testing.assert_allclose(enc.numpy(), jenc, **TOL)


@pytest.mark.parametrize("remat", POLICIES)
def test_forward_loss_and_every_gradient_match_jax(family, remat):
    """Logits, the loss and every gradient leaf (encoder, decoder, cross
    attention, LayerNorms, both position tables) against jax.grad."""
    cfg, params, batch, _, jlogits, grads = family
    cfg = cfg.with_overrides(remat_policy=remat)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        logits, aux = registry.forward(params, cfg, tbatch)
    np.testing.assert_allclose(logits.numpy(), jlogits, **TOL)
    assert float(aux) == 0.0
    leaves = [t.detach().clone().requires_grad_()
              for t in jax.tree.leaves(params)]
    tree = jax.tree.unflatten(jax.tree.structure(params), leaves)
    loss, m = registry.loss_fn(tree, cfg, tbatch)
    g = torch.autograd.grad(loss, leaves)
    jloss, jgrads = grads[remat]
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jgrads)[0]]
    assert len(g) == len(paths) and any("xattn" in p for p in paths)
    for path, got, want in zip(paths, g, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=path, **TOL)


def test_the_tanh_gelu_is_the_one_jax_uses(family, monkeypatch):
    """``jax.nn.gelu`` is the tanh form; the exact erf GELU (PyTorch's
    default) moves the encoder's output (LayerNormed, of order 1) past
    the tolerance that the tanh form keeps."""
    cfg, params, batch, jenc, _, _ = family
    frames = torch.from_numpy(batch["encoder_embeds"])
    monkeypatch.setattr(encdec, "_gelu", F.gelu)
    with torch.no_grad():
        enc = encdec.encode(params, cfg, frames)
    assert not np.allclose(enc.numpy(), jenc, **TOL)


def test_loss_impl_is_plain_xent_as_jax(family):
    cfg, params, batch, _, _, grads = family
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        loss, _ = registry.loss_fn(
            params, cfg.with_overrides(loss_impl="chunked_vocab"), tbatch)
    np.testing.assert_allclose(float(loss), float(grads["none"][0]), **TOL)


# ---------------------------------------------------------------------------
# decode on the slot cache, cross K/V filled from the encoder
# ---------------------------------------------------------------------------

B, S = 3, 16


def fill_cross(enc_fn, kv_fn, params, decoder_layers, cache, frames, stack):
    """The only decode that has a meaning: the encoder over the frames,
    then each decoder layer's cross K/V, stacked into ``xk``/``xv``."""
    enc = enc_fn(frames)
    kvs = [kv_fn(lp, enc) for lp in decoder_layers]
    return dict(cache, xk=stack([k for k, _ in kvs]),
                xv=stack([v for _, v in kvs]))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_with_cross_kv_matches_jax(variant):
    """8 steps over 3 lanes (lane 1 restarts at step 4): logits and the
    self K/V against the JAX ``decode_step`` on a cache whose cross K/V
    both packages fill the same way."""
    jcfg, jparams, cfg, params = setup(variant)
    frames = np.random.RandomState(4).randn(
        B, cfg.encoder_frames, cfg.d_model).astype(np.float32)
    jdec = [jax.tree.map(lambda a, i=i: a[i], jparams["decoder"])
            for i in range(jcfg.num_layers)]
    jcache = fill_cross(
        lambda f: jax_encdec.encode(jparams, jcfg, f),
        lambda lp, e: jax_encdec._enc_kv(jcfg, lp, e), jparams, jdec,
        jax_registry.init_cache(jcfg, B, S), jnp.asarray(frames), jnp.stack)
    with torch.no_grad():
        cache = fill_cross(
            lambda f: encdec.encode(params, cfg, f),
            lambda lp, e: encdec._enc_kv(cfg, lp, e), params,
            layers.unstack_layers(params["decoder"]),
            registry.init_cache(cfg, B, S, "cpu"), torch.from_numpy(frames),
            torch.stack)
    for key in ("xk", "xv"):
        assert float(np.abs(np.asarray(jcache[key])).max()) > 0
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(jcache[key]), **TOL)
    jstep = jax.jit(lambda p, c, t, q: jax_registry.decode_step(
        p, jcfg, c, t, q))
    rs = np.random.RandomState(1)
    pos = np.array([0, 3, 5], np.int32)
    for i in range(8):
        if i == 4:
            pos[1] = 0
        toks = rs.randint(0, cfg.vocab_size, size=(B, 1)).astype(np.int32)
        jl, jcache = jstep(jparams, jcache, jnp.asarray(toks),
                           jnp.asarray(pos))
        with torch.no_grad():
            logits, cache = registry.decode_step(params, cfg, cache,
                                                 torch.from_numpy(toks),
                                                 torch.from_numpy(pos))
        assert logits.shape == (B, 1, cfg.vocab_size)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(cache[key].numpy(),
                                       np.asarray(jcache[key]), **TOL)
        pos = pos + 1


def test_entries_the_family_lacks_raise_as_jax():
    """No decode_hidden and no paged decode, with the JAX messages; the
    serving engine refuses the family."""
    _, _, cfg, params = setup()
    cache = registry.init_cache(cfg, 1, 4, "cpu")
    t, p = torch.zeros(1, 1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
    with pytest.raises(NotImplementedError,
                       match="decode_hidden not supported for family 'audio'"):
        registry.decode_hidden(params, cfg, cache, t, p)
    with pytest.raises(NotImplementedError,
                       match="paged decode not supported for family 'audio'"):
        registry.init_paged_cache(cfg, 1, 2, 4, "cpu")
    assert not registry.supports_paged(cfg)
    args = serve_launch.build_parser().parse_args(
        ["--arch", ARCH, "--device", "cpu", "--scale", "tiny"])
    with pytest.raises(ValueError, match="paged serving not supported"):
        serve_launch.run(args)
    with pytest.raises(ValueError, match="^bogus$"):
        registry.module_for(cfg.with_overrides(family="bogus"))


@pytest.mark.parametrize("remat", POLICIES)
def test_kernel_launches_per_step_as_derived(monkeypatch, remat):
    """One attention per encoder layer and two per decoder layer (self and
    cross), each layer recomputed under every policy but "none"; no
    rmsnorm (LayerNorm is tensor code)."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train import optimizer as opt
    names = {"rmsnorm_fwd": "rmsnorm_fwd_plain",
             "rmsnorm_bwd": "rmsnorm_bwd_plain",
             "flash_attention": "flash_attention_plain",
             "flash_decode": "flash_decode_plain",
             "ssd_chunk": "ssd_chunk_plain"}
    calls = dict.fromkeys(names, 0)

    def counting(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    for name, attr in names.items():
        monkeypatch.setattr(ops, attr, counting(name, getattr(ops, attr)))
    _, _, cfg, params = setup(vocab_size=64, remat_policy=remat)
    step = train_launch.make_train_step(cfg, opt.AdamWConfig())
    batch = {k: torch.from_numpy(v)
             for k, v in SyntheticLM(64, 8, 2, seed=1).sample().items()}
    batch["encoder_embeds"] = torch.ones(2, cfg.encoder_frames, cfg.d_model)
    step(params, opt.init(params), batch)
    assert calls == train_launch.kernel_launches_per_step(cfg)
    assert calls["flash_attention"] == (6 if remat == "none" else 12)


def test_train_launcher_feeds_encoder_embeds(tmp_path):
    """``--arch whisper-tiny --scale tiny --device cpu``: 2 encoder layers
    over 16 frames, as the JAX launcher shrinks it, every batch with
    encoder embeddings of ones in bf16; finite losses."""
    assert serve_launch.make_config(ARCH, "full") == get_config(ARCH)
    cfg = serve_launch.make_config(ARCH, "tiny")
    assert (cfg.num_encoder_layers, cfg.encoder_frames,
            cfg.max_position_embeddings) == (2, 16, 256)
    seen = []
    loss_fn = encdec.loss_fn

    def spy(params, cfg_, batch):
        seen.append((batch["encoder_embeds"].dtype,
                     tuple(batch["encoder_embeds"].shape),
                     float(batch["encoder_embeds"].float().min()),
                     float(batch["encoder_embeds"].float().max())))
        return loss_fn(params, cfg_, batch)

    encdec.loss_fn = spy
    try:
        args = train_launch.build_parser().parse_args(
            ["--arch", ARCH, "--device", "cpu", "--scale", "tiny", "--steps",
             "2", "--seq", "16", "--global-batch", "4", "--ckpt-dir",
             str(tmp_path)])
        with contextlib.redirect_stdout(io.StringIO()):
            report = train_launch.run(args, log_every=1)
    finally:
        encdec.loss_fn = loss_fn
    assert seen == [(torch.bfloat16, (4, 16, 64), 1.0, 1.0)] * 2
    assert len(report.log) == 2
    assert all(np.isfinite(m["loss"]) for m in report.log)
