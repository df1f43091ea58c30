"""The training options the port used to refuse, against the JAX package
on the CPU: the vocab-chunked cross entropy (value and both gradients),
every checkpoint policy of both families, and head padding; and the
kernel launches each policy makes, against ``kernel_launches_per_step``.

Tolerances: f32 losses and logits rel 1e-5; gradients within 1e-4 of the
leaf's largest entry (f32 sums run in another order in XLA and PyTorch);
a bf16 ``dx`` also within one bf16 rounding step of each entry, since
the same f32 value can round to either neighbour after a last-bit
difference."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduce_cfg
from repro.configs import get_config as jax_get_config
from repro.models import registry as jax_registry
from repro.train.losses import chunked_vocab_xent as jax_chunked
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import train as train_launch
from repro_torch.models import bridge, layers, registry
from repro_torch.train import optimizer as opt
from repro_torch.train.losses import chunked_vocab_xent, plain_xent

POLICIES = ["none", "full", "subblock", "attn_only", "dots"]
BF16_STEP = 2.0 ** -8


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_cfg(jcfg):
    import dataclasses
    return get_config(jcfg.name).with_overrides(
        **{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def assert_grad_close(got, want, rtol=0.0):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    top = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=1e-4 * top, rtol=rtol)


def assert_logits_close(got, want):
    """f32 logits: max abs error within 1e-5 of the largest logit."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=1e-5 * float(np.abs(want).max()), rtol=0)


def bf16_np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


# ---------------------------------------------------------------------------
# chunked_vocab_xent
# ---------------------------------------------------------------------------

# (V, chunk): V a multiple of the chunk, V not a multiple, chunk > V
VOCABS = [(64, 16), (50, 16), (20, 32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("V,chunk", VOCABS)
def test_chunked_vocab_xent_matches_jax(V, chunk, transpose, dtype):
    B, S, D = 2, 8, 32
    rs = np.random.RandomState(V + chunk + transpose)
    x = rs.randn(B, S, D).astype(np.float32)
    table = (rs.randn(D, V) if transpose else rs.randn(V, D)) \
        .astype(np.float32) * 0.3
    labels = rs.randint(0, V, size=(B, S)).astype(np.int32)
    labels[0, 0], labels[1, -1] = 0, V - 1          # the first and last ids
    jx = jnp.asarray(x, dtype)

    def jloss(x_, t_):
        return jax_chunked(x_, t_, jnp.asarray(labels), chunk, transpose)

    jval, (jdx, jdt) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jx, jnp.asarray(table))
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    tt = torch.from_numpy(table).requires_grad_()
    val = chunked_vocab_xent(tx, tt, torch.from_numpy(labels), chunk,
                             transpose)
    dx, dt = torch.autograd.grad(val, (tx, tt))
    assert dx.dtype == tx.dtype and dt.dtype == torch.float32
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5)
    assert_grad_close(bf16_np(dx), np.asarray(jdx, np.float32),
                      rtol=BF16_STEP if dtype == "bfloat16" else 0.0)
    assert_grad_close(dt.numpy(), np.asarray(jdt))
    # and the same value as the plain loss over the full f32 logits
    logits = torch.matmul(tx.detach(), (tt if transpose else tt.t())
                          .detach().to(tx.dtype)).float()
    np.testing.assert_allclose(float(val.detach()), float(plain_xent(
        logits, torch.from_numpy(labels))), rtol=1e-5)


def _dense_setup(arch, B=2, S=16, **over):
    jcfg = reduce_cfg(jax_get_config(arch), dtype="float32", **over)
    jparams = jax_registry.init_params(jcfg, jax.random.PRNGKey(1))
    params = bridge.params_from_numpy(np_tree(jparams), device="cpu")
    rs = np.random.RandomState(2)
    toks = rs.randint(0, jcfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return jcfg, jparams, port_cfg(jcfg), params, batch


def _loss_and_grads(cfg, params, batch):
    leaves = [t.requires_grad_() for t in jax.tree.leaves(params)]
    loss, _ = registry.loss_fn(params, cfg,
                               {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    return loss, torch.autograd.grad(loss, leaves)


def _jax_loss_and_grads(jcfg, jparams, batch):
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_registry.loss_fn(p, jcfg, jbatch)[0])(jparams)
    return jloss, jax.tree.leaves(jgrads)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "llama3-405b"])
def test_dense_chunked_loss_matches_jax_and_plain(arch):
    """loss_impl="chunked_vocab" over the tied embedding (qwen2.5-3b) and
    the untied lm_head (llama3-405b), with a vocabulary of 256 in chunks
    of 48 (the last one padded): the loss and gradients equal the JAX
    chunked loss's, and the loss equals the port's own plain loss."""
    jcfg, jparams, cfg, params, batch = _dense_setup(
        arch, loss_impl="chunked_vocab", loss_vocab_chunk=48)
    loss, grads = _loss_and_grads(cfg, params, batch)
    jloss, jgrads = _jax_loss_and_grads(jcfg, jparams, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert len(grads) == len(jgrads)
    for g, jg in zip(grads, jgrads):
        assert_grad_close(g.numpy(), jg)
    with torch.no_grad():
        plain, _ = registry.loss_fn(
            params, cfg.with_overrides(loss_impl="plain"),
            {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(plain), rtol=1e-5)


# ---------------------------------------------------------------------------
# checkpoint policies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ["smollm-360m", "qwen2.5-3b",
                                  "llama3-405b"])
def test_dense_gradients_match_jax_under_each_policy(arch, policy):
    """Every leaf of the port's gradient against jax.grad of the JAX loss
    under the same checkpoint policy (llama3-405b: untied lm_head)."""
    jcfg, jparams, cfg, params, batch = _dense_setup(arch,
                                                     remat_policy=policy)
    loss, grads = _loss_and_grads(cfg, params, batch)
    jloss, jgrads = _jax_loss_and_grads(jcfg, jparams, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert len(grads) == len(jgrads)
    for g, jg in zip(grads, jgrads):
        assert_grad_close(g.numpy(), jg)


def test_policies_give_the_same_gradients_as_full():
    """On one side, the five policies change what is kept and recomputed,
    never the values: the gradients equal "full"'s bit for bit."""
    base = None
    for policy in POLICIES:
        _, _, cfg, params, batch = _dense_setup("smollm-360m",
                                                remat_policy=policy)
        _, grads = _loss_and_grads(cfg, params, batch)
        if base is None:
            base = grads
        assert all(torch.equal(a, b) for a, b in zip(grads, base)), policy


def test_mamba_dots_gradients_match_jax():
    jcfg = reduce_cfg(jax_get_config("mamba2-1.3b"), dtype="float32",
                      remat_policy="dots")
    jparams = jax_registry.init_params(jcfg, jax.random.PRNGKey(1))
    params = bridge.params_from_numpy(np_tree(jparams), device="cpu")
    cfg = port_cfg(jcfg)
    rs = np.random.RandomState(3)
    toks = rs.randint(0, jcfg.vocab_size, size=(2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss, grads = _loss_and_grads(cfg, params, batch)
    jloss, jgrads = _jax_loss_and_grads(jcfg, jparams, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for g, jg in zip(grads, jgrads):
        assert_grad_close(g.numpy(), jg)
    _, full = _loss_and_grads(cfg.with_overrides(remat_policy="full"),
                              bridge.params_from_numpy(np_tree(jparams),
                                                       device="cpu"), batch)
    assert all(torch.equal(a, b) for a, b in zip(grads, full))


def test_dots_policy_saves_only_matrix_products():
    """The selective policy keeps the outputs of mm/addmm/bmm/baddbmm and
    recomputes everything else, the kernels' ``torch.empty`` outputs
    included."""
    must, prefer = (torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE,
                    torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)
    aten = torch.ops.aten
    for op in (aten.mm.default, aten.addmm.default, aten.bmm.default,
               aten.baddbmm.default):
        assert layers._save_dots(None, op) == must
    for op in (aten.empty.memory_format, aten.mul.Tensor, aten.add.Tensor,
               aten.exp.default, aten.clone.default):
        assert layers._save_dots(None, op) == prefer


def _count_launches(monkeypatch):
    from repro_torch.kernels import ops
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
    return calls


@pytest.mark.parametrize("arch,policy", [
    *(("smollm-360m", p) for p in POLICIES),
    ("qwen2.5-3b", "subblock"), ("mamba2-1.3b", "dots")])
def test_kernel_launches_per_step_as_derived(monkeypatch, arch, policy):
    """The launch counts chip_smoke.py asserts on the card, held against
    the calls one ``make_train_step`` step makes to each kernel's plain
    version (ops dispatches to exactly one of the two per launch); the
    qwen2.5-3b case is the card's train path (chunked loss, "subblock")."""
    calls = _count_launches(monkeypatch)
    jcfg = reduce_cfg(jax_get_config(arch), num_layers=3, vocab_size=64)
    cfg = port_cfg(jcfg).with_overrides(remat_policy=policy,
                                        loss_impl="chunked_vocab",
                                        loss_vocab_chunk=24)
    params = bridge.params_from_numpy(np_tree(jax_registry.init_params(
        jcfg, jax.random.PRNGKey(0))), device="cpu")
    step = train_launch.make_train_step(cfg, opt.AdamWConfig())
    batch = {k: torch.from_numpy(v)
             for k, v in SyntheticLM(64, 16, 4, seed=1).sample().items()}
    step(params, opt.init(params), batch)
    assert calls == train_launch.kernel_launches_per_step(cfg)
    NL = 3
    if cfg.family == "dense":
        again_norm = policy in ("full", "dots", "subblock")
        again_attn = policy in ("full", "dots", "attn_only")
        assert calls["flash_attention"] == (2 if again_attn else 1) * NL
        assert calls["rmsnorm_fwd"] == (4 if again_norm else 2) * NL + 1


@pytest.mark.parametrize("arch,policy", [
    *(("smollm-360m", p) for p in POLICIES), ("zamba2-1.2b", "full"),
    ("zamba2-1.2b", "none")])
def test_kernel_launches_per_step_with_ring_on_4_model_ranks(
        monkeypatch, arch, policy):
    """"ring" on a 4-rank model axis: the step under ``set_mesh`` of a
    (1, 4) mesh makes no flash_attention call (every causal
    self-attention goes around the ring, recomputed or not) and the
    norms of the single-rank step, as ``kernel_launches_per_step(cfg,
    model=4, seq=16)`` derives; with a sequence the axis does not divide
    the ring falls back and the counts are the single-rank ones."""
    from repro_torch import sharding
    from repro_torch.launch.mesh import make_mesh
    calls = _count_launches(monkeypatch)
    jcfg = reduce_cfg(jax_get_config(arch), num_layers=3, vocab_size=64)
    cfg = port_cfg(jcfg).with_overrides(remat_policy=policy,
                                        attention_impl="ring")
    params = bridge.params_from_numpy(np_tree(jax_registry.init_params(
        jcfg, jax.random.PRNGKey(0))), device="cpu")
    step = train_launch.make_train_step(cfg, opt.AdamWConfig())
    mesh = make_mesh((1, 4), ("data", "model"), "cpu")
    for seq in (16, 14):
        for k in calls:
            calls[k] = 0
        batch = {k: torch.from_numpy(v) for k, v in
                 SyntheticLM(64, seq, 4, seed=1).sample().items()}
        with sharding.set_mesh(mesh):
            step(params, opt.init(params), batch)
        assert calls == train_launch.kernel_launches_per_step(
            cfg, model=4, seq=seq)
        single = train_launch.kernel_launches_per_step(cfg)
        if seq == 16:
            assert calls["flash_attention"] == 0 < single["flash_attention"]
            assert {k: v for k, v in calls.items() if k != "flash_attention"} \
                == {k: v for k, v in single.items() if k != "flash_attention"}
        else:
            assert calls == single


# ---------------------------------------------------------------------------
# head padding
# ---------------------------------------------------------------------------

def test_padded_heads_equal_jax():
    from repro.models import layers as jax_layers
    for heads, kv, pad in ((14, 2, 4), (15, 5, 8), (16, 2, 0), (3, 2, 2)):
        jcfg = jax_get_config("qwen2-0.5b").with_overrides(
            num_heads=heads, num_kv_heads=kv, pad_heads_to=pad)
        assert layers.padded_heads(port_cfg(jcfg)) == \
            jax_layers.padded_heads(jcfg)


def test_head_padding_forward_loss_and_grads_match_jax():
    """pad_heads_to=3 turns 4/2 heads into 6/3 (a grouping of 2 either
    way, but other weights): parity is with the padded JAX model."""
    jcfg, jparams, cfg, params, batch = _dense_setup(
        "qwen2.5-3b", pad_heads_to=3, remat_policy="full")
    assert params["layers"]["attn"]["wq"].shape[2] == 6
    assert params["layers"]["attn"]["wk"].shape[2] == 3
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jlogits, _ = jax_registry.forward(
        jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        logits, _ = registry.forward(params, cfg, tb)
    assert_logits_close(logits.numpy(), jlogits)
    loss, grads = _loss_and_grads(cfg, params, batch)
    jloss, jgrads = _jax_loss_and_grads(jcfg, jparams, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for g, jg in zip(grads, jgrads):
        assert_grad_close(g.numpy(), jg)


def test_head_padding_paged_decode_matches_jax():
    """3/2 heads padded to multiples of 2 (4/2: KVH unchanged, which the
    JAX cache, sized from num_kv_heads, needs): paged decode logits and
    pool over four steps."""
    jcfg = reduce_cfg(jax_get_config("qwen2.5-3b"), dtype="float32",
                      num_heads=3, num_kv_heads=2, pad_heads_to=2)
    jparams = jax_registry.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = port_cfg(jcfg)
    params = bridge.params_from_numpy(np_tree(jparams), device="cpu")
    B, bs, nb = 3, 4, 4
    jcache = jax_registry.init_paged_cache(jcfg, B, 1 + B * nb, bs)
    cache = registry.init_paged_cache(cfg, B, 1 + B * nb, bs, "cpu")
    tables = (1 + np.arange(B * nb)).reshape(B, nb).astype(np.int32)
    pos = np.array([0, 2, 5], np.int32)
    rs = np.random.RandomState(4)
    for _ in range(4):
        toks = rs.randint(0, cfg.vocab_size, size=(B, 1)).astype(np.int32)
        jl, jcache = jax_registry.decode_step_paged(
            jparams, jcfg, jcache, jnp.asarray(toks), jnp.asarray(pos),
            jnp.asarray(tables))
        logits, cache = registry.decode_step_paged(
            params, cfg, cache, torch.from_numpy(toks), torch.from_numpy(pos),
            torch.from_numpy(tables))
        assert_logits_close(logits.numpy(), jl)
        for key in ("k", "v"):
            assert_logits_close(cache[key].numpy(), jcache[key])
        pos = pos + 1


def test_head_padding_that_changes_kv_heads_decodes_as_jax_forward():
    """pad_heads_to=3 turns 4/2 heads into 6/3.  The JAX caches are sized
    from num_kv_heads (2), so its decode under this padding fails on a
    shape; the port sizes them from the padded heads (3).  Its paged
    decode, token by token, gives the logits of the padded JAX model's
    forward over the same tokens."""
    jcfg = reduce_cfg(jax_get_config("qwen2.5-3b"), dtype="float32",
                      pad_heads_to=3)
    jparams = jax_registry.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = port_cfg(jcfg)
    params = bridge.params_from_numpy(np_tree(jparams), device="cpu")
    B, S, bs = 2, 8, 4
    toks = np.random.RandomState(5).randint(0, cfg.vocab_size, size=(B, S)) \
        .astype(np.int32)
    jlogits, _ = jax_registry.forward(jparams, jcfg,
                                      {"tokens": jnp.asarray(toks)})
    jcache = jax_registry.init_paged_cache(jcfg, B, 1 + B * 2, bs)
    with pytest.raises(ValueError):
        jax_registry.decode_step_paged(
            jparams, jcfg, jcache, jnp.asarray(toks[:, :1]),
            jnp.zeros(B, jnp.int32), jnp.ones((B, 2), jnp.int32))
    cache = registry.init_paged_cache(cfg, B, 1 + B * 2, bs, "cpu")
    assert cache["k"].shape[3] == 3
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    for t in range(S):
        logits, cache = registry.decode_step_paged(
            params, cfg, cache, torch.from_numpy(toks[:, t:t + 1]),
            torch.full((B,), t, dtype=torch.int32), tables)
        assert_logits_close(logits[:, 0].numpy(), np.asarray(jlogits)[:, t])
