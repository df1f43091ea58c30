"""The MoE family of the port against the JAX package on the CPU: the
router's top-k and GShard capacity dispatch (masks exact in f32, ties
and dropped tokens included), ``moe_apply`` and its gradients, the
granite-moe and grok-1 families (grok's logit cap in both attention
paths) under three checkpoint policies, their slot and paged decode, the
``ServeEngine`` streams unsharded and on 2 model ranks, the
expert-parallel path on the user-space all-to-all against the native
block transpose and ``moe_apply`` (bit for bit), that path with each
rank's groups and experts on a device of its own against the stacked one
(bit for bit on integer-valued inputs) and JAX, and both launchers.

Tolerances (f32; XLA and PyTorch sum in other orders): forward values
within 1e-5 of the largest entry, gradients within 1e-4 of each leaf's
largest entry, the aux loss rel 1e-5; the dispatch masks, the top-k
indices and the expert-parallel results bit for bit.  bf16 is held only
in the top-k tie order, which is exact."""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduce_cfg
from repro.configs import get_config as jax_get_config
from repro.core import ProgressEngine as JaxProgressEngine
from repro.models import layers as JL
from repro.models import registry as jax_registry
from repro.serve.engine import GenRequest as JaxGenRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.collectives.nonblocking import CollectiveSpec, UserCollectives
from repro_torch.configs import get_config
from repro_torch.core import ProgressEngine
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import flash_decode_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import bridge, layers, registry, transformer
from repro_torch.serve.engine import GenRequest, ServeEngine

MOE_ARCHS = ["granite-moe-3b-a800m", "grok-1-314b"]
POLICIES = ["none", "full", "subblock"]


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_cfg(jcfg):
    return get_config(jcfg.name).with_overrides(
        **{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def assert_fwd_close(got, want):
    """Within 1e-5 of the largest entry."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def assert_grad_close(got, want):
    """Within 1e-4 of the leaf's largest entry."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))


def moe_cfg(arch="granite-moe-3b-a800m", *, E=4, K=2, F=32, group=64,
            cf=1.25, D=32):
    """One MoE layer's config at test widths (the JAX tests' make_cfg)."""
    base = jax_get_config(arch)
    jcfg = base.with_overrides(
        num_layers=1, d_model=D, num_heads=2, num_kv_heads=2, head_dim=16,
        vocab_size=64, dtype="float32",
        moe=base.moe.__class__(num_experts=E, top_k=K, expert_d_ff=F,
                               capacity_factor=cf, group_size=group))
    return jcfg, port_cfg(jcfg)


def moe_params(jcfg, seed=0):
    jp = JL.init_tree(JL.moe_spec(jcfg), jax.random.PRNGKey(seed))
    return jp, bridge.params_from_numpy(np_tree(jp), device="cpu")


# ---------------------------------------------------------------------------
# the router: top-k order, capacity dispatch, aux loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_top_k_breaks_ties_as_jax(dtype):
    """Equal values come lower index first, as jax.lax.top_k gives them:
    values drawn from a few levels, so most rows tie."""
    rs = np.random.RandomState(0)
    probs = rs.randint(0, 4, size=(3, 50, 40)).astype(np.float32) / 4
    jv, ji = jax.lax.top_k(jnp.asarray(probs, dtype), 8)
    v, i = layers._top_k(torch.from_numpy(probs).to(getattr(torch, dtype)), 8)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.float().numpy(),
                                  np.asarray(jv, np.float32))


def tie_inputs(jcfg, Gtok=128, seed=3):
    """Tokens and a router whose logits are exact in f32 whatever the sum
    order (small multiples of 1/4 against entries in {-1/2, 0, 1/2}),
    with expert columns repeated, so the probabilities tie exactly."""
    rs = np.random.RandomState(seed)
    D, E = jcfg.d_model, jcfg.moe.num_experts
    x = (rs.randint(-4, 5, size=(2, Gtok // 2, D)) / 4).astype(np.float32)
    r = (rs.randint(-1, 2, size=(D, E)) / 2).astype(np.float32)
    r[:, 1::2] = r[:, 0::2]            # expert 2j+1 copies expert 2j
    return x, r


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_route_matches_jax(cf, ties):
    """``_moe_route`` in f32: the dispatch mask exactly, the combine
    weights and the aux loss within limits; capacity factor 0.5 drops
    tokens, and the tied router picks among equal experts as JAX does."""
    jcfg, cfg = moe_cfg(E=8, K=2, cf=cf)
    jp, p = moe_params(jcfg)
    if ties:
        x, r = tie_inputs(jcfg)
        jp = dict(jp, router=jnp.asarray(r))
        p = dict(p, router=torch.from_numpy(r))
    else:
        x = np.random.RandomState(1).randn(2, 64, 32).astype(np.float32)
    jxg, jdisp, jcomb, jaux = JL._moe_route(jp, jnp.asarray(x), jcfg)
    xg, disp, comb, aux = layers._moe_route(p, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(xg.numpy(), np.asarray(jxg))
    np.testing.assert_array_equal(disp.numpy(), np.asarray(jdisp))
    assert_fwd_close(comb.numpy(), jcomb)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    C = disp.shape[-1]
    routed = int(disp.sum())
    if cf == 0.5:                          # some token was dropped
        assert routed < x.shape[0] * x.shape[1] * cfg.moe.top_k
    assert disp.sum(dim=1).max() <= 1      # one token per capacity place
    assert C % 16 == 0 or C == xg.shape[1]


def test_capacity_drop_rows_are_zero_not_an_error():
    """A token past its expert's capacity gets an all-zero capacity row
    (jax.nn.one_hot's zero row; F.one_hot would raise): with a router
    that sends every token to experts 0 and 1, only C of them fit."""
    jcfg, cfg = moe_cfg(E=4, K=2, cf=0.25)
    jp, p = moe_params(jcfg)
    r = np.zeros((32, 4), np.float32)
    r[:, :2] = 1.0
    x = np.abs(np.random.RandomState(2).randn(1, 64, 32)).astype(np.float32)
    jp, p = dict(jp, router=jnp.asarray(r)), dict(p, router=torch.from_numpy(r))
    _, disp, comb, _ = layers._moe_route(p, torch.from_numpy(x), cfg)
    _, jdisp, jcomb, _ = JL._moe_route(jp, jnp.asarray(x), jcfg)
    C = disp.shape[-1]
    assert C == 16
    np.testing.assert_array_equal(disp.numpy(), np.asarray(jdisp))
    assert_fwd_close(comb.numpy(), jcomb)
    per_expert = disp.sum(dim=(0, 1, 3))
    assert per_expert.tolist() == [C, C, 0, 0]


# ---------------------------------------------------------------------------
# moe_apply and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_apply_and_gradients_match_jax(cf):
    """y and aux, and the gradients of sum(y * w) + aux in x, the router
    and each expert leaf, against jax.grad: the router's gradient flows
    through the gate values and the aux loss only."""
    jcfg, cfg = moe_cfg(E=4, K=2, cf=cf)
    jp, p = moe_params(jcfg)
    rs = np.random.RandomState(5)
    x = rs.randn(2, 32, 32).astype(np.float32)
    w = rs.randn(2, 32, 32).astype(np.float32)

    def jloss(p_, x_):
        y, aux = JL.moe_apply(p_, x_, jcfg)
        return jnp.sum(y * jnp.asarray(w)) + aux

    (jy, jaux) = JL.moe_apply(jp, jnp.asarray(x), jcfg)
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = layers.moe_apply(leaves, tx, cfg)
    assert_fwd_close(y.detach().numpy(), jy)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-5)
    loss = torch.sum(y * torch.from_numpy(w)) + aux
    names = sorted(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in names] + [tx])
    for name, g in zip(names, grads):
        assert_grad_close(g.numpy(), jgp[name])
        assert float(g.abs().sum()) > 0, name
    assert_grad_close(grads[-1].numpy(), jgx)


# ---------------------------------------------------------------------------
# the granite and grok families: forward, loss, gradients
# ---------------------------------------------------------------------------

def family_setup(arch, remat="none", B=2, S=32, **over):
    jcfg = reduce_cfg(jax_get_config(arch), dtype="float32",
                      remat_policy=remat, **over)
    jparams = jax_registry.init_params(jcfg, jax.random.PRNGKey(1))
    params = bridge.params_from_numpy(np_tree(jparams), device="cpu")
    rs = np.random.RandomState(2)
    toks = rs.randint(0, jcfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return jcfg, jparams, port_cfg(jcfg), params, batch


def test_reduced_configs_keep_the_family():
    for arch, cap in zip(MOE_ARCHS, (0.0, 30.0)):
        cfg = port_cfg(reduce_cfg(jax_get_config(arch)))
        assert cfg.family == "moe" and cfg.moe.num_experts == 4
        assert cfg.logit_softcap == cap
        assert "moe" in transformer.param_spec(cfg)["layers"]


@pytest.mark.parametrize("remat", POLICIES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_family_forward_loss_and_gradients_match_jax(arch, remat):
    """Logits and the summed aux loss, the loss with its nll and aux, and
    every gradient leaf, under the checkpoint policy; grok at reduced
    widths keeps its logit cap of 30 in attention and on the logits."""
    jcfg, jparams, cfg, params, batch = family_setup(arch, remat)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jlogits, jaux = jax_registry.forward(jparams, jcfg, jbatch)
    with torch.no_grad():
        logits, aux = registry.forward(params, cfg, tbatch)
    assert_fwd_close(logits.numpy(), jlogits)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)

    def jloss(p):
        return jax_registry.loss_fn(p, jcfg, jbatch)

    (jl, jm), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    leaves = [t.requires_grad_() for t in jax.tree.leaves(params)]
    loss, m = registry.loss_fn(params, cfg, tbatch)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["nll"]), float(jm["nll"]), rtol=1e-5)
    grads = torch.autograd.grad(loss, leaves)
    jleaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(jleaves)
    for g, jg in zip(grads, jleaves):
        assert_grad_close(g.numpy(), jg)


def test_loss_fn_runs_in_training_mode():
    """registry.loss_fn enters training_mode, as the JAX registry's does;
    the flag is thread-local and restored on the way out."""
    _, _, cfg, params, batch = family_setup("granite-moe-3b-a800m", S=8)
    seen = []
    moe_apply = layers.moe_apply

    def spy(*a, **kw):
        seen.append(layers.in_training())
        return moe_apply(*a, **kw)

    layers.moe_apply = spy
    try:
        registry.loss_fn(params, cfg, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
        registry.forward(params, cfg, {"tokens": torch.from_numpy(
            batch["tokens"])})
    finally:
        layers.moe_apply = moe_apply
    assert seen == [True, True, False, False]
    assert not layers.in_training()


def _count_launches(monkeypatch):
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


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_kernel_launches_per_step_cover_the_moe_family(monkeypatch, arch):
    """One ``make_train_step`` step under "full" calls each kernel's plain
    version as often as ``kernel_launches_per_step`` derives: the dense
    family's counts (the MoE layer is tensor code)."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train as train_launch
    from repro_torch.train import optimizer as opt
    calls = _count_launches(monkeypatch)
    jcfg = reduce_cfg(jax_get_config(arch), num_layers=3, vocab_size=64)
    cfg = port_cfg(jcfg).with_overrides(remat_policy="full")
    params = bridge.params_from_numpy(np_tree(jax_registry.init_params(
        jcfg, jax.random.PRNGKey(0))), device="cpu")
    step = train_launch.make_train_step(cfg, opt.AdamWConfig())
    batch = {k: torch.from_numpy(v)
             for k, v in SyntheticLM(64, 16, 4, seed=1).sample().items()}
    _, _, m = step(params, opt.init(params), batch)
    assert calls == train_launch.kernel_launches_per_step(cfg) == \
        train_launch.kernel_launches_per_step(cfg.with_overrides(
            family="dense", moe=None))
    assert float(m["aux"]) > 0


# ---------------------------------------------------------------------------
# decode: slot cache and paged pool, K/V in the compute dtype and int8
# ---------------------------------------------------------------------------

B, BS, NB, MAX_SEQ = 3, 4, 4, 16


def decode_steps(seed=1, n=6):
    rs = np.random.RandomState(seed)
    pos = np.array([0, 3, 7], np.int32)
    out = []
    for i in range(n):
        if i == 3:
            pos[1] = 0                 # lane 1 serves a new request
        out.append((rs.randint(0, 256, size=(B, 1)).astype(np.int32),
                    pos.copy()))
        pos = pos + 1
    return out


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("path", ["slot", "paged"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_matches_jax(arch, path, kv):
    jcfg, jparams, cfg, params, _ = family_setup(arch, kv_cache_dtype=kv)
    tables = 1 + np.random.RandomState(0).permutation(B * NB) \
        .reshape(B, NB).astype(np.int32)
    if path == "slot":
        jcache = jax_registry.init_cache(jcfg, B, MAX_SEQ)
        cache = registry.init_cache(cfg, B, MAX_SEQ, "cpu")
        jstep = jax.jit(lambda p, c, t, q: jax_registry.decode_step(
            p, jcfg, c, t, q))
        step = lambda c, t, q: registry.decode_step(params, cfg, c, t, q)  # noqa: E731
    else:
        jcache = jax_registry.init_paged_cache(jcfg, B, 1 + B * NB, BS)
        cache = registry.init_paged_cache(cfg, B, 1 + B * NB, BS, "cpu")
        jstep = jax.jit(lambda p, c, t, q: jax_registry.decode_step_paged(
            p, jcfg, c, t, q, jnp.asarray(tables)))
        step = lambda c, t, q: registry.decode_step_paged(  # noqa: E731
            params, cfg, c, t, q, torch.from_numpy(tables))
    for toks, pos in decode_steps():
        jl, jcache = jstep(jparams, jcache, jnp.asarray(toks),
                           jnp.asarray(pos))
        with torch.no_grad():
            logits, cache = step(cache, torch.from_numpy(toks),
                                 torch.from_numpy(pos))
        assert_fwd_close(logits.numpy(), jl)
        for key, v in cache.items():
            if v.dtype == torch.int8:
                np.testing.assert_array_equal(v.numpy(),
                                              np.asarray(jcache[key]))
            else:
                assert_fwd_close(v.numpy(), jcache[key])


# ---------------------------------------------------------------------------
# ServeEngine streams: unsharded, and grok on 2 model ranks
# ---------------------------------------------------------------------------

def prompts(n, vocab, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, vocab - 1, size=rs.randint(2, 12)).astype(np.int32)
            for _ in range(n)]


def serve_jax(jcfg, jparams, ps, max_new):
    srv = JaxServeEngine(jcfg, jparams, JaxProgressEngine(), batch_slots=4,
                         max_seq=32)
    reqs = [JaxGenRequest(f"r{i}", p, max_new_tokens=max_new)
            for i, p in enumerate(ps)]
    for r in reqs:
        srv.submit(r)
    srv.run_until_idle(timeout=300)
    srv.close(timeout=60)
    return [list(r.out_tokens) for r in reqs]


def serve_port(cfg, params, ps, max_new, *, n=None, backend="native"):
    mesh = make_mesh((n,), ("model",), "cpu") if n else None
    srv = ServeEngine(cfg, params, ProgressEngine(), batch_slots=4,
                      max_seq=32, mesh=mesh, device="cpu",
                      collective_spec=CollectiveSpec(backend=backend,
                                                     chunks=2))
    reqs = [GenRequest(f"r{i}", p, max_new_tokens=max_new)
            for i, p in enumerate(ps)]
    for r in reqs:
        srv.submit(r)
    srv.run_until_idle(timeout=300)
    starts = srv._ag_handle.starts if srv._ag_handle is not None else None
    steps = srv.steps
    srv.close(timeout=60)
    assert all(r.done_req.is_complete and not r.done_req.failed
               for r in reqs)
    return [list(r.out_tokens) for r in reqs], starts, steps


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_engine_streams_match_jax(arch):
    jcfg, jparams, cfg, params, _ = family_setup(arch)
    ps = prompts(6, cfg.vocab_size)
    assert serve_port(cfg, params, ps, 5)[0] == \
        serve_jax(jcfg, jparams, ps, 5)


def test_grok_serves_sharded_on_two_ranks():
    """The grok family's vocabulary divides the ranks: its streams on 2
    model ranks are the same on the user and the native backends, bit
    for bit, and the JAX unsharded engine's."""
    jcfg, jparams, cfg, params, _ = family_setup("grok-1-314b")
    ps = prompts(6, cfg.vocab_size, seed=1)
    want = serve_jax(jcfg, jparams, ps, 5)
    native, no_handle, _ = serve_port(cfg, params, ps, 5, n=2)
    user, starts, steps = serve_port(cfg, params, ps, 5, n=2, backend="user")
    assert no_handle is None and starts == steps > 0
    assert user == native == want


def test_granite_vocabulary_divides_no_rank_count():
    """granite's 49155 entries divide neither 2 nor 4 ranks: the
    vocab-parallel unembed raises, as the JAX engine refuses it; grok's
    131072 divide 4."""
    cfg = get_config("granite-moe-3b-a800m")
    assert cfg.vocab_size == 49155
    small = cfg.with_overrides(d_model=8)
    params = {"embed": torch.zeros(cfg.vocab_size, 8)}
    for n in (2, 4):
        with pytest.raises(ValueError, match="not divisible"):
            transformer.unembed_ranks(params, small, torch.zeros(1, 8), n)
    assert get_config("grok-1-314b").vocab_size % 4 == 0


# ---------------------------------------------------------------------------
# expert parallelism: the user-space all-to-all against the native one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_dispatch_alltoall_user_equals_native(n):
    """Both directions move the same blocks on both backends, bit for
    bit; the global array is the same after the move, and the round trip
    is the identity."""
    mesh = make_mesh((n,), ("model",), "cpu")
    coll = UserCollectives(ProgressEngine())
    G, E, C, d = 8, 8, 4, 32
    xe = torch.from_numpy(np.random.RandomState(2).randn(G, E, C, d)
                          .astype(np.float32))
    try:
        for reverse in (False, True):
            nat = layers.moe_dispatch_alltoall(xe, mesh, "model",
                                               reverse=reverse)
            usr = layers.moe_dispatch_alltoall(xe, mesh, "model",
                                               reverse=reverse, coll=coll)
            assert torch.equal(nat, usr) and torch.equal(nat, xe)
        fwd = layers.moe_dispatch_alltoall(xe, mesh, "model", coll=coll)
        back = layers.moe_dispatch_alltoall(fwd, mesh, "model", reverse=True,
                                            coll=coll)
        assert torch.equal(back, xe)
        assert coll.issued == 4 and coll.completed == 4
    finally:
        coll.close()


def test_dispatch_alltoall_moves_the_blocks_of_a_transpose():
    """The payload's n·n blocks go to their destination ranks: rank r's
    rows after the move hold every group of its experts."""
    n, G, E = 2, 4, 4
    mesh = make_mesh((n,), ("model",), "cpu")
    xe = torch.arange(G * E, dtype=torch.float32).reshape(G, E, 1, 1)
    coll = UserCollectives(ProgressEngine())
    seen = []
    orig = coll.ialltoall

    def spy(pay, *a, **kw):
        req = orig(pay, *a, **kw)
        seen.append((pay.clone(), req))
        return req

    coll.ialltoall = spy
    try:
        layers.moe_dispatch_alltoall(xe, mesh, "model", coll=coll)
    finally:
        coll.close()
    pay, req = seen[0]
    out = req.value()
    # block (s, r) of the payload: groups of s x experts of r
    assert torch.equal(pay[0 * n + 1].flatten(), torch.tensor([2., 3, 6, 7]))
    # rank 0 receives every group's slice of its experts 0 and 1
    assert torch.equal(out[:n].flatten(),
                       torch.tensor([0., 1, 4, 5, 8, 9, 12, 13]))


def test_dispatch_alltoall_refuses_indivisible_dims():
    mesh = make_mesh((4,), ("model",), "cpu")
    with pytest.raises(ValueError, match=r"groups \(6\) and experts \(8\) "
                                         r"must divide the 'model' axis "
                                         r"size \(4\)"):
        layers.moe_dispatch_alltoall(torch.zeros(6, 8, 2, 2), mesh, "model")
    assert torch.equal(layers.moe_dispatch_alltoall(
        torch.ones(3, 5, 1, 1), make_mesh((1,), ("model",), "cpu"), "model"),
        torch.ones(3, 5, 1, 1))


@pytest.mark.parametrize("n", [2, 4])
def test_expert_parallel_apply_equals_moe_apply(n):
    """granite's many-tiny-expert shape at test widths, as the JAX test
    holds it: moe_apply == expert-parallel native == expert-parallel user,
    bit for bit, y and aux; and moe_apply against the JAX one."""
    base = jax_get_config("granite-moe-3b-a800m")
    jcfg = base.with_overrides(
        num_layers=1, d_model=32, num_heads=2, num_kv_heads=2, head_dim=16,
        vocab_size=64, dtype="float32",
        moe=base.moe.__class__(num_experts=8, top_k=2, expert_d_ff=16,
                               capacity_factor=2.0, group_size=16))
    cfg = port_cfg(jcfg)
    jp, p = moe_params(jcfg)
    x = np.random.RandomState(1).randn(4, 16, 32).astype(np.float32)
    tx = torch.from_numpy(x)
    mesh = make_mesh((n,), ("model",), "cpu")
    coll = UserCollectives(ProgressEngine())
    try:
        y_ref, aux_ref = layers.moe_apply(p, tx, cfg)
        y_nat, aux_nat = layers.moe_apply_expert_parallel(p, tx, cfg, mesh)
        y_usr, aux_usr = layers.moe_apply_expert_parallel(p, tx, cfg, mesh,
                                                          coll=coll)
    finally:
        coll.close()
    assert torch.equal(y_ref, y_nat) and torch.equal(y_nat, y_usr)
    assert float(aux_ref) == float(aux_nat) == float(aux_usr)
    jy, jaux = JL.moe_apply(jp, jnp.asarray(x), jcfg)
    assert_fwd_close(y_ref.numpy(), jy)
    np.testing.assert_allclose(float(aux_ref), float(jaux), rtol=1e-5)


def test_expert_parallel_apply_refuses_indivisible_experts():
    jcfg, cfg = moe_cfg(E=6, K=2, group=16)
    _, p = moe_params(jcfg)
    with pytest.raises(ValueError, match=r"experts \(6\) must divide"):
        layers.moe_apply_expert_parallel(
            p, torch.zeros(4, 16, 32), cfg, make_mesh((4,), ("model",), "cpu"))


# ---------------------------------------------------------------------------
# expert parallelism with a device per rank: each rank's groups and experts
# on its device (meshes of ["cpu"] * n)
# ---------------------------------------------------------------------------

def per_device_params(p, n):
    """The router a replica on each of n ranks, the experts ``RankShards``
    blocks of E/n (the JAX ``"experts" -> model`` placement)."""
    from repro_torch.collectives.rank_shards import RankShards, replicate
    devices = ["cpu"] * n
    return {k: replicate(v, devices) if k == "router"
            else RankShards.from_stacked(v, devices=devices)
            for k, v in p.items()}


def exact_moe_inputs(cfg, B, S, seed):
    """Integer-valued tokens and weights on which every product and sum of
    the layer is exact in f32, whatever the order: each token's first E
    entries pick two experts with one-hot 1s against a router of 200 on
    the diagonal, so their probabilities are exactly 1/2 and every other
    is exactly 0; the gate weights are 0 or 20, so each gate
    pre-activation is 0 or at least 20, where silu is exactly 0 or the
    identity in f32; the rest are small integers."""
    rs = np.random.RandomState(seed)
    D, E, F_ = cfg.d_model, cfg.moe.num_experts, cfg.moe.expert_d_ff
    x = rs.randint(0, 3, size=(B, S, D)).astype(np.float32)
    x[..., :E] = 0
    hot = np.argsort(rs.rand(B, S, E), axis=-1)[..., :2]
    np.put_along_axis(x[..., :E], hot, 1.0, axis=-1)
    router = np.zeros((D, E), np.float32)
    router[np.arange(E), np.arange(E)] = 200.0
    p = {"router": router,
         "wi_gate": rs.randint(0, 2, size=(E, D, F_)).astype(np.float32) * 20,
         "wi_up": rs.randint(-1, 2, size=(E, D, F_)).astype(np.float32),
         "wo": rs.randint(-1, 2, size=(E, F_, D)).astype(np.float32)}
    return ({k: torch.from_numpy(v) for k, v in p.items()},
            torch.from_numpy(x))


def per_device_runs(p, x, cfg, n):
    """The per-device expert-parallel layer on the native copies and on
    the user-space all-to-all: ((y, aux) native, (y, aux) user), y glued
    back in rank order."""
    from repro_torch.collectives.rank_shards import RankShards
    mesh = make_mesh((n,), ("model",), devices=["cpu"] * n)
    pd, xd = per_device_params(p, n), RankShards.from_stacked(x, mesh)
    coll = UserCollectives(ProgressEngine())
    try:
        runs = [layers.moe_apply_expert_parallel(pd, xd, cfg, mesh, coll=c)
                for c in (None, coll)]
    finally:
        coll.close()
    for y, _ in runs:
        assert isinstance(y, RankShards) and len(y) == n
    assert coll.issued == coll.completed == 2
    return [(y.to_stacked("cpu"), aux) for y, aux in runs]


@pytest.mark.parametrize("n", [2, 4])
def test_expert_parallel_per_device_equals_stacked_on_exact_inputs(n):
    """Integer-valued inputs (every product and sum exact in f32): the
    per-device layer's y and aux, native and user, bit for bit against
    the stacked ``moe_apply_expert_parallel``; tokens are dropped at the
    capacity in both."""
    jcfg, cfg = moe_cfg(E=4, K=2, F=32, group=64, cf=1.0)
    p, x = exact_moe_inputs(cfg, 4, 64, seed=n)
    y_ref, aux_ref = layers.moe_apply_expert_parallel(
        p, x, cfg, make_mesh((n,), ("model",), "cpu"))
    (y_nat, aux_nat), (y_usr, aux_usr) = per_device_runs(p, x, cfg, n)
    assert torch.equal(y_nat, y_usr) and torch.equal(y_nat, y_ref)
    assert aux_nat.numpy().tobytes() == aux_usr.numpy().tobytes() == \
        aux_ref.numpy().tobytes()
    assert float(y_ref.abs().max()) > 0 and float(aux_ref) > 0


@pytest.mark.parametrize("n", [2, 4])
def test_expert_parallel_per_device_near_jax(n):
    """Random inputs: user = native bit for bit, y within 1e-5 of the
    largest entry of the JAX ``moe_apply`` and aux within rel 1e-5."""
    jcfg, cfg = moe_cfg(E=8, K=2, F=16, group=16, cf=2.0)
    jp, p = moe_params(jcfg, seed=n)
    x = np.random.RandomState(n).randn(4, 16, 32).astype(np.float32)
    (y_nat, aux_nat), (y_usr, aux_usr) = per_device_runs(
        p, torch.from_numpy(x), cfg, n)
    assert torch.equal(y_nat, y_usr) and float(aux_nat) == float(aux_usr)
    jy, jaux = JL.moe_apply(jp, jnp.asarray(x), jcfg)
    assert_fwd_close(y_nat.numpy(), jy)
    np.testing.assert_allclose(float(aux_nat), float(jaux), rtol=1e-5)


def test_dispatch_alltoall_per_device_moves_the_stacked_blocks():
    """Per device, rank r's forward result is the stacked move's slice of
    its experts and its reverse result its groups, both backends."""
    from repro_torch.collectives.rank_shards import RankShards
    n, G, E = 4, 8, 8
    xe = torch.from_numpy(np.random.RandomState(4).randn(G, E, 3, 5)
                          .astype(np.float32))
    mesh = make_mesh((n,), ("model",), devices=["cpu"] * n)
    coll = UserCollectives(ProgressEngine())
    try:
        for c in (None, coll):
            fwd = layers.moe_dispatch_alltoall(
                RankShards.from_stacked(xe, mesh), mesh, "model", coll=c)
            for r in range(n):
                assert torch.equal(fwd[r], xe[:, r * 2:(r + 1) * 2])
            back = layers.moe_dispatch_alltoall(fwd, mesh, "model",
                                                reverse=True, coll=c)
            assert torch.equal(back.to_stacked("cpu"), xe)
    finally:
        coll.close()


def test_expert_parallel_per_device_refuses_indivisible_dims():
    """Experts or groups that do not divide the ranks, and a payload off
    the mesh's devices, raise."""
    from repro_torch.collectives.rank_shards import RankShards
    mesh = make_mesh((4,), ("model",), devices=["cpu"] * 4)
    jcfg, cfg = moe_cfg(E=6, K=2, group=16)
    _, p = moe_params(jcfg)
    with pytest.raises(ValueError, match=r"experts \(6\) and groups \(4\) "
                                         r"must divide"):
        # (refused before the experts are read: 6 do not split over 4)
        layers.moe_apply_expert_parallel(
            per_device_params({"router": p["router"]}, 4),
            RankShards.from_stacked(torch.zeros(4, 16, 32), mesh), cfg, mesh)
    jcfg, cfg = moe_cfg(E=4, K=2, group=32)
    _, p = moe_params(jcfg)
    with pytest.raises(ValueError, match=r"groups \(2\) must divide"):
        layers.moe_apply_expert_parallel(
            per_device_params(p, 4),
            RankShards.from_stacked(torch.zeros(4, 16, 32), mesh), cfg, mesh)
    with pytest.raises(ValueError, match="must be a RankShards"):
        layers.moe_apply_expert_parallel(per_device_params(p, 4),
                                         torch.zeros(4, 16, 32), cfg, mesh)


# ---------------------------------------------------------------------------
# grok's logit cap in the attention kernels' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_capped_flash_attention_plain_matches_jax(causal):
    """flash_attention_plain (and the op's backward through the oracle)
    with logit_cap=30 against JAX's L.attention: q scaled by 4 so the cap
    bites."""
    rs = np.random.RandomState(7)
    q = (rs.randn(2, 24, 6, 16) * 4).astype(np.float32)
    k = (rs.randn(2, 24, 2, 16) * 4).astype(np.float32)
    v = rs.randn(2, 24, 2, 16).astype(np.float32)
    g = rs.randn(2, 24, 6, 16).astype(np.float32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))

    def jattn(a, b, c, cap):
        return JL.attention(a, b, c, causal=causal, logit_cap=cap)

    want = jattn(jq, jk, jv, 30.0)
    got = flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                causal=causal, logit_cap=30.0)
    assert_fwd_close(got.numpy(), want)
    uncapped = jattn(jq, jk, jv, 0.0)
    assert float(jnp.abs(want - uncapped).max()) > 1e-2     # the cap bites
    jgrads = jax.grad(lambda a, b, c: jnp.sum(jattn(a, b, c, 30.0)
                                              * jnp.asarray(g)),
                      argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=causal, logit_cap=30.0)
    assert_fwd_close(out.detach().numpy(), want)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for t, jt in zip(grads, jgrads):
        assert_grad_close(t.numpy(), jt)


def test_capped_flash_decode_plain_matches_jax():
    """flash_decode_plain with logit_cap=30 against JAX's
    L.decode_attention (pos = lengths - 1)."""
    rs = np.random.RandomState(8)
    Bq, S, H, KVH, hd = 3, 20, 6, 2, 16
    q = (rs.randn(Bq, H, hd) * 4).astype(np.float32)
    k = (rs.randn(Bq, S, KVH, hd) * 4).astype(np.float32)
    v = rs.randn(Bq, S, KVH, hd).astype(np.float32)
    lengths = np.array([1, 11, 20], np.int32)
    want = JL.decode_attention(jnp.asarray(q)[:, None], jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(lengths - 1),
                               logit_cap=30.0)[:, 0]
    got = flash_decode_plain(*map(torch.from_numpy, (q, k, v, lengths)),
                             logit_cap=30.0)
    assert_fwd_close(got.numpy(), want)
    plain = flash_decode_plain(*map(torch.from_numpy, (q, k, v, lengths)))
    assert float((got - plain).abs().max()) > 1e-2


# ---------------------------------------------------------------------------
# parameter counts and the launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_active_param_counts_equal_jax(arch):
    jcfg = reduce_cfg(jax_get_config(arch))
    cfg = port_cfg(jcfg)
    for active in (False, True):
        assert registry.param_count(cfg, active) == \
            jax_registry.param_count(jcfg, active)
    assert registry.param_count(cfg, True) < registry.param_count(cfg)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_launchers_run_the_family_on_the_cpu(tmp_path, arch):
    """``--arch <moe> --scale tiny --device cpu`` through both launchers:
    4 experts top 2, expert_d_ff = d_ff // 2, groups of 64, as the JAX
    launchers shrink them; finite losses with an aux loss, every request
    served."""
    from repro_torch.launch import serve as serve_launch
    from repro_torch.launch import train as train_launch
    args = train_launch.build_parser().parse_args(
        ["--arch", arch, "--device", "cpu", "--scale", "tiny", "--steps",
         "3", "--ckpt-dir", str(tmp_path)])
    with contextlib.redirect_stdout(io.StringIO()):
        report = train_launch.run(args, log_every=1)
    moe = report.cfg.moe
    assert (moe.num_experts, moe.top_k, moe.expert_d_ff, moe.group_size) == \
        (4, 2, 64, 64)
    assert len(report.log) == 3
    assert all(np.isfinite(m["loss"]) and m["aux"] > 0 for m in report.log)
    args = serve_launch.build_parser().parse_args(
        ["--arch", arch, "--device", "cpu", "--scale", "tiny",
         "--requests", "4", "--max-new", "3"])
    with contextlib.redirect_stdout(io.StringIO()):
        rep = serve_launch.run(args)
    assert rep.server.cfg.moe.num_experts == 4
    assert all(len(r.out_tokens) == 3 for r in rep.requests)
