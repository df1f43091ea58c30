"""The port's hybrid family (zamba2-1.2b) against the JAX package on the
CPU, in f32 with bridged weights, nonzero per-site LoRA factors and
numpy-made inputs, at ``tests/conftest.reduce_cfg``'s size (5 layers in
2 groups of 2 and a tail of 1, LoRA rank 4) with 4/2 heads and with 4/4
(G = 1): the training forward, loss and every gradient leaf under
"none", "full" and "dots"; the launch counts; the slot and paged decode
(paged = slot bit for bit), the ``fed`` mask; the ``ServeEngine``
streams, unsharded and on 2 model ranks (user = native); both
launchers.  The lane snapshots and the recovery cases are
``tests/test_torch_serve_elastic.py``'s, which takes zamba2 too.

Tolerance (f32; XLA and PyTorch sum in other orders): 1e-4 absolute and
relative, as ``tests/test_torch_mamba.py`` holds the mamba family; the
slot and paged decode of the port bit for bit."""
import contextlib
import dataclasses
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduce_cfg
from repro.configs import get_config as jax_get_config
from repro.core import ProgressEngine as JaxProgressEngine
from repro.models import registry as jax_registry
from repro.serve.engine import GenRequest as JaxGenRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.collectives.nonblocking import CollectiveSpec
from repro_torch.configs import get_config
from repro_torch.core import ProgressEngine
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import bridge, hybrid, registry
from repro_torch.models.layers import tree_leaves
from repro_torch.serve.engine import GenRequest, ServeEngine
from repro_torch.serve.kvcache import keystr

ARCH = "zamba2-1.2b"
TOL = dict(atol=1e-4, rtol=1e-4)
# the reduced config's heads (4 query, 2 KV), and G = 1 as zamba2 has
VARIANTS = {"gqa": {}, "g1": dict(num_kv_heads=4)}
POLICIES = ["none", "full", "dots"]


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_cfg(jcfg):
    return get_config(jcfg.name).with_overrides(
        **{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def with_lora(jparams, seed=7):
    """The JAX tree with every LoRA factor replaced by seeded nonzero
    values (``_lora_spec`` starts every b at zero, where the deltas
    vanish)."""
    rs = np.random.RandomState(seed)
    lora = {k: jnp.asarray((0.3 * rs.randn(*v.shape)).astype(np.float32))
            for k, v in jparams["site_lora"].items()}
    return dict(jparams, site_lora=lora)


@functools.lru_cache(maxsize=None)
def jax_params(variant, vocab_size):
    """The JAX weights of a variant (drawn once: the JAX init is slow on
    the CPU), LoRA made nonzero."""
    jcfg = reduce_cfg(jax_get_config(ARCH), dtype="float32",
                      vocab_size=vocab_size, **VARIANTS[variant])
    return with_lora(jax_registry.init_params(jcfg, jax.random.PRNGKey(1)))


def setup(variant="gqa", vocab_size=256, **kw):
    """The JAX config and weights, and the port's twins (a fresh copy:
    a train step updates the port's in place)."""
    jcfg = reduce_cfg(jax_get_config(ARCH), dtype="float32",
                      vocab_size=vocab_size, **VARIANTS[variant], **kw)
    jparams = jax_params(variant, vocab_size)
    params = bridge.params_from_numpy(np_tree(jparams), device="cpu")
    return jcfg, jparams, port_cfg(jcfg), params


def batch_of(vocab, B=2, S=16, seed=3):
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, vocab, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def test_config_layout_and_param_tree_equal_jax():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jax_get_config(ARCH))
    assert hybrid.group_layout(get_config(ARCH)) == (6, 6, 2)
    jcfg, jparams, cfg, params = setup()
    assert hybrid.group_layout(cfg) == (2, 2, 1)
    assert registry.module_for(cfg) is hybrid
    assert jax.tree.map(lambda t: tuple(t.shape), registry.init_params(
        cfg, torch.Generator().manual_seed(0))) == \
        jax.tree.map(lambda s: tuple(s.shape),
                     jax_registry.param_shapes(jcfg))
    # every b starts at zero, as _lora_spec makes it
    fresh = registry.init_params(cfg, torch.Generator().manual_seed(0))
    assert all(float(v.abs().max()) == 0.0
               for k, v in fresh["site_lora"].items() if k.endswith("_b"))


def test_cast_params_keeps_the_norms_and_ssm_scalars_f32():
    _, _, cfg, params = setup()
    cast = registry.cast_params(cfg.with_overrides(dtype="bfloat16"), params)
    for path, t in tree_leaves(cast):
        want = torch.float32 if path[-1] in hybrid.F32_KEYS \
            else torch.bfloat16
        assert t.dtype == want, path
    assert {p[-1] for p, t in tree_leaves(cast) if t.dtype == torch.float32} \
        >= {"ln1", "ln2", "block_norms", "tail_norms", "final_norm", "a_log"}


@pytest.fixture(scope="module", params=list(VARIANTS))
def family(request):
    """Per variant: the JAX logits, and the JAX loss and gradients under
    each policy, computed once."""
    jcfg, jparams, cfg, params = setup(request.param)
    batch = batch_of(cfg.vocab_size)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jlogits, _ = jax_registry.forward(jparams, jcfg, jbatch)
    grads = {}
    for remat in POLICIES:
        jc = jcfg.with_overrides(remat_policy=remat)
        grads[remat] = jax.jit(jax.value_and_grad(
            lambda p, jc=jc: jax_registry.loss_fn(p, jc, jbatch)[0]))(jparams)
    return cfg, params, batch, np.asarray(jlogits), grads


@pytest.mark.parametrize("remat", POLICIES)
def test_forward_loss_and_every_gradient_match_jax(family, remat):
    """Logits, the loss, and every gradient leaf — the shared block's and
    each site's LoRA factors among them (the shared block's gradient is
    the sum over its sites) — against jax.grad, under the policy."""
    cfg, params, batch, jlogits, grads = family
    cfg = cfg.with_overrides(remat_policy=remat)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        logits, aux = registry.forward(params, cfg, tbatch)
    np.testing.assert_allclose(logits.numpy(), jlogits, **TOL)
    assert float(aux) == 0.0
    leaves = [t.detach().clone().requires_grad_() for t in
              jax.tree.leaves(params)]
    tree = jax.tree.unflatten(jax.tree.structure(params), leaves)
    loss, m = registry.loss_fn(tree, cfg, tbatch)
    g = torch.autograd.grad(loss, leaves)
    jloss, jgrads = grads[remat]
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jgrads)[0]]
    assert any("site_lora" in p for p in paths) and \
        any("shared" in p for p in paths) and len(g) == len(paths)
    for path, got, want in zip(paths, g, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=path, **TOL)


def test_lora_changes_the_logits():
    """Zero LoRA b factors give other logits: the parity above would
    pass a port that ignored the LoRA only if the deltas were zero."""
    _, _, cfg, params = setup()
    tokens = torch.from_numpy(batch_of(cfg.vocab_size)["tokens"])
    zeroed = dict(params, site_lora={
        k: torch.zeros_like(v) if k.endswith("_b") else v
        for k, v in params["site_lora"].items()})
    with torch.no_grad():
        a = registry.forward(params, cfg, {"tokens": tokens})[0]
        b = registry.forward(zeroed, cfg, {"tokens": tokens})[0]
    assert float((a - b).abs().max()) > 1e-3


def test_loss_impl_is_plain_xent_as_jax():
    """The JAX ``hybrid.loss_fn`` reads no ``loss_impl``: under
    "chunked_vocab" the loss is the plain one, as JAX's."""
    jcfg, jparams, cfg, params = setup(loss_impl="chunked_vocab")
    batch = batch_of(cfg.vocab_size)
    jloss, _ = jax.jit(lambda p, b: jax_registry.loss_fn(p, jcfg, b))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        loss, _ = registry.loss_fn(params, cfg, {
            k: torch.from_numpy(v) for k, v in batch.items()})
        plain, _ = registry.loss_fn(
            params, cfg.with_overrides(loss_impl="plain"),
            {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(loss) == float(plain)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)


def test_unported_attention_raises(tmp_path):
    """Ring attention at the shared block's sites, which raised before it
    was ported, is held against the JAX model with nonzero LoRA and
    "full" remat (each group recomputed): the "ring" loss without a mesh
    and under a (1, 4) mesh equals the JAX loss without a mesh and under
    JAX's (1, 4) mesh, within 1e-5."""
    from tests.test_torch_ring import jax_ring_losses, port_ring_losses
    jcfg, jparams, cfg, params = setup()
    batch = batch_of(cfg.vocab_size, S=16)
    got = port_ring_losses(params, cfg.with_overrides(remat_policy="full"),
                           batch)
    want = jax_ring_losses(
        f'reduce_cfg(get_config("{ARCH}"), dtype="float32", '
        f'vocab_size={cfg.vocab_size}, remat_policy="full", '
        f'attention_impl="ring")', jparams, batch, tmp_path)
    np.testing.assert_allclose(got, want, rtol=1e-5)


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


@pytest.mark.parametrize("remat", POLICIES)
def test_kernel_launches_per_step_as_derived(monkeypatch, remat):
    """One ``make_train_step`` step calls each kernel's plain version as
    often as ``kernel_launches_per_step`` derives: the groups (k layers
    and a site) recomputed under every policy but "none", the tail
    never."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train import optimizer as opt
    calls = _count_launches(monkeypatch)
    _, _, cfg, params = setup(vocab_size=64)
    cfg = cfg.with_overrides(remat_policy=remat)
    step = train_launch.make_train_step(cfg, opt.AdamWConfig())
    batch = {k: torch.from_numpy(v)
             for k, v in SyntheticLM(64, 16, 2, seed=1).sample().items()}
    step(params, opt.init(params), batch)
    assert calls == train_launch.kernel_launches_per_step(cfg)
    # 5 layers in 2 groups of 2 and a tail of 1: 5 + 2*2 + 1 norms
    again = remat != "none"
    assert (calls["rmsnorm_fwd"], calls["ssd_chunk"],
            calls["flash_attention"]) == (10 + 8 * again, 5 + 4 * again,
                                          2 + 2 * again)


# ---------------------------------------------------------------------------
# decode: slot cache and paged pool
# ---------------------------------------------------------------------------

B, S, BS = 3, 16, 4


def _tables():
    nb = S // BS
    return (1 + np.arange(B * nb, dtype=np.int32)).reshape(B, nb)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_slot_and_paged_decode_match_jax(variant, kv):
    """8 steps over 3 lanes: the port's slot and paged logits against
    the JAX slot and paged decode, every cache leaf against JAX's, and
    paged = slot bit for bit.  ``kv_cache_dtype`` does not change the
    hybrid's cache (the compute dtype), as in the JAX package."""
    jcfg, jparams, cfg, params = setup(variant, kv_cache_dtype=kv)
    tables = _tables()
    jslot = jax_registry.init_cache(jcfg, B, S)
    jpool = jax_registry.init_paged_cache(jcfg, B, 1 + tables.size, BS)
    slot = registry.init_cache(cfg, B, S, "cpu")
    pool = registry.init_paged_cache(cfg, B, 1 + tables.size, BS, "cpu")
    assert slot["attn_k"].dtype == torch.float32
    assert slot["attn_k"].shape == (2, B, S, cfg.num_kv_heads, 16)
    assert pool["attn_k"].shape == (2, 1 + tables.size, BS,
                                    cfg.num_kv_heads, 16)
    jstep = jax.jit(lambda p, c, t, q: jax_registry.decode_step(
        p, jcfg, c, t, q))
    jpstep = jax.jit(lambda p, c, t, q: jax_registry.decode_step_paged(
        p, jcfg, c, t, q, jnp.asarray(tables), jnp.ones((B,), bool)))
    rs = np.random.RandomState(1)
    pos = np.zeros(B, np.int32)
    for _ in range(8):
        toks = rs.randint(0, cfg.vocab_size, size=(B, 1)).astype(np.int32)
        jl, jslot = jstep(jparams, jslot, jnp.asarray(toks), jnp.asarray(pos))
        jlp, jpool = jpstep(jparams, jpool, jnp.asarray(toks),
                            jnp.asarray(pos))
        with torch.no_grad():
            a, slot = registry.decode_step(params, cfg, slot,
                                           torch.from_numpy(toks),
                                           torch.from_numpy(pos))
            b, pool = registry.decode_step_paged(
                params, cfg, pool, torch.from_numpy(toks),
                torch.from_numpy(pos), torch.from_numpy(tables),
                torch.ones(B, dtype=torch.bool))
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(b.numpy(), np.asarray(jlp), **TOL)
        for (path, got), (jpath, want) in zip(
                tree_leaves(pool),
                jax.tree_util.tree_flatten_with_path(jpool)[0]):
            assert keystr(path) == jax.tree_util.keystr(jpath)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **TOL)
        pos = pos + 1


@pytest.mark.parametrize("path", ["slot", "paged"])
def test_fed_mask_freezes_ssm_state_and_nothing_else(path):
    """A call feeding only lane 0 leaves lane 1's ``ssm``/``tail_ssm``
    state bit for bit and advances lane 0's (the JAX
    test_elastic_membership check); the attention K/V are written for
    both lanes, as the JAX decode writes them."""
    _, _, cfg, params = setup()
    tables = _tables()[:2]
    if path == "slot":
        cache = registry.init_cache(cfg, 2, S, "cpu")
        step = lambda c, t, p, f=None: registry.decode_step(  # noqa: E731
            params, cfg, c, t, p, f)
    else:
        cache = registry.init_paged_cache(cfg, 2, 1 + tables.size, BS, "cpu")
        step = lambda c, t, p, f=None: registry.decode_step_paged(  # noqa: E731
            params, cfg, c, t, p, torch.from_numpy(tables), f)
    pos = torch.zeros(2, dtype=torch.int32)
    with torch.no_grad():
        _, cache = step(cache, torch.tensor([[5], [6]]), pos)
        old = {keystr(p): t.clone() for p, t in tree_leaves(cache)}
        _, cache = step(cache, torch.tensor([[7], [9]]), pos + 1,
                        torch.tensor([True, False]))
    ssm = 0
    for p, new in tree_leaves(cache):
        key = keystr(p)
        if "ssm" in key:
            ssm += 1
            assert torch.equal(new[:, 1], old[key][:, 1]), key
            assert not torch.equal(new[:, 0], old[key][:, 0]), key
        else:
            assert not torch.equal(new, old[key]), key
    assert ssm == 8                  # ssm and tail_ssm: conv x/b/c and h


def test_reset_lane_zeroes_only_the_lanes_state():
    _, _, cfg, _ = setup()
    pool = registry.init_paged_cache(cfg, 3, 5, BS, "cpu")
    for _, t in tree_leaves(pool):
        t.fill_(1.0)
    registry.reset_paged_lane(cfg, pool, 1)
    for p, t in tree_leaves(pool):
        if "ssm" in keystr(p):
            assert torch.all(t[:, 1] == 0) and torch.all(t[:, 0] == 1)
        else:
            assert torch.all(t == 1)
    assert registry.paged_has_blocks(cfg) and registry.supports_paged(cfg)


# ---------------------------------------------------------------------------
# the serving engine: unsharded and on 2 model ranks
# ---------------------------------------------------------------------------

def prompts(n, vocab, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, vocab - 1, size=rs.randint(2, 12)).astype(np.int32)
            for _ in range(n)]


def serve_port(cfg, params, ps, *, n=None, backend="native"):
    mesh = make_mesh((n,), ("model",), "cpu") if n else None
    srv = ServeEngine(cfg, params, ProgressEngine(), batch_slots=4,
                      max_seq=32, mesh=mesh, device="cpu",
                      collective_spec=CollectiveSpec(backend=backend,
                                                     chunks=2))
    reqs = [GenRequest(f"r{i}", p, max_new_tokens=5)
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


def test_serve_engine_streams_match_jax_unsharded_and_on_two_ranks():
    """10 requests through 4 lanes (recycled lanes zeroed): the port's
    greedy streams equal the JAX ServeEngine's; on 2 model ranks the
    user and native backends give the same streams bit for bit."""
    jcfg, jparams, cfg, params = setup()
    ps = prompts(10, cfg.vocab_size)
    jsrv = JaxServeEngine(jcfg, jparams, JaxProgressEngine(), batch_slots=4,
                          max_seq=32)
    jreqs = [JaxGenRequest(f"r{i}", p, max_new_tokens=5)
             for i, p in enumerate(ps)]
    for r in jreqs:
        jsrv.submit(r)
    jsrv.run_until_idle(timeout=300)
    jsrv.close(timeout=60)
    want = [list(r.out_tokens) for r in jreqs]
    assert serve_port(cfg, params, ps)[0] == want
    native, no_handle, _ = serve_port(cfg, params, ps, n=2)
    user, starts, steps = serve_port(cfg, params, ps, n=2, backend="user")
    assert no_handle is None and starts == steps > 0
    assert user == native == want


def test_launchers_run_the_family_on_the_cpu(tmp_path):
    """``--arch zamba2-1.2b --scale tiny --device cpu`` through both
    launchers: 5 layers in groups of 2, LoRA rank 8, as the JAX launchers
    shrink it; finite losses, every request served."""
    assert serve_launch.make_config(ARCH, "full") == get_config(ARCH)
    cfg = serve_launch.make_config(ARCH, "tiny")
    assert (cfg.num_layers, cfg.shared_attn_every,
            cfg.shared_attn_lora_rank, cfg.ssm.d_state) == (5, 2, 8, 16)
    args = train_launch.build_parser().parse_args(
        ["--arch", ARCH, "--device", "cpu", "--scale", "tiny", "--steps",
         "3", "--seq", "32", "--ckpt-dir", str(tmp_path)])
    with contextlib.redirect_stdout(io.StringIO()):
        report = train_launch.run(args, log_every=1)
    assert report.cfg == cfg and len(report.log) == 3
    assert all(np.isfinite(m["loss"]) for m in report.log)
    args = serve_launch.build_parser().parse_args(
        ["--arch", ARCH, "--device", "cpu", "--scale", "tiny",
         "--requests", "5", "--slots", "2", "--max-new", "3"])
    with contextlib.redirect_stdout(io.StringIO()):
        rep = serve_launch.run(args)
    assert rep.tokens == 15
    assert all(r.done_req.is_complete and not r.done_req.failed
               for r in rep.requests)
