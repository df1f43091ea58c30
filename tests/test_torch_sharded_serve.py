"""The port's model-axis-sharded serving on the CPU, against the JAX
package.

* ``unembed_partial`` equals the JAX ``unembed_partial`` slice by slice
  (tied and untied, with and without a logit softcap), the slices
  concatenate to the port's ``unembed``, and ``unembed_ranks`` stacks
  exactly the n single-slice calls;
* the sharded engine's partial logits ``[n, B, V/n]`` equal the pieces
  the JAX ``local_step`` computes — ``decode_hidden_paged``, then
  ``unembed_partial`` for each rank — built outside any mesh, since the
  JAX sharded engine cannot run under this JAX (ROADMAP §3);
* the sharded engine serves the same greedy streams on the user and
  the native backend, bit for bit, with one gather start a step, and
  those streams equal the JAX *unsharded* engine's (dense and mamba2);
* executor-driven gather starts serve the caller-driven streams, and an
  executor attached but never started serves rather than hangs;
* the eager errors are the JAX engine's;
* with a device per rank (``devices=["cpu"] * n``, n in {2, 4}) each
  rank's partial logits equal the JAX pieces and, on the CPU, the
  rank-stacked engine's bit for bit; the streams equal on both backends
  (one gather start a step), the stacked engine's and the JAX unsharded
  engine's; the weights and the pool are a replica per rank.
"""
import dataclasses
import warnings

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
from repro_torch.core import ProgressEngine, ProgressExecutor
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import bridge, registry, transformer
from repro_torch.serve.engine import GenRequest, ServeEngine, allgather_ranks
from repro_torch.serve.kvcache import to_device

# f32 summation order differs between XLA's and PyTorch's CPU matmuls
TOL = dict(atol=1e-5, rtol=1e-5)
ARCHS = ("qwen2-0.5b", "mamba2-1.3b")


def port_cfg(jcfg):
    """The port's config with the same fields as a (reduced) JAX config."""
    return get_config(jcfg.name).with_overrides(
        **{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def bridged(arch, **kw):
    jcfg = reduce_cfg(jax_get_config(arch), dtype="float32", **kw)
    jparams = jax_registry.init_params(jcfg, jax.random.PRNGKey(0))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    return jcfg, jparams, port_cfg(jcfg), params


def prompts(n, vocab, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, vocab - 1, size=rs.randint(2, 12)).astype(np.int32)
            for _ in range(n)]


# ---------------------------------------------------------------------------
# unembed_partial
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_unembed_partial_matches_jax(n, tied, cap):
    jcfg, jparams, cfg, params = bridged("qwen2-0.5b", tie_embeddings=tied,
                                         logit_softcap=cap)
    x = np.random.RandomState(n).randn(3, 1, cfg.d_model).astype(np.float32)
    tx = torch.from_numpy(x)
    w = cfg.vocab_size // n
    parts = [registry.unembed_partial(params, cfg, tx, r * w, w)
             for r in range(n)]
    for r, part in enumerate(parts):
        want = jax_registry.unembed_partial(jparams, jcfg, jnp.asarray(x),
                                            r * w, w)
        assert part.dtype == torch.float32 and part.shape == (3, 1, w)
        np.testing.assert_allclose(part.numpy(), np.asarray(want), **TOL)
    # on the CPU in f32 the slices, their stack and the whole product
    # agree bit for bit
    assert torch.equal(torch.cat(parts, -1),
                       transformer.unembed(params, cfg, tx))
    stacked = registry.unembed_ranks(params, cfg, tx, n)
    assert stacked.shape == (n, 3, 1, w)
    assert torch.equal(stacked, torch.stack(parts))
    if cap:
        assert float(stacked.abs().max()) <= cap


def test_unembed_ranks_refuses_an_indivisible_vocab():
    _, _, cfg, params = bridged("qwen2-0.5b")
    with pytest.raises(ValueError, match="not divisible"):
        registry.unembed_ranks(params, cfg, torch.zeros(2, 1, cfg.d_model), 3)


def test_native_gather_is_every_rank_in_rank_order():
    part = torch.arange(4 * 3 * 5, dtype=torch.float32).reshape(4, 3, 5)
    full = allgather_ranks(part)
    want = torch.cat(list(part), dim=-1)
    assert full.shape == (4, 3, 20)
    for r in range(4):
        assert torch.equal(full[r], want)


# ---------------------------------------------------------------------------
# the sharded engine's partial logits against the JAX pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_partial_logits_match_the_jax_local_step(arch):
    """Four fused calls of the sharded engine's decode (``_decode``, the
    code its steps run) on its own pool, against the JAX
    ``decode_hidden_paged`` + per-rank ``unembed_partial`` on a JAX pool
    fed the same tokens: every rank's slice within f32 tolerance."""
    from repro.serve.kvcache import PagedKVCache as JaxPagedKVCache
    jcfg, jparams, cfg, params = bridged(arch)
    n, lanes = 4, 3
    srv = ServeEngine(cfg, params, ProgressEngine(), batch_slots=lanes,
                      max_seq=32, kv_block_size=4, device="cpu",
                      mesh=make_mesh((n,), ("model",), "cpu"))
    jpool = JaxPagedKVCache(jcfg, lanes, 32, block_size=4)
    for i in range(lanes):
        srv.slots.assign(f"r{i}", seq_len=5)
        jpool.assign(f"r{i}", seq_len=5)
    rs = np.random.RandomState(7)
    w = cfg.vocab_size // n
    for t in range(4):
        toks = rs.randint(1, cfg.vocab_size, (lanes, 1)).astype(np.int32)
        fed = np.array([True, t % 2 == 0, True])
        pos = np.full((lanes,), t, np.int32)
        tables = srv.slots.block_tables()
        assert np.array_equal(tables.numpy(), np.asarray(jpool.block_tables()))
        part, srv.slots.cache = srv._decode(
            srv.slots.cache, to_device(toks, srv.device),
            to_device(pos, srv.device), tables, to_device(fed, srv.device))
        hid, jpool.cache = jax_registry.decode_hidden_paged(
            jparams, jcfg, jpool.cache, jnp.asarray(toks), jnp.asarray(pos),
            jpool.block_tables(), jnp.asarray(fed))
        want = np.stack([np.asarray(jax_registry.unembed_partial(
            jparams, jcfg, hid, r * w, w))[:, 0] for r in range(n)])
        assert part.shape == (n, lanes, w)
        np.testing.assert_allclose(part.numpy(), want, atol=1e-4, rtol=1e-4)
    srv.close()


# ---------------------------------------------------------------------------
# sharded streams: user == native, bit for bit, == the JAX unsharded engine
# ---------------------------------------------------------------------------

def serve_jax(jcfg, jparams, ps, max_new):
    eng = JaxProgressEngine()
    srv = JaxServeEngine(jcfg, jparams, eng, batch_slots=4, max_seq=32)
    reqs = [JaxGenRequest(f"r{i}", p, max_new_tokens=max_new)
            for i, p in enumerate(ps)]
    for r in reqs:
        srv.submit(r)
    srv.run_until_idle(timeout=300)
    srv.close(timeout=60)
    return [list(r.out_tokens) for r in reqs]


def serve_port(cfg, params, ps, max_new, *, n=None, backend="native",
               workers=0, start=True, chunks=2, per_device=False):
    eng = ProgressEngine()
    ex = ProgressExecutor(eng, workers, steal=False) if workers else None
    if ex is not None and start:
        ex.start()
    mesh = None
    if n and per_device:
        mesh = make_mesh((n,), ("model",), devices=["cpu"] * n)
    elif n:
        mesh = make_mesh((n,), ("model",), "cpu")
    srv = ServeEngine(cfg, params, eng, batch_slots=4, max_seq=32,
                      executor=ex, mesh=mesh,
                      device=None if per_device else "cpu",
                      collective_spec=CollectiveSpec(backend=backend,
                                                     chunks=chunks))
    reqs = [GenRequest(f"r{i}", p, max_new_tokens=max_new)
            for i, p in enumerate(ps)]
    try:
        for r in reqs:
            srv.submit(r)
        srv.run_until_idle(timeout=300)
        lat = srv.latency_snapshot()
        starts = srv._ag_handle.starts if srv._ag_handle is not None else None
        steps, checked = srv.steps, srv._rows_checked
        srv.close(timeout=60)
    finally:
        if ex is not None and ex.running:
            ex.shutdown(drain=True, timeout=60)
    assert lat.completed == len(ps) and lat.failed == 0
    assert checked == bool(n)          # the gathered rows were checked
    return [list(r.out_tokens) for r in reqs], starts, steps


@pytest.fixture(scope="module", params=ARCHS)
def reference(request):
    """The JAX unsharded engine's greedy streams: one run per family."""
    jcfg, jparams, cfg, params = bridged(request.param)
    ps = prompts(6, cfg.vocab_size)
    return cfg, params, ps, serve_jax(jcfg, jparams, ps, 5)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_streams_user_equal_native_and_jax(reference, n):
    cfg, params, ps, want = reference
    native, no_handle, _ = serve_port(cfg, params, ps, 5, n=n)
    user, starts, steps = serve_port(cfg, params, ps, 5, n=n,
                                     backend="user")
    assert no_handle is None
    assert user == native                 # bit for bit: the same partials
    assert starts == steps > 0            # one gather start a step
    assert user == want                   # the JAX unsharded streams
    assert serve_port(cfg, params, ps, 5)[0] == want


def test_executor_driven_gather_serves_the_caller_driven_streams(reference):
    cfg, params, ps, want = reference
    caller, _, _ = serve_port(cfg, params, ps, 5, n=2, backend="user")
    driven, starts, steps = serve_port(cfg, params, ps, 5, n=2,
                                       backend="user", workers=2)
    # an executor attached but never started must drive every serve
    # stream inline (the collective stream's rounds included), not hang
    idle, _, _ = serve_port(cfg, params, ps, 5, n=2, backend="user",
                            workers=2, start=False)
    assert caller == driven == idle == want
    assert starts == steps


# ---------------------------------------------------------------------------
# the eager errors, as the JAX engine raises them
# ---------------------------------------------------------------------------

def test_eager_errors_match_jax():
    from repro import compat
    jcfg, jparams, cfg, params = bridged("qwen2-0.5b")
    jmesh = compat.make_mesh((1,), ("model",))
    mesh = make_mesh((4,), ("model",), "cpu")

    def jax_engine(**kw):
        return JaxServeEngine(jcfg, jparams, JaxProgressEngine(),
                              batch_slots=2, max_seq=32, **kw)

    def port_engine(**kw):
        return ServeEngine(cfg, params, ProgressEngine(), batch_slots=2,
                           max_seq=32, device="cpu", **kw)

    cases = [
        ("requires a mesh", lambda: jax_engine(collective_backend="user"),
         lambda: port_engine(collective_backend="user")),
        ("has no axis", lambda: jax_engine(mesh=jmesh, model_axis="nope"),
         lambda: port_engine(mesh=mesh, model_axis="nope")),
        ("backend", lambda: jax_engine(collective_backend="bogus"),
         lambda: port_engine(collective_backend="bogus")),
    ]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for match, jax_fn, port_fn in cases:
            with pytest.raises(ValueError, match=match):
                jax_fn()
            with pytest.raises(ValueError, match=match):
                port_fn()
    # a vocabulary the model axis does not divide (the JAX test builds it
    # on a 2- and a 4-device mesh in a child; the message is the same)
    bad = cfg.with_overrides(vocab_size=254)
    with pytest.raises(ValueError, match="divisible"):
        ServeEngine(bad, registry.init_params(bad, torch.Generator()),
                    ProgressEngine(), batch_slots=2, max_seq=32, mesh=mesh,
                    device="cpu")
    # a family without paged decode is refused before any mesh check
    jw = jax_get_config("whisper-tiny")
    with pytest.raises(ValueError, match="paged serving not supported"):
        JaxServeEngine(jw, {}, JaxProgressEngine(), batch_slots=2,
                       max_seq=32, mesh=jmesh)
    with pytest.raises(ValueError, match="paged serving not supported"):
        ServeEngine(port_cfg(jw), {}, ProgressEngine(), batch_slots=2,
                    max_seq=32, mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="not the mesh's device"):
        ServeEngine(cfg, params, ProgressEngine(), mesh=mesh, device="meta")


# ---------------------------------------------------------------------------
# a device per rank
# ---------------------------------------------------------------------------

def dev_mesh(n):
    return make_mesh((n,), ("model",), devices=["cpu"] * n)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_per_device_partial_logits_match_the_jax_local_step(arch, n):
    """Three fused calls of the per-device engine's ``_decode``: each
    rank's ``[1, B, V/n]`` on its device within f32 tolerance of the JAX
    ``decode_hidden_paged`` + ``unembed_partial`` piece, and, on the CPU,
    bit for bit the rank-stacked engine's row (``unembed_ranks``' batched
    product equals the single slices here)."""
    from repro.serve.kvcache import PagedKVCache as JaxPagedKVCache
    from repro_torch.collectives.rank_shards import RankShards
    jcfg, jparams, cfg, params = bridged(arch)
    lanes = 3
    kw = dict(batch_slots=lanes, max_seq=32, kv_block_size=4)
    dev = ServeEngine(cfg, params, ProgressEngine(), mesh=dev_mesh(n), **kw)
    ref = ServeEngine(cfg, params, ProgressEngine(), device="cpu",
                      mesh=make_mesh((n,), ("model",), "cpu"), **kw)
    jpool = JaxPagedKVCache(jcfg, lanes, 32, block_size=4)
    for i in range(lanes):
        for pool in (dev.slots, ref.slots, jpool):
            pool.assign(f"r{i}", seq_len=5)
    rs = np.random.RandomState(7)
    w = cfg.vocab_size // n
    for t in range(3):
        toks = rs.randint(1, cfg.vocab_size, (lanes, 1)).astype(np.int32)
        fed = np.array([True, t % 2 == 0, True])
        pos = np.full((lanes,), t, np.int32)
        part, dev.slots.cache = dev._decode(
            dev.slots.cache, dev.slots.place(toks), dev.slots.place(pos),
            dev.slots.block_tables(), dev.slots.place(fed))
        stacked, ref.slots.cache = ref._decode(
            ref.slots.cache, to_device(toks, ref.device),
            to_device(pos, ref.device), ref.slots.block_tables(),
            to_device(fed, ref.device))
        hid, jpool.cache = jax_registry.decode_hidden_paged(
            jparams, jcfg, jpool.cache, jnp.asarray(toks), jnp.asarray(pos),
            jpool.block_tables(), jnp.asarray(fed))
        assert isinstance(part, RankShards) and len(part) == n
        assert part.devices == dev.mesh.devices
        for r in range(n):
            want = np.asarray(jax_registry.unembed_partial(
                jparams, jcfg, hid, r * w, w))[:, 0]
            assert part[r].shape == (1, lanes, w)
            np.testing.assert_allclose(part[r][0].numpy(), want, atol=1e-4,
                                       rtol=1e-4)
        assert torch.equal(part.to_stacked("cpu"), stacked)
    dev.close()
    ref.close()


@pytest.mark.parametrize("n", [2, 4])
def test_per_device_streams_equal_stacked_and_jax(reference, n):
    """User and native on a device per rank, bit for bit, with one gather
    start a step; both equal the JAX unsharded engine's streams, which
    the rank-stacked engine's equal on both backends
    (``test_sharded_streams_user_equal_native_and_jax``)."""
    cfg, params, ps, want = reference
    native, no_handle, _ = serve_port(cfg, params, ps, 5, n=n,
                                      per_device=True)
    user, starts, steps = serve_port(cfg, params, ps, 5, n=n,
                                     backend="user", per_device=True)
    assert no_handle is None
    assert user == native == want
    assert starts == steps > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_per_device_weights_and_pool_are_a_replica_per_rank(arch):
    """On a mesh of ``["cpu"] * 4`` every weight and pool leaf is a
    ``RankShards`` replica, a copy of its own on each rank's device,
    cast once; positions, tables and tokens come as a copy a device;
    ``device=`` beside such a mesh is refused, by the pool too."""
    from repro_torch.collectives.rank_shards import RankShards
    from repro_torch.models.layers import tree_leaves
    from repro_torch.serve.kvcache import PagedKVCache
    _, _, cfg, params = bridged(arch)
    mesh = dev_mesh(4)
    srv = ServeEngine(cfg, params, ProgressEngine(), batch_slots=2,
                      max_seq=32, mesh=mesh)
    for tree in (srv.params, srv.slots.cache):
        for path, leaf in tree_leaves(tree):
            assert isinstance(leaf, RankShards) and leaf.replica, path
            assert leaf.devices == mesh.devices
            assert len({s.data_ptr() for s in leaf}) == 4, path
            assert all(torch.equal(s, leaf[0]) for s in leaf), path
    cast = registry.cast_params(cfg, params)
    for (path, leaf), (_, want) in zip(tree_leaves(srv.params),
                                       tree_leaves(cast)):
        assert leaf.dtype == want.dtype and torch.equal(leaf[3], want), path
    for got in (srv.slots.positions(), srv.slots.block_tables(),
                srv.slots.place(np.zeros(2, np.int32))):
        assert isinstance(got, RankShards) and got.devices == mesh.devices
    assert srv.device == torch.device("cpu") and srv.slots.devices == \
        mesh.devices
    srv.close()
    with pytest.raises(ValueError, match="no device= beside it"):
        ServeEngine(cfg, params, ProgressEngine(), mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="no device= beside it"):
        PagedKVCache(cfg, 2, 32, mesh=mesh, device="cpu")
