"""The port's user-space point-to-point (``repro_torch.collectives.p2p``),
as the JAX package's ``tests/test_p2p.py`` holds its own: isend/irecv
matched FIFO by tag and direction in either posting order, the fused
``sendrecv``, persistent channels restarted (executor-driven issue), and
epoch invalidation with ``rebuild`` on the survivors' mesh.  A hop moves
rank i's row to rank i+1 (``np.roll`` by one); the same hop through the
JAX package's ``P2P`` on 4 host devices gives the same tensor."""
import threading
import warnings

import numpy as np
import pytest
import torch

from repro_torch.collectives import nonblocking as NB
from repro_torch.collectives.nonblocking import (CollectiveSpec,
                                                 MembershipEpoch,
                                                 MembershipError)
from repro_torch.collectives.p2p import P2P, _resolve_spec_partition
from repro_torch.core import ProgressEngine, ProgressExecutor
from repro_torch.launch.mesh import make_mesh
from tests._multidevice import run_with_devices


def roll(x, k=1):
    return np.roll(x.numpy(), k, axis=0)


def test_isend_irecv_roundtrip_and_matching():
    p2p = P2P(ProgressEngine())
    mesh = make_mesh((4,), ("x",), "cpu")
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)

    sreq = p2p.isend(x, mesh, "x")
    rreq = p2p.irecv(x, mesh, "x")
    np.testing.assert_array_equal(rreq.wait(timeout=30).numpy(), roll(x))
    sreq.wait(timeout=30)
    assert sreq.value() is None

    rrev = p2p.irecv(x, mesh, "x", reverse=True)      # recv posted first
    p2p.isend(x, mesh, "x", reverse=True)
    np.testing.assert_array_equal(rrev.wait(timeout=30).numpy(), roll(x, -1))

    # the unexpected-message queue: two sends before any recv match FIFO
    a, b = x + 100.0, x + 200.0
    p2p.isend(a, mesh, "x")
    p2p.isend(b, mesh, "x")
    assert p2p.unexpected >= 2
    r1, r2 = p2p.irecv(x, mesh, "x"), p2p.irecv(x, mesh, "x")
    np.testing.assert_array_equal(r1.wait(timeout=30).numpy(), roll(a))
    np.testing.assert_array_equal(r2.wait(timeout=30).numpy(), roll(b))
    assert p2p.matched >= 3

    # tags partition the matching space
    p2p.isend(a, mesh, "x", tag=0)
    rt = p2p.irecv(x, mesh, "x", tag=1)
    assert not rt.is_complete
    p2p.isend(b, mesh, "x", tag=1)
    np.testing.assert_array_equal(rt.wait(timeout=30).numpy(), roll(b))
    p2p.irecv(x, mesh, "x", tag=0).wait(timeout=30)

    sr = p2p.sendrecv(x, mesh, "x")
    np.testing.assert_array_equal(sr.wait(timeout=30).numpy(), roll(x))
    assert p2p.stream.completions > 0
    p2p.close()


def test_hop_equals_jax_p2p(tmp_path):
    out = tmp_path / "hop.npz"
    run_with_devices(f"""
        import jax.numpy as jnp, numpy as np, jax
        from jax.sharding import Mesh
        from repro.collectives.p2p import P2P
        from repro.core import ProgressEngine
        p2p = P2P(ProgressEngine())
        mesh = Mesh(np.array(jax.devices()), ("x",))
        x = jnp.asarray(np.random.RandomState(3).randn(4, 5, 2)
                        .astype(np.float32))
        fwd = p2p.sendrecv(x, mesh, "x").wait(timeout=120)
        p2p.isend(x, mesh, "x", reverse=True)
        rev = p2p.irecv(x, mesh, "x", reverse=True).wait(timeout=120)
        np.savez({str(out)!r}, x=np.asarray(x), fwd=np.asarray(fwd),
                 rev=np.asarray(rev))
        p2p.close()
    """, n_devices=4)
    ref = np.load(out)
    p2p = P2P(ProgressEngine())
    mesh = make_mesh((4,), ("x",), "cpu")
    x = torch.from_numpy(ref["x"])
    np.testing.assert_array_equal(p2p.sendrecv(x, mesh, "x").wait(
        timeout=30).numpy(), ref["fwd"])
    p2p.isend(x, mesh, "x", reverse=True)
    np.testing.assert_array_equal(p2p.irecv(x, mesh, "x", reverse=True).wait(
        timeout=30).numpy(), ref["rev"])
    p2p.close()


def test_persistent_channel_restarts_and_executor_issue():
    eng = ProgressEngine()
    ex = ProgressExecutor(eng, num_workers=2).start()
    eng.attach_executor(ex)
    p2p = P2P(eng, executor=ex)
    mesh = make_mesh((2,), ("x",), "cpu")
    like = torch.zeros(2, 4)
    send = p2p.send_init(like, mesh, "x")
    recv = p2p.recv_init(like, mesh, "x")
    assert send.channel is recv.channel          # same signature: the match
    chan = send.channel
    starts0 = chan.starts
    for i in range(20):
        x = torch.full((2, 4), float(i + 1)) + torch.arange(2.0)[:, None]
        hop = send.start(x)
        inner = chan.persistent.active
        got = recv.start().wait(timeout=30)
        np.testing.assert_array_equal(got.numpy(), roll(x))
        hop.wait(timeout=30)
        assert inner.issue_thread in ex.worker_thread_idents()
        assert inner.issue_thread != threading.get_ident()
    assert chan.starts == starts0 + 20 and recv.starts == 20
    p2p.close()
    ex.shutdown(drain=True, timeout=30)


def test_channel_epoch_invalidation_and_rebuild():
    epoch = MembershipEpoch(mesh=make_mesh((4,), ("x",), "cpu"))
    assert epoch.n_devices == 4
    p2p = P2P(ProgressEngine(), epoch=epoch)
    mesh = make_mesh((4,), ("x",), "cpu")
    chan = p2p.channel_init(torch.zeros(4, 4), mesh, "x")
    x = torch.arange(16.0).reshape(4, 4)
    chan.send.start(x)
    chan.recv.start().wait(timeout=30)

    seen = []
    epoch.subscribe(lambda ep, exc: seen.append(exc.survivors))
    epoch.invalidate(survivors=2, reason="test kill")
    assert chan.stale and seen == [2] and epoch.n_devices == 2
    with pytest.raises(MembershipError):
        chan.send.start(x)

    small = make_mesh((2,), ("x",), "cpu")
    chan.rebuild(small, axis="x")
    y = torch.arange(8.0).reshape(2, 4)
    chan.send.start(y)
    np.testing.assert_array_equal(chan.recv.start().wait(timeout=30).numpy(),
                                  roll(y))
    assert chan.persistent.rebuilds == 1
    p2p.close()


def test_invalidation_fails_an_in_flight_start_once():
    """A start in flight when the epoch is invalidated fails with a
    retryable MembershipError exactly once."""
    import types
    epoch = MembershipEpoch(4)
    coll = NB.UserCollectives(ProgressEngine(), epoch=epoch)
    gate = types.SimpleNamespace(is_ready=lambda: False)
    sched = NB._Schedule((lambda v: gate,))
    plan = NB._Plan("allreduce", "ring", None, None, None, None,
                    [types.SimpleNamespace(num_rounds=1,
                                           compiled=lambda b: sched)],
                    lambda x: [x], NB._first, 0, 1)
    h = NB.PersistentCollective(coll, plan, warmup=False, epoch=epoch)
    req = h.start(1.0)
    epoch.invalidate(survivors=3)
    assert req.failed and isinstance(req.exception, MembershipError)
    assert req.exception.survivors == 3 and coll.failed == 1
    epoch.invalidate(survivors=2)
    assert coll.failed == 1
    coll.close(drain=False)


def test_per_device_hops_equal_the_stacked_form():
    """On a mesh of ``["cpu"] * 4``: ``sendrecv``, ``isend``/``irecv`` and
    a persistent channel restarted five times carry ``RankShards`` of each
    rank's ``[1, ...]`` row, each hop the stacked hop's rows bit for bit,
    forward and reverse; each received shard is a fresh tensor; a stacked
    payload on the per-device mesh is refused."""
    from repro_torch.collectives.rank_shards import RankShards
    p2p = P2P(ProgressEngine())
    mesh = make_mesh((4,), ("x",), devices=["cpu"] * 4)
    x = torch.arange(24.0).reshape(4, 2, 3)
    xs = RankShards.from_stacked(x, mesh)
    got = p2p.sendrecv(xs, mesh, "x").wait(timeout=30)
    assert isinstance(got, RankShards)
    np.testing.assert_array_equal(got.to_stacked("cpu").numpy(), roll(x))
    p2p.isend(xs, mesh, "x", reverse=True)
    back = p2p.irecv(xs, mesh, "x", reverse=True).wait(timeout=30)
    np.testing.assert_array_equal(back.to_stacked("cpu").numpy(),
                                  roll(x, -1))
    chan = p2p.channel_init(xs, mesh, "x", reverse=True)
    for i in range(5):
        y = RankShards.from_stacked(x + i, mesh)
        chan.send.start(y)
        out = chan.recv.start().wait(timeout=30)
        np.testing.assert_array_equal(out.to_stacked("cpu").numpy(),
                                      roll(x + i, -1))
        assert all(o.data_ptr() != t.data_ptr()
                   for o in out.shards for t in y.shards)
    assert chan.starts == 5
    with pytest.raises(ValueError, match="must be a RankShards"):
        p2p.sendrecv(x, mesh, "x")
    p2p.close()


class TestP2PSpecShim:
    @pytest.fixture(autouse=True)
    def _reset(self):
        saved = set(NB._legacy_kwargs_warned)
        NB._legacy_kwargs_warned.clear()
        yield
        NB._legacy_kwargs_warned.clear()
        NB._legacy_kwargs_warned.update(saved)

    def test_partition_via_spec_warns_and_works(self):
        with pytest.warns(DeprecationWarning, match="partition"):
            spec, part = _resolve_spec_partition(("x",), None)
        assert spec is None and part == ("x",)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            _resolve_spec_partition(("y",), None)

    def test_native_collective_spec_rejected(self):
        with pytest.raises(ValueError, match="user backend"):
            _resolve_spec_partition(CollectiveSpec(backend="native"), None)

    def test_user_spec_accepted(self):
        spec = CollectiveSpec(backend="user")
        got, part = _resolve_spec_partition(spec, None)
        assert got is spec and part is None

    def test_payload_must_stack_one_row_per_rank(self):
        p2p = P2P(ProgressEngine())
        with pytest.raises(ValueError, match="one slice per rank"):
            p2p.sendrecv(torch.zeros(3, 2), make_mesh((4,), ("x",), "cpu"),
                         "x")
        p2p.close()
