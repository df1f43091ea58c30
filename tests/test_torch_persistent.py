"""Persistent collective schedules, round batching and the engine grad
reducer of the port, against the JAX package
(``tests/test_persistent_collectives.py``'s counterparts).

A JAX child (4 host devices) runs persistent rebinds and the engine
grad reducer over three steps on numpy inputs from a seed; the port must
give the same outputs bit for bit, and the plain sum (integer-valued
rebind payloads make the float sums exact) or mean.  The handle lifecycle — one outstanding start,
failure then restart, cancel, close, the carries a restart reuses — runs
in-process on fake host plans and small CPU payloads."""
import random
import types
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.collectives import nonblocking as NB
from repro_torch.collectives import schedules as S
from repro_torch.core import DEFERRED, ProgressEngine
from repro_torch.core.request import CancelledError
from repro_torch.launch.mesh import make_mesh
from tests._multidevice import run_with_devices

REBIND_NS = (2, 3, 4)


def rebind_inputs(n):
    rs = np.random.RandomState(40 + n)
    return [rs.randint(-8, 8, size=(n * 2, 33)).astype(np.float32)
            for _ in range(3)]


def reducer_inputs():
    rs = np.random.RandomState(9)
    return [{"w": rs.randn(4, 8, 16).astype(np.float32),
             "b": rs.randn(4, 16).astype(np.float32)} for _ in range(3)]


_JAX_CHILD = """
import sys, warnings
sys.path.insert(0, {root!r})
warnings.simplefilter("ignore")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.core import ProgressEngine
from repro.collectives import nonblocking as NB
from repro.collectives import schedules as S
from repro.collectives.overlap import EngineGradReducer
from tests.test_torch_persistent import (REBIND_NS, rebind_inputs,
                                         reducer_inputs)
res = {{}}
eng = ProgressEngine()
coll = NB.UserCollectives(eng)
for n in REBIND_NS:
    mesh = Mesh(np.array(jax.devices()[:n]), ("x",))
    for alg in S.ALGORITHMS:
        h = coll.allreduce_init(jax.ShapeDtypeStruct((n * 2, 33),
                                                     jnp.float32),
                                mesh, "x", algorithm=alg, chunks=2)
        for i, x in enumerate(rebind_inputs(n)):
            res[f"rebind/{{n}}/{{alg}}/{{i}}"] = h.start(
                jnp.asarray(x)).wait(timeout=300)
        h.close()
coll.close()
mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
red = EngineGradReducer(mesh, "data", engine=eng, chunks=3, bucket_bytes=64,
                        mean=True)
for step, grads in enumerate(reducer_inputs()):
    out = red.iallreduce_tree({{k: jnp.asarray(v) for k, v in grads.items()}}
                              ).wait(timeout=300)
    for k, v in out.items():
        res[f"reducer/{{step}}/{{k}}"] = v
res["reducer/handles"] = np.asarray([h.starts for h in
                                     red._persistent.values()])
red.close()
np.savez({out!r}, **{{k: np.asarray(v) for k, v in res.items()}})
print("SAVED", len(res))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("persistent") / "ref.npz"
    root = str(Path(__file__).resolve().parents[1])
    log = run_with_devices(_JAX_CHILD.format(root=root, out=str(out)),
                           n_devices=4, timeout=600)
    assert "SAVED" in log
    return dict(np.load(out))


@pytest.mark.parametrize("n", REBIND_NS)
def test_persistent_rebind_equals_jax(ref, n):
    """MPI *_init/Start: one handle, three successive distinct payloads,
    each equal to JAX's persistent rebind and to the plain sum."""
    mesh = make_mesh((n,), ("x",), "cpu")
    coll = NB.UserCollectives(ProgressEngine())
    for alg in S.ALGORITHMS:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")          # n = 3: pow2 fallback
            h = coll.allreduce_init(torch.zeros(n * 2, 33), mesh, "x",
                                    algorithm=alg, chunks=2)
        for i, x in enumerate(rebind_inputs(n)):
            got = h.start(torch.from_numpy(x)).wait(timeout=30).numpy()
            np.testing.assert_array_equal(got, ref[f"rebind/{n}/{alg}/{i}"])
            plain = x.reshape(n, 2, 33).sum(0)
            np.testing.assert_array_equal(got, np.tile(plain, (n, 1)))
        assert h.starts == 3
        h.close()
    assert coll.failed == 0
    coll.close()


@pytest.mark.parametrize("n", (1, 2, 4))
def test_round_batched_equals_unbatched(n):
    """Round fusion is composition: batched (with the stacked multi-chunk
    path) and unbatched issues give the same outputs for every algorithm
    and every op."""
    mesh = make_mesh((n,), ("x",), "cpu")
    coll = NB.UserCollectives(ProgressEngine())
    rs = np.random.RandomState(n)
    x = torch.from_numpy(rs.randn(n * 2, 3, 40).astype(np.float32))
    for alg in S.ALGORITHMS:
        for K in (1, 3):
            want = coll.iallreduce(x, mesh, "x", algorithm=alg, chunks=K,
                                   round_batch=1).wait(timeout=30)
            for rb in (2, 100, None):
                got = coll.iallreduce(x, mesh, "x", algorithm=alg, chunks=K,
                                      round_batch=rb).wait(timeout=30)
                assert torch.equal(got, want), (alg, K, rb)
    y = torch.from_numpy(rs.randn(n * 2, n * 4).astype(np.float32))
    for op in ("ireduce_scatter", "iallgather"):
        want = getattr(coll, op)(y, mesh, "x", chunks=2,
                                 round_batch=1).wait(timeout=30)
        got = getattr(coll, op)(y, mesh, "x", chunks=2,
                                round_batch=100).wait(timeout=30)
        assert torch.equal(got, want), op
    z = torch.from_numpy(rs.randn(n * n, 6).astype(np.float32))
    want = coll.ialltoall(z, mesh, "x", chunks=2, round_batch=1).wait(timeout=30)
    got = coll.ialltoall(z, mesh, "x", chunks=2, round_batch=100).wait(timeout=30)
    assert torch.equal(got, want)
    coll.close()


def test_grad_reducer_equals_jax_and_caches_handles(ref):
    """EngineGradReducer: one persistent schedule per bucket, restarted
    across steps, each step's reduction equal to JAX's reducer bit for
    bit and to the plain mean within 1e-6."""
    from repro_torch.collectives.overlap import EngineGradReducer
    mesh = make_mesh((4,), ("data",), "cpu")
    red = EngineGradReducer(mesh, "data", engine=ProgressEngine(), chunks=3,
                            bucket_bytes=64, mean=True)
    for step, grads in enumerate(reducer_inputs()):
        out = red.iallreduce_tree({k: torch.from_numpy(v)
                                   for k, v in grads.items()}).wait(30)
        for k, g in grads.items():
            np.testing.assert_array_equal(out[k].numpy(),
                                          ref[f"reducer/{step}/{k}"])
            np.testing.assert_allclose(out[k].numpy(), g.mean(0), rtol=1e-6,
                                       atol=1e-6)
    handles = list(red._persistent.values())
    assert len(handles) >= 2                     # one per bucket
    assert sorted(h.starts for h in handles) == \
        sorted(ref["reducer/handles"].tolist()) == [3] * len(handles)
    assert red.dispatches_per_step == sum(h.dispatches_per_start
                                          for h in handles)
    red.close()
    assert all(h._closed for h in handles)


def test_restart_reuses_its_carries():
    """A completed start's successor writes the same workspace buffers
    (MPI's persistent request owns its carries); the result is a fresh
    tensor each start, so an earlier result survives a later start."""
    coll = NB.UserCollectives(ProgressEngine())
    mesh = make_mesh((4,), ("x",), "cpu")
    h = coll.allreduce_init(torch.zeros(8, 64), mesh, "x", chunks=2,
                            round_batch=1)
    bufs = [dict(ws.bufs) for ws in h._workspaces]
    assert all(bufs)
    x1, x2 = torch.randn(8, 64), torch.randn(8, 64)
    r1 = h.start(x1).wait(timeout=30)
    keep = r1.clone()
    r2 = h.start(x2).wait(timeout=30)
    assert torch.equal(r1, keep) and not torch.equal(r1, r2)
    for before, ws in zip(bufs, h._workspaces):
        assert before.keys() == ws.bufs.keys()
        assert all(before[k] is ws.bufs[k] for k in before)
    coll.close()


# ---------------------------------------------------------------------------
# Handle lifecycle (in-process, fake host plans)
# ---------------------------------------------------------------------------

def host_schedule(fns):
    sched = NB._Schedule(tuple(fns))
    return types.SimpleNamespace(num_rounds=len(fns),
                                 compiled=lambda b: sched)


def fake_plan(schedules, split=None, join=None):
    return NB._Plan("allreduce", "ring", None, None, None, None,
                    schedules, split or (lambda x: [x]),
                    join or NB._first, 0, 1)


def make_handle(fns, **plan_kw):
    coll = NB.UserCollectives(ProgressEngine())
    plan = fake_plan([host_schedule(fns)], **plan_kw)
    return coll, NB.PersistentCollective(coll, plan, warmup=False)


class TestPersistentLifecycle:
    def test_start_wait_start(self):
        coll, h = make_handle([lambda v: v + 1, lambda v: v * 10])
        assert h.start(1.0).wait(timeout=5) == 20.0
        assert h.start(2.0).wait(timeout=5) == 30.0
        assert h.starts == 2
        coll.close()

    def test_second_start_while_active_raises(self):
        coll, h = make_handle([lambda v: v])
        req = h.start(1.0)
        with pytest.raises(RuntimeError, match="active start"):
            h.start(2.0)
        req.wait(timeout=5)
        h.start(3.0).wait(timeout=5)
        coll.close()

    def test_failure_then_restart_same_handle(self):
        def stage(v):
            if v < 0:
                raise RuntimeError("negative payload boom")
            return v + 1

        coll, h = make_handle([stage])
        bad = h.start(-1.0)
        assert bad.failed
        with pytest.raises(RuntimeError, match="negative payload boom"):
            bad.value()
        ws = h._workspaces
        assert h.start(5.0).wait(timeout=5) == 6.0
        assert h._workspaces is not ws           # fresh carries after a fail
        assert coll.failed == 1 and coll.completed == 1
        coll.close()

    def test_cancel_then_restart(self):
        gate = {"open": False}
        blocker = types.SimpleNamespace(is_ready=lambda: gate["open"])
        coll, h = make_handle([lambda v: blocker if v == 1.0 else v,
                               lambda v: v])
        req = h.start(1.0)
        assert not req.is_complete
        h.cancel()
        assert req.cancelled and req.failed
        with pytest.raises(CancelledError):
            req.wait(timeout=5)
        assert coll.cancelled == 1 and coll.in_flight == 0
        h.cancel()                               # idle: a no-op
        req2 = h.start(2.0)
        gate["open"] = True
        assert req2.wait(timeout=5) == 2.0
        coll.close()

    def test_cancel_after_complete_is_noop(self):
        coll, h = make_handle([lambda v: v])
        req = h.start(1.0)
        assert req.wait(timeout=5) == 1.0
        req.cancel()
        assert not req.cancelled and req.value() == 1.0
        assert coll.cancelled == 0
        coll.close()

    def test_closed_handle_rejects_start(self):
        coll, h = make_handle([lambda v: v])
        h.close()
        with pytest.raises(RuntimeError, match="closed"):
            h.start(1.0)
        coll.close()

    def test_shape_dtype_validation(self):
        mesh = make_mesh((1,), ("x",), "cpu")
        coll = NB.UserCollectives(ProgressEngine())
        h = coll.allreduce_init(torch.zeros(2, 4), mesh, "x")
        with pytest.raises(ValueError, match="shape"):
            h.start(torch.zeros(2, 5))
        with pytest.raises(ValueError, match="dtype"):
            h.start(torch.zeros(2, 4, dtype=torch.int32))
        assert h.start(torch.ones(2, 4)).wait(timeout=30).shape == (2, 4)
        coll.close()


class TestRoundBatching:
    def test_auto_round_batch_equals_jax_at_its_breakpoints(self):
        from repro.collectives import schedules as JS
        assert (S.ROUND_BATCH_SMALL_BYTES, S.ROUND_BATCH_LARGE_BYTES) == \
            (JS.ROUND_BATCH_SMALL_BYTES, JS.ROUND_BATCH_LARGE_BYTES)
        points = [0, 1, 128 << 10]
        for b in (S.ROUND_BATCH_SMALL_BYTES, S.ROUND_BATCH_LARGE_BYTES):
            points += [b - 1, b, b + 1]
        for nbytes in points + [1 << 30]:
            for rounds in (0, 1, 2, 5, 15, 17):
                assert S.auto_round_batch(nbytes, rounds) == \
                    JS.auto_round_batch(nbytes, rounds), (nbytes, rounds)

    def test_fuse_rounds_is_composition(self):
        fns = [lambda v: v + 1, lambda v: v * 3, lambda v: v - 2]
        assert S.fuse_rounds(fns)(4) == ((4 + 1) * 3) - 2
        assert S.fuse_rounds([fns[0]]) is fns[0]
        with pytest.raises(ValueError):
            S.fuse_rounds([])

    def test_compiled_groups_and_caches(self):
        stages = [NB._RoundStage(lambda v, ws, i=i: v + i) for i in range(5)]
        rs = NB._RoundSchedule(stages)
        assert rs.compiled(2).num_rounds == 3        # 2+2+1
        assert rs.compiled(5).num_rounds == 1
        assert rs.compiled(99).num_rounds == 1       # clamped to len
        assert rs.compiled(1).num_rounds == 5
        assert rs.compiled(2) is rs.compiled(2)      # cached per batch
        for b in (1, 2, 5):
            out = torch.ones(1, 3)
            for prog in NB._bind(rs.compiled(b), NB._Workspace()).stages:
                out = prog(out)
            assert float(out[0, 0]) == 1 + 0 + 1 + 2 + 3 + 4

    def test_plan_round_batch_resolution(self):
        assert NB._resolve_round_batch(3, 1 << 30, 15) == 3
        assert NB._resolve_round_batch(None, 128 << 10, 15) == 15
        assert NB._resolve_round_batch(0, 1 << 30, 15) == 1
        coll = NB.UserCollectives(ProgressEngine())
        h = coll.allreduce_init(torch.zeros(2, 8),
                                make_mesh((1,), ("x",), "cpu"), "x",
                                round_batch=3, warmup=False)
        assert h.round_batch == 1                    # n = 1: degenerate
        coll.close()


def test_persistent_restart_random_drains():
    """A persistent handle restarted many times under random progress /
    drain interleavings runs every stage exactly once per start."""
    coll = NB.UserCollectives(ProgressEngine(), policy=DEFERRED)
    eng = coll.engine
    counts = []

    def stage(s):
        def fn(v):
            counts[-1][s] += 1
            return v + 1
        return fn

    plan = fake_plan([host_schedule([stage(0), stage(1), stage(2)])])
    h = NB.PersistentCollective(coll, plan, warmup=False)
    rng = random.Random(7)
    for trial in range(20):
        counts.append([0, 0, 0])
        req = h.start(float(trial))
        steps = 0
        while not req.is_complete and steps < 10_000:
            op = rng.randrange(3)
            if op == 0:
                eng.progress(coll.stream)
            elif op == 1:
                coll.queue.drain(max_items=rng.randrange(1, 3))
            else:
                eng.progress(coll.stream)
                coll.queue.drain()
            steps += 1
        assert req.value() == trial + 3.0
    assert counts == [[1, 1, 1]] * 20
    coll.close()
