"""The port's request lifecycle and config surface for the nonblocking
user-space collectives, as the JAX package's tests hold them
(``tests/test_nonblocking_collectives.py``'s pipeline mechanics and
``tests/test_collective_api.py``'s non-serve cases): failure at issue
and mid-pipeline, sibling chunks abandoned, the closed context, eager
shape validation, close with work in flight, the deferred issue on an
executor, exactly-once completion under random drain orderings, and the
``CollectiveSpec`` record with its deprecation shim.  Host-only fake
schedules (floats, and stand-ins answering ``is_ready()``) drive the
machinery with no device."""
import random
import threading
import types
import warnings

import pytest
import torch

from repro_torch.collectives import nonblocking as NB
from repro_torch.collectives.nonblocking import CollectiveSpec, \
    spec_from_legacy
from repro_torch.core import DEFERRED, ProgressEngine, ProgressExecutor
from repro_torch.launch.mesh import make_mesh


def make_coll(policy=None):
    kwargs = {"policy": policy} if policy else {}
    return NB.UserCollectives(ProgressEngine(), **kwargs)


def fake_schedule(stages):
    """A _Schedule of plain host callables (floats instead of tensors:
    torch_future treats them as ready at the first poll)."""
    sched = NB._Schedule.__new__(NB._Schedule)
    sched.stages = tuple(stages)
    return sched


class TestPipelineMechanics:
    def test_failure_at_issue_time_fails_request(self):
        coll = make_coll()

        def boom(v):
            raise RuntimeError("round-0 boom")

        req = coll._issue("allreduce", "ring", [fake_schedule([boom])],
                          [1.0], lambda parts: parts[0])
        assert req.failed
        with pytest.raises(RuntimeError, match="round-0 boom"):
            req.value()
        assert coll.failed == 1
        coll.close()

    def test_failure_mid_pipeline_propagates_into_request(self):
        coll = make_coll()
        ran = []

        def ok(v):
            ran.append(v)
            return v + 1

        def boom(v):
            raise ValueError("round-1 boom")

        req = coll._issue("allreduce", "ring",
                          [fake_schedule([ok, boom])], [1.0],
                          lambda parts: parts[0])
        assert not req.is_complete          # round 0 dispatched fine
        with pytest.raises(ValueError, match="round-1 boom"):
            req.wait(timeout=5.0)
        assert req.failed and ran == [1.0]
        assert coll.failed == 1
        coll.close()

    def test_one_bad_chunk_fails_request_once(self):
        coll = make_coll()

        def ok(v):
            return v

        def boom(v):
            raise RuntimeError("chunk-1 boom")

        req = coll._issue(
            "allreduce", "ring",
            [fake_schedule([ok, ok]), fake_schedule([ok, boom])],
            [1.0, 2.0], lambda parts: parts)
        with pytest.raises(RuntimeError, match="chunk-1 boom"):
            req.wait(timeout=5.0)
        assert coll.failed == 1             # per REQUEST, not per chunk
        assert coll.in_flight == 0
        coll.close()

    def test_failure_abandons_sibling_chunks(self):
        coll = make_coll()
        ran = []

        def boom(v):
            raise RuntimeError("boom")

        def late(v):
            ran.append(v)
            return v

        req = coll._issue("allreduce", "ring",
                          [fake_schedule([boom]),
                           fake_schedule([late, late, late])],
                          [1.0, 2.0], lambda parts: parts)
        assert req.failed
        for _ in range(10):
            coll.engine.progress(coll.stream)
        assert ran == []
        assert coll.failed == 1
        coll.close()

    def test_deferred_without_executor_wait_self_drains(self):
        coll = make_coll(policy=DEFERRED)
        req = coll._issue("allreduce", "ring",
                          [fake_schedule([lambda v: v + 1,
                                          lambda v: v * 10])],
                          [1.0], lambda parts: parts[0])
        assert req.wait(timeout=5.0) == 20.0
        coll.close()

    def test_close_timeout_is_retryable(self):
        coll = make_coll()
        gate = {"open": False}
        blocker = types.SimpleNamespace(is_ready=lambda: gate["open"])
        req = coll._issue("allreduce", "ring",
                          [fake_schedule([lambda v: blocker])], [1.0],
                          lambda parts: parts[0])
        with pytest.raises(TimeoutError):
            coll.close(timeout=0.05)
        gate["open"] = True
        coll.close(timeout=5.0)              # retry succeeds
        assert req.is_complete
        assert coll.stream not in coll.engine._streams

    def test_default_collectives_conflicting_kwargs_raise(self):
        eng = ProgressEngine()
        ctx = NB.default_collectives(eng)
        assert NB.default_collectives(eng) is ctx
        with pytest.raises(ValueError, match="configured differently"):
            NB.default_collectives(eng, policy=DEFERRED)
        ctx.close()
        ctx2 = NB.default_collectives(eng, policy=DEFERRED)
        assert ctx2.queue.policy == DEFERRED
        ctx2.close()

    def test_join_failure_fails_request(self):
        coll = make_coll()

        def bad_join(parts):
            raise RuntimeError("join boom")

        req = coll._issue("allreduce", "ring",
                          [fake_schedule([lambda v: v])], [1.0], bad_join)
        with pytest.raises(RuntimeError, match="join boom"):
            req.wait(timeout=5.0)
        coll.close()

    def test_closed_context_rejects_issues(self):
        coll = make_coll()
        coll.close()
        mesh = types.SimpleNamespace(shape={"x": 2})
        with pytest.raises(RuntimeError, match="closed"):
            coll.iallreduce(None, mesh, "x")

    def test_eager_shape_validation(self):
        coll = make_coll()
        mesh = types.SimpleNamespace(shape={"x": 3})
        arr = types.SimpleNamespace(shape=(6, 10))
        with pytest.raises(ValueError, match="not divisible"):
            coll.ireduce_scatter(arr, mesh, "x")
        with pytest.raises(ValueError, match="not divisible"):
            coll.ialltoall(types.SimpleNamespace(shape=(7, 9)), mesh, "x")
        with pytest.raises(ValueError, match="unknown allreduce algorithm"):
            coll.iallreduce(arr, mesh, "x", algorithm="nope")
        with pytest.raises(ValueError, match="not divisible"):
            coll.iallreduce(types.SimpleNamespace(shape=(7, 9)), mesh, "x")
        one_d = types.SimpleNamespace(shape=(6,))
        for op in ("iallreduce", "ireduce_scatter", "iallgather",
                   "ialltoall"):
            with pytest.raises(ValueError, match="at least 2-D"):
                getattr(coll, op)(one_d, mesh, "x")
        coll.close()

    def test_abandon_close_with_in_flight_work_does_not_raise(self):
        coll = make_coll()
        never_ready = types.SimpleNamespace(is_ready=lambda: False)
        req = coll._issue("allreduce", "ring",
                          [fake_schedule([lambda v: never_ready,
                                          lambda v: v])], [1.0],
                          lambda parts: parts[0])
        assert coll.stream.pending
        coll.close(drain=False)                 # must not raise
        assert not req.is_complete
        assert coll.stream in coll.engine._streams


def test_one_rank_completes_through_a_future():
    """n = 1: the degenerate schedule still completes through the engine,
    never synchronously at issue, and hands back the payload."""
    coll = make_coll()
    x = torch.arange(6.0).reshape(2, 3)
    req = coll.iallreduce(x, make_mesh((1,), ("x",), "cpu"), "x")
    assert not req.is_complete
    assert req.wait(timeout=5) is x
    coll.close()


def test_payload_is_never_written():
    """Rounds write into their workspace, never into the caller's tensor
    (the JAX package's undonated first program)."""
    coll = make_coll()
    for n in (2, 4):
        mesh = make_mesh((n,), ("x",), "cpu")
        x = torch.randn(n * 2, 12)
        keep = x.clone()
        for alg in NB.S.ALGORITHMS:
            coll.iallreduce(x, mesh, "x", algorithm=alg,
                            chunks=2).wait(timeout=5)
        coll.ireduce_scatter(x, mesh, "x").wait(timeout=5)
        coll.iallgather(x, mesh, "x").wait(timeout=5)
        assert torch.equal(x, keep)
    coll.close()


def test_deferred_issue_runs_on_the_executor():
    """With the collective stream adopted by a running executor, a
    persistent start only enqueues its issue task: a worker splits the
    payload and dispatches round 0."""
    eng = ProgressEngine()
    ex = ProgressExecutor(eng, num_workers=2).start()
    eng.attach_executor(ex)
    coll = NB.UserCollectives(eng, executor=ex)
    mesh = make_mesh((4,), ("x",), "cpu")
    h = coll.allreduce_init(torch.zeros(8, 16), mesh, "x", chunks=2)
    for i in range(3):
        x = torch.full((8, 16), float(i)) + torch.arange(8.0)[:, None]
        req = h.start(x)
        out = req.wait(timeout=30)
        assert torch.equal(out, x.unflatten(0, (4, 2)).sum(0).repeat(4, 1))
        assert req.issue_thread in ex.worker_thread_idents()
        assert req.issue_thread != threading.get_ident()
    coll.close()
    ex.shutdown(drain=True, timeout=30)


def run_random_drain(rng, num_chunks, num_stages):
    """One exactly-once trial: chunked fake schedules on a DEFERRED
    queue, progressed/drained in a random interleave."""
    coll = make_coll(policy=DEFERRED)
    eng, stream, queue = coll.engine, coll.stream, coll.queue
    counts = [[0] * num_stages for _ in range(num_chunks)]

    def stage(c, s):
        def fn(v):
            counts[c][s] += 1
            return v + 1
        return fn

    scheds = [fake_schedule([stage(c, s) for s in range(num_stages)])
              for c in range(num_chunks)]
    joins = []

    def join(parts):
        joins.append(list(parts))
        return sum(parts)

    req = coll._issue("allreduce", "ring", scheds,
                      [float(c) for c in range(num_chunks)], join)
    assert not req.is_complete
    steps = 0
    while not req.is_complete and steps < 10_000:
        op = rng.randrange(3)
        if op == 0:
            eng.progress(stream)
        elif op == 1:
            queue.drain(max_items=rng.randrange(1, 3))
        else:
            eng.progress(stream)
            queue.drain()
        steps += 1
    assert req.is_complete, "pipeline wedged under random drain ordering"
    assert counts == [[1] * num_stages for _ in range(num_chunks)], counts
    assert len(joins) == 1
    assert req.value() == sum(c + num_stages for c in range(num_chunks))
    coll.close()


class TestExactlyOnce:
    @pytest.mark.parametrize("seed", range(8))
    def test_random_drain_orderings(self, seed):
        rng = random.Random(seed)
        run_random_drain(rng, num_chunks=rng.randrange(1, 5),
                         num_stages=rng.randrange(1, 6))

    def test_hypothesis_property(self):
        pytest.importorskip("hypothesis")
        from hypothesis import given, settings, strategies as st

        @settings(max_examples=40, deadline=None)
        @given(seed=st.integers(0, 2**32 - 1),
               chunks=st.integers(1, 6), stages=st.integers(1, 6))
        def prop(seed, chunks, stages):
            run_random_drain(random.Random(seed), chunks, stages)

        prop()


def test_trainer_rejects_user_backend_without_split_step(tmp_path):
    from repro_torch.train.train_loop import Trainer, TrainLoopConfig
    with pytest.warns(DeprecationWarning):
        cfg = TrainLoopConfig(collective_backend="user",
                              checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="split_step"):
        Trainer(lambda *a: None, None, None, None, cfg,
                engine=ProgressEngine())


def test_mesh_on_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA: the refusal is for CPU-only boxes")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh((4,), ("x",))
    m = make_mesh((4, 1), ("data", "model"), "cpu")
    assert dict(m.shape)["data"] == 4 and m.size == 4
    assert m == make_mesh((4, 1), ("data", "model"), "cpu")
    assert len({m, make_mesh((4, 1), ("data", "model"), "cpu")}) == 1


# ---------------------------------------------------------------------------
# The CollectiveSpec record and its deprecation shim
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True)
def _reset_warn_once():
    saved = set(NB._legacy_kwargs_warned)
    NB._legacy_kwargs_warned.clear()
    yield
    NB._legacy_kwargs_warned.clear()
    NB._legacy_kwargs_warned.update(saved)


class TestCollectiveSpec:
    def test_defaults_match_jax(self):
        from repro.collectives.nonblocking import CollectiveSpec as JaxSpec
        spec, want = CollectiveSpec(), JaxSpec()
        assert (spec.backend, spec.algorithm, spec.chunks,
                spec.round_batch) == (want.backend, want.algorithm,
                                      want.chunks, want.round_batch)
        assert not spec.user and CollectiveSpec(backend="user").user

    def test_eager_validation(self):
        with pytest.raises(ValueError, match="backend"):
            CollectiveSpec(backend="bogus")
        with pytest.raises(ValueError, match="algorithm"):
            CollectiveSpec(algorithm="bogus")
        with pytest.raises(ValueError, match="chunks"):
            CollectiveSpec(chunks=0)
        with pytest.raises(ValueError, match="round_batch"):
            CollectiveSpec(round_batch=-1)

    def test_frozen_and_hashable(self):
        spec = CollectiveSpec()
        with pytest.raises(Exception):
            spec.backend = "user"
        assert len({CollectiveSpec(), CollectiveSpec(),
                    CollectiveSpec(chunks=2)}) == 2

    def test_resolve_pow2_fallback(self):
        spec = CollectiveSpec(algorithm="halving_doubling")
        assert spec.resolve(4) is spec
        with pytest.warns(RuntimeWarning, match="power-of-two"):
            assert spec.resolve(3).algorithm == "ring"


class TestSpecFromLegacy:
    def test_spec_passthrough(self):
        spec = CollectiveSpec(backend="user", chunks=3)
        assert spec_from_legacy(spec, surface="T") is spec

    def test_legacy_kwargs_warn_once_per_surface(self):
        with pytest.warns(DeprecationWarning, match="deprecated"):
            got = spec_from_legacy(None, surface="T", backend="user",
                                   chunks=2)
        assert got == CollectiveSpec(backend="user", chunks=2)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            spec_from_legacy(None, surface="T", backend="native")
        with pytest.warns(DeprecationWarning):
            spec_from_legacy(None, surface="U", chunks=4)

    def test_no_legacy_no_warning(self):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert spec_from_legacy(None, surface="T") == CollectiveSpec()

    def test_mixing_spec_and_legacy_raises(self):
        with pytest.raises(ValueError, match="not both"):
            spec_from_legacy(CollectiveSpec(), surface="T", chunks=2)

    def test_default_base(self):
        base = CollectiveSpec(chunks=4, round_batch=0)
        assert spec_from_legacy(None, surface="T", default=base) is base
        with pytest.warns(DeprecationWarning):
            got = spec_from_legacy(None, surface="T", backend="user",
                                   default=base)
        assert got == CollectiveSpec(backend="user", chunks=4,
                                     round_batch=0)


class TestSurfaces:
    def test_train_loop_config_accepts_spec(self):
        from repro_torch.train.train_loop import TrainLoopConfig
        spec = CollectiveSpec(backend="user", chunks=2)
        cfg = TrainLoopConfig(total_steps=1, collective_spec=spec)
        assert cfg.collective_spec is spec
        assert cfg.collective_backend == "user"
        assert cfg.collective_chunks == 2

    def test_train_loop_config_legacy_warns_once(self):
        from repro_torch.train.train_loop import TrainLoopConfig
        with pytest.warns(DeprecationWarning):
            cfg = TrainLoopConfig(total_steps=1, collective_backend="user")
        assert cfg.collective_spec.user
        assert cfg.collective_spec.chunks == 4      # the loop's default
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            TrainLoopConfig(total_steps=1, collective_backend="native")

    def test_train_loop_config_matches_jax_default(self):
        from repro.train.train_loop import TrainLoopConfig as JaxLoop
        from repro_torch.train.train_loop import TrainLoopConfig
        a, b = TrainLoopConfig().collective_spec, JaxLoop().collective_spec
        assert (a.backend, a.algorithm, a.chunks, a.round_batch) == \
            (b.backend, b.algorithm, b.chunks, b.round_batch)

    def test_train_loop_config_conflict_raises(self):
        from repro_torch.train.train_loop import TrainLoopConfig
        with pytest.raises(ValueError, match="conflicts"):
            TrainLoopConfig(total_steps=1,
                            collective_spec=CollectiveSpec(backend="user"),
                            collective_backend="native")

    def test_train_loop_config_replace_roundtrip(self):
        import dataclasses

        from repro_torch.train.train_loop import TrainLoopConfig
        cfg = TrainLoopConfig(total_steps=2,
                              collective_spec=CollectiveSpec(chunks=2))
        cfg2 = dataclasses.replace(cfg, total_steps=5)
        assert cfg2.collective_spec == cfg.collective_spec

    def test_step_records_reject_non_spec(self):
        from repro_torch.train.train_loop import FsdpStep, UserCollectiveStep
        with pytest.raises(TypeError, match="CollectiveSpec"):
            UserCollectiveStep(lambda: 0, lambda: 0, None, spec="user")
        with pytest.raises(TypeError, match="CollectiveSpec"):
            FsdpStep(lambda: 0, lambda: 0, None, spec="user")


def test_collectives_import_surface_mirrors_jax():
    import repro.collectives as J
    import repro_torch.collectives as C
    assert set(C.__all__) == set(J.__all__)
    for name in C.__all__:
        assert getattr(C, name) is not None, name
    assert C.CollectiveSpec is CollectiveSpec
    assert C.S is __import__("repro_torch.collectives.schedules",
                             fromlist=["x"])


def test_factories_accept_spec_kwarg():
    import inspect

    import repro_torch.collectives as C
    for fac in (C.iallreduce, C.ireduce_scatter, C.iallgather,
                C.ialltoall, C.allreduce_init, C.reduce_scatter_init,
                C.allgather_init, C.alltoall_init, C.channel_init,
                C.send_init, C.recv_init):
        params = inspect.signature(fac).parameters
        assert "spec" in params, fac.__name__
        assert params["spec"].kind is inspect.Parameter.KEYWORD_ONLY
    for fac in (C.allreduce_init, C.reduce_scatter_init,
                C.allgather_init, C.alltoall_init, C.channel_init,
                C.send_init, C.recv_init):
        params = inspect.signature(fac).parameters
        for kw in ("epoch", "stream", "engine"):
            assert kw in params, (fac.__name__, kw)
