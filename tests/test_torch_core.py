"""The port's progress-engine core (``repro_torch.core``): the engine,
request, continuation and executor behaviours that test_engine.py and
test_continuations.py check on the JAX package, plus ``torch_future`` on
CPU tensors.  One scripted scenario also runs through both packages and
must leave identical progress statistics."""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import repro.core as jax_core
import repro_torch.core as core
from repro_torch.core import (
    DEFERRED, DONE, INLINE, NOPROGRESS, CancelledError, CompletionCounter,
    ContinuationQueue, GeneralizedRequest, ProgressEngine, ProgressExecutor,
    Request, chain, debug, io_future, torch_future,
)


def timer_task(duration, req=None, value=None):
    deadline = time.monotonic() + duration

    def poll(thing):
        if time.monotonic() >= deadline:
            if req is not None:
                req.complete(value)
            return DONE
        return NOPROGRESS
    return poll


def spin(eng, pred, timeout=10.0):
    t0 = time.monotonic()
    while not pred():
        eng.progress()
        assert time.monotonic() - t0 < timeout


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

def test_tasks_complete_via_progress_and_drain():
    eng = ProgressEngine()
    reqs = [Request() for _ in range(10)]
    for i, r in enumerate(reqs):
        eng.async_start(timer_task(0.005, r, i))
    eng.drain(timeout=10)
    assert [r.value() for r in reqs] == list(range(10))
    assert eng.default_stream.pending == 0


def test_spawn_is_deferred_and_crosses_streams():
    eng = ProgressEngine()
    other = eng.stream("other")
    seen = []

    def child(thing):
        seen.append(thing.stream.name)
        return DONE

    def parent(thing):
        thing.spawn(child, None)                 # same stream: next sweep
        thing.spawn(child, None, stream=other)   # other stream's task list
        return DONE

    eng.async_start(parent)
    assert eng.progress() == 1 and seen == []    # no recursion in the sweep
    eng.progress()
    eng.progress(other)
    assert sorted(seen) == ["default", "other"]


def test_subsystems_collate_short_circuit_and_isolate():
    eng = ProgressEngine()
    calls = []
    eng.register_subsystem("cheap", lambda: calls.append("cheap") or True,
                           cheap=True, priority=0)
    eng.register_subsystem("expensive",
                           lambda: calls.append("expensive") or False,
                           cheap=False, priority=1)
    eng.progress()
    assert calls == ["cheap"]                    # skipped after progress

    def broken():
        raise ValueError("boom")

    eng.register_subsystem("broken", broken, priority=2)
    with pytest.warns(RuntimeWarning):
        eng.poll_subsystems(skip_expensive_on_progress=False)
    assert [name for name, _ in eng.subsystem_errors] == ["broken"]
    eng.poll_subsystems()                        # unregistered: no raise


def test_request_flags_generalized_and_cancel():
    r = Request()
    assert not r.is_complete and r.exception is None
    r.fail(RuntimeError("x"))
    assert r.is_complete and r.failed
    g = GeneralizedRequest(query_fn=lambda st: st * 2, extra_state=21)
    g.complete()
    assert g.value() == 42
    c = GeneralizedRequest()
    c.cancel()
    assert c.cancelled
    with pytest.raises(CancelledError):
        ProgressEngine().wait(c)


def test_wait_family_and_completion_counter():
    eng = ProgressEngine()
    reqs = [Request() for _ in range(3)]
    for r, d in zip(reqs, (0.03, 0.0, 0.015)):
        eng.async_start(timer_task(d, r))
    i, _ = eng.wait_any(reqs, timeout=10)
    assert i == 1
    order = eng.wait_some(reqs, min_count=3, timeout=10)
    assert sorted(order) == [0, 1, 2]
    cc = CompletionCounter(reqs)
    assert cc.remaining == 0 and cc.as_request().is_complete


# ---------------------------------------------------------------------------
# continuations
# ---------------------------------------------------------------------------

def test_inline_fires_once_on_progress_thread():
    eng = ProgressEngine()
    q = ContinuationQueue(eng, policy=INLINE)
    r = Request()
    fired = []
    q.attach(r, lambda req: fired.append(threading.get_ident()))
    eng.progress()
    assert fired == []
    r.complete(1)
    for _ in range(3):
        eng.progress()
    assert fired == [threading.get_ident()]


def test_deferred_drained_by_owner_with_backpressure():
    eng = ProgressEngine()
    q = ContinuationQueue(eng, policy=DEFERRED)
    reqs = [Request() for _ in range(5)]
    fired = []
    for i, r in enumerate(reqs):
        q.attach(r, lambda req, i=i: fired.append(i))
        r.complete()
    eng.progress()
    assert fired == [] and q.ready == 5          # progress only moves them
    assert q.drain(2) == 2 and q.ready == 3
    q.drain()
    assert sorted(fired) == list(range(5))


def test_chaining_then_when_all_when_any_and_errors():
    eng = ProgressEngine()
    q = ContinuationQueue(eng, policy=INLINE)
    r = Request()
    doubled = q.then(r, lambda v: v * 2)
    recovered = q.then(q.then(r, lambda v: 1 / 0), lambda v: v,
                       on_error=lambda exc: "recovered")
    reqs = [Request() for _ in range(3)]
    every = q.when_all(reqs)
    first = q.when_any(reqs)
    r.complete(21)
    reqs[2].complete("c")
    eng.progress()                               # when_any sees "c" first
    reqs[0].complete("a")
    reqs[1].complete("b")
    for _ in range(6):
        eng.progress()
    assert doubled.value() == 42
    assert recovered.value() == "recovered"
    assert every.value() == ["a", "b", "c"]
    assert first.value()[0] == 2


def test_executor_workers_progress_adopted_streams_and_queue():
    eng = ProgressEngine()
    ex = ProgressExecutor(eng, 2)
    s1, s2 = ex.stream("s1"), ex.stream("s2")
    q = ContinuationQueue(eng, s1, policy=DEFERRED)   # detection on s1
    ex.adopt_queue(q)
    done = []
    reqs = [Request() for _ in range(6)]
    for i, r in enumerate(reqs):
        eng.async_start(timer_task(0.002, r, i), stream=(s1, s2)[i % 2])
        q.attach(r, lambda req: done.append(req.value()))
    ex.start()
    try:
        assert eng.wait_all(reqs, timeout=10) == list(range(6))
        ex.drain(timeout=10)
        t0 = time.monotonic()
        while len(done) < 6:
            time.sleep(0.001)
            assert time.monotonic() - t0 < 10
    finally:
        ex.shutdown(drain=True, timeout=10)
    assert sorted(done) == list(range(6))
    assert sum(w.sweeps for w in ex.worker_stats()) > 0


def test_debug_lock_order_checker():
    prev = debug.set_debug(True)
    try:
        graph = debug.LockOrderGraph()
        a = debug.OrderedLock("A", graph)
        b = debug.OrderedLock("B", graph)
        with a, b:
            pass
        with b:
            with pytest.raises(debug.LockOrderError):
                a.acquire()
    finally:
        debug.set_debug(prev)


# ---------------------------------------------------------------------------
# futures
# ---------------------------------------------------------------------------

def test_torch_future_cpu_tensors_ready_at_first_poll():
    eng = ProgressEngine()
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 3))
    seen = []
    req = torch_future(eng, {"y": x * 2, "z": [x]},
                       on_complete=lambda t: seen.append(t["y"]))
    assert not req.is_complete                   # completes on the engine
    assert eng.progress() == 1
    assert req.is_complete and len(seen) == 1
    torch.testing.assert_close(req.value()["y"], x * 2)


def test_io_future_and_chain():
    eng = ProgressEngine()
    io = io_future(eng, lambda: 7)
    ch = chain(eng, [lambda v: v + 1, lambda v: v * 10], initial=1)
    assert eng.wait_all([io, ch], timeout=10) == [7, 20]
    boom = io_future(eng, lambda: 1 / 0)
    spin(eng, lambda: boom.is_complete)
    assert isinstance(boom.exception, ZeroDivisionError)


# ---------------------------------------------------------------------------
# the same script through both packages
# ---------------------------------------------------------------------------

def _scripted(pkg):
    eng = pkg.ProgressEngine()
    s = eng.stream("work")
    q = pkg.ContinuationQueue(eng, s, policy=pkg.DEFERRED, name="cont")
    reqs = [pkg.Request() for _ in range(4)]
    counts = {"n": 0}

    def make(i):
        def poll(thing):
            counts["n"] += 1
            if counts["n"] >= 3 * (i + 1):
                reqs[i].complete(i)
                return pkg.DONE
            return pkg.NOPROGRESS
        return poll

    for i in range(4):
        eng.async_start(make(i), None, s)
        q.attach(reqs[i], lambda r: None)
    eng.register_subsystem("tick", lambda: False, cheap=False)
    for _ in range(12):
        eng.progress(s)
    q.drain()
    snap = dataclasses.asdict(pkg.stats.collect(eng))
    return [r.value() for r in reqs], snap


def test_scripted_scenario_matches_jax_package():
    vals_jax, snap_jax = _scripted(jax_core)
    vals_port, snap_port = _scripted(core)
    assert vals_port == vals_jax == [0, 1, 2, 3]
    assert snap_port == snap_jax
