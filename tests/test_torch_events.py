"""The port's ``core.events`` (``CompletionWatcher``, ``EventQueue``) and
``core.task_class`` (``TaskQueue``, ``TaskGraph``) against the JAX
package's: each scenario of tests/test_events_extra.py and of the task
and event classes of tests/test_engine.py runs on both packages, and the
two traces (callback order, completion states, poll counts, drain
results, failures) must be equal, and equal to what the scenario
expects."""
import pytest

import repro.core as jax_core
import repro_torch.core as torch_core


def watcher_reentrant(c):
    eng = c.ProgressEngine()
    w = c.CompletionWatcher(eng)
    fired = []
    first, second = c.Request(tag="first"), c.Request(tag="second")

    def on_first(req):
        fired.append(req.tag)
        w.watch(second, lambda r: fired.append(r.tag))   # re-entrant

    w.watch(first, on_first)
    first.complete()
    eng.progress()
    trace = [list(fired), w.pending]
    second.complete()
    eng.progress()
    trace += [list(fired), w.pending]
    eng.progress()
    return trace + [eng.default_stream.pending]


def watcher_chain(c):
    eng = c.ProgressEngine()
    w = c.CompletionWatcher(eng)
    order = []
    reqs = [c.Request(tag=f"r{i}") for i in range(3)]

    def chained(i):
        def cb(req):
            order.append(req.tag)
            if i + 1 < len(reqs):
                w.watch(reqs[i + 1], chained(i + 1))
                reqs[i + 1].complete()
        return cb

    w.watch(reqs[0], chained(0))
    reqs[0].complete()
    trace = []
    for _ in range(4):
        eng.progress()
        trace.append(list(order))
    return trace


def watcher_query_loop(c):
    eng = c.ProgressEngine()
    w = c.CompletionWatcher(eng)
    fired = []
    reqs = [c.Request(tag=f"q{i}") for i in range(3)]
    for r in reqs:
        w.watch(r, lambda rr: fired.append(rr.tag))
    eng.progress()
    trace = [list(fired)]
    reqs[1].complete()
    eng.progress()
    trace.append(list(fired))
    for r in (reqs[2], reqs[0]):
        r.complete()
    eng.progress()
    return trace + [sorted(fired), w.pending]


def event_queue_bounds(c):
    evq = c.EventQueue()
    for i in range(10):
        evq.emit(i)
    trace = [evq.drain(max_events=3), len(evq), evq.drain(max_events=0),
             evq.drain(max_events=100), evq.drain(max_events=5), len(evq)]
    for i in range(4):
        evq.emit(i)
    return trace + [evq.drain()]


def event_queue_from_hook(c):
    eng = c.ProgressEngine()
    evq = c.EventQueue()
    eng.async_start(lambda t: (evq.emit("ev"), c.DONE)[1])
    eng.progress()
    return [len(evq), evq.drain(), len(evq)]


def graph_dep_fail(c):
    eng = c.ProgressEngine()
    g = c.TaskGraph(eng)
    started = []
    dep = c.Request()
    r = g.add(lambda: True, deps=[dep], start_fn=lambda: started.append("x"))
    eng.progress()
    trace = [r.is_complete]
    boom = ValueError("upstream exploded")
    dep.fail(boom)
    eng.progress()
    return trace + [r.is_complete, r.failed, list(started),
                    r.exception is boom, str(r.exception), g.pending]


def graph_transitive_fail(c):
    eng = c.ProgressEngine()
    g = c.TaskGraph(eng)
    gate = c.Request()
    ra = g.add(lambda: True, deps=[gate])
    rb = g.add(lambda: True, deps=[ra])
    rc = g.add(lambda: True, deps=[rb])
    eng.progress()
    trace = [[r.is_complete for r in (ra, rb, rc)]]
    gate.fail(RuntimeError("root cause"))
    for _ in range(3):                        # one hop per sweep
        eng.progress()
        trace.append([r.failed for r in (ra, rb, rc)])
    return trace + [str(rc.exception)]


def graph_sibling(c):
    eng = c.ProgressEngine()
    g = c.TaskGraph(eng)
    bad_dep, good_dep = c.Request(), c.Request()
    r_bad = g.add(lambda: True, deps=[bad_dep])
    r_good = g.add(lambda: True, deps=[good_dep], on_complete=lambda: "ok")
    bad_dep.fail(RuntimeError("nope"))
    good_dep.complete()
    eng.progress()
    eng.progress()
    return [r_bad.failed, r_good.is_complete, r_good.value()]


def graph_dependencies(c):
    eng = c.ProgressEngine()
    g = c.TaskGraph(eng)
    started = []
    r1 = g.add(lambda: True, start_fn=lambda: started.append("a"))
    r2 = g.add(lambda: True, deps=[r1], start_fn=lambda: started.append("b"))
    eng.progress()
    trace = [r1.is_complete, r2.is_complete]
    eng.progress()
    return trace + [r2.is_complete, list(started)]


def graph_blocked_not_polled(c):
    eng = c.ProgressEngine()
    g = c.TaskGraph(eng)
    polls = []
    gate = c.Request()
    g.add(lambda: (polls.append(1), True)[1], deps=[gate])
    eng.progress()
    trace = [list(polls)]
    gate.complete()
    eng.progress()
    return trace + [list(polls)]


def graph_diamond(c):
    """a -> (b, c) -> d, each ready one sweep after it is polled first."""
    eng = c.ProgressEngine()
    g = c.TaskGraph(eng)
    polls = {k: 0 for k in "abcd"}

    def ready(k):
        def fn():
            polls[k] += 1
            return polls[k] >= 2
        return fn

    a = g.add(ready("a"), on_complete=lambda: "a")
    b = g.add(ready("b"), deps=[a], on_complete=lambda: "b")
    cc = g.add(ready("c"), deps=[a], on_complete=lambda: "c")
    d = g.add(ready("d"), deps=[b, cc], on_complete=lambda: "d")
    trace = []
    for _ in range(7):
        eng.progress()
        trace.append(([r.is_complete for r in (a, b, cc, d)], dict(polls),
                      g.pending))
    return trace + [d.value()]


def queue_head_only(c):
    eng = c.ProgressEngine()
    q = c.TaskQueue(eng)
    counts = [0] * 5
    ready = {"upto": 0}

    def mk(i):
        def ready_fn():
            counts[i] += 1
            return i < ready["upto"]
        return ready_fn

    reqs = [q.submit(mk(i)) for i in range(5)]
    for _ in range(4):
        eng.progress()
    trace = [list(counts)]
    ready["upto"] = 3
    eng.progress()
    trace += [[r.is_complete for r in reqs], list(counts)]
    ready["upto"] = 5
    eng.progress()
    return trace + [[r.is_complete for r in reqs], q.pending]


def queue_in_order(c):
    eng = c.ProgressEngine()
    q = c.TaskQueue(eng)
    ready = {"k": 0}
    reqs = [q.submit(lambda i=i: ready["k"] > i) for i in range(5)]
    eng.progress()
    trace = [[r.is_complete for r in reqs]]
    ready["k"] = 3
    eng.progress()
    trace.append([r.is_complete for r in reqs])
    ready["k"] = 5
    eng.progress()
    return trace + [[r.is_complete for r in reqs], q.pending]


SCENARIOS = {
    "watcher_reentrant": (watcher_reentrant, [
        ["first"], 1, ["first", "second"], 0, 0]),
    "watcher_chain": (watcher_chain, None),
    "watcher_query_loop": (watcher_query_loop, [
        [], ["q1"], ["q0", "q1", "q2"], 0]),
    "event_queue_bounds": (event_queue_bounds, [
        [0, 1, 2], 7, [], list(range(3, 10)), [], 0, [0, 1, 2, 3]]),
    "event_queue_from_hook": (event_queue_from_hook, [1, ["ev"], 0]),
    "graph_dep_fail": (graph_dep_fail, [
        False, True, True, [], True, "upstream exploded", 0]),
    "graph_transitive_fail": (graph_transitive_fail, None),
    "graph_sibling": (graph_sibling, [True, True, "ok"]),
    # a dependent whose dependency completed earlier in the same sweep
    # starts and completes in that sweep
    "graph_dependencies": (graph_dependencies, [
        True, True, True, ["a", "b"]]),
    "graph_blocked_not_polled": (graph_blocked_not_polled, [[], [1]]),
    "graph_diamond": (graph_diamond, None),
    "queue_head_only": (queue_head_only, [
        [4, 0, 0, 0, 0], [True] * 3 + [False] * 2, [5, 1, 1, 1, 0],
        [True] * 5, 0]),
    "queue_in_order": (queue_in_order, [
        [False] * 5, [True] * 3 + [False] * 2, [True] * 5, 0]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name):
    scenario, expected = SCENARIOS[name]
    got = scenario(torch_core)
    assert got == scenario(jax_core)
    if expected is not None:
        assert got == expected


def test_chain_and_transitive_failure_and_diamond_traces():
    """The three scenarios whose traces are long, held to what they must
    show on the port: the chain fires in order, a failure moves one hop a
    sweep, and the diamond completes a, then b and c, then d."""
    assert watcher_chain(torch_core)[-1] == ["r0", "r1", "r2"]
    hops = graph_transitive_fail(torch_core)
    assert hops[0] == [False, False, False]
    assert hops[-2] == [True, True, True] and hops[-1] == "root cause"
    diamond = graph_diamond(torch_core)
    done = [t[0] for t in diamond[:-1]]
    assert done[-1] == [True] * 4 and diamond[-1] == "d"
    first = {k: next(i for i, t in enumerate(done) if t[j])
             for j, k in enumerate("abcd")}
    assert first["a"] < first["b"] == first["c"] < first["d"]


def test_exports_match_jax():
    for name in ("TaskGraph", "TaskQueue", "CompletionWatcher", "EventQueue"):
        assert name in torch_core.__all__ and name in jax_core.__all__
        assert getattr(torch_core, name).__module__.startswith("repro_torch.")
