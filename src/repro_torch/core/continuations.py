"""MPI Continuations on the progress engine (paper §4.6 direction).

*Callback-based Completion Notification using MPI Continuations*
(Schuchart et al.) attaches callbacks to requests so completion *pushes*
into the application instead of being pulled by wait/test loops; the
MPICH-extensions prototyping work (Zhou et al.) folds the same idea into
the stream/progress machinery this repo reproduces.  This module is that
layer for ``repro_torch.core``: a ``ContinuationQueue`` watches requests from
one poll hook (task-class style, one sweep per progress call) and runs
the attached continuation exactly once per request, under one of the two
execution policies both papers distinguish:

* ``INLINE``   — the continuation executes on the progress thread, inside
  the sweep that observed completion (lowest latency; the callback must
  be lightweight, it runs in the progress path);
* ``DEFERRED`` — completion only moves the continuation to a *ready*
  list; the queue's owner drains it outside the progress path
  (``drain(max_items)`` gives bounded-drain backpressure).  A
  ``ProgressExecutor`` can adopt a deferred queue so its workers drain
  between polls (§4.4 composition).

Failure continuations are first-class: a request that completed via
``Request.fail`` routes to ``on_error`` (falling back to the normal
callback, which can inspect ``request.failed``/``request.exception``).
``then``/``when_all``/``when_any``/``node`` chain continuations so DAG
dependencies (TaskGraph nodes) become completion-driven instead of
polled.

Exactly-once: a continuation lives in exactly one container (pending →
ready → gone); the move happens under the queue lock and execution only
after removal, so concurrent sweeps/drains can never fire it twice.
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Iterable, Optional

from repro_torch.core import debug
from repro_torch.core.engine import DONE, NOPROGRESS, ProgressEngine, Stream
from repro_torch.core.request import CompletionCounter, PollRequest, Request

INLINE = "inline"
DEFERRED = "deferred"
POLICIES = (INLINE, DEFERRED)


class Continuation:
    """One attached callback. ``request`` may be any request-like object
    exposing ``is_complete`` (and optionally ``failed``) — ``Request``,
    ``PollRequest``, ``CompletionCounter``, a wait-set gate, ..."""

    __slots__ = ("request", "callback", "on_error")

    def __init__(self, request, callback, on_error=None):
        self.request = request
        self.callback = callback
        self.on_error = on_error


class ContinuationQueue:
    """Attach continuations to requests; fire them on completion.

    Registers (lazily) ONE async task on ``stream`` that sweeps pending
    continuations with side-effect-free ``is_complete`` reads — the same
    Fig-12 cost model as ``CompletionWatcher`` — and returns ``DONE``
    whenever nothing is pending, so an idle queue costs the engine
    nothing at all (no perpetual task, no idle spins).

    Counters (snapshotted by ``repro_torch.core.stats``):

    * ``enqueued`` — continuations attached
    * ``executed`` — continuations run (success or failure path)
    * ``deferred`` — continuations that went through the ready list
    * ``failed``   — failure-path executions + callbacks that raised
    """

    def __init__(self, engine: ProgressEngine,
                 stream: Optional[Stream] = None, *,
                 policy: str = DEFERRED, name: str = "cont"):
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, got {policy!r}")
        self.engine = engine
        self.stream = stream
        self.policy = policy
        self.name = name
        self._lock = debug.make_lock("ContinuationQueue._lock")
        self._pending: list[Continuation] = []
        self._ready: collections.deque[Continuation] = collections.deque()
        # thread idents currently inside drain(): a continuation body
        # calling drain() on its own queue would recurse through
        # _execute forever (or deadlock on backpressure) — detect and
        # raise instead
        self._draining: set[int] = set()
        self._registered = False
        self._closed = False
        self.enqueued = 0
        self.executed = 0
        self.deferred = 0
        self.failed = 0
        self.cancelled = 0
        # bounded: a recurring failure on a long-lived queue must not
        # accumulate exception objects (and their frames) forever
        self.callback_errors: collections.deque[BaseException] = \
            collections.deque(maxlen=256)
        engine.continuation_queues.append(self)

    # -- attachment --------------------------------------------------------
    def attach(self, request, callback: Callable[[Any], None],
               on_error: Callable[[Any], None] | None = None) -> Continuation:
        """Fire ``callback(request)`` exactly once when ``request``
        completes; if it completed via ``fail``, fire ``on_error(request)``
        instead (when given).  A request already complete at attach time
        fires immediately (INLINE, on this thread) or on the next drain
        (DEFERRED) — it never gets lost."""
        cont = Continuation(request, callback, on_error)
        run_now = False
        with self._lock:
            if self._closed:
                raise RuntimeError(f"continuation queue {self.name!r} is closed")
            self.enqueued += 1
            if request.is_complete:
                if self.policy == INLINE:
                    run_now = True
                else:
                    self._ready.append(cont)
                    self.deferred += 1
            else:
                self._pending.append(cont)
                if not self._registered:
                    self._registered = True
                    self.engine.async_start(self._poll, None, self.stream)
        if run_now:
            self._execute(cont)
        return cont

    def attach_counter(self, counter: CompletionCounter,
                       callback: Callable[[Any], None],
                       on_error: Callable[[Any], None] | None = None) -> Continuation:
        """Continuation on a wait-set aggregate: fires once when every
        request behind the ``CompletionCounter`` has completed."""
        return self.attach(counter, callback, on_error)

    # -- chaining ----------------------------------------------------------
    def then(self, request, fn: Callable[[Any], Any], *,
             on_error: Callable[[BaseException], Any] | None = None) -> Request:
        """Chain: returns a Request that completes with ``fn(value)`` once
        ``request`` completes.  Failures propagate (the returned request
        fails with the same exception) unless ``on_error`` recovers by
        returning a substitute value; ``fn`` raising fails the result."""
        out = Request(tag="then")

        def _fire(req):
            exc = getattr(req, "exception", None)
            if getattr(req, "failed", False) and exc is not None:
                if on_error is None:
                    out.fail(exc)
                    return
                try:
                    out.complete(on_error(exc))
                except BaseException as e:  # noqa: BLE001
                    out.fail(e)
                return
            try:
                out.complete(fn(req.value()))
            except BaseException as e:  # noqa: BLE001
                out.fail(e)

        self.attach(request, _fire)
        return out

    def when_all(self, requests: Iterable[Request]) -> Request:
        """Request completing with ``[r.value() ...]`` once ALL complete;
        fails with the first (by index) failed request's exception."""
        reqs = list(requests)
        out = Request(tag="when_all")
        if not reqs:
            out.complete([])
            return out
        gate = CompletionCounter(reqs).as_request()

        def _fire(_):
            bad = next((r for r in reqs if r.failed), None)
            if bad is not None:
                out.fail(bad.exception)
            else:
                out.complete([r.value() for r in reqs])

        self.attach(gate, _fire)
        return out

    def when_any(self, requests: Iterable[Request]) -> Request:
        """Request completing with ``(index, request)`` of the first
        completed member (lowest index wins ties, like ``wait_any``)."""
        reqs = list(requests)
        if not reqs:
            raise ValueError("when_any on empty request list")
        out = Request(tag="when_any")
        gate = PollRequest(lambda: any(r.is_complete for r in reqs),
                           tag="when_any_gate")

        def _fire(_):
            i, r = next((i, r) for i, r in enumerate(reqs) if r.is_complete)
            if r.failed:
                out.fail(r.exception)
            else:
                out.complete((i, r))

        self.attach(gate, _fire)
        return out

    def node(self, fn: Callable[..., Any],
             deps: Iterable[Request] = ()) -> Request:
        """A TaskGraph node as a continuation chain: run
        ``fn(*dep_values)`` once every dependency completes.  A failed
        dependency fails the node (transitively, through chains of
        ``node``/``then``) without ever running ``fn`` — the same
        propagation contract as ``TaskGraph``, but completion-driven."""
        deps = list(deps)
        if not deps:
            root = Request(tag="node_root")
            root.complete(())
            return self.then(root, lambda _: fn())
        return self.then(self.when_all(deps), lambda vals: fn(*vals))

    # -- the detection sweep ----------------------------------------------
    def _poll(self, thing) -> str:
        with self._lock:
            fired, still = [], []
            for c in self._pending:           # one O(n) partition, not
                if c.request.is_complete:     # per-item list.remove
                    fired.append(c)
                else:
                    still.append(c)
            if fired:
                self._pending = still
                if self.policy == DEFERRED:
                    self._ready.extend(fired)
                    self.deferred += len(fired)
                    fired = []
            alive = bool(self._pending)
            if not alive:
                self._registered = False
        for c in fired:                      # INLINE: run on this thread
            self._execute(c)
        return NOPROGRESS if alive else DONE

    # -- deferred drain ----------------------------------------------------
    def drain(self, max_items: int | None = None) -> int:
        """Execute up to ``max_items`` ready continuations (all if None)
        on the calling thread.  Bounded drains are the backpressure knob:
        a latency-sensitive owner drains a few per iteration instead of
        being flooded by a completion burst.

        Re-entrancy is an error: a continuation body calling ``drain()``
        on its own queue raises RuntimeError (recorded in
        ``callback_errors`` by the enclosing ``_execute``) instead of
        recursing unboundedly — chain follow-up work with ``then``/
        ``attach`` and let the *outer* drain run it."""
        me = threading.get_ident()
        with self._lock:
            if me in self._draining:
                raise RuntimeError(
                    f"re-entrant drain on continuation queue "
                    f"{self.name!r}: a continuation body called drain() "
                    f"on the queue executing it — attach follow-up work "
                    f"instead of draining inline")
            self._draining.add(me)
        n = 0
        try:
            while max_items is None or n < max_items:
                with self._lock:
                    if not self._ready:
                        break
                    cont = self._ready.popleft()
                self._execute(cont)
                n += 1
        finally:
            with self._lock:
                self._draining.discard(me)
        return n

    def _execute(self, cont: Continuation) -> None:
        req = cont.request
        req_failed = bool(getattr(req, "failed", False))
        fn = cont.on_error if (req_failed and cont.on_error is not None) \
            else cont.callback
        if req_failed:
            self.failed += 1
        try:
            fn(req)
        except BaseException as exc:  # noqa: BLE001
            # a continuation must never wedge the progress path or a
            # drain loop: record, count (once per continuation), continue
            if not req_failed:
                self.failed += 1
            self.callback_errors.append(exc)
        finally:
            self.executed += 1

    # -- introspection / lifecycle ----------------------------------------
    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._pending)

    @property
    def ready(self) -> int:
        with self._lock:
            return len(self._ready)

    def close(self, *, run_ready: bool = True) -> None:
        """Deterministic shutdown: refuse new attachments, run (or drop)
        everything already ready, and cancel pending continuations whose
        requests never completed (counted in ``cancelled``).  The
        detection task notices the empty pending list and retires on the
        next sweep."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self.cancelled += len(self._pending)
            self._pending.clear()
            if not run_ready:
                self.cancelled += len(self._ready)
                self._ready.clear()
        if run_ready:
            self.drain()
        try:
            self.engine.continuation_queues.remove(self)
        except ValueError:
            pass

    def __repr__(self):
        return (f"ContinuationQueue({self.name!r}, policy={self.policy}, "
                f"pending={self.pending}, ready={self.ready})")
