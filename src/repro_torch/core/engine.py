"""The collated, interoperable progress engine (paper §2.6, §3).

Paper API                      →  here
---------------------------------------------------------------
MPIX_Stream_create             →  Stream() / engine.stream()
MPIX_Stream_progress(stream)   →  engine.progress(stream)
MPIX_Async_start(fn, st, strm) →  engine.async_start(fn, st, stream)
MPIX_Async_spawn               →  AsyncThing.spawn(...)
MPIX_Async_get_state           →  AsyncThing.state
MPIX_ASYNC_DONE / NOPROGRESS   →  DONE / NOPROGRESS (PENDING alias)
subsystem hooks (Listing 1.1)  →  engine.register_subsystem(...)
MPI_Waitany / MPI_Waitsome     →  engine.wait_any / engine.wait_some
progress threads (§4.4)        →  repro_torch.core.executor.ProgressExecutor
completion counting (§4.5)     →  repro_torch.core.request.CompletionCounter
progress statistics (§4.1)     →  repro_torch.core.stats.collect(engine)

Semantics faithfully kept:

* A Stream is a *serial execution context*: tasks attached to one stream
  are polled by at most one thread at a time (per-stream lock), and two
  different streams NEVER contend on a shared lock — the fix for the
  MPI_THREAD_MULTIPLE global-lock pathology the paper measures (§4.4).
* ``progress`` collates: subsystem hooks run in registration (priority)
  order and, like MPICH's Listing 1.1, later (expensive) subsystems are
  skipped once progress was made (short-circuit), controllable per call.
* A failing subsystem is isolated — unregistered and recorded on
  ``engine.subsystem_errors`` — rather than poisoning every subsequent
  ``progress`` call; pass ``strict=True`` to re-raise instead.
* ``spawn`` from inside a poll_fn defers enqueueing until after the poll
  sweep — no recursion, no queue mutation under iteration (§3.3).
* Poll functions must be lightweight; completion events can be emitted
  via ``repro_torch.core.events`` instead of doing heavy work inline (§4.2).
* The wait family (``wait``/``wait_all``/``wait_any``/``wait_some``)
  drives progress from the calling thread — unless a running
  ``ProgressExecutor`` is attached, in which case callers yield the CPU
  and let the background workers make progress (§4.4 + §4.5).
"""
from __future__ import annotations

import itertools
import threading
import time
import warnings
from typing import Any, Callable, Iterable, Optional

# poll_fn return codes (paper: MPIX_ASYNC_DONE / MPIX_ASYNC_NOPROGRESS)
DONE = "done"
NOPROGRESS = "noprogress"
PENDING = NOPROGRESS  # alias: the paper text uses PENDING in §3.3

# How long a waiting thread sleeps per check when a background executor
# owns progress (keeps waiters off the stream locks entirely).
_WAIT_YIELD_S = 20e-6


class AsyncThing:
    """Opaque handle passed to poll functions (MPIX_Async_thing).

    Combines the user state (``MPIX_Async_get_state``) with the
    implementation-side context, and provides ``spawn`` (MPIX_Async_spawn):
    children are buffered and enqueued only after the current poll sweep,
    avoiding recursion and re-entrant queue mutation.
    """

    __slots__ = ("state", "poll_fn", "stream", "_spawned", "engine")

    def __init__(self, engine: "ProgressEngine", poll_fn, state, stream: "Stream"):
        self.engine = engine
        self.poll_fn = poll_fn
        self.state = state
        self.stream = stream
        self._spawned: list[AsyncThing] = []

    def spawn(self, poll_fn, state, stream: Optional["Stream"] = None) -> "AsyncThing":
        child = AsyncThing(self.engine, poll_fn, state,
                           stream if stream is not None else self.stream)
        self._spawned.append(child)
        return child


class Stream:
    """MPIX_Stream: a serial context with its own task list and lock."""

    _ids = itertools.count()

    def __init__(self, name: str = "", engine: "ProgressEngine" = None):
        self.id = next(Stream._ids)
        self.name = name or f"stream{self.id}"
        self.engine = engine
        self._lock = threading.Lock()
        self._tasks: list[AsyncThing] = []
        self._incoming: list[AsyncThing] = []
        self._incoming_lock = threading.Lock()
        self.polls = 0           # statistics (see repro_torch.core.stats)
        self.completions = 0
        self.contention = 0      # _poll_once found the lock already held
        self.idle_spins = 0      # sweeps that polled tasks, completed none
        self.task_errors: list[BaseException] = []

    def _enqueue(self, thing: AsyncThing) -> None:
        # cross-thread additions land in _incoming; the polling thread
        # absorbs them — keeps the hot poll loop free of contention.
        with self._incoming_lock:
            self._incoming.append(thing)

    @property
    def pending(self) -> int:
        with self._incoming_lock:
            inc = len(self._incoming)
        return len(self._tasks) + inc

    def _poll_once(self) -> int:
        """One collated sweep over this stream's tasks. Returns #completed.

        A poll_fn that raises is dropped from the stream (recorded in
        ``task_errors``) before the exception propagates — a broken task
        must not wedge the serial context by re-raising every sweep.
        """
        if not self._lock.acquire(blocking=False):
            # another thread is progressing this serial context; in the
            # paper's model this cannot happen (streams are serial), but
            # we make it safe rather than corrupt the task list.
            self.contention += 1
            self._lock.acquire()
        try:
            with self._incoming_lock:
                if self._incoming:
                    self._tasks.extend(self._incoming)
                    self._incoming.clear()
            completed = 0
            polled = 0
            spawned: list[AsyncThing] = []
            keep: list[AsyncThing] = []
            try:
                for i, thing in enumerate(self._tasks):
                    self.polls += 1
                    polled += 1
                    try:
                        rc = thing.poll_fn(thing)
                    except BaseException as exc:
                        # drop the broken task, keep the rest intact
                        self.task_errors.append(exc)
                        keep.extend(self._tasks[i + 1:])
                        raise
                    if thing._spawned:
                        spawned.extend(thing._spawned)
                        thing._spawned = []
                    if rc == DONE:
                        completed += 1
                        self.completions += 1
                    else:
                        keep.append(thing)
            finally:
                self._tasks = keep
                # deferred enqueue of spawned children (MPIX_Async_spawn)
                for child in spawned:
                    if child.stream is self:
                        self._tasks.append(child)
                    else:
                        child.stream._enqueue(child)
                if polled and not completed:
                    self.idle_spins += 1
            return completed
        finally:
            self._lock.release()


class Subsystem:
    """A progress hook à la MPICH Listing 1.1 (datatype engine /
    collectives / shmem / netmod).  ``poll`` returns True if progress was
    made.  ``cheap`` subsystems are always polled; expensive ones are
    skipped when an earlier subsystem already made progress.  A
    ``strict`` subsystem raises *on purpose* (watchdogs, exhausted data
    sources): its exceptions re-raise out of ``progress`` instead of
    being swallowed by isolation — else a deliberate crash signal would
    degrade into an infinite wait."""

    def __init__(self, name: str, poll: Callable[[], bool], cheap: bool = True,
                 priority: int = 0, strict: bool = False):
        self.name = name
        self.poll = poll
        self.cheap = cheap
        self.priority = priority
        self.strict = strict
        self.polls = 0           # statistics (see repro_torch.core.stats)
        self.progressed = 0
        self.errors = 0
        self.last_error: BaseException | None = None

    def __repr__(self):
        return f"Subsystem({self.name!r}, cheap={self.cheap})"


class ProgressEngine:
    """One engine per process (the paper's thesis: ONE progress engine
    collating every async subsystem, instead of one thread per library)."""

    def __init__(self):
        self.default_stream = Stream("default", self)   # MPIX_STREAM_NULL
        self._streams: list[Stream] = [self.default_stream]
        self._subsystems: list[Subsystem] = []
        self._lock = threading.Lock()
        # MPICH-style progress critical section: subsystem hooks are never
        # executed by two threads at once (hooks are not required to be
        # thread-safe); contenders skip instead of blocking, so stream
        # polling stays lock-free across threads (§4.4)
        self._sub_poll_lock = threading.Lock()
        self._executor = None          # attached ProgressExecutor, if any
        # (subsystem_name, exception) pairs from isolated failures
        self.subsystem_errors: list[tuple[str, BaseException]] = []
        # live ContinuationQueue objects (self-registered; see
        # repro_torch.core.continuations) — snapshotted by repro_torch.core.stats
        self.continuation_queues: list = []

    # -- streams ---------------------------------------------------------
    def stream(self, name: str = "") -> Stream:
        s = Stream(name, self)
        with self._lock:
            self._streams.append(s)
        return s

    def free_stream(self, stream: Stream) -> None:
        if stream.pending:
            raise RuntimeError(f"{stream.name} has pending tasks")
        with self._lock:
            self._streams.remove(stream)

    # -- MPIX_Async ------------------------------------------------------
    def async_start(self, poll_fn: Callable[[AsyncThing], str],
                    extra_state: Any = None,
                    stream: Optional[Stream] = None) -> AsyncThing:
        s = stream if stream is not None else self.default_stream
        thing = AsyncThing(self, poll_fn, extra_state, s)
        s._enqueue(thing)
        return thing

    # -- subsystems (Listing 1.1) ------------------------------------------
    def register_subsystem(self, name: str, poll: Callable[[], bool],
                           cheap: bool = True, priority: int = 0,
                           strict: bool = False) -> Subsystem:
        sub = Subsystem(name, poll, cheap, priority, strict)
        with self._lock:
            self._subsystems.append(sub)
            self._subsystems.sort(key=lambda x: x.priority)
        return sub

    def unregister_subsystem(self, sub: Subsystem) -> None:
        with self._lock:
            if sub in self._subsystems:
                self._subsystems.remove(sub)

    def poll_subsystems(self, *, progressed: bool = False,
                        skip_expensive_on_progress: bool = True,
                        strict: bool = False) -> int:
        """One pass over the subsystem hooks in priority order.

        A hook that raises is *isolated*: unregistered, the error recorded
        on ``subsystem_errors`` (and the Subsystem itself) with a warning,
        and polling continues — a broken library must not take down global
        progress.  With ``strict=True`` the exception re-raises after
        isolation.

        Hooks run inside a try-lock critical section: if another thread is
        already polling the subsystems this call returns 0 immediately
        (that thread IS making the progress) — hooks never execute
        concurrently, so they need no thread safety of their own.
        """
        if not self._sub_poll_lock.acquire(blocking=False):
            return 0
        try:
            with self._lock:
                subs = list(self._subsystems)
            made = 0
            for sub in subs:
                if ((progressed or made) and skip_expensive_on_progress
                        and not sub.cheap):
                    continue
                sub.polls += 1
                try:
                    if sub.poll():
                        made += 1
                        sub.progressed += 1
                except Exception as exc:
                    sub.errors += 1
                    sub.last_error = exc
                    self.subsystem_errors.append((sub.name, exc))
                    self.unregister_subsystem(sub)
                    if strict or sub.strict:
                        raise
                    warnings.warn(
                        f"progress subsystem {sub.name!r} raised "
                        f"{exc!r}; unregistered (see "
                        f"engine.subsystem_errors)", RuntimeWarning)
            return made
        finally:
            self._sub_poll_lock.release()

    # -- progress ----------------------------------------------------------
    def progress(self, stream: Optional[Stream] = None, *,
                 skip_expensive_on_progress: bool = True,
                 strict: bool = False) -> int:
        """MPIX_Stream_progress.

        Polls (a) the async tasks of ``stream`` (or the default stream)
        and (b) the registered subsystem hooks in priority order with the
        MPICH short-circuit: once progress is made, remaining *expensive*
        subsystems are skipped this round.  Subsystem failures are
        isolated (see ``poll_subsystems``) unless ``strict=True``.
        """
        s = stream if stream is not None else self.default_stream
        made = s._poll_once()
        made += self.poll_subsystems(
            progressed=made > 0,
            skip_expensive_on_progress=skip_expensive_on_progress,
            strict=strict)
        return made

    def progress_all(self, *, strict: bool = False) -> int:
        """Progress every stream (used by shutdown/finalize paths)."""
        made = 0
        with self._lock:
            streams = list(self._streams)
        for s in streams:
            made += s._poll_once()
        made += self.poll_subsystems(skip_expensive_on_progress=False,
                                     strict=strict)
        return made

    # -- executor attachment (§4.4) ----------------------------------------
    def attach_executor(self, executor) -> None:
        """Background ProgressExecutor announces itself: wait loops stop
        self-progressing and yield to the worker threads instead."""
        self._executor = executor

    def detach_executor(self, executor) -> None:
        if self._executor is executor:
            self._executor = None

    @property
    def executor(self):
        return self._executor

    def _advance(self, stream: Optional[Stream]) -> None:
        """One unit of forward motion for a wait loop: drive progress from
        this thread, or — when a running executor owns the target stream —
        just yield so the workers can.

        A stream the executor does NOT own is still progressed inline
        (only the stream, not the subsystems — worker 0 already polls
        those): waiting on an unadopted stream must never deadlock."""
        ex = self._executor
        if ex is not None and ex.running:
            target = stream if stream is not None else self.default_stream
            if ex.owns(target):
                time.sleep(_WAIT_YIELD_S)
            elif ex.poll_subsystems:
                if target._poll_once() == 0:
                    time.sleep(_WAIT_YIELD_S)   # don't burn a core idling
            else:
                self.progress(stream)
        else:
            self.progress(stream)

    # -- waiting -----------------------------------------------------------
    def wait(self, request, stream: Optional[Stream] = None,
             timeout: float | None = None) -> Any:
        """MPI_Wait: drive progress until ``request.is_complete``."""
        t0 = time.monotonic()
        while not request.is_complete:
            self._advance(stream)
            if timeout is not None and time.monotonic() - t0 > timeout:
                raise TimeoutError(f"wait timed out after {timeout}s")
        return request.value()

    def wait_all(self, requests: Iterable, stream: Optional[Stream] = None,
                 timeout: float | None = None) -> list:
        reqs = list(requests)
        t0 = time.monotonic()
        while not all(r.is_complete for r in reqs):
            self._advance(stream)
            if timeout is not None and time.monotonic() - t0 > timeout:
                raise TimeoutError(f"wait_all timed out after {timeout}s")
        return [r.value() for r in reqs]

    def wait_any(self, requests: Iterable, stream: Optional[Stream] = None,
                 timeout: float | None = None) -> tuple[int, Any]:
        """MPI_Waitany: block until *one* request completes.

        Returns ``(index, request)`` of the first request observed
        complete (requests already complete on entry win immediately, in
        list order — MPI's deterministic-tiebreak behaviour).
        """
        reqs = list(requests)
        if not reqs:
            raise ValueError("wait_any on empty request list")
        t0 = time.monotonic()
        while True:
            for i, r in enumerate(reqs):
                if r.is_complete:
                    return i, r
            self._advance(stream)
            if timeout is not None and time.monotonic() - t0 > timeout:
                raise TimeoutError(f"wait_any timed out after {timeout}s")

    def wait_some(self, requests: Iterable, stream: Optional[Stream] = None,
                  min_count: int = 1,
                  timeout: float | None = None) -> list[int]:
        """MPI_Waitsome: block until ≥ ``min_count`` requests complete.

        Returns the indices of *all* requests complete at return time, in
        the order their completion was first observed (so index order
        reflects completion order across progress sweeps, the property
        event-driven consumers rely on).
        """
        reqs = list(requests)
        if min_count > len(reqs):
            raise ValueError(f"min_count={min_count} > {len(reqs)} requests")
        t0 = time.monotonic()
        done_order: list[int] = []
        seen = set()
        while True:
            for i, r in enumerate(reqs):
                if i not in seen and r.is_complete:
                    seen.add(i)
                    done_order.append(i)
            if len(done_order) >= min_count:
                return done_order
            self._advance(stream)
            if timeout is not None and time.monotonic() - t0 > timeout:
                raise TimeoutError(f"wait_some timed out after {timeout}s")

    def drain(self, stream: Optional[Stream] = None,
              timeout: float | None = None) -> None:
        """MPI_Finalize behaviour (Listing 1.2): progress until no pending
        tasks remain on the stream (or all streams if None)."""
        t0 = time.monotonic()
        if stream is not None:
            while stream.pending:
                self.progress(stream)
                if timeout is not None and time.monotonic() - t0 > timeout:
                    raise TimeoutError("drain timed out")
            return
        while True:
            # snapshot under the lock: a task/continuation may free_stream
            # (or stream()) mid-sweep, and iterating the live list would
            # blow up with "list changed size during iteration"
            with self._lock:
                streams = list(self._streams)
            if not any(s.pending for s in streams):
                return
            self.progress_all()
            if timeout is not None and time.monotonic() - t0 > timeout:
                raise TimeoutError("drain timed out")


# Process-global engine (most applications want exactly one).
_global_engine: ProgressEngine | None = None
_global_lock = threading.Lock()


def global_engine() -> ProgressEngine:
    global _global_engine
    if _global_engine is None:
        with _global_lock:
            if _global_engine is None:
                _global_engine = ProgressEngine()
    return _global_engine


def reset_global_engine() -> None:
    global _global_engine
    with _global_lock:
        _global_engine = None
