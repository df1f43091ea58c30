"""Multi-threaded progress executor (paper §4.4, Listing 1.2).

The paper's fix for the MPI_THREAD_MULTIPLE pathology is per-stream
serial contexts: many threads can drive progress concurrently as long as
no two threads poll the *same* stream.  ``ProgressExecutor`` packages
that pattern: it owns N worker threads, each responsible for a disjoint
set of streams, so the serve/train layers share one pool of progress
threads instead of each hand-rolling a ``while: engine.progress()`` loop.

Design points:

* **Ownership, not locking.**  A stream is assigned to exactly one
  worker; workers never poll each other's streams, so the per-stream
  lock is uncontended (Fig 11, not Fig 9).  ``Stream.contention`` stays
  zero unless an outside thread also calls ``engine.progress`` on an
  adopted stream.
* **Work stealing.**  A worker whose streams have all gone idle for
  ``steal_after`` consecutive sweeps takes one stream from the most
  loaded worker — ownership *moves*, preserving the serial-context
  invariant (the steal is an assignment change, never concurrent
  polling).
* **Subsystems on worker 0.**  Registered subsystem hooks (Listing 1.1)
  are polled by exactly one worker, keeping the MPICH short-circuit
  meaningful and sparing hooks from needing thread safety.
* **Finalize semantics** (Listing 1.2): ``drain`` spins until every
  adopted stream — including cross-thread ``_incoming`` backlogs — is
  empty; ``shutdown(drain=True)`` drains first, then joins the workers.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from repro_torch.core import debug
from repro_torch.core.engine import ProgressEngine, Stream
from repro_torch.core.stats import WorkerStats


class _Worker:
    """One progress thread plus the streams it owns."""

    def __init__(self, index: int):
        self.index = index
        self.streams: list[Stream] = []
        self.queues: list = []          # adopted ContinuationQueues
        self.thread: threading.Thread | None = None
        self.thread_ident: int | None = None   # set by the worker loop
        self.sweeps = 0
        self.idle_spins = 0
        self.steals = 0
        self.drained = 0                # continuations executed by this worker
        self.idle_streak = 0


class ProgressExecutor:
    """N worker threads driving progress for assigned streams.

    Usage::

        ex = ProgressExecutor(engine, num_workers=2)
        s1, s2 = ex.stream("a"), ex.stream("b")   # create + adopt
        ex.start()
        ... engine.async_start(poll, None, s1) ...
        ex.shutdown(drain=True)                   # Listing 1.2 finalize

    Also usable as a context manager (``with ProgressExecutor(...)``):
    enter starts the workers, exit drains and shuts down.
    """

    def __init__(self, engine: ProgressEngine, num_workers: int = 2, *,
                 poll_subsystems: bool = True, steal: bool = True,
                 steal_after: int = 16, idle_sleep_s: float = 20e-6,
                 drain_continuations: bool = True,
                 continuation_max_drain: int = 64):
        if num_workers < 1:
            raise ValueError("need at least one worker")
        self.engine = engine
        self.num_workers = num_workers
        self.poll_subsystems = poll_subsystems
        self.steal = steal
        self.steal_after = steal_after
        self.idle_sleep_s = idle_sleep_s
        # adopted ContinuationQueues (deferred policy) are drained by their
        # owning worker between polls, at most continuation_max_drain per
        # sweep — the paper-recommended place to run completion callbacks
        # without a dedicated callback thread (bounded => backpressure)
        self.drain_continuations = drain_continuations
        self.continuation_max_drain = continuation_max_drain
        self._workers = [_Worker(i) for i in range(num_workers)]
        self._assign_lock = debug.make_lock("ProgressExecutor._assign_lock")
        self._stop = threading.Event()
        self._running = False
        self.errors: list[tuple[str, BaseException]] = []

    # -- stream assignment -------------------------------------------------
    def stream(self, name: str = "") -> Stream:
        """Create a new engine stream and adopt it (least-loaded worker)."""
        s = self.engine.stream(name)
        self.adopt(s)
        return s

    def adopt(self, stream: Stream, worker: Optional[int] = None) -> int:
        """Assign ``stream`` to a worker (least-loaded unless given).
        Returns the worker index."""
        with self._assign_lock:
            for w in self._workers:
                if stream in w.streams:
                    raise ValueError(f"{stream.name} already adopted")
            if worker is None:
                w = min(self._workers, key=lambda w: len(w.streams))
            else:
                w = self._workers[worker]
            w.streams.append(stream)
            return w.index

    def release(self, stream: Stream) -> None:
        """Remove ``stream`` from the executor (caller drives it again)."""
        with self._assign_lock:
            for w in self._workers:
                if stream in w.streams:
                    w.streams.remove(stream)
                    return
        raise ValueError(f"{stream.name} not adopted by this executor")

    def streams(self) -> list[Stream]:
        with self._assign_lock:
            return [s for w in self._workers for s in w.streams]

    def owns(self, stream: Stream) -> bool:
        with self._assign_lock:
            return any(stream in w.streams for w in self._workers)

    def worker_thread_idents(self) -> set[int]:
        """Thread idents of the live worker loops.  Lets callers (and
        the executor-driven-start tests) distinguish "dispatched by a
        progress worker" from "dispatched on the caller's thread"."""
        return {w.thread_ident for w in self._workers
                if w.thread_ident is not None}

    # -- continuation-queue assignment -------------------------------------
    def adopt_queue(self, queue, worker: Optional[int] = None) -> int:
        """Assign a (deferred-policy) ContinuationQueue to a worker: that
        worker becomes the queue's owner thread and drains it between
        polls.  Returns the worker index."""
        with self._assign_lock:
            for w in self._workers:
                if queue in w.queues:
                    raise ValueError(f"{queue.name} already adopted")
            if worker is None:
                w = min(self._workers, key=lambda w: len(w.queues))
            else:
                w = self._workers[worker]
            w.queues.append(queue)
            return w.index

    def release_queue(self, queue) -> None:
        with self._assign_lock:
            for w in self._workers:
                if queue in w.queues:
                    w.queues.remove(queue)
                    return
        raise ValueError(f"{queue.name} not adopted by this executor")

    def queues(self) -> list:
        with self._assign_lock:
            return [q for w in self._workers for q in w.queues]

    # -- lifecycle ---------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._running

    def start(self) -> "ProgressExecutor":
        if self._running:
            return self
        self._stop.clear()
        for w in self._workers:
            w.thread = threading.Thread(
                target=self._worker_loop, args=(w,),
                name=f"progress-worker-{w.index}", daemon=True)
        self._running = True
        self.engine.attach_executor(self)
        for w in self._workers:
            w.thread.start()
        return self

    def drain(self, timeout: float | None = None) -> None:
        """Listing 1.2 finalize: block until every adopted stream has zero
        pending tasks (``pending`` includes the cross-thread ``_incoming``
        backlog, so late ``async_start`` calls are absorbed too).

        Works whether or not the workers are running: with workers up, it
        just waits; with workers down, it progresses the streams inline.
        """
        t0 = time.monotonic()
        while True:
            streams = self.streams()
            queues = self.queues()
            if (not any(s.pending for s in streams)
                    and not any(q.ready for q in queues)):
                return
            if self._running:
                if not self.drain_continuations:
                    # workers are not draining queues; the drainer must,
                    # or adopted-queue readiness could never reach zero
                    for q in queues:
                        q.drain()
                time.sleep(self.idle_sleep_s)
            else:
                for s in streams:
                    s._poll_once()
                for q in queues:
                    q.drain()
                if self.poll_subsystems:
                    self.engine.poll_subsystems()
            if timeout is not None and time.monotonic() - t0 > timeout:
                raise TimeoutError(
                    "executor drain timed out; pending: "
                    + "; ".join([f"{s.name}={s.pending}"
                                 for s in streams if s.pending]
                                + [f"{q.name}.ready={q.ready}"
                                   for q in queues if q.ready]))

    def shutdown(self, drain: bool = True,
                 timeout: float | None = None) -> None:
        """Stop the workers (optionally draining first, per Listing 1.2).

        The workers are stopped and the executor detached even when the
        drain times out — a wedged task must not leak spinning threads."""
        try:
            if drain:
                self.drain(timeout)
        finally:
            self._stop.set()
            for w in self._workers:
                if w.thread is not None:
                    w.thread.join(timeout)
                    w.thread = None
            self._running = False
            self.engine.detach_executor(self)

    def __enter__(self) -> "ProgressExecutor":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.shutdown(drain=exc_type is None)

    # -- worker loop -------------------------------------------------------
    def _worker_loop(self, w: _Worker) -> None:
        w.thread_ident = threading.get_ident()
        while not self._stop.is_set():
            with self._assign_lock:
                streams = list(w.streams)
            made = 0
            for s in streams:
                try:
                    made += s._poll_once()
                except BaseException as exc:  # noqa: BLE001
                    # the broken task was already dropped by _poll_once;
                    # record and keep the worker alive — even SystemExit
                    # from a poll_fn must not silently kill the worker
                    # (its streams would starve with no error anywhere)
                    self.errors.append((s.name, exc))
            if w.index == 0 and self.poll_subsystems:
                try:
                    made += self.engine.poll_subsystems()
                except BaseException as exc:  # noqa: BLE001
                    # a strict subsystem re-raises on purpose; on a worker
                    # thread that must not silently kill the thread (its
                    # streams would starve) — record it where callers look
                    self.errors.append(("subsystems", exc))
            if self.drain_continuations:
                with self._assign_lock:
                    queues = list(w.queues)
                for q in queues:
                    n = q.drain(self.continuation_max_drain)
                    made += n
                    w.drained += n
            w.sweeps += 1
            if made:
                w.idle_streak = 0
            else:
                w.idle_spins += 1
                w.idle_streak += 1
                if (self.steal and w.idle_streak >= self.steal_after
                        and self._try_steal(w)):
                    w.steals += 1
                    w.idle_streak = 0
                else:
                    # idle: yield the core instead of burning it
                    time.sleep(self.idle_sleep_s)

    def _try_steal(self, thief: _Worker) -> bool:
        """Move one stream from the most loaded worker to ``thief``.

        Ownership transfer happens under the assignment lock; the victim
        worker snapshots its stream list per sweep, so after this returns
        the stolen stream is polled by exactly one thread (at worst one
        final already-snapshotted sweep overlaps, which the per-stream
        lock makes safe and visible via ``Stream.contention``).
        """
        with self._assign_lock:
            victim = max((v for v in self._workers if v is not thief),
                        key=lambda v: len(v.streams), default=None)
            if victim is None or not victim.streams:
                return False
            # only steal when it improves balance — and never from a
            # single-stream victim: that stream already has a dedicated
            # worker, so moving it just ping-pongs ownership between idle
            # workers (handoff overlap shows up as stream contention)
            if len(victim.streams) < 2 or len(victim.streams) <= len(thief.streams):
                return False
            # prefer a stream with work queued; else take the last one
            stolen = next((s for s in victim.streams if s.pending),
                          victim.streams[-1])
            victim.streams.remove(stolen)
            thief.streams.append(stolen)
            return True

    # -- statistics --------------------------------------------------------
    def worker_stats(self) -> list[WorkerStats]:
        with self._assign_lock:
            return [WorkerStats(w.index, w.sweeps, w.idle_spins, w.steals,
                                [s.name for s in w.streams], w.drained)
                    for w in self._workers]
