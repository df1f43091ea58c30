"""Task classes (paper §4.3): one poll hook progresses a whole queue.

Polling N independent tasks costs O(N) per progress call (paper Fig 7).
When tasks complete in order (streams / linear dependency chains), a
single registered poll function that only inspects the queue head keeps
the progress cost O(1) (paper Fig 10).  ``TaskQueue`` is that pattern;
``TaskGraph`` generalizes it to DAG dependencies, polling only *ready*
tasks.
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Optional

from repro_torch.core.engine import DONE, NOPROGRESS, AsyncThing, ProgressEngine, Stream
from repro_torch.core.request import Request


class TaskQueue:
    """In-order task class: one poll_fn checks only the queue head.

    ``submit(ready_fn, on_complete)`` returns a Request.  ``ready_fn()``
    -> bool decides completion of the head task.
    """

    def __init__(self, engine: ProgressEngine, stream: Optional[Stream] = None,
                 name: str = "taskq"):
        self.engine = engine
        self.stream = stream
        self.name = name
        self._q: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._registered = False

    def submit(self, ready_fn: Callable[[], bool],
               on_complete: Callable[[], Any] | None = None) -> Request:
        req = Request(tag=self.name)
        with self._lock:
            self._q.append((ready_fn, on_complete, req))
            if not self._registered:
                self._registered = True
                self.engine.async_start(self._poll, None, self.stream)
        return req

    def _poll(self, thing: AsyncThing) -> str:
        # only the head is inspected: O(1) per progress call
        while True:
            with self._lock:
                if not self._q:
                    self._registered = False
                    return DONE
                ready_fn, on_complete, req = self._q[0]
            if not ready_fn():
                return NOPROGRESS
            value = on_complete() if on_complete is not None else None
            req.complete(value)
            with self._lock:
                self._q.popleft()

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._q)


class TaskGraph:
    """DAG task class: tasks poll only once their dependencies completed.

    The paper notes general-purpose dependency tracking belongs in the
    application's poll_fn, not the MPI library — this is that layer.
    A dependency that *fails* (``Request.fail``) fails its dependents
    with the same exception, transitively, without starting them.
    """

    def __init__(self, engine: ProgressEngine, stream: Optional[Stream] = None):
        self.engine = engine
        self.stream = stream
        self._lock = threading.Lock()
        self._tasks: dict[int, dict] = {}
        self._next_id = 0
        self._registered = False

    def add(self, ready_fn: Callable[[], bool],
            deps: list[Request] | None = None,
            on_complete: Callable[[], Any] | None = None,
            start_fn: Callable[[], None] | None = None) -> Request:
        """start_fn runs once when all deps are complete (task launch);
        ready_fn polls completion afterwards."""
        req = Request(tag="graph")
        with self._lock:
            tid = self._next_id
            self._next_id += 1
            self._tasks[tid] = {
                "ready": ready_fn, "deps": list(deps or ()),
                "done_cb": on_complete, "start": start_fn,
                "started": False, "req": req,
            }
            if not self._registered:
                self._registered = True
                self.engine.async_start(self._poll, None, self.stream)
        return req

    def _poll(self, thing: AsyncThing) -> str:
        with self._lock:
            items = list(self._tasks.items())
        finished = []
        for tid, t in items:
            failed_dep = next((d for d in t["deps"] if d.failed), None)
            if failed_dep is not None:
                # failure propagation: a failed dependency fails this task
                # (transitively — our request now reads as failed to ours'
                # dependents on the next sweep) without ever starting it
                t["req"].fail(failed_dep.exception)
                finished.append(tid)
                continue
            if any(not d.is_complete for d in t["deps"]):
                continue                      # dependencies pending: skip poll
            if not t["started"]:
                if t["start"] is not None:
                    t["start"]()
                t["started"] = True
            if t["ready"]():
                value = t["done_cb"]() if t["done_cb"] is not None else None
                t["req"].complete(value)
                finished.append(tid)
        if finished:
            with self._lock:
                for tid in finished:
                    self._tasks.pop(tid, None)
        with self._lock:
            if not self._tasks:
                self._registered = False
                return DONE
        return NOPROGRESS

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._tasks)
