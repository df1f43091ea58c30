"""Requests and generalized requests.

``Request.is_complete`` is the paper's ``MPIX_Request_is_complete``: a
single atomic-flag read with NO side effects — it never invokes progress,
so tasks can poll their dependencies without contending with the progress
engine (paper §3.4).

``GeneralizedRequest`` reproduces MPI generalized requests (§4.6): a
waitable handle whose completion is signalled from inside a poll
function via ``complete()`` (the ``MPI_Grequest_complete`` analogue).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Iterable, Optional


class CancelledError(RuntimeError):
    """Failure a cancelled request completes with (MPI_Cancel semantics):
    ``MPI_Wait`` on a cancelled request must *return*, not spin — here,
    ``engine.wait`` raises this instead of timing out."""


class Request:
    """Completion handle. The flag is a plain attribute — CPython attribute
    loads are atomic, mirroring the paper's 'an atomic read instruction'."""

    __slots__ = ("_complete", "_value", "_exc", "tag")

    def __init__(self, tag: str = ""):
        self._complete = False
        self._value: Any = None
        self._exc: Optional[BaseException] = None
        self.tag = tag

    @property
    def is_complete(self) -> bool:
        """MPIX_Request_is_complete: side-effect free, never progresses."""
        return self._complete

    @property
    def exception(self) -> Optional[BaseException]:
        """The failure, if this request completed via ``fail`` (else None).
        Side-effect free, like ``is_complete`` — dependency trackers use
        it to propagate failures without calling ``value()``."""
        return self._exc

    @property
    def failed(self) -> bool:
        return self._complete and self._exc is not None

    def wait(self, engine, stream=None, timeout: float | None = None) -> Any:
        """Convenience: ``engine.wait(self)`` (MPI_Wait on this handle)."""
        return engine.wait(self, stream=stream, timeout=timeout)

    def complete(self, value: Any = None) -> None:
        self._value = value
        self._complete = True      # publish after value (GIL ordering)

    def fail(self, exc: BaseException) -> None:
        self._exc = exc
        self._complete = True

    def value(self) -> Any:
        if not self._complete:
            raise RuntimeError("request not complete; use engine.wait()")
        if self._exc is not None:
            raise self._exc
        return self._value


class GeneralizedRequest(Request):
    """MPI_Grequest_start analogue: user callbacks + external completion.

    query_fn/free_fn/cancel_fn mirror the MPI interface; like MPI (and as
    the paper critiques), the generalized request has NO progress of its
    own — pair it with ``engine.async_start`` which provides the missing
    progression mechanism (paper §4.6).
    """

    __slots__ = ("query_fn", "free_fn", "cancel_fn", "extra_state", "_cancelled")

    def __init__(self,
                 query_fn: Callable[[Any], Any] | None = None,
                 free_fn: Callable[[Any], None] | None = None,
                 cancel_fn: Callable[[Any, bool], None] | None = None,
                 extra_state: Any = None):
        super().__init__(tag="grequest")
        self.query_fn = query_fn
        self.free_fn = free_fn
        self.cancel_fn = cancel_fn
        self.extra_state = extra_state
        self._cancelled = False

    def complete(self, value: Any = None) -> None:  # MPI_Grequest_complete
        if self._complete:
            # already complete — e.g. cancelled; MPI_Grequest_complete on
            # a cancelled request must not resurrect it as successful
            return
        if self.query_fn is not None:
            value = self.query_fn(self.extra_state)
        super().complete(value)

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    def cancel(self) -> None:
        """MPI_Cancel: inform the callback, then *complete* the request
        (with a ``CancelledError`` failure) if it has not completed yet —
        MPI_Cancel + MPI_Wait semantics: a wait on a cancelled request
        returns instead of spinning until timeout."""
        if self.cancel_fn is not None:
            self.cancel_fn(self.extra_state, self._complete)
        if not self._complete:
            self._cancelled = True
            self.fail(CancelledError(f"grequest {self.tag!r} cancelled"))

    def free(self) -> None:
        if self.free_fn is not None:
            self.free_fn(self.extra_state)


class CompletionCounter:
    """Wait-set aggregate (paper §4.5 / MPI Continuations idiom): counts
    completions across a set of requests with one atomic-read sweep.

    Unlike ``engine.wait_all`` this is a passive observable — task-runtime
    schedulers poll ``remaining`` (one ``is_complete`` read per request,
    the Fig-12 cost model) and release dependents when it hits zero.
    ``as_request()`` adapts the counter back into a waitable ``Request``
    so counters compose with ``wait``/``wait_any``/``TaskGraph`` deps.
    """

    def __init__(self, requests: Iterable["Request"] = ()):
        self._lock = threading.Lock()
        self._reqs: list[Request] = []
        for r in requests:
            self.add(r)

    def add(self, request: "Request") -> "CompletionCounter":
        with self._lock:
            self._reqs.append(request)
        return self

    @property
    def total(self) -> int:
        with self._lock:
            return len(self._reqs)

    @property
    def completed(self) -> int:
        with self._lock:
            reqs = list(self._reqs)
        return sum(1 for r in reqs if r.is_complete)

    @property
    def remaining(self) -> int:
        # one snapshot for both counts: total and completed from separate
        # lock acquisitions could interleave with add() and go negative
        with self._lock:
            reqs = list(self._reqs)
        return sum(1 for r in reqs if not r.is_complete)

    @property
    def is_complete(self) -> bool:
        return self.remaining == 0

    @property
    def failed(self) -> list["Request"]:
        with self._lock:
            reqs = list(self._reqs)
        return [r for r in reqs if r.failed]

    def as_request(self) -> "PollRequest":
        return PollRequest(lambda: self.is_complete, tag="ccounter")


def request_of(fn: Callable[[], bool], tag: str = "") -> "PollRequest":
    return PollRequest(fn, tag)


class PollRequest(Request):
    """Request whose completion is determined by a user predicate."""

    __slots__ = ("_predicate",)

    def __init__(self, predicate: Callable[[], bool], tag: str = ""):
        super().__init__(tag)
        self._predicate = predicate

    @property
    def is_complete(self) -> bool:
        if not self._complete and self._predicate():
            self.complete()
        return self._complete
