"""Request-completion events (paper §4.5, Listing 1.6).

The MPIX Async interface has no native callbacks; the paper shows the
"poor man's" version — a progress hook that sweeps registered requests
with ``MPIX_Request_is_complete`` and fires callbacks.  Overhead is one
atomic read per pending request per progress call (paper Fig 12), which
is negligible below a few hundred requests.

Heavy handlers should be deferred: ``EventQueue`` collects completion
events inside the hook and lets the application drain them outside the
progress path (the paper's §4.2 recommendation).
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Optional

from repro_torch.core.engine import DONE, NOPROGRESS, ProgressEngine, Stream
from repro_torch.core.request import Request


class CompletionWatcher:
    """Fire ``callback(request)`` when each registered request completes."""

    def __init__(self, engine: ProgressEngine, stream: Optional[Stream] = None):
        self.engine = engine
        self.stream = stream
        self._lock = threading.Lock()
        self._watched: list[tuple[Request, Callable]] = []
        self._registered = False

    def watch(self, request: Request, callback: Callable[[Request], None]) -> None:
        with self._lock:
            self._watched.append((request, callback))
            if not self._registered:
                self._registered = True
                self.engine.async_start(self._poll, None, self.stream)

    def _poll(self, thing) -> str:
        with self._lock:
            watched = list(self._watched)
        fired = []
        for req, cb in watched:
            if req.is_complete:               # the Fig-12 query loop
                cb(req)
                fired.append((req, cb))
        if fired:
            with self._lock:
                for item in fired:
                    self._watched.remove(item)
        with self._lock:
            if not self._watched:
                self._registered = False
                return DONE
        return NOPROGRESS

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._watched)


class EventQueue:
    """Deferred event delivery: hooks enqueue, application drains.

    Keeps poll functions lightweight (paper §4.2: 'enqueue events and
    postpone the heavy work outside of the progress callbacks')."""

    def __init__(self):
        self._q: collections.deque = collections.deque()
        self._lock = threading.Lock()

    def emit(self, event: Any) -> None:
        with self._lock:
            self._q.append(event)

    def drain(self, max_events: int | None = None) -> list:
        out = []
        with self._lock:
            while self._q and (max_events is None or len(out) < max_events):
                out.append(self._q.popleft())
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)
