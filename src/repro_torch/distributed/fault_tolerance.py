"""Fault-tolerance monitors — clients of the progress engine (the part of
the JAX package's ``distributed/fault_tolerance.py`` that ``Trainer``
needs; ``HeartbeatMonitor`` and ``monitor_mesh`` wait for the elastic
slice).

* ``StragglerDetector`` — EWMA of step durations; steps slower than
  ``threshold ×`` the EWMA are counted per source so schedulers can
  evict persistent stragglers.  Both ledgers are bounded deques/maps —
  a monitor that lives for a million steps must not grow with them.
* ``StepWatchdog`` — wall-clock bound on a single step, polled by the
  SAME collated progress loop as checkpointing and data (no private
  watchdog thread); firing means the step is presumed hung and a
  restart from checkpoint is requested.  Its membership-epoch argument
  waits for the elastic slice.
"""
from __future__ import annotations

import collections
import time
from typing import Callable

from repro_torch.core.engine import ProgressEngine


class StragglerDetector:
    def __init__(self, threshold: float = 1.5, alpha: float = 0.1,
                 history_maxlen: int = 1024):
        self.threshold = threshold
        self.alpha = alpha
        self.ewma: float | None = None
        # bounded ledgers: the step history is a ring, and the flagged map
        # holds at most `history_maxlen` sources (least-recently-flagged
        # evicted)
        self.history_maxlen = history_maxlen
        self.flagged: "collections.OrderedDict[str, int]" = \
            collections.OrderedDict()
        self.history: "collections.deque[tuple[str, float, bool]]" = \
            collections.deque(maxlen=history_maxlen)

    def record(self, source: str, duration: float) -> bool:
        """Returns True if this step was a straggler."""
        is_straggler = (self.ewma is not None
                        and duration > self.threshold * self.ewma)
        if is_straggler:
            # saturating count, LRU-bounded source set
            count = self.flagged.get(source, 0)
            self.flagged[source] = min(count + 1, self.history_maxlen)
            self.flagged.move_to_end(source)
            while len(self.flagged) > self.history_maxlen:
                self.flagged.popitem(last=False)
        # EWMA excludes outliers so one straggler doesn't poison the mean
        if not is_straggler:
            self.ewma = (duration if self.ewma is None
                         else (1 - self.alpha) * self.ewma + self.alpha * duration)
        self.history.append((source, duration, is_straggler))
        return is_straggler

    def persistent_stragglers(self, min_count: int = 3) -> list[str]:
        return [s for s, n in self.flagged.items() if n >= min_count]


class StepWatchdog:
    def __init__(self, engine: ProgressEngine, limit: float = 300.0,
                 on_hang: Callable[[], None] = None, clock=time.monotonic):
        self.limit = limit
        self.on_hang = on_hang or (lambda: None)
        self.clock = clock
        self._armed_at: float | None = None
        self.fired = 0
        # strict: firing the watchdog (on_hang raising) must abort the
        # run loudly, not be isolated into a silent unregister + hang
        self._sub = engine.register_subsystem(
            "watchdog", self._poll, cheap=True, priority=3, strict=True)

    def arm(self) -> None:
        self._armed_at = self.clock()

    def disarm(self) -> None:
        self._armed_at = None

    def _poll(self) -> bool:
        if self._armed_at is not None and \
                self.clock() - self._armed_at > self.limit:
            # disarm BEFORE the callbacks: firing is one-shot per arm —
            # a poll sweep racing the handler must not refire, and the
            # handler itself may progress the engine (more sweeps)
            self._armed_at = None
            self.fired += 1
            self.on_hang()
            return True
        return False
