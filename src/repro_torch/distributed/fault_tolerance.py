"""Fault-tolerance monitors — clients of the progress engine (the port of
the JAX package's ``distributed/fault_tolerance.py``).

At scale the failure model is: slow ranks (stragglers), hung steps (a
deadlocked collective after a link flap), and dead peers.  The monitors
here are host-side subsystems polled by the SAME collated progress loop
as checkpointing and data (no private watchdog threads):

* ``HeartbeatMonitor`` — every participant beats per step; a peer whose
  beat is older than ``timeout`` is flagged, triggering recovery (driven
  by the trainer).
* ``StragglerDetector`` — EWMA of step durations; steps slower than
  ``threshold ×`` the EWMA are counted per source so schedulers can
  evict persistent stragglers.  Both ledgers are bounded deques/maps —
  a monitor that lives for a million steps must not grow with them.
* ``StepWatchdog`` — wall-clock bound on a single step; firing means the
  step is presumed hung and a restart is requested.
* ``monitor_mesh`` — a ``HeartbeatMonitor`` with one peer per rank of a
  mesh axis, counting the other axes' ranks per peer.

``HeartbeatMonitor`` and ``StepWatchdog`` optionally carry a
``MembershipEpoch`` (``collectives.nonblocking``): a dead peer or a hung
step invalidates the epoch from the monitor's subsystem poll, which
fails in-flight persistent-collective starts with a retryable
``MembershipError`` and marks their handles stale — the trainer observes
the error, rebuilds on the surviving mesh and resumes.  The epoch is
duck-typed (anything with ``invalidate(survivors=, reason=)`` and
``n_devices``) so this module keeps no import edge into the collectives.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Callable

from repro_torch.core.engine import ProgressEngine


class HeartbeatMonitor:
    """``beat()`` is called from worker/request threads; ``_poll`` runs
    on whichever thread sweeps the engine's subsystems (often an
    executor worker).  Both paths take ``_lock``: without it a beat
    landing between ``_poll`` reading the stale timestamp and flagging
    the peer would leave the peer marked failed *forever* (the discard
    ran before the add).  Under the lock, flag-vs-beat is a clean
    ordering: whichever runs second wins, and a flagged peer's next beat
    revives it.  The callbacks (``on_failure``, the epoch's
    ``invalidate``) run after the lock is released."""

    def __init__(self, engine: ProgressEngine, peers: list[str],
                 timeout: float = 60.0, on_failure: Callable[[str], None] = None,
                 clock=time.monotonic, epoch=None, devices_per_peer: int = 1):
        self.timeout = timeout
        self.on_failure = on_failure or (lambda p: None)
        self.failed: set[str] = set()
        self.clock = clock
        self.epoch = epoch
        self.devices_per_peer = devices_per_peer
        self._lock = threading.Lock()
        self.peers = {p: clock() for p in peers}
        self._sub = engine.register_subsystem(
            "heartbeat", self._poll, cheap=True, priority=2)

    def beat(self, peer: str) -> None:
        with self._lock:
            self.peers[peer] = self.clock()
            self.failed.discard(peer)

    def _poll(self) -> bool:
        now = self.clock()
        newly_dead = []
        with self._lock:
            for peer, last in self.peers.items():
                if peer not in self.failed and now - last > self.timeout:
                    self.failed.add(peer)
                    newly_dead.append(peer)
            survivors = len(self.peers) - len(self.failed)
        # callbacks outside the lock: on_failure/invalidate may run
        # arbitrary user code (and a listener calling alive/beat back
        # into this monitor must not deadlock)
        for peer in newly_dead:
            self.on_failure(peer)
        if newly_dead and self.epoch is not None:
            self.epoch.invalidate(
                survivors=survivors * self.devices_per_peer,
                reason=f"heartbeat timeout: {', '.join(newly_dead)}")
        return bool(newly_dead)

    @property
    def alive(self) -> list[str]:
        with self._lock:
            return [p for p in self.peers if p not in self.failed]



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
                 on_hang: Callable[[], None] = None, clock=time.monotonic,
                 epoch=None):
        self.limit = limit
        self.on_hang = on_hang or (lambda: None)
        self.clock = clock
        self.epoch = epoch
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
            if self.epoch is not None:
                # a hung step means the in-flight collective is presumed
                # dead: same membership, but every in-flight start fails
                # retryably so the step can be restarted on fresh plans
                self.epoch.invalidate(
                    survivors=self.epoch.n_devices,
                    reason=f"step watchdog fired after {self.limit}s")
            self.on_hang()
            return True
        return False


def monitor_mesh(engine: ProgressEngine, mesh, axis: str = "data", *,
                 timeout: float, epoch=None, on_failure=None,
                 clock=time.monotonic) -> HeartbeatMonitor:
    """A :class:`HeartbeatMonitor` shaped to a (possibly 2-D) mesh.

    One peer per rank of ``axis``; ``devices_per_peer`` is the product
    of the *other* mesh dims, so losing one data rank on a
    (data=2, model=2) mesh invalidates the epoch with the surviving
    *rank* count (what ``elastic.plan_mesh`` consumes), not the
    surviving peer count.  This is the heartbeat wiring the FSDP
    trainer uses: its persistent reduce-scatter/all-gather handles
    registered under the same ``epoch`` fail exactly once on
    invalidation and rebuild on the survivors' mesh."""
    shape = dict(mesh.shape)
    n = shape.get(axis, 1)
    per = 1
    for name, size in shape.items():
        if name != axis:
            per *= size
    return HeartbeatMonitor(engine, [f"{axis}{i}" for i in range(n)],
                            timeout=timeout, on_failure=on_failure,
                            clock=clock, epoch=epoch,
                            devices_per_peer=per)
