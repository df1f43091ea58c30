"""Progress statistics (paper §4.1/§4.4 instrumentation).

The paper's evaluation is built on three observables: progress *latency*
(benchmarks/_util.py measures that), lock *contention* between threads
sharing a serial context (Fig 9 vs Fig 11), and wasted *idle spins* —
sweeps that polled tasks but completed nothing.  This module snapshots
those counters from streams, subsystems and executor workers into plain
dataclasses so tests and benchmarks can assert on them (e.g. "two
workers on disjoint streams ⇒ zero cross-stream contention").

Counters are incremented without locks on the hot path: every mutation
happens either under the stream's serial-context lock or from the single
thread polling a subsystem, so plain ``+= 1`` is race-free in the same
way the paper's per-stream state is.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:  # pragma: no cover - import cycle guard
    from repro_torch.core.engine import ProgressEngine
    from repro_torch.core.executor import ProgressExecutor


@dataclasses.dataclass
class StreamStats:
    name: str
    polls: int              # task poll_fn invocations
    completions: int        # tasks that returned DONE
    contention: int         # _poll_once found the serial lock held
    idle_spins: int         # sweeps that polled ≥1 task, completed 0
    task_errors: int        # poll_fns that raised (task dropped)
    pending: int


@dataclasses.dataclass
class SubsystemStats:
    name: str
    polls: int
    progressed: int         # polls that returned True
    errors: int             # polls that raised (subsystem unregistered)
    cheap: bool
    priority: int


@dataclasses.dataclass
class WorkerStats:
    index: int
    sweeps: int             # full passes over the worker's streams
    idle_spins: int         # sweeps with zero completions
    steals: int             # streams taken from another worker
    streams: list[str] = dataclasses.field(default_factory=list)
    drained: int = 0        # continuations executed between polls


@dataclasses.dataclass
class ContinuationStats:
    name: str
    policy: str             # "inline" | "deferred"
    enqueued: int           # continuations attached
    executed: int           # continuations run (success or failure path)
    deferred: int           # continuations routed through the ready list
    failed: int             # failure-path runs + callbacks that raised
    cancelled: int          # dropped unfired by close()
    pending: int            # attached, request not yet complete
    ready: int              # awaiting a drain


@dataclasses.dataclass
class SchedulerStats:
    """Continuous-batching scheduler counters (paged serve engine).

    ``admitted`` counts admissions *including re-admissions* of preempted
    requests, so ``admitted - preemptions`` is the number of distinct
    residencies that ran to completion/failure.  ``prefill_calls`` is the
    number of fused chunked-prefill dispatches (each feeds every
    mid-prefill lane one token) — the interleaving knob's observable."""
    admitted: int = 0          # (re-)admissions into a lane
    preemptions: int = 0       # evictions under block pressure
    prefill_calls: int = 0     # fused chunked-prefill dispatches
    peak_resident: int = 0     # max lanes occupied at once
    peak_backlog: int = 0      # max requests waiting for lanes/blocks

    def format(self) -> str:
        return (f"scheduler: {self.admitted} admitted "
                f"({self.preemptions} preemptions), "
                f"{self.prefill_calls} prefill chunks; peaks: "
                f"{self.peak_resident} resident, "
                f"{self.peak_backlog} backlogged")


@dataclasses.dataclass
class EngineStats:
    streams: list[StreamStats]
    subsystems: list[SubsystemStats]
    workers: list[WorkerStats]
    continuations: list[ContinuationStats] = dataclasses.field(
        default_factory=list)

    def stream(self, name: str) -> StreamStats:
        for s in self.streams:
            if s.name == name:
                return s
        raise KeyError(name)

    def subsystem(self, name: str) -> SubsystemStats:
        for s in self.subsystems:
            if s.name == name:
                return s
        raise KeyError(name)

    def continuation_queue(self, name: str) -> ContinuationStats:
        for c in self.continuations:
            if c.name == name:
                return c
        raise KeyError(name)

    @property
    def total_contention(self) -> int:
        return sum(s.contention for s in self.streams)

    @property
    def total_steals(self) -> int:
        return sum(w.steals for w in self.workers)


def collect(engine: "ProgressEngine",
            executor: Optional["ProgressExecutor"] = None) -> EngineStats:
    """Snapshot every counter the engine (and optional executor) keeps."""
    with engine._lock:
        streams = list(engine._streams)
        subsystems = list(engine._subsystems)
    queues = list(getattr(engine, "continuation_queues", ()))
    if executor is None:
        executor = getattr(engine, "_executor", None)
    stream_stats = [
        StreamStats(s.name, s.polls, s.completions, s.contention,
                    s.idle_spins, len(s.task_errors), s.pending)
        for s in streams
    ]
    sub_stats = [
        SubsystemStats(s.name, s.polls, s.progressed, s.errors,
                       s.cheap, s.priority)
        for s in subsystems
    ]
    worker_stats = []
    if executor is not None:
        worker_stats = executor.worker_stats()
    cont_stats = [
        ContinuationStats(q.name, q.policy, q.enqueued, q.executed,
                          q.deferred, q.failed, q.cancelled,
                          q.pending, q.ready)
        for q in queues
    ]
    return EngineStats(stream_stats, sub_stats, worker_stats, cont_stats)


def format_stats(stats: EngineStats) -> str:
    """Human-readable table (benchmarks / --verbose launchers)."""
    lines = ["stream             polls  compl  contend  idle  errs  pending"]
    for s in stats.streams:
        lines.append(f"{s.name:<18} {s.polls:>5}  {s.completions:>5}  "
                     f"{s.contention:>7}  {s.idle_spins:>4}  "
                     f"{s.task_errors:>4}  {s.pending:>7}")
    if stats.subsystems:
        lines.append("subsystem          polls  progressed  errors")
        for s in stats.subsystems:
            lines.append(f"{s.name:<18} {s.polls:>5}  {s.progressed:>10}  "
                         f"{s.errors:>6}")
    if stats.workers:
        lines.append("worker  sweeps  idle  steals  drained  streams")
        for w in stats.workers:
            lines.append(f"w{w.index:<5} {w.sweeps:>7}  {w.idle_spins:>4}  "
                         f"{w.steals:>6}  {w.drained:>7}  "
                         f"{','.join(w.streams)}")
    if stats.continuations:
        lines.append("cont-queue         policy    enq  exec  defer  fail  "
                     "cancel  pend  ready")
        for c in stats.continuations:
            lines.append(f"{c.name:<18} {c.policy:<8} {c.enqueued:>4}  "
                         f"{c.executed:>4}  {c.deferred:>5}  {c.failed:>4}  "
                         f"{c.cancelled:>6}  {c.pending:>4}  {c.ready:>5}")
    return "\n".join(lines)
