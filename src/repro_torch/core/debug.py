"""Opt-in runtime invariant checkers for the progress stack (REPRO_DEBUG=1).

The JAX package's static pass (``repro.analysis.progress_lint``) proves progress-safety
rules where call order is visible in a function body; this module is the
runtime half, for the orderings only an execution can exhibit:

* **Lock order** — :func:`make_lock` hands out plain ``threading.Lock``
  in production and an :class:`OrderedLock` under ``REPRO_DEBUG=1``.
  Ordered locks report every acquisition to a process-wide
  :class:`LockOrderGraph` (the DAG of *outer lock -> inner lock* edges,
  per thread); an acquisition that would close a cycle raises
  :class:`LockOrderError` **before** blocking, so an AB/BA inversion is
  caught on first sight without needing the deadlock interleaving to
  actually fire.  The observed DAG can be snapshotted, persisted and
  diffed (:meth:`LockOrderGraph.snapshot`, :func:`diff_order`) so tests
  pin the engine's acquisition order and flag drift.

* **Handle lifecycle** — the MPI persistent-request state machine
  (``*_init -> start -> complete -> (rebuild) -> close``) is declared
  once in :data:`LIFECYCLE_TRANSITIONS` / :data:`LIFECYCLE_VIOLATIONS`
  and enforced twice: statically by the lint (which loads this table)
  and dynamically by :class:`HandleTracker`, a weak-keyed side table of
  per-handle states fed by hooks in ``PersistentCollective``,
  ``P2PChannel`` and ``FsdpReducer``.  Illegal events (double-start,
  start-after-invalidate-without-rebuild, wait-without-start,
  use-after-close) raise :class:`LifecycleError`.

Everything here is stdlib-only and dormant unless ``REPRO_DEBUG`` is set
(or a test flips :func:`set_debug`): ``make_lock`` returns an untouched
``threading.Lock`` and the hook helpers are a single ``if`` on the hot
path, so the production tax is one truthiness check per event.
"""
from __future__ import annotations

import json
import os
import threading
import weakref

_DEBUG = os.environ.get("REPRO_DEBUG", "") not in ("", "0", "false", "False")


def debug_enabled() -> bool:
    return _DEBUG


def set_debug(on: bool) -> bool:
    """Flip the checkers at runtime (tests); returns the previous value.

    Lock instrumentation is chosen at *construction* time — only objects
    built after the flip pick up :class:`OrderedLock`s — while the
    lifecycle hooks consult the flag on every event."""
    global _DEBUG
    prev = _DEBUG
    _DEBUG = bool(on)
    return prev


class LockOrderError(RuntimeError):
    """An acquisition would close a cycle in the lock-order graph."""


class LifecycleError(RuntimeError):
    """A persistent handle received an event its state forbids."""


# ---------------------------------------------------------------------------
# Lock-order graph
# ---------------------------------------------------------------------------

class LockOrderGraph:
    """Process-wide acquisition DAG: edge ``A -> B`` means some thread
    acquired ``B`` while holding ``A``.  Edges accumulate over the whole
    run; a new edge whose reverse path already exists is a potential
    deadlock regardless of whether the two threads ever actually race,
    which is exactly why the check happens *before* blocking."""

    def __init__(self):
        self._mu = threading.Lock()
        self._edges: dict[str, set[str]] = {}
        self._witness: dict[tuple[str, str], int] = {}  # edge -> count
        self._tls = threading.local()

    def _held(self) -> list[str]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _path(self, src: str, dst: str) -> list[str] | None:
        """DFS path src -> dst over recorded edges (caller holds _mu)."""
        stack, seen = [(src, [src])], {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self._edges.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def check(self, name: str) -> None:
        """Record ``held -> name`` edges; raise on cycle formation.

        Runs before the underlying lock blocks: the inversion is
        reported the first time the reversed order is *attempted*, not
        when two threads finally interleave into the deadlock."""
        held = self._held()
        if not held:
            return
        with self._mu:
            for outer in held:
                if outer == name:
                    continue          # re-acquire: the Lock itself deadlocks
                back = self._path(name, outer)
                if back is not None:
                    cycle = " -> ".join([outer] + back)
                    raise LockOrderError(
                        f"lock-order inversion: acquiring {name!r} while "
                        f"holding {outer!r}, but the established order is "
                        f"{cycle} (cycle).  One of the two call paths must "
                        f"release before acquiring, or the order must be "
                        f"made consistent.")
                edge = (outer, name)
                if edge not in self._witness:
                    self._edges.setdefault(outer, set()).add(name)
                self._witness[edge] = self._witness.get(edge, 0) + 1

    def push(self, name: str) -> None:
        self._held().append(name)

    def pop(self, name: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):  # non-LIFO release is legal
            if held[i] == name:
                del held[i]
                return

    # -- persistence / diffing --------------------------------------------
    def snapshot(self) -> dict[str, list[str]]:
        """The observed order as ``{outer: [inner, ...]}``, sorted."""
        with self._mu:
            return {k: sorted(v) for k, v in sorted(self._edges.items())}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()
            self._witness.clear()


def load_order(path: str) -> dict[str, list[str]]:
    with open(path) as f:
        return {k: sorted(v) for k, v in json.load(f).items()}


def diff_order(prev: dict[str, list[str]],
               cur: dict[str, list[str]]) -> dict[str, list[tuple[str, str]]]:
    """Edge-level diff of two snapshots: ``{"added": [...], "removed":
    [...]}`` — tests persist the observed order and fail on drift."""
    def edges(d):
        return {(a, b) for a, bs in d.items() for b in bs}
    p, c = edges(prev), edges(cur)
    return {"added": sorted(c - p), "removed": sorted(p - c)}


LOCK_GRAPH = LockOrderGraph()


class OrderedLock:
    """``threading.Lock`` wrapper reporting to the shared order graph.

    Same interface as ``Lock`` (``acquire``/``release``/context manager/
    ``locked``); the cycle check precedes the blocking acquire."""

    __slots__ = ("name", "_lock", "_graph")

    def __init__(self, name: str, graph: LockOrderGraph | None = None):
        self.name = name
        self._lock = threading.Lock()
        self._graph = graph if graph is not None else LOCK_GRAPH

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._graph.check(self.name)
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._graph.push(self.name)
        return got

    def release(self) -> None:
        self._lock.release()
        self._graph.pop(self.name)

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "OrderedLock":
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.release()

    def __repr__(self):
        return f"OrderedLock({self.name!r}, locked={self.locked()})"


def make_lock(name: str):
    """A hot-path lock: plain ``threading.Lock`` in production, an
    :class:`OrderedLock` on the shared graph under ``REPRO_DEBUG=1``.
    ``name`` should be ``Class._attr`` — order is tracked per *role*,
    not per instance, matching how deadlocks are reasoned about."""
    if _DEBUG:
        return OrderedLock(name)
    return threading.Lock()


# ---------------------------------------------------------------------------
# Handle lifecycle state machine
# ---------------------------------------------------------------------------

IDLE, ACTIVE, STALE, CLOSED = "idle", "active", "stale", "closed"

# The declared machine (MPI persistent-request semantics).  This table is
# the single source of truth: the JAX package's progress lint loads its copy for
# the static pass and HandleTracker enforces it at runtime.
LIFECYCLE_TRANSITIONS: dict[tuple[str, str], str] = {
    (IDLE, "start"): ACTIVE,
    (ACTIVE, "complete"): IDLE,       # wait()/cancel()/fail retired the start
    (ACTIVE, "wait"): IDLE,
    (IDLE, "invalidate"): STALE,
    (ACTIVE, "invalidate"): STALE,    # the in-flight start is failed
    (STALE, "invalidate"): STALE,
    (CLOSED, "invalidate"): CLOSED,   # the epoch may still hold a weakref
    (IDLE, "rebuild"): IDLE,
    (STALE, "rebuild"): IDLE,
    (IDLE, "close"): CLOSED,
    (ACTIVE, "close"): CLOSED,
    (STALE, "close"): CLOSED,
    (CLOSED, "close"): CLOSED,        # close is idempotent
}

# Illegal (state, event) pairs with their canonical names; anything in
# neither table is reported as a generic illegal event.
LIFECYCLE_VIOLATIONS: dict[tuple[str, str], str] = {
    (ACTIVE, "start"): "double-start",
    (STALE, "start"): "start-after-invalidate-without-rebuild",
    (CLOSED, "start"): "use-after-close",
    (CLOSED, "rebuild"): "use-after-close",
    (CLOSED, "wait"): "use-after-close",
    (CLOSED, "cancel"): "use-after-close",
    (ACTIVE, "rebuild"): "rebuild-with-active-start",
    (IDLE, "wait"): "wait-without-start",
    (STALE, "wait"): "wait-without-start",
}


class HandleTracker:
    """Weak-keyed per-handle lifecycle states.

    Handles register on construction (:meth:`track`) and report events
    from their public entry points; an event the declared machine
    forbids raises :class:`LifecycleError`.  The side table is weak so
    tracking never extends a handle's lifetime.

    Completion is observed lazily: nothing pushes an event when a start
    retires on a progress thread, so ``event(..., complete_probe=...)``
    lets an ACTIVE handle settle to IDLE first when the probe confirms
    the tracked start is complete (exactly the restartability rule
    ``PersistentCollective.start`` implements)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._entries: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self.violations = 0

    def track(self, handle, kind: str, state: str = IDLE) -> None:
        with self._mu:
            self._entries[handle] = [state, kind]

    def state(self, handle) -> str | None:
        with self._mu:
            entry = self._entries.get(handle)
            return entry[0] if entry is not None else None

    def event(self, handle, ev: str, *, kind: str = "handle",
              complete_probe=None, racing_invalidate: bool = False) -> str:
        """Apply ``ev`` to ``handle``; returns the new state.

        ``racing_invalidate=True`` tolerates the one benign interleaving
        production permits: a ``start`` that passed its epoch-version
        check before the invalidation hook landed may observe STALE here
        — the epoch fails that start through the request ``_fail_lock``,
        so the tracker transitions to ACTIVE instead of flagging it."""
        with self._mu:
            entry = self._entries.get(handle)
            if entry is None:
                entry = self._entries[handle] = [IDLE, kind]
            state = entry[0]
            if (state == ACTIVE and complete_probe is not None
                    and complete_probe()):
                state = entry[0] = IDLE
            if state == STALE and ev == "start" and racing_invalidate:
                entry[0] = ACTIVE
                return ACTIVE
            nxt = LIFECYCLE_TRANSITIONS.get((state, ev))
            if nxt is None:
                why = LIFECYCLE_VIOLATIONS.get(
                    (state, ev), f"illegal event {ev!r} in state {state!r}")
                self.violations += 1
                raise LifecycleError(
                    f"{entry[1]} lifecycle violation: {why} (event {ev!r} "
                    f"in state {state!r})")
            entry[0] = nxt
            return nxt

    def check_open(self, handle, op: str, *, kind: str = "handle") -> None:
        """Raise use-after-close for ``op`` on a CLOSED handle (for entry
        points that are not themselves lifecycle events)."""
        with self._mu:
            entry = self._entries.get(handle)
            if entry is not None and entry[0] == CLOSED:
                self.violations += 1
                raise LifecycleError(
                    f"{entry[1]} lifecycle violation: use-after-close "
                    f"({op!r} on a closed handle)")

    def reset(self) -> None:
        with self._mu:
            self._entries = weakref.WeakKeyDictionary()
            self.violations = 0


HANDLES = HandleTracker()


# -- hook helpers (the only calls production code makes) --------------------

def track_handle(handle, kind: str, state: str = IDLE) -> None:
    if _DEBUG:
        HANDLES.track(handle, kind, state)


def handle_event(handle, ev: str, **kw) -> None:
    if _DEBUG:
        HANDLES.event(handle, ev, **kw)


def handle_check_open(handle, op: str, *, kind: str = "handle") -> None:
    if _DEBUG:
        HANDLES.check_open(handle, op, kind=kind)
