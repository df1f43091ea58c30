"""Nonblocking user-space collectives on the progress engine (paper §4.7),
the port of the JAX package's ``collectives/nonblocking.py``.

The algorithms of ``schedules`` are compiled into **chunk-pipelined
schedules** driven by the engine (Schafer et al.'s persistent user-level
schedules, driven to completion by continuations as in Schuchart et
al.):

* the payload is split into K chunks;
* each algorithm is decomposed into rounds: a round is a few eager torch
  ops on the rank-stacked carry (see ``schedules``), queued on the
  context's own CUDA stream;
* chunk c's round r+1 is chained off round r by a *continuation* on a
  ``torch_future`` (a CUDA event the engine polls), so rounds fire
  exactly when their inputs are ready — no wait loop, no blocking;
* all round tasks live on one dedicated collective ``Stream``, so a
  ``ProgressExecutor`` worker (or any ``engine.progress`` caller) drives
  many in-flight collectives while the application computes.

``iallreduce`` / ``ireduce_scatter`` / ``iallgather`` / ``ialltoall``
return ``CollectiveRequest`` handles: issue returns at once, completion
is observed through ``is_complete`` / ``wait`` like every other request,
and a failing round fails the request instead of raising into the
progress loop.  A payload is the global tensor of the JAX package's
``shard_map`` form, its leading dim sharded over the axis: on a
rank-stacked mesh every rank's shard lives on the mesh's one device
(``launch.mesh``); on a mesh with one device per rank the payload is a
``RankShards`` (``rank_shards``), each rank's shard on its own device, and
a round's hops are copies between the devices (``schedules``: the same
bits as the stacked form).

**Streams.**  Every round, and the ``torch_future`` after it, is queued
inside ``torch.cuda.stream(<the context's stream>)`` of every device the
payload lives on (a copy between two cards runs on both cards' current
streams), whatever thread runs the continuation.  At issue an event
recorded on the caller's stream of each device makes that device's
collective stream wait for the payload's producer, and each shard is
``record_stream``-ed for its device's collective stream; a round
completes when its event on every device has (``torch_future``), a
request only after its last device op has finished (its join too), and
each result shard is ``record_stream``-ed for the stream of its device
that was current at issue.  Nothing on the path synchronizes a card or
reads a value back to the host.

**Carries.**  Round carries are buffers of a per-chunk workspace (one
buffer per rank and device in the per-device form): a round writes into
them and never into the caller's payload.  A
``PersistentCollective`` owns its workspaces and reuses them on every
``start`` (MPI's ``Allreduce_init``/``Start``), so a restart allocates
only its result; a one-shot issue gets fresh ones.  A start that failed
or was cancelled hands its workspaces to nobody: the next start takes
new ones, so rounds still queued for the dead start never touch it.

Two amortization layers, as in the JAX package: **round batching**
(``round_batch=K`` runs K consecutive rounds per dispatch; composition,
so bit for bit the unbatched result; ``None`` picks from the payload
size) and **persistent schedules** (``*_init`` handles fix the plan once;
``start(payload)`` pays split and dispatch only).  When the handle's
collective stream is adopted by a running ``ProgressExecutor``,
``start`` only enqueues a one-shot issue task and the adopting worker
splits and dispatches round 0 (recorded on
``CollectiveRequest.issue_thread``).

Chunk layouts keep the outputs equal to the native op's: allreduce
chunks are contiguous last-dim slices (padded to a multiple of n·K for
the ring family); reduce-scatter chunks interleave the per-rank blocks;
all-gather joins with the inverse interleave; all-to-all slices the last
dim.  In the fully batched regime the K chunks ride one program stacked
on a batch dim (bit for bit the per-chunk issue).
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
import warnings
import weakref
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.collectives import schedules as S
from repro_torch.collectives.rank_shards import RankShards, global_view, \
    local, ranks_view
from repro_torch.core import debug
from repro_torch.core.continuations import DEFERRED, INLINE, \
    ContinuationQueue
from repro_torch.core.engine import DONE, ProgressEngine, Stream, \
    global_engine
from repro_torch.core.futures import torch_future
from repro_torch.core.request import CancelledError, Request


# ---------------------------------------------------------------------------
# Shape helpers: the rank-stacked view, splits and joins
# ---------------------------------------------------------------------------

def _ranks(x, n: int):
    """Global payload [n*k, ...] -> rank-stacked [n, k, ...] (a view; in
    the per-device form each shard [k, ...] as [1, k, ...])."""
    return ranks_view(x, n)


def _global(y):
    """Rank-stacked [n, k, ...] -> global [n*k, ...]."""
    return global_view(y)


def _splitter(n: int, split_v):
    """The chunk split of a payload: ``split_v`` on the rank view, per
    rank in the per-device form (each chunk a ``RankShards``)."""
    def split(x):
        v = _ranks(x, n)
        if isinstance(v, RankShards):
            return [RankShards(parts)
                    for parts in zip(*(split_v(t) for t in v.shards))]
        return split_v(v)

    return split


def _joiner(join_v):
    """The chunk join: ``join_v`` on the chunks' rank views, per rank in
    the per-device form, then back to the global payload."""
    def join(parts):
        if isinstance(parts[0], RankShards):
            return _global(RankShards(join_v([p.shards[r] for p in parts])
                                      for r in range(len(parts[0]))))
        return _global(join_v(parts))

    return join


def _pad_last_to(x, target: int):
    pad = target - x.shape[-1]
    return F.pad(x, (0, pad)) if pad else x


def _slice_last(x, width: int):
    return x if x.shape[-1] == width else x[..., :width]


def _split_last(x, chunks: int, width: int):
    """Contiguous last-dim split into ``chunks`` pieces of ``width``."""
    return tuple(x[..., c * width:(c + 1) * width] for c in range(chunks))


def _concat_last(parts):
    return parts[0] if len(parts) == 1 else torch.cat(list(parts), dim=-1)


def _first(parts):
    """Single-chunk passthrough join."""
    return parts[0]


def _stack_last(x, k: int, width: int):
    """[..., k*width] -> [..., k, width]: contiguous chunks as a batch
    dim that rides through every round body untouched."""
    return x.reshape(x.shape[:-1] + (k, width))


def _unstack_last(y, total: int):
    """Inverse of ``_stack_last`` (+ drop padding)."""
    flat = y.reshape(y.shape[:-2] + (y.shape[-2] * y.shape[-1],))
    return _slice_last(flat, total)


def _rs_split(x, n: int, chunks: int):
    """Interleaved reduce-scatter split: chunk c gets piece c of every
    rank block, so chunked outputs reassemble into the native block."""
    m = x.shape[-1] // (n * chunks)
    v = x.reshape(x.shape[:-1] + (n, chunks, m))
    return tuple(v[..., :, c, :].reshape(x.shape[:-1] + (n * m,))
                 for c in range(chunks))


def _rs_join(parts):
    """Per-chunk RS outputs [..., m] -> native rank block [..., K*m]."""
    if len(parts) == 1:
        return parts[0]
    return torch.stack(list(parts), dim=-2).reshape(
        parts[0].shape[:-1] + (len(parts) * parts[0].shape[-1],))


def _ag_join(parts, n: int):
    """Per-chunk AG outputs [..., n*m] -> native [..., n*d]."""
    if len(parts) == 1:
        return parts[0]
    blocks = [p.reshape(p.shape[:-1] + (n, p.shape[-1] // n)) for p in parts]
    stacked = torch.stack(blocks, dim=-2)            # [..., n, K, m]
    return stacked.reshape(parts[0].shape[:-1]
                           + (n * len(parts) * blocks[0].shape[-1],))


def _rs_stack(x, n: int, chunks: int):
    """``_rs_split``'s chunks as ONE stacked batch [..., k, n*m]."""
    m = x.shape[-1] // (n * chunks)
    v = x.reshape(x.shape[:-1] + (n, chunks, m)).movedim(-2, -3)
    return v.reshape(x.shape[:-1] + (chunks, n * m))


def _rs_unstack(y):
    """Stacked RS output [..., k, m] -> native rank block [..., k*m]."""
    return y.reshape(y.shape[:-2] + (y.shape[-2] * y.shape[-1],))


def _ag_unstack(y, n: int):
    """Stacked AG output [..., k, n*m] -> native [..., n*(k*m)]."""
    k, w = y.shape[-2], y.shape[-1]
    v = y.reshape(y.shape[:-2] + (k, n, w // n)).movedim(-3, -2)
    return v.reshape(y.shape[:-2] + (n * k * (w // n),))


def _split_ranges(total: int, k: int):
    base, extra = divmod(total, k)
    ranges, off = [], 0
    for i in range(k):
        w = base + (1 if i < extra else 0)
        ranges.append(range(off, off + w))
        off += w
    return [r for r in ranges if len(r)]


def _contiguous_chunks(x, widths):
    parts, off = [], 0
    for w in widths:
        parts.append(x[..., off:off + w])
        off += w
    return parts


# ---------------------------------------------------------------------------
# Round-decomposed schedules
# ---------------------------------------------------------------------------

class _Workspace:
    """One chunk's round carries, by name: a buffer is made at its first
    use and handed back on every later use of the same shape and dtype."""

    __slots__ = ("bufs",)

    def __init__(self):
        self.bufs: dict = {}

    def buf(self, key, shape, dtype, device) -> torch.Tensor:
        t = self.bufs.get(key)
        if t is None or tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            t = torch.empty(tuple(shape), dtype=dtype, device=device)
            self.bufs[key] = t
        return t

    def shaped(self, key, like, shape_fn):
        """A buffer of shape ``shape_fn(like.shape)`` in ``like``'s dtype
        and device; for a ``RankShards``, one per rank on its device."""
        if isinstance(like, RankShards):
            return RankShards(self.buf((key, r), shape_fn(t.shape), t.dtype,
                                       t.device)
                              for r, t in enumerate(like.shards))
        return self.buf(key, shape_fn(like.shape), like.dtype, like.device)

    def like(self, key, t):
        return self.shaped(key, t, tuple)


class _Schedule:
    """One chunk's dispatch units (init/rounds/finish, possibly fused by
    round batching).  ``takes_ws``: each unit is ``fn(carry, ws)`` and is
    bound to a chunk's workspace at issue; else ``fn(carry)``."""

    __slots__ = ("stages", "takes_ws")

    def __init__(self, stages=(), takes_ws: bool = False):
        self.stages = tuple(stages)
        self.takes_ws = takes_ws

    @property
    def num_rounds(self) -> int:
        return len(self.stages)


def _bind(sched: _Schedule, ws: _Workspace) -> _Schedule:
    if not getattr(sched, "takes_ws", False):
        return sched
    return _Schedule([lambda carry, fn=fn: fn(carry, ws)
                      for fn in sched.stages])


class _RoundStage:
    """One raw round body ``fn(carry, ws)``.  A body writes only into its
    workspace's buffers (or a fresh result), never into its input when
    that input is the caller's payload."""

    __slots__ = ("fn",)

    def __init__(self, fn):
        self.fn = fn


class _RoundSchedule:
    """Round-decomposed schedule in raw form.  ``compiled(round_batch)``
    groups consecutive rounds by the batch factor and fuses each group
    into one dispatch unit (``schedules.fuse_rounds``: composition, so
    the ops and their order are those of the unbatched rounds).  Views
    are cached per batch factor, and the _RoundSchedule itself per
    (algorithm, n), so re-issuing reuses the same objects."""

    __slots__ = ("stages", "_compiled")

    def __init__(self, stages):
        self.stages = tuple(stages)
        self._compiled: dict[int, _Schedule] = {}

    @property
    def num_rounds(self) -> int:
        return len(self.stages)

    def compiled(self, round_batch: int = 1) -> _Schedule:
        b = max(1, min(int(round_batch), len(self.stages) or 1))
        sched = self._compiled.get(b)
        if sched is None:
            progs = [S.fuse_rounds([st.fn for st in self.stages[i:i + b]])
                     for i in range(0, len(self.stages), b)]
            sched = _Schedule(progs, takes_ws=True)
            self._compiled[b] = sched
        return sched


# cache: (kind, n, extras) -> _RoundSchedule.  The bodies depend on the
# rank count only (never on a mesh or device), so every mesh shares them.
_schedule_cache: dict = {}


def _cached(key, build):
    sched = _schedule_cache.get(key)
    if sched is None:
        sched = build()
        _schedule_cache[key] = sched
    return sched


def _identity_schedule():
    return _cached(("identity",), lambda: _RoundSchedule(()))


def _recursive_doubling_schedule(n):
    def build():
        stages, mask = [], 1
        while mask < n:
            def step(v, ws, mask=mask, last=2 * mask >= n):
                recv = S.xor_exchange(v, mask, out=ws.like("recv", v))
                if last:
                    return S.add(v, recv)
                return S.add(v, recv, out=ws.like("acc", v))

            stages.append(_RoundStage(step))
            mask <<= 1
        return _RoundSchedule(stages)

    return _cached(("rd", n), build)


def _ring_rs_init(n, d):
    """carry = (chunks [..., n, W/n], acc [..., W/n]) with acc = own
    starting chunk (rank r starts from chunk (r - d) mod n)."""
    def init(x, ws):
        chunks = local(lambda t: t.reshape(t.shape[:-1]
                                           + (n, t.shape[-1] // n)), x)
        acc = ws.shaped("acc", chunks, lambda s: s[:-2] + s[-1:])
        S.take_block(chunks, S.rank_row(n, -d % n, x), out=acc)
        return chunks, acc

    return init


def _ring_rs_round(n, d, step, fresh: bool = False):
    """recv + own chunk; ``fresh``: the result leaves the workspace."""
    def rnd(carry, ws):
        chunks, acc = carry
        recv = S.ring_shift(acc, d, out=ws.like("recv", acc))
        blk = S.take_block(chunks, S.rank_row(n, (-d * (1 + step)) % n, acc),
                           out=ws.like("blk", acc))
        if fresh:
            return chunks, S.add(recv, blk)
        return chunks, S.add(recv, blk, out=acc)

    return rnd


def _ring_ag_start(n):
    """AG step 0: the output (a fresh tensor, the collective's result)
    with the fully reduced resident chunk at slot idx."""
    def start(carry, ws):
        _, acc = carry
        out = local(lambda t: t.new_empty(t.shape[:-1] + (n, t.shape[-1])),
                    acc)
        S.put_block(out, acc, S.rank_row(n, 0, acc))
        return out, acc

    return start


def _ring_ag_round(n, d, step):
    def rnd(carry, ws):
        out, cur = carry
        # ping-pong: round 1 reads "acc" (or the payload) into "recv"
        nxt = S.ring_shift(cur, d, out=ws.like("recv" if step % 2 else "acc",
                                               cur))
        S.put_block(out, nxt, S.rank_row(n, (-d * step) % n, cur))
        return out, nxt

    return rnd


def _ring_finish(carry, ws):
    out, _ = carry
    return local(lambda t: t.reshape(t.shape[:-2]
                                     + (t.shape[-2] * t.shape[-1],)), out)


def _ring_allreduce_schedule(n, reverse):
    """2n+1 dispatch units: init, n-1 reduce-scatter rounds, the AG
    placement, n-1 all-gather rounds, finish."""
    def build():
        d = -1 if reverse else 1
        stages = [_RoundStage(_ring_rs_init(n, d))]
        stages += [_RoundStage(_ring_rs_round(n, d, s)) for s in range(1, n)]
        stages.append(_RoundStage(_ring_ag_start(n)))
        stages += [_RoundStage(_ring_ag_round(n, d, s)) for s in range(1, n)]
        stages.append(_RoundStage(_ring_finish))
        return _RoundSchedule(stages)

    return _cached(("ring", n, reverse), build)


def _hd_halve_round(mask, fresh: bool = False):
    def rnd(cur, ws):
        out = None if fresh else ws.shaped(
            ("half", cur.shape[-1] // 2), cur,
            lambda s: s[:-1] + (s[-1] // 2,))
        return S.halve(cur, mask, out=out)

    return rnd


def _hd_double_round(mask, fresh: bool = False):
    def rnd(cur, ws):
        out = None if fresh else ws.shaped(
            ("double", 2 * cur.shape[-1]), cur,
            lambda s: s[:-1] + (2 * s[-1],))
        return S.double(cur, mask, out=out)

    return rnd


def _hd_stages(n, *, halve: bool, double: bool):
    stages = []
    if halve:
        mask = n >> 1
        while mask >= 1:
            stages.append(_RoundStage(_hd_halve_round(
                mask, fresh=mask == 1 and not double)))
            mask >>= 1
    if double:
        mask = 1
        while mask < n:
            stages.append(_RoundStage(_hd_double_round(
                mask, fresh=2 * mask >= n)))
            mask <<= 1
    return stages


def _halving_doubling_schedule(n):
    return _cached(("hd", n), lambda: _RoundSchedule(
        _hd_stages(n, halve=True, double=True)))


def _hd_reduce_scatter_schedule(n):
    """The halving phase alone: rank r finishes holding its contiguous
    block (the ring's placement, tiled ``psum_scatter``'s)."""
    return _cached(("hd_rs", n), lambda: _RoundSchedule(
        _hd_stages(n, halve=True, double=False)))


def _hd_all_gather_schedule(n):
    """The doubling phase alone: native rank order."""
    return _cached(("hd_ag", n), lambda: _RoundSchedule(
        _hd_stages(n, halve=False, double=True)))


def _ring_reduce_scatter_schedule(n):
    def build():
        stages = [_RoundStage(_ring_rs_init(n, 1))]
        stages += [_RoundStage(_ring_rs_round(n, 1, s, fresh=s == n - 1))
                   for s in range(1, n)]
        stages.append(_RoundStage(lambda carry, ws: carry[1]))
        return _RoundSchedule(stages)

    return _cached(("rs", n), build)


def _ring_all_gather_schedule(n):
    def build():
        def init(x, ws):
            out = local(lambda t: t.new_empty(t.shape[:-1]
                                              + (n, t.shape[-1])), x)
            S.put_block(out, x, S.rank_row(n, 0, x))
            return out, x

        stages = [_RoundStage(init)]
        stages += [_RoundStage(_ring_ag_round(n, 1, s)) for s in range(1, n)]
        stages.append(_RoundStage(_ring_finish))
        return _RoundSchedule(stages)

    return _cached(("ag", n), build)


def _bruck_alltoall_schedule(n):
    def build():
        def init(x, ws):
            return S.rotate_blocks(x, out=ws.like("a", x))

        stages = [_RoundStage(init)]
        step = 1
        while step < n:
            def rnd(x, ws, step=step):
                moved = S.ring_shift(x, step, out=ws.like("moved", x))
                return S.bruck_select(x, moved, step, out=x)

            stages.append(_RoundStage(rnd))
            step <<= 1

        stages.append(_RoundStage(lambda x, ws: S.unrotate_blocks(x)))
        return _RoundSchedule(stages)

    return _cached(("bruck", n), build)


# ---------------------------------------------------------------------------
# Membership
# ---------------------------------------------------------------------------

class MembershipError(RuntimeError):
    """A membership change invalidated this collective mid-flight.
    Retryable: the payload was not consumed — ``rebuild`` the persistent
    handle on the surviving mesh and ``start`` it again.  ``survivors``
    is the surviving rank count, ``version`` the epoch that killed it."""

    def __init__(self, message: str, *, survivors: int | None = None,
                 version: int | None = None):
        super().__init__(message)
        self.survivors = survivors
        self.version = version


class MembershipEpoch:
    """Generation counter for the set of ranks collectives run on.

    ``invalidate`` bumps the generation, fails every registered
    persistent handle's in-flight start with a retryable
    :class:`MembershipError` (exactly once, under the request's fail
    lock), then notifies the subscribed listeners; a handle built under
    an older generation refuses ``start`` until ``rebuild``.  Listeners
    run inside the poll that fired the invalidation: they only record
    the change.  ``n_devices`` is the mesh's rank count (or given)."""

    def __init__(self, n_devices: int | None = None, *, mesh=None):
        self._lock = debug.make_lock("MembershipEpoch._lock")
        self.version = 0
        if n_devices is None:
            n_devices = mesh.size if mesh is not None else 1
        self.n_devices = int(n_devices)
        self.invalidations = 0
        self._handles: "weakref.WeakSet" = weakref.WeakSet()
        self._listeners: list[Callable[["MembershipEpoch",
                                        "MembershipError"], None]] = []

    def register(self, handle: "PersistentCollective") -> None:
        with self._lock:
            self._handles.add(handle)

    def subscribe(self, fn: Callable[["MembershipEpoch", "MembershipError"],
                                     None]) -> None:
        """``fn(epoch, exc)`` runs after every invalidation."""
        with self._lock:
            self._listeners.append(fn)

    def invalidate(self, *, survivors: int,
                   reason: str = "") -> "MembershipError":
        """Declare a membership change down to ``survivors`` ranks."""
        with self._lock:
            self.version += 1
            self.invalidations += 1
            self.n_devices = int(survivors)
            version = self.version
            handles = list(self._handles)
            listeners = list(self._listeners)
        exc = MembershipError(
            f"membership epoch {version}: {int(survivors)} surviving "
            f"device(s)" + (f" ({reason})" if reason else ""),
            survivors=int(survivors), version=version)
        for h in handles:
            h._membership_changed(exc)
        for fn in listeners:
            fn(self, exc)
        return exc

    def __repr__(self):
        return (f"MembershipEpoch(version={self.version}, "
                f"n_devices={self.n_devices}, "
                f"handles={len(self._handles)})")


# ---------------------------------------------------------------------------
# The request handle
# ---------------------------------------------------------------------------

class CollectiveRequest(Request):
    """Handle for an in-flight user-space collective.  ``rounds_done`` /
    ``rounds_total`` count dispatch units (with round batching one covers
    several rounds); ``issue_thread`` is the thread that dispatched round
    0 (an executor worker for an executor-driven start)."""

    __slots__ = ("engine", "stream", "queue", "ctx", "op", "algorithm",
                 "num_chunks", "rounds_total", "rounds_done", "_fail_lock",
                 "_cancelled", "issue_thread")

    def __init__(self, engine: ProgressEngine, stream: Stream, queue,
                 op: str, algorithm: str, num_chunks: int,
                 rounds_total: int, ctx=None):
        super().__init__(tag=f"i{op}")
        self.engine = engine
        self.stream = stream
        self.queue = queue
        self.ctx = ctx
        self.op = op
        self.algorithm = algorithm
        self.num_chunks = num_chunks
        self.rounds_total = rounds_total
        self.rounds_done = 0
        self._fail_lock = threading.Lock()
        self._cancelled = False
        self.issue_thread: int | None = None

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    def cancel(self) -> None:
        """MPI_Cancel + MPI_Wait: complete with ``CancelledError``.  Rounds
        already queued retire harmlessly: their continuations see the
        completed request and dispatch nothing further."""
        with self._fail_lock:
            if self._complete:
                return
            self._cancelled = True
            self.fail(CancelledError(f"{self.tag} cancelled"))
        if self.ctx is not None:
            self.ctx.cancelled += 1

    def wait(self, engine=None, stream=None, timeout: float | None = None):
        """MPI_Wait: drive the collective's stream until complete.  A
        DEFERRED queue is drained by the waiter (exactly-once under
        concurrent drains); when an executor owns the stream the waiter
        yields to its workers instead of polling.  The card is never
        synchronized: a sweep that finds a round still running polls
        again."""
        eng = engine if engine is not None else self.engine
        s = stream if stream is not None else self.stream
        q = self.queue
        deferred = q is not None and q.policy == DEFERRED
        ex = eng.executor
        t0 = time.monotonic()
        while not self.is_complete:
            owned = ex is not None and ex.running and ex.owns(s)
            made = 0 if owned else eng.progress(s)
            if deferred:
                made += q.drain()
            if timeout is not None and not self.is_complete \
                    and time.monotonic() - t0 > timeout:
                raise TimeoutError(f"wait timed out after {timeout}s")
            if not made and not self.is_complete:
                time.sleep(20e-6 if owned else 0)
        return self.value()

    def __repr__(self):
        return (f"CollectiveRequest({self.op}/{self.algorithm}, "
                f"chunks={self.num_chunks}, "
                f"rounds={self.rounds_done}/{self.rounds_total}, "
                f"complete={self.is_complete})")


# ---------------------------------------------------------------------------
# The chunk pipeline driver
# ---------------------------------------------------------------------------

def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, RankShards):
        return list(tree.shards)
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


class _ChunkPipeline:
    """Drives K chunks through their schedules via continuations.

    Every dispatch happens inside a continuation (or in ``launch`` for
    round 0), on the collective CUDA stream: run unit r, register a
    ``torch_future`` for its outputs on the collective engine stream,
    attach the next continuation.  A unit that raises — or a future that
    fails — fails the request exactly once; the other chunks are
    abandoned.  The join's device work completes through one more
    future before the request does.  ``defer=True``: the caller enqueues
    a one-shot issue task and the stream's adopting worker runs
    ``launch``.

    ``cuda_streams`` holds one round stream per device the payload lives
    on, ``ready`` one event per device (recorded on its stream current at
    issue), ``consumers`` each device's stream current at issue."""

    def __init__(self, ctx: "UserCollectives", req: CollectiveRequest,
                 schedules, payloads_fn: Callable[[], list],
                 join: Callable[[list], Any], defer: bool = False, *,
                 cuda_streams=(), ready=(), consumers=None):
        self.ctx = ctx
        self.req = req
        self.schedules = schedules
        self.join = join
        self.cuda_streams = tuple(cuda_streams)
        self._ready = tuple(ready)          # events on the payload's streams
        self._consumers = consumers or {}   # device -> stream at issue
        self._lock = threading.Lock()
        self._results: list = [None] * len(schedules)
        self._remaining = len(schedules)
        self._payloads_fn = payloads_fn
        if not defer:
            self.launch()

    def _on_stream(self):
        """Every device's round stream made current for the block."""
        if not self.cuda_streams:
            return contextlib.nullcontext()
        if len(self.cuda_streams) == 1:
            return torch.cuda.stream(self.cuda_streams[0])
        stack = contextlib.ExitStack()
        for cs in self.cuda_streams:
            stack.enter_context(torch.cuda.stream(cs))
        return stack

    def launch(self) -> None:
        """Split the payload and dispatch round 0 of every chunk on the
        calling thread."""
        if self.req.is_complete:
            return                    # cancelled before the issue task ran
        self.req.issue_thread = threading.get_ident()
        fn, self._payloads_fn = self._payloads_fn, None
        with self._on_stream():
            for cs, ready in zip(self.cuda_streams, self._ready):
                cs.wait_event(ready)
            try:
                payloads = fn()
            except BaseException as exc:  # noqa: BLE001
                self._fail(exc)
                return
            for c, payload in enumerate(payloads):
                self._advance(c, 0, payload)

    def _advance(self, c: int, r: int, value) -> None:
        if self.req.is_complete:
            return                    # another chunk failed: abandon
        stages = self.schedules[c].stages
        with self._on_stream():
            if r >= len(stages):
                # degenerate schedule (n == 1): completion still flows
                # through one future, never synchronously at issue
                fut = torch_future(self.ctx.engine, value, self.ctx.stream,
                                   on_pending=self.ctx._round_pending)
                self.ctx.queue.attach(
                    fut, lambda rq, c=c: self._chunk_done(c, rq.value()),
                    on_error=self._on_error)
                return
            try:
                out = stages[r](value)
            except BaseException as exc:  # noqa: BLE001
                self._fail(exc)
                return
            self.req.rounds_done += 1
            fut = torch_future(self.ctx.engine, out, self.ctx.stream,
                               on_pending=self.ctx._round_pending)
        if r + 1 < len(stages):
            cb = lambda rq, c=c, r=r: self._advance(c, r + 1, rq.value())  # noqa: E731
        else:
            cb = lambda rq, c=c: self._chunk_done(c, rq.value())  # noqa: E731
        self.ctx.queue.attach(fut, cb, on_error=self._on_error)

    def _fail(self, exc: BaseException) -> None:
        """Fail the request exactly once; the failure counter moves with
        the request, not with every chunk that observes the failure."""
        with self.req._fail_lock:
            if self.req.is_complete:
                return
            self.req.fail(exc)
        self.ctx.failed += 1

    def _on_error(self, rq) -> None:
        self._fail(rq.exception or RuntimeError("collective round failed"))

    def _chunk_done(self, c: int, value) -> None:
        with self._lock:
            self._results[c] = value
            self._remaining -= 1
            done = self._remaining == 0
        if not done or self.req.is_complete:
            return
        with self._on_stream():
            try:
                result = self.join(self._results)
            except BaseException as exc:  # noqa: BLE001
                self._fail(exc)
                return
            fut = torch_future(self.ctx.engine, result, self.ctx.stream)
        self.ctx.queue.attach(fut, lambda rq: self._complete(rq.value()),
                              on_error=self._on_error)

    def _complete(self, result) -> None:
        if self._consumers:
            for t in _tensors(result):
                if t.is_cuda:
                    t.record_stream(self._consumers[t.device])
        with self.req._fail_lock:
            if self.req.is_complete:
                return                # lost the race to cancel()/fail()
            self.req.complete(result)
        self.ctx.completed += 1


# ---------------------------------------------------------------------------
# CollectiveSpec — the one collective-tuning config object
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CollectiveSpec:
    """How collectives run: backend + algorithm + chunking + fusion, one
    frozen value every surface takes.  Validation is eager;
    ``resolve(axis_size)`` applies the power-of-two fallback."""

    backend: str = "native"
    algorithm: str = "ring"
    chunks: int = 1
    round_batch: int | None = None

    def __post_init__(self):
        if self.backend not in ("native", "user"):
            raise ValueError(
                f"CollectiveSpec.backend must be 'native' or 'user', "
                f"got {self.backend!r}")
        if self.algorithm not in S.ALGORITHMS:
            raise ValueError(
                f"CollectiveSpec.algorithm {self.algorithm!r} unknown; "
                f"options: {sorted(S.ALGORITHMS)}")
        if int(self.chunks) < 1:
            raise ValueError(
                f"CollectiveSpec.chunks must be >= 1, got {self.chunks}")
        if self.round_batch is not None and int(self.round_batch) < 0:
            raise ValueError(
                f"CollectiveSpec.round_batch must be None (auto) or "
                f">= 0, got {self.round_batch}")

    @property
    def user(self) -> bool:
        return self.backend == "user"

    def resolve(self, axis_size: int) -> "CollectiveSpec":
        algorithm = S.resolve_algorithm(self.algorithm, axis_size)
        if algorithm == self.algorithm:
            return self
        return dataclasses.replace(self, algorithm=algorithm)


# one warning per config surface per process
_legacy_kwargs_warned: set[str] = set()


def spec_from_legacy(spec: "CollectiveSpec | None" = None, *,
                     surface: str, backend: str | None = None,
                     algorithm: str | None = None,
                     chunks: int | None = None,
                     round_batch: int | None = None,
                     default: "CollectiveSpec | None" = None,
                     ) -> "CollectiveSpec":
    """Coerce one surface's legacy ``collective_*`` kwargs into a
    :class:`CollectiveSpec`.  ``spec`` wins when given (mixing it with
    legacy kwargs raises); any legacy kwarg warns once per surface."""
    legacy = {k: v for k, v in (("backend", backend),
                                ("algorithm", algorithm),
                                ("chunks", chunks),
                                ("round_batch", round_batch))
              if v is not None}
    if spec is not None:
        if legacy:
            raise ValueError(
                f"{surface}: pass either collective_spec or the legacy "
                f"collective_* kwargs, not both (got {sorted(legacy)})")
        return spec
    base = default if default is not None else CollectiveSpec()
    if not legacy:
        return base
    if surface not in _legacy_kwargs_warned:
        _legacy_kwargs_warned.add(surface)
        warnings.warn(
            f"{surface}: the collective_backend / collective_algorithm / "
            f"collective_chunks / collective_round_batch kwargs are "
            f"deprecated; pass collective_spec=CollectiveSpec(...) "
            f"(repro_torch.collectives) instead",
            DeprecationWarning, stacklevel=3)
    return dataclasses.replace(base, **legacy)


# ---------------------------------------------------------------------------
# Issue plans (everything that does NOT depend on the payload's values)
# ---------------------------------------------------------------------------

class _Plan:
    """Issue-invariant description of one collective for one payload
    signature: the chunk split, the raw per-chunk schedules and the
    join.  Validation and heuristics happen when the plan is built."""

    __slots__ = ("op", "algorithm", "shape", "dtype", "mesh", "axis",
                 "schedules", "split", "join", "payload_bytes",
                 "round_batch")

    def __init__(self, op, algorithm, shape, dtype, mesh, axis,
                 schedules, split, join, payload_bytes, round_batch):
        self.op = op
        self.algorithm = algorithm
        self.shape = shape
        self.dtype = dtype
        self.mesh = mesh
        self.axis = axis
        self.schedules = schedules
        self.split = split
        self.join = join
        self.payload_bytes = payload_bytes
        self.round_batch = round_batch

    @property
    def num_rounds(self) -> int:
        return max((s.num_rounds for s in self.schedules), default=0)


def _axis_len(mesh, axis: str) -> int:
    return dict(mesh.shape)[axis]


def _largest_divisor_leq(total: int, k: int) -> int:
    k = max(1, min(k, total))
    while total % k:
        k -= 1
    return k


def _check_payload(x, op: str) -> None:
    """Collectives shard the leading dim and schedule over the last: a
    1-D payload is rejected eagerly."""
    if len(x.shape) < 2:
        raise ValueError(
            f"i{op}: payload must be at least 2-D ([sharded_dim, ..., "
            f"payload_dim]), got shape {tuple(x.shape)}; reshape(-1, 1) "
            f"scalars-per-rank or add a trailing payload dim")


def _check_lead(shape, n: int, op: str) -> None:
    if shape[0] % n:
        raise ValueError(f"i{op}: leading dim {shape[0]} not divisible by "
                         f"axis size {n}")


def _dtype_of(x):
    return getattr(x, "dtype", torch.float32)


def _payload_bytes(shape, dtype) -> int:
    size = 1
    for s in shape:
        size *= int(s)
    return size * (dtype.itemsize if isinstance(dtype, torch.dtype) else 4)


def _resolve_round_batch(round_batch, payload_bytes: int,
                         num_rounds: int) -> int:
    """None / <=0 means auto: pick from the payload size."""
    if round_batch is None or int(round_batch) <= 0:
        return S.auto_round_batch(payload_bytes, num_rounds)
    return int(round_batch)


def _identity_plan(op, algorithm, shape, dtype, mesh, axis, nbytes):
    return _Plan(op, algorithm, tuple(shape), dtype, mesh, axis,
                 [_identity_schedule()], lambda x: [x], _first, nbytes, 1)


def _plan_allreduce(mesh, axis: str, shape, dtype, algorithm: str,
                    chunks: int, round_batch=None) -> _Plan:
    n = _axis_len(mesh, axis)
    algorithm = S.resolve_algorithm(algorithm, n)
    chunks = max(1, int(chunks))
    D = shape[-1]
    nbytes = _payload_bytes(shape, dtype)
    if n == 1:
        return _identity_plan("allreduce", algorithm, shape, dtype, mesh,
                              axis, nbytes)
    _check_lead(shape, n, "allreduce")
    if algorithm == "recursive_doubling":
        base = _recursive_doubling_schedule(n)
        per = -(-D // chunks)        # rd has no per-rank block structure
    else:
        # ring family (+ halving/doubling): chunk width a multiple of n
        per = -(-D // (n * chunks)) * n
        base = (_halving_doubling_schedule(n)
                if algorithm == "halving_doubling"
                else _ring_allreduce_schedule(n, False))
    pad_to = per * chunks
    batch = _resolve_round_batch(round_batch, nbytes, base.num_rounds)
    if chunks == 1:
        if pad_to == D:
            split_v, join_v = (lambda v: [v]), _first
        else:
            split_v = lambda v: [_pad_last_to(v, pad_to)]           # noqa: E731
            join_v = lambda parts: _slice_last(parts[0], D)         # noqa: E731
        scheds = [base]
    elif algorithm != "bidir" and batch >= base.num_rounds:
        # chunk fusion for the fully batched (small payload) regime: all
        # K chunks ride ONE program as a stacked batch dim.  Bit for bit
        # the per-chunk issue: every element's cross-rank summation order
        # depends only on ring position / partner masks.
        split_v = lambda v: [_stack_last(_pad_last_to(v, pad_to),   # noqa: E731
                                         chunks, per)]
        join_v = lambda parts: _unstack_last(parts[0], D)           # noqa: E731
        scheds = [base]
    elif algorithm == "recursive_doubling":
        # no divisibility constraint: contiguous near-equal slices
        widths = [len(r) for r in _split_ranges(D, min(chunks, D))]
        split_v = lambda v: _contiguous_chunks(v, widths)           # noqa: E731
        join_v = _concat_last
        scheds = [base] * len(widths)
    else:
        split_v = lambda v: list(_split_last(_pad_last_to(v, pad_to),  # noqa: E731
                                             chunks, per))
        if algorithm == "bidir":
            # alternate ring direction per chunk (chunks=1: forward ring)
            scheds = [_ring_allreduce_schedule(n, bool(c % 2))
                      for c in range(chunks)]
        else:
            scheds = [base] * chunks
        join_v = lambda parts: _slice_last(_concat_last(parts), D)  # noqa: E731
    return _Plan("allreduce", algorithm, tuple(shape), dtype, mesh, axis,
                 scheds, _splitter(n, split_v), _joiner(join_v), nbytes,
                 batch)


def _plan_reduce_scatter(mesh, axis: str, shape, dtype,
                         algorithm: str = "ring", chunks: int = 1,
                         round_batch=None) -> _Plan:
    n = _axis_len(mesh, axis)
    D = shape[-1]
    if D % n:
        raise ValueError(
            f"ireduce_scatter: last dim {D} not divisible by "
            f"axis size {n}")
    nbytes = _payload_bytes(shape, dtype)
    if n == 1:
        return _identity_plan("reduce_scatter", "ring", shape, dtype, mesh,
                              axis, nbytes)
    _check_lead(shape, n, "reduce_scatter")
    algorithm = S.resolve_rs_ag_algorithm(algorithm, n, op="reduce_scatter")
    k = _largest_divisor_leq(D // n, max(1, int(chunks)))
    base = (_hd_reduce_scatter_schedule(n)
            if algorithm == "halving_doubling"
            else _ring_reduce_scatter_schedule(n))
    batch = _resolve_round_batch(round_batch, nbytes, base.num_rounds)
    if k == 1:
        split_v, join_v = (lambda v: [v]), _first
        scheds = [base]
    elif batch >= base.num_rounds:
        split_v = lambda v: [_rs_stack(v, n, k)]                    # noqa: E731
        join_v = lambda parts: _rs_unstack(parts[0])                # noqa: E731
        scheds = [base]
    else:
        split_v = lambda v: list(_rs_split(v, n, k))                # noqa: E731
        join_v = _rs_join
        scheds = [base] * k
    return _Plan("reduce_scatter", algorithm, tuple(shape), dtype, mesh,
                 axis, scheds, _splitter(n, split_v), _joiner(join_v),
                 nbytes, batch)


def _plan_allgather(mesh, axis: str, shape, dtype,
                    algorithm: str = "ring", chunks: int = 1,
                    round_batch=None) -> _Plan:
    n = _axis_len(mesh, axis)
    nbytes = _payload_bytes(shape, dtype)
    if n == 1:
        return _identity_plan("allgather", "ring", shape, dtype, mesh, axis,
                              nbytes)
    _check_lead(shape, n, "allgather")
    algorithm = S.resolve_rs_ag_algorithm(algorithm, n, op="allgather")
    d = shape[-1]
    k = _largest_divisor_leq(d, max(1, int(chunks)))
    base = (_hd_all_gather_schedule(n)
            if algorithm == "halving_doubling"
            else _ring_all_gather_schedule(n))
    batch = _resolve_round_batch(round_batch, nbytes, base.num_rounds)
    if k == 1:
        split_v, join_v = (lambda v: [v]), _first
        scheds = [base]
    elif batch >= base.num_rounds:
        split_v = lambda v: [_stack_last(v, k, d // k)]             # noqa: E731
        join_v = lambda parts: _ag_unstack(parts[0], n)             # noqa: E731
        scheds = [base]
    else:
        split_v = lambda v: list(_split_last(v, k, d // k))         # noqa: E731
        join_v = lambda parts: _ag_join(parts, n)                   # noqa: E731
        scheds = [base] * k
    return _Plan("allgather", algorithm, tuple(shape), dtype, mesh, axis,
                 scheds, _splitter(n, split_v), _joiner(join_v), nbytes,
                 batch)


def _plan_alltoall(mesh, axis: str, shape, dtype, chunks: int,
                   round_batch=None) -> _Plan:
    n = _axis_len(mesh, axis)
    lead = shape[0]
    if lead % n:
        raise ValueError(
            f"ialltoall: leading dim {lead} not divisible by "
            f"axis size {n}")
    nbytes = _payload_bytes(shape, dtype)
    if n == 1:
        return _identity_plan("alltoall", "bruck", shape, dtype, mesh, axis,
                              nbytes)
    if lead != n * n:
        raise ValueError(f"ialltoall: leading dim {lead} must be n*n = "
                         f"{n * n} blocks (n per rank)")
    D = shape[-1]
    widths = [len(r) for r in _split_ranges(D, min(max(1, int(chunks)), D))]
    base = _bruck_alltoall_schedule(n)
    batch = _resolve_round_batch(round_batch, nbytes, base.num_rounds)
    if len(widths) == 1:
        split_v, join_v = (lambda v: [v]), _first
    else:
        split_v = lambda v: _contiguous_chunks(v, widths)           # noqa: E731
        join_v = _concat_last
    return _Plan("alltoall", "bruck", tuple(shape), dtype, mesh, axis,
                 [base] * len(widths), _splitter(n, split_v),
                 _joiner(join_v), nbytes, batch)


def _check_form(x, mesh, axis: str, op: str) -> None:
    """A rank-stacked mesh takes a tensor; a mesh with a device per rank
    takes a ``RankShards`` with shard ``r`` on ``mesh.devices[r]`` (its
    collectives run over an axis that holds every rank)."""
    if mesh is None:
        return
    if not getattr(mesh, "per_device", False):
        if isinstance(x, RankShards):
            raise ValueError(f"i{op}: a RankShards payload needs a mesh "
                             f"with a device per rank, got {mesh!r}")
        return
    if not isinstance(x, RankShards):
        raise ValueError(f"i{op}: {mesh!r} has a device per rank; the "
                         f"payload must be a RankShards "
                         f"(RankShards.from_stacked), got "
                         f"{type(x).__name__}")
    if _axis_len(mesh, axis) != mesh.size:
        raise ValueError(f"i{op}: on a mesh with a device per rank the "
                         f"axis {axis!r} must hold every rank of {mesh!r}")
    if x.devices != mesh.devices:
        raise ValueError(f"i{op}: shards on {list(map(str, x.devices))}, "
                         f"the mesh's ranks on "
                         f"{list(map(str, mesh.devices))}")


def _cuda_tensors_by_device(x) -> dict:
    """The payload's CUDA tensors by device, in rank order."""
    out: dict = {}
    for t in _tensors(x):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            out.setdefault(t.device, []).append(t)
    return out


class UserCollectives:
    """Issue context for nonblocking user-space collectives.

    Owns one dedicated engine ``Stream`` (adopted by a
    ``ProgressExecutor`` when given), one ``ContinuationQueue`` that
    chains the rounds, and one CUDA stream per device the rounds are
    queued on (made at the first CUDA payload).  INLINE policy (default)
    runs the chaining on whichever thread progresses the stream; DEFERRED
    routes it through the queue's ready list."""

    _ids = itertools.count()

    def __init__(self, engine: Optional[ProgressEngine] = None, *,
                 executor=None, stream: Optional[Stream] = None,
                 policy: str = INLINE, name: str = "",
                 epoch: "MembershipEpoch | None" = None):
        self.engine = engine if engine is not None else global_engine()
        self.executor = executor
        self.epoch = epoch
        self.name = name or f"usercoll{next(UserCollectives._ids)}"
        self._own_stream = stream is None
        if stream is None:
            if executor is not None:
                stream = executor.stream(f"{self.name}-stream")
            else:
                stream = self.engine.stream(f"{self.name}-stream")
        self.stream = stream
        self.queue = ContinuationQueue(self.engine, self.stream,
                                       policy=policy, name=f"{self.name}-q")
        self._adopted_queue = False
        if executor is not None and policy == DEFERRED:
            executor.adopt_queue(self.queue)
            self._adopted_queue = True
        self._cuda_streams: dict = {}
        # polls of a round's future that found the round still running:
        # the rounds run asynchronously to the thread that issued them
        self.pending_polls = 0
        self.issued = 0
        self.completed = 0
        self.failed = 0
        self.cancelled = 0
        self._closed = False

    def _round_pending(self) -> None:
        self.pending_polls += 1

    def cuda_stream(self, device) -> "torch.cuda.Stream | None":
        """The CUDA stream this context queues rounds on for ``device``
        (None off the card)."""
        if device is None or torch.device(device).type != "cuda":
            return None
        device = torch.device(device)
        cs = self._cuda_streams.get(device)
        if cs is None:
            cs = self._cuda_streams.setdefault(
                device, torch.cuda.Stream(device=device))
        return cs

    # -- the collectives ---------------------------------------------------
    def iallreduce(self, x, mesh, axis: str, *, algorithm: str = "ring",
                   chunks: int = 1, round_batch: int | None = None,
                   spec: "CollectiveSpec | None" = None) -> CollectiveRequest:
        """Nonblocking allreduce of ``x`` (leading dim sharded on
        ``axis``): every rank's slice becomes the sum over ranks, as
        ``psum``.  ``algorithm`` is any ``schedules.ALGORITHMS`` key
        (power-of-two-only ones fall back to ring with a warning);
        ``round_batch`` runs that many rounds per dispatch (None/0: auto
        from the payload size); ``spec`` overrides all three."""
        self._check_open()
        _check_payload(x, "allreduce")
        _check_form(x, mesh, axis, "allreduce")
        if spec is not None:
            algorithm, chunks, round_batch = \
                spec.algorithm, spec.chunks, spec.round_batch
        plan = _plan_allreduce(mesh, axis, tuple(x.shape), _dtype_of(x),
                               algorithm, chunks, round_batch)
        return self._issue_plan(plan, x)

    def ireduce_scatter(self, x, mesh, axis: str, *,
                        algorithm: str = "ring", chunks: int = 1,
                        round_batch: int | None = None,
                        spec: "CollectiveSpec | None" = None,
                        ) -> CollectiveRequest:
        """Nonblocking reduce-scatter (tiled ``psum_scatter`` on the last
        dim; the last dim must divide by the axis size).  ``ring`` or
        ``halving_doubling``; other names fall back to ring."""
        self._check_open()
        _check_payload(x, "reduce_scatter")
        _check_form(x, mesh, axis, "reduce_scatter")
        if spec is not None:
            algorithm, chunks, round_batch = \
                spec.algorithm, spec.chunks, spec.round_batch
        plan = _plan_reduce_scatter(mesh, axis, tuple(x.shape),
                                    _dtype_of(x), algorithm, chunks,
                                    round_batch)
        return self._issue_plan(plan, x)

    def iallgather(self, x, mesh, axis: str, *, algorithm: str = "ring",
                   chunks: int = 1, round_batch: int | None = None,
                   spec: "CollectiveSpec | None" = None) -> CollectiveRequest:
        """Nonblocking all-gather (tiled ``all_gather`` on the last
        dim); ``ring`` or ``halving_doubling``."""
        self._check_open()
        _check_payload(x, "allgather")
        _check_form(x, mesh, axis, "allgather")
        if spec is not None:
            algorithm, chunks, round_batch = \
                spec.algorithm, spec.chunks, spec.round_batch
        plan = _plan_allgather(mesh, axis, tuple(x.shape), _dtype_of(x),
                               algorithm, chunks, round_batch)
        return self._issue_plan(plan, x)

    def ialltoall(self, x, mesh, axis: str, *, chunks: int = 1,
                  round_batch: int | None = None,
                  spec: "CollectiveSpec | None" = None) -> CollectiveRequest:
        """Nonblocking Bruck all-to-all over each rank's leading block
        dim (the global leading dim is n·n blocks, n per rank)."""
        self._check_open()
        _check_payload(x, "alltoall")
        _check_form(x, mesh, axis, "alltoall")
        if spec is not None:
            chunks, round_batch = spec.chunks, spec.round_batch
        plan = _plan_alltoall(mesh, axis, tuple(x.shape), _dtype_of(x),
                              chunks, round_batch)
        return self._issue_plan(plan, x)

    # -- persistent handles (MPI *_init / MPI_Start) -----------------------
    def _init(self, op, planner, x, mesh, axis, spec, warmup, epoch,
              **kw) -> "PersistentCollective":
        self._check_open()
        _check_payload(x, op)
        _check_form(x, mesh, axis, op)
        if spec is not None:
            kw.update(chunks=spec.chunks, round_batch=spec.round_batch)
            if "algorithm" in kw:
                kw["algorithm"] = spec.algorithm
        shape, dtype = tuple(x.shape), _dtype_of(x)
        replan = lambda m, a: planner(m, a, shape, dtype, **kw)  # noqa: E731
        return PersistentCollective(
            self, replan(mesh, axis), warmup=warmup,
            epoch=epoch if epoch is not None else self.epoch, replan=replan)

    def allreduce_init(self, x, mesh, axis: str, *,
                       algorithm: str = "ring", chunks: int = 1,
                       round_batch: int | None = None,
                       spec: "CollectiveSpec | None" = None,
                       warmup: bool = True,
                       epoch: "MembershipEpoch | None" = None,
                       ) -> "PersistentCollective":
        """MPI_Allreduce_init: a persistent schedule for payloads shaped
        like ``x`` (a tensor, or anything with ``shape``/``dtype``; only
        those are read).  ``start(payload)`` re-issues it; see
        :class:`PersistentCollective`."""
        return self._init("allreduce", _plan_allreduce, x, mesh, axis, spec,
                          warmup, epoch, algorithm=algorithm, chunks=chunks,
                          round_batch=round_batch)

    def reduce_scatter_init(self, x, mesh, axis: str, *,
                            algorithm: str = "ring", chunks: int = 1,
                            round_batch: int | None = None,
                            spec: "CollectiveSpec | None" = None,
                            warmup: bool = True,
                            epoch: "MembershipEpoch | None" = None,
                            ) -> "PersistentCollective":
        return self._init("reduce_scatter", _plan_reduce_scatter, x, mesh,
                          axis, spec, warmup, epoch, algorithm=algorithm,
                          chunks=chunks, round_batch=round_batch)

    def allgather_init(self, x, mesh, axis: str, *,
                       algorithm: str = "ring", chunks: int = 1,
                       round_batch: int | None = None,
                       spec: "CollectiveSpec | None" = None,
                       warmup: bool = True,
                       epoch: "MembershipEpoch | None" = None,
                       ) -> "PersistentCollective":
        return self._init("allgather", _plan_allgather, x, mesh, axis, spec,
                          warmup, epoch, algorithm=algorithm, chunks=chunks,
                          round_batch=round_batch)

    def alltoall_init(self, x, mesh, axis: str, *, chunks: int = 1,
                      round_batch: int | None = None,
                      spec: "CollectiveSpec | None" = None,
                      warmup: bool = True,
                      epoch: "MembershipEpoch | None" = None,
                      ) -> "PersistentCollective":
        return self._init("alltoall", _plan_alltoall, x, mesh, axis, spec,
                          warmup, epoch, chunks=chunks,
                          round_batch=round_batch)

    # -- machinery ---------------------------------------------------------
    def _issue_plan(self, plan: _Plan, x) -> CollectiveRequest:
        scheds = [rs.compiled(plan.round_batch) for rs in plan.schedules]
        return self._issue(plan.op, plan.algorithm, scheds,
                           lambda: plan.split(x), plan.join,
                           payload=x)

    def _adopting_executor(self):
        """The running executor whose worker owns this context's stream,
        or None — the gate for executor-driven starts."""
        ex = self.executor if self.executor is not None \
            else self.engine.executor
        if ex is not None and ex.running and ex.owns(self.stream):
            return ex
        return None

    def _issue(self, op, algorithm, scheds, payloads, join, *,
               defer: bool = False, payload=None,
               workspaces=None) -> CollectiveRequest:
        """``payloads`` is the chunk list, or a thunk producing it (the
        deferred path passes a thunk so the split runs on the worker).
        ``payload`` (the caller's tensor) sets the CUDA stream and what it
        waits for; ``workspaces`` are a persistent handle's carries."""
        payloads_fn = payloads if callable(payloads) else lambda: payloads
        if workspaces is None:
            workspaces = [_Workspace() for _ in scheds]
        scheds = [_bind(s, ws) for s, ws in zip(scheds, workspaces)]
        streams, ready, consumers = [], [], {}
        for device, shards in _cuda_tensors_by_device(payload).items():
            cs = self.cuda_stream(device)
            consumers[device] = torch.cuda.current_stream(device)
            ev = torch.cuda.Event()
            ev.record(consumers[device])
            for t in shards:
                t.record_stream(cs)
            streams.append(cs)
            ready.append(ev)
        req = CollectiveRequest(self.engine, self.stream, self.queue, op,
                                algorithm, len(scheds),
                                sum(s.num_rounds for s in scheds), ctx=self)
        self.issued += 1
        pipe = _ChunkPipeline(self, req, scheds, payloads_fn, join,
                              defer=defer, cuda_streams=streams, ready=ready,
                              consumers=consumers)
        if defer:
            # one-shot issue task: the worker that owns the collective
            # stream splits + dispatches round 0 on its next sweep
            def issue_task(thing, pipe=pipe) -> str:
                pipe.launch()
                return DONE

            self.engine.async_start(issue_task, None, self.stream)
        return req

    def _check_open(self):
        if self._closed:
            raise RuntimeError(f"UserCollectives {self.name!r} is closed")

    # -- lifecycle ---------------------------------------------------------
    @property
    def in_flight(self) -> int:
        return self.issued - self.completed - self.failed - self.cancelled

    def close(self, *, drain: bool = True,
              timeout: float | None = 30.0) -> None:
        """Drain in-flight collectives, then release the stream/queue.
        ``drain=False`` (the abandon path) cancels pending continuations
        and leaves a still-busy stream registered rather than freed, so
        close never raises over the application's own error.  Safe to
        call twice."""
        if self._closed:
            return
        self._closed = True          # block new issues during the drain
        if drain:
            t0 = time.monotonic()
            ex = self.executor
            while self.stream.pending or self.queue.ready:
                # park only when SOMEONE ELSE progresses the stream; a
                # close() on the owning worker itself progresses inline
                if ex is not None and ex.running and ex.owns(self.stream) \
                        and threading.get_ident() \
                        not in ex.worker_thread_idents():
                    time.sleep(50e-6)
                else:
                    self.engine.progress(self.stream)
                    self.queue.drain()
                if timeout is not None and time.monotonic() - t0 > timeout:
                    # reopen so a retry close() drains and releases
                    self._closed = False
                    raise TimeoutError(
                        f"UserCollectives.close: {self.stream.pending} tasks "
                        f"/ {self.queue.ready} continuations still pending")
        if self._adopted_queue:
            self.executor.release_queue(self.queue)
        self.queue.close(run_ready=drain)
        if self._own_stream:
            if self.executor is not None and self.executor.owns(self.stream):
                self.executor.release(self.stream)
            if not self.stream.pending:
                self.engine.free_stream(self.stream)

    def __enter__(self) -> "UserCollectives":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(drain=exc_type is None)

    def __repr__(self):
        return (f"UserCollectives({self.name!r}, issued={self.issued}, "
                f"completed={self.completed}, failed={self.failed}, "
                f"cancelled={self.cancelled})")


class PersistentCollective:
    """Persistent collective schedule: MPI ``*_init`` + ``MPI_Start`` on
    the progress engine.

    Built once per (op, payload shape, dtype, algorithm, chunks,
    round-batch, mesh, axis): the plan is fixed, and the handle owns one
    workspace per chunk (the round carries), made by the ``warmup=True``
    throwaway start on zeros, so a later start allocates only its
    result.  At most ONE outstanding start (starting an active handle
    raises); ``cancel()`` cancels it; a failed or cancelled start is
    restartable and its successor takes fresh workspaces.

    Built against a :class:`MembershipEpoch`, the handle registers
    itself: ``epoch.invalidate`` fails the in-flight start with a
    retryable :class:`MembershipError` and marks the handle stale, and
    ``start`` raises until ``rebuild(mesh)`` re-plans it on the
    survivors."""

    __slots__ = ("ctx", "plan", "round_batch", "schedules", "active",
                 "starts", "_closed", "epoch", "_epoch_version", "_replan",
                 "rebuilds", "_workspaces", "__weakref__")

    def __init__(self, ctx: UserCollectives, plan: _Plan, *,
                 warmup: bool = True, epoch: "MembershipEpoch | None" = None,
                 replan: Callable[[Any, str], _Plan] | None = None):
        self.ctx = ctx
        self.active: CollectiveRequest | None = None
        self.starts = 0
        self.rebuilds = 0
        self._closed = False
        self.epoch = epoch
        self._replan = replan
        self._epoch_version = epoch.version if epoch is not None else 0
        self._adopt(plan)
        if epoch is not None:
            epoch.register(self)
        debug.track_handle(self, "PersistentCollective")
        if warmup:
            self._warm()
            self.starts = 0          # the warm-up doesn't count

    def _adopt(self, plan: _Plan) -> None:
        self.plan = plan
        self.round_batch = plan.round_batch
        self.schedules = [rs.compiled(plan.round_batch)
                          for rs in plan.schedules]
        self._workspaces = [_Workspace() for _ in self.schedules]

    def _warm(self) -> None:
        mesh = self.plan.mesh
        if mesh is not None and mesh.per_device:
            k = self.plan.shape[0] // mesh.size
            zeros = RankShards(torch.zeros((k,) + self.plan.shape[1:],
                                           dtype=self.plan.dtype, device=d)
                               for d in mesh.devices)
        else:
            zeros = torch.zeros(self.plan.shape, dtype=self.plan.dtype,
                                device=mesh.device if mesh is not None
                                else None)
        self.start(zeros).wait(timeout=600)

    # -- introspection -----------------------------------------------------
    @property
    def op(self) -> str:
        return self.plan.op

    @property
    def algorithm(self) -> str:
        return self.plan.algorithm

    @property
    def num_chunks(self) -> int:
        return len(self.schedules)

    @property
    def dispatches_per_start(self) -> int:
        """Dispatch units one start costs (rounds after fusion)."""
        return sum(s.num_rounds for s in self.schedules)

    # -- lifecycle ---------------------------------------------------------
    def start(self, payload) -> CollectiveRequest:
        """MPI_Start: re-bind ``payload`` to the persistent schedule and
        issue.  Raises while the previous start is in flight.  When the
        collective stream is adopted by a running executor, this only
        enqueues a one-shot issue task; the adopting worker splits and
        dispatches round 0."""
        if self._closed:
            raise RuntimeError(f"{self!r} is closed")
        self.ctx._check_open()
        if self.epoch is not None and self._epoch_version != self.epoch.version:
            raise MembershipError(
                f"persistent {self.plan.op} handle is stale: built under "
                f"membership epoch {self._epoch_version}, current is "
                f"{self.epoch.version} ({self.epoch.n_devices} surviving "
                f"device(s)) — rebuild(mesh) before restarting",
                survivors=self.epoch.n_devices, version=self.epoch.version)
        active = self.active
        if active is not None and not active.is_complete:
            raise RuntimeError(
                f"persistent {self.plan.op} already has an active start "
                f"(MPI semantics: complete or cancel it before restarting)")
        if self.plan.shape is not None and hasattr(payload, "shape") \
                and tuple(payload.shape) != self.plan.shape:
            raise ValueError(
                f"persistent {self.plan.op} built for shape "
                f"{self.plan.shape}, got {tuple(payload.shape)}")
        if self.plan.dtype is not None and hasattr(payload, "dtype") \
                and payload.dtype != self.plan.dtype:
            raise ValueError(
                f"persistent {self.plan.op} built for dtype "
                f"{self.plan.dtype}, got {payload.dtype}")
        _check_form(payload, self.plan.mesh, self.plan.axis, self.plan.op)
        if active is not None and active.failed:
            # the dead start's queued rounds may still write its carries
            self._workspaces = [_Workspace() for _ in self.schedules]
        defer = self.ctx._adopting_executor() is not None
        req = self.ctx._issue(self.plan.op, self.plan.algorithm,
                              self.schedules,
                              lambda: self.plan.split(payload),
                              self.plan.join, defer=defer, payload=payload,
                              workspaces=self._workspaces)
        self.active = req
        self.starts += 1
        debug.handle_event(self, "start", kind="PersistentCollective",
                           complete_probe=lambda: True,
                           racing_invalidate=True)
        return req

    def cancel(self) -> None:
        """MPI_Cancel on the active start (no-op when idle/complete)."""
        if self.active is not None:
            self.active.cancel()

    # -- membership --------------------------------------------------------
    @property
    def stale(self) -> bool:
        return (self.epoch is not None
                and self._epoch_version != self.epoch.version)

    def _membership_changed(self, exc: "MembershipError") -> None:
        """Epoch invalidation: fail the in-flight start exactly once."""
        debug.handle_event(self, "invalidate", kind="PersistentCollective")
        req = self.active
        if req is None:
            return
        with req._fail_lock:
            if req.is_complete:
                return
            req.fail(exc)
        self.ctx.failed += 1

    def rebuild(self, mesh, axis: str | None = None, *,
                warmup: bool = False) -> "PersistentCollective":
        """Re-plan the same collective against ``mesh`` (the survivors)
        and adopt the current epoch generation.  Any incomplete start
        must be failed or cancelled first."""
        if self._closed:
            raise RuntimeError(f"{self!r} is closed")
        if self._replan is None:
            raise RuntimeError(
                f"persistent {self.plan.op} handle has no replan thunk "
                f"(constructed directly from a _Plan?) — build it via "
                f"UserCollectives.*_init to make it rebuildable")
        active = self.active
        if active is not None and not active.is_complete:
            raise RuntimeError(
                f"persistent {self.plan.op}: rebuild with a live start "
                f"in flight; cancel it (or let the epoch fail it) first")
        debug.handle_event(self, "rebuild", kind="PersistentCollective",
                           complete_probe=lambda: True)
        self._adopt(self._replan(mesh, axis if axis is not None
                                 else self.plan.axis))
        self.active = None
        self.rebuilds += 1
        if self.epoch is not None:
            self._epoch_version = self.epoch.version
        if warmup:
            self._warm()
            self.starts -= 1         # the warm-up doesn't count
        return self

    def close(self) -> None:
        """Release the handle: further starts raise."""
        debug.handle_event(self, "close", kind="PersistentCollective")
        self._closed = True
        self.active = None
        self._workspaces = []

    def __repr__(self):
        return (f"PersistentCollective({self.plan.op}/"
                f"{self.plan.algorithm}, shape={self.plan.shape}, "
                f"chunks={self.num_chunks}, "
                f"round_batch={self.round_batch}, starts={self.starts})")


# -- module-level convenience (one default context per engine) --------------

def default_collectives(engine: Optional[ProgressEngine] = None,
                        **kwargs) -> UserCollectives:
    eng = engine if engine is not None else global_engine()
    ctx = getattr(eng, "_user_collectives", None)
    if ctx is None or ctx._closed:
        ctx = UserCollectives(eng, **kwargs)
        eng._user_collectives = ctx
        return ctx
    # refuse to hand back a context configured differently from the ask
    if (("policy" in kwargs and kwargs["policy"] != ctx.queue.policy)
            or ("executor" in kwargs
                and kwargs["executor"] is not ctx.executor)
            or ("stream" in kwargs and kwargs["stream"] is not ctx.stream)):
        raise ValueError(
            f"engine already has a default UserCollectives "
            f"({ctx.name!r}: policy={ctx.queue.policy}, "
            f"executor={ctx.executor}) configured differently; close it "
            f"first or construct a UserCollectives explicitly")
    return ctx


def _default_ctx(engine, stream):
    if stream is not None:
        return default_collectives(engine, stream=stream)
    return default_collectives(engine)


# The canonical handle-factory shape (the p2p factories follow it too):
#
#     <op>_init(like, mesh, axis_name, *, spec=None, epoch=None,
#               stream=None, engine=None, warmup=True)

def iallreduce(x, mesh, axis: str, *, spec: CollectiveSpec | None = None,
               engine: Optional[ProgressEngine] = None,
               stream: Optional[Stream] = None,
               algorithm: str = "ring", chunks: int = 1,
               round_batch: int | None = None) -> CollectiveRequest:
    return _default_ctx(engine, stream).iallreduce(
        x, mesh, axis, algorithm=algorithm, chunks=chunks,
        round_batch=round_batch, spec=spec)


def ireduce_scatter(x, mesh, axis: str, *,
                    spec: CollectiveSpec | None = None,
                    engine: Optional[ProgressEngine] = None,
                    stream: Optional[Stream] = None,
                    algorithm: str = "ring", chunks: int = 1,
                    round_batch: int | None = None) -> CollectiveRequest:
    return _default_ctx(engine, stream).ireduce_scatter(
        x, mesh, axis, algorithm=algorithm, chunks=chunks,
        round_batch=round_batch, spec=spec)


def iallgather(x, mesh, axis: str, *, spec: CollectiveSpec | None = None,
               engine: Optional[ProgressEngine] = None,
               stream: Optional[Stream] = None,
               algorithm: str = "ring", chunks: int = 1,
               round_batch: int | None = None) -> CollectiveRequest:
    return _default_ctx(engine, stream).iallgather(
        x, mesh, axis, algorithm=algorithm, chunks=chunks,
        round_batch=round_batch, spec=spec)


def ialltoall(x, mesh, axis: str, *, spec: CollectiveSpec | None = None,
              engine: Optional[ProgressEngine] = None,
              stream: Optional[Stream] = None,
              chunks: int = 1,
              round_batch: int | None = None) -> CollectiveRequest:
    return _default_ctx(engine, stream).ialltoall(
        x, mesh, axis, chunks=chunks, round_batch=round_batch, spec=spec)


def allreduce_init(x, mesh, axis: str, *,
                   spec: CollectiveSpec | None = None,
                   epoch: "MembershipEpoch | None" = None,
                   stream: Optional[Stream] = None,
                   engine: Optional[ProgressEngine] = None,
                   algorithm: str = "ring", chunks: int = 1,
                   round_batch: int | None = None,
                   warmup: bool = True) -> PersistentCollective:
    return _default_ctx(engine, stream).allreduce_init(
        x, mesh, axis, algorithm=algorithm, chunks=chunks,
        round_batch=round_batch, spec=spec, warmup=warmup, epoch=epoch)


def reduce_scatter_init(x, mesh, axis: str, *,
                        spec: CollectiveSpec | None = None,
                        epoch: "MembershipEpoch | None" = None,
                        stream: Optional[Stream] = None,
                        engine: Optional[ProgressEngine] = None,
                        algorithm: str = "ring", chunks: int = 1,
                        round_batch: int | None = None,
                        warmup: bool = True) -> PersistentCollective:
    return _default_ctx(engine, stream).reduce_scatter_init(
        x, mesh, axis, algorithm=algorithm, chunks=chunks,
        round_batch=round_batch, spec=spec, warmup=warmup, epoch=epoch)


def allgather_init(x, mesh, axis: str, *,
                   spec: CollectiveSpec | None = None,
                   epoch: "MembershipEpoch | None" = None,
                   stream: Optional[Stream] = None,
                   engine: Optional[ProgressEngine] = None,
                   algorithm: str = "ring", chunks: int = 1,
                   round_batch: int | None = None,
                   warmup: bool = True) -> PersistentCollective:
    return _default_ctx(engine, stream).allgather_init(
        x, mesh, axis, algorithm=algorithm, chunks=chunks,
        round_batch=round_batch, spec=spec, warmup=warmup, epoch=epoch)


def alltoall_init(x, mesh, axis: str, *,
                  spec: CollectiveSpec | None = None,
                  epoch: "MembershipEpoch | None" = None,
                  stream: Optional[Stream] = None,
                  engine: Optional[ProgressEngine] = None,
                  chunks: int = 1,
                  round_batch: int | None = None,
                  warmup: bool = True) -> PersistentCollective:
    return _default_ctx(engine, stream).alltoall_init(
        x, mesh, axis, chunks=chunks,
        round_batch=round_batch, spec=spec, warmup=warmup, epoch=epoch)
