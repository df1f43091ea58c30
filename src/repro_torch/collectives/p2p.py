"""User-space nonblocking point-to-point on the progress engine (the port
of the JAX package's ``collectives/p2p.py``).

MPI's point-to-point layer — ``isend``/``irecv`` pairs and persistent
``Send_init``/``Recv_init`` channels — as **single-hop rounds** on the
collectives' ``_RoundSchedule``/``_Plan`` machinery.

Single-controller matching.  Every rank's message lives in one
rank-stacked ``[n, ...]`` payload (rank s's in row s); one ring hop
moves row s to row s+1, so the hop *is* the rendezvous — but the MPI
halves still exist as separate handles:

* ``isend(x, ...)`` posts the send half: it issues the hop at once when
  a matching receive is posted, else parks on the pending-send queue
  (MPI's unexpected-message queue).  Its handle completes (value None)
  when the transfer has retired.
* ``irecv(like, ...)`` posts the receive half; its handle completes with
  the received stacked tensor.

On a mesh with one device per rank (``launch.mesh``) the payload is a
``RankShards`` of each rank's ``[1, ...]`` row on its device, and the hop
copies row s onto rank s+1's device (``schedules.ring_shift``): the
received value is a ``RankShards`` likewise, equal to the stacked hop's
rows bit for bit.  A persistent channel's hop allocates only its result,
on each rank's device; it keeps no carry, so its workspaces stay empty.

Matching is FIFO per ``(mesh, axis, tag, direction, partition)`` — the
non-overtaking rule.  ``partition`` names how the trailing dims are
laid out (the JAX package's payload ``PartitionSpec``); on the port's
one-device mesh it places nothing and only takes part in matching.

Persistent channels: ``send_init``/``recv_init`` return the two views of
one :class:`P2PChannel`, whose hop rides a
:class:`~repro_torch.collectives.nonblocking.PersistentCollective`
(executor-driven starts, one outstanding start, membership awareness:
epoch invalidation fails the in-flight hop retryably and the channel
refuses starts until ``rebuild(mesh)``).
"""
from __future__ import annotations

import collections
import threading
import warnings
from typing import Any, Optional

from repro_torch.collectives import nonblocking as NB
from repro_torch.collectives import schedules as S
from repro_torch.collectives.nonblocking import (CollectiveRequest,
                                                 MembershipEpoch,
                                                 PersistentCollective,
                                                 UserCollectives, _Plan,
                                                 _identity_schedule,
                                                 _payload_bytes)
from repro_torch.core import debug


def _hop_schedule(n: int, reverse: bool):
    """Single ring hop (forward: rank i -> i+1), from the shared schedule
    cache.  Its output is a fresh tensor: the hop's result."""
    def build():
        d = -1 if reverse else 1
        return NB._RoundSchedule([NB._RoundStage(
            lambda v, ws: S.ring_shift(v, d))])

    return NB._cached(("p2p_hop", n, reverse), build)


def _plan_sendrecv(mesh, axis: str, shape, dtype, *,
                   reverse: bool = False) -> _Plan:
    """Issue-invariant plan for one matched send/recv hop; ``shape`` is the
    stacked ``[n, ...]`` shape (a ``RankShards`` payload's ``shape``)."""
    n = NB._axis_len(mesh, axis)
    if len(shape) < 1 or shape[0] != n:
        raise ValueError(
            f"p2p payload must stack one slice per rank: leading dim "
            f"{shape[0] if shape else '?'} != axis size {n} "
            f"(shape {tuple(shape)})")
    nbytes = _payload_bytes(shape, dtype)
    sched = _identity_schedule() if n == 1 else _hop_schedule(n, reverse)
    return _Plan("sendrecv", "ring_hop" + ("-" if reverse else "+"),
                 tuple(shape), dtype, mesh, axis, [sched],
                 lambda x: [x], NB._first, nbytes, 1)


# ---------------------------------------------------------------------------
# Persistent channels (MPI Send_init / Recv_init + Start)
# ---------------------------------------------------------------------------

class PersistentSend:
    """Send view of a :class:`P2PChannel` (MPI ``Send_init``)."""

    __slots__ = ("channel",)

    def __init__(self, channel: "P2PChannel"):
        self.channel = channel

    def start(self, payload) -> CollectiveRequest:
        """MPI_Start on the send half; completes when the transfer has
        retired (buffer reusable)."""
        return self.channel._start_send(payload)

    @property
    def starts(self) -> int:
        return self.channel.starts

    def close(self) -> None:
        self.channel.close()


class PersistentRecv:
    """Receive view of a :class:`P2PChannel` (MPI ``Recv_init``)."""

    __slots__ = ("channel",)

    def __init__(self, channel: "P2PChannel"):
        self.channel = channel

    def start(self) -> CollectiveRequest:
        """MPI_Start on the receive half: completes with the received
        stacked tensor, matching the channel's hops FIFO."""
        return self.channel._start_recv()

    @property
    def starts(self) -> int:
        return self.channel.recv_starts

    def close(self) -> None:
        self.channel.close()


class P2PChannel:
    """One persistent matched send/recv pair over a fixed-shape hop,
    wrapping a :class:`PersistentCollective` built from the single-hop
    plan; send starts and recv starts match FIFO."""

    def __init__(self, ctx: "P2P", plan: _Plan, *, warmup: bool = True,
                 epoch: "MembershipEpoch | None" = None):
        # on rebuild the stacked leading dim follows the survivors' axis
        # length, so only the trailing message shape carries over
        replan = lambda m, a: _plan_sendrecv(          # noqa: E731
            m, a, (NB._axis_len(m, a),) + plan.shape[1:], plan.dtype,
            reverse=plan.algorithm.endswith("-"))
        self.ctx = ctx
        self.persistent = PersistentCollective(
            ctx, plan, warmup=warmup,
            epoch=epoch if epoch is not None else ctx.epoch, replan=replan)
        self.send = PersistentSend(self)
        self.recv = PersistentRecv(self)
        self.starts = 0
        self.recv_starts = 0
        self._lock = threading.Lock()
        # hops issued but not yet claimed by a recv start / recvs posted
        # before their hop — the two MPI matching queues, channel-local
        self._unclaimed: collections.deque = collections.deque()
        self._waiting: collections.deque = collections.deque()
        debug.track_handle(self, "P2PChannel")

    @property
    def stale(self) -> bool:
        return self.persistent.stale

    def _start_send(self, payload) -> CollectiveRequest:
        hop = self.persistent.start(payload)
        self.starts += 1
        sreq = self.ctx._overlay_request("send")
        with self._lock:
            rreq = self._waiting.popleft() if self._waiting else None
            if rreq is None:
                self._unclaimed.append(hop)
        self.ctx._wire_pair(hop, sreq, rreq)
        return sreq

    def _start_recv(self) -> CollectiveRequest:
        debug.handle_check_open(self, "recv.start", kind="P2PChannel")
        rreq = self.ctx._overlay_request("recv")
        self.recv_starts += 1
        with self._lock:
            hop = self._unclaimed.popleft() if self._unclaimed else None
            if hop is None:
                self._waiting.append(rreq)
        if hop is not None:
            self.ctx._wire_pair(hop, None, rreq)
        return rreq

    def cancel(self) -> None:
        self.persistent.cancel()

    def rebuild(self, mesh, axis: str | None = None, *,
                warmup: bool = False) -> "P2PChannel":
        """Adopt the survivors' mesh after a membership change; unmatched
        halves from the dead epoch are dropped."""
        self.persistent.rebuild(mesh, axis, warmup=warmup)
        debug.handle_event(self, "rebuild", kind="P2PChannel",
                           complete_probe=lambda: True)
        with self._lock:
            self._unclaimed.clear()
            self._waiting.clear()
        return self

    def close(self) -> None:
        debug.handle_event(self, "close", kind="P2PChannel")
        self.persistent.close()

    def __repr__(self):
        return (f"P2PChannel({self.persistent.plan.algorithm}, "
                f"shape={self.persistent.plan.shape}, "
                f"starts={self.starts})")


# ---------------------------------------------------------------------------
# The p2p issue context
# ---------------------------------------------------------------------------

def _resolve_spec_partition(spec, partition):
    """Normalize the p2p kwarg pair to (CollectiveSpec, partition).

    ``spec=`` takes a :class:`CollectiveSpec` like every other factory;
    a partition (a tuple of axis names) passed there still works, with a
    once-per-process DeprecationWarning.  Of a CollectiveSpec only the
    backend matters for a single hop, and ``native`` is refused."""
    if spec is not None and not isinstance(spec, NB.CollectiveSpec):
        if "P2P.spec" not in NB._legacy_kwargs_warned:
            NB._legacy_kwargs_warned.add("P2P.spec")
            warnings.warn(
                "p2p spec= now takes a CollectiveSpec like every other "
                "collective factory; pass the payload partition as "
                "partition= (the old spelling works one more release)",
                DeprecationWarning, stacklevel=4)
        if partition is None:
            partition = spec
        spec = None
    if spec is not None and not spec.user:
        raise ValueError(
            "p2p channels run on the user backend only; got "
            f"spec.backend={spec.backend!r}")
    return spec, partition


def _partition_key(partition):
    return None if partition is None else tuple(partition)


class P2P(UserCollectives):
    """Issue context for user-space nonblocking point-to-point: the
    :class:`UserCollectives` stream, queue, counters and lifecycle, plus
    ``isend``/``irecv`` matched pairs and persistent channels.

    Extra counters: ``sends``/``recvs`` (halves posted), ``matched``
    (pairs that met), ``unexpected`` (sends posted before their
    receive)."""

    def __init__(self, engine=None, *, executor=None, stream=None,
                 policy: str = NB.INLINE, name: str = "",
                 epoch: "MembershipEpoch | None" = None):
        super().__init__(engine, executor=executor, stream=stream,
                         policy=policy, name=name or "p2p", epoch=epoch)
        self._match_lock = threading.Lock()
        self._pending_sends: dict = {}
        self._posted_recvs: dict = {}
        self._channels: dict = {}
        self.sends = 0
        self.recvs = 0
        self.matched = 0
        self.unexpected = 0

    # -- one-shot matched pairs -------------------------------------------
    def isend(self, x, mesh, axis: str, *, tag: Any = 0,
              reverse: bool = False, spec=None,
              partition=None) -> CollectiveRequest:
        """Post the send half: ``x`` is the stacked ``[n, ...]`` payload;
        each rank's row ships one hop along the ring.  The hop issues
        when the matching ``irecv`` is posted — in either order."""
        self._check_open()
        NB._check_form(x, mesh, axis, "send")
        spec, partition = _resolve_spec_partition(spec, partition)
        key = (mesh, axis, tag, bool(reverse), _partition_key(partition))
        sreq = self._overlay_request("send")
        self.sends += 1
        with self._match_lock:
            recvs = self._posted_recvs.get(key)
            rreq = recvs.popleft() if recvs else None
            if rreq is None:
                self._pending_sends.setdefault(
                    key, collections.deque()).append((x, sreq))
                self.unexpected += 1
        if rreq is not None:
            self._match(key, x, sreq, rreq)
        return sreq

    def irecv(self, like, mesh, axis: str, *, tag: Any = 0,
              reverse: bool = False, spec=None,
              partition=None) -> CollectiveRequest:
        """Post the receive half (``like`` fixes shape/dtype).  Completes
        with the received stacked tensor (row i+1 = what rank i sent)."""
        self._check_open()
        del like  # shape/dtype ride with the send payload
        spec, partition = _resolve_spec_partition(spec, partition)
        key = (mesh, axis, tag, bool(reverse), _partition_key(partition))
        rreq = self._overlay_request("recv")
        self.recvs += 1
        with self._match_lock:
            sends = self._pending_sends.get(key)
            pair = sends.popleft() if sends else None
            if pair is None:
                self._posted_recvs.setdefault(
                    key, collections.deque()).append(rreq)
        if pair is not None:
            x, sreq = pair
            self._match(key, x, sreq, rreq)
        return rreq

    def sendrecv(self, x, mesh, axis: str, *, reverse: bool = False,
                 spec=None, partition=None) -> CollectiveRequest:
        """One-shot fused pair: issue the hop now, return the receive
        handle."""
        self._check_open()
        NB._check_form(x, mesh, axis, "sendrecv")
        _resolve_spec_partition(spec, partition)
        plan = _plan_sendrecv(mesh, axis, tuple(x.shape), NB._dtype_of(x),
                              reverse=reverse)
        return self._issue_plan(plan, x)

    # -- persistent channels ----------------------------------------------
    def channel_init(self, like, mesh, axis: str, *, tag: Any = 0,
                     reverse: bool = False, spec=None, partition=None,
                     warmup: bool = True,
                     epoch: "MembershipEpoch | None" = None) -> P2PChannel:
        """Build (or fetch) the persistent channel for this signature;
        ``send_init`` and ``recv_init`` with the same signature return
        views of the same channel — that is the match."""
        self._check_open()
        spec, partition = _resolve_spec_partition(spec, partition)
        shape = tuple(like.shape)
        dtype = NB._dtype_of(like)
        key = (mesh, axis, tag, bool(reverse), _partition_key(partition),
               shape, dtype)
        chan = self._channels.get(key)
        if chan is None:
            plan = _plan_sendrecv(mesh, axis, shape, dtype, reverse=reverse)
            chan = P2PChannel(self, plan, warmup=warmup, epoch=epoch)
            self._channels[key] = chan
        return chan

    def send_init(self, like, mesh, axis: str, *, tag: Any = 0,
                  reverse: bool = False, spec=None, partition=None,
                  warmup: bool = True,
                  epoch: "MembershipEpoch | None" = None) -> PersistentSend:
        """MPI ``Send_init``: persistent send half for payloads like
        ``like``."""
        return self.channel_init(like, mesh, axis, tag=tag, reverse=reverse,
                                 spec=spec, partition=partition,
                                 warmup=warmup, epoch=epoch).send

    def recv_init(self, like, mesh, axis: str, *, tag: Any = 0,
                  reverse: bool = False, spec=None, partition=None,
                  warmup: bool = True,
                  epoch: "MembershipEpoch | None" = None) -> PersistentRecv:
        """MPI ``Recv_init``: the matching persistent receive half."""
        return self.channel_init(like, mesh, axis, tag=tag, reverse=reverse,
                                 spec=spec, partition=partition,
                                 warmup=warmup, epoch=epoch).recv

    # -- machinery ---------------------------------------------------------
    def _overlay_request(self, op: str) -> CollectiveRequest:
        """A send/recv handle overlaying a hop request."""
        return CollectiveRequest(self.engine, self.stream, self.queue, op,
                                 "ring_hop", 1, 1, ctx=self)

    def _match(self, key, x, sreq, rreq) -> None:
        mesh, axis, _tag, reverse, _pk = key
        self.matched += 1
        try:
            plan = _plan_sendrecv(mesh, axis, tuple(x.shape),
                                  NB._dtype_of(x), reverse=reverse)
            hop = self._issue_plan(plan, x)
        except BaseException as exc:  # noqa: BLE001
            for req in (sreq, rreq):
                self._fail_overlay(req, exc)
            return
        self._wire_pair(hop, sreq, rreq)

    def _wire_pair(self, hop: CollectiveRequest,
                   sreq: Optional[CollectiveRequest],
                   rreq: Optional[CollectiveRequest]) -> None:
        """Complete the overlay handles off the hop's completion (send
        with None, receive with the hopped tensor); a failure reaches
        both."""

        def _done(h):
            if rreq is not None:
                self._complete_overlay(rreq, h.value())
            if sreq is not None:
                self._complete_overlay(sreq, None)

        def _err(h):
            exc = h.exception or RuntimeError("p2p hop failed")
            for req in (sreq, rreq):
                if req is not None:
                    self._fail_overlay(req, exc)

        self.queue.attach(hop, _done, on_error=_err)

    @staticmethod
    def _complete_overlay(req: CollectiveRequest, value) -> None:
        with req._fail_lock:
            if not req.is_complete:
                req.rounds_done = 1
                req.complete(value)

    @staticmethod
    def _fail_overlay(req: CollectiveRequest, exc: BaseException) -> None:
        with req._fail_lock:
            if not req.is_complete:
                req.fail(exc)

    def close(self, *, drain: bool = True,
              timeout: float | None = 30.0) -> None:
        for chan in self._channels.values():
            chan.close()
        super().close(drain=drain, timeout=timeout)


def default_p2p(engine=None, *, executor=None, **kw) -> P2P:
    """Module-default p2p context (one per engine)."""
    eng = engine if engine is not None else NB.global_engine()
    ctx = getattr(eng, "_default_p2p", None)
    if ctx is None or ctx._closed:
        ctx = P2P(eng, executor=executor, **kw)
        eng._default_p2p = ctx
    return ctx


# Canonical module-level factories (the *_init shape of nonblocking).

def channel_init(like, mesh, axis: str, *, spec=None, tag: Any = 0,
                 reverse: bool = False, partition=None, warmup: bool = True,
                 epoch: "MembershipEpoch | None" = None, stream=None,
                 engine=None) -> P2PChannel:
    """Persistent matched send/recv channel on the default p2p context
    (``spec``: a user-backend ``CollectiveSpec``)."""
    ctx = default_p2p(engine, stream=stream) if stream is not None \
        else default_p2p(engine)
    return ctx.channel_init(like, mesh, axis, tag=tag, reverse=reverse,
                            spec=spec, partition=partition, warmup=warmup,
                            epoch=epoch)


def send_init(like, mesh, axis: str, *, spec=None, tag: Any = 0,
              reverse: bool = False, partition=None, warmup: bool = True,
              epoch: "MembershipEpoch | None" = None, stream=None,
              engine=None) -> PersistentSend:
    """MPI ``Send_init`` on the default p2p context."""
    return channel_init(like, mesh, axis, spec=spec, tag=tag, reverse=reverse,
                        partition=partition, warmup=warmup, epoch=epoch,
                        stream=stream, engine=engine).send


def recv_init(like, mesh, axis: str, *, spec=None, tag: Any = 0,
              reverse: bool = False, partition=None, warmup: bool = True,
              epoch: "MembershipEpoch | None" = None, stream=None,
              engine=None) -> PersistentRecv:
    """MPI ``Recv_init`` on the default p2p context."""
    return channel_init(like, mesh, axis, spec=spec, tag=tag, reverse=reverse,
                        partition=partition, warmup=warmup, epoch=epoch,
                        stream=stream, engine=engine).recv
