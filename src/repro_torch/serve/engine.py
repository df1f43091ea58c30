"""Event-driven continuous-batching server on the progress engine.

Serving is the dynamic side of the paper's story: requests arrive at
arbitrary times (the "unexpected message queue" of MPI has no SPMD
analogue — this layer is it).  The whole request lifecycle is
completion-driven — there is no polling loop anywhere in this file:

* ``submit``            — the *arrival event* schedules a one-shot
  admission task on the admit stream (none is scheduled while idle);
* admission / prefill   — admits arrivals into free paged-KV lanes
  (blocks + lane claimed atomically) and runs one chunk of batched
  prefill, then schedules the first decode step;
* decode                — one fused decode step for ALL active slots
  (continuous batching) is dispatched to the card; a CUDA event recorded
  after it is watched by a one-shot readiness task (``event.query()``,
  never a synchronize) that completes a per-step ``Request``;
* detokenize            — a continuation attached to the step request:
  reads the greedy tokens, finishes requests (their ``done_req``
  completes, firing any client continuations), and *chains the next
  decode step* — each stage's completion schedules the next;
* slot-free event       — finishing requests re-schedules admission, so
  a backlog drains exactly when capacity appears.

Between requests every serve stream is empty: no perpetual task spins,
no idle polling — the paper's event-driven integration claim (§4.6).

The continuation execution policy is a knob (``continuation_policy``):
``INLINE`` runs detokenize on the progress thread that observed decode
completion; ``DEFERRED`` (default) queues it and the owner drains with
``continuation_max_drain`` as bounded backpressure.  With a
``ProgressExecutor`` the serve streams are adopted by its workers and a
deferred queue is drained by them between polls; without one, a cheap
subsystem bridges streams + continuation drain into every
``engine.progress()`` call, so the classic ``while: engine.progress()``
loop still serves traffic.

**Model-axis sharding + serve-side collectives.**  With a ``mesh`` the
decode step is tensor-parallel on the output projection, as in the JAX
package's ``serve/engine.py``.  The mesh is the port's single-controller
one: its n model-axis ranks share one device.  Every JAX rank runs the
same ``decode_hidden_paged`` over the replicated params and pool, so the
port runs it once; then ``unembed_ranks`` computes every rank's
vocabulary slice as one batched product, the rank-stacked partial logits
``[n, B, V/n]``.  The full logits are the rank-order all-gather of that
activation, ``[n, B, V]`` with every row the whole vocabulary, two ways:

* ``collective_spec.backend="native"`` — a gather over the rank dim on
  the compute stream;
* ``collective_spec.backend="user"`` — a **persistent user-space
  all-gather** (``allgather_init``/``start``) on a dedicated
  serve-collective stream.  Decode's shapes are fixed, so the handle is
  built and warmed once; every step is a ``start(partial)`` re-bind
  whose completion feeds the detokenize continuation.  The gather rounds
  are driven by the progress engine while the host stays free for the
  admission and prefill of new arrivals; with an executor the ``start``
  itself is executor-driven.

Both sharded paths consume the same partial logits, so their greedy
token streams are identical.  The greedy ids come from row 0, and the
first gathered step of an engine checks that every row equals row 0.

**A device per rank.**  On a mesh built with ``devices=[...]`` each
model-axis rank holds a replica of the weights (cast once) and of the
paged pool on its own device, as every JAX device holds the replicated
params and pool: for each rank ``r``, with its device current, the step
runs ``decode_hidden_paged`` on replica ``r`` and pool ``r`` and then
``unembed_partial`` at offset ``r·V/n`` (the JAX ``local_step``), giving
a ``RankShards`` of ``[1, B, V/n]`` partial logits.  The gather is the
per-device ``allgather_shards`` (copies between the devices on their
compute streams) or the persistent user-space all-gather built on that
mesh; the greedy ids come from rank 0's row, and the step's readiness is
an event on each device.  A rebuild takes the first surviving devices
and restores resident lanes into every survivor's pool; a lone survivor
serves unsharded on the first device.

**Membership.**  With an ``epoch`` (a ``MembershipEpoch`` shared with the
heartbeat monitor, the step watchdog and the persistent all-gather) a
membership change fails the step, not the requests.  The epoch's
listener only records the change; the admit path then drains, closes
the old handle, checkpoints each decoding lane's KV prefix and per-lane
state to the host (``PagedKVCache.checkpoint_lane``), rebuilds the mesh,
the pool and the handle on the survivors (a lone survivor serves
unsharded) and re-admits the residents with their KV restored rather
than replayed.  Mid-prefill lanes replay.  The port writes the decode
state in place, so a step that failed at its gather has already
advanced it: dense lanes stay consistent (a checkpoint reads positions
``0..pos-1`` only, and the replayed token rewrites ``pos``), but lanes
with per-lane recurrent state (the ssm family) hold the failed step's
token, and those replay instead of restoring.
"""
from __future__ import annotations

import collections
import dataclasses
import statistics
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.collectives.nonblocking import (CollectiveSpec,
                                                 MembershipError,
                                                 UserCollectives,
                                                 spec_from_legacy)
from repro_torch.collectives.rank_shards import (RankShards, device_context,
                                                 tree_keep, tree_shard,
                                                 tree_stack)
from repro_torch.core import DEFERRED, DONE, ProgressEngine, Request
from repro_torch.core import debug
from repro_torch.core.continuations import POLICIES, ContinuationQueue
from repro_torch.core.executor import ProgressExecutor
from repro_torch.core.futures import torch_future
from repro_torch.core.stats import SchedulerStats
from repro_torch.models import registry
from repro_torch.models.layers import tree_map
from repro_torch.serve.kvcache import PagedKVCache


@dataclasses.dataclass
class GenRequest:
    request_id: str
    prompt: np.ndarray               # [prompt_len] int32
    max_new_tokens: int = 16
    out_tokens: list = dataclasses.field(default_factory=list)
    done_req: Request = dataclasses.field(default_factory=Request)
    slot_index: int = -1
    next_input: int = 0            # next token to feed the fused decode
    submitted_at: float = dataclasses.field(default_factory=time.monotonic)
    # stamped exactly once, by the detokenize continuation of the first
    # decode step that produced a token for this request; stays None for
    # requests that fail before their first token (TTFT must not count
    # them — see ServeLatencyStats.no_first_token)
    first_token_at: float | None = None
    finished_at: float | None = None
    # -- continuous-batching bookkeeping (paged cache mode) ----------------
    # replay = prompt + generated prefix: what prefill must rebuild in the
    # KV cache.  Set at first admission; recomputed at preemption so a
    # re-admitted request resumes its exact token stream (greedy decode is
    # per-lane deterministic — same replay ⇒ same continuation).
    replay: Optional[np.ndarray] = None
    prefill_pos: int = 0           # replay tokens already fed this residency
    preemptions: int = 0           # times evicted under block pressure
    seq: int = 0                   # submit order; the scheduler never
    #                                preempts the oldest resident
    queued_s: float = 0.0          # total backlog wait across (re)admissions
    last_enqueued_at: float = 0.0
    # membership change: host-side snapshot of the lane's KV prefix +
    # per-lane state (PagedKVCache.checkpoint_lane), carried through the
    # backlog so re-admission on the rebuilt mesh restores instead of
    # replaying the whole prefix; None = replay from tokens
    kv_ckpt: Optional[dict] = None


class _BucketBacklog:
    """Length-bucketed FIFO backlog (power-of-two length buckets).

    Admission drains buckets in order of their oldest member, so requests
    of similar length are admitted together (their prefills retire
    together and lanes churn less — the classic bucket-by-length batching
    idiom), while one bucket's over-long head cannot starve the others:
    ``pop_fitting`` falls through to the next bucket when a head does not
    fit the free pool.  Within a bucket order is by submit ``seq``, so a
    preempted request re-enters ahead of younger arrivals and is retried
    first once blocks free up.
    """

    def __init__(self):
        self._buckets: dict[int, collections.deque] = {}

    @staticmethod
    def bucket_of(length: int) -> int:
        return max(1, int(length)).bit_length()

    def push(self, req: GenRequest) -> None:
        dq = self._buckets.setdefault(self.bucket_of(len(req.replay)),
                                      collections.deque())
        if not dq or req.seq >= dq[-1].seq:
            dq.append(req)
        elif req.seq <= dq[0].seq:
            dq.appendleft(req)
        else:                       # rare: mid-deque re-admission
            items = sorted([*dq, req], key=lambda r: r.seq)
            dq.clear()
            dq.extend(items)

    def pop_fitting(self, fits):
        """First (oldest-bucket-first) request for which ``fits(req)``
        returns a lane; ``(None, None)`` when nothing fits."""
        order = sorted((dq for dq in self._buckets.values() if dq),
                       key=lambda dq: dq[0].seq)
        for dq in order:
            lane = fits(dq[0])
            if lane is not None:
                return dq.popleft(), lane
        return None, None

    def drain(self) -> list:
        out = []
        for dq in self._buckets.values():
            out.extend(dq)
            dq.clear()
        out.sort(key=lambda r: r.seq)
        return out

    def __len__(self) -> int:
        return sum(len(dq) for dq in self._buckets.values())


def allgather_shards(parts: RankShards) -> RankShards:
    """The native all-gather of per-device partial logits (shard ``r``
    ``[1, B, w]`` on rank ``r``'s device) -> shard ``r`` ``[1, B, n·w]``,
    the rank-order concatenation of every rank's slice on rank ``r``'s
    device: copies between the devices, ordered on both devices' current
    (compute) streams."""
    out = []
    for d in parts.devices:
        with device_context(d):
            out.append(torch.cat([p.to(d) for p in parts.shards], dim=-1))
    return RankShards(out, replica=True)


def allgather_ranks(part: torch.Tensor) -> torch.Tensor:
    """The native all-gather of rank-stacked partial logits: ``[n, B, w]``
    -> ``[n, B, n·w]``, row r the rank-order concatenation of every
    rank's slice — one gather over the rank dim."""
    n, B, w = part.shape
    idx = torch.arange(n, device=part.device).repeat(n)
    return (part.index_select(0, idx).view(n, n, B, w)
            .permute(0, 2, 1, 3).reshape(n, B, n * w))


def _replicas(cfg, params, devices):
    """A replica of the weights on each of ``devices``, each cast to the
    compute dtype there (a ``RankShards`` replica per leaf)."""
    out = []
    for d in devices:
        with device_context(d):
            out.append(registry.cast_params(
                cfg, tree_map(lambda t: t.to(d, copy=True), params)))
    return tree_stack(out, replica=True)


def _quantiles(samples_ms: list[float]) -> tuple[float, float, float]:
    mean = statistics.fmean(samples_ms)
    s = sorted(samples_ms)
    p50 = s[len(s) // 2]
    p99 = s[min(int(0.99 * len(s)), len(s) - 1)]
    return mean, p50, p99


@dataclasses.dataclass
class ServeLatencyStats:
    """Request-latency snapshot (``ServeEngine.latency_snapshot``).

    TTFT aggregates cover only requests that produced a first token;
    ``no_first_token`` counts the ones that finished (failed) without —
    they are excluded from TTFT rather than silently dropped from the
    ledger.  Latency aggregates cover every finished request.  Queue-time
    aggregates cover time spent waiting in the backlog (summed across
    re-admissions for preempted requests); ``preempted``/``preemptions``
    count requests evicted under block pressure and total evictions."""
    submitted: int = 0
    completed: int = 0
    failed: int = 0
    no_first_token: int = 0          # finished without a first token
    preempted: int = 0               # finished requests evicted >= once
    preemptions: int = 0             # total evictions over those requests
    ttft_ms_mean: float | None = None
    ttft_ms_p50: float | None = None
    ttft_ms_p99: float | None = None
    latency_ms_mean: float | None = None
    latency_ms_p50: float | None = None
    latency_ms_p99: float | None = None
    queued_ms_mean: float | None = None
    queued_ms_p50: float | None = None
    queued_ms_p99: float | None = None

    def format(self) -> str:
        def f(v):
            return f"{v:.1f}" if v is not None else "n/a"
        return (f"requests: {self.submitted} submitted, "
                f"{self.completed} completed, {self.failed} failed "
                f"({self.no_first_token} without first token, "
                f"{self.preempted} preempted {self.preemptions}x); "
                f"TTFT ms mean/p50/p99 {f(self.ttft_ms_mean)}/"
                f"{f(self.ttft_ms_p50)}/{f(self.ttft_ms_p99)}; "
                f"latency ms mean/p50/p99 {f(self.latency_ms_mean)}/"
                f"{f(self.latency_ms_p50)}/{f(self.latency_ms_p99)}; "
                f"queued ms mean/p50/p99 {f(self.queued_ms_mean)}/"
                f"{f(self.queued_ms_p50)}/{f(self.queued_ms_p99)}")


class ServeEngine:
    def __init__(self, cfg, params, engine: ProgressEngine,
                 batch_slots: int = 8, max_seq: int = 512,
                 executor: Optional[ProgressExecutor] = None,
                 continuation_policy: str = DEFERRED,
                 continuation_max_drain: int = 64,
                 mesh=None, model_axis: str = "model",
                 collective_spec: CollectiveSpec | None = None,
                 collective_backend: str | None = None,
                 collective_chunks: int | None = None,
                 collective_round_batch: int | None = None,
                 cache_mode: str = "paged",
                 kv_block_size: int = 16,
                 kv_blocks: int | None = None,
                 prefill_chunk: int = 8,
                 epoch=None,
                 device=None):
        if continuation_policy not in POLICIES:
            raise ValueError(f"continuation_policy must be one of {POLICIES}")
        spec = spec_from_legacy(collective_spec, surface="ServeEngine",
                                backend=collective_backend,
                                chunks=collective_chunks,
                                round_batch=collective_round_batch)
        if spec.user and mesh is None:
            # silently serving the plain path while the operator believes
            # they exercised user-space collectives is worse than an
            # eager error
            raise ValueError("collective backend 'user' requires a mesh "
                             "(model-axis-sharded decode)")
        if cache_mode == "slots":
            raise ValueError(
                "cache_mode='slots' was retired, as in the JAX engine: "
                "the engine serves from the paged pool only (paged is "
                "strictly more capable — same bytes, block granularity; "
                "SlotCache and registry.decode_step remain for direct "
                "use).  Drop the kwarg, or size the pool with "
                "kv_block_size/kv_blocks to mimic fixed lanes "
                "(kv_blocks = batch_slots * max_seq // kv_block_size + 1)")
        if cache_mode != "paged":
            raise ValueError("cache_mode must be 'paged'")
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{prefill_chunk}")
        per_device = mesh is not None and mesh.per_device
        if per_device:
            if device is not None:
                raise ValueError(f"{mesh!r} has a device per rank: the "
                                 f"engine takes no device= beside it")
            device = mesh.devices[0]
        elif mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"device {mesh.device}")
            device = mesh.device
        self.cfg = cfg
        self.device = resolve_device(device)
        self.slots = PagedKVCache(cfg, batch_slots, max_seq,
                                  block_size=kv_block_size,
                                  num_blocks=kv_blocks, mesh=mesh,
                                  device=None if per_device else self.device)
        # weights move to the device (each rank's device) and take the
        # compute dtype once, here
        if per_device:
            self.params = _replicas(cfg, params, mesh.devices)
        else:
            self.params = registry.cast_params(
                cfg, tree_map(lambda t: t.to(self.device), params))
        self.engine = engine
        self.executor = executor
        self.mesh = mesh
        self.model_axis = model_axis
        self.collective_spec = spec
        self._sharded = mesh is not None
        self._model_shards = 1
        self.batch_slots = batch_slots
        self.max_seq = max_seq
        self.prefill_chunk = prefill_chunk
        # retained for elastic rebuilds (_rebuild_for_survivors)
        self._kv_block_size = kv_block_size
        self._kv_blocks = kv_blocks
        self._arrivals: collections.deque[GenRequest] = collections.deque()
        self._active: dict[int, GenRequest] = {}
        # paged continuous batching: requests waiting for blocks/lanes,
        # and lanes whose prompt replay is mid-prefill (chunked — prefill
        # interleaves with decode steps instead of blocking them)
        self._backlog = _BucketBacklog()
        self._prefilling: dict[int, GenRequest] = {}
        self._seq = 0                  # submit-order stamp (preemption policy)
        self.sched = SchedulerStats()
        # one lock serialises admission/prefill against detokenize: the
        # stages may run on different executor workers, but KV cache and
        # slot state are shared.  Prefill itself runs OUTSIDE the lock
        # (no step is in flight meanwhile) so submit() and the detokenize
        # path never block behind a token-by-token prompt loop.
        self._lock = debug.make_lock("ServeEngine._lock")
        self._decode_inflight = None
        self._current_step = None      # the step whose continuation owns state
        self._admit_scheduled = False
        self._prefill_active = False
        self._stopping = False
        self._closed = False
        # membership (fault tolerance): the epoch's invalidation listener
        # only RECORDS the change — it may run inside whatever subsystem
        # poll fired the invalidation (often an executor worker), where a
        # drain/rebuild would self-deadlock.  The heavy work happens on
        # the admit path (_apply_membership_change).
        self.epoch = epoch
        self._membership_exc = None
        self._remeshing = False
        # a step failed by the change ran its decode: per-lane state
        # written in place already holds that step's token
        self._stale_lane_state = False
        self.remeshes = 0
        self.recovery_s: list[float] = []    # per remesh: drain + rebuild
        self.lanes_checkpointed = 0
        self.lanes_restored = 0
        # the first gathered step checks every row against row 0
        self._rows_checked = False
        # finished-request ledger for latency_snapshot (bounded: a
        # long-lived server must not grow per-request records forever)
        self._submitted = 0
        self._finished: collections.deque[tuple] = collections.deque(
            maxlen=4096)
        self.coll = None
        self._ag_handle = None
        if self._sharded:
            self._build_sharded_decode()
        self.admit_stream = engine.stream("serve-admit")
        self.decode_stream = engine.stream("serve-decode")
        # decode completions are delivered through this queue; its
        # detection task lives on the decode stream so INLINE runs
        # detokenize right where completion was observed
        self.continuations = ContinuationQueue(
            engine, self.decode_stream, policy=continuation_policy,
            name="serve-cont")
        self.continuation_max_drain = continuation_max_drain
        self._queue_adopted = False
        # streams the caller-driven bridge polls: the serve pair plus
        # (user backend) the collective stream — without an executor
        # nobody else progresses the all-gather rounds, and with one that
        # is NOT running the run_until_idle fallback drives these same
        # streams inline (a running executor never routes through
        # _poll_streams, so there is no contention)
        self._bridge_streams = [self.admit_stream, self.decode_stream]
        if self.coll is not None:
            self._bridge_streams.append(self.coll.stream)
        if executor is not None:
            executor.adopt(self.admit_stream)
            executor.adopt(self.decode_stream)
            if continuation_policy == DEFERRED:
                executor.adopt_queue(self.continuations)
                self._queue_adopted = True
            self._sub = None
        else:
            # no executor: bridge the serve streams (and the continuation
            # drain) into every engine.progress() call so single-threaded
            # callers still serve
            self._sub = engine.register_subsystem(
                "serve-streams", self._poll_streams, cheap=True, priority=4)
        self.steps = 0
        # host-clock seconds from each completed step's dispatch to its
        # harvest (mean_step_ms)
        self.step_s = 0.0
        self._step_t0 = 0.0
        # bounded: transient device failures on a long-lived server must
        # not accumulate exception objects forever
        self.decode_errors: collections.deque[BaseException] = \
            collections.deque(maxlen=256)
        if epoch is not None:
            epoch.subscribe(self._on_epoch_invalidate)

    # -- sharded decode construction --------------------------------------
    def _build_sharded_decode(self) -> None:
        """Validate the model axis and build the gather: nothing for the
        native path (a gather over the rank dim in the step), or a
        persistent user-space ``allgather_init`` handle of shape
        ``[n, batch_slots, V/n]`` f32 on a dedicated serve-collective
        stream, built and warmed once (decode shapes are fixed)."""
        cfg, mesh, axis = self.cfg, self.mesh, self.model_axis
        if axis not in dict(mesh.shape):
            raise ValueError(f"mesh has no axis {axis!r}: {dict(mesh.shape)}")
        n = dict(mesh.shape)[axis]
        V = cfg.vocab_size
        if V % n:
            raise ValueError(
                f"sharded serving needs vocab_size ({V}) divisible by the "
                f"{axis!r} axis size ({n})")
        self._model_shards = n
        if not hasattr(registry.module_for(cfg), "decode_hidden_paged"):
            raise ValueError(
                f"sharded serving not supported for family {cfg.family!r}")
        if self.collective_spec.user:
            self.coll = UserCollectives(self.engine, executor=self.executor,
                                        name="serve-coll", epoch=self.epoch)
            if mesh.per_device:
                like = RankShards(torch.empty((1, self.batch_slots, V // n),
                                              dtype=torch.float32, device=d)
                                  for d in mesh.devices)
            else:
                like = torch.empty((n, self.batch_slots, V // n),
                                   dtype=torch.float32, device="meta")
            self._ag_handle = self.coll.allgather_init(
                like, mesh, axis, spec=self.collective_spec, warmup=True)

    def _decode(self, cache, toks, pos, tables, fed):
        """One fused paged call: logits [B, 1, V] unsharded; sharded, the
        rank-stacked partial logits [n, B, V/n] of ``decode_hidden_paged``
        then ``unembed_ranks`` (every JAX rank's ``local_step`` at once),
        or, with a device per rank, each rank's ``local_step`` on its
        device: a ``RankShards`` of [1, B, V/n] and the pool replicas."""
        if not self._sharded:
            with device_context(self.device):
                return registry.decode_step_paged(self.params, self.cfg,
                                                  cache, toks, pos, tables,
                                                  fed)
        if self.mesh.per_device:
            return self._decode_per_device(cache, toks, pos, tables, fed)
        hid, cache = registry.decode_hidden_paged(self.params, self.cfg,
                                                  cache, toks, pos, tables,
                                                  fed)
        return registry.unembed_ranks(self.params, self.cfg, hid[:, -1],
                                      self._model_shards), cache

    def _decode_per_device(self, cache, toks, pos, tables, fed):
        width = self.cfg.vocab_size // self._model_shards
        parts, caches = [], []
        for r, d in enumerate(self.mesh.devices):
            params = tree_shard(self.params, r)
            with device_context(d):
                hid, c = registry.decode_hidden_paged(
                    params, self.cfg, tree_shard(cache, r), toks[r], pos[r],
                    tables[r], None if fed is None else fed[r])
                parts.append(registry.unembed_partial(
                    params, self.cfg, hid[:, -1], r * width, width)[None])
            caches.append(c)
        return RankShards(parts), tree_stack(caches, replica=True)

    # -- client API -------------------------------------------------------
    def submit(self, request: GenRequest) -> Request:
        with self._lock:
            if self._stopping:
                raise RuntimeError("serve engine is stopping")
            request.seq = self._seq
            self._seq += 1
            request.last_enqueued_at = time.monotonic()
            self._arrivals.append(request)
            self._submitted += 1
            waiting = len(self._arrivals) + len(self._backlog)
            self.sched.peak_backlog = max(self.sched.peak_backlog, waiting)
        self._schedule_admit()               # the arrival event
        return request.done_req

    # -- caller-driven bridge ---------------------------------------------
    def _poll_streams(self) -> bool:
        made = 0
        for s in self._bridge_streams:
            try:
                made += s._poll_once()
            except Exception:
                # the broken task is already dropped and recorded on
                # s.task_errors; the bridge must NOT let the exception
                # escape, or the engine's isolation would unregister it
                # and silently halt all serving
                pass
        made += self.continuations.drain(self.continuation_max_drain)
        coll = self.coll                 # a rebuild swaps it concurrently
        if coll is not None:
            made += coll.queue.drain(self.continuation_max_drain)
        return made > 0

    # -- admission (event-scheduled, one-shot) ------------------------------
    def _schedule_admit(self) -> None:
        with self._lock:
            pending = (self._arrivals or self._backlog or self._prefilling
                       or self._membership_exc is not None)
            if self._admit_scheduled or not pending:
                return
            self._admit_scheduled = True
        self.engine.async_start(self._admit_task, None, self.admit_stream)

    def _admit_task(self, thing) -> str:
        with self._lock:
            self._admit_scheduled = False
        self._admit()
        self._schedule_decode()
        return DONE                          # one-shot: nothing left to poll

    def _admit(self) -> bool:
        """Admission + one prefill chunk.  A pending membership change is
        applied first — nothing may be admitted onto the old mesh.  The
        unlocked read is benign: the flag is set under the lock, and an
        invalidation racing past the check is caught by the decode gate
        and the next admit pass."""
        if self._membership_exc is not None:
            self._apply_membership_change()
            if self._membership_exc is not None:
                return False         # in-flight work must drain first
        return self._admit_paged()

    def _admit_paged(self) -> bool:
        """Continuous-batching admission: drain arrivals into the
        length-bucketed backlog, admit whatever fits the free lanes AND
        free blocks (lane + prefill blocks claimed atomically), then run
        ONE chunk of batched prefill — at most ``prefill_chunk`` fused
        calls, each feeding EVERY mid-prefill lane its next replay token.
        Long prompts therefore interleave with decode steps instead of
        blocking them: the caller (admit task / detokenize continuation)
        re-schedules until every replay is rebuilt.

        Runs the chunk outside the lock, writing the pool in place: no
        decode step is in flight and ``_prefill_active`` excludes
        concurrent admissions."""
        with self._lock:
            if self._decode_inflight is not None or self._prefill_active:
                return False
            now = time.monotonic()
            while self._arrivals:
                req = self._arrivals.popleft()
                if req.replay is None:
                    req.replay = np.asarray(req.prompt, np.int32)
                self._backlog.push(req)

            def fits(req):
                return self.slots.assign(req.request_id,
                                         seq_len=len(req.replay))

            admitted = []
            while self.slots.free_count:
                req, lane = self._backlog.pop_fitting(fits)
                if req is None:
                    break
                req.slot_index = lane.index
                req.prefill_pos = 0
                req.queued_s += now - req.last_enqueued_at
                self._prefilling[lane.index] = req
                admitted.append(req)
                self.sched.admitted += 1
            if not self._prefilling:
                return False
            self.sched.peak_resident = max(
                self.sched.peak_resident,
                len(self._active) + len(self._prefilling))
            self._prefill_active = True
            cache = self.slots.cache
        try:
            for req in admitted:
                idx = req.slot_index
                # recycled lane: zero per-lane recurrent state (SSM) so
                # the previous occupant cannot leak into this request
                cache = self.slots.reset_lane(cache, idx)
                if req.kv_ckpt is not None:
                    # migrated lane (membership change): restore the KV
                    # prefix + per-lane state checkpointed off the old
                    # mesh instead of replaying the whole prefix
                    cache = self.slots.restore_lane(cache, idx, req.kv_ckpt)
                    req.prefill_pos = len(req.replay) - 1
                    req.kv_ckpt = None
                    self.lanes_restored += 1
            cache, completed = self._prefill_chunk(cache)
        except BaseException as exc:  # noqa: BLE001
            # chunk failure: every mid-prefill replay is lost — fail those
            # requests exactly once, return their lanes and blocks to the
            # free lists (what the chunk wrote there is unreachable)
            self.decode_errors.append(exc)
            with self._lock:
                self._prefill_active = False
                for idx, req in list(self._prefilling.items()):
                    self._prefilling.pop(idx)
                    self.slots.release(self.slots.slots[idx])
                    req.finished_at = time.monotonic()
                    self._record_locked(req, failed=True)
                    req.done_req.fail(exc)
            self._schedule_admit()           # backlog remainder, if any
            return False
        with self._lock:
            self._prefill_active = False
            self.slots.cache = cache
            for idx in completed:
                self._active[idx] = self._prefilling.pop(idx)
        return True

    def _prefill_chunk(self, cache):
        """Up to ``prefill_chunk`` fused paged calls over the pool; logits
        are discarded (and in sharded mode no gather is started) —
        prefill only needs the KV side effect.  Lanes not
        being fed write scratch KV at their next position, which is
        overwritten before the mask can expose it (see
        models/transformer.py).  Returns the cache and the lanes whose
        replay completed."""
        for _ in range(self.prefill_chunk):
            feeding = [(idx, req) for idx, req in self._prefilling.items()
                       if req.prefill_pos < len(req.replay) - 1]
            if not feeding:
                break
            toks = np.zeros((self.batch_slots, 1), np.int32)
            fed = np.zeros((self.batch_slots,), bool)
            for idx, req in feeding:
                toks[idx, 0] = int(req.replay[req.prefill_pos])
                fed[idx] = True
            _, cache = self._decode(
                cache, self.slots.place(toks), self.slots.positions(),
                self.slots.block_tables(), self.slots.place(fed))
            for idx, req in feeding:
                req.prefill_pos += 1
                self.slots.slots[idx].pos += 1
            self.sched.prefill_calls += 1
        completed = []
        for idx, req in self._prefilling.items():
            if req.prefill_pos >= len(req.replay) - 1:
                req.next_input = int(req.replay[-1])
                completed.append(idx)
        return cache, completed

    # -- fused decode (continuation-chained steps) ---------------------------
    def _schedule_decode(self) -> None:
        with self._lock:
            # defer while a prefill is staging: a step launched before the
            # prefill finished would race it on the pool.  The admitting
            # thread always calls _schedule_decode after publishing, so
            # nothing starves.
            busy = (self._decode_inflight is not None
                    or self._prefill_active)
            # membership pending: nothing launches on the old mesh — the
            # admit path applies the change first.  With a step still in
            # flight its own continuation funnels there; re-scheduling
            # here too would spin the admit stream against it.
            blocked = self._membership_exc is not None
            launched = not busy and not blocked and bool(self._active)
            if launched:
                step, agreq, cache = self._launch_decode_locked()
            # paged: prompts may still be mid-replay with no lane decoding
            # yet — keep the prefill chain alive (the admit task runs the
            # next chunk; _admit_scheduled bounds this to one outstanding
            # task)
            reschedule = (not busy and not blocked
                          and not self._active and bool(self._prefilling))
        if launched:
            self._attach_step(step, agreq, cache)
        elif reschedule or (blocked and not busy):
            self._schedule_admit()

    def _launch_decode_locked(self):
        """Dispatch one fused decode step; caller holds ``self._lock``.
        Returns ``(step, agreq, cache)``.

        Unsharded and native-sharded: ``_harvest`` takes the greedy ids on
        the card and watches them through a CUDA event (one-shot readiness
        task on the decode stream, never a synchronize) that completes
        ``step``.  User backend: the step's partial logits are re-bound
        into the persistent all-gather (``start``), and ``agreq``'s
        completion (bridged by a continuation, ``_attach_step``) harvests
        the gathered logits — the engine drives the gather rounds while
        the card runs.

        Dispatch failure fails the request instead of wedging the stream
        (the failure continuation cleans up).  The caller attaches the
        continuations AFTER releasing the lock: an already-failed step
        fires inline immediately, and that must not happen while the
        serve lock is held.
        """
        step = Request(tag="decode-step")
        self._current_step = step
        self._step_t0 = time.perf_counter()
        try:
            self._ensure_capacity_locked()
            toks = np.zeros((self.batch_slots, 1), np.int32)
            for idx, req in self._active.items():
                toks[idx, 0] = req.next_input
            fed = np.zeros((self.batch_slots,), bool)
            for idx in self._active:
                fed[idx] = True
            out, cache = self._decode(
                self.slots.cache, self.slots.place(toks),
                self.slots.positions(), self.slots.block_tables(),
                self.slots.place(fed))
            agreq = None
            if self._ag_handle is not None:      # user-space gather
                agreq = self._ag_handle.start(out)
            elif isinstance(out, RankShards):    # native, a device per rank
                out = allgather_shards(out)
            elif self._sharded:                  # native gather
                out = allgather_ranks(out)
            if agreq is None:
                self._harvest(step, out, cache)
        except BaseException as exc:  # noqa: BLE001
            step.fail(exc)
            return step, None, None
        self._decode_inflight = (out, cache)
        return step, agreq, cache

    def _harvest(self, step: Request, out, cache) -> None:
        """Greedy ids of a step's logits — unsharded [B, 1, V], or
        gathered [n, B, V] whose row 0 is the whole answer — taken on the
        card and copied to pinned host memory without blocking;
        ``torch_future`` completes ``step`` once that copy has passed.
        The first gathered step also copies whether every row equals row
        0, so that a wrong gather shows.  With a device per rank ``out``
        is a ``RankShards`` of the gathered rows, row 0 on rank 0's device
        (where the ids are taken), and the step waits for an event on
        every device."""
        per_device = isinstance(out, RankShards)
        first = out.shards[0] if per_device else out
        logits = first[0] if self._sharded else out[:, -1]
        ids = torch.argmax(logits, dim=-1)
        ids_host = ids.to("cpu", non_blocking=True)
        watched = [ids, ids_host, out] if per_device else [ids, ids_host]
        rows_host = None
        if self._sharded and not self._rows_checked:
            if per_device:
                rows = torch.stack([(s.to(first.device) == first).all()
                                    for s in out.shards]).all()
            else:
                rows = (out == out[:1]).all()
            rows_host = rows.to("cpu", non_blocking=True)
            watched += [rows, rows_host]
        torch_future(self.engine, watched, self.decode_stream,
                     on_complete=lambda _: step.complete(
                         (ids_host, cache, rows_host)))

    # -- block pressure: preemption / re-admission (paged mode) -------------
    def _ensure_capacity_locked(self) -> None:
        """Grow every decoding lane's block table to cover its next write
        position, preempting victims under block pressure.  Caller holds
        ``self._lock``.

        Policy: the oldest resident (smallest submit ``seq``, across
        decoding AND prefilling lanes) is never preempted, so it always
        runs to completion — every preemption strictly reduces the set of
        requests younger than it, which bounds total preemptions for a
        finite workload (no livelock).  Victims are evicted
        youngest-first; a lane may evict itself (it re-enters the backlog
        ahead of younger arrivals and is retried once blocks free)."""
        for idx in sorted(self._active, key=lambda i: self._active[i].seq):
            while idx in self._active:
                if self.slots.ensure(idx, self.slots.slots[idx].pos):
                    break
                victim = self._pick_victim_locked()
                if victim is None:
                    # sole resident: PagedKVCache guarantees the pool
                    # holds one max_seq request, so ensure cannot fail
                    raise RuntimeError(
                        "block pool exhausted with no preemptible victim")
                self._preempt_locked(victim)

    def _pick_victim_locked(self) -> Optional[int]:
        """Lane of the youngest resident, never the oldest; ``None`` when
        fewer than two requests are resident."""
        residents = {**self._prefilling, **self._active}
        if len(residents) < 2:
            return None
        return max(residents, key=lambda i: residents[i].seq)

    def _preempt_locked(self, idx: int) -> None:
        """Evict one resident lane: return its blocks to the free list
        and re-queue the request with its generated prefix folded into
        ``replay``.  Greedy decode is per-lane deterministic, so the
        rebuilt KV continues the exact same token stream — preemption is
        invisible in the output."""
        req = self._active.pop(idx, None)
        if req is None:
            req = self._prefilling.pop(idx)
        self.slots.release(self.slots.slots[idx])
        req.preemptions += 1
        self.sched.preemptions += 1
        req.replay = np.concatenate([
            np.asarray(req.prompt, np.int32),
            np.asarray(req.out_tokens, np.int32)])
        req.prefill_pos = 0
        req.slot_index = -1
        req.last_enqueued_at = time.monotonic()
        self._backlog.push(req)

    def _attach_step(self, step: Request, agreq=None, cache=None) -> None:
        if agreq is not None:
            # bridge the persistent all-gather into the step request:
            # detokenize (below) stays identical across backends
            def gathered(rq, step=step, cache=cache):
                try:
                    self._harvest(step, rq.value(), cache)
                except BaseException as exc:  # noqa: BLE001
                    step.fail(exc)

            self.continuations.attach(
                agreq, gathered,
                on_error=lambda rq, step=step: step.fail(
                    rq.exception
                    or RuntimeError("serve all-gather failed")))
        self.continuations.attach(step, self._on_step_done,
                                  on_error=self._on_step_failed)

    def _on_step_done(self, step: Request) -> None:
        """Detokenize stage (a continuation): harvest the fused step,
        finish/complete requests, and chain the next decode step."""
        ids, cache, rows = step.value()
        try:
            # read OUTSIDE the lock: a raise here must take the failure
            # path, not wedge the server with _active full and no task
            # on any stream
            next_ids = ids.numpy()
            if rows is not None and not bool(rows):
                raise RuntimeError(
                    "the gathered logits' rows differ from row 0: the "
                    "all-gather is wrong")
        except BaseException as exc:  # noqa: BLE001
            self._fail_step(step, exc)
            return
        freed = False
        with self._lock:
            if self._current_step is not step:
                return                         # stale: a newer step owns state
            self._current_step = None
            self._decode_inflight = None
            self.slots.cache = cache
            self.steps += 1
            if rows is not None:
                self._rows_checked = True
            self.step_s += time.perf_counter() - self._step_t0
            finished = []
            for idx, req in list(self._active.items()):
                tok = int(next_ids[idx])
                if req.first_token_at is None:
                    # TTFT stamp: exactly once, on the first produced token
                    req.first_token_at = time.monotonic()
                req.out_tokens.append(tok)
                req.next_input = tok
                self.slots.slots[idx].pos += 1
                if (len(req.out_tokens) >= req.max_new_tokens
                        or self.slots.slots[idx].pos >= self.max_seq - 1):
                    finished.append(idx)
            for idx in finished:
                req = self._active.pop(idx)
                req.finished_at = time.monotonic()
                self.slots.release(self.slots.slots[idx])
                self._record_locked(req, failed=False)
                req.done_req.complete(req.out_tokens)
                freed = True
        # admit between steps: arrivals that landed while this step was
        # in flight (their admission was deferred — prefill and an
        # in-flight step must not both write the pool) join the batch
        # before the next launch.  Prefill runs outside the lock, so
        # releasing it first keeps submit() responsive during admission.
        self._admit()
        self._schedule_decode()                # chain the next step
        if freed:
            self._schedule_admit()             # the slot-free event

    def _on_step_failed(self, step: Request) -> None:
        """Failure continuation: a decode step that failed fails every
        in-flight request with the step's exception (propagated through
        ``Request.exception``) and frees their slots."""
        self._fail_step(step, step.exception)

    def _fail_step(self, step: Request, exc: BaseException) -> None:
        self.decode_errors.append(exc)
        with self._lock:
            if self._current_step is not step:
                # stale failure (a newer healthy step was launched before
                # this continuation drained): the requests already belong
                # to that step — touching state here would clobber it
                return
            self._current_step = None
            self._decode_inflight = None
            if (isinstance(exc, MembershipError)
                    or self._membership_exc is not None):
                # a membership change killed the STEP, not the requests:
                # they stay resident until the admit path has drained and
                # closed the old handle, then are checkpointed and
                # requeued for the rebuilt mesh (no in-flight request is
                # lost).  The step ran its decode, in place.
                if self._membership_exc is None:
                    self._membership_exc = exc
                self._stale_lane_state = True
            else:
                for idx, req in list(self._active.items()):
                    self._active.pop(idx)
                    # first_token_at stays as-is: a request that failed
                    # before its first token keeps None (null-propagated
                    # — counted by the snapshot, never faked into TTFT)
                    req.finished_at = time.monotonic()
                    self.slots.release(self.slots.slots[idx])
                    self._record_locked(req, failed=True)
                    req.done_req.fail(exc)
        self._schedule_admit()

    # -- membership changes (elastic fault tolerance) -----------------------
    def _on_epoch_invalidate(self, epoch, exc) -> None:
        """Epoch listener — runs inside whatever subsystem poll fired the
        invalidation (often an executor worker), so it only records the
        change and pokes the admit path; draining or rebuilding here
        could deadlock the worker against its own stream."""
        with self._lock:
            if self._closed:
                return
            self._membership_exc = exc
        self._schedule_admit()

    def _requeue_residents_locked(self, stale_state: bool) -> int:
        """Move every resident request (decoding or mid-prefill) back to
        the queue for re-admission on the rebuilt mesh.  Decoding lanes
        checkpoint their KV prefix + per-lane state to host memory
        (block-table walk) so restore skips the replay — unless
        ``stale_state`` (a failed step advanced the per-lane state in
        place) and the pool has per-lane state: those replay, as do
        mid-prefill lanes.  Caller holds ``self._lock``; no step is in
        flight and ``replay = prompt + out_tokens`` resumes the exact
        stream."""
        now = time.monotonic()
        moved = []
        keep_state = not (stale_state and self.slots.has_lane_state)
        for idx, req in list(self._active.items()):
            self._active.pop(idx)
            lane = self.slots.slots[idx]
            req.kv_ckpt = None
            if lane.pos > 0 and keep_state:
                try:
                    req.kv_ckpt = self.slots.checkpoint_lane(idx)
                    self.lanes_checkpointed += 1
                except Exception as ckpt_exc:   # fall back to full replay
                    self.decode_errors.append(ckpt_exc)
            self.slots.release(lane)
            moved.append(req)
        for idx, req in list(self._prefilling.items()):
            self._prefilling.pop(idx)
            req.kv_ckpt = None                  # partial prefix: replay
            self.slots.release(self.slots.slots[idx])
            moved.append(req)
        for req in moved:
            req.replay = np.concatenate([
                np.asarray(req.prompt, np.int32),
                np.asarray(req.out_tokens, np.int32)])
            req.prefill_pos = 0
            req.slot_index = -1
            req.last_enqueued_at = now
            self._backlog.push(req)
        return len(moved)

    def _apply_membership_change(self) -> None:
        """Drain + rebuild after an epoch invalidation (admit path, no
        lock held).  Bails while a step or prefill is in flight: their
        completion/failure continuations funnel back here.  The old
        gather handle and its collectives are closed first (their stream
        drained, so no round still runs when the lanes are copied to the
        host); then the residents are checkpointed and requeued under
        the lock; then the mesh, the pool and the handle are rebuilt on
        the survivors."""
        with self._lock:
            exc = self._membership_exc
            if exc is None or self._remeshing:
                return
            if self._decode_inflight is not None or self._prefill_active:
                return
            self._remeshing = True
        t0 = time.perf_counter()
        try:
            self._close_collectives()
            with self._lock:
                moved = self._requeue_residents_locked(self._stale_lane_state)
                self._stale_lane_state = False
            self._rebuild_for_survivors(exc)
        except BaseException:
            # keep _membership_exc set: the next admit pass retries the
            # rebuild (residents are already requeued — idempotent)
            with self._lock:
                self._remeshing = False
            raise
        with self._lock:
            self._remeshing = False
            if self._membership_exc is exc:     # a FRESH invalidation
                self._membership_exc = None     # during rebuild stays
            self.remeshes += 1
            self.recovery_s.append(time.perf_counter() - t0)
        if moved:
            self._schedule_admit()

    def _close_collectives(self, timeout: float = 60.0) -> None:
        """Close the gather handle and drain + release its collectives."""
        handle, coll = self._ag_handle, self.coll
        self._ag_handle = None
        self.coll = None
        # stop bridging the old collective stream BEFORE draining it
        self._bridge_streams = [self.admit_stream, self.decode_stream]
        if handle is not None:
            handle.close()
        if coll is not None:
            coll.close(timeout=timeout)

    def _rebuild_for_survivors(self, exc) -> None:
        """Rebuild every mesh-dependent piece on the survivors: the mesh
        (model axis shrunk to what survives — capped by the old degree
        and the vocab divisibility rule), the pool and the persistent
        all-gather handle.  Nothing resident survives in the pool:
        requeued requests carry their prefix as a host checkpoint or as
        replay tokens."""
        from repro_torch.distributed import elastic
        from repro_torch.launch.mesh import make_mesh
        if self._sharded:
            survivors = getattr(exc, "survivors", None)
            if survivors is None:
                survivors = self._model_shards
            # plan_mesh validates survivors >= 1 and keeps the model
            # degree when it still fits; vocab divisibility caps it below
            shape, _axes = elastic.plan_mesh(
                survivors, prefer_model=self._model_shards)
            m = shape[1]
            while m > 1 and self.cfg.vocab_size % m:
                m //= 2
            per_device = self.mesh.per_device
            if m > 1 and per_device:
                # the first m devices and their weight replicas
                self.mesh = make_mesh((m,), (self.model_axis,),
                                      devices=self.mesh.devices[:m])
                self.params = tree_keep(self.params, m)
            elif m > 1:
                self.mesh = make_mesh((m,), (self.model_axis,), self.device)
            else:
                # a lone survivor serves unsharded — there is nothing
                # left to gather; with a device per rank, on the first
                # device (self.device) with its replica
                self.mesh = None
                self._sharded = False
                self._model_shards = 1
                if per_device:
                    self.params = tree_shard(self.params, 0)
        per_device = self.mesh is not None and self.mesh.per_device
        self.slots = PagedKVCache(self.cfg, self.batch_slots, self.max_seq,
                                  block_size=self._kv_block_size,
                                  num_blocks=self._kv_blocks, mesh=self.mesh,
                                  device=None if per_device else self.device)
        if self._sharded:
            self._build_sharded_decode()
            if self.coll is not None:
                self._bridge_streams = [self.admit_stream,
                                        self.decode_stream, self.coll.stream]

    # -- latency accounting ------------------------------------------------
    def _record_locked(self, req: GenRequest, failed: bool) -> None:
        """Append one finished request to the ledger (caller holds the
        serve lock — or owns the request exclusively, as prefill does)."""
        self._finished.append((req.submitted_at, req.first_token_at,
                               req.finished_at, failed, req.queued_s,
                               req.preemptions))

    def latency_snapshot(self) -> ServeLatencyStats:
        """TTFT / completion-latency aggregates over the (bounded) ledger
        of finished requests.  Requests that failed before producing a
        first token are counted (``no_first_token``) and excluded from
        the TTFT aggregates instead of silently skewing them."""
        with self._lock:
            records = list(self._finished)
            submitted = self._submitted
        snap = ServeLatencyStats(submitted=submitted)
        ttfts, lats, queued = [], [], []
        for sub, first, fin, failed, q_s, npre in records:
            if failed:
                snap.failed += 1
            else:
                snap.completed += 1
            if first is None:
                snap.no_first_token += 1
            else:
                ttfts.append((first - sub) * 1e3)
            if fin is not None:
                lats.append((fin - sub) * 1e3)
            queued.append(q_s * 1e3)
            if npre:
                snap.preempted += 1
                snap.preemptions += npre
        if ttfts:
            (snap.ttft_ms_mean, snap.ttft_ms_p50,
             snap.ttft_ms_p99) = _quantiles(ttfts)
        if lats:
            (snap.latency_ms_mean, snap.latency_ms_p50,
             snap.latency_ms_p99) = _quantiles(lats)
        if queued:
            (snap.queued_ms_mean, snap.queued_ms_p50,
             snap.queued_ms_p99) = _quantiles(queued)
        return snap

    def mean_step_ms(self) -> float:
        """Mean host-clock time of a fused decode step, from dispatch to
        the harvest of its tokens."""
        with self._lock:
            return self.step_s * 1e3 / max(self.steps, 1)

    def scheduler_snapshot(self) -> SchedulerStats:
        """Copy of the continuous-batching scheduler counters."""
        with self._lock:
            return dataclasses.replace(self.sched)

    # -- lifecycle ------------------------------------------------------------
    @property
    def idle(self) -> bool:
        with self._lock:
            busy = (self._active or self._arrivals or self._prefill_active
                    or self._prefilling or len(self._backlog)
                    or self._decode_inflight is not None
                    or self._membership_exc is not None)
        return not busy and self.continuations.ready == 0

    def run_until_idle(self, timeout: float = 120.0) -> None:
        """Serve until the backlog empties.  With an executor the worker
        threads do the progressing and this thread just waits; without one
        it is the classic caller-driven progress loop."""
        t0 = time.monotonic()
        while not self.idle:
            if self.executor is not None and self.executor.running:
                time.sleep(0.0005)
            elif self._sub is not None:
                # bridge polls the streams; pace out when nothing moved
                # (waiting on the device must not burn the core)
                if self.engine.progress() == 0:
                    time.sleep(50e-6)
            else:
                # executor attached but not running (never started, or
                # already shut down): drive the adopted streams inline so
                # waiting can never silently hang
                made = self._poll_streams()
                subs = self.engine.poll_subsystems()
                if not made and not subs:
                    time.sleep(50e-6)       # device wait: don't burn a core
            if time.monotonic() - t0 > timeout:
                raise TimeoutError("serve engine did not drain")

    def stop(self) -> None:
        """Begin shutdown: reject new submissions.  Already-submitted
        work keeps flowing (the event chain runs the backlog down); once
        it finishes no tasks remain, so drains terminate."""
        with self._lock:
            self._stopping = True

    def close(self, timeout: float = 60.0) -> None:
        """Stop, serve the backlog, then deterministically drain: both
        serve streams empty and every pending continuation executed
        (Listing 1.2 finalize, extended to the continuation layer).
        Idempotent: a second close (finally blocks, racing shutdown
        paths) is a no-op."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self.stop()
        self.run_until_idle(timeout=timeout)
        if self.executor is not None and self.executor.running:
            self.executor.drain(timeout)
        else:
            self.engine.drain(self.admit_stream, timeout=timeout)
            self.engine.drain(self.decode_stream, timeout=timeout)
        self.continuations.drain()             # anything still ready
        if self._queue_adopted:
            self.executor.release_queue(self.continuations)
            self._queue_adopted = False
        self.continuations.close()
        # drains the serve-collective stream and hands it back
        self._close_collectives(timeout)
        if self._sub is not None:
            self.engine.unregister_subsystem(self._sub)
            self._sub = None
        # hand the (drained) streams back to the engine: a process that
        # builds ServeEngines repeatedly must not grow the stream list
        for stream in (self.admit_stream, self.decode_stream):
            if self.executor is not None and self.executor.owns(stream):
                self.executor.release(stream)
            if not stream.pending:
                self.engine.free_stream(stream)
