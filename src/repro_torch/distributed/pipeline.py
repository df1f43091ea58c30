"""Pipeline parallelism on the progress engine (the port of the JAX
package's ``distributed/pipeline.py``).

Two implementations of the same semantics:

* :func:`gpipe` — the reference path: a GPipe tick loop over the
  rank-stacked stage activations ``[S, mb, ...]``, every tick running
  each stage on its row and shifting the rows one stage down the ring
  (``schedules.ring_shift``).  Forward AND backward differentiate
  through the tick loop with autograd.  The runtime cannot see (or
  overlap) any of it.
* :class:`PipelineSchedule` — 1F1B rebuilt as a **continuation DAG on
  the progress engine** (the paper's §4.6 task-based-runtime
  integration): each stage owns an engine stream adopted by a
  ``ProgressExecutor`` and its own CUDA stream on the card; every
  (stage, microbatch) forward/backward cell is a DAG node gated by
  ``when_all`` on exactly its inputs — a forward cell on
  (recv_activation, params_ready), a backward cell on (recv_grad,
  stashed_activation) — and micro-batch activation handoffs are
  **persistent user-space nonblocking p2p** (``repro_torch.collectives.
  p2p`` channels: fixed-shape every tick, the ideal ``*_init`` +
  ``Start`` case).  Warmup/steady/cooldown phases are not special-cased
  anywhere: they fall out of the dependency structure.

Semantics (both paths): ``num_stages`` ranks along ``axis`` each own a
contiguous block of layers (stacked params, stage s in row s);
microbatches enter stage 0 one tick apart; activations hop
stage→stage; after the pipeline drains, all M microbatches have exited
stage S-1.  Both schedules burn the same warmup bubble of
(S-1)/(M+S-1) ticks — 1F1B's win is memory: at most min(S, M)
activation stashes live per stage instead of GPipe's M.

The stage mesh takes either form of ``launch.mesh.Mesh``.  On a
rank-stacked mesh every stage lives on the mesh's one device, the stacked
params ``[S, ...]`` hold stage s's block in row s, and on the card the
stages' cells run on S CUDA streams, so they overlap as the S devices of
the JAX package's mesh do.  On a mesh with a device per stage
(``make_mesh((S,), ("stage",), devices=[...])``, the JAX package's
``mesh.devices``) stage s's parameters are shard s of ``RankShards``
blocks, its CUDA stream, accumulators and cells are on ``devices[s]``,
the microbatches enter on stage 0's device and the targets and the loss
live on the last stage's, and a hop is a copy between two stages' devices
(``schedules.ring_shift`` on ``RankShards``); the loss, the gradients
(``RankShards`` blocks, stage s's on its device) and ``apply``'s outputs
equal the stacked form's bit for bit.  A tensor made on one stream and
read on another is ``record_stream``-ed for the reader, on the reader's
own device, and a cell reads its inputs only after the engine saw the
producing work finish (its gate's requests are CUDA events).
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Optional

import torch

from repro_torch.collectives import schedules as S_mod
from repro_torch.collectives.overlap import tree_flatten
from repro_torch.collectives.rank_shards import RankShards, device_context
from repro_torch.core import (INLINE, ContinuationQueue, ProgressEngine,
                              Request, global_engine, torch_future)


def _stage_params(stacked_leaves, s: int) -> list:
    """Stage s's block of each leaf: row s of a stacked ``[S, ...]`` leaf,
    or shard s (its one row) of ``RankShards`` blocks."""
    return [leaf.shards[s][0] if isinstance(leaf, RankShards) else leaf[s]
            for leaf in stacked_leaves]


def _stage_devices(mesh, S: int) -> list:
    """The device of each of the ``S`` stages: the mesh's one device, or
    (a device per stage) ``mesh.devices``, which must then be the
    stages' and no other rank's."""
    if not mesh.per_device:
        return [mesh.device] * S
    if mesh.size != S:
        raise ValueError(f"a stage mesh with a device per rank holds the "
                         f"{S} stages and nothing else, got {mesh!r}")
    return list(mesh.devices)


def _stack_blocks(blocks: list, per_device: bool):
    """Per-stage blocks -> the ``[S, ...]`` leaf of the mesh's form: one
    stacked tensor, or ``RankShards`` blocks (stage s's ``[1, ...]`` on
    its device)."""
    if per_device:
        return RankShards(b.unsqueeze(0) for b in blocks)
    return torch.stack(blocks)


def gpipe(stage_fn: Callable, mesh, axis: str, num_stages: int):
    """Build a pipelined apply: ``(stage_params_stacked, x_microbatches)
    -> y_microbatches``.

    * ``stage_fn(stage_params, x) -> y``: one stage's computation
      (same shape in/out — the residual-stream case).
    * ``stage_params_stacked``: tree of tensors with leading dim
      ``num_stages`` (stage s's block in row s), or on a mesh with a
      device per stage of ``RankShards`` blocks (stage s's on its
      device).
    * ``x_microbatches``: ``[M, mb, ...]``.

    Returns ``[M, mb, ...]`` (on the last stage's device), differentiable
    with autograd: on a device per stage, stage s runs on its device and
    the carry hops between the devices as copies, which autograd
    differentiates as JAX does ``ppermute``."""
    S = num_stages
    if dict(mesh.shape).get(axis) != S:
        raise ValueError(f"mesh axis {axis!r} has "
                         f"{dict(mesh.shape).get(axis)} rank(s), gpipe "
                         f"wants {S} stages")
    devices = _stage_devices(mesh, S)

    def pipelined(stage_params, xs):
        M = xs.shape[0]
        leaves, rebuild = tree_flatten(stage_params)
        mine = [rebuild(_stage_params(leaves, s)) for s in range(S)]
        if mesh.per_device:
            xs = xs.to(devices[0])
            carry = [xs.new_zeros(xs.shape[1:], device=d) for d in devices]
        else:
            carry = xs.new_zeros((S,) + tuple(xs.shape[1:]))
        out = [None] * M
        for t in range(M + S - 1):
            # stage 0 injects microbatch t (if valid); others consume
            x0 = xs[t] if t < M else xs[0]
            x_in = [x0] + [carry[s] for s in range(1, S)]
            ys = []
            for s in range(S):
                with device_context(devices[s]):
                    ys.append(stage_fn(mine[s], x_in[s]))
            y = RankShards(ys) if mesh.per_device else torch.stack(ys)
            # the last stage owns microbatch t - (S-1) at this tick
            if t - (S - 1) >= 0:
                out[t - (S - 1)] = y[S - 1]
            carry = S_mod.ring_shift(y, 1)
        return torch.stack(out)

    return pipelined


SCHEDULES = ("gpipe", "1f1b")


def bubble_fraction(num_stages: int, num_microbatches: int,
                    schedule: str = "gpipe") -> float:
    """Fraction of pipeline ticks burned in the warmup/cooldown bubble.

    GPipe and 1F1B share the same bubble — (S-1)/(M+S-1) — because both
    must fill S-1 ticks before the last stage has work and drain S-1
    after stage 0 runs dry.  1F1B's advantage is peak activation
    memory, not bubble time (see
    :func:`peak_activation_microbatches`)."""
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}, "
                         f"got {schedule!r}")
    return (num_stages - 1) / (num_microbatches + num_stages - 1)


def peak_activation_microbatches(num_stages: int, num_microbatches: int,
                                 schedule: str = "gpipe") -> int:
    """Peak in-flight activation stashes on the deepest stage (stage 0).

    GPipe runs all M forwards before any backward, so every microbatch's
    activations are live at once; 1F1B starts draining after S forwards,
    capping the stash depth at min(S, M)."""
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}, "
                         f"got {schedule!r}")
    if schedule == "gpipe":
        return num_microbatches
    return min(num_stages, num_microbatches)


# ---------------------------------------------------------------------------
# The 1F1B grid: a static dependency simulation, cached per (S, M)
# ---------------------------------------------------------------------------

class _Op:
    __slots__ = ("stage", "kind", "mb", "tick", "src_hop")

    def __init__(self, stage, kind, mb, tick, src_hop):
        self.stage = stage
        self.kind = kind          # "F" | "B"
        self.mb = mb
        self.tick = tick
        self.src_hop = src_hop    # ("f"|"b", tick) of the hop feeding it


class _Grid:
    __slots__ = ("S", "M", "forward_only", "ops", "ticks",
                 "hop_edges", "hop_order", "peak_stash")

    def __init__(self, S, M, forward_only, ops, ticks, hop_edges,
                 hop_order, peak_stash):
        self.S = S
        self.M = M
        self.forward_only = forward_only
        self.ops = ops                  # list[_Op] in fire order
        self.ticks = ticks              # number of ticks
        self.hop_edges = hop_edges      # ("f"|"b", tick) -> [(src_stage, mb)]
        self.hop_order = hop_order      # "f"|"b" -> [ticks with a hop]
        self.peak_stash = peak_stash


_grid_cache: dict = {}


def _stage_order(S: int, M: int, s: int, forward_only: bool):
    """Stage s's 1F1B op order: min(M, S-s) warmup forwards, steady
    B/F alternation, cooldown backwards."""
    w = min(M, S - s)
    order = [("F", m) for m in range(w)]
    if forward_only:
        return order + [("F", m) for m in range(w, M)]
    for i in range(M - w):
        order.append(("B", i))
        order.append(("F", w + i))
    for m in range(M - w, M):
        order.append(("B", m))
    return order


def _build_grid(S: int, M: int, forward_only: bool = False) -> _Grid:
    """Greedy tick simulation of the per-stage 1F1B orders under hop
    latency (an activation produced at tick t is consumable downstream
    at tick t+1).  The warmup/steady/cooldown phases are emergent."""
    key = (S, M, forward_only)
    grid = _grid_cache.get(key)
    if grid is not None:
        return grid
    orders = [_stage_order(S, M, s, forward_only) for s in range(S)]
    ptr = [0] * S
    f_tick = [[None] * M for _ in range(S)]
    b_tick = [[None] * M for _ in range(S)]
    ops: list[_Op] = []
    hop_edges: dict = {}
    stash_depth = [0] * S
    peak_stash = 0
    t = 0
    while any(ptr[s] < len(orders[s]) for s in range(S)):
        fired = []
        for s in range(S):
            if ptr[s] >= len(orders[s]):
                continue
            kind, m = orders[s][ptr[s]]
            if kind == "F":
                ready = s == 0 or (f_tick[s - 1][m] is not None
                                   and f_tick[s - 1][m] < t)
            elif s == S - 1:
                ready = f_tick[s][m] is not None and f_tick[s][m] < t
            else:
                ready = (b_tick[s + 1][m] is not None
                         and b_tick[s + 1][m] < t
                         and f_tick[s][m] is not None and f_tick[s][m] < t)
            if ready:
                fired.append((s, kind, m))
        if not fired:
            raise AssertionError(
                f"1F1B grid deadlock at tick {t} (S={S}, M={M})")
        for s, kind, m in fired:
            ptr[s] += 1
            if kind == "F":
                f_tick[s][m] = t
                src = ("f", f_tick[s - 1][m]) if s > 0 else None
                if s < S - 1:
                    hop_edges.setdefault(("f", t), []).append((s, m))
                if not forward_only:
                    stash_depth[s] += 1
                    peak_stash = max(peak_stash, stash_depth[s])
            else:
                b_tick[s][m] = t
                src = ("b", b_tick[s + 1][m]) if s < S - 1 else None
                if s > 0:
                    hop_edges.setdefault(("b", t), []).append((s, m))
                stash_depth[s] -= 1
            ops.append(_Op(s, kind, m, t, src))
        t += 1
    hop_order = {
        "f": sorted(tk for d, tk in hop_edges if d == "f"),
        "b": sorted(tk for d, tk in hop_edges if d == "b"),
    }
    grid = _Grid(S, M, forward_only, ops, t, hop_edges, hop_order,
                 peak_stash)
    _grid_cache[key] = grid
    return grid


# ---------------------------------------------------------------------------
# The event-driven schedule
# ---------------------------------------------------------------------------

class _StepRun:
    """All mutable state of one in-flight pipeline step."""

    __slots__ = ("grid", "params_stages", "xs", "targets", "scale",
                 "inbox_f", "inbox_b", "stash", "dp_acc", "losses",
                 "outputs", "staging", "cell_req", "hop_rreq",
                 "params_ready", "done", "_lock", "t0", "cell_spans",
                 "hops", "failing")

    def __init__(self, grid):
        self.grid = grid
        self.inbox_f: dict = {}
        self.inbox_b: dict = {}
        self.stash: dict = {}
        self.losses: dict = {}
        self.outputs: dict = {}
        self.staging: dict = {}
        self.cell_req: dict = {}
        self.hop_rreq: dict = {}
        # per-stage [(t_issue, t_done), ...] — cells on a stage are
        # serial, so wall - sum(spans) is that stage's idle time
        self.cell_spans: dict = {}
        self.done = Request(tag="pipeline_step")
        self._lock = threading.RLock()
        self.t0 = time.monotonic()
        # this step's persistent hop starts, and whether it is failing:
        # a failing step cancels its hops before its request fails
        self.hops: list = []
        self.failing = False


def _for_stream(tensors, cs) -> None:
    """Mark tensors made on another CUDA stream as used on ``cs`` (the
    caching allocator then keeps their blocks until ``cs`` is done); the
    tensors are on ``cs``'s device."""
    if cs is None:
        return
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            t.record_stream(cs)


def _for_current(tensors) -> None:
    """Mark tensors as used on the calling thread's current stream of
    each one's own device."""
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            t.record_stream(torch.cuda.current_stream(t.device))


class PipelineSchedule:
    """1F1B pipeline parallelism as a continuation DAG.

    * ``stage_fn(stage_params, x) -> y`` — one stage's computation
      (same activation shape in/out, the residual-stream case).
    * ``loss_fn(y, target) -> scalar`` — the loss head, applied to the
      last stage's output per microbatch (required for :meth:`step`).
    * ``mesh``/``axis`` — a 1-D mesh whose ``axis`` has ``num_stages``
      ranks; stacked params ``[S, ...]`` hold stage s's block in row s,
      or (a device per stage) ``RankShards`` blocks stage s's on its
      device.

    Execution model: :meth:`istep` builds one DAG per call from the
    cached (S, M) grid.  Every (stage, microbatch) forward/backward
    cell is a ``ContinuationQueue.node`` gated by ``when_all`` on its
    true inputs — the p2p receive carrying its activation (or gradient)
    and the previous cell on its stage (serial stage order; for backward
    cells also the forward cell that stashed the activation).  When the
    gate fires, a one-shot issue task is enqueued on the stage's engine
    stream, so the adopting executor worker — not the caller — enters
    the stage's CUDA stream and dispatches the cell: a forward under
    ``no_grad``, or a backward that runs the stage again on the stashed
    activation and takes ``torch.autograd.grad`` (the JAX package's
    ``vjp``).  Handoffs ride TWO persistent p2p channels (forward ring
    for activations, reverse ring for gradients), one ``start`` per tick
    with edges stacked (on a device per stage a ``RankShards`` of each
    stage's ``[1, *act]`` row, a zero row on the stages without an edge).

    The whole step completes through continuations: ``istep`` returns a
    Request, and nothing in the DAG ever polls or blocks — the only
    blocking wait is the caller's (``step`` = ``istep`` + wait), counted
    in ``blocking_waits``."""

    def __init__(self, stage_fn: Callable, mesh, axis: str,
                 num_stages: int, *, loss_fn: Callable | None = None,
                 engine: Optional[ProgressEngine] = None, executor=None,
                 epoch=None, name: str = "pipe"):
        from repro_torch.collectives.p2p import P2P
        self.stage_fn = stage_fn
        self.loss_fn = loss_fn
        self.mesh = mesh
        self.axis = axis
        self.S = num_stages
        if dict(mesh.shape).get(axis) != num_stages:
            raise ValueError(
                f"mesh axis {axis!r} has {dict(mesh.shape).get(axis)} "
                f"rank(s), schedule wants {num_stages} stages")
        self.engine = engine if engine is not None else global_engine()
        self.executor = executor
        self.epoch = epoch
        self.name = name
        # stage s's device: its CUDA stream, parameters, accumulators and
        # cells are there
        self.devices = _stage_devices(mesh, num_stages)
        mk = executor.stream if executor is not None else self.engine.stream
        self.stage_streams = [mk(f"{name}-stage{s}")
                              for s in range(num_stages)]
        self.cuda_streams = [
            torch.cuda.Stream(device=d) if d.type == "cuda" else None
            for d in self.devices]
        self.dag_stream = mk(f"{name}-dag")
        # DAG gates fire INLINE on whichever thread progresses the dag
        # stream (an executor worker, or the step waiter's sweep)
        self.queue = ContinuationQueue(self.engine, self.dag_stream,
                                       policy=INLINE, name=f"{name}-dag-q")
        self.p2p = P2P(self.engine, executor=executor,
                       name=f"{name}-p2p", epoch=epoch)
        self._chan = {}              # "f"/"b" -> P2PChannel
        self._zeros = None           # per stage: a [1, *act] zero row
        self._act_sig = None
        self.steps = 0
        self.blocking_waits = 0
        # the rows the hops carried, and those whose device differs from
        # the receiving rank's (a copy between two cards)
        self.hop_rows = 0
        self.hop_rows_between_devices = 0
        # set after each step: {"window_s", "idle_s" (per stage),
        # "bubble"} — measured idle from the cell spans, comparable to
        # bubble_fraction's analytic value
        self.last_step_timing: dict | None = None

    # -- the per-stage programs -------------------------------------------
    def _fwd(self, p, x):
        with torch.no_grad():
            return self.stage_fn(p, x)

    def _grads(self, p, x, head, seed):
        """Run ``head(params, x)`` again with autograd on the stashed
        activation and pull ``seed`` back: (output, dparams, dx)."""
        leaves, rebuild = tree_flatten(p)
        with torch.enable_grad():
            ps = [t.detach().requires_grad_(True) for t in leaves]
            xx = x.detach().requires_grad_(True)
            out = head(rebuild(ps), xx)
            grads = torch.autograd.grad(out, ps + [xx], seed)
        return out.detach(), list(grads[:-1]), grads[-1]

    def _bwd(self, p, x, dy, acc):
        _, dp, dx = self._grads(p, x, self.stage_fn, dy)
        return dx, [a + d for a, d in zip(acc, dp)]

    def _last_bwd(self, p, x, t, scale, acc):
        loss_fn, stage_fn = self.loss_fn, self.stage_fn
        loss, dp, dx = self._grads(
            p, x, lambda pp, xx: loss_fn(stage_fn(pp, xx), t), scale)
        return loss, dx, [a + d for a, d in zip(acc, dp)]

    # -- public API --------------------------------------------------------
    def step(self, params, xs, targets, timeout: float = 600.0):
        """Blocking 1F1B train step: returns ``(loss, grads)`` with
        ``loss`` the mean microbatch loss (a scalar on the last stage's
        device) and ``grads`` the ``[S, ...]`` gradient tree in the
        mesh's form — bit-identical to sequential per-stage
        accumulation."""
        return self._wait(self.istep(params, xs, targets), timeout)

    def istep(self, params, xs, targets) -> Request:
        """Nonblocking step: build the DAG, return its completion
        Request (value ``(loss, grads)``)."""
        if self.loss_fn is None:
            raise ValueError("istep needs loss_fn (construct the "
                             "schedule with one, or use apply)")
        if targets is None:
            raise ValueError("istep needs targets for the loss head")
        return self._launch(params, xs, targets, forward_only=False)

    def apply(self, params, xs, timeout: float = 600.0):
        """Forward-only pipelined apply (gpipe-comparable): returns
        y_microbatches ``[M, mb, ...]``."""
        req = self._launch(params, xs, None, forward_only=True)
        return self._wait(req, timeout)

    def stats(self) -> dict:
        hops = {d: c.starts for d, c in self._chan.items()}
        return {
            "steps": self.steps,
            "blocking_waits": self.blocking_waits,
            "hop_starts": hops,
            "hop_rows": self.hop_rows,
            "hop_rows_between_devices": self.hop_rows_between_devices,
            "p2p_stream_completions": self.p2p.stream.completions,
            "p2p_issued": self.p2p.issued,
            "p2p_completed": self.p2p.completed,
            "stage_stream_completions": [s.completions
                                         for s in self.stage_streams],
            "dag_executed": self.queue.executed,
        }

    def close(self):
        self.p2p.close()
        self.queue.close()
        if self.executor is not None:
            for s in self.stage_streams + [self.dag_stream]:
                if self.executor.owns(s):
                    self.executor.release(s)

    # -- DAG construction --------------------------------------------------
    def _launch(self, params, xs, targets, *, forward_only: bool) -> Request:
        S, eng = self.S, self.engine
        M = int(xs.shape[0])
        grid = _build_grid(S, M, forward_only)
        run = _StepRun(grid)
        self.steps += 1

        leaves, self._rebuild = tree_flatten(params)
        run.params_stages = [_stage_params(leaves, s) for s in range(S)]
        # the microbatches enter on stage 0's device; the loss head's
        # targets and scale live on the last stage's
        first, last = self.devices[0], self.devices[-1]
        run.xs = xs.to(first)
        run.targets = None if targets is None else targets.to(last)
        run.scale = torch.tensor(1.0 / M, dtype=torch.float32, device=last)
        run.dp_acc = None if forward_only else [
            [torch.zeros_like(t) for t in run.params_stages[s]]
            for s in range(S)]
        self._ensure_channels(tuple(xs.shape[1:]), xs.dtype)

        # pre-create every completion request the DAG will gate on; the
        # params future covers everything queued above (the zeroed
        # accumulators, the caller's params and batch)
        run.params_ready = [
            torch_future(eng, run.params_stages[s], self.stage_streams[s])
            for s in range(S)]
        for op in grid.ops:
            run.cell_req[(op.stage, op.kind, op.mb)] = Request(
                tag=f"{op.kind}{op.stage}.{op.mb}")
        for d in ("f", "b"):
            for t in grid.hop_order[d]:
                run.hop_rreq[(d, t)] = Request(tag=f"hop{d}@{t}")

        # wire the cells
        prev_on_stage: list = [None] * S
        for op in grid.ops:
            creq = run.cell_req[(op.stage, op.kind, op.mb)]
            deps = [run.params_ready[op.stage]]
            if prev_on_stage[op.stage] is not None:
                deps.append(prev_on_stage[op.stage])
            if op.src_hop is not None:
                deps.append(run.hop_rreq[op.src_hop])
            if op.kind == "B":
                # the stashed activation: the forward cell of (s, m)
                deps.append(run.cell_req[(op.stage, "F", op.mb)])
            node = self.queue.node(
                (lambda *_vals, op=op, creq=creq:
                 self._enqueue_cell(run, op, creq)), deps)
            self.queue.attach(
                node, lambda _rq: None,
                on_error=lambda rq: self._fail(run, rq.exception))
            prev_on_stage[op.stage] = creq

        # wire the hops: one persistent start per (direction, tick),
        # chained per direction (one outstanding start per channel)
        for d in ("f", "b"):
            prev = None
            for t in grid.hop_order[d]:
                rreq = run.hop_rreq[(d, t)]
                edges = grid.hop_edges[(d, t)]
                deps = [run.cell_req[(s, "F" if d == "f" else "B", m)]
                        for s, m in edges]
                if prev is not None:
                    deps.append(prev)
                node = self.queue.node(
                    (lambda *_vals, d=d, t=t, edges=edges, rreq=rreq:
                     self._start_hop(run, d, t, edges, rreq)), deps)
                self.queue.attach(
                    node, lambda _rq: None,
                    on_error=lambda rq: self._fail(run, rq.exception))
                prev = rreq

        # the step gate: every cell retired -> finalize
        gate = self.queue.when_all(list(run.cell_req.values()))
        self.queue.attach(
            gate, lambda _rq: self._finalize(run),
            on_error=lambda rq: self._fail(run, rq.exception))
        return run.done

    # -- node bodies -------------------------------------------------------
    def _enqueue_cell(self, run: _StepRun, op: _Op, creq: Request) -> None:
        """Gate fired: enqueue the one-shot issue task on the stage's
        stream; the adopting worker dispatches the cell on the stage's
        CUDA stream."""
        if run.done.is_complete:
            return

        def issue(_thing):
            if run.done.is_complete:
                return "done"
            t_issue = time.monotonic()
            cs = self.cuda_streams[op.stage]
            # the current device and stream are per thread: enter the
            # stage's device and stream inside the cell
            ctx = torch.cuda.stream(cs) if cs is not None \
                else contextlib.nullcontext()
            try:
                with device_context(self.devices[op.stage]), ctx:
                    out = self._dispatch(run, op, cs)
                    fut = torch_future(self.engine, out,
                                       self.stage_streams[op.stage])
            except BaseException as exc:  # noqa: BLE001
                self._fail(run, exc)
                return "done"

            def _done(_rq):
                run.cell_spans.setdefault(op.stage, []).append(
                    (t_issue, time.monotonic()))
                creq.complete(None)

            self.queue.attach(
                fut, _done,
                on_error=lambda rq: self._fail(
                    run, rq.exception or RuntimeError("cell failed")))
            return "done"

        self.engine.async_start(issue, None, self.stage_streams[op.stage])

    def _dispatch(self, run: _StepRun, op: _Op, cs):
        """Run one cell on the stage's CUDA stream (``cs``, current
        here); the returned tensors gate the cell's completion."""
        s, m = op.stage, op.mb
        p = self._rebuild(run.params_stages[s])
        if op.kind == "F":
            x = run.inbox_f.pop((s, m)) if s > 0 else run.xs[m]
            _for_stream([x] + run.params_stages[s], cs)
            if not run.grid.forward_only:
                run.stash[(s, m)] = x
            y = self._fwd(p, x)
            if s < self.S - 1:
                run.staging[("f", op.tick, s)] = y
            elif run.grid.forward_only:
                run.outputs[m] = y
            return y
        x = run.stash.pop((s, m))
        _for_stream(run.dp_acc[s], cs)
        if s == self.S - 1:
            t = run.targets[m]
            _for_stream([t, run.scale], cs)
            loss, dx, run.dp_acc[s] = self._last_bwd(
                p, x, t, run.scale, run.dp_acc[s])
            run.losses[m] = loss
            if s > 0:
                run.staging[("b", op.tick, s)] = dx
            return (loss, dx, run.dp_acc[s])
        dy = run.inbox_b.pop((s, m))
        _for_stream([dy], cs)
        dx, run.dp_acc[s] = self._bwd(p, x, dy, run.dp_acc[s])
        if s > 0:
            run.staging[("b", op.tick, s)] = dx
        return (dx, run.dp_acc[s])

    def _start_hop(self, run: _StepRun, d: str, t: int, edges,
                   rreq: Request) -> None:
        """All of tick t's producing cells retired: stack their rows
        (zeros elsewhere) and start the persistent channel."""
        if run.done.is_complete:
            return
        rows = list(self._zeros)
        for s, _m in edges:
            rows[s] = run.staging.pop((d, t, s)).unsqueeze(0)
        _for_current(rows)
        payload = RankShards(rows) if self.mesh.per_device \
            else torch.cat(rows)
        chan = self._chan[d]
        try:
            # under the step's lock: either ``_fail`` finds this start
            # among the step's hops and cancels it, or the start sees the
            # step failing and is never made
            with run._lock:
                if run.failing:
                    return
                chan.send.start(payload)
                run.hops.append(chan.persistent.active)
                self.hop_rows += len(rows)
                self.hop_rows_between_devices += sum(
                    a.device != b.device
                    for a, b in zip(rows, rows[1:] + rows[:1]))
            inner = chan.recv.start()
        except BaseException as exc:  # noqa: BLE001
            self._fail(run, exc)
            return

        def deliver(rq):
            # stage s's row: row s of the stacked value, or its shard's one
            value = rq.value()
            rows = [v[0] for v in value.shards] \
                if isinstance(value, RankShards) else value
            for s, m in edges:
                if d == "f":
                    run.inbox_f[(s + 1, m)] = rows[s + 1]
                else:
                    run.inbox_b[(s - 1, m)] = rows[s - 1]
            rreq.complete(None)

        self.queue.attach(
            inner, deliver,
            on_error=lambda rq: self._fail(
                run, rq.exception or RuntimeError("p2p hop failed")))

    def _finalize(self, run: _StepRun) -> None:
        if run.done.is_complete:
            return
        try:
            if run.grid.forward_only:
                ys = [run.outputs[m] for m in range(run.grid.M)]
                _for_current(ys)
                result = torch.stack(ys)
            else:
                losses = [run.losses[m] for m in range(run.grid.M)]
                _for_current(losses + [run.scale])
                loss = losses[0]
                for m in range(1, run.grid.M):
                    loss = loss + losses[m]
                loss = loss * run.scale
                for acc in run.dp_acc:
                    _for_current(acc)
                grads = self._rebuild([
                    _stack_blocks([run.dp_acc[s][i] for s in range(self.S)],
                                  self.mesh.per_device)
                    for i in range(len(run.dp_acc[0]))])
                result = (loss, grads)
        except BaseException as exc:  # noqa: BLE001
            self._fail(run, exc)
            return
        self.last_step_timing = self._timing(run)
        with run._lock:
            if not run.done.is_complete and not run.failing:
                run.done.complete(result)

    def _timing(self, run: _StepRun) -> dict | None:
        """Measured bubble: per-stage idle inside the step window.  Per
        stage, busy = sum of its (serial) cell spans, each from the
        cell's issue to the engine seeing its work done; idle = window -
        busy; the mean idle fraction across stages is directly
        comparable to :func:`bubble_fraction`'s analytic value."""
        spans = run.cell_spans
        if len(spans) != self.S or not all(spans.values()):
            return None
        t_lo = min(t0 for ss in spans.values() for t0, _ in ss)
        t_hi = max(t1 for ss in spans.values() for _, t1 in ss)
        window = max(t_hi - t_lo, 1e-9)
        idle = [window - sum(t1 - t0 for t0, t1 in spans[s])
                for s in range(self.S)]
        return {"window_s": window, "idle_s": idle,
                "bubble": sum(idle) / (window * self.S),
                "cells": [len(spans[s]) for s in range(self.S)],
                "grid_ticks": run.grid.ticks}

    # -- helpers -----------------------------------------------------------
    def _fail(self, run: _StepRun, exc: BaseException | None) -> None:
        exc = exc or RuntimeError("pipeline step failed")
        with run._lock:
            if run.done.is_complete or run.failing:
                return
            run.failing = True
            hops = list(run.hops)
        # cancel the step's hops still in flight before its request
        # fails: the caller's next step then finds each persistent
        # channel free, and a cancelled start's successor gets fresh
        # workspaces.  (The JAX ``_fail`` leaves them running, and the
        # next step's first hop can find its channel still active.)
        for hop in hops:
            hop.cancel()
        with run._lock:
            if not run.done.is_complete:
                run.done.fail(exc)
        # release every still-pending gate so sibling branches retire
        # instead of hanging (their nodes observe done and no-op)
        for req in list(run.cell_req.values()) + list(run.hop_rreq.values()):
            if not req.is_complete:
                try:
                    req.fail(exc)
                except BaseException:  # noqa: BLE001
                    pass

    def _ensure_channels(self, act_shape, dtype) -> None:
        sig = (tuple(act_shape), dtype)
        if self._act_sig == sig:
            return
        if self._act_sig is not None:
            for c in self._chan.values():
                c.close()
            self._chan = {}
        self._act_sig = sig
        self._zeros = [torch.zeros((1,) + tuple(act_shape), dtype=dtype,
                                   device=d) for d in self.devices]
        if self.S > 1:
            like = torch.empty((self.S,) + tuple(act_shape), dtype=dtype,
                               device="meta")
            self._chan = {
                "f": self.p2p.channel_init(like, self.mesh, self.axis,
                                           tag=f"{self.name}-act",
                                           warmup=False),
                "b": self.p2p.channel_init(like, self.mesh, self.axis,
                                           tag=f"{self.name}-grad",
                                           reverse=True, warmup=False),
            }

    def _wait(self, req: Request, timeout: float):
        """The only blocking wait in the lifecycle: drive progress (or
        yield to the executor) until the step's DAG completes."""
        self.blocking_waits += 1
        ex = self.executor if self.executor is not None \
            else self.engine.executor
        owned = ex is not None and ex.running and ex.owns(self.dag_stream)
        t0 = time.monotonic()
        while not req.is_complete:
            if owned:
                time.sleep(20e-6)
            else:
                made = self.engine.progress_all()
                if not made:
                    time.sleep(5e-6)
            if timeout is not None and not req.is_complete \
                    and time.monotonic() - t0 > timeout:
                raise TimeoutError(
                    f"pipeline step timed out after {timeout}s "
                    f"({self.stats()})")
        return req.value()

    def __repr__(self):
        return (f"PipelineSchedule(S={self.S}, axis={self.axis!r}, "
                f"steps={self.steps})")
