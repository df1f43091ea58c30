"""Training loop — every async subsystem hangs off ONE progress engine
(the port of the JAX package's ``train/train_loop.py``, native path).

The loop body is the paper's Figure 4(b) pattern:

    dispatch step N (PyTorch returns once the step's kernels are queued
    on the CUDA stream)
    ── while the card runs ──
    engine.progress():  data prefetch fills, checkpoint stages advance,
                        the watchdog is checked
    block on step N's metrics only when needed (torch_future completion)

``torch_future`` (a CUDA event polled by the engine) replaces the JAX
package's ``jax_future``, and the metrics are read with ``.item()`` only
after the engine wait, so the host never syncs on the card inside the
step.

The user collective backend runs a split step (``UserCollectiveStep``):
per-rank gradients stacked on a leading rank dim (or, with a device per
rank, ``RankShards`` leaves), reduced by an ``EngineGradReducer`` whose
persistent bucketed allreduces progress on the collective stream of the
same engine, then the optimizer.
``FsdpStep`` runs ZeRO-style FSDP: the step's full parameters are
all-gathered from flat shards (the next step's gathers chained off the
optimizer's compute futures), the gradients reduce-scattered, and the
optimizer steps on the shards.  With a membership ``epoch`` and a
``remesh_fn`` a ``MembershipError`` raised mid-step (a dead peer, a hung
step) is recovered within the step: rebuild on the survivors, retry the
same batch.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Optional

from repro_torch.collectives.nonblocking import CollectiveSpec, \
    MembershipError, spec_from_legacy
from repro_torch.core import ProgressEngine, ProgressExecutor, \
    global_engine, torch_future
from repro_torch.core.request import Request
from repro_torch.distributed.fault_tolerance import StepWatchdog, \
    StragglerDetector
from repro_torch.train.checkpoint import AsyncCheckpointer


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    log_every: int = 10
    watchdog_limit_s: float = 600.0
    resume: bool = True
    # >0: that many background progress workers drive prefetch/checkpoint/
    # watchdog tasks (§4.4); 0: the overlap window self-progresses
    progress_workers: int = 0
    # gradient-reduction configuration: ONE CollectiveSpec covers the
    # backend ("native": the reduction is inside the step; "user":
    # nonblocking user-space collectives on the progress engine, which
    # needs a split step, see ``UserCollectiveStep``), algorithm, chunk
    # count and round batching.  The collective_* fields are the
    # deprecated spelling: accepted (a DeprecationWarning fires once) and
    # mirrored from the resolved spec.
    collective_spec: "CollectiveSpec | None" = None
    collective_backend: "str | None" = None
    collective_algorithm: "str | None" = None
    collective_chunks: "int | None" = None
    collective_round_batch: "int | None" = None
    # pipeline-parallel schedule this loop runs under ("none", "gpipe",
    # "1f1b") — a record field like collective_spec.backend: the
    # launcher carries the machinery (a PipelineSchedule per data row),
    # the config is what logs and stats report
    pipeline: str = "none"

    _DEFAULT_SPEC = CollectiveSpec(backend="native", algorithm="ring",
                                   chunks=4, round_batch=0)

    def __post_init__(self):
        spec = self.collective_spec
        legacy = (("backend", self.collective_backend),
                  ("algorithm", self.collective_algorithm),
                  ("chunks", self.collective_chunks),
                  ("round_batch", self.collective_round_batch))
        if spec is not None:
            # mirrored legacy fields (a dataclasses.replace round-trip)
            # must agree with the spec; a conflicting one is a config bug
            for name, val in legacy:
                if val is not None and val != getattr(spec, name):
                    raise ValueError(
                        f"TrainLoopConfig: collective_spec.{name}="
                        f"{getattr(spec, name)!r} conflicts with legacy "
                        f"collective_{name}={val!r}; pass one, not both")
        else:
            spec = spec_from_legacy(
                None, surface="TrainLoopConfig",
                backend=self.collective_backend,
                algorithm=self.collective_algorithm,
                chunks=self.collective_chunks,
                round_batch=self.collective_round_batch,
                default=self._DEFAULT_SPEC)
        self.collective_spec = spec
        self.collective_backend = spec.backend
        self.collective_algorithm = spec.algorithm
        self.collective_chunks = spec.chunks
        self.collective_round_batch = spec.round_batch


def _check_spec(spec) -> None:
    if spec is not None and not isinstance(spec, CollectiveSpec):
        raise TypeError(
            f"spec must be a CollectiveSpec, got {type(spec).__name__} "
            f"(legacy kwargs belong on TrainLoopConfig)")


@dataclasses.dataclass
class UserCollectiveStep:
    """Split train step for the engine-driven collective backend.

    ``grad_fn(params, batch) -> (stacked_metrics, stacked_grads)`` —
    per-rank metrics and f32 gradients stacked on a leading rank dim, or
    ``RankShards`` leaves on a mesh with a device per rank (the params
    and optimizer state are then trees of per-rank replicas, and the
    step's wait covers every device they live on);
    ``reducer`` (an ``EngineGradReducer``) allreduces the gradients on
    the collective stream while the engine also progresses prefetch and
    checkpoint tasks; ``apply_fn(params, opt_state, grads,
    stacked_metrics) -> (params, opt_state, metrics)`` finishes the step.
    ``spec`` records the reducer's ``CollectiveSpec``."""
    grad_fn: Callable
    apply_fn: Callable
    reducer: Any
    spec: "CollectiveSpec | None" = None

    def __post_init__(self):
        _check_spec(self.spec)


@dataclasses.dataclass
class FsdpStep:
    """Split train step for ZeRO-style FSDP on the user backend.

    Parameters live as *flat shard stacks* (``FsdpLayout.shard_params``
    — one ``[n, W/n]`` tensor per bucket, rank ``r`` owning row ``r``; on
    a mesh with a device per rank one ``RankShards`` per bucket, rank
    ``r``'s block on its device, and every payload below likewise):

    * ``grad_fn(gathered_flats, batch) -> (stacked_metrics,
      flat_grads)`` — takes the all-gathered full flat buckets ``[n,
      W]``, rank r's forward reading row r, and returns per-rank metrics
      plus stacked f32 flat grad buckets ``[n, W]``;
    * ``reducer`` (an :class:`~repro_torch.collectives.overlap.
      FsdpReducer`) reduce-scatters the grad buckets — each rank
      receives only its own block — and prefetches the next step's
      params via continuation-chained persistent all-gathers;
    * ``apply_fn(shards, opt_state, grad_shards, stacked_metrics) ->
      (shards, opt_state, metrics)`` — the sharded optimizer step.

    ``spec`` as in :class:`UserCollectiveStep`."""
    grad_fn: Callable
    apply_fn: Callable
    reducer: Any
    spec: "CollectiveSpec | None" = None

    def __post_init__(self):
        _check_spec(self.spec)


class Trainer:
    def __init__(self, step_fn: Callable, params, opt_state,
                 pipeline, cfg: TrainLoopConfig,
                 engine: Optional[ProgressEngine] = None,
                 hooks: list[Callable[[int, dict], None]] | None = None,
                 split_step: "UserCollectiveStep | FsdpStep | None" = None,
                 epoch=None, remesh_fn: Callable | None = None):
        """``step_fn(params, opt_state, batch) -> (params, opt_state,
        metrics)`` dispatches one step (metrics: 0-d tensors).  With a
        ``split_step`` (the user collective backend) each step is its
        ``grad_fn``, the engine-driven reduction and its ``apply_fn``;
        the config's backend follows the split step, and a "user"
        backend without one raises.

        ``epoch``: a collectives ``MembershipEpoch`` shared with the
        reducer's persistent handles; the watchdog invalidates it when a
        step hangs, so the in-flight reduction fails retryably instead
        of deadlocking the loop.  ``remesh_fn(exc, params, opt_state) ->
        (split_step, params, opt_state)`` rebuilds the split step on the
        survivors' mesh; with it set, a ``MembershipError`` from the
        step is recovered within the same step: rebuild, then retry the
        step's batch (counted in ``recoveries``)."""
        if split_step is not None and cfg.collective_backend != "user":
            cfg = dataclasses.replace(
                cfg,
                collective_spec=dataclasses.replace(cfg.collective_spec,
                                                    backend="user"),
                collective_backend="user")
        elif split_step is None and cfg.collective_backend == "user":
            raise ValueError(
                "collective_backend='user' requires a split_step "
                "(UserCollectiveStep or FsdpStep with "
                "grad_fn/apply_fn/reducer)")
        self.step_fn = step_fn
        self.split_step = split_step
        self.params = params
        self.opt_state = opt_state
        self.pipeline = pipeline
        self.cfg = cfg
        self.engine = engine or global_engine()
        self.hooks = hooks or []
        self.ckpt = AsyncCheckpointer(cfg.checkpoint_dir, self.engine)
        self.straggler = StragglerDetector()
        self.epoch = epoch
        self.remesh_fn = remesh_fn
        self.watchdog = StepWatchdog(self.engine, cfg.watchdog_limit_s,
                                     on_hang=self._on_hang, epoch=epoch)
        self.start_step = 0
        self.recoveries = 0
        self.reduce_issue_s: list[float] = []   # host time to issue each
        #                                         step's reduction
        self.metrics_log: list[dict] = []
        self._pending_ckpt: Request | None = None
        self._pending_gather = None     # FsdpStep: chained param prefetch
        self._hung = False

    # ------------------------------------------------------------------
    def _on_hang(self):
        self._hung = True

    def _split_step_once(self, batch):
        """Split-step grad dispatch, the engine-driven bucketed
        reduction, then the optimizer; returns the metrics.  Raises
        ``MembershipError`` retryably (params not yet updated)."""
        ss = self.split_step
        limit = self.cfg.watchdog_limit_s
        if isinstance(ss, FsdpStep):
            if self._pending_gather is None:
                # cold start (or post-remesh): no prefetch in flight —
                # issue the continuation-chained gather and wait it here
                self._pending_gather = ss.reducer.igather(self.params)
            flats = self._pending_gather.wait(timeout=limit)
            self._pending_gather = None
            stacked_metrics, flat_grads = ss.grad_fn(flats, batch)
            del flats
            reduction = ss.reducer.ireduce_scatter(flat_grads)
            del flat_grads
            grad_shards = reduction.wait(timeout=limit)
            self.params, self.opt_state, metrics = ss.apply_fn(
                self.params, self.opt_state, grad_shards, stacked_metrics)
            # prefetch the next step's full params NOW: each bucket's
            # persistent all-gather start is chained off that bucket's
            # compute future (a CUDA event after the in-place optimizer on
            # each card the bucket's blocks live on, polled on the
            # reducer's collective stream), so it fires on
            # the first sweep of that stream after the optimizer's work —
            # a worker's that owns the stream, or at the latest the next
            # step's gather wait (§4.6 continuations)
            self._pending_gather = ss.reducer.igather(
                self.params, after=[ss.reducer.future(s)
                                    for s in self.params])
            return metrics
        stacked_metrics, grads = ss.grad_fn(self.params, batch)
        reduction = ss.reducer.iallreduce_tree(grads)
        self.reduce_issue_s.append(reduction.issue_s)
        del grads
        grads = reduction.wait(timeout=self.cfg.watchdog_limit_s)
        self.params, self.opt_state, metrics = ss.apply_fn(
            self.params, self.opt_state, grads, stacked_metrics)
        return metrics

    def maybe_resume(self):
        if not self.cfg.resume:
            return
        latest = self.ckpt.latest_step()
        if latest is not None:
            state = self.ckpt.restore(latest, {"params": self.params,
                                               "opt_state": self.opt_state})
            self.params = state["params"]
            self.opt_state = state["opt_state"]
            self.start_step = latest + 1

    # ------------------------------------------------------------------
    def run(self) -> list[dict]:
        executor = None
        if self.cfg.progress_workers > 0:
            # background progress (§4.4): workers own the default stream's
            # async tasks (prefetch fills, checkpoint stages, futures) plus
            # the subsystem hooks; the overlap window below then *waits*
            # (engine.wait yields to the executor) instead of polling
            executor = ProgressExecutor(self.engine,
                                        self.cfg.progress_workers)
            executor.adopt(self.engine.default_stream)
            executor.start()
        try:
            return self._run_loop()
        finally:
            if executor is not None:
                executor.shutdown(drain=True, timeout=600)

    def _run_loop(self) -> list[dict]:
        self.maybe_resume()
        for step in range(self.start_step, self.cfg.total_steps):
            batch = self.pipeline.next_batch()     # warm path: no block
            t0 = time.monotonic()
            self.watchdog.arm()
            if self.split_step is not None:
                # engine-driven collective backend: local gradients, the
                # nonblocking bucketed allreduce on the collective stream
                # (the engine overlaps it with prefetch/checkpoint work),
                # then the optimizer
                try:
                    metrics = self._split_step_once(batch)
                except MembershipError as exc:
                    if self.remesh_fn is None:
                        raise
                    # membership changed mid-step (dead peer or hung
                    # collective): rebuild the split step on survivors
                    # and retry THIS step's batch.  Params were not yet
                    # updated, so the retried step computes exactly what
                    # a from-checkpoint restart at this step would.  An
                    # in-flight FSDP prefetch died with the old epoch —
                    # drop it; the retry re-gathers on the new mesh.
                    self._pending_gather = None
                    self.split_step, self.params, self.opt_state = \
                        self.remesh_fn(exc, self.params, self.opt_state)
                    self.recoveries += 1
                    self._hung = False
                    self.watchdog.arm()
                    metrics = self._split_step_once(batch)
            else:
                # dispatch: returns once the step's kernels are queued
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, batch)
            # the step is done when the metrics are and the optimizer's
            # update on every device the parameters live on (one polled
            # event per device: a step over replicas or blocks on several
            # cards is not done when rank 0's card is)
            loss_req = torch_future(self.engine, (metrics, self.params))

            # overlap window: drive collated progress until the card is
            # done (with progress workers attached, wait yields to them)
            self.engine.wait(loss_req)
            self.watchdog.disarm()
            dur = time.monotonic() - t0
            self.straggler.record("self", dur)

            if (step + 1) % self.cfg.checkpoint_every == 0 \
                    or step == self.cfg.total_steps - 1:
                # async save: the device→host copies are enqueued here,
                # before the next step's in-place update
                self._pending_ckpt = self.ckpt.save_async(
                    step, {"params": self.params, "opt_state": self.opt_state})

            if step % self.cfg.log_every == 0 or step == self.cfg.total_steps - 1:
                m = {k: float(v.item()) for k, v in metrics.items()}
                m["step"] = step
                m["step_time_s"] = dur
                self.metrics_log.append(m)
                for hook in self.hooks:
                    hook(step, m)
            if self._hung:
                raise RuntimeError("watchdog: step exceeded wall-clock limit")
        # finalize: drain pending checkpoint I/O (paper Listing 1.2 note:
        # finalize spins progress until all async tasks complete)
        if self._pending_ckpt is not None:
            self.engine.wait(self._pending_ckpt, timeout=600)
        return self.metrics_log
