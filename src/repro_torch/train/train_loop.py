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
step.  The split-step collective backends (``UserCollectiveStep``,
``FsdpStep``), ``epoch`` and ``remesh_fn`` wait for the collectives and
elastic slices.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

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


class Trainer:
    def __init__(self, step_fn: Callable, params, opt_state,
                 pipeline, cfg: TrainLoopConfig,
                 engine: Optional[ProgressEngine] = None,
                 hooks: list[Callable[[int, dict], None]] | None = None,
                 split_step=None):
        """``step_fn(params, opt_state, batch) -> (params, opt_state,
        metrics)`` dispatches one step (metrics: 0-d tensors).  Only the
        native path is ported: a ``split_step`` raises."""
        if split_step is not None:
            raise NotImplementedError(
                "split-step backends (UserCollectiveStep/FsdpStep) are not "
                "ported yet (collectives slice)")
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.pipeline = pipeline
        self.cfg = cfg
        self.engine = engine or global_engine()
        self.hooks = hooks or []
        self.ckpt = AsyncCheckpointer(cfg.checkpoint_dir, self.engine)
        self.straggler = StragglerDetector()
        self.watchdog = StepWatchdog(self.engine, cfg.watchdog_limit_s,
                                     on_hang=self._on_hang)
        self.start_step = 0
        self.metrics_log: list[dict] = []
        self._pending_ckpt: Request | None = None
        self._hung = False

    # ------------------------------------------------------------------
    def _on_hang(self):
        self._hung = True

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
            # dispatch: returns once the step's kernels are queued
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            loss_req = torch_future(self.engine, metrics)

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
