"""Serving launcher of the port: continuous batching on the progress engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --scale full                       # on the card (the default)
    PYTHONPATH=src python -m repro_torch.launch.serve --scale tiny \
        --device cpu                       # plain versions, on the CPU

Continuous batching on a paged KV cache (length-bucketed admission,
chunked prefill interleaved with decode, preemption under block
pressure), as the JAX package's ``repro.launch.serve``; its sharding and
fault-tolerance flags are not ported yet.  Weights are random, drawn from
seed 0 by a ``torch.Generator`` on the device, as the JAX launcher draws
them from ``PRNGKey(0)``.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

# The example scales of the JAX package's examples/train_lm.py (a copy:
# the port imports nothing of the JAX package).
SCALES = {
    # ~1M params: fast CPU demo
    "tiny": dict(num_layers=2, d_model=64, d_ff=128, vocab_size=512,
                 num_heads=4, num_kv_heads=2, head_dim=16, remat_policy="none"),
    # ~25M params: slower but meaningful loss curves on CPU
    "small": dict(num_layers=4, d_model=256, d_ff=1024, vocab_size=4096,
                  num_heads=8, num_kv_heads=4, head_dim=32, remat_policy="none"),
    "full": {},
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--scale", default="tiny", choices=list(SCALES))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--min-prompt", type=int, default=2,
                    help="shortest prompt, in tokens")
    ap.add_argument("--max-prompt", type=int, default=7,
                    help="longest prompt, in tokens")
    ap.add_argument("--kv-block-size", type=int, default=16,
                    help="positions per KV block")
    ap.add_argument("--kv-blocks", type=int, default=0,
                    help="total pool blocks incl. the reserved scratch "
                         "block (0 = slots*ceil(max_seq/block)+1, i.e. "
                         "every lane can hold max_seq)")
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="fused prefill calls interleaved per admission "
                         "round before decode resumes")
    ap.add_argument("--progress-workers", type=int, default=0,
                    help="N background progress threads (0 = caller-driven)")
    ap.add_argument("--continuation-policy", default="deferred",
                    choices=["inline", "deferred"],
                    help="completion callbacks run inline on the progress "
                         "thread, or deferred to a bounded owner drain")
    ap.add_argument("--continuation-max-drain", type=int, default=64,
                    help="max continuations executed per drain (deferred "
                         "policy backpressure bound)")
    ap.add_argument("--stats", action="store_true",
                    help="print progress statistics after serving")
    return ap


def make_config(arch: str, scale: str):
    """``arch`` at ``scale``: the example scales shrink the SSM too, as
    the JAX launchers do."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    overrides = dict(SCALES[scale])
    if overrides and cfg.ssm:
        overrides["ssm"] = cfg.ssm.__class__(d_state=16, expand=2,
                                             head_dim=16, chunk_size=16)
    return cfg.with_overrides(**overrides) if overrides else cfg


@dataclasses.dataclass
class ServeReport:
    server: object                 # the closed ServeEngine (params, cache)
    requests: list                 # the GenRequests, in submit order
    tokens: int
    steps: int                     # fused decode steps
    prefill_calls: int             # fused prefill calls
    wall_s: float                  # first submit -> idle, host clock
    latency: object                # ServeLatencyStats
    sched: object                  # SchedulerStats
    stats: object                  # EngineStats

    def format(self) -> list[str]:
        calls = self.steps + self.prefill_calls
        return [
            f"served {len(self.requests)} requests, {self.tokens} tokens in "
            f"{self.steps} fused decode steps + {self.prefill_calls} fused "
            f"prefill calls in {self.wall_s:.3f} s "
            f"({self.tokens / self.wall_s:.1f} tokens/s, "
            f"{self.wall_s * 1e3 / max(calls, 1):.3f} ms per fused call, "
            f"mean decode step {self.server.mean_step_ms():.3f} ms)",
            self.latency.format(),
            self.sched.format(),
        ]


def run(args, **cfg_overrides) -> ServeReport:
    """Serve as the command line asks; ``cfg_overrides`` replace fields of
    the ``ModelConfig`` that the JAX launcher has no flags for either
    (e.g. ``kv_cache_dtype="int8"``)."""
    from repro_torch import resolve_device
    from repro_torch.core import ProgressEngine, ProgressExecutor
    from repro_torch.core import stats as stats_mod
    from repro_torch.models import registry
    from repro_torch.serve.engine import GenRequest, ServeEngine

    device = resolve_device(args.device)
    cfg = make_config(args.arch, args.scale).with_overrides(**cfg_overrides)
    gen = torch.Generator(device=device).manual_seed(0)
    eng = ProgressEngine()
    executor = None
    if args.progress_workers > 0:
        executor = ProgressExecutor(
            eng, args.progress_workers,
            continuation_max_drain=args.continuation_max_drain)
    srv = ServeEngine(cfg, registry.init_params(cfg, gen), eng,
                      batch_slots=args.slots, max_seq=args.max_seq,
                      executor=executor,
                      continuation_policy=args.continuation_policy,
                      continuation_max_drain=args.continuation_max_drain,
                      kv_block_size=args.kv_block_size,
                      kv_blocks=args.kv_blocks or None,
                      prefill_chunk=args.prefill_chunk, device=device)
    if executor is not None:
        executor.start()
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, cfg.vocab_size - 1,
                           size=rng.randint(args.min_prompt,
                                            args.max_prompt + 1)
                           ).astype(np.int32)
               for _ in range(args.requests)]
    reqs = [GenRequest(f"req{i}", p, max_new_tokens=args.max_new)
            for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    for r in reqs:
        srv.submit(r)
    srv.run_until_idle(timeout=600)
    wall = time.perf_counter() - t0
    snap = stats_mod.collect(eng, executor)   # before close drops the queue
    lat = srv.latency_snapshot()              # before close, too
    sched = srv.scheduler_snapshot()
    srv.close(timeout=60)
    if executor is not None:
        executor.shutdown(drain=True, timeout=60)
    return ServeReport(srv, reqs, sum(len(r.out_tokens) for r in reqs),
                       srv.steps, sched.prefill_calls, wall, lat, sched, snap)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    report = run(args)
    mode = (f"{args.progress_workers} progress workers"
            if args.progress_workers > 0 else "caller-driven progress")
    print(f"[{args.arch} scale={args.scale} device={args.device}, {mode}]")
    for line in report.format():
        print(line)
    if args.stats:
        from repro_torch.core import stats as stats_mod
        print(stats_mod.format_stats(report.stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
