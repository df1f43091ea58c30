"""Serving launcher of the port: continuous batching on the progress engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --scale full                       # on the card (the default)
    PYTHONPATH=src python -m repro_torch.launch.serve --scale tiny \
        --device cpu                       # plain versions, on the CPU

Continuous batching on a paged KV cache (length-bucketed admission,
chunked prefill interleaved with decode, preemption under block
pressure), as the JAX package's ``repro.launch.serve``.  Weights are
random, drawn from seed 0 by a ``torch.Generator`` on the device, as the
JAX launcher draws them from ``PRNGKey(0)``.

Model-axis-sharded decode (vocab-parallel unembed) with the per-step
logits all-gather native (a gather over the rank dim) or as a persistent
user-space all-gather on the serve-collective stream; ``--devices N``
puts N ranks on the one device, as the train launcher does:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --devices 4 --model-shards 4 --collective-backend user

``--rank-devices cuda:0,cuda:1,...`` (as many as ``--model-shards``)
puts each model rank on a device of its own instead: a replica of the
weights and of the paged pool on each, every rank's decode and
vocabulary slice computed there, the gather a copy between the devices
(``serve.engine``):

    PYTHONPATH=src python -m repro_torch.launch.serve --scale full \
        --model-shards 4 --rank-devices cuda:0,cuda:1,cuda:2,cuda:3 \
        --collective-backend user

Fault tolerance: one ``MembershipEpoch`` shared by the heartbeat monitor
(``--heartbeat-timeout``), the step watchdog (``--watchdog-limit``, armed
while the launcher serves; the JAX launcher builds it unarmed) and the
engine's persistent all-gather.  ``--chaos-kill N`` serves half the
requests, invalidates the epoch down to the survivors, and serves the
other half on the rebuilt mesh.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

def build_parser() -> argparse.ArgumentParser:
    from repro_torch.examples.train_lm import SCALES
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
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks on the one device (0 = 1)")
    ap.add_argument("--model-shards", type=int, default=0,
                    help="shard decode over a 'model' mesh axis of this "
                         "size (0 = unsharded)")
    ap.add_argument("--rank-devices", default="",
                    help="a device per model rank, comma-separated (e.g. "
                         "cuda:0,cuda:1,cuda:2,cuda:3; a device may "
                         "repeat); as many as --model-shards")
    ap.add_argument("--collective-backend", default="native",
                    choices=["native", "user"],   # -> one CollectiveSpec
                    help="per-step logits all-gather: native (a gather "
                         "over the rank dim), or persistent user-space "
                         "allgather on the serve-collective stream")
    ap.add_argument("--collective-chunks", type=int, default=1,
                    help="chunk pipelining factor for the user backend")
    ap.add_argument("--collective-round-batch", type=int, default=0,
                    help="rounds fused per dispatch in the user backend "
                         "(0 = auto from payload size)")
    ap.add_argument("--progress-workers", type=int, default=0,
                    help="N background progress threads (0 = caller-driven)")
    ap.add_argument("--continuation-policy", default="deferred",
                    choices=["inline", "deferred"],
                    help="completion callbacks run inline on the progress "
                         "thread, or deferred to a bounded owner drain")
    ap.add_argument("--continuation-max-drain", type=int, default=64,
                    help="max continuations executed per drain (deferred "
                         "policy backpressure bound)")
    ap.add_argument("--heartbeat-timeout", type=float, default=0.0,
                    help="enable a HeartbeatMonitor subsystem with this "
                         "peer timeout in seconds (0 = off); a dead peer "
                         "invalidates the membership epoch and the server "
                         "drains, remeshes and re-admits")
    ap.add_argument("--watchdog-limit", type=float, default=0.0,
                    help="enable a StepWatchdog subsystem with this "
                         "wall-clock limit in seconds on each serving run "
                         "(0 = off)")
    ap.add_argument("--chaos-kill", type=int, default=0,
                    help="simulate the death of N ranks after half the "
                         "requests finish (invalidates the membership "
                         "epoch) and report the recovery")
    ap.add_argument("--stats", action="store_true",
                    help="print progress statistics after serving")
    return ap


def make_config(arch: str, scale: str):
    """``arch`` at ``scale``: the example scales shrink the experts, the
    SSM, the hybrid's grouping and the encoder too, as the JAX launchers
    do."""
    from repro_torch.configs import get_config
    from repro_torch.examples.train_lm import SCALES
    cfg = get_config(arch)
    overrides = dict(SCALES[scale])
    if not overrides:
        return cfg
    if cfg.moe:
        overrides["moe"] = cfg.moe.__class__(
            num_experts=4, top_k=2, expert_d_ff=overrides["d_ff"] // 2,
            group_size=64)
    if cfg.ssm:
        overrides["ssm"] = cfg.ssm.__class__(d_state=16, expand=2,
                                             head_dim=16, chunk_size=16)
    if cfg.shared_attn_every:
        overrides.update(num_layers=5, shared_attn_every=2,
                         shared_attn_lora_rank=8)
    if cfg.is_encoder_decoder:
        overrides.update(num_encoder_layers=2, encoder_frames=16,
                         max_position_embeddings=256)
    return cfg.with_overrides(**overrides)


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
    model_shards: int = 0          # the --model-shards asked for (0 = none)
    backend: str = "native"
    remeshes: int = 0              # membership changes applied
    starts: int | None = None      # the user gather's starts (None: no handle)

    def format(self) -> list[str]:
        calls = self.steps + self.prefill_calls
        shard = (f"model-shards={self.model_shards} backend={self.backend}"
                 f", gather starts {self.starts}, remeshes {self.remeshes}; "
                 if self.model_shards > 0 else "")
        return [
            f"served {len(self.requests)} requests, {self.tokens} tokens in "
            f"{self.steps} fused decode steps + {self.prefill_calls} fused "
            f"prefill calls in {self.wall_s:.3f} s [{shard}"
            f"{self.tokens / self.wall_s:.1f} tokens/s, "
            f"{self.wall_s * 1e3 / max(calls, 1):.3f} ms per fused call, "
            f"mean decode step {self.server.mean_step_ms():.3f} ms]",
            self.latency.format(),
            self.sched.format(),
        ]


def run(args, **cfg_overrides) -> ServeReport:
    """Serve as the command line asks; ``cfg_overrides`` replace fields of
    the ``ModelConfig`` that the JAX launcher has no flags for either
    (e.g. ``kv_cache_dtype="int8"``)."""
    from repro_torch import resolve_device
    from repro_torch.collectives.nonblocking import (CollectiveSpec,
                                                     MembershipEpoch)
    from repro_torch.core import ProgressEngine, ProgressExecutor
    from repro_torch.core import stats as stats_mod
    from repro_torch.distributed.fault_tolerance import (HeartbeatMonitor,
                                                         StepWatchdog)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry
    from repro_torch.serve.engine import GenRequest, ServeEngine

    rank_devices = None
    if args.rank_devices:
        rank_devices = [d.strip() for d in args.rank_devices.split(",")]
        if len(rank_devices) != args.model_shards:
            raise SystemExit(f"--rank-devices names {len(rank_devices)} "
                             f"device(s) for --model-shards "
                             f"{args.model_shards}")
        if args.devices and args.devices != len(rank_devices):
            raise SystemExit(f"--rank-devices names {len(rank_devices)} "
                             f"device(s), --devices {args.devices}")
        args.devices = len(rank_devices)
    n_ranks = max(args.devices, 1)
    if args.model_shards > n_ranks:
        raise SystemExit(f"--model-shards {args.model_shards} > {n_ranks} "
                         f"devices (use --devices)")
    if args.model_shards <= 0 and args.collective_backend == "user":
        raise SystemExit("--collective-backend user requires --model-shards "
                         ">= 1 (the user backend is the sharded decode's "
                         "logits all-gather)")
    spec = CollectiveSpec(backend=args.collective_backend,
                          chunks=args.collective_chunks,
                          round_batch=args.collective_round_batch or None)
    device = resolve_device(args.device)
    cfg = make_config(args.arch, args.scale).with_overrides(**cfg_overrides)
    gen = torch.Generator(device=device).manual_seed(0)
    eng = ProgressEngine()
    executor = None
    if args.progress_workers > 0:
        executor = ProgressExecutor(
            eng, args.progress_workers,
            continuation_max_drain=args.continuation_max_drain)
    mesh = None
    if rank_devices is not None:
        try:
            mesh = make_mesh((args.model_shards,), ("model",),
                             devices=rank_devices)
        except RuntimeError as exc:
            raise SystemExit(f"--rank-devices: {exc}") from None
    elif args.model_shards > 0:
        mesh = make_mesh((args.model_shards,), ("model",), device)
    # fault tolerance: one membership epoch shared by the monitors and
    # the serve engine's persistent collectives — a dead peer or a hung
    # run fails in-flight starts retryably, and the engine drains,
    # remeshes onto the survivors, and re-admits from the backlog
    epoch = heartbeat = watchdog = None
    if args.heartbeat_timeout > 0 or args.watchdog_limit > 0 \
            or args.chaos_kill > 0:
        epoch = MembershipEpoch(n_devices=n_ranks)
        if args.heartbeat_timeout > 0:
            heartbeat = HeartbeatMonitor(
                eng, [f"rank{i}" for i in range(n_ranks)],
                timeout=args.heartbeat_timeout, epoch=epoch)
        if args.watchdog_limit > 0:
            watchdog = StepWatchdog(eng, limit=args.watchdog_limit,
                                    epoch=epoch)
    srv = ServeEngine(cfg, registry.init_params(cfg, gen), eng,
                      batch_slots=args.slots, max_seq=args.max_seq,
                      executor=executor,
                      continuation_policy=args.continuation_policy,
                      continuation_max_drain=args.continuation_max_drain,
                      mesh=mesh, collective_spec=spec,
                      kv_block_size=args.kv_block_size,
                      kv_blocks=args.kv_blocks or None,
                      prefill_chunk=args.prefill_chunk, epoch=epoch,
                      device=None if rank_devices is not None else device)
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

    def serve(batch):
        for r in batch:
            srv.submit(r)
        if watchdog is not None:
            watchdog.arm()
        srv.run_until_idle(timeout=600)
        if watchdog is not None:
            watchdog.disarm()

    t0 = time.perf_counter()
    if args.chaos_kill > 0:
        half = max(1, args.requests // 2)
        serve(reqs[:half])
        survivors = max(1, n_ranks - args.chaos_kill)
        t_kill = time.perf_counter()
        epoch.invalidate(survivors=survivors,
                         reason=f"--chaos-kill {args.chaos_kill}")
        serve(reqs[half:])
        print(f"chaos: killed {args.chaos_kill} device(s) -> {survivors} "
              f"survivors; remeshes={srv.remeshes}, second half served "
              f"in {(time.perf_counter() - t_kill) * 1e3:.1f} ms")
    else:
        serve(reqs)
    wall = time.perf_counter() - t0
    if heartbeat is not None:
        for peer in heartbeat.alive:
            heartbeat.beat(peer)
    snap = stats_mod.collect(eng, executor)   # before close drops the queue
    lat = srv.latency_snapshot()              # before close, too
    sched = srv.scheduler_snapshot()
    starts = srv._ag_handle.starts if srv._ag_handle is not None else None
    srv.close(timeout=60)
    if executor is not None:
        executor.shutdown(drain=True, timeout=60)
    return ServeReport(srv, reqs, sum(len(r.out_tokens) for r in reqs),
                       srv.steps, sched.prefill_calls, wall, lat, sched, snap,
                       model_shards=args.model_shards,
                       backend=args.collective_backend,
                       remeshes=srv.remeshes, starts=starts)


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
