"""Training launcher of the port: one card, the trainer on the progress
engine.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --scale full --global-batch 8 --seq 1024 --steps 6   # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --scale tiny --steps 6                 # plain versions, on the CPU

The single-card native path of the JAX package's ``repro.launch.train``:
synthetic data prefetched on the engine, a forward + backward + AdamW
step (``make_train_step``, the body of the JAX ``build_cell`` train step,
with microbatch accumulation and the bf16 cast), async checkpoints and
the step watchdog on the same engine.  Batches move to the card from
pinned host memory.  Weights are random, drawn from seed 0 by a
``torch.Generator`` on the device.  A run with background progress
workers goes through ``run(args, progress_workers=N)``.  The mesh, FSDP,
pipeline, user-collective and elastic flags wait for their slices.
Training resumes from ``--ckpt-dir``: remove ``<ckpt-dir>/<arch>`` to
start over.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import torch


def build_parser() -> argparse.ArgumentParser:
    from repro_torch.launch.serve import SCALES
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--scale", default="tiny", choices=list(SCALES))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--cast-bf16", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def make_train_step(cfg, ocfg, *, microbatches: int = 1,
                    cast_params_bf16: bool = False):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: loss and gradients of ``registry.loss_fn`` (summed over
    ``microbatches`` slices of the batch, then averaged), then one AdamW
    step IN PLACE on ``params`` and the moments.  With
    ``cast_params_bf16`` the f32 master params are cast to the compute
    dtype before the model reads them (norm scales and other 1-D leaves
    stay f32) and the gradients land on the f32 masters.  Metrics are
    0-d tensors on the device: {"nll", "aux", "loss", "grad_norm", "lr"}."""
    from repro_torch.models import registry
    from repro_torch.models.layers import (torch_dtype, tree_from_leaves,
                                           tree_leaves, tree_map)
    from repro_torch.train import optimizer as opt

    cdt = torch_dtype(cfg.dtype)

    def model_params(params):
        if not cast_params_bf16:
            return params
        return tree_map(lambda p: p.to(cdt)
                        if p.dtype == torch.float32 and p.dim() > 1 else p,
                        params)

    def train_step(params, opt_state, batch):
        paths, leaves = zip(*tree_leaves(params))
        for t in leaves:
            t.requires_grad_(True)
        if microbatches > 1:
            mb = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                               + tuple(v.shape[1:]))
                  for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            grads = None
            for i in range(microbatches):
                l, _ = registry.loss_fn(model_params(params), cfg,
                                        {k: v[i] for k, v in mb.items()})
                g = torch.autograd.grad(l, leaves)
                loss = loss + l.detach()
                grads = [x.float() for x in g] if grads is None else \
                    [a + x.float() for a, x in zip(grads, g)]
            inv = 1.0 / microbatches
            loss = loss * inv
            grads = [x * inv for x in grads]
            metrics = {"nll": loss, "aux": torch.zeros_like(loss)}
        else:
            loss, metrics = registry.loss_fn(model_params(params), cfg, batch)
            grads = [x.float() for x in torch.autograd.grad(loss, leaves)]
        params, opt_state, om = opt.apply(ocfg, opt_state, params,
                                          tree_from_leaves(zip(paths, grads)))
        metrics = dict(metrics, loss=loss, **om)
        return params, opt_state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def kernel_launches_per_step(cfg, microbatches: int = 1) -> dict:
    """Launches of each kernel in one ``make_train_step`` step, per
    microbatch.  A checkpointed region runs its forward again in the
    backward: non-reentrant checkpointing recomputes until every tensor
    the region saved is back, and each region's last product saves an
    input that only the whole region recomputes, so every kernel in it
    launches twice.  The dispatcher never sees the kernels' launches
    (ctypes), so under "dots" they run again too: only the matrix
    products' outputs are kept.

    * dense: the forward runs two rmsnorms per layer plus the final norm
      and one attention per layer; the backward one rmsnorm backward per
      forward rmsnorm (attention's backward is the oracle's autograd, no
      kernel).  "full" and "dots" recompute the whole layer (both norms
      and the attention), "subblock" the two sub-blocks around the
      attention (both norms, not the attention), "attn_only" the
      attention alone;
    * ssm: one rmsnorm per layer plus the final norm and one ssd_chunk
      per layer (all chunks at once; its backward is the oracle's
      autograd); the gated per-head norm is inline, not the kernel.
      Every policy but "none" recomputes the whole layer."""
    from repro_torch.kernels import _lib
    NL = cfg.num_layers
    policy = cfg.remat_policy
    per = dict.fromkeys(_lib.launches, 0)
    if cfg.family == "ssm":
        again = 0 if policy == "none" else 1
        per.update(rmsnorm_fwd=(1 + again) * NL + 1, rmsnorm_bwd=NL + 1,
                   ssd_chunk=(1 + again) * NL)
    else:
        norms_again = policy in ("full", "dots", "subblock")
        attn_again = policy in ("full", "dots", "attn_only")
        per.update(rmsnorm_fwd=(2 + 2 * norms_again) * NL + 1,
                   rmsnorm_bwd=2 * NL + 1,
                   flash_attention=(1 + attn_again) * NL)
    return {k: v * microbatches for k, v in per.items()}


@dataclasses.dataclass
class TrainReport:
    trainer: object                # the Trainer (params, opt_state, ckpt)
    cfg: object                    # the ModelConfig
    log: list                      # Trainer.metrics_log
    wall_s: float                  # Trainer.run, host clock
    tokens_per_step: int

    def format(self) -> list[str]:
        if not self.log:
            return ["nothing to do: resumed past the last step"]
        steps = [m["step_time_s"] for m in self.log[1:]] or \
            [self.log[0]["step_time_s"]]
        mean_s = sum(steps) / len(steps)
        return [f"trained {len(self.log)} logged steps in {self.wall_s:.3f} s"
                f"; mean step {mean_s * 1e3:.3f} ms (first logged step "
                f"excluded), {self.tokens_per_step / mean_s:.1f} tokens/s; "
                f"final loss {self.log[-1]['loss']:.6f}"]


def run(args, **loop_overrides) -> TrainReport:
    """Train as the command line asks; ``loop_overrides`` replace fields
    of the ``TrainLoopConfig`` (e.g. ``progress_workers=2``,
    ``log_every=1``)."""
    from repro_torch import resolve_device
    from repro_torch.core import ProgressEngine
    from repro_torch.data.pipeline import PrefetchPipeline, SyntheticLM
    from repro_torch.launch.serve import make_config
    from repro_torch.models import registry
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_loop import Trainer, TrainLoopConfig

    device = resolve_device(args.device)
    cfg = make_config(args.arch, args.scale)
    if args.global_batch % args.microbatches:
        raise SystemExit(f"--global-batch {args.global_batch} is not a "
                         f"multiple of --microbatches {args.microbatches}")
    ocfg = opt_mod.AdamWConfig(lr=3e-3, warmup_steps=5,
                               total_steps=max(args.steps, 10))
    params = registry.init_params(
        cfg, torch.Generator(device=device).manual_seed(0))
    opt_state = opt_mod.init(params)

    eng = ProgressEngine()
    src = SyntheticLM(cfg.vocab_size, args.seq, args.global_batch, seed=5)
    pin = device.type == "cuda"

    def to_host(b):
        # pinned host memory, so the step's copy to the card is async
        return {k: torch.from_numpy(v.copy()).pin_memory() if pin
                else torch.from_numpy(v.copy()) for k, v in b.items()}

    pipe = PrefetchPipeline(map(to_host, iter(src)), eng, depth=3)
    train_step = make_train_step(cfg, ocfg, microbatches=args.microbatches,
                                 cast_params_bf16=args.cast_bf16)

    def step_fn(params, opt_state, batch):
        batch = {k: v.to(device, non_blocking=True) for k, v in batch.items()}
        return train_step(params, opt_state, batch)

    loop_cfg = TrainLoopConfig(**{
        "total_steps": args.steps, "checkpoint_every": 10,
        "checkpoint_dir": os.path.join(args.ckpt_dir, args.arch),
        "log_every": 5, **loop_overrides})
    hooks = [lambda s, m: print(
        f"step {s:4d} loss={m['loss']:.4f} "
        f"{m['step_time_s'] * 1e3:.0f}ms", flush=True)]
    trainer = Trainer(step_fn, params, opt_state, pipe, loop_cfg,
                      engine=eng, hooks=hooks)
    t0 = time.perf_counter()
    try:
        log = trainer.run()
    finally:
        pipe.close()
    return TrainReport(trainer, cfg, log, time.perf_counter() - t0,
                       args.global_batch * args.seq)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    report = run(args)
    print(f"[{args.arch} scale={args.scale} device={args.device}]")
    for line in report.format():
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
