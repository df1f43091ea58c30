"""Training launcher of the port: the trainer on the progress engine,
native on one card or data-parallel over ranks that share it.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --scale full --global-batch 8 --seq 1024 --steps 6   # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --devices 4 \
        --collective-backend user --scale full --global-batch 8 \
        --seq 1024 --steps 6                   # 4 ranks on the card
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --scale tiny --steps 6 [--devices 4 --collective-backend user]

The JAX package's ``repro.launch.train``, its native and data-parallel
user-backend paths: synthetic data prefetched on the engine, a forward +
backward + AdamW step (``make_train_step``, the body of the JAX
``build_cell`` train step, with microbatch accumulation and the bf16
cast), async checkpoints and the step watchdog on the same engine.

``--devices N --collective-backend user`` runs N data-parallel ranks on
a single-controller mesh (``--mesh Nx1``; a model axis above 1 waits for
the FSDP slice): each rank's gradients on its slice of the batch,
stacked f32 ``[N, *shape]`` (``make_rank_grads``), are reduced by an
``EngineGradReducer`` — persistent bucketed user-space allreduces whose
rounds run on their own CUDA stream, driven by the same engine — and
AdamW steps on the mean.  The native backend computes the same mean
gradient inside one step.  Batches move to the card from pinned host
memory.  Weights are random, drawn from seed 0 by a ``torch.Generator``
on the device.  A run with background progress workers goes through
``run(args, progress_workers=N)``.  The FSDP, pipeline and elastic flags
wait for their slices.  Training resumes from ``--ckpt-dir``: remove
``<ckpt-dir>/<arch>`` to start over.
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
    ap.add_argument("--devices", type=int, default=0,
                    help="data-parallel ranks, all on the one --device "
                         "(0: one)")
    ap.add_argument("--mesh", default="",
                    help="e.g. 4x1 -> (data=4, model=1); model must be 1")
    ap.add_argument("--collective-backend", default="native",
                    choices=["native", "user"],
                    help="native: the gradient mean inside the step; user: "
                         "nonblocking user-space collectives on the "
                         "progress engine")
    ap.add_argument("--collective-chunks", type=int, default=4,
                    help="chunk pipelining factor of the user backend")
    ap.add_argument("--collective-algorithm", default="ring",
                    help="user-backend allreduce schedule "
                         "(ring/bidir/recursive_doubling/halving_doubling)")
    ap.add_argument("--collective-round-batch", type=int, default=0,
                    help="rounds per dispatch in the user backend (0 = "
                         "auto from the bucket size)")
    return ap


def mesh_shape(args) -> tuple:
    """(data, model) from ``--mesh`` or ``--devices``; a model axis above
    1 raises (tensor parallelism and FSDP are ROADMAP §1 item 6)."""
    if args.mesh:
        shape = tuple(int(v) for v in args.mesh.split("x"))
        if len(shape) != 2:
            raise SystemExit(f"--mesh {args.mesh}: want DATAxMODEL")
        if args.devices and shape[0] * shape[1] != args.devices:
            raise SystemExit(f"--mesh {args.mesh} does not hold "
                             f"--devices {args.devices} ranks")
    else:
        shape = (max(args.devices, 1), 1)
    if shape[1] != 1:
        raise SystemExit(
            f"--mesh {args.mesh}: a model axis above 1 needs FSDP or tensor "
            f"parallelism, not ported yet (ROADMAP §1 item 6)")
    return shape


def _compute_params(cfg, cast_params_bf16: bool):
    """``params -> params`` the model reads: with ``cast_params_bf16`` the
    f32 masters cast to the compute dtype (1-D leaves such as norm scales
    stay f32), else the masters themselves."""
    from repro_torch.models.layers import torch_dtype, tree_map
    cdt = torch_dtype(cfg.dtype)

    def model_params(params):
        if not cast_params_bf16:
            return params
        return tree_map(lambda p: p.to(cdt)
                        if p.dtype == torch.float32 and p.dim() > 1 else p,
                        params)

    return model_params


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
    from repro_torch.models.layers import tree_from_leaves, tree_leaves
    from repro_torch.train import optimizer as opt

    model_params = _compute_params(cfg, cast_params_bf16)

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


def make_rank_grads(cfg, ranks: int, *, cast_params_bf16: bool = False):
    """``grad_fn(params, batch) -> (stacked_metrics, stacked_grads)``: the
    loss and gradients of ``registry.loss_fn`` on each rank's contiguous
    slice of the batch, one rank after the other, each rank's gradients
    written as f32 into row r of ``[ranks, *shape]`` leaves (the JAX
    launcher's ``v[None].astype(f32)``); metrics ``[ranks]``.  The bf16
    cast as in ``make_train_step``."""
    from repro_torch.models import registry
    from repro_torch.models.layers import tree_from_leaves, tree_leaves

    model_params = _compute_params(cfg, cast_params_bf16)

    def grad_fn(params, batch):
        paths, leaves = zip(*tree_leaves(params))
        for t in leaves:
            t.requires_grad_(True)
        per = batch["tokens"].shape[0] // ranks
        stacked, mets = None, []
        for r in range(ranks):
            local = {k: v[r * per:(r + 1) * per] for k, v in batch.items()}
            loss, m = registry.loss_fn(model_params(params), cfg, local)
            grads = torch.autograd.grad(loss, leaves)
            if stacked is None:
                stacked = [torch.empty((ranks,) + tuple(g.shape),
                                       dtype=torch.float32, device=g.device)
                           for g in grads]
            for dst, g in zip(stacked, grads):
                dst[r].copy_(g)
            del grads
            mets.append({k: v.detach() for k, v in dict(m, loss=loss).items()})
        stacked_mets = {k: torch.stack([m[k] for m in mets]) for k in mets[0]}
        return stacked_mets, tree_from_leaves(zip(paths, stacked))

    return grad_fn


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
    reducer: object = None         # the user backend's EngineGradReducer
    reduce_dispatches: int = 0     # its dispatch units a step

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


def run(args, *, config=None, params=None, **loop_overrides) -> TrainReport:
    """Train as the command line asks; ``loop_overrides`` replace fields
    of the ``TrainLoopConfig`` (e.g. ``progress_workers=2``,
    ``log_every=1``).  ``config`` replaces the ``--arch``/``--scale``
    ModelConfig and ``params`` the seeded weights (tests hand in bridged
    ones)."""
    from repro_torch import resolve_device
    from repro_torch.collectives.nonblocking import CollectiveSpec
    from repro_torch.core import ProgressEngine
    from repro_torch.data.pipeline import PrefetchPipeline, SyntheticLM
    from repro_torch.launch.serve import make_config
    from repro_torch.models import registry
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_loop import (Trainer, TrainLoopConfig,
                                              UserCollectiveStep)

    device = resolve_device(args.device)
    cfg = config if config is not None else make_config(args.arch,
                                                        args.scale)
    if args.global_batch % args.microbatches:
        raise SystemExit(f"--global-batch {args.global_batch} is not a "
                         f"multiple of --microbatches {args.microbatches}")
    data, _ = mesh_shape(args)
    user_backend = args.collective_backend == "user"
    if user_backend and args.microbatches > 1:
        raise SystemExit("--collective-backend user does not compose with "
                         "--microbatches yet")
    if args.global_batch % data:
        raise SystemExit(f"--global-batch {args.global_batch} does not "
                         f"split over {data} ranks")
    spec = CollectiveSpec(backend=args.collective_backend,
                          algorithm=args.collective_algorithm,
                          chunks=args.collective_chunks,
                          round_batch=args.collective_round_batch or None)
    ocfg = opt_mod.AdamWConfig(lr=3e-3, warmup_steps=5,
                               total_steps=max(args.steps, 10))
    if params is None:
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

    def to_device(batch):
        return {k: v.to(device, non_blocking=True) for k, v in batch.items()}

    def step_fn(params, opt_state, batch):
        return train_step(params, opt_state, to_device(batch))

    split, reducer = None, None
    if user_backend:
        from repro_torch.collectives.overlap import EngineGradReducer
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh((data, 1), ("data", "model"), device)
        rank_grads = make_rank_grads(cfg, data,
                                     cast_params_bf16=args.cast_bf16)

        def grad_fn(params, batch):
            return rank_grads(params, to_device(batch))

        def apply_fn(params, opt_state, grads, stacked_mets):
            params, opt_state, om = opt_mod.apply(ocfg, opt_state, params,
                                                  grads)
            mets = {k: v.mean() for k, v in stacked_mets.items()}
            return params, opt_state, dict(mets, **om)

        reducer = EngineGradReducer(mesh, "data", engine=eng, spec=spec,
                                    mean=True)
        split = UserCollectiveStep(grad_fn, apply_fn, reducer, spec=spec)
        print(f"collective backend: user ({reducer.algorithm}, "
              f"chunks={args.collective_chunks}, round_batch="
              f"{args.collective_round_batch or 'auto'}, persistent "
              f"schedules per bucket) over {mesh}")

    loop_cfg = TrainLoopConfig(**{
        "total_steps": args.steps, "checkpoint_every": 10,
        "checkpoint_dir": os.path.join(args.ckpt_dir, args.arch),
        "log_every": 5, "collective_spec": spec, **loop_overrides})
    hooks = [lambda s, m: print(
        f"step {s:4d} loss={m['loss']:.4f} "
        f"{m['step_time_s'] * 1e3:.0f}ms", flush=True)]
    trainer = Trainer(step_fn, params, opt_state, pipe, loop_cfg,
                      engine=eng, hooks=hooks, split_step=split)
    t0 = time.perf_counter()
    dispatches = 0
    try:
        log = trainer.run()
    finally:
        pipe.close()
        if reducer is not None:
            dispatches = reducer.dispatches_per_step
            reducer.close()
    return TrainReport(trainer, cfg, log, time.perf_counter() - t0,
                       args.global_batch * args.seq, reducer, dispatches)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    report = run(args)
    print(f"[{args.arch} scale={args.scale} device={args.device}]")
    for line in report.format():
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
