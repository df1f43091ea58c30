"""Training launcher of the port: the trainer on the progress engine,
native on one card or over ranks that share it — data-parallel, FSDP,
elastic, or a 1F1B pipeline.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --scale full --global-batch 8 --seq 1024 --steps 6   # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --devices 4 \
        --collective-backend user --scale full --global-batch 8 \
        --seq 1024 --steps 6                   # 4 ranks on the card
    PYTHONPATH=src python -m repro_torch.launch.train --devices 4 --fsdp \
        --collective-backend user --scale full --global-batch 8 \
        --seq 1024 --steps 6                   # FSDP over 4 ranks
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --scale tiny --steps 6 [--devices 4 --collective-backend user \
        [--fsdp] [--elastic --chaos-kill 2 --chaos-kill-step 2]]
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --pipeline 1f1b --mesh 2x2 --microbatches 4 --steps 6
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --scale tiny --mesh 1x4 --steps 6        # a model axis of 4 ranks

The JAX package's ``repro.launch.train``: synthetic data prefetched on
the engine, a forward + backward + AdamW step (the train cell of
``launch.steps.build_cell``, as the JAX launcher builds its step, with
microbatch accumulation and the bf16 cast), async checkpoints and the
step watchdog on the same engine.

``--devices N --collective-backend user`` runs N data-parallel ranks on
a single-controller mesh (``--mesh Nx1``): each rank's gradients on its
slice of the batch, stacked f32 ``[N, *shape]`` (``make_rank_grads``),
are reduced by an ``EngineGradReducer`` — persistent bucketed
user-space allreduces whose rounds run on their own CUDA stream, driven
by the same engine — and AdamW steps on the mean.  The native backend
computes the same mean gradient inside one step.

``--mesh DxM`` on the native backend trains on a (data, model) mesh of
ranks on the one device, entered (``sharding.set_mesh``) around each
step: with ``attention_impl="ring"`` the causal attention splits the
sequence over the M model ranks (``collectives.ring_attention``), and
the MoE block splits the expert width over them when it is wide enough
(``layers.moe_tp_ranks``); every other layer replicates over the model
axis, and the data axis splits nothing the one pass over the batch does
not already sum (the JAX launcher's ``build_cell`` under the same mesh).
A config with "ring" goes through ``run(args, config=...)``.

``--fsdp`` shards parameters and AdamW moments over the mesh's data
axis as flat per-dtype buckets (``FsdpLayout``, ``--fsdp-bucket-bytes``):
each step all-gathers the full flat buckets, rank r's forward reading
row r, and reduce-scatters the gradient buckets so each rank receives
only the block it applies (``build_fsdp_programs``).  The user backend
moves both through an ``FsdpReducer``'s persistent handles, the next
step's gathers chained off the optimizer's compute futures; the native
backend stacks and sums over the rank dim in the step.  A model axis
(``--mesh DxM``) replicates: each data rank's work is computed once.

``--elastic`` (user backend) shares a ``MembershipEpoch`` between the
watchdog, an optional heartbeat monitor (``--heartbeat-timeout``) and
the reducer's persistent collectives; ``--chaos-kill N`` invalidates it
after step ``--chaos-kill-step`` (the loop logs every step then), and
the trainer remeshes onto the survivors and retries the step's batch.

``--pipeline gpipe|1f1b`` trains a residual-MLP stage stack against a
fixed linear teacher on a (data x stage) mesh (``_run_pipeline``).

Batches move to the card from pinned host memory.  Weights are random,
drawn from seed 0 by a ``torch.Generator`` on the device.  A run with
background progress workers goes through ``run(args,
progress_workers=N)``.  Training resumes from ``--ckpt-dir``: remove
``<ckpt-dir>/<arch>`` (``<arch>-fsdp`` for FSDP) to start over.
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
    from repro_torch.examples.train_lm import SCALES
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
                    help="e.g. 4x1 -> (data=4, model=1); a model axis "
                         "above 1 splits the sequence for "
                         "attention_impl='ring' and the MoE expert width "
                         "(native backend), replicates under --fsdp, and "
                         "needs --fsdp on the user backend; with "
                         "--pipeline the mesh is (data x stage)")
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
    ap.add_argument("--fsdp", action="store_true",
                    help="ZeRO-style FSDP over the mesh's data axis: params "
                         "and optimizer state sharded into flat per-dtype "
                         "buckets, grads reduce-scattered, full params "
                         "all-gathered each step (the user backend chains "
                         "the next step's gathers off the optimizer's "
                         "compute futures)")
    ap.add_argument("--fsdp-bucket-bytes", type=int, default=1 << 22,
                    help="flat-bucket size for --fsdp (smaller = more "
                         "buckets = more prefetch-chain links)")
    ap.add_argument("--pipeline", default="none",
                    choices=["none", "gpipe", "1f1b"],
                    help="pipeline-parallel backend: gpipe = the tick-loop "
                         "reference; 1f1b = the continuation-DAG schedule "
                         "on the progress engine (per-stage streams, "
                         "persistent user-space p2p handoffs), composed "
                         "with the engine grad reducer over the data axis")
    ap.add_argument("--pipeline-stages", type=int, default=0,
                    help="pipeline stages (0 = the mesh's second dim); "
                         "with --pipeline the mesh is (data x stage) and "
                         "--microbatches sets M per step")
    ap.add_argument("--elastic", action="store_true",
                    help="membership-aware fault tolerance (user backend "
                         "only): a shared MembershipEpoch ties the "
                         "watchdog/heartbeat to the reducer's persistent "
                         "collectives; on invalidation the trainer "
                         "remeshes onto the survivors and retries the "
                         "step's batch")
    ap.add_argument("--heartbeat-timeout", type=float, default=0.0,
                    help="enable a heartbeat monitor with this peer "
                         "timeout in seconds (0 = off; implies --elastic)")
    ap.add_argument("--chaos-kill", type=int, default=0,
                    help="simulate the death of N ranks after step "
                         "--chaos-kill-step (implies --elastic)")
    ap.add_argument("--chaos-kill-step", type=int, default=10)
    return ap


def mesh_shape(args) -> tuple:
    """(data, model) from ``--mesh`` or ``--devices``.  A model axis above
    1 trains natively (the ring splits the sequence over it, the MoE
    block the expert width; every other layer replicates) or under
    ``--fsdp`` (where it replicates); the user backend without
    ``--fsdp`` refuses it, as the JAX launcher does."""
    if args.mesh:
        shape = tuple(int(v) for v in args.mesh.split("x"))
        if len(shape) != 2:
            raise SystemExit(f"--mesh {args.mesh}: want DATAxMODEL")
        if args.devices and shape[0] * shape[1] != args.devices:
            raise SystemExit(f"--mesh {args.mesh} does not hold "
                             f"--devices {args.devices} ranks")
    else:
        shape = (max(args.devices, 1), 1)
    if shape[1] != 1 and args.collective_backend == "user" \
            and not args.fsdp:
        raise SystemExit("--collective-backend user on a 2-D mesh requires "
                         "--fsdp (ZeRO sharding over the data axis); "
                         "without it use model dim 1")
    return shape


def make_train_step(cfg, ocfg, *, microbatches: int = 1,
                    cast_params_bf16: bool = False):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the train cell's step (``launch.steps.train_step_fn``);
    ``run`` takes it from ``build_cell``."""
    from repro_torch.launch.steps import train_step_fn
    return train_step_fn(cfg, ocfg, microbatches=microbatches,
                         cast_params_bf16=cast_params_bf16)


def make_rank_grads(cfg, ranks: int, *, cast_params_bf16: bool = False):
    """``grad_fn(params, batch) -> (stacked_metrics, stacked_grads)``: the
    loss and gradients of ``registry.loss_fn`` on each rank's contiguous
    slice of the batch, one rank after the other, each rank's gradients
    written as f32 into row r of ``[ranks, *shape]`` leaves (the JAX
    launcher's ``v[None].astype(f32)``); metrics ``[ranks]``.  The bf16
    cast as in ``make_train_step``."""
    from repro_torch.launch.steps import compute_params
    from repro_torch.models import registry
    from repro_torch.models.layers import tree_from_leaves, tree_leaves

    model_params = compute_params(cfg, cast_params_bf16)

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


def kernel_launches_per_step(cfg, microbatches: int = 1, model: int = 1,
                             seq: int | None = None) -> dict:
    """Launches of each kernel in one ``make_train_step`` step, per
    microbatch.  A checkpointed region runs its forward again in the
    backward: non-reentrant checkpointing recomputes until every tensor
    the region saved is back, and each region's last product saves an
    input that only the whole region recomputes, so every kernel in it
    launches twice.  The dispatcher never sees the kernels' launches
    (ctypes), so under "dots" they run again too: only the matrix
    products' outputs are kept.

    * dense and moe (the MoE layer is tensor code, no kernel): the
      forward runs two rmsnorms per layer plus the final norm
      and one attention per layer; the backward one rmsnorm backward per
      forward rmsnorm (attention's backward is the oracle's autograd, no
      kernel).  "full" and "dots" recompute the whole layer (both norms
      and the attention), "subblock" the two sub-blocks around the
      attention (both norms, not the attention), "attn_only" the
      attention alone;
    * ssm: one rmsnorm per layer plus the final norm and one ssd_chunk
      per layer (all chunks at once; its backward is the oracle's
      autograd); the gated per-head norm is inline, not the kernel.
      Every policy but "none" recomputes the whole layer;
    * hybrid: the ssm family's per mamba layer, and at each of the
      n_groups sites the shared block's two rmsnorms and one attention.
      Every policy but "none" recomputes the whole group (its k layers
      and its site); the tail's layers and the final norm are never
      recomputed;
    * audio (whisper): LayerNorms, no rmsnorm; one attention per encoder
      layer and two per decoder layer (self and cross), all recomputed
      under every policy but "none".

    ``model`` is the mesh's model axis: with ``attention_impl="ring"``
    and ``model`` > 1 dividing ``seq`` (the sequence, when given), every
    causal self-attention of the dense, moe, vlm and hybrid families goes
    around the ring and launches no ``flash_attention`` (the ring is
    tensor code); the norms are unchanged.  whisper's attention never
    takes the ring (``layers.attention``), as in the JAX package."""
    from repro_torch.kernels import _lib
    NL = cfg.num_layers
    ring = cfg.attention_impl == "ring" and model > 1 and (
        seq is None or seq % model == 0)
    policy = cfg.remat_policy
    again = 0 if policy == "none" else 1
    per = dict.fromkeys(_lib.launches, 0)
    if cfg.family == "ssm":
        per.update(rmsnorm_fwd=(1 + again) * NL + 1, rmsnorm_bwd=NL + 1,
                   ssd_chunk=(1 + again) * NL)
    elif cfg.family == "hybrid":
        n_groups = NL // cfg.shared_attn_every
        grouped = n_groups * cfg.shared_attn_every   # the layers of groups
        norms = NL + 2 * n_groups + 1
        per.update(rmsnorm_fwd=norms + again * (grouped + 2 * n_groups),
                   rmsnorm_bwd=norms, ssd_chunk=NL + again * grouped,
                   flash_attention=0 if ring else (1 + again) * n_groups)
    elif cfg.family == "audio":
        per.update(flash_attention=(1 + again)
                   * (cfg.num_encoder_layers + 2 * NL))
    else:
        norms_again = policy in ("full", "dots", "subblock")
        attn_again = policy in ("full", "dots", "attn_only")
        per.update(rmsnorm_fwd=(2 + 2 * norms_again) * NL + 1,
                   rmsnorm_bwd=2 * NL + 1,
                   flash_attention=0 if ring else (1 + attn_again) * NL)
    return {k: v * microbatches for k, v in per.items()}


def build_fsdp_programs(cfg, ocfg, mesh, layout, *, axis: str = "data"):
    """The FSDP step programs over ``mesh``'s data axis: ``(grad_fn,
    apply_fn, ag_fn, rs_fn)``.

    Shared by the user and native backends — the only difference
    between the two paths is who moves the bytes (the ``FsdpReducer``'s
    persistent engine handles, or ``ag_fn``/``rs_fn`` in the step), so
    a loss-trajectory comparison measures exactly the collectives.

    * ``grad_fn(gathered_flats, batch)`` — for each data rank r: the
      parameter tree as views of row r of the gathered flat buckets
      ``[n, W]``, the loss and gradients of ``registry.loss_fn`` on the
      rank's contiguous slice of the batch, the gradients written as f32
      into row r of stacked flat buckets ``[n, W]`` (zero pad tails);
      metrics ``[n]``.  A model axis replicates: its ranks would compute
      the same, so each data rank's work runs once;
    * ``apply_fn(shards, opt_state, grad_shards, stacked_mets)`` — the
      sharded AdamW step (``optimizer.apply_shards``, the 1/n mean
      folded into ``grad_scale``), in place;
    * ``ag_fn(shards)`` / ``rs_fn(flat_grads)`` — the native collectives:
      every row the concatenated shards (a broadcast view), and the sum
      over the rank dim with row r its block r."""
    from repro_torch.collectives.overlap import tree_flatten
    from repro_torch.models import registry
    from repro_torch.train import optimizer as opt_mod

    n = layout.n
    if dict(mesh.shape)[axis] != n:
        raise ValueError(f"mesh axis {axis!r} has {dict(mesh.shape)[axis]} "
                         f"ranks, the layout {n}")

    def grad_fn(flats, batch):
        per = batch["tokens"].shape[0] // n
        flat_g = []
        for b, f in enumerate(flats):
            g = torch.empty((n, layout.widths[b]), dtype=torch.float32,
                            device=f.device)
            g[:, layout.totals[b]:].zero_()
            flat_g.append(g)
        mets = []
        for r in range(n):
            leaves, rebuild = tree_flatten(
                layout.unflatten([f[r] for f in flats]))
            local = {k: v[r * per:(r + 1) * per] for k, v in batch.items()}
            with torch.enable_grad():
                ps = [t.detach().requires_grad_(True) for t in leaves]
                loss, m = registry.loss_fn(rebuild(ps), cfg, local)
                grads = torch.autograd.grad(loss, ps)
            for b, bucket in enumerate(layout.buckets):
                off = 0
                for i in bucket:
                    size = layout.sizes[i]
                    flat_g[b][r, off:off + size].copy_(grads[i].reshape(-1))
                    off += size
            del grads
            mets.append({k: v.detach() for k, v in dict(m, loss=loss).items()})
        stacked = {k: torch.stack([m[k] for m in mets]) for k in mets[0]}
        return stacked, flat_g

    def apply_fn(shards, opt_state, grad_shards, stacked_mets):
        shards, opt_state, om = opt_mod.apply_shards(
            ocfg, opt_state, shards, grad_shards, grad_scale=1.0 / n)
        mets = {k: v.mean() for k, v in stacked_mets.items()}
        return shards, opt_state, dict(mets, **om)

    def ag_fn(shards):
        return [s.reshape(1, -1).expand(n, -1) for s in shards]

    def rs_fn(flat_grads):
        return [g.sum(0).view(n, -1) for g in flat_grads]

    return grad_fn, apply_fn, ag_fn, rs_fn


@dataclasses.dataclass
class TrainReport:
    trainer: object                # the Trainer (params, opt_state, ckpt)
    cfg: object                    # the ModelConfig (None for --pipeline)
    log: list                      # Trainer.metrics_log
    wall_s: float                  # Trainer.run, host clock
    tokens_per_step: int
    reducer: object = None         # the user backend's reducer
    reduce_dispatches: int = 0     # its dispatch units a step
    layout: object = None          # --fsdp: the FsdpLayout (last mesh's)
    rows: list = None              # --pipeline 1f1b: a schedule per row

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


def _elastic_on(args) -> bool:
    return args.elastic or args.heartbeat_timeout > 0 or args.chaos_kill > 0


def _fault_hooks(args, eng, mesh, epoch, axis: str = "data") -> list:
    """The heartbeat monitor's beat hook (``--heartbeat-timeout``) and the
    chaos hook (``--chaos-kill``: invalidate the epoch down to the
    survivors after the first logged step >= ``--chaos-kill-step``)."""
    hooks = []
    if args.heartbeat_timeout > 0:
        from repro_torch.distributed.fault_tolerance import monitor_mesh
        hb = monitor_mesh(eng, mesh, axis, timeout=args.heartbeat_timeout,
                          epoch=epoch)
        hooks.append(lambda s, m: [hb.beat(p) for p in hb.alive])
    if args.chaos_kill > 0:
        killed = []

        def chaos_hook(s, m):
            if s >= args.chaos_kill_step and not killed:
                killed.append(s)
                survivors = max(1, mesh.size - args.chaos_kill)
                print(f"chaos: killing {args.chaos_kill} rank(s) at step "
                      f"{s} -> {survivors} survivors", flush=True)
                epoch.invalidate(survivors=survivors,
                                 reason=f"--chaos-kill {args.chaos_kill}")
        hooks.append(chaos_hook)
    return hooks


def _loop_config(args, spec, ckpt_name: str, loop_overrides: dict,
                 checkpoint_every: int = 10, **fields):
    from repro_torch.train.train_loop import TrainLoopConfig
    base = {"total_steps": args.steps, "checkpoint_every": checkpoint_every,
            "checkpoint_dir": os.path.join(args.ckpt_dir, ckpt_name),
            "log_every": 1 if args.chaos_kill > 0 else 5,
            "collective_spec": spec, **fields}
    return TrainLoopConfig(**{**base, **loop_overrides})


def _print_hook(digits: int = 4):
    return lambda s, m: print(
        f"step {s:4d} loss={m['loss']:.{digits}f} "
        f"{m['step_time_s'] * 1e3:.0f}ms", flush=True)


def run(args, *, config=None, params=None, **loop_overrides) -> TrainReport:
    """Train as the command line asks; ``loop_overrides`` replace fields
    of the ``TrainLoopConfig`` (e.g. ``progress_workers=2``,
    ``log_every=1``).  ``config`` replaces the ``--arch``/``--scale``
    ModelConfig and ``params`` the seeded weights (tests hand in bridged
    ones)."""
    from repro_torch import resolve_device, sharding
    from repro_torch.collectives.nonblocking import CollectiveSpec
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.core import ProgressEngine
    from repro_torch.data.pipeline import PrefetchPipeline, SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import make_config
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import registry
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_loop import Trainer, UserCollectiveStep

    if args.pipeline != "none":
        return _run_pipeline(args, **loop_overrides)
    device = resolve_device(args.device)
    cfg = config if config is not None else make_config(args.arch,
                                                        args.scale)
    if args.global_batch % args.microbatches:
        raise SystemExit(f"--global-batch {args.global_batch} is not a "
                         f"multiple of --microbatches {args.microbatches}")
    data, model = mesh_shape(args)
    user_backend = args.collective_backend == "user"
    if _elastic_on(args) and not user_backend:
        raise SystemExit("--elastic/--chaos-kill/--heartbeat-timeout "
                         "require --collective-backend user (the epoch "
                         "invalidates user-space persistent collectives)")
    if args.fsdp and (args.microbatches > 1 or args.cast_bf16):
        raise SystemExit("--fsdp does not compose with "
                         "--microbatches/--cast-bf16 yet")
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

    eng = ProgressEngine()
    src = SyntheticLM(cfg.vocab_size, args.seq, args.global_batch, seed=5)
    pin = device.type == "cuda"

    def to_host(b):
        # pinned host memory, so the step's copy to the card is async
        b = {k: torch.from_numpy(v.copy()) for k, v in b.items()}
        if cfg.is_encoder_decoder:
            # the stub audio frontend's frames: ones, as the JAX launcher
            b["encoder_embeds"] = torch.ones(
                (args.global_batch, cfg.encoder_frames, cfg.d_model),
                dtype=torch.bfloat16)
        return {k: v.pin_memory() if pin else v for k, v in b.items()}

    def to_device(batch):
        return {k: v.to(device, non_blocking=True) for k, v in batch.items()}

    pipe = PrefetchPipeline(map(to_host, iter(src)), eng, depth=3)
    if args.fsdp:
        try:
            return _run_fsdp(args, cfg, ocfg, params, device, (data, model),
                             spec, eng, pipe, to_device, loop_overrides)
        finally:
            pipe.close()

    opt_state = opt_mod.init(params)
    native_mesh = make_mesh((data, model), ("data", "model"), device)
    cell = build_cell(cfg, ShapeSpec("train", args.seq, args.global_batch,
                                     "train"), native_mesh, opt_cfg=ocfg,
                      microbatches=args.microbatches,
                      cast_params_bf16=args.cast_bf16)
    train_step = cell.step_fn

    def step_fn(params, opt_state, batch):
        # the mesh is entered here, on the thread that runs the step (the
        # Trainer may call it from a progress worker): the model's
        # attention and MoE layers read their model axis from it
        with sharding.set_mesh(native_mesh):
            return train_step(params, opt_state, to_device(batch))

    split, reducer, epoch, remesh_fn, mesh = None, None, None, None, None
    if user_backend:
        from repro_torch.collectives.overlap import EngineGradReducer

        def make_grad_fn(ranks):
            rank_grads = make_rank_grads(cfg, ranks,
                                         cast_params_bf16=args.cast_bf16)
            return lambda params, batch: rank_grads(params,
                                                    to_device(batch))

        def apply_fn(params, opt_state, grads, stacked_mets):
            params, opt_state, om = opt_mod.apply(ocfg, opt_state, params,
                                                  grads)
            mets = {k: v.mean() for k, v in stacked_mets.items()}
            return params, opt_state, dict(mets, **om)

        mesh = make_mesh((data, 1), ("data", "model"), device)
        if _elastic_on(args):
            from repro_torch.collectives.nonblocking import MembershipEpoch
            epoch = MembershipEpoch(mesh=mesh)
        reducer = EngineGradReducer(mesh, "data", engine=eng, spec=spec,
                                    mean=True, epoch=epoch)
        split = UserCollectiveStep(make_grad_fn(data), apply_fn, reducer,
                                   spec=spec)
        if epoch is not None:
            from repro_torch.distributed import elastic

            def remesh_fn(exc, params, opt_state):
                # survivors' mesh: pure data-parallel (model dim stays 1);
                # the ranks share the one device, so the state stays put
                new_mesh = elastic.remesh(exc.survivors, prefer_model=1,
                                          device=device)
                print(f"remesh: {exc.survivors} survivor(s) -> mesh "
                      f"{dict(new_mesh.shape)}", flush=True)
                reducer.remesh(new_mesh, "data")
                ranks = dict(new_mesh.shape)["data"]
                return (UserCollectiveStep(make_grad_fn(ranks), apply_fn,
                                           reducer, spec=spec),
                        params, opt_state)

        print(f"collective backend: user ({reducer.algorithm}, "
              f"chunks={args.collective_chunks}, round_batch="
              f"{args.collective_round_batch or 'auto'}, persistent "
              f"schedules per bucket) over {mesh}")

    loop_cfg = _loop_config(args, spec, args.arch, loop_overrides)
    hooks = [_print_hook()]
    if epoch is not None:
        hooks += _fault_hooks(args, eng, mesh, epoch)
    trainer = Trainer(step_fn, params, opt_state, pipe, loop_cfg,
                      engine=eng, hooks=hooks, split_step=split,
                      epoch=epoch, remesh_fn=remesh_fn)
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


def _run_fsdp(args, cfg, ocfg, params, device, shape, spec, eng, pipe,
              to_device, loop_overrides) -> TrainReport:
    """ZeRO-style FSDP over the mesh's data axis.

    Params and AdamW moments live as flat per-dtype bucket shards
    ``[n, W/n]`` (rank ``r`` owns row ``r``); every step all-gathers the
    full flat buckets for the forward/backward and reduce-scatters the
    grad buckets so each rank receives only the block it applies.
    ``--collective-backend user`` moves both through persistent engine
    handles, with the next step's gathers chained as continuations off
    the optimizer's compute futures; ``native`` runs the same programs
    with ``ag_fn``/``rs_fn`` in the step.  The model axis replicates, so
    the same step runs unchanged on (4,1) and (2,2)."""
    from repro_torch.collectives.nonblocking import MembershipEpoch
    from repro_torch.collectives.overlap import FsdpLayout, FsdpReducer
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_loop import FsdpStep, Trainer

    axis = "data"
    user_backend = args.collective_backend == "user"
    mesh = make_mesh(shape, ("data", "model"), device)
    epoch = MembershipEpoch(mesh=mesh) if _elastic_on(args) else None

    def shard_state(mesh_, params_tree, mu_tree=None, nu_tree=None,
                    step=None):
        n = dict(mesh_.shape)[axis]
        layout = FsdpLayout(params_tree, n, args.fsdp_bucket_bytes)
        shards = layout.shard_params(params_tree, mesh_, axis)
        if mu_tree is None:
            return layout, shards, opt_mod.init_shards(shards)
        return layout, shards, opt_mod.AdamWState(
            step, layout.shard_params(mu_tree, mesh_, axis),
            layout.shard_params(nu_tree, mesh_, axis))

    layout, shards, opt_state = shard_state(mesh, params)
    del params
    print(f"fsdp: {layout.num_buckets} bucket(s), shard widths "
          f"{[w // layout.n for w in layout.widths]} over {axis}="
          f"{layout.n} ({args.collective_backend} backend)", flush=True)
    grad_fn, apply_fn, ag_fn, rs_fn = build_fsdp_programs(
        cfg, ocfg, mesh, layout, axis=axis)

    def on_device(fn):
        return lambda flats, batch: fn(flats, to_device(batch))

    reducer, split, step_fn, remesh_fn = None, None, None, None
    if user_backend:
        reducer = FsdpReducer(mesh, axis, engine=eng, spec=spec,
                              bucket_bytes=args.fsdp_bucket_bytes,
                              epoch=epoch)
        split = FsdpStep(on_device(grad_fn), apply_fn, reducer, spec=spec)
    else:
        def step_fn(shards, opt_state, batch):
            smets, flat_grads = grad_fn(ag_fn(shards), to_device(batch))
            return apply_fn(shards, opt_state, rs_fn(flat_grads), smets)

    if epoch is not None:
        from repro_torch.distributed import elastic
        model_dim = shape[1]

        def remesh_fn(exc, shards_, opt_state_):
            nonlocal layout
            new_mesh = elastic.remesh(exc.survivors, prefer_model=model_dim,
                                      device=device)
            print(f"remesh: {exc.survivors} survivor(s) -> mesh "
                  f"{dict(new_mesh.shape)}", flush=True)
            # shard widths depend on the data-axis size: unshard, rebuild
            # the layout + programs for the new mesh, re-shard params AND
            # moments (the step counter carries)
            params_tree = layout.unshard_params(shards_)
            mu_tree = layout.unshard_params(opt_state_.mu)
            nu_tree = layout.unshard_params(opt_state_.nu)
            reducer.remesh(new_mesh, axis)
            layout, new_shards, new_state = shard_state(
                new_mesh, params_tree, mu_tree, nu_tree, opt_state_.step)
            g2, a2, _, _ = build_fsdp_programs(cfg, ocfg, new_mesh, layout,
                                               axis=axis)
            return (FsdpStep(on_device(g2), a2, reducer, spec=spec),
                    new_shards, new_state)

    loop_cfg = _loop_config(args, spec, args.arch + "-fsdp", loop_overrides,
                            checkpoint_every=max(args.steps, 10))
    hooks = [_print_hook(6)]
    if epoch is not None:
        hooks += _fault_hooks(args, eng, mesh, epoch, axis)
    trainer = Trainer(step_fn, shards, opt_state, pipe, loop_cfg,
                      engine=eng, split_step=split, epoch=epoch,
                      remesh_fn=remesh_fn, hooks=hooks)
    t0 = time.perf_counter()
    dispatches = 0
    try:
        log = trainer.run()
    finally:
        if reducer is not None:
            dispatches = reducer.dispatches_per_step
            reducer.close()
    if reducer is not None:
        print(f"prefetch overlap: {reducer.prefetch_overlap:.3f} "
              f"({reducer.gathers} chained gathers)", flush=True)
    return TrainReport(trainer, cfg, log, time.perf_counter() - t0,
                       args.global_batch * args.seq, reducer, dispatches,
                       layout=layout)


PIPE_D_MODEL, PIPE_D_HIDDEN = 16, 32     # the JAX launcher's rehearsal widths


def pipe_stage_fn(p, x):
    """One pipeline stage of the residual-MLP rehearsal."""
    return x + torch.tanh(x @ p["w1"]) @ p["w2"]


def pipe_loss_fn(y, t):
    return torch.mean((y - t) ** 2)


def _run_pipeline(args, **loop_overrides) -> TrainReport:
    """Pipeline-parallel rehearsal: a residual-MLP stage stack (d_model
    16, hidden 32) trained against a fixed linear teacher, on a (data x
    stage) mesh.

    * ``--pipeline gpipe``: the tick-loop reference — forward AND
      backward differentiate through it in one step (data dim must be
      1).
    * ``--pipeline 1f1b``: one event-driven :class:`PipelineSchedule`
      per data row (per-stage executor-owned streams, persistent p2p
      handoffs), composed with the ``EngineGradReducer`` over the data
      axis of the 2-D mesh — the split-step ``UserCollectiveStep``
      path, exactly as for plain data-parallel."""
    import numpy as np

    from repro_torch import resolve_device
    from repro_torch.collectives.nonblocking import CollectiveSpec
    from repro_torch.collectives.overlap import EngineGradReducer
    from repro_torch.core import ProgressEngine, ProgressExecutor
    from repro_torch.data.pipeline import PrefetchPipeline
    from repro_torch.distributed import pipeline as pl
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_loop import Trainer, UserCollectiveStep

    device = resolve_device(args.device)
    n_dev = max(args.devices, 1)
    if args.mesh:
        shape = tuple(int(v) for v in args.mesh.split("x"))
        if len(shape) != 2:
            raise SystemExit(f"--mesh {args.mesh}: want DATAxSTAGE")
    else:
        S0 = args.pipeline_stages or n_dev
        shape = (max(n_dev // S0, 1), S0)
    D, S = shape
    if args.pipeline_stages and args.pipeline_stages != S:
        raise SystemExit(f"--pipeline-stages {args.pipeline_stages} "
                         f"contradicts --mesh {args.mesh} (stage dim {S})")
    if args.devices and D * S > args.devices:
        raise SystemExit(f"mesh {D}x{S} needs {D * S} ranks, have "
                         f"{args.devices}")
    if args.pipeline == "gpipe" and D != 1:
        raise SystemExit("--pipeline gpipe differentiates through one "
                         "tick loop; use a 1xS mesh (data dim 1)")
    mesh = make_mesh((D, S), ("data", "stage"), device)
    M = max(args.microbatches, 1)
    d_model, mb = PIPE_D_MODEL, max(args.global_batch, 1)
    print(f"pipeline={args.pipeline} mesh={dict(mesh.shape)} "
          f"microbatches={M} "
          f"bubble={pl.bubble_fraction(S, M, args.pipeline):.3f} "
          f"peak_act={pl.peak_activation_microbatches(S, M, args.pipeline)}")

    gen = torch.Generator(device=device).manual_seed(0)
    params = {
        "w1": torch.randn((S, d_model, PIPE_D_HIDDEN), generator=gen,
                          device=device) * 0.1,
        "w2": torch.randn((S, PIPE_D_HIDDEN, d_model), generator=gen,
                          device=device) * 0.1,
    }
    ocfg = opt_mod.AdamWConfig(lr=3e-3, warmup_steps=5,
                               total_steps=max(args.steps, 10))
    opt_state = opt_mod.init(params)

    eng = ProgressEngine()
    ex = ProgressExecutor(eng, num_workers=2).start()
    eng.attach_executor(ex)
    rng = np.random.default_rng(7)
    teacher = (rng.standard_normal((d_model, d_model))
               .astype(np.float32) * 0.3)

    def gen_batches():
        while True:
            xs = rng.standard_normal((D, M, mb, d_model)).astype(np.float32)
            yield {"xs": torch.from_numpy(xs),
                   "ts": torch.from_numpy(xs @ teacher)}

    pipe = PrefetchPipeline(gen_batches(), eng, depth=3)

    def apply_fn(params, opt_state, grads, stacked_mets):
        params, opt_state, om = opt_mod.apply(ocfg, opt_state, params, grads)
        mets = {k: v.mean() for k, v in stacked_mets.items()}
        return params, opt_state, dict(mets, **om)

    pspec = CollectiveSpec(
        backend="user" if args.pipeline == "1f1b" else "native",
        algorithm=args.collective_algorithm,
        chunks=args.collective_chunks,
        round_batch=args.collective_round_batch or None)
    loop_cfg = _loop_config(args, pspec, f"pipeline-{args.pipeline}",
                            loop_overrides, pipeline=args.pipeline)
    hooks = [_print_hook()]

    rows, reducer, step_fn, split = [], None, None, None
    if args.pipeline == "gpipe":
        gp = pl.gpipe(pipe_stage_fn, make_mesh((S,), ("stage",), device),
                      "stage", S)

        def step_fn(p, o, batch):
            xs, ts = batch["xs"][0].to(device), batch["ts"][0].to(device)
            with torch.enable_grad():
                ps = {k: v.detach().requires_grad_(True)
                      for k, v in p.items()}
                ys = gp(ps, xs)
                loss = torch.stack([pipe_loss_fn(ys[m], ts[m])
                                    for m in range(M)]).mean()
                g = torch.autograd.grad(loss, [ps[k] for k in sorted(ps)])
            p, o, om = opt_mod.apply(ocfg, o, p, dict(zip(sorted(ps), g)))
            return p, o, dict(loss=loss.detach(), **om)
    else:
        for r in range(D):
            rows.append(pl.PipelineSchedule(
                pipe_stage_fn, make_mesh((S,), ("stage",), device), "stage",
                S, loss_fn=pipe_loss_fn, engine=eng, executor=ex,
                name=f"pipe{r}"))

        def grad_fn(params, batch):
            xs, ts = batch["xs"].to(device), batch["ts"].to(device)
            # launch every row's DAG before waiting on any: the rows'
            # stage streams progress concurrently under the executor
            reqs = [rows[r].istep(params, xs[r], ts[r]) for r in range(D)]
            outs = [rows[r]._wait(reqs[r], timeout=600) for r in range(D)]
            losses = torch.stack([o[0] for o in outs])
            grads = {k: torch.stack([o[1][k] for o in outs])
                     for k in outs[0][1]}
            return {"loss": losses}, grads

        reducer = EngineGradReducer(mesh, "data", engine=eng, spec=pspec,
                                    mean=True)
        split = UserCollectiveStep(grad_fn, apply_fn, reducer, spec=pspec)

    trainer = Trainer(step_fn, params, opt_state, pipe, loop_cfg,
                      engine=eng, split_step=split, hooks=hooks)
    t0 = time.perf_counter()
    dispatches = 0
    try:
        log = trainer.run()
    finally:
        pipe.close()
        for r in rows:
            r.close()
        if reducer is not None:
            dispatches = reducer.dispatches_per_step
            reducer.close()
        ex.shutdown(drain=True, timeout=600)
    if log and rows:
        st = rows[0].stats()
        print(f"pipe0 stats: hops={st['hop_starts']} "
              f"p2p_completions={st['p2p_stream_completions']} "
              f"blocking_waits={st['blocking_waits']}")
    return TrainReport(trainer, None, log, time.perf_counter() - t0,
                       D * M * mb, reducer, dispatches, rows=rows)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    report = run(args)
    print(f"[{args.arch} scale={args.scale} device={args.device}]")
    for line in report.format():
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
