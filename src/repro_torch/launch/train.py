"""Training launcher of the port: the trainer on the progress engine,
native on one card or over ranks that share it — data-parallel, FSDP,
elastic, or a 1F1B pipeline.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --scale full --global-batch 8 --seq 1024 --steps 6   # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --devices 4 \
        --collective-backend user --scale full --global-batch 8 \
        --seq 1024 --steps 6                   # 4 ranks on the card
    PYTHONPATH=src python -m repro_torch.launch.train --devices 4 \
        --collective-backend user --rank-devices cuda:0,cuda:1,cuda:2,cuda:3 \
        --scale full --global-batch 8 --seq 1024 --steps 6  # a card a rank
    PYTHONPATH=src python -m repro_torch.launch.train --devices 4 --fsdp \
        --collective-backend user --scale full --global-batch 8 \
        --seq 1024 --steps 6                   # FSDP over 4 ranks
    PYTHONPATH=src python -m repro_torch.launch.train --devices 4 --fsdp \
        --collective-backend user --rank-devices cuda:0,cuda:1,cuda:2,cuda:3 \
        --scale full --global-batch 8 --seq 1024 --steps 6  # a card a rank
    PYTHONPATH=src python -m repro_torch.launch.train --devices 4 \
        [--fsdp] --rank-devices cuda:0,cuda:1,cuda:2,cuda:3 --scale full \
        --global-batch 8 --seq 1024 --steps 6   # native: NCCL between cards
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --scale tiny --steps 6 [--devices 4 --collective-backend user \
        [--fsdp] [--elastic --chaos-kill 2 --chaos-kill-step 2]]
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --pipeline 1f1b --mesh 2x2 --microbatches 4 --steps 6
    PYTHONPATH=src python -m repro_torch.launch.train --pipeline 1f1b \
        --mesh 1x4 --microbatches 8 --rank-devices \
        cuda:0,cuda:1,cuda:2,cuda:3 --steps 6    # a card a stage
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --scale tiny --mesh 1x4 --steps 6        # a model axis of 4 ranks
    PYTHONPATH=src python -m repro_torch.launch.train --scale full \
        --mesh 1x4 --rank-devices cuda:0,cuda:1,cuda:2,cuda:3 \
        --global-batch 8 --seq 1024 --steps 6    # a card a model rank
    PYTHONPATH=src python -m repro_torch.launch.train --scale full \
        --mesh 2x2 --fsdp --collective-backend user --rank-devices \
        cuda:0,cuda:1,cuda:2,cuda:3 --global-batch 8 --seq 1024 \
        --steps 6                 # FSDP, a copy of each row's blocks a card

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
computes the same mean gradient inside one step.  ``--rank-devices`` puts
each rank on a device of its own (a mesh with one device per rank,
``launch.mesh``): each rank holds a replica of the parameters and AdamW
state on its device, computes its gradients there on its slice of the
batch (copied from pinned host memory), the reducer's rounds copy
between the devices, and every rank applies AdamW to its own replica —
the losses and parameters of the rank-stacked run, bit for bit.  The
checkpoint holds rank 0's replica.  On the native backend
(``_run_native_devices``) the same replicas and passes meet in the step
through ``collectives.native_devices.native_allreduce``: NCCL where every
rank has a card of its own (the launcher exits where NCCL is not
available for them), else the sum in rank order on rank 0's device;
``--microbatches`` and ``--cast-bf16`` compose with it, as with the JAX
launcher's native backend.

``--mesh DxM`` on the native backend trains on a (data, model) mesh of
ranks on the one device, entered (``sharding.set_mesh``) around each
step: with ``attention_impl="ring"`` the causal attention splits the
sequence over the M model ranks (``collectives.ring_attention``), and
the MoE block splits the expert width over them when it is wide enough
(``layers.moe_tp_ranks``); every other layer replicates over the model
axis, and the data axis splits nothing the one pass over the batch does
not already sum (the JAX launcher's ``build_cell`` under the same mesh).
A config with "ring" goes through ``run(args, config=...)``.  With
``--rank-devices`` (D·M devices, rank (d, m) on ``devices[d*M + m]``)
the model axis runs with a device per rank (``_run_model_devices``):
each data row's replicated layers once on its leader's device, the
ring's sequence blocks and the MoE block's F-slices on the ranks'
devices, the rows' gradients averaged over a reducer a model column;
``--microbatches`` splits the batch as the one-device step does.

``--fsdp`` shards parameters and AdamW moments over the mesh's data
axis as flat per-dtype buckets (``FsdpLayout``, ``--fsdp-bucket-bytes``):
each step all-gathers the full flat buckets, rank r's forward reading
row r, and reduce-scatters the gradient buckets so each rank receives
only the block it applies (``build_fsdp_programs``).  The user backend
moves both through an ``FsdpReducer``'s persistent handles, the next
step's gathers chained off the optimizer's compute futures; the native
backend stacks and sums over the rank dim in the step.  A model axis
(``--mesh DxM``) replicates: each data rank's work is computed once.
With ``--rank-devices`` rank r's blocks, moments, step counter and pass
live on its own device, the user reducer's rounds copy between the
devices (the native backend's pair is ``collectives.native_devices``'
NCCL calls or its sum in rank order), and the checkpoint holds the
blocks glued in rank order: the stacked run's losses, shards and
checkpoint files, bit for bit (on NCCL within its sum order).  On a
model axis every device of data row d holds a copy of its blocks; the
row's work runs on its leader, and every copy steps.

``--elastic`` (user backend) shares a ``MembershipEpoch`` between the
watchdog, an optional heartbeat monitor (``--heartbeat-timeout``) and
the reducer's persistent collectives; ``--chaos-kill N`` invalidates it
after step ``--chaos-kill-step`` (the loop logs every step then), and
the trainer remeshes onto the survivors and retries the step's batch.

``--pipeline gpipe|1f1b`` trains a residual-MLP stage stack against a
fixed linear teacher on a (data x stage) mesh (``_run_pipeline``); with
``--rank-devices`` (D·S devices, rank (d, s) on ``devices[d*S + s]``)
each stage runs on its rank's device, the losses and checkpoint files of
the rank-stacked run, bit for bit.

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
    ap.add_argument("--rank-devices", default="",
                    help="a device per data-parallel rank, comma-separated "
                         "(e.g. cuda:0,cuda:1,cuda:2,cuda:3; a device may "
                         "repeat); as many as --devices, either backend "
                         "(native: NCCL between distinct cards); composes "
                         "with --fsdp; with --pipeline a device per (data, "
                         "stage) rank, row-major; with a model axis above "
                         "1 a device per (data, model) rank, row-major "
                         "(native backend, or --fsdp)")
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


def make_rank_grads(cfg, ranks: int, *, cast_params_bf16: bool = False,
                    mesh=None):
    """``grad_fn(params, batch) -> (stacked_metrics, stacked_grads)``: the
    loss and gradients of ``registry.loss_fn`` on each rank's contiguous
    slice of the batch, one rank after the other, each rank's gradients
    written as f32 into row r of ``[ranks, *shape]`` leaves (the JAX
    launcher's ``v[None].astype(f32)``); metrics ``[ranks]``.  The bf16
    cast as in ``make_train_step``.

    On a ``mesh`` with a device per rank, ``params`` is a tree of
    ``RankShards`` replicas: rank r's pass runs with its device current,
    on its replica and on its slice of the batch copied to that device,
    and its f32 gradients are the ``[1, *shape]`` shards of ``RankShards``
    leaves; the metrics are stacked on rank 0's device."""
    from repro_torch.launch.steps import compute_params
    from repro_torch.models import registry
    from repro_torch.models.layers import tree_from_leaves, tree_leaves

    model_params = compute_params(cfg, cast_params_bf16)
    if mesh is not None and mesh.per_device:
        return _rank_grads_per_device(cfg, ranks, model_params, mesh)

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


def _rank_grads_per_device(cfg, ranks: int, model_params, mesh):
    """``make_rank_grads`` on a mesh with a device per rank."""
    from repro_torch.collectives.rank_shards import RankShards, \
        device_context, tree_shard
    from repro_torch.models import registry
    from repro_torch.models.layers import tree_from_leaves, tree_leaves

    devices = mesh.devices
    if len(devices) != ranks:
        raise ValueError(f"{ranks} ranks on {mesh!r}")

    def grad_fn(params, batch):
        per = batch["tokens"].shape[0] // ranks
        rank_grads, mets, paths = [], [], None
        for r, dev in enumerate(devices):
            with device_context(dev):
                replica = tree_shard(params, r)
                paths, leaves = zip(*tree_leaves(replica))
                for t in leaves:
                    t.requires_grad_(True)
                local = {k: v[r * per:(r + 1) * per].to(dev, non_blocking=True)
                         for k, v in batch.items()}
                loss, m = registry.loss_fn(model_params(replica), cfg, local)
                grads = torch.autograd.grad(loss, leaves)
                rank_grads.append([g.to(torch.float32)[None] for g in grads])
                del grads
                mets.append({k: v.detach()
                             for k, v in dict(m, loss=loss).items()})
        first = devices[0]
        stacked_mets = {k: torch.stack([m[k].to(first) for m in mets])
                        for k in mets[0]}
        return stacked_mets, tree_from_leaves(
            zip(paths, [RankShards(g) for g in zip(*rank_grads)]))

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
      over the rank dim with row r its block r.

    On a ``mesh`` with a device per rank the flats, the gradient buckets
    and the shards are ``RankShards`` (rank r's ``[1, W]`` and ``[1,
    W/n]`` on its device): ``grad_fn`` runs rank r's pass with its device
    current, over views of its gathered flats, on its slice of the batch
    copied there from the host (pinned on the card's machine), and stacks
    the metrics on rank 0's device; ``apply_fn`` steps each rank's blocks
    on its device.  A model axis there holds copies (``FsdpLayout.
    shard_params``): the flats and gradients live on the data axis's
    leaders (rank (d, 0)), each data rank's pass runs once on its leader,
    and ``apply_fn`` sends each reduced block to the rest of its row
    (``rank_shards.spread``) before every copy steps on its card, the
    grad norm adding each data rank's partial once.  The native pair
    there runs over the leaders (``collectives.native_devices``): ``ag_fn``
    gives each leader its ``[1, W]`` flats, the leaders' blocks glued in
    rank order; ``rs_fn`` gives leader r block r ``[1, W/n]`` of the sum
    of the leaders' gradient buckets (NCCL where every leader has a card
    of its own, else the sum in rank order on leader 0's device, which
    is the stacked ``rs_fn``'s sum)."""
    from repro_torch.collectives.overlap import tree_flatten
    from repro_torch.models import registry
    from repro_torch.train import optimizer as opt_mod

    n = layout.n
    if dict(mesh.shape)[axis] != n:
        raise ValueError(f"mesh axis {axis!r} has {dict(mesh.shape)[axis]} "
                         f"ranks, the layout {n}")

    def rank_pass(rows, local, out_rows):
        """One rank's forward and backward over its gathered flat rows
        ``[W]``, its f32 gradients written into ``out_rows``; its
        metrics."""
        leaves, rebuild = tree_flatten(layout.unflatten(rows))
        with torch.enable_grad():
            ps = [t.detach().requires_grad_(True) for t in leaves]
            loss, m = registry.loss_fn(rebuild(ps), cfg, local)
            grads = torch.autograd.grad(loss, ps)
        for b, bucket in enumerate(layout.buckets):
            off = 0
            for i in bucket:
                size = layout.sizes[i]
                out_rows[b][off:off + size].copy_(grads[i].reshape(-1))
                off += size
        del grads
        return {k: v.detach() for k, v in dict(m, loss=loss).items()}

    if mesh.per_device:
        return _fsdp_per_device(mesh, layout, rank_pass, ocfg, axis)

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
            local = {k: v[r * per:(r + 1) * per] for k, v in batch.items()}
            mets.append(rank_pass([f[r] for f in flats], local,
                                  [g[r] for g in flat_g]))
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


def _fsdp_per_device(mesh, layout, rank_pass, ocfg, axis: str):
    """``build_fsdp_programs``' four programs on a mesh with a device per
    rank: the passes and the native pair on ``axis``'s leaders, the AdamW
    step on every copy."""
    from repro_torch.collectives import native_devices
    from repro_torch.collectives.rank_shards import RankShards, \
        device_context, spread
    from repro_torch.launch.mesh import axis_column
    from repro_torch.train import optimizer as opt_mod
    devices, n = axis_column(mesh, axis).devices, layout.n
    if len(devices) != n:
        raise ValueError(f"{n} FSDP ranks on {mesh!r}")

    def grad_fn(flats, batch):
        per = batch["tokens"].shape[0] // n
        grads, mets = [[] for _ in flats], []
        for r, dev in enumerate(devices):
            with device_context(dev):
                rows = []
                for b, f in enumerate(flats):
                    g = torch.empty((1, layout.widths[b]),
                                    dtype=torch.float32, device=dev)
                    g[:, layout.totals[b]:].zero_()
                    grads[b].append(g)
                    rows.append(g[0])
                local = {k: v[r * per:(r + 1) * per].to(dev,
                                                        non_blocking=True)
                         for k, v in batch.items()}
                mets.append(rank_pass([f[r][0] for f in flats], local, rows))
        first = devices[0]
        stacked = {k: torch.stack([m[k].to(first) for m in mets])
                   for k in mets[0]}
        return stacked, [RankShards(g) for g in grads]

    def apply_fn(shards, opt_state, grad_shards, stacked_mets):
        # the leaders' reduced blocks, and a copy on each other rank of
        # their rows (none without a model axis)
        grad_shards = [spread(g, s.devices)
                       for g, s in zip(grad_shards, shards)]
        shards, opt_state, om = opt_mod.apply_shards(
            ocfg, opt_state, shards, grad_shards, grad_scale=1.0 / n)
        with device_context(devices[0]):
            mets = {k: v.mean() for k, v in stacked_mets.items()}
        return shards, opt_state, dict(mets, **om)

    def ag_fn(shards):
        # the first copy of each bucket's blocks: the leaders'
        return [native_devices.native_all_gather(RankShards(s.blocks))
                .map(lambda t: t.view(1, -1)) for s in shards]

    def rs_fn(flat_grads):
        return [native_devices.native_reduce_scatter(g)
                .map(lambda t: t.view(1, -1)) for g in flat_grads]

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


def _rank_devices(args):
    """``--rank-devices`` as a list of devices (None when not given).
    Every form takes it on either backend; the refusals are the JAX
    launcher's (``run``)."""
    if not args.rank_devices:
        return None
    return [torch.device(d.strip()) for d in args.rank_devices.split(",")]


def _native_route(devices) -> str:
    """The route of the native collectives over ``devices``
    (``collectives.native_devices.route``); exits where the ranks are on
    distinct cards and NCCL is not available for them."""
    from repro_torch.collectives import native_devices
    try:
        native_devices.require_nccl(devices)
    except RuntimeError as exc:
        raise SystemExit(f"--collective-backend native --rank-devices: "
                         f"{exc}") from None
    return native_devices.route(devices)


def _replicate_state(params, mesh):
    """A replica of ``params`` and of fresh AdamW state on each rank's
    device (``RankShards`` leaves)."""
    from repro_torch.collectives.rank_shards import replicate_tree
    from repro_torch.train import optimizer as opt_mod
    params = replicate_tree(params, mesh.devices)
    return params, opt_mod.init(params)


def _apply_per_device(ocfg):
    """``apply_fn`` over per-rank replicas: AdamW on each rank's replica
    on its device, the metrics' mean on rank 0's (where the gradient
    pass stacked them), the optimizer's own metrics rank 0's."""
    from repro_torch.collectives.rank_shards import device_context, \
        tree_shard, tree_stack
    from repro_torch.models.layers import tree_leaves
    from repro_torch.train import optimizer as opt_mod

    def apply_fn(params, opt_state, grads, stacked_mets):
        outs = []
        for r, dev in enumerate(next(t for _, t in tree_leaves(params))
                                .devices):
            with device_context(dev):
                outs.append(opt_mod.apply(ocfg, tree_shard(opt_state, r),
                                          tree_shard(params, r),
                                          tree_shard(grads, r)))
        mets = {k: v.mean() for k, v in stacked_mets.items()}
        return (tree_stack([o[0] for o in outs], replica=True),
                tree_stack([o[1] for o in outs], replica=True),
                dict(mets, **outs[0][2]))

    return apply_fn


def _run_native_devices(args, cfg, ocfg, params, data: int, rank_devices,
                        spec, eng, pipe, loop_overrides) -> TrainReport:
    """``--collective-backend native --rank-devices`` for data-parallel
    training on ``Dx1``: a replica of the parameters and AdamW state on
    each rank's device (``_replicate_state``), each rank's pass on its
    device over its slice of the batch (``make_row_grads`` on the ``(D,
    1)`` mesh: with ``--microbatches`` k each rank takes its share of each
    microbatch, and an MoE model's ranks run in lockstep, routing the
    whole batch's groups as the stacked native step does), the
    gradients' mean through
    ``collectives.native_devices.native_allreduce`` inside the step (NCCL
    where every rank has a card of its own, the sum in rank order on rank
    0's device otherwise), then AdamW on every replica.  The Trainer's
    step future covers every device's work (it watches the replicas)."""
    from repro_torch.collectives import native_devices
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import tree_map
    from repro_torch.train.train_loop import Trainer
    k = args.microbatches
    if args.global_batch % (data * k):
        raise SystemExit(f"--global-batch {args.global_batch} does not "
                         f"split into {k} microbatch(es) over {data} "
                         f"rank(s)")
    mesh = make_mesh((data, 1), ("data", "model"), devices=rank_devices)
    route = _native_route(mesh.devices)
    native_devices.warm(mesh.devices)
    params, opt_state = _replicate_state(params, mesh)
    grad_fn = make_row_grads(cfg, mesh, microbatches=k,
                             cast_params_bf16=args.cast_bf16)
    apply_fn = _apply_per_device(ocfg)

    def mean(g):
        return native_devices.native_allreduce(g.map(lambda t: t[0]),
                                               mean=True)

    def step_fn(params, opt_state, batch):
        stacked_mets, grads = grad_fn(params, batch)
        return apply_fn(params, opt_state, tree_map(mean, grads),
                        stacked_mets)

    print(f"collective backend: native ({route}"
          + (f", NCCL {native_devices.nccl_version()}" if route == "nccl"
             else ", the sum in rank order on rank 0's device")
          + f"; {k} microbatch(es) a step) over {mesh}", flush=True)
    trainer = Trainer(step_fn, params, opt_state, pipe,
                      _loop_config(args, spec, args.arch, loop_overrides),
                      engine=eng, hooks=[_print_hook()])
    t0 = time.perf_counter()
    log = trainer.run()
    return TrainReport(trainer, cfg, log, time.perf_counter() - t0,
                       args.global_batch * args.seq)


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

    rank_devices = _rank_devices(args)
    if args.pipeline != "none":
        return _run_pipeline(args, rank_devices, params=params,
                             **loop_overrides)
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
    if rank_devices is not None and len(rank_devices) != data * model:
        raise SystemExit(f"--rank-devices names {len(rank_devices)} "
                         f"device(s) for {data * model} rank(s) (data "
                         f"{data} x model {model})")
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
                             spec, eng, pipe, to_device, loop_overrides,
                             rank_devices)
        finally:
            pipe.close()
    if rank_devices is not None and model > 1:
        try:
            return _run_model_devices(args, cfg, ocfg, params, (data, model),
                                      rank_devices, eng, pipe,
                                      loop_overrides)
        finally:
            pipe.close()
    if rank_devices is not None and not user_backend:
        try:
            return _run_native_devices(args, cfg, ocfg, params, data,
                                       rank_devices, spec, eng, pipe,
                                       loop_overrides)
        finally:
            pipe.close()

    # the per-device form makes its replicas' state below, on each device
    opt_state = opt_mod.init(params) if rank_devices is None else None
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

        def make_grad_fn(mesh_):
            ranks = dict(mesh_.shape)["data"]
            rank_grads = make_rank_grads(cfg, ranks,
                                         cast_params_bf16=args.cast_bf16,
                                         mesh=mesh_)
            if mesh_.per_device:
                # each rank's slice goes from pinned host memory to its
                # own device
                return rank_grads
            return lambda params, batch: rank_grads(params,
                                                    to_device(batch))

        def apply_fn(params, opt_state, grads, stacked_mets):
            params, opt_state, om = opt_mod.apply(ocfg, opt_state, params,
                                                  grads)
            mets = {k: v.mean() for k, v in stacked_mets.items()}
            return params, opt_state, dict(mets, **om)

        if rank_devices is not None:
            mesh = make_mesh((data, 1), ("data", "model"),
                             devices=rank_devices)
            params, opt_state = _replicate_state(params, mesh)
            apply_fn = _apply_per_device(ocfg)
        else:
            mesh = make_mesh((data, 1), ("data", "model"), device)
        if _elastic_on(args):
            from repro_torch.collectives.nonblocking import MembershipEpoch
            epoch = MembershipEpoch(mesh=mesh)
        reducer = EngineGradReducer(mesh, "data", engine=eng, spec=spec,
                                    mean=True, epoch=epoch)
        split = UserCollectiveStep(make_grad_fn(mesh), apply_fn, reducer,
                                   spec=spec)
        if epoch is not None:
            from repro_torch.collectives.rank_shards import tree_keep
            from repro_torch.distributed import elastic
            live = {"mesh": mesh}

            def remesh_fn(exc, params, opt_state):
                # survivors' mesh: pure data-parallel (model dim stays 1);
                # ranks that share the one device keep the state where it
                # is, ranks on devices of their own keep the replicas of
                # the first devices the new mesh takes
                if live["mesh"].per_device:
                    new_mesh = elastic.remesh(
                        exc.survivors, prefer_model=1,
                        devices=live["mesh"].devices[:exc.survivors])
                    params = tree_keep(params, new_mesh.size)
                    opt_state = tree_keep(opt_state, new_mesh.size)
                else:
                    new_mesh = elastic.remesh(exc.survivors, prefer_model=1,
                                              device=device)
                live["mesh"] = new_mesh
                print(f"remesh: {exc.survivors} survivor(s) -> mesh "
                      f"{dict(new_mesh.shape)}", flush=True)
                reducer.remesh(new_mesh, "data")
                return (UserCollectiveStep(make_grad_fn(new_mesh), apply_fn,
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


def make_row_grads(cfg, mesh, *, microbatches: int = 1,
                   cast_params_bf16: bool = False):
    """``grad_fn(params, batch) -> (stacked_metrics, grads)`` on a (data,
    model) mesh of D x M ranks with a device per rank (rank (d, m) on
    ``mesh.devices[d*M + m]``), ``params`` placed as
    ``bridge.params_on_model_axis`` places them.

    Row d's pass runs on its leader's card (rank (d, 0)), on its
    contiguous slice of the batch copied there from the host, inside the
    row's ``(1, M)`` mesh (``sharding.set_mesh``): the replicated layers
    once on the leader, the ring's sequence blocks and the MoE block's
    F-slices on the row's ranks' cards.  With D > 1 an MoE model's rows
    run in lockstep, layer by layer (``registry.loss_fn_rows``): each MoE
    layer routes the whole batch's groups, each on the row that holds its
    first token, whatever rows it spans, and each row's aux loss takes
    the batch's routed shares, so the rows' mean loss and gradients are
    the batch's; one backward runs over every row's loss.  Every other
    model's rows run one after the other, each forward before any
    backward.  The gradients are f32 ``[1, *shape]`` shards of
    ``RankShards`` leaves, the form the reducer takes: a replicated leaf's
    on the D leaders, an F-sliced leaf's on every rank (row-major); the
    metrics are stacked on rank (0, 0)'s card.

    With ``microbatches`` k > 1, microbatch i is the batch's i-th
    contiguous slice (``launch.steps.train_step_fn``'s split) and row d
    takes its d-th share of each, one microbatch after the other (the
    batch above is then the microbatch); each row's gradients and loss
    are summed in f32 over the microbatches in order and scaled by 1/k,
    as the stacked step does, and its metrics are ``{"nll": loss, "aux":
    0, "loss": loss}``."""
    import contextlib

    from repro_torch import sharding
    from repro_torch.collectives.rank_shards import RankShards, \
        device_context
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import compute_params
    from repro_torch.models import layers as L
    from repro_torch.models import registry

    D, M = dict(mesh.shape)["data"], dict(mesh.shape)["model"]
    rows = [mesh.devices[d * M:(d + 1) * M] for d in range(D)]
    leaders = [row[0] for row in rows]
    row_meshes = [make_mesh((1, M), ("data", "model"), devices=row)
                  for row in rows]
    model_params = compute_params(cfg, cast_params_bf16)
    rules = sharding.merged_rules(cfg.sharding_overrides)
    lockstep = D > 1 and cfg.moe is not None
    k = microbatches

    def row_tree(params, d):
        return L.tree_map(lambda leaf: leaf.shards[d] if leaf.replica else
                          RankShards(leaf.shards[d * M:(d + 1) * M],
                                     dim=leaf.dim), params)

    @contextlib.contextmanager
    def row_context(d):
        with device_context(leaders[d]), sharding.set_mesh(row_meshes[d]), \
                sharding.axis_rules(rules):
            yield

    contexts = [lambda d=d: row_context(d) for d in range(D)]

    def passes(trees, batch, lo, per):
        """Every row's ``(loss, metrics, gradients)`` on its share of the
        rows ``lo .. lo + D*per`` of ``batch``."""
        locals_, params = [], []
        for d, (paths, leaves, _) in enumerate(trees):
            with contexts[d]():
                locals_.append({key: v[lo + d * per:lo + (d + 1) * per].to(
                    leaders[d], non_blocking=True)
                    for key, v in batch.items()})
                params.append(model_params(
                    L.tree_from_leaves(zip(paths, leaves))))
        if lockstep:
            outs = registry.loss_fn_rows(params, cfg, locals_, contexts)
            wrt = [t for tree in trees for t in tree[2]]
            with device_context(leaders[0]):
                flat = torch.autograd.grad([loss for loss, _ in outs], wrt,
                                           allow_unused=True)
            # a row that serves no group gets no gradient of its MoE copy
            flat = iter(torch.zeros_like(t) if g is None else g
                        for t, g in zip(wrt, flat))
            return [(loss, m, [next(flat) for _ in tree[2]])
                    for (loss, m), tree in zip(outs, trees)]
        outs = []
        for d in range(D):
            with contexts[d]():
                outs.append(registry.loss_fn(params[d], cfg, locals_[d]))
        grads = []
        for d, (loss, _) in enumerate(outs):
            with device_context(leaders[d]):
                grads.append(torch.autograd.grad(loss, trees[d][2]))
        return [(loss, m, g) for (loss, m), g in zip(outs, grads)]

    def grad_fn(params, batch):
        mb = batch["tokens"].shape[0] // k
        trees = []
        for d in range(D):
            paths, leaves = zip(*L.tree_leaves(row_tree(params, d)))
            tensors = [t for leaf in leaves for t in (
                leaf.shards if isinstance(leaf, RankShards) else (leaf,))]
            for t in tensors:
                t.requires_grad_(True)
            trees.append((paths, leaves, tensors))
        sums, mets = [None] * D, [None] * D
        for i in range(k):
            for d, (loss, m, g) in enumerate(passes(trees, batch, i * mb,
                                                    mb // D)):
                with device_context(leaders[d]):
                    if k == 1:
                        sums[d] = [x.to(torch.float32) for x in g]
                        mets[d] = dict(m, loss=loss)
                    elif sums[d] is None:
                        sums[d] = [x.float() for x in g]
                        mets[d] = torch.zeros((), dtype=torch.float32,
                                              device=leaders[d]) \
                            + loss.detach()
                    else:
                        sums[d] = [a + x.float() for a, x in zip(sums[d], g)]
                        mets[d] = mets[d] + loss.detach()
        if k > 1:
            inv = 1.0 / k
            for d in range(D):
                with device_context(leaders[d]):
                    sums[d] = [x * inv for x in sums[d]]
                    loss = mets[d] * inv
                    mets[d] = {"nll": loss, "aux": torch.zeros_like(loss),
                               "loss": loss}
        grads = {}
        for (paths, leaves, _), row in zip(trees, sums):
            it = iter(row)
            for path, leaf in zip(paths, leaves):
                n = len(leaf.shards) if isinstance(leaf, RankShards) else 1
                grads.setdefault(path, []).extend(
                    next(it)[None] for _ in range(n))
        first = mesh.devices[0]
        with device_context(first):
            stacked = {key: torch.stack([m[key].detach().to(first)
                                         for m in mets])
                       for key in mets[0]}
        return stacked, L.tree_from_leaves((path, RankShards(g))
                                           for path, g in grads.items())

    return grad_fn


def _only_row(g):
    """A leaf of one data rank, in a reducer's output form: its row."""
    from repro_torch.collectives.rank_shards import RankShards
    return g.map(lambda t: t[0]) if isinstance(g, RankShards) else g[0]


class _ColumnReducer:
    """The data-axis gradient reduction of a (data x c) mesh, c its model
    axis or a pipeline's stages: one ``EngineGradReducer`` a column, over
    a 1-D data mesh of that column's D ranks (their devices in the
    per-device form).  It runs on the user-space collectives whatever
    ``--collective-backend`` says.  With one data rank no reducer is
    built: the row's gradients are the step's.

    ``split(grads)`` gives each column's tree in the reducer's input form
    (``[D, ...]`` leaves, or ``RankShards`` of the column's ``[1, ...]``
    shards; ``{}`` for a column with nothing to reduce).  ``join(cols)``
    takes the columns' means (each leaf once, or a ``RankShards`` of each
    rank's copy) and gives the tree the optimizer takes."""

    def __init__(self, meshes: list, split, join, *, engine, spec):
        from repro_torch.collectives.overlap import EngineGradReducer
        self.axis_size = dict(meshes[0].shape)["data"]
        self.split, self.join = split, join
        self.reducers = [] if self.axis_size == 1 else [
            EngineGradReducer(m, "data", engine=engine, spec=spec, mean=True)
            for m in meshes]

    @property
    def dispatches_per_step(self) -> int:
        return sum(r.dispatches_per_step for r in self.reducers)

    def iallreduce_tree(self, grads):
        from repro_torch.models.layers import tree_map
        trees = self.split(grads)
        if not self.reducers:
            return _ColumnReduction([tree_map(_only_row, t) for t in trees],
                                    self.join)
        return _ColumnReduction([r.iallreduce_tree(t) if t else {}
                                 for r, t in zip(self.reducers, trees)],
                                self.join)

    def close(self) -> None:
        for r in self.reducers:
            r.close()


class _ColumnReduction:
    """The columns' reductions in flight (with one data rank, their trees
    as they are)."""

    def __init__(self, parts: list, join):
        self.parts, self.join = parts, join
        self.issue_s = sum(getattr(p, "issue_s", 0.0) for p in parts)

    def wait(self, timeout: float | None = None):
        from repro_torch.collectives.overlap import TreeReduction
        return self.join([p.wait(timeout=timeout)
                          if isinstance(p, TreeReduction) else p
                          for p in self.parts])


def model_columns(mesh, dims: dict, *, engine, spec) -> _ColumnReducer:
    """The data-axis reduction of a (data x model) mesh with a device per
    rank, a model column at a time.  Column 0 (the leaders) reduces the
    replicated leaves and its F-slices, column m > 0 its F-slices.  It
    takes ``make_row_grads``' gradients and gives the mean in the form the
    optimizer takes: a replica on the leaders, or the F-slices as
    ``RankShards`` blocks split on ``dims[path]``, a copy per row."""
    from repro_torch.collectives.rank_shards import RankShards
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import tree_from_leaves, tree_leaves
    D, M = dict(mesh.shape)["data"], dict(mesh.shape)["model"]

    def split(grads):
        cols = [{} for _ in range(M)]
        for path, g in tree_leaves(grads):
            if path in dims:
                for m in range(M):
                    cols[m][path] = RankShards(g.shards[m::M])
            else:
                cols[0][path] = g
        return [tree_from_leaves(c.items()) for c in cols]

    def join(cols):
        got = [dict(tree_leaves(c)) for c in cols]
        return tree_from_leaves(
            (path, RankShards(g.shards, replica=True)) if path not in dims
            else (path, RankShards((got[m][path].shards[d] for d in range(D)
                                    for m in range(M)),
                                   copies=D, dim=dims[path]))
            for path, g in got[0].items())

    return _ColumnReducer([make_mesh((D,), ("data",),
                                     devices=mesh.devices[m::M])
                           for m in range(M)], split, join,
                          engine=engine, spec=spec)


def _run_model_devices(args, cfg, ocfg, params, shape, rank_devices, eng,
                       pipe, loop_overrides) -> TrainReport:
    """``--mesh DxM --rank-devices`` (M > 1, native backend): the model
    axis with a device per rank, rank (d, m) on ``rank_devices[d*M +
    m]`` (row-major, as ``jax.sharding.Mesh.devices``).

    Where the layers run: each data row's replicated layers (embedding,
    norms, QKV and RoPE, the out-projection, the MLP, the router, the
    final norm and the loss) run once, on its leader's card, rank (d, 0),
    on row d's slice of the batch, as the rank-stacked model axis computes
    them once; the ring's sequence blocks (``ring_attention``) and the MoE
    block's F-slices (``layers._MoEBlockPerDevice``: weights, gradients,
    AdamW moments and each slice's expert FFN) live on the ranks' cards.
    The leaders hold a replica of every other leaf (and its moments), every
    rank a step counter.  One host thread drives every card, so ranks
    that share a card run one after the other.

    A step is the split step: ``make_row_grads``, then (D > 1) the mean
    over each model column's D ranks (``model_columns``), then AdamW on
    each leaf's cards (``optimizer.apply`` over placed leaves: the grad
    norm from each leaf's square sums, a sliced leaf's slices in rank
    order, added on rank (0, 0)'s card).  Data moved between cards a
    step: the ring's blocks and hops and the MoE block's tokens and
    partials, with D > 1 an MoE group's tokens and outputs where the
    group spans rows (``rank_shards.transfers`` counts them), and for
    D > 1 the column reductions.  With one data row the losses,
    parameters and checkpoint files equal the rank-stacked ``--mesh
    1xM`` run's bit for bit; the checkpoint holds the replicas once and
    the F-slices glued along F, the stacked run's files.  With D > 1 the
    rows of an MoE model run in lockstep and route the whole batch's
    groups, as the stacked run does (``make_row_grads``), so any batch
    that splits over the rows trains.

    ``--microbatches`` k > 1 splits the batch as the stacked step does:
    each row takes its share of each microbatch in turn and accumulates
    (``make_row_grads``); each leader launches k times the kernels of one
    pass (``kernel_launches_per_step(cfg, k, M)``), the other ranks none.
    An MoE model's rows then route each microbatch's groups."""
    from repro_torch.collectives.nonblocking import CollectiveSpec
    from repro_torch.collectives.rank_shards import device_context
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.bridge import params_on_model_axis
    from repro_torch.models.layers import expert_width_dims
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_loop import Trainer, UserCollectiveStep

    D, M = shape
    k = args.microbatches
    if args.global_batch % (D * k):
        raise SystemExit(f"--global-batch {args.global_batch} does not "
                         f"split into {k} microbatch(es) over {D} data "
                         f"row(s)")
    mesh = make_mesh(shape, ("data", "model"), devices=rank_devices)
    params = params_on_model_axis(params, cfg, mesh)
    opt_state = opt_mod.init(params)
    dims = expert_width_dims(cfg, M)
    spec = CollectiveSpec(backend="user", algorithm=args.collective_algorithm,
                          chunks=args.collective_chunks,
                          round_batch=args.collective_round_batch or None)
    reducer = model_columns(mesh, dims, engine=eng, spec=spec)
    first = mesh.devices[0]

    def apply_fn(params, opt_state, grads, stacked_mets):
        params, opt_state, om = opt_mod.apply(ocfg, opt_state, params, grads)
        with device_context(first):
            mets = {k: v.mean() for k, v in stacked_mets.items()}
        return params, opt_state, dict(mets, **om)

    split = UserCollectiveStep(
        make_row_grads(cfg, mesh, microbatches=k,
                       cast_params_bf16=args.cast_bf16),
        apply_fn, reducer, spec=spec)
    print(f"model axis with a device per rank: data {D} x model {M} on "
          f"{[str(d) for d in mesh.devices]}; {len(dims)} leaf/leaves as "
          f"F-slices; {k} microbatch(es) a step; the data reduction "
          + (f"over {M} model column(s) ({reducer.reducers[0].algorithm})"
             if D > 1 else "none (one row)"), flush=True)
    trainer = Trainer(None, params, opt_state, pipe,
                      _loop_config(args, spec, args.arch, loop_overrides),
                      engine=eng, hooks=[_print_hook()], split_step=split)
    t0 = time.perf_counter()
    try:
        log = trainer.run()
    finally:
        dispatches = reducer.dispatches_per_step
        reducer.close()
    return TrainReport(trainer, cfg, log, time.perf_counter() - t0,
                       args.global_batch * args.seq, reducer, dispatches)


def fsdp_state(params, mesh, bucket_bytes: int, axis: str = "data",
               moments=None, step=None):
    """FSDP's resident state on ``mesh``: ``(layout, shards, opt_state)``,
    the full ``params`` tree sharded over ``axis`` (``FsdpLayout``; copies
    over a model axis with a device per rank), with fresh AdamW state, or
    with the full ``moments`` (mu, nu) sharded alike beside ``step``."""
    from repro_torch.collectives.overlap import FsdpLayout
    from repro_torch.train import optimizer as opt_mod
    layout = FsdpLayout(params, dict(mesh.shape)[axis], bucket_bytes)
    shards = layout.shard_params(params, mesh, axis)
    if moments is None:
        return layout, shards, opt_mod.init_shards(shards)
    return layout, shards, opt_mod.AdamWState(
        step, *(layout.shard_params(m, mesh, axis) for m in moments))


def fsdp_remesh(layout, shards, opt_state, old_mesh, new_mesh,
                bucket_bytes: int, axis: str = "data"):
    """FSDP's state moved onto the survivors' ``new_mesh`` (a remesh):
    ``fsdp_state`` of the params and moments unsharded from the leaders'
    blocks (glued on rank 0's device; shard widths depend on the data-axis
    size), the step counter carried: with a device per rank new rank r,
    on old rank r's device, keeps that rank's counter."""
    from repro_torch.collectives.rank_shards import RankShards
    from repro_torch.launch.mesh import axis_ranks
    step = opt_state.step
    if new_mesh.per_device:
        kept = dict(zip(axis_ranks(old_mesh, axis), step.shards))
        step = RankShards((kept[r] for r in axis_ranks(new_mesh, axis)),
                          replica=True)
    return fsdp_state(layout.unshard_params(shards), new_mesh, bucket_bytes,
                      axis, (layout.unshard_params(opt_state.mu),
                             layout.unshard_params(opt_state.nu)), step)


def _run_fsdp(args, cfg, ocfg, params, device, shape, spec, eng, pipe,
              to_device, loop_overrides, rank_devices=None) -> TrainReport:
    """ZeRO-style FSDP over the mesh's data axis.

    Params and AdamW moments live as flat per-dtype bucket shards
    ``[n, W/n]`` (rank ``r`` owns row ``r``); every step all-gathers the
    full flat buckets for the forward/backward and reduce-scatters the
    grad buckets so each rank receives only the block it applies.
    ``--collective-backend user`` moves both through persistent engine
    handles, with the next step's gathers chained as continuations off
    the optimizer's compute futures; ``native`` runs the same programs
    with ``ag_fn``/``rs_fn`` in the step.  The model axis replicates, so
    the same step runs unchanged on (4,1) and (2,2).

    With ``rank_devices`` data rank ``r``'s blocks, moments, step counter
    and pass live on its device: the user reducer's rounds copy between
    the devices (the native backend runs the per-device ``ag_fn``/
    ``rs_fn`` of ``build_fsdp_programs`` in the step, over the leaders),
    and a remesh re-shards onto the first of the survivors' devices.  On a model axis of M > 1 (rank (d,
    m) on ``rank_devices[d*M + m]``) every rank of row d holds a copy of
    its blocks, moments and a step counter, as JAX's ``NamedSharding(mesh,
    P("data"))`` places them; the row's gather, pass and reduce-scatter
    run once, on its leader's card over the leaders' column, and the
    reduced blocks go to the rest of the row, where every copy takes its
    own AdamW step.  The losses, the shards and the checkpoint equal the
    rank-stacked run's bit for bit, and so the per-device ``Dx1`` run's;
    a remesh keeps the model dim (JAX's ``prefer_model``)."""
    from repro_torch.collectives.nonblocking import MembershipEpoch
    from repro_torch.collectives.overlap import FsdpReducer
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.train_loop import FsdpStep, Trainer

    axis = "data"
    user_backend = args.collective_backend == "user"
    if rank_devices is not None:
        mesh = make_mesh(shape, ("data", "model"), devices=rank_devices)
    else:
        mesh = make_mesh(shape, ("data", "model"), device)
    epoch = MembershipEpoch(mesh=mesh) if _elastic_on(args) else None
    layout, shards, opt_state = fsdp_state(params, mesh,
                                           args.fsdp_bucket_bytes, axis)
    del params
    copies = (f", a copy on each of model={shape[1]} card(s) a row"
              if mesh.per_device and shape[1] > 1 else "")
    if mesh.per_device and not user_backend:
        from repro_torch.collectives import native_devices
        from repro_torch.launch.mesh import axis_column
        leaders = axis_column(mesh, axis).devices
        copies += f", the native pair on the {_native_route(leaders)} route"
        native_devices.warm(leaders)
    print(f"fsdp: {layout.num_buckets} bucket(s), shard widths "
          f"{[w // layout.n for w in layout.widths]} over {axis}="
          f"{layout.n} ({args.collective_backend} backend){copies}",
          flush=True)
    grad_fn, apply_fn, ag_fn, rs_fn = build_fsdp_programs(
        cfg, ocfg, mesh, layout, axis=axis)

    def on_device(fn):
        if mesh.per_device:
            # each rank's slice goes from the host to its own device
            return fn
        return lambda flats, batch: fn(flats, to_device(batch))

    reducer, split, step_fn, remesh_fn = None, None, None, None
    if user_backend:
        reducer = FsdpReducer(mesh, axis, engine=eng, spec=spec,
                              bucket_bytes=args.fsdp_bucket_bytes,
                              epoch=epoch)
        split = FsdpStep(on_device(grad_fn), apply_fn, reducer, spec=spec)
    else:
        grad_step = on_device(grad_fn)

        def step_fn(shards, opt_state, batch):
            smets, flat_grads = grad_step(ag_fn(shards), batch)
            return apply_fn(shards, opt_state, rs_fn(flat_grads), smets)

    if epoch is not None:
        from repro_torch.distributed import elastic
        model_dim = shape[1]

        live = {"mesh": mesh}

        def remesh_fn(exc, shards_, opt_state_):
            nonlocal layout
            old = live["mesh"]
            # the survivors' mesh keeps the model dim where it divides; a
            # device per rank: on the first devices it takes
            if old.per_device:
                new_mesh = elastic.remesh(
                    exc.survivors, prefer_model=model_dim,
                    devices=old.devices[:exc.survivors])
            else:
                new_mesh = elastic.remesh(exc.survivors,
                                          prefer_model=model_dim,
                                          device=device)
            live["mesh"] = new_mesh
            print(f"remesh: {exc.survivors} survivor(s) -> mesh "
                  f"{dict(new_mesh.shape)}", flush=True)
            reducer.remesh(new_mesh, axis)
            layout, new_shards, new_state = fsdp_remesh(
                layout, shards_, opt_state_, old, new_mesh,
                args.fsdp_bucket_bytes, axis)
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


def stage_columns(meshes: list, *, engine, spec) -> _ColumnReducer:
    """The data-axis reduction of a (data x stage) pipeline mesh, a stage
    column at a time (``meshes``: each column's 1-D data mesh, of its
    ranks' devices in the per-device form).  It takes the rows' gradient
    trees (``[S, ...]`` leaves, or ``RankShards`` blocks on the row's
    devices) and gives the mean in the form ``_pipe_adamw`` takes:
    ``[S, ...]`` leaves, or ``RankShards`` copies (rank (d, s)'s block on
    its device, row-major).  Both forms reduce the same per-column
    payloads, so they give the same bits."""
    from repro_torch.collectives.rank_shards import RankShards
    per_device = meshes[0].per_device
    S, D = len(meshes), dict(meshes[0].shape)["data"]

    def split(row_grads):
        # stage s's gradients of the D rows: [D, ...] leaves, or the rows'
        # shards s on the column's devices
        return [{k: (RankShards(g[k].shards[s] for g in row_grads)
                     if per_device else torch.stack([g[k][s]
                                                     for g in row_grads]))
                 for k in row_grads[0]} for s in range(S)]

    def join(cols):
        if not per_device:
            return {k: torch.stack([c[k] for c in cols]) for k in cols[0]}
        return {k: RankShards((cols[s][k].shards[d].unsqueeze(0)
                               for d in range(D) for s in range(S)),
                              copies=D)
                for k in cols[0]}

    return _ColumnReducer(meshes, split, join, engine=engine, spec=spec)


def _pipe_adamw(ocfg, state, params, grads):
    """AdamW over the stages' leaves, in place: ``apply_shards`` on the
    leaves in key order (``[S, ...]`` stacks, or ``RankShards`` copies of
    the S blocks), the moments as leaf lists, so both forms take the
    grad norm as the same per-stage partials added in stage order."""
    from repro_torch.train import optimizer as opt_mod
    keys = sorted(params)
    _, st, om = opt_mod.apply_shards(
        ocfg, opt_mod.AdamWState(state.step, [state.mu[k] for k in keys],
                                 [state.nu[k] for k in keys]),
        [params[k] for k in keys], [grads[k] for k in keys])
    return params, opt_mod.AdamWState(st.step, state.mu, state.nu), om


def _run_pipeline(args, rank_devices=None, *, params=None,
                  **loop_overrides) -> TrainReport:
    """Pipeline-parallel rehearsal: a residual-MLP stage stack (d_model
    16, hidden 32) trained against a fixed linear teacher, on a (data x
    stage) mesh.

    * ``--pipeline gpipe``: the tick-loop reference — forward AND
      backward differentiate through it in one step (data dim must be
      1).
    * ``--pipeline 1f1b``: one event-driven :class:`PipelineSchedule`
      per data row (per-stage executor-owned streams, persistent p2p
      handoffs), composed with a data-axis reduction a stage column
      (``stage_columns``) — the split-step ``UserCollectiveStep`` path,
      as for plain data-parallel.

    AdamW steps every stage's block (``_pipe_adamw``: the grad norm from
    per-stage partials).  ``params`` (``[S, ...]`` ``w1``/``w2``) replace
    the seeded weights; tests hand in the JAX reference's.  With ``rank_devices`` (D·S of them, rank (d, s)
    on ``rank_devices[d*S + s]``, row-major as ``jax.sharding.Mesh``
    lays them out) row d's schedule (or gpipe's tick loop) runs on a mesh
    with a device per stage, rank (d, s) holds stage s's parameters,
    moments and step counter on its device, and each stage column's
    reduction copies between its ranks' devices; the checkpoint holds the
    ``[S, ...]`` leaves as the stacked run's, byte for byte, and the
    losses equal that run's bit for bit."""
    import numpy as np

    from repro_torch import resolve_device
    from repro_torch.collectives.nonblocking import CollectiveSpec
    from repro_torch.collectives.rank_shards import RankShards
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
    if rank_devices is not None and len(rank_devices) != D * S:
        raise SystemExit(f"--rank-devices names {len(rank_devices)} "
                         f"device(s) for the {D}x{S} mesh's {D * S} ranks")
    if rank_devices is not None:
        mesh = make_mesh((D, S), ("data", "stage"), devices=rank_devices)
        rows_of = [list(mesh.devices[r * S:(r + 1) * S]) for r in range(D)]
        stage_meshes = [make_mesh((S,), ("stage",), devices=row)
                        for row in rows_of]
        column_meshes = [make_mesh((D,), ("data",), devices=[
            row[s] for row in rows_of]) for s in range(S)]
    else:
        mesh = make_mesh((D, S), ("data", "stage"), device)
        stage_meshes = [make_mesh((S,), ("stage",), device)] * D
        column_meshes = [make_mesh((D,), ("data",), device)] * S
    M = max(args.microbatches, 1)
    d_model, mb = PIPE_D_MODEL, max(args.global_batch, 1)
    print(f"pipeline={args.pipeline} mesh={dict(mesh.shape)} "
          f"microbatches={M} "
          f"bubble={pl.bubble_fraction(S, M, args.pipeline):.3f} "
          f"peak_act={pl.peak_activation_microbatches(S, M, args.pipeline)}"
          + (f" devices={[str(d) for d in mesh.devices]}"
             if mesh.per_device else ""))

    if params is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = {
            "w1": torch.randn((S, d_model, PIPE_D_HIDDEN), generator=gen,
                              device=device) * 0.1,
            "w2": torch.randn((S, PIPE_D_HIDDEN, d_model), generator=gen,
                              device=device) * 0.1,
        }
    else:
        params = {k: torch.as_tensor(v).to(device, torch.float32, copy=True)
                  for k, v in params.items()}
    if mesh.per_device:
        # rank (d, s) holds stage s's block: the stages split over the
        # stage axis, copied over the data axis (JAX's P("stage"))
        params = {k: RankShards.from_stacked(v, mesh, copies=D)
                  for k, v in params.items()}
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

    def row_params(params, r):
        # row r's stage blocks: its S ranks' shards, or the stacked leaves
        if not mesh.per_device:
            return params
        return {k: RankShards(v.shards[r * S:(r + 1) * S])
                for k, v in params.items()}

    def apply_fn(params, opt_state, grads, stacked_mets):
        params, opt_state, om = _pipe_adamw(ocfg, opt_state, params, grads)
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
        gp = pl.gpipe(pipe_stage_fn, stage_meshes[0], "stage", S)
        last = stage_meshes[0].devices[-1] if mesh.per_device else device

        def leaves_of(p):
            return [t for k in sorted(p) for t in (
                p[k].shards if mesh.per_device else [p[k]])]

        def step_fn(p, o, batch):
            xs, ts = batch["xs"][0].to(device), batch["ts"][0].to(last)
            with torch.enable_grad():
                ps = {k: (RankShards(t.detach().requires_grad_(True)
                                     for t in v.shards)
                          if mesh.per_device
                          else v.detach().requires_grad_(True))
                      for k, v in p.items()}
                ys = gp(ps, xs)
                loss = torch.stack([pipe_loss_fn(ys[m], ts[m])
                                    for m in range(M)]).mean()
                g = torch.autograd.grad(loss, leaves_of(ps))
            if mesh.per_device:
                grads = {k: RankShards(g[i * S:(i + 1) * S])
                         for i, k in enumerate(sorted(ps))}
            else:
                grads = dict(zip(sorted(ps), g))
            p, o, om = _pipe_adamw(ocfg, o, p, grads)
            return p, o, dict(loss=loss.detach(), **om)
    else:
        first = mesh.devices[0] if mesh.per_device else device
        for r in range(D):
            rows.append(pl.PipelineSchedule(
                pipe_stage_fn, stage_meshes[r], "stage", S,
                loss_fn=pipe_loss_fn, engine=eng, executor=ex,
                name=f"pipe{r}"))

        def grad_fn(params, batch):
            # each row's schedule moves its microbatches to its stage 0's
            # device and its targets to its last stage's; launch every
            # row's DAG before waiting on any: the rows' stage streams
            # progress concurrently under the executor
            reqs = [rows[r].istep(row_params(params, r), batch["xs"][r],
                                  batch["ts"][r]) for r in range(D)]
            outs = [rows[r]._wait(reqs[r], timeout=600) for r in range(D)]
            losses = torch.stack([o[0].to(first) for o in outs])
            return {"loss": losses}, [o[1] for o in outs]

        reducer = stage_columns(column_meshes, engine=eng, spec=pspec)
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
