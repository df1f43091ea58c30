"""AdamW with a cosine schedule and global-norm clipping: the math of the
JAX package's ``train/optimizer.py``, leaf by leaf, in plain PyTorch.

Differences from the JAX package, by design:

* ``apply`` updates the parameters and the moments IN PLACE (no second
  copy of a 1.4 GB tree at smollm-360m) and returns the same dicts.  A
  caller that must keep the old values copies them first: the
  checkpointer does, on the same CUDA stream, before the next update.
* The moments are f32 whatever the parameters' dtype (the JAX moments
  become f32 after the first step; here they start so).
* A leaf above ``SLICE_ELEMS`` elements is updated a slice of its
  leading dim at a time: the update is elementwise, so the values are
  the same, and the step's temporaries stay a few slices big instead of
  a few copies of the leaf (granite-moe's 4 GB expert leaves).

``torch.optim.AdamW`` is not used: its schedule, clipping and decay
differ.  ``init_shards``/``apply_shards`` are the ZeRO step over FSDP
flat shard stacks, in place likewise (also over pipeline stages' blocks).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.collectives.rank_shards import RankShards, \
    device_context
from repro_torch.models.layers import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 scalar on the parameters' device
    mu: Any
    nu: Any


def init(params) -> AdamWState:
    """Fresh state for ``params``.  Over ``RankShards`` leaves (replicas,
    blocks or copies of blocks, a device per rank) the moments are leaves
    of the same kind on the same devices and the step counter a replica
    on every rank: on the devices of the leaf with the most shards (a
    model axis's F-slices, on every rank, beside replicas on the data
    rows' leaders)."""
    first = next(t for _, t in tree_leaves(params))
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    if isinstance(first, RankShards):
        moments = lambda: tree_map(lambda p: p.map(zeros),      # noqa: E731
                                   params)
        widest = max((t for _, t in tree_leaves(params)),
                     key=lambda t: len(t.shards))
        return AdamWState(
            step=RankShards((torch.zeros((), dtype=torch.int32, device=d)
                             for d in widest.devices), replica=True),
            mu=moments(), nu=moments())
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        mu=tree_map(zeros, params),
        nu=tree_map(zeros, params),
    )


def init_shards(shards) -> AdamWState:
    """Optimizer state over FSDP flat shard stacks ``[n, W/n]``: mu/nu are
    lists shaped like the stacks, f32 (ZeRO — each rank holds moments
    only for the block it owns, row r).  Over ``RankShards`` blocks (a
    device per rank), or copies of them (a model axis beside the data
    axis), each rank's moments are blocks on its device, laid out as the
    shards, and its step counter a replica there."""
    zeros = lambda s: torch.zeros_like(s, dtype=torch.float32)  # noqa: E731
    if isinstance(shards[0], RankShards):
        return AdamWState(
            step=RankShards((torch.zeros((), dtype=torch.int32, device=d)
                             for d in shards[0].devices), replica=True),
            mu=[s.map(zeros) for s in shards],
            nu=[s.map(zeros) for s in shards],
        )
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=shards[0].device),
        mu=[zeros(s) for s in shards],
        nu=[zeros(s) for s in shards],
    )


def schedule(cfg: AdamWConfig, step):
    """Linear warmup, then cosine decay to ``min_lr_ratio``; f32 tensor."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _sq(x) -> torch.Tensor:
    return torch.sum(torch.square(x.float()))


def global_norm(tree, splits: dict | None = None):
    """The f32 norm of a tree: each leaf's sum of squares, added in leaf
    order.  ``splits`` (path -> (dim, n)) names leaves a model axis of n
    ranks holds as slices of ``dim`` (the MoE block's F-slices): such a
    leaf's sum is its n slices' sums added in rank order, as the JAX
    package psums the devices' local sums and as ``apply`` adds them when
    the slices live on the ranks' cards, so both forms give the same
    bits."""
    splits = splits or {}

    def part(path, x):
        if path not in splits:
            return _sq(x)
        dim, n = splits[path]
        w = x.shape[dim] // n
        return sum(_sq(x.narrow(dim, r * w, w)) for r in range(n))

    return torch.sqrt(sum(part(path, x) for path, x in tree_leaves(tree)))


def _sum_squares(rows, grad_scale: float) -> torch.Tensor:
    """One rank's sum of squares over its blocks (one row per bucket):
    each block reduced whole, the buckets added in order.  A block is
    reduced by itself in both mesh forms, so the rank's partial is the
    same bits whether its block is a row of a stack or a card's own."""
    return sum(torch.sum(torch.square(g.float() * grad_scale))
               for g in rows)


def _adamw_blocks(cfg: AdamWConfig, step, scale, shards, grad_shards, mu, nu,
                  grad_scale: float):
    """The elementwise AdamW update of one set of blocks, in place; the
    new step counter and the schedule's lr."""
    step, lr, b1c, b2c = _step_scalars(cfg, step)
    for p, g, m, v in zip(shards, grad_shards, mu, nu):
        _adamw_leaf(cfg, p, g, m, v, scale, lr, b1c, b2c, grad_scale)
    return step, lr


@torch.no_grad()
def apply_shards(cfg: AdamWConfig, state: AdamWState, shards, grad_shards,
                 *, grad_scale: float = 1.0):
    """One AdamW step over flat shard stacks (the ZeRO step: each rank
    updates only the parameter block it owns), IN PLACE on ``shards`` and
    the moments.

    ``shards``/``grad_shards`` are lists of rank-stacked ``[n, W/n]``
    tensors, rank r's block in row r, or (a device per rank) lists of
    ``RankShards`` blocks with the moments likewise and the step counter
    a replica.  Pipeline stages' leaves fit both forms: ``[S, ...]``
    stacks, or ``RankShards`` copies of the S blocks on a (data x stage)
    mesh, whose norm takes the first copy's blocks and whose every copy
    steps on its device; so do FSDP's blocks on a (data x model) mesh,
    copied over the model axis (each data rank's partial added once).  AdamW is elementwise, so flat math equals
    per-leaf math given the same clip scale and schedule; the one
    cross-rank quantity, the global grad norm, is each rank's sum of
    squares over its blocks (the JAX package's local sum) then the sum of
    the n partials in rank order (its ``psum``).  In the per-device form the partials meet on
    rank 0's card, are added there as the stacked form adds them, and
    the clip scale goes back to every card as a copy between cards: no
    value is read to the host.  ``grad_scale`` folds the data-parallel
    mean into the step (reduce-scatter delivers sums).  Zero-padded
    bucket tails stay zero: grad 0 keeps mu/nu 0 and weight decay
    multiplies a zero param.

    Returns ``(shards, new_state, metrics)``."""
    if isinstance(shards[0], RankShards):
        return _apply_shards_per_device(cfg, state, shards, grad_shards,
                                        grad_scale)
    n = grad_shards[0].shape[0]
    sq = torch.stack([_sum_squares([g[r] for g in grad_shards], grad_scale)
                      for r in range(n)])
    gnorm = torch.sqrt(sq.sum())
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step, lr = _adamw_blocks(cfg, state.step, scale, shards, grad_shards,
                             state.mu, state.nu, grad_scale)
    return shards, AdamWState(step, state.mu, state.nu), \
        {"grad_norm": gnorm, "lr": lr}


def _apply_shards_per_device(cfg, state, shards, grad_shards, grad_scale):
    devices = shards[0].devices
    first = devices[0]
    partials = []
    for r in range(len(grad_shards[0].blocks)):
        with device_context(devices[r]):
            partials.append(_sum_squares([g[r][0] for g in grad_shards],
                                         grad_scale).to(first))
    with device_context(first):
        gnorm = torch.sqrt(torch.stack(partials).sum())
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    steps, lrs = [], []
    for r, d in enumerate(devices):
        with device_context(d):
            step, lr = _adamw_blocks(
                cfg, state.step[r], scale.to(d),
                [p[r] for p in shards], [g[r] for g in grad_shards],
                [m[r] for m in state.mu], [v[r] for v in state.nu],
                grad_scale)
        steps.append(step)
        lrs.append(lr)
    return shards, AdamWState(RankShards(steps, replica=True), state.mu,
                              state.nu), {"grad_norm": gnorm, "lr": lrs[0]}


def _step_scalars(cfg: AdamWConfig, step):
    """The step after ``step``, its lr and the moments' bias corrections."""
    step = step + 1
    stepf = step.float()
    return (step, schedule(cfg, step), 1 - torch.pow(cfg.b1, stepf),
            1 - torch.pow(cfg.b2, stepf))


def _adamw_leaf(cfg: AdamWConfig, p_leaf, g_leaf, m_leaf, v_leaf, scale, lr,
                b1c, b2c, grad_scale: float = 1.0) -> None:
    """The elementwise AdamW update of one leaf, in place, a slice of its
    leading dim at a time (``_slices``); the gradient times
    ``grad_scale`` (where it is not 1), then times the clip ``scale``."""
    for p, g, m, v in zip(*map(_slices, (p_leaf, g_leaf, m_leaf, v_leaf))):
        g = g.float()
        if grad_scale != 1.0:
            g = g * grad_scale
        g = g * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        mhat = m / b1c
        vhat = v / b2c
        pf = p.float()
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))


@torch.no_grad()
def apply(cfg: AdamWConfig, state: AdamWState, params, grads, *,
          splits: dict | None = None):
    """One AdamW step, IN PLACE on ``params`` and the moments.  Returns
    (params, new_state, metrics) with metrics {"grad_norm", "lr"} as f32
    tensors on the device (read them after the step's work is done).
    ``splits`` as ``global_norm``'s.  Over ``RankShards`` leaves placed
    on a mesh's ranks, ``_apply_placed``."""
    if isinstance(next(t for _, t in tree_leaves(params)), RankShards):
        return _apply_placed(cfg, state, params, grads)
    gnorm = global_norm(grads, splits)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step, lr, b1c, b2c = _step_scalars(cfg, state.step)
    g_leaves = dict(tree_leaves(grads))
    m_leaves = dict(tree_leaves(state.mu))
    v_leaves = dict(tree_leaves(state.nu))
    for path, p_leaf in tree_leaves(params):
        _adamw_leaf(cfg, p_leaf, g_leaves[path], m_leaves[path],
                    v_leaves[path], scale, lr, b1c, b2c)
    return params, AdamWState(step, state.mu, state.nu), \
        {"grad_norm": gnorm, "lr": lr}


def _apply_placed(cfg, state, params, grads):
    """``apply`` over ``RankShards`` leaves of a mesh's R ranks (the model
    axis with a device per rank): a replica on every ``R / len(shards)``-th
    rank (the data rows' leaders) or blocks on every rank (the F-slices,
    copied over the rows), the moments likewise and the step counter a
    replica on every rank.  The grad norm is ``global_norm``'s with the
    sliced leaves split: each leaf's sum of squares on its card (a
    replica's once, on its first rank's), a block leaf's the first copy's
    blocks' sums in rank order, all added in leaf order on rank 0's card;
    the clip scale goes back to every card as a copy between cards, with
    no read to the host.  Each leaf then steps on its cards with its
    rank's counter."""
    steps = state.step
    devices, R = steps.devices, len(steps.shards)
    first = devices[0]
    parts = []
    for _, g in tree_leaves(grads):
        sums = []
        for b in ([g.shards[0]] if g.replica else g.blocks):
            with device_context(b.device):
                sums.append(_sq(b).to(first))
        parts.append(sums[0] if g.replica else sum(sums))
    with device_context(first):
        gnorm = torch.sqrt(sum(parts))
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    ranks = []
    for r, d in enumerate(devices):
        with device_context(d):
            ranks.append((scale.to(d), *_step_scalars(cfg, steps.shards[r])))
    g_leaves = dict(tree_leaves(grads))
    m_leaves = dict(tree_leaves(state.mu))
    v_leaves = dict(tree_leaves(state.nu))
    for path, p_leaf in tree_leaves(params):
        stride = R // len(p_leaf.shards)
        for i, p in enumerate(p_leaf.shards):
            scale_r, _, lr, b1c, b2c = ranks[i * stride]
            with device_context(p.device):
                _adamw_leaf(cfg, p, g_leaves[path].shards[i],
                            m_leaves[path].shards[i],
                            v_leaves[path].shards[i], scale_r, lr, b1c, b2c)
    return params, AdamWState(RankShards((r[1] for r in ranks), replica=True),
                              state.mu, state.nu), \
        {"grad_norm": gnorm, "lr": ranks[0][2]}


SLICE_ELEMS = 1 << 26       # 256 MB of f32: larger leaves go by slices


def _slices(t):
    """``t`` as views of at most ``SLICE_ELEMS`` elements along its
    leading dim (``t`` itself when it is that small or has no dim)."""
    if t.numel() <= SLICE_ELEMS or t.dim() == 0:
        return [t]
    rows = max(1, SLICE_ELEMS // max(1, t[0].numel()))
    return list(t.split(rows))
