"""Ring attention: context parallelism as an explicit ring schedule on
the rank dim (the port of the JAX package's
``collectives/ring_attention.py``).

When a config's head count does not divide the model axis (smollm-360m:
15 heads, qwen2-0.5b: 14), splitting heads degenerates to replicated
attention.  Ring attention splits the *sequence* instead: rank r holds
query, key and value block r of S/n positions; the key/value blocks
circulate around the ring, one hop a step, while every rank accumulates
the online-softmax partials of its own query block.  The math is that of
full attention, for any head count.

The JAX package runs the body inside ``shard_map`` with
``jax.lax.ppermute`` hops.  The port keeps every rank of the axis on one
device, rank-stacked on a leading dim (``collectives/schedules.py``): a
block tensor is ``[n, B, S/n, ...]``, rank r's block in row r, and a hop
of the ring is ``S.ring_shift`` on that dim.  Each rank's sums come in
the JAX order (own block first, then the blocks of ranks r-1, r-2, ...).
Under a causal mask a rank skips the blocks that lie wholly in its
queries' future, which JAX computes and discards (``_first_live``).

* ``_ring_body`` is the forward, differentiated by autograd (the JAX
  package's AD path, taken with a logit cap);
* ``_RingAttention`` is the ``jax.custom_vjp`` twin
  (``make_ring_attention_vjp``): it saves only ``(q, k, v, o, m, l)`` and
  its backward runs ONE ring in which the ``dk``/``dv`` accumulators ride
  along with the circulating key/value blocks and are home after n hops.
  Its backward reads no mesh: the ring size is the rank dim of what it
  saved (autograd may run the backward on a thread of its own);
* ``ring_attention`` is the entry point: q/k/v ``[B, S, H, hd]`` under a
  ``sharding.set_mesh`` whose ``model`` axis has n > 1 ranks, S a
  multiple of n; anything else falls back to ``ops.flash_attention``, as
  the JAX function falls back to plain attention.

On a mesh with a device per rank (``launch.mesh``; a data row's ``(1,
n)`` mesh, which the train launcher enters around the row's pass) the
ring runs on the ranks' cards, as JAX's ``ppermute`` hops go between
devices.  The replicated layers run once, on the row's leader (rank 0):
its q/k/v ``[B, S, ...]`` are split into the n sequence blocks and block
r is copied to rank r's card; each ring step runs on every live rank's
card (``device_context``) with the stacked ring's arithmetic
(``_fwd_step``/``_bwd_step`` on a ``[1, ...]`` block where the stacked
ring takes rows ``lo:``), rank r computing nothing before step r under a
causal mask; a hop copies each key/value block to the next rank's card
(``rank_shards.send``: PyTorch fences a copy between cards on both
cards' current streams, with no host sync); the output blocks come back
to the leader in rank order.  ``_RingAttentionPerDevice`` saves each
rank's ``(q, k, v, o, m, l)`` on its card, and its backward ring carries
the dk/dv accumulators with the blocks and brings dq/dk/dv home to the
leader; with a logit cap autograd differentiates the copies.  A rank's
sums are the stacked ring's, so both forms give the same bits.  Data
moved a call, for n ranks and q/k/v blocks of ``b_q``/``b_kv`` bytes:
forward ``(n-1)(b_q + 2 b_kv)`` to the ranks, ``2n(n-1)`` key/value
hops of ``b_kv``, ``(n-1) b_q`` back; backward ``(n-1) b_q`` of ``do``,
``2n(n-1)`` key/value hops, ``2n^2`` hops of the f32 dk/dv
accumulators, ``(n-1)(b_q + 2 b_kv)`` of gradients back.  A per-device
mesh never runs the stacked ring.

Scores and ``p·v`` are f32 products of operands in the inputs' dtype
(``preferred_element_type=jnp.float32``): on the card bf16 operands go
through ``torch.bmm(..., out_dtype=torch.float32)``; under autograd (the
capped body) and on the CPU, which lack that overload, they are widened
to f32 first (products of bf16 values are exact in f32).  These are tensor ops, not kernels: the JAX package
computes them as einsums outside any Pallas kernel.
"""
from __future__ import annotations

import math

import torch

from repro_torch import sharding
from repro_torch.collectives import schedules as S
from repro_torch.collectives.rank_shards import device_context, send
from repro_torch.kernels import ops

NEG_INF = -1e30


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over the leading batch dims with an f32 result: f32
    operands as they are; bf16 operands on the card through ``bmm``'s
    f32 ``out_dtype`` (outside autograd, which has no rule for it),
    widened to f32 otherwise."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.device.type == "cuda" and not torch.is_grad_enabled():
        lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
        a3 = a.expand(lead + a.shape[-2:]).reshape((-1,) + a.shape[-2:])
        b3 = b.expand(lead + b.shape[-2:]).reshape((-1,) + b.shape[-2:])
        out = torch.bmm(a3, b3, out_dtype=torch.float32)
        return out.view(lead + out.shape[-2:])
    return torch.matmul(a.float(), b.float())


def _heads_major(t: torch.Tensor) -> torch.Tensor:
    """``[n, B, S, H, hd]`` -> ``[n, B, H, S, hd]`` (contiguous)."""
    return t.permute(0, 1, 3, 2, 4).contiguous()


def _first_live(step: int, causal: bool) -> int:
    """The first rank whose key block at ``step`` is not wholly in its
    queries' future.  At ``step`` rank r holds the block of rank
    (r - step) % n, which for r < step comes after rank r's queries:
    under a causal mask each of its scores is NEG_INF, so it adds p = 0
    with corr = 1, and nothing to any gradient.  JAX computes and
    discards those blocks (each device runs the same program); here the
    ranks are rows of one tensor, so the ring computes ranks
    ``step..n-1`` only, to the same result."""
    return step if causal else 0


def _diagonal_masked(s):
    """Scores ``[..., S_loc, S_loc]`` of each rank's own key block (step
    0) with each query's future set to NEG_INF; every later block a
    rank computes lies wholly in its queries' past."""
    s_loc = s.shape[-1]
    mask = torch.ones((s_loc, s_loc), dtype=torch.bool,
                      device=s.device).tril()
    return torch.where(mask, s, NEG_INF)


def _joined(old, new, lo: int):
    """Ranks ``:lo`` of ``old`` (unchanged this step) before ``new``."""
    return torch.cat([old[:lo], new]) if lo else new


def _fwd_init(q):
    """A set of ranks' query blocks ``[k, B, S_loc, H, hd]`` scaled and
    heads-major, and their zero statistics m, l ``[k, B, H, S_loc]`` and
    accumulator ``[k, B, H, S_loc, hd]`` (f32)."""
    k, B, s_loc, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    qf = _heads_major((q.float() * scale).to(q.dtype))
    m = torch.full((k, B, H, s_loc), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((k, B, H, s_loc), dtype=torch.float32, device=q.device)
    acc = torch.zeros((k, B, H, s_loc, hd), dtype=torch.float32,
                      device=q.device)
    return qf, m, l, acc


def _fwd_step(qf, k_blk, v_blk, m, l, acc, *, diagonal: bool,
              logit_cap: float):
    """One ring step of a set of ranks (rows of the stacked blocks, or
    one rank's ``[1, ...]``): their queries against the key/value blocks
    they hold (``diagonal``: each rank's own, its queries' future masked);
    the new (m, l, acc).  Both mesh forms run this on the same values, so
    a rank's sums are the same bits in either."""
    G = qf.shape[2] // k_blk.shape[3]
    k_r = _heads_major(k_blk).repeat_interleave(G, dim=2)
    v_r = _heads_major(v_blk).repeat_interleave(G, dim=2)
    s = _bmm_f32(qf, k_r.transpose(-1, -2))                 # [.,B,H,Sq,Sk]
    if logit_cap:
        s = torch.tanh(s / logit_cap) * logit_cap
    if diagonal:
        s = _diagonal_masked(s)
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    m_safe = torch.clamp(m_new, min=NEG_INF / 2)
    p = torch.exp(s - m_safe[..., None])
    corr = torch.exp(torch.clamp(m - m_new, max=0.0))
    l = l * corr + torch.sum(p, dim=-1)
    pv = _bmm_f32(p.to(v_r.dtype), v_r)                     # [.,B,H,Sq,hd]
    return m_new, l, acc * corr[..., None] + pv


def _fwd_out(acc, l, dtype):
    """The output blocks ``[k, B, S_loc, H, hd]`` in ``dtype``."""
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(dtype)
    return out.permute(0, 1, 3, 2, 4)


def _ring_fwd_stats(q, k, v, causal: bool, logit_cap: float = 0.0):
    """The forward ring on rank-stacked blocks q ``[n, B, S_loc, H, hd]``,
    k/v ``[n, B, S_loc, KVH, hd]``: the output in q's dtype and the
    softmax statistics m, l ``[n, B, H, S_loc]`` f32."""
    n = q.shape[0]
    qf, m, l, acc = _fwd_init(q)
    k_cur, v_cur = k, v
    for step in range(n):
        lo = _first_live(step, causal)
        m_new, l_new, acc_new = _fwd_step(
            qf[lo:], k_cur[lo:], v_cur[lo:], m[lo:], l[lo:], acc[lo:],
            diagonal=causal and step == 0, logit_cap=logit_cap)
        m, l, acc = (_joined(m, m_new, lo), _joined(l, l_new, lo),
                     _joined(acc, acc_new, lo))
        if step != n - 1:
            k_cur = S.ring_shift(k_cur, 1)
            v_cur = S.ring_shift(v_cur, 1)
    return _fwd_out(acc, l, q.dtype), m, l


def _ring_body(q, k, v, *, causal: bool, logit_cap: float = 0.0):
    """The forward ring (rank-stacked blocks in, ``[n, B, S_loc, H, hd]``
    out), differentiated by autograd through every hop: the JAX package's
    path with a logit cap, whose tanh changes the backward algebra."""
    return _ring_fwd_stats(q, k, v, causal, logit_cap)[0]


def _bwd_init(q, o, do, m, l):
    """A set of ranks' backward inputs: the scaled heads-major queries and
    output gradient, ``D = rowsum(do * o)``, the safe statistics, and a
    zero dq accumulator (all f32)."""
    hd = q.shape[-1]
    qf = _heads_major(q.float() * (1.0 / math.sqrt(hd)))
    dof = _heads_major(do.float())
    drow = torch.sum(dof * _heads_major(o.float()), dim=-1)  # [k,B,H,Sq]
    return (qf, dof, drow, torch.clamp(m, min=NEG_INF / 2),
            torch.clamp(l, min=1e-30), torch.zeros_like(qf))


def _bwd_step(qf, dof, drow, m_safe, l_safe, k_blk, v_blk, *,
              diagonal: bool):
    """One backward ring step of a set of ranks: (dq, dk, dv) of their
    queries against the key/value blocks they hold, dk/dv folded onto the
    KV heads (GQA)."""
    KVH = k_blk.shape[3]
    G = qf.shape[2] // KVH
    scale = 1.0 / math.sqrt(qf.shape[-1])
    k_r = _heads_major(k_blk).float().repeat_interleave(G, dim=2)
    v_r = _heads_major(v_blk).float().repeat_interleave(G, dim=2)
    s = torch.matmul(qf, k_r.transpose(-1, -2))              # [.,B,H,Sq,Sk]
    if diagonal:
        s = _diagonal_masked(s)
    p = torch.exp(s - m_safe[..., None]) / l_safe[..., None]
    dv_blk = torch.matmul(p.transpose(-1, -2), dof)          # full heads
    dp = torch.matmul(dof, v_r.transpose(-1, -2))
    ds = p * (dp - drow[..., None])
    dq = torch.matmul(ds, k_r) * scale
    dk_blk = torch.matmul(ds.transpose(-1, -2), qf)          # scale in qf
    # fold GQA: the full heads' gradients summed into kv heads
    return (dq, dk_blk.unflatten(2, (KVH, G)).sum(dim=3),
            dv_blk.unflatten(2, (KVH, G)).sum(dim=3))


def _back(t, dtype):
    """Heads-major ``[k, B, H, S_loc, hd]`` -> ``[k, B, S_loc, H, hd]``."""
    return t.permute(0, 1, 3, 2, 4).to(dtype)


class _RingAttention(torch.autograd.Function):
    """``make_ring_attention_vjp``'s ``custom_vjp`` (cap 0): the forward
    ring saving ``(q, k, v, o, m, l)``, and one backward ring."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, m, l = _ring_fwd_stats(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, l = ctx.saved_tensors
        n = q.shape[0]
        qf, dof, drow, m_safe, l_safe, dq = _bwd_init(q, o, do, m, l)
        dk_ring = torch.zeros(k.shape[:2] + (k.shape[3], k.shape[2],
                                             k.shape[4]),
                              dtype=torch.float32, device=q.device)
        dv_ring = torch.zeros_like(dk_ring)
        k_cur, v_cur = k, v
        for step in range(n):
            lo = _first_live(step, ctx.causal)
            dq_s, dk_s, dv_s = _bwd_step(
                qf[lo:], dof[lo:], drow[lo:], m_safe[lo:], l_safe[lo:],
                k_cur[lo:], v_cur[lo:],
                diagonal=ctx.causal and step == 0)
            dq[lo:] += dq_s
            dk_ring[lo:] += dk_s
            dv_ring[lo:] += dv_s
            # the key/value blocks and their gradients move together;
            # after n hops each gradient block is home
            if step != n - 1:
                k_cur = S.ring_shift(k_cur, 1)
                v_cur = S.ring_shift(v_cur, 1)
            dk_ring = S.ring_shift(dk_ring, 1)
            dv_ring = S.ring_shift(dv_ring, 1)
        return (_back(dq, q.dtype), _back(dk_ring, k.dtype),
                _back(dv_ring, v.dtype), None)


# ---------------------------------------------------------------------------
# the ring with a device per rank
# ---------------------------------------------------------------------------

def _hop(blocks: list, devices) -> list:
    """One hop of the ring over the ranks' devices, in ``S.ring_shift(x,
    1)``'s direction: rank i receives rank i-1's block, a copy between
    their cards."""
    n = len(blocks)
    return [send(blocks[(i - 1) % n], devices[i], hop=True)
            for i in range(n)]


def _to_ranks(t, devices) -> list:
    """The leader's ``[B, S, ...]`` as each rank's ``[1, B, S/n, ...]``
    sequence block on its device (block r on rank r's; block 0 stays)."""
    n = len(devices)
    s_loc = t.shape[1] // n
    blocks = [t[:, r * s_loc:(r + 1) * s_loc].unsqueeze(0) for r in range(n)]
    return blocks[:1] + [send(b, dev)
                         for b, dev in zip(blocks[1:], devices[1:])]


def _to_leader(blocks: list, leader):
    """The ranks' ``[1, B, S/n, ...]`` blocks back on the leader (rank
    0), glued in rank order: ``[B, S, ...]``."""
    return torch.cat(blocks[:1] + [send(b, leader) for b in blocks[1:]],
                     dim=2)[0]


def _ring_fwd_per_device(qs, ks, vs, devices, causal: bool,
                         logit_cap: float = 0.0):
    """The forward ring over per-rank blocks (rank r's ``[1, B, S_loc,
    ...]`` on ``devices[r]``): every rank's step on its own card with the
    stacked ring's arithmetic (``_fwd_step``), rank r computing nothing
    before step r under a causal mask, the key/value blocks hopping
    between the cards.  Each rank's (output, m, l) on its card."""
    n = len(devices)
    state = []
    for q, dev in zip(qs, devices):
        with device_context(dev):
            state.append(list(_fwd_init(q)))
    k_cur, v_cur = list(ks), list(vs)
    for step in range(n):
        for r in range(_first_live(step, causal), n):
            qf, m, l, acc = state[r]
            with device_context(devices[r]):
                state[r][1:] = _fwd_step(
                    qf, k_cur[r], v_cur[r], m, l, acc,
                    diagonal=causal and step == 0, logit_cap=logit_cap)
        if step != n - 1:
            k_cur = _hop(k_cur, devices)
            v_cur = _hop(v_cur, devices)
    outs = []
    for (qf, m, l, acc), q, dev in zip(state, qs, devices):
        with device_context(dev):
            outs.append((_fwd_out(acc, l, q.dtype), m, l))
    return outs


class _RingAttentionPerDevice(torch.autograd.Function):
    """``_RingAttention`` with rank r's blocks on ``devices[r]``: the
    leader's q/k/v ``[B, S, H, hd]`` in, each rank's block copied to its
    card, the output blocks back on the leader in rank order.  It saves
    each rank's ``(q, k, v, o, m, l)`` on its card; the backward copies
    ``do``'s blocks there and runs one ring whose dk/dv accumulators ride
    with the key/value blocks, then brings dq/dk/dv home to the leader.
    The devices are captured at forward time: the backward reads no mesh
    (autograd runs it on the leader's device thread)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, devices):
        qs, ks, vs = (_to_ranks(t, devices) for t in (q, k, v))
        outs = _ring_fwd_per_device(qs, ks, vs, devices, causal)
        ctx.save_for_backward(*qs, *ks, *vs, *(t for o in outs for t in o))
        ctx.causal, ctx.devices = causal, devices
        return _to_leader([o for o, _, _ in outs], q.device)

    @staticmethod
    def backward(ctx, do):
        devices, n = ctx.devices, len(ctx.devices)
        saved = ctx.saved_tensors
        qs, ks, vs = saved[:n], saved[n:2 * n], saved[2 * n:3 * n]
        oml = saved[3 * n:]
        dos = _to_ranks(do, devices)
        state = []
        for r, dev in enumerate(devices):
            with device_context(dev):
                ins = _bwd_init(qs[r], oml[3 * r], dos[r], oml[3 * r + 1],
                                oml[3 * r + 2])
                k = ks[r]
                dk = torch.zeros(k.shape[:2] + (k.shape[3], k.shape[2],
                                                k.shape[4]),
                                 dtype=torch.float32, device=k.device)
                state.append((ins, dk, torch.zeros_like(dk)))
        k_cur, v_cur = list(ks), list(vs)
        dk_ring = [s[1] for s in state]
        dv_ring = [s[2] for s in state]
        for step in range(n):
            for r in range(_first_live(step, ctx.causal), n):
                qf, dof, drow, m_safe, l_safe, dq = state[r][0]
                with device_context(devices[r]):
                    dq_s, dk_s, dv_s = _bwd_step(
                        qf, dof, drow, m_safe, l_safe, k_cur[r], v_cur[r],
                        diagonal=ctx.causal and step == 0)
                    dq += dq_s
                    dk_ring[r] += dk_s
                    dv_ring[r] += dv_s
            # the accumulators ride with the blocks: home after n hops
            if step != n - 1:
                k_cur = _hop(k_cur, devices)
                v_cur = _hop(v_cur, devices)
            dk_ring = _hop(dk_ring, devices)
            dv_ring = _hop(dv_ring, devices)
        leader = do.device
        grads = []
        for blocks, like in (([s[0][5] for s in state], qs), (dk_ring, ks),
                             (dv_ring, vs)):
            parts = []
            for t, ref, dev in zip(blocks, like, devices):
                with device_context(dev):
                    parts.append(_back(t, ref.dtype))
            grads.append(_to_leader(parts, leader))
        return (*grads, None, None)


def _axis_devices(mesh, axis: str) -> tuple:
    """The devices of ``axis``'s ranks on a per-device mesh whose other
    axes have one rank (a data row's mesh)."""
    if any(size != 1 for name, size in mesh.shape.items() if name != axis):
        raise ValueError(f"the ring with a device per rank runs on one data "
                         f"row's mesh (every axis but {axis!r} of size 1), "
                         f"got {mesh!r}")
    return mesh.devices


def _ring_per_device(q, k, v, devices, causal: bool, logit_cap: float):
    """The ring over ``devices`` (rank 0's, the leader's, holds q/k/v and
    gets the output); autograd through every hop with a logit cap."""
    if q.device != torch.device(devices[0]):
        raise ValueError(f"q is on {q.device}, the ring's leader (rank 0) "
                         f"on {devices[0]}")
    if not logit_cap:
        return _RingAttentionPerDevice.apply(q, k, v, causal, tuple(devices))
    qs, ks, vs = (_to_ranks(t, devices) for t in (q, k, v))
    outs = _ring_fwd_per_device(qs, ks, vs, devices, causal, logit_cap)
    return _to_leader([o for o, _, _ in outs], q.device)


def ring_attention(q, k, v, *, causal: bool = True, axis: str = "model",
                   logit_cap: float = 0.0):
    """q ``[B, S, H, hd]``, k/v ``[B, S, KVH, hd]`` -> ``[B, S, H, hd]``
    in q's dtype, the sequence split over ``axis`` of the current mesh
    (``sharding.set_mesh``): rank r holds block r of S/n positions, as
    the JAX ``P(batch, "model")`` places it.  The batch is not split: a
    data axis runs the same ring on each slice of the batch.  Without a
    mesh, on a 1-rank axis, or when the axis does not divide S, plain
    attention (``ops.flash_attention``)."""
    Sq = q.shape[1]
    mesh = sharding.current_mesh()
    n = 1 if mesh is None else dict(mesh.shape).get(axis, 1)
    if n == 1 or Sq % n or k.shape[1] != Sq:
        return ops.flash_attention(q, k, v, causal=causal,
                                   logit_cap=logit_cap)

    def stack(t):                       # [B, S, ...] -> [n, B, S/n, ...]
        return t.unflatten(1, (n, Sq // n)).transpose(0, 1)

    if mesh.per_device:
        return _ring_per_device(q, k, v, _axis_devices(mesh, axis), causal,
                                logit_cap)
    if logit_cap:
        out = _ring_body(stack(q), stack(k), stack(v), causal=causal,
                         logit_cap=logit_cap)
    else:
        out = _RingAttention.apply(stack(q), stack(k), stack(v), causal)
    return out.transpose(0, 1).flatten(1, 2)
