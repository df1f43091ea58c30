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


def _ring_fwd_stats(q, k, v, causal: bool, logit_cap: float = 0.0):
    """The forward ring on rank-stacked blocks q ``[n, B, S_loc, H, hd]``,
    k/v ``[n, B, S_loc, KVH, hd]``: the output in q's dtype and the
    softmax statistics m, l ``[n, B, H, S_loc]`` f32."""
    n, B, s_loc, H, hd = q.shape
    G = H // k.shape[3]
    scale = 1.0 / math.sqrt(hd)
    qf = _heads_major((q.float() * scale).to(q.dtype))
    m = torch.full((n, B, H, s_loc), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((n, B, H, s_loc), dtype=torch.float32, device=q.device)
    acc = torch.zeros((n, B, H, s_loc, hd), dtype=torch.float32,
                      device=q.device)
    k_cur, v_cur = k, v
    for step in range(n):
        lo = _first_live(step, causal)
        k_r = _heads_major(k_cur[lo:]).repeat_interleave(G, dim=2)
        v_r = _heads_major(v_cur[lo:]).repeat_interleave(G, dim=2)
        s = _bmm_f32(qf[lo:], k_r.transpose(-1, -2))          # [.,B,H,Sq,Sk]
        if logit_cap:
            s = torch.tanh(s / logit_cap) * logit_cap
        if causal and step == 0:
            s = _diagonal_masked(s)
        m_new = torch.maximum(m[lo:], torch.amax(s, dim=-1))
        m_safe = torch.clamp(m_new, min=NEG_INF / 2)
        p = torch.exp(s - m_safe[..., None])
        corr = torch.exp(torch.clamp(m[lo:] - m_new, max=0.0))
        l = _joined(l, l[lo:] * corr + torch.sum(p, dim=-1), lo)
        pv = _bmm_f32(p.to(v_r.dtype), v_r)                  # [.,B,H,Sq,hd]
        acc = _joined(acc, acc[lo:] * corr[..., None] + pv, lo)
        m = _joined(m, m_new, lo)
        if step != n - 1:
            k_cur = S.ring_shift(k_cur, 1)
            v_cur = S.ring_shift(v_cur, 1)
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    return out.permute(0, 1, 3, 2, 4), m, l


def _ring_body(q, k, v, *, causal: bool, logit_cap: float = 0.0):
    """The forward ring (rank-stacked blocks in, ``[n, B, S_loc, H, hd]``
    out), differentiated by autograd through every hop: the JAX package's
    path with a logit cap, whose tanh changes the backward algebra."""
    return _ring_fwd_stats(q, k, v, causal, logit_cap)[0]


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
        n, B, s_loc, H, hd = q.shape
        KVH = k.shape[3]
        G = H // KVH
        scale = 1.0 / math.sqrt(hd)
        qf = _heads_major(q.float() * scale)
        dof = _heads_major(do.float())
        # D = rowsum(do * o)  [n, B, H, Sq]
        drow = torch.sum(dof * _heads_major(o.float()), dim=-1)
        l_safe = torch.clamp(l, min=1e-30)
        m_safe = torch.clamp(m, min=NEG_INF / 2)
        dq = torch.zeros((n, B, H, s_loc, hd), dtype=torch.float32,
                         device=q.device)
        dk_ring = torch.zeros((n, B, KVH, s_loc, hd), dtype=torch.float32,
                              device=q.device)
        dv_ring = torch.zeros_like(dk_ring)
        k_cur, v_cur = k, v
        for step in range(n):
            lo = _first_live(step, ctx.causal)
            k_r = _heads_major(k_cur[lo:]).float().repeat_interleave(G, dim=2)
            v_r = _heads_major(v_cur[lo:]).float().repeat_interleave(G, dim=2)
            s = torch.matmul(qf[lo:], k_r.transpose(-1, -2))  # [.,B,H,Sq,Sk]
            if ctx.causal and step == 0:
                s = _diagonal_masked(s)
            p = torch.exp(s - m_safe[lo:, ..., None]) / l_safe[lo:, ..., None]
            dv_blk = torch.matmul(p.transpose(-1, -2), dof[lo:])  # full heads
            dp = torch.matmul(dof[lo:], v_r.transpose(-1, -2))
            ds = p * (dp - drow[lo:, ..., None])
            dq[lo:] += torch.matmul(ds, k_r) * scale
            dk_blk = torch.matmul(ds.transpose(-1, -2), qf[lo:])  # scale in qf
            # fold GQA: the full heads' gradients summed into kv heads
            dk_ring[lo:] += dk_blk.unflatten(2, (KVH, G)).sum(dim=3)
            dv_ring[lo:] += dv_blk.unflatten(2, (KVH, G)).sum(dim=3)
            # the key/value blocks and their gradients move together;
            # after n hops each gradient block is home
            if step != n - 1:
                k_cur = S.ring_shift(k_cur, 1)
                v_cur = S.ring_shift(v_cur, 1)
            dk_ring = S.ring_shift(dk_ring, 1)
            dv_ring = S.ring_shift(dv_ring, 1)
        back = lambda t: t.permute(0, 1, 3, 2, 4)  # noqa: E731
        return (back(dq).to(q.dtype), back(dk_ring).to(k.dtype),
                back(dv_ring).to(v.dtype), None)


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

    if logit_cap:
        out = _ring_body(stack(q), stack(k), stack(v), causal=causal,
                         logit_cap=logit_cap)
    else:
        out = _RingAttention.apply(stack(q), stack(k), stack(v), causal)
    return out.transpose(0, 1).flatten(1, 2)
