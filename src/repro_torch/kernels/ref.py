"""Plain-PyTorch oracles of the ported kernels (the allclose targets);
counterparts of the JAX package's ``kernels/ref.py``."""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        logit_cap: float = 0.0):
    """q: [B,Sq,H,hd]; k,v: [B,Sk,KVH,hd] -> [B,Sq,H,hd] (f32 math).
    The causal mask is aligned bottom-right (query i sits at key position
    i + Sk - Sq); masked scores are -inf.  ``logit_cap`` > 0 caps the
    scaled scores at cap·tanh(s/cap) before the mask."""
    B, Sq, H, hd = q.shape
    _, Sk, KVH, _ = k.shape
    G = H // KVH
    scale = 1.0 / math.sqrt(hd)
    kr = torch.repeat_interleave(k, G, dim=2)
    vr = torch.repeat_interleave(v, G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kr.float())
    if logit_cap:
        s = torch.tanh(s / logit_cap) * logit_cap
    if causal:
        mask = torch.ones(Sq, Sk, dtype=torch.bool,
                          device=q.device).tril(diagonal=Sk - Sq)
        s = torch.where(mask[None, None], s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vr.float())
    return o.to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, lengths):
    """q: [B,H,hd]; caches: [B,S,KVH,hd]; lengths: [B] -> [B,H,hd]."""
    B, H, hd = q.shape
    _, S, KVH, _ = k_cache.shape
    G = H // KVH
    scale = 1.0 / math.sqrt(hd)
    kr = torch.repeat_interleave(k_cache, G, dim=2)
    vr = torch.repeat_interleave(v_cache, G, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q.float() * scale, kr.float())
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, :], s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhk,bkhd->bhd", p, vr.float())
    return o.to(q.dtype)


def rmsnorm_ref(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def prefix_sum(a):
    """Inclusive prefix sums of ``a`` [B, Q, nh] over Q, in f32, in one
    fixed order: sequential within blocks of 16 (zero-padded), each
    block's carry the same scan of the block totals, recursively.  It is
    the order XLA's CPU backend gives the JAX package's ``jnp.cumsum``,
    and the ``ssd_chunk`` kernel's.  The order matters: y cancels
    cum_i - cum_j, two sums of up to hundreds at Q = 256, so two orders
    of f32 adds move y by more than the f32 tolerance.  Each step is an
    elementwise f32 add, which every device rounds alike."""
    B, N, nh = a.shape
    if N <= 16:
        out = [a[:, 0]]
        for k in range(1, N):
            out.append(out[-1] + a[:, k])
        return torch.stack(out, dim=1)
    nb = -(-N // 16)
    pad = a.new_zeros(B, nb * 16 - N, nh)
    blocks = torch.cat([a, pad], dim=1).reshape(B, nb, 16, nh)
    local = [blocks[:, :, 0]]
    for k in range(1, 16):
        local.append(local[-1] + blocks[:, :, k])
    local = torch.stack(local, dim=2)                   # [B, nb, 16, nh]
    totals = prefix_sum(local[:, :, -1])                # [B, nb, nh]
    carry = torch.cat([a.new_zeros(B, 1, nh), totals[:, :-1]], dim=1)
    return (local + carry[:, :, None]).reshape(B, nb * 16, nh)[:, :N]


def ssd_chunk_ref(x, b, c, dt, a_log):
    """One-chunk SSD oracle (intra-chunk + emitted chunk state).

    x: [B,Q,nh,hp]; b,c: [B,Q,ds]; dt: [B,Q,nh] (post-softplus);
    a_log: [nh].  Returns (y_intra [B,Q,nh,hp] in x's dtype, state
    [B,nh,hp,ds] f32, decay_total [B,nh] f32).  The prefix sums over Q
    are ``prefix_sum``'s, on every device.
    """
    Q = x.shape[1]
    a = -torch.exp(a_log.float())
    cum = prefix_sum(dt.float() * a)                    # [B,Q,nh]
    seg = cum[:, :, None, :] - cum[:, None, :, :]       # [B,Q,Q,nh]
    tri = torch.ones(Q, Q, dtype=torch.float32, device=x.device).tril()
    Lmat = torch.exp(seg.clamp(-60.0, 0.0)) * tri[None, :, :, None]
    cb = torch.einsum("bis,bjs->bij", c.float(), b.float())
    w = cb[..., None] * Lmat
    xdt = x.float() * dt.float()[..., None]
    y = torch.einsum("bijh,bjhp->bihp", w, xdt)
    decay_out = torch.exp((cum[:, -1:, :] - cum).clamp(-60.0, 0.0))
    state = torch.einsum("bjhp,bjh,bjs->bhps", xdt, decay_out, b.float())
    decay_total = torch.exp(cum[:, -1, :].clamp(-60.0, 0.0))
    return y.to(x.dtype), state, decay_total
