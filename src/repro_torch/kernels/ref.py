"""Plain-PyTorch oracles of the ported kernels (the allclose targets);
counterparts of the JAX package's ``kernels/ref.py``."""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """q: [B,Sq,H,hd]; k,v: [B,Sk,KVH,hd] -> [B,Sq,H,hd] (f32 math).
    The causal mask is aligned bottom-right (query i sits at key position
    i + Sk - Sq); masked scores are -inf."""
    B, Sq, H, hd = q.shape
    _, Sk, KVH, _ = k.shape
    G = H // KVH
    scale = 1.0 / math.sqrt(hd)
    kr = torch.repeat_interleave(k, G, dim=2)
    vr = torch.repeat_interleave(v, G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kr.float())
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
