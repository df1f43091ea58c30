"""Flash attention forward: the Hopper kernel (``csrc/flash_attention.cu``)
and its plain PyTorch version.

``flash_attention`` is the port of the TPU kernel of the same name
(``src/repro/kernels/flash_attention.py``): GQA without repeating K/V,
the causal mask aligned bottom-right, key tiles above the diagonal
skipped, and grok-1's logit cap (cap·tanh(s/cap)) on the scaled scores
before the mask.  In bf16 both products run on Hopper's wgmma with S, P
and O in registers and a two-stage ring of K/V copies; f32 runs on the
FMA units.
It takes any Sq and Sk (the Pallas wrapper asserts both are multiples of
its blocks).  ``kernels/ops.py`` picks between the two
versions by the device of the tensor, and gives both one backward.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _lib

NEG_INF = -1e30
MAX_HEAD_DIM = 128       # shared-memory tiles are sized for hd <= 128


def attention_pairs(Sq: int, Sk: int, causal: bool) -> int:
    """The (query, key) pairs the mask leaves: Sq·Sk, or under the
    bottom-right causal mask the sum over query rows i of
    max(0, i + Sk - Sq + 1)."""
    if not causal:
        return Sq * Sk
    off = Sk - Sq + 1
    lo = max(0, 1 - off)              # the first row that sees a key
    return (lo + off + Sk) * (Sq - lo) // 2 if lo < Sq else 0


def flash_attention_work(B: int, Sq: int, Sk: int, H: int, KVH: int,
                         hd: int, causal: bool, dtype) -> tuple[int, int]:
    """(flops, bytes) of one forward: the two products over the pairs the
    mask leaves, 4 operations a (pair, head, hd) entry; q read and the
    output written once, K and V read once."""
    return (4 * B * H * attention_pairs(Sq, Sk, causal) * hd,
            (2 * B * Sq * H * hd + 2 * B * Sk * KVH * hd) * dtype.itemsize)


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          logit_cap: float = 0.0):
    """The kernel's arithmetic in plain PyTorch: scores q.k/sqrt(hd) in f32,
    capped at cap·tanh(s/cap) when ``logit_cap`` > 0 (grok-1), masked to
    -1e30 (bottom-right causal alignment), l floored at 1e-30,
    probabilities rounded to v's dtype for the P.V product.

    q: [B,Sq,H,hd]; k, v: [B,Sk,KVH,hd] -> [B,Sq,H,hd] in q's dtype."""
    B, Sq, H, hd = q.shape
    _, Sk, KVH, _ = k.shape
    G = H // KVH
    qg = q.float().reshape(B, Sq, KVH, G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    s = s * (1.0 / math.sqrt(hd))
    if logit_cap:
        s = torch.tanh(s / logit_cap) * logit_cap
    if causal:
        mask = torch.ones(Sq, Sk, dtype=torch.bool,
                          device=q.device).tril(diagonal=Sk - Sq)
        s = torch.where(mask, s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), 1e-30)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    o = o / l.permute(0, 3, 1, 2, 4)
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, logit_cap: float = 0.0):
    """q: [B,Sq,H,hd]; k, v: [B,Sk,KVH,hd] (q's dtype, f32 or bf16), all
    contiguous on the card -> [B,Sq,H,hd].  ``logit_cap`` > 0 caps the
    scaled scores (0: no cap, the kernel's uncapped instantiation).
    Launches the kernel on the current stream or raises."""
    name = "flash_attention"
    _lib.require(all(t.is_cuda and t.device == q.device for t in (q, k, v)),
                 name, "q, k and v must be on one CUDA device")
    _lib.require(q.dim() == 4 and k.dim() == 4, name,
                 f"need q [B,Sq,H,hd] and k/v [B,Sk,KVH,hd], got "
                 f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, Sq, H, hd = q.shape
    _, Sk, KVH, _ = k.shape
    _lib.require(tuple(k.shape) == (B, Sk, KVH, hd) and v.shape == k.shape
                 and Sq >= 1 and Sk >= 1 and B >= 1, name,
                 f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                 f"v {tuple(v.shape)}")
    _lib.require(q.dtype in _lib.DTYPE_CODES and k.dtype == q.dtype
                 and v.dtype == q.dtype, name,
                 f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: one of "
                 f"{list(_lib.DTYPE_CODES)} for all three")
    _lib.require(all(t.is_contiguous() for t in (q, k, v)), name,
                 "q, k and v must be contiguous")
    _lib.require(KVH >= 1 and H % KVH == 0, name,
                 f"H={H} not a multiple of KVH={KVH}")
    _lib.require(16 <= hd <= MAX_HEAD_DIM and hd % 16 == 0, name,
                 f"hd={hd}: the kernel takes multiples of 16 up to "
                 f"{MAX_HEAD_DIM}")
    _lib.require(not causal or Sq <= Sk, name,
                 f"causal attention needs Sq <= Sk, got {Sq} > {Sk}")
    _lib.require(logit_cap >= 0.0, name,
                 f"logit_cap={logit_cap}: a cap is positive, or 0 for none")
    if q.dtype == torch.bfloat16:
        # the bf16 kernel copies 16-byte chunks: a view that starts off a
        # 16-byte boundary is copied to a fresh (aligned) tensor first
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v))
    out = torch.empty_like(q)
    vec = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    rc = _lib.lib().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk,
        H, KVH, hd, int(causal), float(logit_cap), _lib.DTYPE_CODES[q.dtype],
        int(vec), _lib.stream_of(q))
    _lib.check(rc, name)
    _lib.launches[name] += 1
    return out
