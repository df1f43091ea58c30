"""Flash decode: one query token per sequence against a KV cache — the
Hopper kernel (``csrc/flash_decode.cu``) and its plain PyTorch version.

``flash_decode`` is the port of the TPU kernel of the same name
(``src/repro/kernels/decode_attention.py``).  All G query heads of one KV
head share each K/V tile, per-sequence ``lengths`` mask the tail and end
the walk early, and any cache length S is taken (the TPU wrapper asserts
``S % block_k == 0``).  ``kernels/ops.py`` picks between the two versions
by the device of the tensor.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _lib

NEG_INF = -1e30
MAX_HEAD_DIM = 128       # shared-memory tiles are sized for hd <= 128
MAX_GROUP_WIDTH = 2048   # G*hd: accumulators a CTA keeps in registers


def flash_decode_plain(q, k_cache, v_cache, lengths, *, logit_cap: float = 0.0):
    """The kernel's arithmetic in plain PyTorch: q scaled by 1/sqrt(hd) in
    f32, keys at positions >= length masked to -1e30 (a sequence with no
    valid key gives zeros), l floored at 1e-30.  ``logit_cap`` (a tanh
    softcap on the scores) is here for the CPU path only: the kernel
    does not take it.

    q: [B,H,hd]; caches: [B,S,KVH,hd]; lengths: [B] -> [B,H,hd]."""
    B, H, hd = q.shape
    _, S, KVH, _ = k_cache.shape
    G = H // KVH
    qg = q.float().reshape(B, KVH, G, hd) * (1.0 / math.sqrt(hd))
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    if logit_cap:
        s = torch.tanh(s / logit_cap) * logit_cap
    valid = (torch.arange(S, device=q.device)[None, :]
             < lengths[:, None])[:, None, None, :]          # [B,1,1,S]
    s = torch.where(valid, s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), 1e-30)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float()) / l
    return o.reshape(B, H, hd).to(q.dtype)


def flash_decode(q, k_cache, v_cache, lengths, *, logit_cap: float = 0.0):
    """q: [B,H,hd]; caches: [B,S,KVH,hd] (q's dtype, f32 or bf16);
    lengths: [B] int32, all on the card -> [B,H,hd].  Launches the kernel
    on the current stream or raises."""
    name = "flash_decode"
    if logit_cap:
        raise NotImplementedError(
            "flash_decode: logit_cap != 0 is not in the CUDA kernel yet")
    tensors = (q, k_cache, v_cache, lengths)
    _lib.require(all(t.is_cuda and t.device == q.device for t in tensors),
                 name, "q, caches and lengths must be on one CUDA device")
    _lib.require(q.dim() == 3 and k_cache.dim() == 4, name,
                 f"need q [B,H,hd] and caches [B,S,KVH,hd], got "
                 f"{tuple(q.shape)} and {tuple(k_cache.shape)}")
    B, H, hd = q.shape
    _, S, KVH, _ = k_cache.shape
    _lib.require(tuple(k_cache.shape) == (B, S, KVH, hd)
                 and v_cache.shape == k_cache.shape
                 and tuple(lengths.shape) == (B,) and S >= 1, name,
                 f"shapes q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
                 f"v {tuple(v_cache.shape)}, lengths {tuple(lengths.shape)}")
    _lib.require(q.dtype in _lib.DTYPE_CODES and k_cache.dtype == q.dtype
                 and v_cache.dtype == q.dtype, name,
                 f"q/k/v dtypes {q.dtype}/{k_cache.dtype}/{v_cache.dtype}: "
                 f"one of {list(_lib.DTYPE_CODES)} for all three")
    _lib.require(lengths.dtype == torch.int32, name, "lengths must be int32")
    _lib.require(all(t.is_contiguous() for t in tensors), name,
                 "inputs must be contiguous")
    _lib.require(H % KVH == 0, name, f"H={H} not a multiple of KVH={KVH}")
    _lib.require(hd <= MAX_HEAD_DIM and (H // KVH) * hd <= MAX_GROUP_WIDTH,
                 name, f"hd={hd} (max {MAX_HEAD_DIM}) or G*hd="
                       f"{(H // KVH) * hd} (max {MAX_GROUP_WIDTH}) too large")
    out = torch.empty_like(q)
    vec = (hd % (16 // q.element_size()) == 0 and k_cache.data_ptr() % 16 == 0
           and v_cache.data_ptr() % 16 == 0)
    rc = _lib.lib().repro_flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, S, H, KVH, hd,
        _lib.DTYPE_CODES[q.dtype], int(vec), _lib.stream_of(q))
    _lib.check(rc, name)
    _lib.launches[name] += 1
    return out
