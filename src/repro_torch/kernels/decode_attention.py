"""Flash decode: one query token per sequence against a KV cache — the
Hopper kernel (``csrc/flash_decode.cu``) and its plain PyTorch version.

``flash_decode`` is the port of the TPU kernel of the same name
(``src/repro/kernels/decode_attention.py``).  The kernel splits each
sequence's keys over several CTAs (``decode_split_keys``) and combines
their partial softmaxes in a second launch; all G query heads of one KV
head share each K/V tile, grok-1's logit cap applies to the scores, per-sequence ``lengths`` mask the tail, and any
cache length S is taken (the TPU wrapper asserts ``S % block_k == 0``).
``flash_decode_split_plain`` mirrors the split and combine arithmetic for
the tests; the CPU path takes ``flash_decode_plain``.  ``kernels/ops.py``
picks between kernel and plain version by the device of the tensor.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _lib

NEG_INF = -1e30
MAX_HEAD_DIM = 128       # shared-memory tiles are sized for hd <= 128
MAX_GROUP_WIDTH = 2048   # G*hd: accumulators a CTA keeps in registers
CARD_SMS = 132           # the H100's SMs: the split rule aims at two CTAs each
KEY_TILE = 64            # keys a CTA takes at a time: splits are multiples


def decode_split_keys(B: int, KVH: int, S: int) -> int:
    """Keys per split of the kernel's grid (splits, KVH, B): a multiple of
    ``KEY_TILE`` chosen from the shapes alone (never from ``lengths``, which
    live on the card), so that B*KVH*splits is about twice the card's SMs;
    one split when B*KVH alone covers the SMs.  The qwen2-0.5b serve shape
    (B=8, KVH=2, S=1024) gives 64 keys, 16 splits, 256 CTAs."""
    groups = B * KVH
    want = 1 if groups >= CARD_SMS else -(-2 * CARD_SMS // groups)
    per = -(-S // want)
    return -(-per // KEY_TILE) * KEY_TILE


def decode_splits(B: int, KVH: int, S: int) -> int:
    """The kernel's split count: ceil(S / decode_split_keys(B, KVH, S))."""
    return -(-S // decode_split_keys(B, KVH, S))


def flash_decode_work(B: int, H: int, KVH: int, hd: int, valid: int,
                      dtype) -> tuple[int, int]:
    """(flops, bytes) of one call whose lanes hold ``valid`` cached
    positions in all (the sum of ``lengths``): the two products, 4 operations
    a (position, head, hd) entry; q read and the output written once, each
    valid K and V row read once, the int32 lengths read once."""
    es = dtype.itemsize
    return (4 * valid * H * hd,
            2 * B * H * hd * es + 2 * valid * KVH * hd * es + 4 * B)


def flash_decode_plain(q, k_cache, v_cache, lengths, *, logit_cap: float = 0.0):
    """The kernel's arithmetic in plain PyTorch: q scaled by 1/sqrt(hd) in
    f32, the scores capped at cap·tanh(s/cap) when ``logit_cap`` > 0
    (grok-1), keys at positions >= length masked to -1e30 (a sequence
    with no valid key gives zeros), l floored at 1e-30.

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


def flash_decode_split_plain(q, k_cache, v_cache, lengths, *,
                             split_keys: int):
    """The kernel's split arithmetic in plain PyTorch, for the tests: the
    keys cut into ranges of ``split_keys``; per range f32 m (max of the
    valid scores), l and unnormalised acc, an empty range giving m = -1e30,
    l = 0; then the combine: m = max over ranges, acc and l weighted by
    exp(m_s - m) over the ranges that saw a key, l floored at 1e-30.

    q: [B,H,hd]; caches: [B,S,KVH,hd]; lengths: [B] -> [B,H,hd]."""
    B, H, hd = q.shape
    _, S, KVH, _ = k_cache.shape
    G = H // KVH
    splits = -(-S // split_keys)
    pad = splits * split_keys - S
    qg = q.float().reshape(B, KVH, G, hd) * (1.0 / math.sqrt(hd))
    kf = torch.nn.functional.pad(k_cache.float(), (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(v_cache.float(), (0, 0, 0, 0, 0, pad))
    kf = kf.reshape(B, splits, split_keys, KVH, hd)
    vf = vf.reshape(B, splits, split_keys, KVH, hd)
    s = torch.einsum("bkgd,bnskd->bkgns", qg, kf)           # [B,KVH,G,n,sk]
    pos = torch.arange(splits * split_keys, device=q.device)
    valid = (pos[None, :] < lengths[:, None]).reshape(B, 1, 1, splits,
                                                      split_keys)
    s = torch.where(valid, s, NEG_INF)
    m_s = torch.amax(s, dim=-1)                              # [B,KVH,G,n]
    p = torch.where(valid, torch.exp(s - m_s[..., None]), 0.0)
    l_s = torch.sum(p, dim=-1)
    acc_s = torch.einsum("bkgns,bnskd->bkgnd", p, vf)
    seen = l_s > 0
    m = torch.amax(torch.where(seen, m_s, NEG_INF), dim=-1, keepdim=True)
    w = torch.where(seen, torch.exp(m_s - m), 0.0)
    l = torch.clamp_min(torch.sum(w * l_s, dim=-1), 1e-30)
    o = torch.einsum("bkgn,bkgnd->bkgd", w, acc_s) / l[..., None]
    return o.reshape(B, H, hd).to(q.dtype)


def flash_decode(q, k_cache, v_cache, lengths, *, logit_cap: float = 0.0):
    """q: [B,H,hd]; caches: [B,S,KVH,hd] (q's dtype, f32 or bf16);
    lengths: [B] int32, all on the card -> [B,H,hd].  ``logit_cap`` > 0
    caps the scaled scores (0: no cap, the kernel's uncapped
    instantiation).  Launches the kernel on the current stream or
    raises."""
    name = "flash_decode"
    _lib.require(logit_cap >= 0.0, name,
                 f"logit_cap={logit_cap}: a cap is positive, or 0 for none")
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
    split_keys = decode_split_keys(B, KVH, S)
    splits = decode_splits(B, KVH, S)
    # partials of the splits: f32 acc [B,KVH,splits,G,hd], then m and l
    # [B,KVH,splits,G]; every entry the combine reads is written first
    scratch = (torch.empty(B * H * splits * (hd + 2), dtype=torch.float32,
                           device=q.device) if splits > 1 else None)
    vec = (hd % (16 // q.element_size()) == 0 and k_cache.data_ptr() % 16 == 0
           and v_cache.data_ptr() % 16 == 0)
    rc = _lib.lib().repro_flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(),
        scratch.data_ptr() if scratch is not None else None, B, S, H, KVH,
        hd, split_keys, float(logit_cap), _lib.DTYPE_CODES[q.dtype],
        int(vec), _lib.stream_of(q))
    _lib.check(rc, name)
    _lib.launches[name] += 1
    return out
