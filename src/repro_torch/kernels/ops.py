"""Public wrappers of the ported kernels: the models call these.

Dispatch is by the device of the tensor and nothing else: a CPU tensor
goes to the kernel's plain PyTorch version (the CPU tests' path); a CUDA
tensor goes to the hand-written kernel, which launches or raises.  There
is no fallback from a CUDA tensor to the plain version.

``rmsnorm``, ``flash_attention`` and ``ssd_chunk`` are
``torch.autograd.Function``s, the counterparts of the JAX package's
``jax.custom_vjp``s (``ops.py``): rmsnorm's backward is a kernel too, and
its dscale partials are summed here, as the JAX ``ops.py`` sums them;
flash attention's and ssd_chunk's backwards recompute through the
oracles ``ref.flash_attention_ref`` and ``ref.ssd_chunk_ref`` and take
their autograd gradients, as the JAX ``ops.py`` takes ``jax.vjp`` of the
oracle.  Under ``torch.no_grad()`` each is one forward launch and
nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import flash_decode as _fd_kernel
from repro_torch.kernels.decode_attention import flash_decode_plain
from repro_torch.kernels.flash_attention import \
    flash_attention as _fa_kernel
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.rmsnorm import rmsnorm_bwd as _rms_bwd_kernel
from repro_torch.kernels.rmsnorm import rmsnorm_bwd_plain
from repro_torch.kernels.rmsnorm import rmsnorm_fwd as _rms_fwd_kernel
from repro_torch.kernels.rmsnorm import rmsnorm_fwd_plain
from repro_torch.kernels.ssd_scan import ssd_chunk as _ssd_kernel
from repro_torch.kernels.ssd_scan import ssd_chunk_plain


def flash_decode(q, k_cache, v_cache, lengths, *, logit_cap: float = 0.0):
    """q: [B,H,hd]; caches: [B,S,KVH,hd]; lengths: [B] int32 -> [B,H,hd]."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, lengths,
                                  logit_cap=logit_cap)
    return _fd_kernel(q.contiguous(), k_cache.contiguous(),
                      v_cache.contiguous(), lengths.contiguous(),
                      logit_cap=logit_cap)


# ---------------------------------------------------------------------------
# flash attention (forward kernel; backward through the oracle)
# ---------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, logit_cap):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        ctx.logit_cap = logit_cap
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, causal=causal,
                                         logit_cap=logit_cap)
        return _fa_kernel(q.contiguous(), k.contiguous(), v.contiguous(),
                          causal=causal, logit_cap=logit_cap)

    @staticmethod
    def backward(ctx, g):
        # The recompute materialises f32 scores [B, H, Sq, Sk] and their
        # softmax: at smollm-360m's training shape (B=8, S=1024, H=15)
        # ~0.5 GB a tensor and a few GB transient per layer, freed before
        # the next layer's backward.  That fits the card's 80 GB; a
        # backward kernel is queued in ROADMAP.md.
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            o = ref.flash_attention_ref(*leaves, causal=ctx.causal,
                                        logit_cap=ctx.logit_cap)
            dq, dk, dv = torch.autograd.grad(o, leaves, g)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, logit_cap: float = 0.0):
    """q: [B,Sq,H,hd]; k, v: [B,Sk,KVH,hd] -> [B,Sq,H,hd] in q's dtype.
    ``logit_cap`` > 0 caps the scaled scores at cap·tanh(s/cap) before
    the mask (grok-1); 0 leaves them as they are."""
    return _FlashAttention.apply(q, k, v, causal, float(logit_cap or 0.0))


# ---------------------------------------------------------------------------
# fused rmsnorm (forward and backward kernels)
# ---------------------------------------------------------------------------

class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        if x.device.type == "cpu":
            return rmsnorm_fwd_plain(x, scale, eps)
        return _rms_fwd_kernel(x.contiguous(), scale.contiguous(), eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        g = g.to(x.dtype)
        if x.device.type == "cpu":
            dx, part = rmsnorm_bwd_plain(x, scale, g, ctx.eps)
        else:
            dx, part = _rms_bwd_kernel(x.contiguous(), scale.contiguous(),
                                       g.contiguous(), ctx.eps)
        return dx, torch.sum(part, dim=0).to(scale.dtype), None


def rmsnorm(x, scale, eps: float = 1e-6):
    """x: [..., D]; scale: [D] (read as f32) -> x's shape and dtype."""
    shape = x.shape
    y = _RMSNorm.apply(x.reshape(-1, shape[-1]), scale.float(), eps)
    return y.reshape(shape)


# ---------------------------------------------------------------------------
# SSD intra-chunk (forward kernel; backward through the oracle)
# ---------------------------------------------------------------------------

class _SSDChunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, b, c, dt, a_log):
        ctx.save_for_backward(x, b, c, dt, a_log)
        if x.device.type == "cpu":
            return ssd_chunk_plain(x, b, c, dt, a_log)
        return _ssd_kernel(x.contiguous(), b.contiguous(), c.contiguous(),
                           dt.contiguous(), a_log.float().contiguous())

    @staticmethod
    def backward(ctx, gy, gstates, gdecay):
        # The recompute materialises f32 [B, Q, Q, nh] tensors: at
        # mamba2-1.3b's training shape (B*nc=32, Q=256, nh=64) 0.54 GB
        # each, a few GB transient per layer, freed before the next
        # layer's backward.
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            outs = ref.ssd_chunk_ref(*leaves)
            return torch.autograd.grad(outs, leaves, (gy, gstates, gdecay))


def ssd_chunk(x, b, c, dt, a_log):
    """x: [B,Q,nh,hp]; b, c: [B,Q,ds]; dt: [B,Q,nh]; a_log: [nh] ->
    (y [B,Q,nh,hp] in x's dtype, states [B,nh,hp,ds] f32, decay_total
    [B,nh] f32)."""
    return _SSDChunk.apply(x, b, c, dt, a_log)
