"""Public wrappers of the ported kernels: the models call these.

Dispatch is by the device of the tensor and nothing else: a CPU tensor
goes to the kernel's plain PyTorch version (the CPU tests' path); a CUDA
tensor goes to the hand-written kernel, which launches or raises.  There
is no fallback from a CUDA tensor to the plain version.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention import flash_decode as _fd_kernel
from repro_torch.kernels.decode_attention import flash_decode_plain
from repro_torch.kernels.rmsnorm import rmsnorm_fwd as _rms_fwd_kernel
from repro_torch.kernels.rmsnorm import rmsnorm_fwd_plain


def flash_decode(q, k_cache, v_cache, lengths, *, logit_cap: float = 0.0):
    """q: [B,H,hd]; caches: [B,S,KVH,hd]; lengths: [B] int32 -> [B,H,hd]."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, lengths,
                                  logit_cap=logit_cap)
    return _fd_kernel(q.contiguous(), k_cache.contiguous(),
                      v_cache.contiguous(), lengths.contiguous(),
                      logit_cap=logit_cap)


def rmsnorm(x, scale, eps: float = 1e-6):
    """x: [..., D]; scale: [D] -> x's shape and dtype (forward only)."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if x.device.type == "cpu":
        return rmsnorm_fwd_plain(x2, scale, eps).reshape(shape)
    return _rms_fwd_kernel(x2.contiguous(), scale.contiguous(),
                           eps).reshape(shape)
