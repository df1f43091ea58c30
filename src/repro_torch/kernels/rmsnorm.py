"""RMSNorm forward: the Hopper kernel (``csrc/rmsnorm.cu``) and its plain
PyTorch version.

``rmsnorm_fwd`` is the port of the TPU kernel of the same name
(``src/repro/kernels/rmsnorm.py``).  It takes any N >= 1 rows — there is
no 256-row block to divide N — which the serve path needs: at decode N is
the number of lanes.  ``kernels/ops.py`` picks between the two versions
by the device of the tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib, ref

# The kernel's arithmetic in plain PyTorch is the oracle's, line for line.
rmsnorm_fwd_plain = ref.rmsnorm_ref


def rmsnorm_fwd(x, scale, eps: float = 1e-6):
    """x: [N, D] f32/bf16 on the card; scale: [D] f32 -> [N, D] in x's
    dtype.  Launches the kernel on the current stream or raises."""
    name = "rmsnorm_fwd"
    _lib.require(x.is_cuda and scale.device == x.device, name,
                 f"x and scale must be on one CUDA device, got {x.device} "
                 f"and {scale.device}")
    _lib.require(x.dim() == 2 and x.shape[0] >= 1, name,
                 f"x must be [N>=1, D], got {tuple(x.shape)}")
    N, D = x.shape
    _lib.require(x.dtype in _lib.DTYPE_CODES, name,
                 f"x dtype {x.dtype} not in {list(_lib.DTYPE_CODES)}")
    _lib.require(scale.dtype == torch.float32 and tuple(scale.shape) == (D,),
                 name, f"scale must be f32 [{D}], got {scale.dtype} "
                       f"{tuple(scale.shape)}")
    _lib.require(x.is_contiguous() and scale.is_contiguous(), name,
                 "x and scale must be contiguous")
    _lib.require(D >= 1, name, f"D={D} must be >= 1")
    y = torch.empty_like(x)
    vec = (D % (16 // x.element_size()) == 0 and x.data_ptr() % 16 == 0
           and y.data_ptr() % 16 == 0)
    rc = _lib.lib().repro_rmsnorm_fwd(
        x.data_ptr(), scale.data_ptr(), y.data_ptr(), N, D, float(eps),
        _lib.DTYPE_CODES[x.dtype], int(vec), _lib.stream_of(x))
    _lib.check(rc, name)
    _lib.launches[name] += 1
    return y
