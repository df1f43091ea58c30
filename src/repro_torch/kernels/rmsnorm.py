"""RMSNorm forward and backward: the Hopper kernels (``csrc/rmsnorm.cu``)
and their plain PyTorch versions.

``rmsnorm_fwd`` and ``rmsnorm_bwd`` are the ports of the TPU kernels of
the same names (``src/repro/kernels/rmsnorm.py``).  They take any N >= 1
rows — there is no 256-row block to divide N — which the serve path
needs: at decode N is the number of lanes.  ``kernels/ops.py`` picks
between the kernels and the plain versions by the device of the tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib, ref

# The kernel's arithmetic in plain PyTorch is the oracle's, line for line.
rmsnorm_fwd_plain = ref.rmsnorm_ref

# Rows per CTA of the backward kernel, and so per row of its dscale
# partials (the C entry point refuses any other value).
BWD_BLOCK_ROWS = 32

# Widest row the forward kernel's rows path holds in registers: 16 16-byte
# chunks a lane, 32 lanes.
ROW_PATH_MAX_BYTES = 16 * 16 * 32


def rmsnorm_fwd_path(D: int, dtype) -> str:
    """The forward kernel's path for rows of D entries of ``dtype``, from
    those alone: ``"rows"`` (one warp per row, the row in registers) when D
    is a whole number of 16-byte chunks and at most ``ROW_PATH_MAX_BYTES``
    (D <= 4096 in bf16, 2048 in f32), else ``"cta"`` (one CTA per row, any
    D)."""
    nbytes = D * dtype.itemsize
    fits = nbytes % 16 == 0 and nbytes <= ROW_PATH_MAX_BYTES
    return "rows" if fits else "cta"


def rmsnorm_fwd_work(N: int, D: int, dtype) -> tuple[int, int]:
    """(flops, bytes) of one forward over [N, D] rows of ``dtype``: four
    operations an entry (square, sum, scale, multiply); x read and y
    written once, the f32 scale read once."""
    return 4 * N * D, 2 * N * D * dtype.itemsize + 4 * D


def rmsnorm_bwd_work(N: int, D: int, dtype) -> tuple[int, int]:
    """(flops, bytes) of one backward over [N, D] rows of ``dtype``: twelve
    operations an entry; x and g read and dx written once, the f32 scale
    read and the f32 dscale partials [ceil(N/32), D] written once."""
    nb = -(-N // BWD_BLOCK_ROWS)
    return 12 * N * D, 3 * N * D * dtype.itemsize + nb * D * 4 + D * 4


def rmsnorm_fwd(x, scale, eps: float = 1e-6):
    """x: [N, D] f32/bf16 on the card; scale: [D] f32 -> [N, D] in x's
    dtype.  Launches the kernel on the current stream or raises."""
    name = "rmsnorm_fwd"
    _check(name, x, scale)
    N, D = x.shape
    # the kernel reads 16-byte chunks: a view that starts off a 16-byte
    # boundary is copied to a fresh (aligned) tensor first
    x, scale = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, scale))
    y = torch.empty_like(x)
    path = rmsnorm_fwd_path(D, x.dtype)
    rc = _lib.lib().repro_rmsnorm_fwd(
        x.data_ptr(), scale.data_ptr(), y.data_ptr(), N, D, float(eps),
        _lib.DTYPE_CODES[x.dtype], int(path == "rows"), _lib.stream_of(x))
    _lib.check(rc, name)
    _lib.launches[name] += 1
    return y


def rmsnorm_bwd_plain(x, scale, g, eps: float = 1e-6):
    """The backward kernel's arithmetic in plain PyTorch (the TPU kernel's
    ``_rms_bwd_kernel``): f32 math, dx in x's dtype, and one f32 partial
    of dscale per block of ``BWD_BLOCK_ROWS`` rows.

    x, g: [N, D]; scale: [D] -> (dx [N, D], dscale partials [nb, D])."""
    N, D = x.shape
    xf, gf, s = x.float(), g.float(), scale.float()
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xhat = xf * inv
    gs = gf * s
    dx = inv * (gs - xhat * torch.mean(gs * xhat, dim=-1, keepdim=True))
    nb = -(-N // BWD_BLOCK_ROWS)
    part = torch.zeros(nb * BWD_BLOCK_ROWS, D, dtype=torch.float32,
                       device=x.device)
    part[:N] = gf * xhat
    return dx.to(x.dtype), part.reshape(nb, BWD_BLOCK_ROWS, D).sum(dim=1)


def rmsnorm_bwd(x, scale, g, eps: float = 1e-6):
    """x, g: [N, D] f32/bf16 (one dtype) on the card; scale: [D] f32 ->
    (dx [N, D] in x's dtype, dscale partials [ceil(N/32), D] f32), as
    ``rmsnorm_bwd_plain``.  The caller sums the partials.  Launches the
    kernel on the current stream or raises."""
    name = "rmsnorm_bwd"
    _check(name, x, scale)
    _lib.require(g.device == x.device and g.dtype == x.dtype
                 and g.shape == x.shape and g.is_contiguous(), name,
                 f"g must be a contiguous {x.dtype} {tuple(x.shape)} on "
                 f"{x.device}, got {g.dtype} {tuple(g.shape)} on {g.device}")
    N, D = x.shape
    nb = -(-N // BWD_BLOCK_ROWS)
    dx = torch.empty_like(x)
    part = torch.empty(nb, D, dtype=torch.float32, device=x.device)
    vec = all(t.data_ptr() % 16 == 0 for t in (x, scale, g, dx, part))
    rc = _lib.lib().repro_rmsnorm_bwd(
        x.data_ptr(), scale.data_ptr(), g.data_ptr(), dx.data_ptr(),
        part.data_ptr(), N, D, BWD_BLOCK_ROWS, float(eps),
        _lib.DTYPE_CODES[x.dtype], int(vec), _lib.stream_of(x))
    _lib.check(rc, name)
    _lib.launches[name] += 1
    return dx, part


def _check(name, x, scale):
    _lib.require(x.is_cuda and scale.device == x.device, name,
                 f"x and scale must be on one CUDA device, got {x.device} "
                 f"and {scale.device}")
    _lib.require(x.dim() == 2 and x.shape[0] >= 1 and x.shape[1] >= 1, name,
                 f"x must be [N>=1, D>=1], got {tuple(x.shape)}")
    D = x.shape[1]
    _lib.require(x.dtype in _lib.DTYPE_CODES, name,
                 f"x dtype {x.dtype} not in {list(_lib.DTYPE_CODES)}")
    _lib.require(scale.dtype == torch.float32 and tuple(scale.shape) == (D,),
                 name, f"scale must be f32 [{D}], got {scale.dtype} "
                       f"{tuple(scale.shape)}")
    _lib.require(x.is_contiguous() and scale.is_contiguous(), name,
                 "x and scale must be contiguous")
