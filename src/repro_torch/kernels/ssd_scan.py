"""Mamba2 SSD within a chunk: the Hopper kernel (``csrc/ssd_chunk.cu``)
and its plain PyTorch version.

``ssd_chunk`` is the port of the TPU kernel of the same name
(``src/repro/kernels/ssd_scan.py``): for stacked chunks it returns the
intra-chunk output, each chunk's emitted state and its total decay.  The
inter-chunk recurrence stays in ``models/mamba.py::ssd_forward``, as in
the JAX package.  It takes any chunk length Q (``ssd_forward`` makes one
chunk of a whole sequence whose length the chunk size does not divide)
and dt in f32 or in x's dtype (the model passes dt after an f32
softplus).  ``kernels/ops.py`` picks between the two versions by the
device of the tensor, and gives both one backward.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib, ref

MAX_HEAD_DIM = 128       # the kernel's register and shared-memory tiles
MAX_STATE = 256
Q_TILE = 64              # query rows of a CTA, keys of a tile
MAX_HEAD_BLOCK = 8       # heads a bf16 y CTA shares its S tiles over
CARD_SMS = 132           # the H100's SMs: the head-block rule aims at two CTAs each


def ssd_head_block(B: int, Q: int, nh: int) -> int:
    """Heads a bf16 y CTA of the kernel shares each S = C.B^T tile over,
    from the shapes alone: up to ``MAX_HEAD_BLOCK`` (the TPU kernel's
    ``block_h``), halved while the y CTAs, B * ceil(Q/64) * ceil(nh/hb),
    number fewer than two a SM.  Any nh: the last block of an nh that hb
    does not divide is ragged.  The mamba2-1.3b training shape (B*nc = 32,
    Q = 256, nh = 64) gives 8: 1024 y CTAs."""
    n_q = -(-Q // Q_TILE)
    hb = min(MAX_HEAD_BLOCK, nh)
    while hb > 1 and B * n_q * -(-nh // hb) < 2 * CARD_SMS:
        hb = -(-hb // 2)
    return hb


def ssd_grid(B: int, Q: int, nh: int, hp: int, ds: int) -> tuple[int, int]:
    """The bf16 kernel's CTAs (y CTAs, state CTAs): a y CTA per (chunk,
    64-query tile, head block), a state CTA per (chunk, head, 64 rows of
    hp, 128 columns of ds)."""
    hb = ssd_head_block(B, Q, nh)
    n_y = B * -(-Q // Q_TILE) * -(-nh // hb)
    return n_y, B * nh * -(-hp // 64) * -(-ds // 128)


# the kernel's arithmetic in plain PyTorch: the oracle, whose prefix sums
# add in the kernel's order
ssd_chunk_plain = ref.ssd_chunk_ref


def ssd_states_bf16_plain(x, b, dt, a_log):
    """The bf16 kernel's states in plain PyTorch: each term's decayed x,
    x_j dt_j exp(clip(cum_last - cum_j, -60, 0)), rounded once to bf16 (the
    state's product takes it as one bf16 operand, with no low part), then
    summed against B in f32.

    x: [B,Q,nh,hp] bf16; b: [B,Q,ds] bf16; dt: [B,Q,nh]; a_log: [nh] ->
    states [B,nh,hp,ds] f32."""
    cum = ref.prefix_sum(dt.float() * -torch.exp(a_log.float()))
    f = dt.float() * torch.exp((cum[:, -1:, :] - cum).clamp(-60.0, 0.0))
    xd = (x.float() * f[..., None]).to(torch.bfloat16).float()
    return torch.einsum("bjhp,bjs->bhps", xd, b.float())


def ssd_chunk(x, b, c, dt, a_log):
    """x: [B,Q,nh,hp] f32/bf16; b, c: [B,Q,ds] in x's dtype; dt: [B,Q,nh]
    f32 or x's dtype; a_log: [nh] f32; all contiguous on the card ->
    as ``ssd_chunk_plain``.  Launches the kernel (two launches: the prefix
    sums, then y, the states and the decay) on the current stream or
    raises."""
    name = "ssd_chunk"
    tensors = (x, b, c, dt, a_log)
    _lib.require(all(t.is_cuda and t.device == x.device for t in tensors),
                 name, "x, b, c, dt and a_log must be on one CUDA device")
    _lib.require(x.dim() == 4 and b.dim() == 3 and c.dim() == 3
                 and dt.dim() == 3 and a_log.dim() == 1, name,
                 f"need x [B,Q,nh,hp], b/c [B,Q,ds], dt [B,Q,nh], a_log "
                 f"[nh], got {tuple(x.shape)}, {tuple(b.shape)}, "
                 f"{tuple(c.shape)}, {tuple(dt.shape)}, {tuple(a_log.shape)}")
    B, Q, nh, hp = x.shape
    ds = b.shape[-1]
    _lib.require(tuple(b.shape) == (B, Q, ds) and c.shape == b.shape
                 and tuple(dt.shape) == (B, Q, nh)
                 and tuple(a_log.shape) == (nh,) and min(B, Q, nh) >= 1,
                 name, f"shapes x {tuple(x.shape)}, b {tuple(b.shape)}, "
                       f"c {tuple(c.shape)}, dt {tuple(dt.shape)}, a_log "
                       f"{tuple(a_log.shape)}")
    _lib.require(x.dtype in _lib.DTYPE_CODES and b.dtype == x.dtype
                 and c.dtype == x.dtype, name,
                 f"x/b/c dtypes {x.dtype}/{b.dtype}/{c.dtype}: one of "
                 f"{list(_lib.DTYPE_CODES)} for all three")
    _lib.require(dt.dtype in (torch.float32, x.dtype), name,
                 f"dt dtype {dt.dtype}: float32 or x's {x.dtype}")
    _lib.require(a_log.dtype == torch.float32, name,
                 f"a_log dtype {a_log.dtype}: float32")
    _lib.require(all(t.is_contiguous() for t in tensors), name,
                 "x, b, c, dt and a_log must be contiguous")
    _lib.require(16 <= hp <= MAX_HEAD_DIM and hp % 16 == 0, name,
                 f"hp={hp}: the kernel takes multiples of 16 up to "
                 f"{MAX_HEAD_DIM}")
    _lib.require(16 <= ds <= MAX_STATE and ds % 16 == 0, name,
                 f"ds={ds}: the kernel takes multiples of 16 up to "
                 f"{MAX_STATE}")
    _lib.require(B <= 65535 and nh <= 65535, name,
                 f"B={B} and nh={nh} must be at most 65535 (grid)")
    if x.dtype == torch.bfloat16:
        # the bf16 kernel copies 16-byte chunks: a view that starts off a
        # 16-byte boundary is copied to a fresh (aligned) tensor first
        x, b, c = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (x, b, c))
    lib = _lib.lib()
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    states = torch.empty(B, nh, hp, ds, **f32)
    decay = torch.empty(B, nh, **f32)
    # work space: per (chunk, head) the prefix sums, dt as f32 and the
    # scan's block totals
    work = torch.empty(B, nh, lib.repro_ssd_chunk_scratch(Q), **f32)
    vec = all(t.data_ptr() % 16 == 0 for t in (x, b, c))
    rc = lib.repro_ssd_chunk(
        x.data_ptr(), b.data_ptr(), c.data_ptr(), dt.data_ptr(),
        a_log.data_ptr(), y.data_ptr(), states.data_ptr(), decay.data_ptr(),
        work.data_ptr(), B, Q, nh, hp, ds, ssd_head_block(B, Q, nh),
        _lib.DTYPE_CODES[x.dtype],
        _lib.DTYPE_CODES[dt.dtype], int(vec), _lib.stream_of(x))
    _lib.check(rc, name)
    _lib.launches[name] += 1
    return y, states, decay
