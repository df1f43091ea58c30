"""Gradient compression with error feedback (the port of the JAX
package's ``collectives/compression.py``): the reduction ships int8 with
per-block f32 scales and adds in f32; the quantization error feeds back
into the next step (EF-SGD).  Payloads are rank-stacked ``[n, ..., D]``
(see ``schedules``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.collectives import schedules as S


def quantize_int8(x: torch.Tensor, block: int = 2048):
    """Blockwise symmetric int8 quantization over the last dim.  Returns
    (q [..., nb, block] int8, scales [..., nb, 1] f32)."""
    n = x.shape[-1]
    pad = (-n) % block
    xp = F.pad(x, (0, pad)) if pad else x
    xb = xp.reshape(xp.shape[:-1] + (xp.shape[-1] // block, block))
    amax = torch.amax(torch.abs(xb), dim=-1, keepdim=True)
    # a true division by a tensor, as jnp's ``/ 127.0``: a python-scalar
    # divisor is a multiply by its reciprocal on the card
    scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-12)
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    orig_len: int) -> torch.Tensor:
    x = q.float() * scale
    return x.reshape(x.shape[:-2] + (-1,))[..., :orig_len]


def compressed_allreduce(x: torch.Tensor, block: int = 2048,
                         algorithm: str = "ring") -> torch.Tensor:
    """int8 allreduce of stacked ``x`` ``[n, ..., D]``: each rank
    quantizes, the ring ships (q, scale) pairs (int8 on the wire) and
    every hop adds the dequantized f32 chunk.  Returns the allreduced
    approximation of the f32 sum on every rank."""
    del algorithm                    # the ring is the one wire schedule
    D = x.shape[-1]
    n = x.shape[0]
    q, scale = quantize_int8(x, block)
    acc = dequantize_int8(q, scale, D)
    cur_q, cur_s = q, scale
    for _ in range(n - 1):
        cur_q = S.ring_shift(cur_q, 1)
        cur_s = S.ring_shift(cur_s, 1)
        acc = acc + dequantize_int8(cur_q, cur_s, D)
    return acc


class ErrorFeedback:
    """EF-SGD state helpers: feed the compression residual back next
    step.  ``comp, new_err = ef.reduce_with_feedback(grads, err)`` on
    trees of rank-stacked leaves ``[n, *shape]``."""

    def __init__(self, axis=None, block: int = 2048):
        self.axis = axis
        self.block = block

    def init(self, grads):
        from repro_torch.collectives.overlap import tree_flatten
        leaves, unflatten = tree_flatten(grads)
        return unflatten([torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device) for g in leaves])

    def reduce_with_feedback(self, grads, err):
        """Returns (reduced_grads, new_err): grads + err is quantized;
        the per-leaf residual (what int8 lost) becomes the next err."""
        from repro_torch.collectives.overlap import tree_flatten

        def one(g, e):
            target = g.float() + e
            flat = target.reshape(g.shape[0], -1)
            q, s = quantize_int8(flat, self.block)
            sent = dequantize_int8(q, s, flat.shape[-1]).reshape(g.shape)
            red = compressed_allreduce(flat, self.block)
            return red.reshape(g.shape), target - sent

        flat_g, unflatten = tree_flatten(grads)
        flat_e, _ = tree_flatten(err)
        out = [one(g, e) for g, e in zip(flat_g, flat_e)]
        return (unflatten([o[0] for o in out]),
                unflatten([o[1] for o in out]))
