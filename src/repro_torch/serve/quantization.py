"""int8 weight quantization for serving (the JAX package's
``serve/quantization.py``).

Decode reads every parameter once a token step.  Storing the large 2-D+
weight matrices as per-output-channel int8 with f32 scales halves that
stream against bf16 (and quarters it against f32).  ``quantize_tree``
replaces the eligible leaves of a parameter tree (float, ndim ≥ 2, at
least ``min_size`` entries) with ``QuantizedTensor``;
``dequantize_tree`` restores them in the compute dtype at use
(``registry.decode_step_q``).  Symmetric, 127 levels, one scale per
last-axis channel.

Trees are nested dicts, as everywhere in the port; a ``QuantizedTensor``
is a leaf.  Where the JAX package takes ``jax.ShapeDtypeStruct`` trees
(``quantized_shapes``), this takes tensors on the ``meta`` device.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models.layers import tree_leaves, tree_map


class QuantizedTensor(NamedTuple):
    q: torch.Tensor          # int8, original shape
    scale: torch.Tensor      # f32, shape = original with last dim = 1


def quantize_array(w: torch.Tensor) -> QuantizedTensor:
    wf = w.float()
    scale = wf.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QuantizedTensor(q, scale)


def dequantize_array(t: QuantizedTensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (t.q.float() * t.scale).to(dtype)


def _eligible(leaf, min_size: int) -> bool:
    return (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
            and leaf.dim() >= 2 and leaf.numel() >= min_size)


def quantize_tree(params: Any, min_size: int = 1 << 16) -> Any:
    """Replace large float matrices with QuantizedTensor leaves."""
    return tree_map(
        lambda p: quantize_array(p) if _eligible(p, min_size) else p, params)


def dequantize_tree(params: Any, dtype=torch.bfloat16) -> Any:
    return tree_map(
        lambda p: dequantize_array(p, dtype)
        if isinstance(p, QuantizedTensor) else p, params)


def quantized_bytes(params: Any) -> int:
    total = 0
    for _, leaf in tree_leaves(params):
        for t in (leaf if isinstance(leaf, QuantizedTensor) else (leaf,)):
            total += t.numel() * t.element_size()
    return total


def quantized_shapes(param_shapes: Any, min_size: int = 1 << 16) -> Any:
    """The ``meta``-tensor tree that ``quantize_tree`` makes of a tree of
    ``meta`` tensors (no allocation)."""
    def one(p):
        if _eligible(p, min_size):
            return QuantizedTensor(
                torch.empty(p.shape, dtype=torch.int8, device="meta"),
                torch.empty(p.shape[:-1] + (1,), dtype=torch.float32,
                            device="meta"))
        return p
    return tree_map(one, param_shapes)


def quantized_axes(param_axes: Any, param_shapes: Any,
                   min_size: int = 1 << 16) -> Any:
    """Logical-axes tree matching quantize_tree's structure."""
    if isinstance(param_axes, dict):
        return {k: quantized_axes(param_axes[k], param_shapes[k], min_size)
                for k in param_axes}
    if _eligible(param_shapes, min_size):
        return QuantizedTensor(param_axes, param_axes[:-1] + (None,))
    return param_axes
