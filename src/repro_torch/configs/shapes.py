"""Assigned input shapes, as plain data (the table of the JAX package's
``configs/shapes.py``).

Shapes (LM transformer family — seq_len × global_batch):

* ``train_4k``     seq_len=4 096,   global_batch=256   (training)
* ``prefill_32k``  seq_len=32 768,  global_batch=32    (inference-prefill)
* ``decode_32k``   seq_len=32 768,  global_batch=128   (inference-decode:
  one new token against a KV cache of seq_len)
* ``long_500k``    seq_len=524 288, global_batch=1     (long-context decode;
  SSM/hybrid archs only — pure full-attention archs skip)

The JAX package's ``input_specs`` functions, which make the dry run's
``jax.ShapeDtypeStruct`` stand-ins, have no counterpart here yet: they
come with the port's dry run.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def get_shape(name: str) -> ShapeSpec:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether (arch × shape) is an assigned cell; reason when not."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "long_500k requires sub-quadratic attention (SSM/hybrid only)"
    return True, ""
