"""Assigned input shapes, as plain data (the table of the JAX package's
``configs/shapes.py``).

Shapes (LM transformer family — seq_len × global_batch):

* ``train_4k``     seq_len=4 096,   global_batch=256   (training)
* ``prefill_32k``  seq_len=32 768,  global_batch=32    (inference-prefill)
* ``decode_32k``   seq_len=32 768,  global_batch=128   (inference-decode:
  one new token against a KV cache of seq_len)
* ``long_500k``    seq_len=524 288, global_batch=1     (long-context decode;
  SSM/hybrid archs only — pure full-attention archs skip)

``decode_*`` / ``long_*`` run ``serve_step``, ``train_4k`` runs
``train_step`` and ``prefill_32k`` ``prefill_step``
(``launch/steps.py``).  ``input_specs`` gives every model input of a
cell as a tensor on the ``meta`` device: the counterpart of the JAX
package's ``jax.ShapeDtypeStruct`` stand-ins, with no storage.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

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


def meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict[str, torch.Tensor]:
    """``meta`` stand-ins for every model input of this cell: the keys,
    shapes and dtypes of the JAX package's ``input_specs``."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        S_text = S
        batch: dict[str, torch.Tensor] = {}
        from repro_torch.models.transformer import VISION_PATCHES
        if cfg.frontend_stub == "vision" and S >= VISION_PATCHES:
            # one image (precomputed patch embeddings) per sequence; total
            # sequence length stays at the assigned S.  A shorter sequence
            # holds no image: text only, as the train launchers feed it
            # (the JAX stand-in's text length would be negative there)
            S_text = S - VISION_PATCHES
            batch["vision_embeds"] = meta((B, VISION_PATCHES, cfg.d_model),
                                          torch.bfloat16)
        batch["tokens"] = meta((B, S_text), torch.int32)
        if cfg.is_encoder_decoder:
            batch["encoder_embeds"] = meta(
                (B, cfg.encoder_frames, cfg.d_model), torch.bfloat16)
        if shape.kind == "train":
            batch["labels"] = meta((B, S_text), torch.int32)
        return batch
    if shape.kind == "decode":
        # one new token against a cache of S (the cache's stand-ins come
        # from ``registry.cache_shapes``)
        return {"tokens": meta((B, 1), torch.int32),
                "pos": meta((B,), torch.int32)}
    raise ValueError(shape.kind)
