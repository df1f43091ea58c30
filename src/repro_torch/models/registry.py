"""Uniform model API across families (the entries the train and serve
paths call) + analytical parameter/FLOP counts.

The dense and ssm families are ported; the others raise
``NotImplementedError`` naming the family."""
from __future__ import annotations

import math
from types import ModuleType

from repro_torch.configs.base import ModelConfig
from repro_torch.models import mamba, transformer

_MODULES = {"dense": transformer, "ssm": mamba}


def module_for(cfg: ModelConfig) -> ModuleType:
    if cfg.family not in _MODULES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    return _MODULES[cfg.family]


def init_params(cfg, generator):
    return module_for(cfg).init_params(cfg, generator)


def cast_params(cfg, params):
    return module_for(cfg).cast_params(cfg, params)


def loss_fn(params, cfg, batch):
    return module_for(cfg).loss_fn(params, cfg, batch)


def forward(params, cfg, batch):
    return module_for(cfg).forward(params, cfg, batch["tokens"])


# ---------------------------------------------------------------------------
# Analytical counts (model FLOPs)
# ---------------------------------------------------------------------------

def param_count(cfg: ModelConfig) -> int:
    from repro_torch.models.layers import tree_leaves
    return sum(math.prod(spec.shape)
               for _, spec in tree_leaves(module_for(cfg).param_spec(cfg)))


def model_flops(cfg: ModelConfig, tokens: int, *, training: bool,
                include_attention: bool = True, seq_len: int = 0,
                decode_cache_len: int = 0) -> float:
    """Canonical 6·N·D (train) / 2·N·D (inference) + the kernel terms, as
    the JAX package's ``registry.model_flops`` counts them for the dense
    and ssm families: attention 2·2·S²·H·hd per layer per sequence for
    scores and values, halved by the causal mask, times 3 in training,
    and for decode the cache length per produced token; SSD 2·Q·nh·hp
    (intra-chunk) + 4·nh·hp·ds (state and output) per token per layer,
    times 3 in training."""
    flops = (6.0 if training else 2.0) * param_count(cfg) * tokens
    if include_attention and cfg.ssm is not None and seq_len:
        _, nh, hp, ds = mamba.dims(cfg)
        per_tok = 2 * cfg.ssm.chunk_size * nh * hp + 4 * nh * hp * ds
        flops += (3.0 if training else 1.0) * tokens * cfg.num_layers \
            * per_tok
    if include_attention and cfg.num_heads:
        hd = cfg.resolved_head_dim()
        if seq_len:
            batch = tokens / max(seq_len, 1)
            per_layer = 2 * 2 * seq_len * seq_len * cfg.num_heads * hd / 2
            flops += (3.0 if training else 1.0) * batch * cfg.num_layers \
                * per_layer
        if decode_cache_len:
            flops += tokens * cfg.num_layers * (
                2 * 2 * decode_cache_len * cfg.num_heads * hd)
    return float(flops)


# ---------------------------------------------------------------------------
# Paged decode (block-table-indexed KV cache; see serve/kvcache.py)
# ---------------------------------------------------------------------------

def supports_paged(cfg: ModelConfig) -> bool:
    """True iff the family is ported and implements paged decode."""
    return (cfg.family in _MODULES
            and hasattr(module_for(cfg), "decode_step_paged"))


def paged_has_blocks(cfg: ModelConfig) -> bool:
    """True iff the paged cache pages KV by position (attention families)."""
    return bool(getattr(module_for(cfg), "PAGED_HAS_BLOCKS", False))


def init_paged_cache(cfg, lanes, num_blocks, block_size, device):
    return module_for(cfg).init_paged_cache(cfg, lanes, num_blocks,
                                            block_size, device)


def decode_step_paged(params, cfg, cache, tokens, pos, tables, fed=None):
    return module_for(cfg).decode_step_paged(params, cfg, cache, tokens,
                                             pos, tables, fed)


def decode_hidden_paged(params, cfg, cache, tokens, pos, tables, fed=None):
    return module_for(cfg).decode_hidden_paged(params, cfg, cache, tokens,
                                               pos, tables, fed)


def reset_paged_lane(cfg, cache, lane_index):
    return module_for(cfg).reset_paged_lane(cfg, cache, lane_index)
