"""Uniform model API across families (the entries the serve path calls).

Only the dense family is ported; the others raise ``NotImplementedError``
naming the family."""
from __future__ import annotations

from types import ModuleType

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

_MODULES = {"dense": transformer}


def module_for(cfg: ModelConfig) -> ModuleType:
    if cfg.family not in _MODULES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    return _MODULES[cfg.family]


def init_params(cfg, generator):
    return module_for(cfg).init_params(cfg, generator)


def cast_params(cfg, params):
    return module_for(cfg).cast_params(cfg, params)


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
