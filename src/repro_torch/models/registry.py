"""Uniform model API across families (the entries the train and serve
paths call) + analytical parameter/FLOP counts.

Every family of the JAX registry is ported: dense, moe and vlm (the
transformer), ssm (mamba), hybrid and audio (the encoder-decoder).  An
entry a family lacks raises as the JAX registry's does: the
encoder-decoder has no ``decode_hidden`` and no paged decode."""
from __future__ import annotations

import math
from types import ModuleType

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, hybrid, mamba, transformer

_MODULES = {"dense": transformer, "moe": transformer, "vlm": transformer,
            "ssm": mamba, "hybrid": hybrid, "audio": encdec}


def module_for(cfg: ModelConfig) -> ModuleType:
    if cfg.family not in _MODULES:
        raise ValueError(cfg.family)
    return _MODULES[cfg.family]


def init_params(cfg, generator):
    return module_for(cfg).init_params(cfg, generator)


def cast_params(cfg, params):
    return module_for(cfg).cast_params(cfg, params)


def loss_fn(params, cfg, batch):
    from repro_torch.models.layers import training_mode
    with training_mode():
        return module_for(cfg).loss_fn(params, cfg, batch)


def loss_fn_rows(params_rows, cfg, batches, contexts):
    """``loss_fn`` over D data rows in lockstep, each row on a device of
    its own (``transformer.loss_fn_rows``: the moe family, whose groups
    may span rows): each row's ``(loss, metrics)``."""
    from repro_torch.models.layers import training_mode
    with training_mode():
        return transformer.loss_fn_rows(params_rows, cfg, batches, contexts)


def forward(params, cfg, batch):
    m = module_for(cfg)
    if cfg.is_encoder_decoder:
        return m.forward(params, cfg, batch["tokens"], batch["encoder_embeds"])
    if cfg.frontend_stub == "vision" and "vision_embeds" in batch:
        return m.forward(params, cfg, batch["tokens"],
                         vision_embeds=batch["vision_embeds"])
    return m.forward(params, cfg, batch["tokens"])


# ---------------------------------------------------------------------------
# Slot-cache decode (one max_seq row per lane; see serve/kvcache.SlotCache)
# ---------------------------------------------------------------------------

def decode_step(params, cfg, cache, tokens, pos, fed=None):
    """``fed`` [B] bool (optional): lanes not fed a real token this call
    — the ssm and hybrid families freeze their recurrent state; the
    attention-only families ignore it (their KV writes are safe)."""
    return module_for(cfg).decode_step(params, cfg, cache, tokens, pos, fed)


def decode_hidden(params, cfg, cache, tokens, pos, fed=None):
    """Decode up to the final norm (no unembed).  Raises for the
    encoder-decoder family, whose decode step has its own unembed."""
    m = module_for(cfg)
    if not hasattr(m, "decode_hidden"):
        raise NotImplementedError(
            f"decode_hidden not supported for family {cfg.family!r}")
    return m.decode_hidden(params, cfg, cache, tokens, pos, fed)


def decode_step_q(qparams, cfg, cache, tokens, pos, fed=None):
    """``decode_step`` on int8 weights: the tree of ``quantize_tree`` is
    dequantized to the compute dtype, then decoded — the body of the JAX
    package's ``serve_step_q`` (``launch/steps.py``)."""
    from repro_torch.models.layers import torch_dtype
    from repro_torch.serve.quantization import dequantize_tree
    params = dequantize_tree(qparams, torch_dtype(cfg.dtype))
    return decode_step(params, cfg, cache, tokens, pos, fed)


def param_spec(cfg):
    return module_for(cfg).param_spec(cfg)


def param_shapes(cfg):
    """The parameter tree as ``meta`` tensors in ``cfg.param_dtype`` (a
    leaf's own dtype where its spec names one)."""
    from repro_torch.models.layers import shapes_tree, torch_dtype
    return shapes_tree(param_spec(cfg), torch_dtype(cfg.param_dtype))


def param_axes(cfg):
    """The parameter tree's logical-axis tuples."""
    from repro_torch.models.layers import axes_tree
    return axes_tree(param_spec(cfg))


def init_cache(cfg, batch, max_seq, device):
    return module_for(cfg).init_cache(cfg, batch, max_seq, device)


def cache_shapes(cfg, batch, max_seq):
    """The slot cache's leaves as ``meta`` tensors (shapes and dtypes)."""
    return module_for(cfg).cache_shapes(cfg, batch, max_seq)


def cache_axes(cfg, batch, max_seq):
    """The slot cache's logical-axis tuples."""
    from repro_torch.models.layers import axes_tree
    return axes_tree(module_for(cfg).cache_spec(cfg, batch, max_seq))


def reset_cache_lane(cfg, cache, lane_index):
    """Zero one lane's recurrent state in the slot cache (ssm and hybrid
    families) — a recycled slot must not leak its previous occupant's
    state.  No-op for the attention-only families (KV rows are
    position-indexed and overwritten before the mask exposes them)."""
    m = module_for(cfg)
    if hasattr(m, "reset_cache_lane"):
        return m.reset_cache_lane(cfg, cache, lane_index)
    return cache


# ---------------------------------------------------------------------------
# Analytical counts (model FLOPs)
# ---------------------------------------------------------------------------

def _spec_leaves_with_path(cfg):
    from repro_torch.models.layers import tree_leaves
    return [("/".join(path), spec)
            for path, spec in tree_leaves(param_spec(cfg))]


def _leaf_count(cfg: ModelConfig, path: str, spec, active_only: bool) -> int:
    """A leaf's parameters; with ``active_only`` an expert leaf counts the
    top_k of its num_experts experts a token reaches (the router counts
    whole)."""
    n = math.prod(spec.shape)
    if active_only and cfg.moe is not None and "/moe/" in f"/{path}/" \
            and "router" not in path:
        n = int(n * cfg.moe.top_k / cfg.moe.num_experts)
    return n


def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameters of ``cfg``'s tree (``active_only``: per token)."""
    return sum(_leaf_count(cfg, path, spec, active_only)
               for path, spec in _spec_leaves_with_path(cfg))


def non_embedding_param_count(cfg: ModelConfig,
                              active_only: bool = False) -> int:
    """``param_count`` without the embedding and the untied ``lm_head``."""
    return sum(_leaf_count(cfg, path, spec, active_only)
               for path, spec in _spec_leaves_with_path(cfg)
               if "embed" not in path.split("/")[-1] and "lm_head" not in path)


def _encoder_param_count(cfg: ModelConfig) -> int:
    """Parameters of the encoder (the encoder-decoder family's)."""
    return sum(math.prod(spec.shape)
               for path, spec in _spec_leaves_with_path(cfg)
               if path.startswith("encoder/") or "/encoder/" in path)


def model_flops(cfg: ModelConfig, tokens: int, *, training: bool,
                include_attention: bool = True, seq_len: int = 0,
                decode_cache_len: int = 0) -> float:
    """Canonical 6·N·D (train) / 2·N·D (inference), N the parameters a
    token reaches (an MoE layer's top_k experts; the encoder's run over
    ``encoder_frames`` a sequence), + the kernel terms, as the JAX
    package's ``registry.model_flops`` counts them: attention 2·2·S²·H·hd
    per layer per sequence for scores and values, halved by the causal
    mask (the encoder's and the cross-attention's are not), times 3 in
    training, over the hybrid's attention sites only; for decode the
    cache length per produced token; SSD 2·Q·nh·hp (intra-chunk) +
    4·nh·hp·ds (state and output) per token per layer, times 3 in
    training."""
    n_active = param_count(cfg, active_only=True)
    mult = 6.0 if training else 2.0
    if cfg.is_encoder_decoder and seq_len:
        # encoder params run over `encoder_frames` tokens, not seq_len
        enc = _encoder_param_count(cfg)
        batch = tokens / max(seq_len, 1)
        flops = mult * ((n_active - enc) * tokens
                        + enc * batch * cfg.encoder_frames)
    else:
        flops = mult * n_active * tokens
    if include_attention:
        hd = cfg.resolved_head_dim() if cfg.num_heads else 0
        att_layers = cfg.num_layers + cfg.num_encoder_layers
        if cfg.family == "hybrid":
            att_layers = cfg.num_layers // max(cfg.shared_attn_every, 1)
        if cfg.num_heads and seq_len:
            batch = tokens / max(seq_len, 1)
            k = 3.0 if training else 1.0
            if cfg.is_encoder_decoder:
                F = cfg.encoder_frames
                dec = (2 * 2 * seq_len * seq_len / 2      # causal self
                       + 2 * 2 * seq_len * F)             # cross
                enc = 2 * 2 * F * F
                flops += k * batch * cfg.num_heads * hd * (
                    cfg.num_layers * dec + cfg.num_encoder_layers * enc)
            else:
                per_layer = 2 * 2 * seq_len * seq_len * cfg.num_heads * hd / 2
                flops += k * batch * att_layers * per_layer
        if cfg.num_heads and decode_cache_len:
            per_tok = 2 * 2 * decode_cache_len * cfg.num_heads * hd
            flops += tokens * att_layers * per_tok
        if cfg.ssm is not None and seq_len:
            _, nh, hp, ds = mamba.dims(cfg)
            Q = cfg.ssm.chunk_size
            per_tok = 2 * Q * nh * hp + 4 * nh * hp * ds
            flops += (3.0 if training else 1.0) * tokens * cfg.num_layers \
                * per_tok
    return float(flops)


# ---------------------------------------------------------------------------
# Paged decode (block-table-indexed KV cache; see serve/kvcache.py)
# ---------------------------------------------------------------------------

def supports_paged(cfg: ModelConfig) -> bool:
    """True iff the family implements the paged decode entry points."""
    return hasattr(module_for(cfg), "decode_step_paged")


def paged_has_blocks(cfg: ModelConfig) -> bool:
    """True iff the paged cache pages KV by position (attention families)."""
    return bool(getattr(module_for(cfg), "PAGED_HAS_BLOCKS", False))


def init_paged_cache(cfg, lanes, num_blocks, block_size, device):
    m = module_for(cfg)
    if not hasattr(m, "init_paged_cache"):
        raise NotImplementedError(
            f"paged decode not supported for family {cfg.family!r}")
    return m.init_paged_cache(cfg, lanes, num_blocks, block_size, device)


def decode_step_paged(params, cfg, cache, tokens, pos, tables, fed=None):
    return module_for(cfg).decode_step_paged(params, cfg, cache, tokens,
                                             pos, tables, fed)


def decode_hidden_paged(params, cfg, cache, tokens, pos, tables, fed=None):
    m = module_for(cfg)
    if not hasattr(m, "decode_hidden_paged"):
        raise NotImplementedError(
            f"decode_hidden_paged not supported for family {cfg.family!r}")
    return m.decode_hidden_paged(params, cfg, cache, tokens, pos, tables, fed)


def reset_paged_lane(cfg, cache, lane_index):
    return module_for(cfg).reset_paged_lane(cfg, cache, lane_index)


def unembed_partial(params, cfg, x, vocab_start, vocab_len):
    """Vocab-parallel unembed slice (see ``transformer.unembed_partial``);
    every family with ``decode_hidden`` unembeds through the
    transformer's table."""
    module_for(cfg)
    return transformer.unembed_partial(params, cfg, x, vocab_start,
                                       vocab_len)


def unembed_ranks(params, cfg, x, n):
    """All n ranks' ``unembed_partial`` slices stacked, [n, ..., V/n]
    (see ``transformer.unembed_ranks``)."""
    module_for(cfg)
    return transformer.unembed_ranks(params, cfg, x, n)
