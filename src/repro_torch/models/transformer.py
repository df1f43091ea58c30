"""Decoder-only transformer LM, dense GQA family (qwen2-0.5b, smollm-360m):
the training forward, the loss and the paged decode path of the JAX
package's ``models/transformer.py``.

Layers are stacked on a leading ``layers`` axis, as in the JAX package,
and run by a Python loop over the layer index where the JAX package uses
``jax.lax.scan``.  ``cfg.remat_policy="full"`` checkpoints each layer
(``torch.utils.checkpoint``, non-reentrant) where the JAX package wraps
the scanned body in ``jax.checkpoint``.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.moe is not None or cfg.pad_heads_to:
        raise NotImplementedError(
            f"{cfg.name}: only the dense family without head padding is "
            f"ported (family={cfg.family!r})")
    if cfg.kv_cache_dtype != "bf16":
        raise NotImplementedError(
            f"{cfg.name}: kv_cache_dtype={cfg.kv_cache_dtype!r} is not ported")


# ---------------------------------------------------------------------------
# Parameter spec
# ---------------------------------------------------------------------------

NORM_KEYS = ("ln1", "ln2", "final_norm")   # f32 scales, read as f32 by rmsnorm


def param_spec(cfg: ModelConfig):
    _check_ported(cfg)
    D, V, NL = cfg.d_model, cfg.vocab_size, cfg.num_layers
    layer = {
        "attn": L.attn_spec(cfg, layers=NL),
        "ln1": L.PSpec((NL, D), ("layers", "embed_nofsdp"), init="ones"),
        "ln2": L.PSpec((NL, D), ("layers", "embed_nofsdp"), init="ones"),
        "mlp": L.mlp_spec(cfg, layers=NL),
    }
    spec = {
        "embed": L.PSpec((V, D), ("vocab", "embed"), init="embed"),
        "layers": layer,
        "final_norm": L.PSpec((D,), ("embed_nofsdp",), init="ones"),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = L.PSpec((D, V), ("embed", "vocab"), fan_in=D)
    return spec


def init_params(cfg: ModelConfig, generator: torch.Generator):
    """Random parameters in ``cfg.param_dtype`` on the generator's device."""
    return L.init_tree(param_spec(cfg), generator,
                       L.torch_dtype(cfg.param_dtype))


def cast_params(cfg: ModelConfig, params):
    """Cast every weight except the norm scales to the compute dtype once,
    at load time.  Numerically the same as the per-op casts in
    ``attn_qkv``, ``mlp_apply``, ``embed_tokens`` and ``unembed`` (which
    then cast nothing); the norm scales stay f32, as the kernel reads them."""
    dt = L.torch_dtype(cfg.dtype)

    def walk(tree, key=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return tree if key in NORM_KEYS else tree.to(dt)

    return walk(params)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_tokens(params, cfg: ModelConfig, tokens):
    return params["embed"][tokens].to(L.torch_dtype(cfg.dtype))


def unembed(params, cfg: ModelConfig, x):
    if cfg.tie_embeddings:
        logits = torch.matmul(x, params["embed"].to(x.dtype).t())
    else:
        logits = torch.matmul(x, params["lm_head"].to(x.dtype))
    return L.softcap(logits.float(), cfg.logit_softcap)


# ---------------------------------------------------------------------------
# Forward (train / prefill) + loss
# ---------------------------------------------------------------------------

def _remat(fn, cfg: ModelConfig):
    """``fn`` as the layer's checkpoint policy runs it.  "full" keeps only
    the layer's inputs and recomputes its forward in the backward (every
    kernel of the layer launches again there); it applies only while
    autograd records."""
    if cfg.remat_policy == "none":
        return fn
    if cfg.remat_policy != "full":
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r} is not ported (only 'none' "
            f"and 'full')")

    def checkpointed(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        # the layer draws no random numbers: no RNG state to stash
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False)

    return checkpointed


def _layer_fwd(cfg: ModelConfig, x, lp, positions):
    h = L.rmsnorm(x, lp["ln1"], cfg.rms_norm_eps)
    q, k, v = L.attn_qkv(lp["attn"], h, positions, cfg)
    o = L.attention_dispatch(cfg, q, k, v, causal=True)
    x = x + L.attn_out(lp["attn"], o)
    h = L.rmsnorm(x, lp["ln2"], cfg.rms_norm_eps)
    return x + L.mlp_apply(lp["mlp"], h)


def forward_hidden(params, cfg: ModelConfig, tokens):
    """tokens [B, S] -> (final normed hidden [B,S,D], aux loss: 0 for the
    dense family)."""
    _check_ported(cfg)
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    body = _remat(lambda x_, lp_: _layer_fwd(cfg, x_, lp_, positions), cfg)
    for li in range(cfg.num_layers):
        x = body(x, _layer_params(params["layers"], li))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.rmsnorm(x, params["final_norm"], cfg.rms_norm_eps), aux


def forward(params, cfg: ModelConfig, tokens):
    """tokens [B, S] -> (logits [B, S, V] f32, aux loss)."""
    x, aux = forward_hidden(params, cfg, tokens)
    return unembed(params, cfg, x), aux


def loss_fn(params, cfg: ModelConfig, batch):
    """Mean next-token cross entropy on the plain path (f32 logits
    [B, S, V]); returns (loss, {"nll", "aux"})."""
    from repro_torch.train.losses import plain_xent
    if cfg.loss_impl != "plain":
        raise NotImplementedError(
            f"loss_impl={cfg.loss_impl!r} is not ported (only 'plain')")
    logits, aux = forward(params, cfg, batch["tokens"])
    nll = plain_xent(logits, batch["labels"])
    return nll + aux, {"nll": nll, "aux": aux}


# ---------------------------------------------------------------------------
# Paged KV cache + decode (block-table-indexed attention)
# ---------------------------------------------------------------------------
#
# A shared pool of fixed-size blocks [num_blocks, block_size] per layer;
# each decode lane carries a block *table* [max_blocks] of physical pool
# indices.  Per step the new token's K/V is written at (table[pos//bs],
# pos%bs) and attention runs over the table-gathered view
# [B, max_blocks*block_size, KVH, hd] through the flash_decode kernel with
# lengths = pos + 1: positions past pos are masked, so stale bytes in
# recycled blocks (and the shared scratch block 0 behind unallocated table
# entries) are unreachable.

PAGED_HAS_BLOCKS = True     # per-position KV: sequences occupy pool blocks


def paged_cache_spec(cfg: ModelConfig, lanes: int, num_blocks: int,
                     block_size: int):
    _check_ported(cfg)
    NL, KVH = cfg.num_layers, cfg.num_kv_heads
    hd = cfg.resolved_head_dim()
    axes = ("layers", None, "cache_seq", "act_kv_heads", "head_dim")
    shape = (NL, num_blocks, block_size, KVH, hd)
    dt = L.torch_dtype(cfg.dtype)
    return {
        "k": L.PSpec(shape, axes, init="zeros", dtype=dt),
        "v": L.PSpec(shape, axes, init="zeros", dtype=dt),
    }


def init_paged_cache(cfg: ModelConfig, lanes: int, num_blocks: int,
                     block_size: int, device):
    spec = paged_cache_spec(cfg, lanes, num_blocks, block_size)
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for k, s in spec.items()}


def reset_paged_lane(cfg: ModelConfig, cache, lane_index: int):
    # nothing lane-indexed to clear: blocks are overwritten before the
    # masked attention can reach them
    return cache


def paged_scatter(kc, vc, k_new, v_new, tables, pos):
    """Write one token's K/V [B, KVH, hd] into the pool at
    (table[pos//bs], pos%bs), IN PLACE (the JAX version is functional).

    In place is safe because the serve engine never has a prefill and a
    decode step in flight together (``_prefill_active`` and
    ``_decode_inflight`` exclude each other), a failed prefill or step
    frees the blocks it wrote, and masked positions are unreachable.
    Lanes whose table entry is the scratch block (idle lanes) land at
    physical block 0 — never gathered by a live table, so the duplicate
    writes are harmless."""
    B = k_new.shape[0]
    bs = kc.shape[1]
    phys = tables[torch.arange(B, device=tables.device), pos // bs]
    off = pos % bs
    kc[phys, off] = k_new
    vc[phys, off] = v_new
    return kc, vc


def _paged_view(pool, tables):
    """Gather [num_blocks, bs, ...] through tables [B, max_blocks] into
    the per-lane contiguous view [B, max_blocks*bs, ...]."""
    B, nb = tables.shape
    v = pool[tables]
    return v.reshape((B, nb * v.shape[2]) + tuple(v.shape[3:]))


def _layer_decode_paged(cfg: ModelConfig, x, lp, kc, vc, pos, tables):
    """One decoded token through one layer against the paged pool.
    x: [B,1,D]; kc/vc: [num_blocks, bs, KVH, hd]; tables: [B, max_blocks]."""
    h = L.rmsnorm(x, lp["ln1"], cfg.rms_norm_eps)
    q, k_new, v_new = L.attn_qkv(lp["attn"], h, pos[:, None], cfg)
    kc, vc = paged_scatter(kc, vc, k_new[:, 0], v_new[:, 0], tables, pos)
    k_use = _paged_view(kc, tables)
    v_use = _paged_view(vc, tables)
    o = L.decode_attention(q, k_use, v_use, pos, logit_cap=cfg.logit_softcap)
    x = x + L.attn_out(lp["attn"], o)
    h = L.rmsnorm(x, lp["ln2"], cfg.rms_norm_eps)
    y = L.mlp_apply(lp["mlp"], h)
    return x + y, kc, vc


def _layer_params(tree, li: int):
    if isinstance(tree, dict):
        return {k: _layer_params(v, li) for k, v in tree.items()}
    return tree[li]


def decode_step_paged(params, cfg: ModelConfig, cache, tokens, pos, tables,
                      fed=None):
    """tokens [B,1], pos [B], tables [B,max_blocks] -> (logits [B,1,V] f32,
    cache).  The pool is updated in place and returned.  ``fed`` is
    unused: attention KV at a non-fed lane's next-write position is
    overwritten by its next real token before the mask ever exposes it."""
    x, cache = decode_hidden_paged(params, cfg, cache, tokens, pos, tables,
                                   fed)
    return unembed(params, cfg, x), cache


def decode_hidden_paged(params, cfg: ModelConfig, cache, tokens, pos, tables,
                        fed=None):
    """Paged decode step up to (and including) the final norm."""
    del fed
    x = embed_tokens(params, cfg, tokens)
    for li in range(cfg.num_layers):
        lp = _layer_params(params["layers"], li)
        x, _, _ = _layer_decode_paged(cfg, x, lp, cache["k"][li],
                                      cache["v"][li], pos, tables)
    x = L.rmsnorm(x, params["final_norm"], cfg.rms_norm_eps)
    return x, cache
