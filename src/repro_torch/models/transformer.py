"""Decoder-only transformer LM, the dense GQA family (qwen2-0.5b,
qwen2.5-3b, smollm-360m, llama3-405b), the MoE family
(granite-moe-3b-a800m, grok-1-314b) and the vlm backbone (pixtral-12b,
whose vision frontend is a stub: precomputed patch embeddings go in
before the text): the JAX package's ``models/transformer.py`` — the
training forward
under every checkpoint policy with the MoE aux loss summed over the
layers, the plain and the vocab-chunked loss, head padding, a logit cap
in attention and on the logits, and decode on the slot cache and on the
paged pool, with K/V in the compute dtype or in int8 with per-position
scales, and the vocab-parallel unembed of sharded serving
(``unembed_partial``, ``unembed_ranks``).

Layers are stacked on a leading ``layers`` axis, as in the JAX package,
and run by a Python loop over the layer index where the JAX package uses
``jax.lax.scan``.  ``cfg.remat_policy`` checkpoints with
``torch.utils.checkpoint`` (non-reentrant) where the JAX package uses
``jax.checkpoint`` (``layers.checkpoint``).  The caches are updated in
place where the JAX package returns new ones.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.sharding import shard_hint


VISION_PATCHES = 1024  # the stub vision frontend: one 1024-patch image a sequence


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"{cfg.name}: the transformer takes the dense, moe and vlm "
            f"families (family={cfg.family!r})")


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
    }
    if cfg.moe is not None:
        layer["moe"] = L.moe_spec(cfg, layers=NL)
    else:
        layer["mlp"] = L.mlp_spec(cfg, layers=NL)
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

def embed_tokens(params, cfg: ModelConfig, tokens, vision_embeds=None):
    """tokens [B, S] -> [B, S, D] in the compute dtype; ``vision_embeds``
    [B, P, D] (the vlm stub's patches) go before the text: [B, P+S, D]."""
    dt = L.torch_dtype(cfg.dtype)
    x = params["embed"][tokens].to(dt)
    if vision_embeds is not None:
        x = torch.cat([vision_embeds.to(dt), x], dim=1)
    return x


def unembed(params, cfg: ModelConfig, x):
    if cfg.tie_embeddings:
        logits = torch.matmul(x, params["embed"].to(x.dtype).t())
    else:
        logits = torch.matmul(x, params["lm_head"].to(x.dtype))
    logits = L.softcap(logits.float(), cfg.logit_softcap)
    return shard_hint(logits, "batch", "act_seq", "act_vocab")


def unembed_partial(params, cfg: ModelConfig, x, vocab_start: int,
                    vocab_len: int):
    """Vocab-parallel unembed: f32 logits for ``vocab_len`` vocabulary
    rows starting at ``vocab_start`` — one rank's slice of the
    tensor-parallel output projection.  The full logits are the
    rank-order concatenation of the slices.  Softcap is elementwise, so
    slicing before it is exact."""
    stop = vocab_start + vocab_len
    if cfg.tie_embeddings:
        w = params["embed"][vocab_start:stop]
        logits = torch.matmul(x, w.to(x.dtype).t())
    else:
        w = params["lm_head"][:, vocab_start:stop]
        logits = torch.matmul(x, w.to(x.dtype))
    return L.softcap(logits.float(), cfg.logit_softcap)


def unembed_ranks(params, cfg: ModelConfig, x, n: int):
    """Every rank's ``unembed_partial`` at once: x [..., D] -> f32
    [n, ..., V/n], row r the slice rank r of an n-way model axis computes
    (vocabulary rows r·V/n .. (r+1)·V/n), as one batched product over the
    table viewed [n, V/n, D] (tied) or [n, D, V/n] (``lm_head``)."""
    V, D = cfg.vocab_size, x.shape[-1]
    if V % n:
        raise ValueError(f"vocab_size {V} is not divisible by {n} ranks")
    if cfg.tie_embeddings:
        w = params["embed"].view(n, V // n, D).transpose(1, 2)
    else:
        w = params["lm_head"].view(D, n, V // n).transpose(0, 1)
    logits = torch.matmul(x.reshape(-1, D), w.to(x.dtype))
    logits = logits.view((n,) + tuple(x.shape[:-1]) + (V // n,))
    return L.softcap(logits.float(), cfg.logit_softcap)


# ---------------------------------------------------------------------------
# Forward (train / prefill) + loss
# ---------------------------------------------------------------------------

def _remat(fn, cfg: ModelConfig):
    """``fn`` (a whole layer) as the checkpoint policy runs it: "full"
    keeps only the layer's inputs and recomputes its forward in the
    backward, "dots" keeps the matrix products' outputs too; "none",
    "subblock" and "attn_only" run it as it is ("subblock" and
    "attn_only" checkpoint inside the layer, ``_layer_fwd``)."""
    if cfg.remat_policy in ("none", "subblock", "attn_only"):
        return fn
    dots = cfg.remat_policy == "dots"
    return lambda *args: L.checkpoint(fn, *args, dots=dots)


def _ffn(cfg: ModelConfig, lp, h):
    """The layer's feed-forward block: (y, aux) with the MoE layer's aux
    loss, (y, None) for the dense MLP (whose aux is zero)."""
    if cfg.moe is not None:
        return L.moe_apply(lp["moe"], h, cfg)
    return L.mlp_apply(lp["mlp"], h), None


def _attn_half(cfg: ModelConfig, x, lp, positions):
    """The layer before its feed-forward block: (x + attention, the
    normed input of the feed-forward block)."""
    h = L.rmsnorm(x, lp["ln1"], cfg.rms_norm_eps)
    q, k, v = L.attn_qkv(lp["attn"], h, positions, cfg)
    if cfg.remat_policy == "attn_only":
        # recompute only the attention in the backward: the projections
        # and the MLP keep their residuals
        o = L.checkpoint(lambda q_, k_, v_: L.attention_dispatch(
            cfg, q_, k_, v_, causal=True), q, k, v)
    else:
        o = L.attention_dispatch(cfg, q, k, v, causal=True)
    return _out_half(cfg, x, o, lp)


def _out_half(cfg: ModelConfig, x, o, lp):
    """The attention's out-projection added to ``x``, and its norm."""
    x = x + L.attn_out(lp["attn"], o)
    return x, L.rmsnorm(x, lp["ln2"], cfg.rms_norm_eps)


def _qkv(cfg: ModelConfig, x, lp, positions):
    h = L.rmsnorm(x, lp["ln1"], cfg.rms_norm_eps)
    return L.attn_qkv(lp["attn"], h, positions, cfg)


def _layer_fwd(cfg: ModelConfig, x, lp, positions):
    """One layer: (x, aux), aux None for a dense layer."""
    if cfg.remat_policy == "subblock":
        return _layer_fwd_subblock(cfg, x, lp, positions)
    x, h = _attn_half(cfg, x, lp, positions)
    y, aux = _ffn(cfg, lp, h)
    return x + y, aux


def _layer_fwd_subblock(cfg: ModelConfig, x, lp, positions):
    """Checkpoint the projection and MLP sub-blocks but not the attention,
    which keeps its residuals and is not run again in the backward."""
    q, k, v = L.checkpoint(lambda x_, lp_: _qkv(cfg, x_, lp_, positions),
                           x, lp)
    o = L.attention_dispatch(cfg, q, k, v, causal=True)

    def rest_fn(x_, o_, lp_):
        x_, h = _out_half(cfg, x_, o_, lp_)
        y, aux = _ffn(cfg, lp_, h)
        return x_ + y, aux

    return L.checkpoint(rest_fn, x, o, lp)


def forward_hidden(params, cfg: ModelConfig, tokens, vision_embeds=None):
    """tokens [B, S_text] -> (final normed hidden [B,S,D], aux loss): the
    MoE layers' aux losses summed in layer order from an f32 zero, as the
    JAX scan carries them; 0 for the dense family.  With
    ``vision_embeds`` [B, P, D], S = P + S_text."""
    _check_ported(cfg)
    x = embed_tokens(params, cfg, tokens, vision_embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    body = _remat(lambda x_, lp_: _layer_fwd(cfg, x_, lp_, positions), cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in L.unstack_layers(params["layers"]):
        x, a = body(x, lp)
        if a is not None:
            aux = aux + a
    return L.rmsnorm(x, params["final_norm"], cfg.rms_norm_eps), aux


def forward(params, cfg: ModelConfig, tokens, vision_embeds=None):
    """tokens [B, S_text] -> (logits [B, S, V] f32, aux loss)."""
    x, aux = forward_hidden(params, cfg, tokens, vision_embeds)
    return unembed(params, cfg, x), aux


def _nll(params, cfg: ModelConfig, x, labels):
    """The mean next-token cross entropy of the final normed hidden
    ``x``, over its last ``labels.shape[1]`` positions (vlm: the text).
    ``cfg.loss_impl="chunked_vocab"`` without a logit softcap goes through
    ``chunked_vocab_xent`` over the unembedding table (``embed`` when
    tied, ``lm_head`` read transposed when not) and never builds the
    [B, S, V] logits; every other case is the plain f32 logits path, as
    in the JAX ``loss_fn``."""
    from repro_torch.train.losses import chunked_vocab_xent, plain_xent
    if cfg.loss_impl == "chunked_vocab" and not cfg.logit_softcap:
        if x.shape[1] != labels.shape[1]:       # vlm: the text positions
            x = x[:, -labels.shape[1]:]
        if cfg.tie_embeddings:
            return chunked_vocab_xent(x, params["embed"], labels,
                                      cfg.loss_vocab_chunk, False)
        return chunked_vocab_xent(x, params["lm_head"], labels,
                                  cfg.loss_vocab_chunk, True)
    logits = unembed(params, cfg, x)
    if logits.shape[1] != labels.shape[1]:      # vlm: the text positions
        logits = logits[:, -labels.shape[1]:]
    return plain_xent(logits, labels)


def loss_fn(params, cfg: ModelConfig, batch):
    """Mean next-token cross entropy (``_nll``) plus the MoE aux loss;
    returns (loss, {"nll", "aux"}).  With ``batch["vision_embeds"]``
    (vlm) the loss is over the text positions."""
    x, aux = forward_hidden(params, cfg, batch["tokens"],
                            batch.get("vision_embeds"))
    nll = _nll(params, cfg, x, batch["labels"])
    return nll + aux, {"nll": nll, "aux": aux}


def loss_fn_rows(params_rows: list, cfg: ModelConfig, batches: list,
                 contexts: list) -> list:
    """``loss_fn`` of the MoE family over D data rows in lockstep, each
    row on a device of its own: ``batches[d]`` is row d's contiguous
    share of one batch, ``params_rows[d]`` its copy of the weights, and
    ``contexts[d]()`` the context it computes in (its device and its
    mesh).  Returns each row's ``(loss, {"nll", "aux"})``.

    Layer by layer, every row's attention half runs in its own context
    (the ring, if any, on its own row's ranks); then the MoE step takes
    the whole batch's groups (``layers.moe_apply_rows``): each group is
    routed whole and served by the row that holds its first token, on
    that row's cards and with that row's copy of the MoE weights, and
    its outputs go back to their rows.  So every group routes as the
    batch's does, whatever rows it spans.  Row d's aux loss takes the
    batch's routed shares (``layers.moe_rows_aux``), so the rows' mean
    loss is the batch's.

    The gradients are sound by linearity.  Row d's copy of a weight
    collects the gradient of every row's loss through the work it did:
    its own tokens' attention halves and the groups it served.  So the
    copies' gradients add up to the gradient of the rows' summed loss,
    D times the batch's, whichever row served a group, and their mean
    over the D rows (``launch.train.model_columns``) is the batch's.

    A checkpointed layer ("full", "dots") is the layer over all the
    rows, and "subblock"'s second sub-block is the rows' out-projections
    and norms with the MoE step; each recompute re-enters the rows'
    contexts, so each row's norms run on its own device only, as in its
    own forward."""
    _check_ported(cfg)
    if cfg.moe is None:
        raise ValueError(f"{cfg.name}: loss_fn_rows takes the moe family")
    D = len(batches)
    xs = []
    for d in range(D):
        with contexts[d]():
            xs.append(embed_tokens(params_rows[d], cfg, batches[d]["tokens"],
                                   batches[d].get("vision_embeds")))
    positions = [torch.arange(x.shape[1], device=x.device)[None, :]
                 for x in xs]

    def moe_step(xs_, hs, lps):
        ys, stats = L.moe_apply_rows([lp["moe"] for lp in lps], hs, cfg,
                                     contexts)
        out = []
        for d in range(D):
            with contexts[d]():
                out.append(xs_[d] + ys[d])
        return out, stats

    def layer(xs_, lps):
        halves = []
        for d in range(D):
            with contexts[d]():
                halves.append(_attn_half(cfg, xs_[d], lps[d], positions[d]))
        return moe_step([x for x, _ in halves], [h for _, h in halves], lps)

    def layer_subblock(xs_, lps):
        os = []
        for d in range(D):
            with contexts[d]():
                q, k, v = L.checkpoint(
                    lambda x_, lp_, pos=positions[d]: _qkv(cfg, x_, lp_,
                                                           pos),
                    xs_[d], lps[d])
                os.append(L.attention_dispatch(cfg, q, k, v, causal=True))

        def rest(xs2, os2, lps2):
            halves = []
            for d in range(D):
                with contexts[d]():
                    halves.append(_out_half(cfg, xs2[d], os2[d], lps2[d]))
            return moe_step([x for x, _ in halves], [h for _, h in halves],
                            lps2)

        return L.checkpoint(rest, xs_, os, lps)

    body = layer_subblock if cfg.remat_policy == "subblock" else \
        _remat(layer, cfg)
    row_stats = [[] for _ in range(D)]
    for lps in zip(*(L.unstack_layers(p["layers"]) for p in params_rows)):
        xs, stats = body(xs, list(lps))
        for d in range(D):
            row_stats[d].append(stats[d])
    auxes = L.moe_rows_aux(cfg, row_stats, [x.device for x in xs])
    out = []
    for d in range(D):
        with contexts[d]():
            x = L.rmsnorm(xs[d], params_rows[d]["final_norm"],
                          cfg.rms_norm_eps)
            nll = _nll(params_rows[d], cfg, x, batches[d]["labels"])
            out.append((nll + auxes[d], {"nll": nll, "aux": auxes[d]}))
    return out


# ---------------------------------------------------------------------------
# KV caches + decode
# ---------------------------------------------------------------------------
#
# Two layouts of the same K/V.  The slot cache holds one max_seq row per
# lane, [NL, B, max_seq, KVH, hd].  The paged pool holds fixed-size
# blocks, [NL, num_blocks, block_size, KVH, hd], and each lane carries a
# block *table* [max_blocks] of physical block indices: the new token's
# K/V is written at (table[pos//bs], pos%bs) and attention runs over the
# table-gathered view [B, max_blocks*block_size, KVH, hd].  Either way
# attention reads entries 0..pos of a lane (flash_decode with lengths =
# pos + 1): positions past pos are masked, so stale bytes in recycled
# blocks (and the shared scratch block 0 behind unallocated table
# entries) are unreachable.
#
# ``kv_cache_dtype="int8"`` stores K/V as int8 with one f32 scale per
# (position, KV head), ``k_scale``/``v_scale`` [..., KVH, 1], written like
# the values; attention reads them dequantized to the compute dtype.

PAGED_HAS_BLOCKS = True     # per-position KV: sequences occupy pool blocks


def _kv_spec(cfg: ModelConfig, lead: tuple, lead_axes: tuple):
    NL = cfg.num_layers
    _, KVH = L.padded_heads(cfg)
    hd = cfg.resolved_head_dim()
    axes = ("layers",) + lead_axes + ("act_kv_heads", "head_dim")
    shape = (NL,) + lead + (KVH, hd)
    if cfg.kv_cache_dtype == "int8":
        s_axes = axes[:-1] + (None,)
        s_shape = shape[:-1] + (1,)
        return {
            "k": L.PSpec(shape, axes, init="zeros", dtype=torch.int8),
            "v": L.PSpec(shape, axes, init="zeros", dtype=torch.int8),
            "k_scale": L.PSpec(s_shape, s_axes, init="zeros",
                               dtype=torch.float32),
            "v_scale": L.PSpec(s_shape, s_axes, init="zeros",
                               dtype=torch.float32),
        }
    dt = L.torch_dtype(cfg.dtype)
    return {"k": L.PSpec(shape, axes, init="zeros", dtype=dt),
            "v": L.PSpec(shape, axes, init="zeros", dtype=dt)}


def cache_spec(cfg: ModelConfig, batch: int, max_seq: int):
    """The slot cache: [NL, batch, max_seq, KVH, hd] per leaf.  KVH is the
    padded head count (the JAX package sizes it from ``num_kv_heads``,
    so its decode under a padding that changes KVH fails on a shape)."""
    _check_ported(cfg)
    return _kv_spec(cfg, (batch, max_seq), ("cache_batch", "cache_seq"))


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device):
    return L.zeros_tree(cache_spec(cfg, batch, max_seq), device)


def cache_shapes(cfg: ModelConfig, batch: int, max_seq: int):
    return L.shapes_tree(cache_spec(cfg, batch, max_seq))


def paged_cache_spec(cfg: ModelConfig, lanes: int, num_blocks: int,
                     block_size: int):
    _check_ported(cfg)
    return _kv_spec(cfg, (num_blocks, block_size), (None, "cache_seq"))


def init_paged_cache(cfg: ModelConfig, lanes: int, num_blocks: int,
                     block_size: int, device):
    return L.zeros_tree(paged_cache_spec(cfg, lanes, num_blocks, block_size),
                        device)


def reset_paged_lane(cfg: ModelConfig, cache, lane_index: int):
    # nothing lane-indexed to clear, scales included: blocks are
    # overwritten before the masked attention can reach them
    return cache


def _quantize_kv(t):
    """t: [B,KVH,hd] -> (int8 [B,KVH,hd], f32 scale [B,KVH,1]): max|t|/127
    per (lane, head), then t / scale rounded half to even, as the JAX
    ``_quantize_kv``."""
    tf = t.float()
    scale = torch.clamp(tf.abs().amax(dim=-1, keepdim=True) / 127.0,
                        min=1e-12)
    q = torch.clamp(torch.round(tf / scale), -127, 127).to(torch.int8)
    return q, scale


def _paged_view(pool, tables):
    """Gather [num_blocks, bs, ...] through tables [B, max_blocks] into
    the per-lane contiguous view [B, max_blocks*bs, ...]."""
    B, nb = tables.shape
    v = pool[tables]
    return v.reshape((B, nb * v.shape[2]) + tuple(v.shape[3:]))


def _decode_hidden(params, cfg: ModelConfig, cache, tokens, pos, write, view):
    """One decoded token through every layer and the final norm.  Per
    layer ``write(pool, new)`` stores the token's K/V [B, KVH, hd] (or its
    int8 values and scales) IN PLACE in that layer's cache leaf, and
    ``view(pool)`` gives the [B, S, KVH, ...] the attention reads.

    In place is safe because the serve engine never has a prefill and a
    decode step in flight together (``_prefill_active`` and
    ``_decode_inflight`` exclude each other), a failed prefill or step
    frees the blocks it wrote, and masked positions are unreachable."""
    x = embed_tokens(params, cfg, tokens)
    int8 = cfg.kv_cache_dtype == "int8"
    dt = L.torch_dtype(cfg.dtype)
    for li, lp in enumerate(L.unstack_layers(params["layers"])):
        c = {k: v[li] for k, v in cache.items()}
        h = L.rmsnorm(x, lp["ln1"], cfg.rms_norm_eps)
        q, k_new, v_new = L.attn_qkv(lp["attn"], h, pos[:, None], cfg)
        kv = []
        for name, new in (("k", k_new[:, 0]), ("v", v_new[:, 0])):
            if int8:
                vals, scale = _quantize_kv(new)
                write(c[name], vals)
                write(c[name + "_scale"], scale)
                kv.append((view(c[name]).float()
                           * view(c[name + "_scale"])).to(dt))
            else:
                write(c[name], new)
                kv.append(view(c[name]))
        o = L.decode_attention(q, kv[0], kv[1], pos,
                               logit_cap=cfg.logit_softcap)
        x = x + L.attn_out(lp["attn"], o)
        h = L.rmsnorm(x, lp["ln2"], cfg.rms_norm_eps)
        x = x + _ffn(cfg, lp, h)[0]
    return L.rmsnorm(x, params["final_norm"], cfg.rms_norm_eps)


def decode_step(params, cfg: ModelConfig, cache, tokens, pos, fed=None):
    """tokens [B,1], pos [B] -> (logits [B,1,V] f32, cache) on the slot
    cache, updated in place and returned.  ``fed`` is unused: a lane's KV
    write lands at its own ``pos`` and is overwritten before the mask
    can expose it."""
    x, cache = decode_hidden(params, cfg, cache, tokens, pos, fed)
    return unembed(params, cfg, x), cache


def decode_hidden(params, cfg: ModelConfig, cache, tokens, pos, fed=None):
    """Slot-cache decode step up to (and including) the final norm."""
    del fed
    rows = torch.arange(tokens.shape[0], device=pos.device)

    def write(pool, new):
        pool[rows, pos] = new

    return _decode_hidden(params, cfg, cache, tokens, pos, write,
                          lambda pool: pool), cache


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
    """Paged decode step up to (and including) the final norm.  Lanes
    whose table entry is the scratch block (idle lanes) write to physical
    block 0, which no live table gathers."""
    del fed
    rows = torch.arange(tokens.shape[0], device=tables.device)
    bs = next(iter(cache.values())).shape[2]
    phys, off = tables[rows, pos // bs], pos % bs

    def write(pool, new):
        pool[phys, off] = new

    return _decode_hidden(params, cfg, cache, tokens, pos, write,
                          lambda pool: _paged_view(pool, tables)), cache
