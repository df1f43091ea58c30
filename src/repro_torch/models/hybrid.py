"""zamba2-style hybrid, the hybrid family (zamba2-1.2b): a Mamba2
backbone and ONE shared attention + MLP block applied after every
``shared_attn_every`` SSM layers, with per-site LoRA deltas on its q, k
and v projections — the JAX package's ``models/hybrid.py``: the training
forward under every checkpoint policy, the loss, and decode on the slot
cache and on the paged pool.  [arXiv:2411.15242]

Layout, as in the JAX package: the SSM layers are grouped as
``n_groups`` groups of ``shared_attn_every`` layers (the remainder forms
a tail without an attention site).  The shared block's parameters are
read at every site; only the LoRA factors are stacked per site.  The
JAX ``lax.scan`` over groups becomes a Python loop over groups that
reads the stacked leaves through one ``unbind`` per leaf
(``layers.unstack_layers``).  The Mamba2 blocks are ``models/mamba.py``'s
and the shared block's attention goes through ``ops.flash_attention``
(training) and ``ops.flash_decode`` (decode).

Decode writes the sites' K/V and the SSM state in place, as the port's
other families do; the K/V are kept in the compute dtype whatever
``kv_cache_dtype`` says, as in the JAX package.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import transformer as T


def group_layout(cfg: ModelConfig) -> tuple[int, int, int]:
    """(n_groups, group_size, tail) of the grouping."""
    k = cfg.shared_attn_every
    n_groups = cfg.num_layers // k
    tail = cfg.num_layers - n_groups * k
    return n_groups, k, tail


# ---------------------------------------------------------------------------
# Parameter spec
# ---------------------------------------------------------------------------

def param_spec(cfg: ModelConfig):
    D, V = cfg.d_model, cfg.vocab_size
    n_groups, k, tail = group_layout(cfg)
    spec = {
        "embed": L.PSpec((V, D), ("vocab", "embed"), init="embed"),
        # the grouped SSM blocks, [n_groups * k, ...]
        "blocks": M.block_spec(cfg, cfg.num_layers - tail),
        "block_norms": L.PSpec((cfg.num_layers - tail, D),
                               ("layers", "embed_nofsdp"), init="ones"),
        # the one shared attention + MLP block (no leading layer axis)
        "shared": {
            "attn": L.attn_spec(cfg),
            "mlp": L.mlp_spec(cfg),
            "ln1": L.PSpec((D,), ("embed_nofsdp",), init="ones"),
            "ln2": L.PSpec((D,), ("embed_nofsdp",), init="ones"),
        },
        # per-site LoRA on the shared q/k/v, stacked on the sites
        "site_lora": _lora_spec(cfg, n_groups),
        "final_norm": L.PSpec((D,), ("embed_nofsdp",), init="ones"),
    }
    if tail:
        spec["tail_blocks"] = M.block_spec(cfg, tail)
        spec["tail_norms"] = L.PSpec((tail, D), ("layers", "embed_nofsdp"),
                                     init="ones")
    if not cfg.tie_embeddings:
        spec["lm_head"] = L.PSpec((D, V), ("embed", "vocab"), fan_in=D)
    return spec


def _lora_spec(cfg: ModelConfig, n_sites: int):
    """lora_{q,k,v}_a [sites, D, r] and lora_{q,k,v}_b [sites, r, heads,
    hd]; every b starts at zero, so the deltas start at zero."""
    D, H, KVH = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim()
    r = cfg.shared_attn_lora_rank
    spec = {}
    for nm, outd, outax in (("q", (H, hd), ("heads", "head_dim")),
                            ("k", (KVH, hd), ("kv_heads", "head_dim")),
                            ("v", (KVH, hd), ("kv_heads", "head_dim"))):
        spec[f"lora_{nm}_a"] = L.PSpec((n_sites, D, r),
                                       ("layers", "embed", None), fan_in=D)
        spec[f"lora_{nm}_b"] = L.PSpec((n_sites, r) + outd,
                                       ("layers", None) + outax, init="zeros")
    return spec


def init_params(cfg: ModelConfig, generator: torch.Generator):
    """Random parameters in ``cfg.param_dtype`` on the generator's device."""
    return L.init_tree(param_spec(cfg), generator,
                       L.torch_dtype(cfg.param_dtype))


# read in f32 wherever they are used, as the JAX package reads them: the
# SSM scalars and every norm scale
F32_KEYS = M.F32_KEYS + ("tail_norms", "ln1", "ln2")


def cast_params(cfg: ModelConfig, params):
    """Cast the projections, convs, the shared block's weights, the LoRA
    factors and the embedding to the compute dtype once, at load time;
    the SSM scalars and the norm scales stay f32."""
    dt = L.torch_dtype(cfg.dtype)

    def walk(tree, key=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return tree if key in F32_KEYS else tree.to(dt)

    return walk(params)


# ---------------------------------------------------------------------------
# Forward (train / prefill) + loss
# ---------------------------------------------------------------------------

def _remat(fn, cfg: ModelConfig):
    """The JAX ``hybrid._remat``'s mapping: "none" runs ``fn`` (a whole
    group: its k mamba blocks and its site) as it is, "dots" checkpoints
    it keeping the matrix products' outputs, every other policy
    checkpoints the whole group."""
    if cfg.remat_policy == "none":
        return fn
    dots = cfg.remat_policy == "dots"
    return lambda *args: L.checkpoint(fn, *args, dots=dots)


def _shared_block(cfg: ModelConfig, sp, lora, x, positions, attend):
    """The shared attention + MLP block with one site's LoRA merged in;
    ``attend(q, k, v)`` is the attention of the call (training, or decode
    against the site's cache)."""
    ap = dict(sp["attn"])
    ap.update(lora)
    h = L.rmsnorm(x, sp["ln1"], cfg.rms_norm_eps)
    q, k, v = L.attn_qkv(ap, h, positions, cfg)
    x = x + L.attn_out(ap, attend(q, k, v))
    h = L.rmsnorm(x, sp["ln2"], cfg.rms_norm_eps)
    return x + L.mlp_apply(sp["mlp"], h)


def _shared_attn_fwd(cfg: ModelConfig, sp, lora, x, positions, cache=None,
                     pos=None):
    """The shared block at one site.  Without ``cache``, causal attention
    over the sequence; with ``cache`` = (kc, vc) slot views [B, max_seq,
    KVH, hd] of the site, the token's K/V are written at ``pos`` in place
    and it attends to entries 0..pos."""
    if cache is None:
        return _shared_block(cfg, sp, lora, x, positions,
                             lambda q, k, v: L.attention_dispatch(
                                 cfg, q, k, v, causal=True))
    kc, vc = cache
    rows = torch.arange(x.shape[0], device=pos.device)

    def attend(q, k, v):
        kc[rows, pos] = k[:, 0]
        vc[rows, pos] = v[:, 0]
        return L.decode_attention(q, kc, vc, pos)

    return _shared_block(cfg, sp, lora, x, positions, attend)


def _groups(params, cfg: ModelConfig):
    """Per group: its k blocks' trees and norm scales (views of the
    stacked leaves, one ``unbind`` a leaf) and its site's LoRA tree."""
    n_groups, k, _ = group_layout(cfg)
    blocks = L.unstack_layers(params["blocks"])
    norms = params["block_norms"].unbind(0)
    loras = L.unstack_layers(params["site_lora"])
    return [(blocks[g * k:(g + 1) * k], norms[g * k:(g + 1) * k], loras[g])
            for g in range(n_groups)]


def _tail(params, cfg: ModelConfig):
    if not group_layout(cfg)[2]:
        return []
    return list(zip(L.unstack_layers(params["tail_blocks"]),
                    params["tail_norms"].unbind(0)))


def forward_hidden(params, cfg: ModelConfig, tokens):
    """tokens [B, S] -> (final normed hidden [B,S,D], aux loss 0)."""
    x = T.embed_tokens(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    eps = cfg.rms_norm_eps

    def group_body(x_, gblocks, gnorms, lora):
        for bp, nrm in zip(gblocks, gnorms):
            x_ = x_ + M.block_forward(bp, cfg, L.rmsnorm(x_, nrm, eps))
        return _shared_attn_fwd(cfg, params["shared"], lora, x_, positions)

    body = _remat(group_body, cfg)
    for gblocks, gnorms, lora in _groups(params, cfg):
        x = body(x, gblocks, gnorms, lora)
    # the tail is never rematerialised, as in the JAX package
    for bp, nrm in _tail(params, cfg):
        x = x + M.block_forward(bp, cfg, L.rmsnorm(x, nrm, eps))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.rmsnorm(x, params["final_norm"], eps), aux


def forward(params, cfg: ModelConfig, tokens):
    """tokens [B, S] -> (logits [B, S, V] f32, aux loss 0)."""
    x, aux = forward_hidden(params, cfg, tokens)
    return T.unembed(params, cfg, x), aux


def loss_fn(params, cfg: ModelConfig, batch):
    """Mean next-token cross entropy on the f32 logits; returns (loss,
    {"nll", "aux"}).  Plain for every ``cfg.loss_impl``: the JAX
    ``hybrid.loss_fn`` reads no ``loss_impl`` either."""
    from repro_torch.train.losses import plain_xent
    logits, aux = forward(params, cfg, batch["tokens"])
    nll = plain_xent(logits, batch["labels"])
    return nll + aux, {"nll": nll, "aux": aux}


# ---------------------------------------------------------------------------
# Caches: the SSM state of every mamba layer ([NL, lanes, ...], the
# ``ssm`` and ``tail_ssm`` subtrees) and the K/V of every attention site
# ---------------------------------------------------------------------------

def _kv_spec(cfg: ModelConfig, lead: tuple, lead_axes: tuple):
    n_groups = group_layout(cfg)[0]
    shape = (n_groups,) + lead + (cfg.num_kv_heads, cfg.resolved_head_dim())
    axes = ("layers",) + lead_axes + ("act_kv_heads", "head_dim")
    dt = L.torch_dtype(cfg.dtype)
    return {"attn_k": L.PSpec(shape, axes, init="zeros", dtype=dt),
            "attn_v": L.PSpec(shape, axes, init="zeros", dtype=dt)}


def _state_spec(cfg: ModelConfig, lanes: int, kv: dict):
    tail = group_layout(cfg)[2]
    spec = {"ssm": M.state_spec(cfg, cfg.num_layers - tail, lanes), **kv}
    if tail:
        spec["tail_ssm"] = M.state_spec(cfg, tail, lanes)
    return spec


def cache_spec(cfg: ModelConfig, batch: int, max_seq: int):
    """The slot cache: the state and K/V [n_groups, batch, max_seq, KVH,
    hd] per site."""
    return _state_spec(cfg, batch, _kv_spec(cfg, (batch, max_seq),
                                            ("cache_batch", "cache_seq")))


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device):
    return L.zeros_tree(cache_spec(cfg, batch, max_seq), device)


def cache_shapes(cfg: ModelConfig, batch: int, max_seq: int):
    return L.shapes_tree(cache_spec(cfg, batch, max_seq))


def reset_cache_lane(cfg: ModelConfig, cache, lane_index: int):
    """Slot-cache lane reset: the ``ssm``/``tail_ssm`` subtrees are
    lane-indexed in both layouts, so the paged reset applies as it is;
    the attention rows are position-indexed and need none."""
    return reset_paged_lane(cfg, cache, lane_index)


def _ssm_decode(cfg: ModelConfig, bp, nrm, states, li: int, x, fed):
    """One mamba layer's decode step: layer ``li`` of ``states`` advanced
    (or kept where ``fed`` is False) and written over the old state in
    place."""
    st = {k: v[li] for k, v in states.items()}
    y, new = M.block_decode(bp, cfg, st, L.rmsnorm(x, nrm, cfg.rms_norm_eps))
    if fed is not None:
        new = M.masked_state(fed, new, st)
    for k, v in new.items():
        st[k].copy_(v)
    return x + y


def _decode_hidden(params, cfg: ModelConfig, cache, tokens, pos, fed, site):
    """One decoded token through every layer and the final norm; at group
    g the shared block runs as ``site(g, x, lora)``."""
    x = T.embed_tokens(params, cfg, tokens)
    k = group_layout(cfg)[1]
    for g, (gblocks, gnorms, lora) in enumerate(_groups(params, cfg)):
        for i, (bp, nrm) in enumerate(zip(gblocks, gnorms)):
            x = _ssm_decode(cfg, bp, nrm, cache["ssm"], g * k + i, x, fed)
        x = site(g, x, lora)
    for i, (bp, nrm) in enumerate(_tail(params, cfg)):
        x = _ssm_decode(cfg, bp, nrm, cache["tail_ssm"], i, x, fed)
    return L.rmsnorm(x, params["final_norm"], cfg.rms_norm_eps)


def decode_step(params, cfg: ModelConfig, cache, tokens, pos, fed=None):
    """tokens [B,1], pos [B] -> (logits [B,1,V] f32, cache) on the slot
    cache, updated in place and returned."""
    x, cache = decode_hidden(params, cfg, cache, tokens, pos, fed)
    return T.unembed(params, cfg, x), cache


def decode_hidden(params, cfg: ModelConfig, cache, tokens, pos, fed=None):
    """Slot-cache decode step up to (and including) the final norm.
    ``fed`` [B] bool freezes the SSM state of lanes not fed; the K/V rows
    need no mask: a lane's write at its own ``pos`` is overwritten before
    the mask exposes it."""
    def site(g, x, lora):
        return _shared_attn_fwd(cfg, params["shared"], lora, x, pos[:, None],
                                cache=(cache["attn_k"][g],
                                       cache["attn_v"][g]), pos=pos)

    return _decode_hidden(params, cfg, cache, tokens, pos, fed, site), cache


# ---------------------------------------------------------------------------
# Paged decode: block-table-indexed K/V at each site, fed-masked SSM state
# ---------------------------------------------------------------------------

PAGED_HAS_BLOCKS = True     # the attention sites cache K/V per position


def paged_cache_spec(cfg: ModelConfig, lanes: int, num_blocks: int,
                     block_size: int):
    """The paged pool: lane-indexed state and block-pooled K/V
    [n_groups, num_blocks, block_size, KVH, hd]."""
    return _state_spec(cfg, lanes, _kv_spec(cfg, (num_blocks, block_size),
                                            (None, "cache_seq")))


def init_paged_cache(cfg: ModelConfig, lanes: int, num_blocks: int,
                     block_size: int, device):
    return L.zeros_tree(paged_cache_spec(cfg, lanes, num_blocks, block_size),
                        device)


def reset_paged_lane(cfg: ModelConfig, cache, lane_index: int):
    """Zero one lane's SSM state IN PLACE; the K/V block pools need no
    reset (stale bytes are never read unmasked).  The serve engine resets
    lanes only while no decode step is in flight."""
    for key in ("ssm", "tail_ssm"):
        for leaf in cache.get(key, {}).values():
            leaf[:, lane_index] = 0
    return cache


def _shared_attn_paged(cfg: ModelConfig, sp, lora, x, kc, vc, pos, tables):
    """The shared block against one site's paged K/V: kc/vc [num_blocks,
    bs, KVH, hd], tables [B, max_blocks].  The token's K/V are written at
    (tables[pos // bs], pos % bs) in place; attention reads the
    table-gathered view."""
    rows = torch.arange(x.shape[0], device=tables.device)
    bs = kc.shape[1]
    phys, off = tables[rows, pos // bs], pos % bs

    def attend(q, k, v):
        kc[phys, off] = k[:, 0]
        vc[phys, off] = v[:, 0]
        return L.decode_attention(q, T._paged_view(kc, tables),
                                  T._paged_view(vc, tables), pos)

    return _shared_block(cfg, sp, lora, x, pos[:, None], attend)


def decode_step_paged(params, cfg: ModelConfig, cache, tokens, pos, tables,
                      fed=None):
    """tokens [B,1], pos [B], tables [B,max_blocks] -> (logits [B,1,V]
    f32, cache); the pool is updated in place and returned."""
    x, cache = decode_hidden_paged(params, cfg, cache, tokens, pos, tables,
                                   fed)
    return T.unembed(params, cfg, x), cache


def decode_hidden_paged(params, cfg: ModelConfig, cache, tokens, pos, tables,
                        fed=None):
    """Paged decode step up to (and including) the final norm.  Lanes
    whose table entry is the scratch block write their K/V to physical
    block 0, which no live table gathers; ``fed`` freezes the SSM state
    of lanes not fed."""
    def site(g, x, lora):
        return _shared_attn_paged(cfg, params["shared"], lora, x,
                                  cache["attn_k"][g], cache["attn_v"][g],
                                  pos, tables)

    return _decode_hidden(params, cfg, cache, tokens, pos, fed, site), cache
