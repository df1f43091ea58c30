"""Mamba2 (SSD — state-space duality) blocks and LM, the ssm family
(mamba2-1.3b): the JAX package's ``models/mamba.py`` — the training
forward under every checkpoint policy, the loss, and decode on the slot
cache and on the paged (per-lane) state.  [arXiv:2405.21060]

As in the JAX package, z/x/B/C/dt have separate projections and convs
per component, and the chunked SSD is the intra-chunk quadratic form
plus an inter-chunk recurrence.  The intra-chunk part runs in
``ops.ssd_chunk`` (the hand-written kernel on the card, its plain version
on the CPU), once per layer for all chunks; the JAX ``ssd_forward``
writes it in jnp.  The inter-chunk recurrence, a Python loop over chunks
where the JAX package uses ``lax.scan``, and the layer loop stay plain
PyTorch.  Decode keeps an O(1) recurrent state ``h [B, nh, hp, ds]`` per
lane, updated in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nh = d_inner // s.head_dim
    return d_inner, nh, s.head_dim, s.d_state


# ---------------------------------------------------------------------------
# Parameter spec (one stacked block set)
# ---------------------------------------------------------------------------

def block_spec(cfg: ModelConfig, layers: int):
    D = cfg.d_model
    d_inner, nh, hp, ds = dims(cfg)
    W = cfg.ssm.conv_width
    NL = layers
    lax = ("layers",)
    return {
        "z_proj": L.PSpec((NL, D, nh, hp), lax + ("embed", "heads", "head_dim"), fan_in=D),
        "x_proj": L.PSpec((NL, D, nh, hp), lax + ("embed", "heads", "head_dim"), fan_in=D),
        "b_proj": L.PSpec((NL, D, ds), lax + ("embed", "state"), fan_in=D),
        "c_proj": L.PSpec((NL, D, ds), lax + ("embed", "state"), fan_in=D),
        "dt_proj": L.PSpec((NL, D, nh), lax + ("embed", "heads"), fan_in=D),
        "conv_x": L.PSpec((NL, W, nh, hp), lax + ("conv", "heads", "head_dim"), fan_in=W),
        "conv_b": L.PSpec((NL, W, ds), lax + ("conv", "state"), fan_in=W),
        "conv_c": L.PSpec((NL, W, ds), lax + ("conv", "state"), fan_in=W),
        "a_log": L.PSpec((NL, nh), lax + ("heads",), init="ssm_a"),
        "d_skip": L.PSpec((NL, nh), lax + ("heads",), init="ones"),
        "dt_bias": L.PSpec((NL, nh), lax + ("heads",), init="ssm_dt"),
        "norm": L.PSpec((NL, nh, hp), lax + ("heads", "head_dim"), init="ones"),
        "out_proj": L.PSpec((NL, nh, hp, D), lax + ("heads", "head_dim", "embed"), fan_in=d_inner),
    }


def param_spec(cfg: ModelConfig):
    D, V = cfg.d_model, cfg.vocab_size
    spec = {
        "embed": L.PSpec((V, D), ("vocab", "embed"), init="embed"),
        "blocks": block_spec(cfg, cfg.num_layers),
        "block_norms": L.PSpec((cfg.num_layers, D), ("layers", "embed_nofsdp"), init="ones"),
        "final_norm": L.PSpec((D,), ("embed_nofsdp",), init="ones"),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = L.PSpec((D, V), ("embed", "vocab"), fan_in=D)
    return spec


def init_params(cfg: ModelConfig, generator: torch.Generator):
    """Random parameters in ``cfg.param_dtype`` on the generator's device."""
    return L.init_tree(param_spec(cfg), generator,
                       L.torch_dtype(cfg.param_dtype))


# read in f32 wherever they are used, as the JAX package reads them
F32_KEYS = ("a_log", "d_skip", "dt_bias", "norm", "block_norms", "final_norm")


def cast_params(cfg: ModelConfig, params):
    """Cast the projections, convs, ``out_proj`` and the embedding to the
    compute dtype once, at load time (the per-op casts then cast
    nothing); the SSM scalars and the norm scales stay f32."""
    dt = L.torch_dtype(cfg.dtype)

    def walk(tree, key=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return tree if key in F32_KEYS else tree.to(dt)

    return walk(params)


# ---------------------------------------------------------------------------
# Causal conv1d
# ---------------------------------------------------------------------------

def _causal_conv(u, w):
    """u: [B, S, ...feat], w: [W, ...feat] — depthwise causal conv."""
    W = w.shape[0]
    pad = torch.zeros((u.shape[0], W - 1) + tuple(u.shape[2:]),
                      dtype=u.dtype, device=u.device)
    up = torch.cat([pad, u], dim=1)
    out = torch.zeros_like(u)
    for i in range(W):
        out = out + up[:, i:i + u.shape[1]] * w[i].to(u.dtype)
    return out


# ---------------------------------------------------------------------------
# SSD forward (chunked)
# ---------------------------------------------------------------------------

def ssd_forward(xh, bm, cm, dt, a_log, *, chunk: int):
    """Chunked SSD. xh: [B,S,nh,hp]; bm/cm: [B,S,ds]; dt: [B,S,nh] (post-
    softplus). Returns y: [B,S,nh,hp] f32.

    One ``ops.ssd_chunk`` call over all B·nc chunks gives the
    intra-chunk output, each chunk's state and its total decay; across
    chunks the state h [B,nh,hp,ds] is carried by a loop."""
    B, S, nh, hp = xh.shape
    ds = bm.shape[-1]
    Q = min(chunk, S)
    if S % Q != 0:
        Q = S
    nc = S // Q

    y_intra, sts, dec = ops.ssd_chunk(
        xh.reshape(B * nc, Q, nh, hp), bm.reshape(B * nc, Q, ds),
        cm.reshape(B * nc, Q, ds), dt.reshape(B * nc, Q, nh), a_log)
    sts = sts.reshape(B, nc, nh, hp, ds)
    dec = dec.reshape(B, nc, nh)

    h = torch.zeros((B, nh, hp, ds), dtype=torch.float32, device=xh.device)
    h_prevs = []                                        # state entering chunk n
    for n in range(nc):
        h_prevs.append(h)
        h = h * dec[:, n, :, None, None] + sts[:, n]
    h_prevs = torch.stack(h_prevs, dim=1)               # [B,nc,nh,hp,ds]

    # inter-chunk: y_inter[i] = exp(cum_i) * C_i . h_prev, with the
    # prefix sums of the chunk's oracle and kernel
    a = -torch.exp(a_log.float())
    cum = ref.prefix_sum((dt.float() * a).reshape(B * nc, Q, nh))
    decay_in = torch.exp(cum.clamp(-60.0, 0.0)).reshape(B, nc, Q, nh)
    cc = cm.reshape(B, nc, Q, ds).float()
    y_inter = torch.einsum("bnis,bnhps,bnih->bnihp", cc, h_prevs, decay_in)
    return (y_intra.float().reshape(B, nc, Q, nh, hp)
            + y_inter).reshape(B, S, nh, hp)


def ssd_decode_step(h, x1, b1, c1, dt1, a_log):
    """One recurrent step. h: [B,nh,hp,ds]; x1: [B,nh,hp]; b1/c1: [B,ds];
    dt1: [B,nh] (post-softplus). Returns (y [B,nh,hp], h)."""
    a = -torch.exp(a_log.float())
    dA = torch.exp(dt1.float() * a)                     # [B,nh]
    dBx = torch.einsum("bhp,bs,bh->bhps", x1.float(), b1.float(),
                       dt1.float())
    h = h * dA[..., None, None] + dBx
    y = torch.einsum("bhps,bs->bhp", h, c1.float())
    return y, h


# ---------------------------------------------------------------------------
# Full block (proj + conv + SSD + gate + out)
# ---------------------------------------------------------------------------

def _gated_norm(y, z, scale, eps):
    """The gated per-head RMSNorm, f32: y·silu(z), normalised over hp."""
    y = y * F.silu(z.float())
    var = torch.mean(y * y, dim=-1, keepdim=True)
    return y * torch.rsqrt(var + eps) * scale.float()


def block_forward(bp, cfg: ModelConfig, x):
    """x: [B,S,D] -> [B,S,D]."""
    dt_ = x.dtype
    z = torch.einsum("bsd,dhp->bshp", x, bp["z_proj"].to(dt_))
    xh = torch.einsum("bsd,dhp->bshp", x, bp["x_proj"].to(dt_))
    bm = torch.einsum("bsd,dk->bsk", x, bp["b_proj"].to(dt_))
    cm = torch.einsum("bsd,dk->bsk", x, bp["c_proj"].to(dt_))
    dt_raw = torch.einsum("bsd,dh->bsh", x, bp["dt_proj"].to(dt_))

    xh = F.silu(_causal_conv(xh, bp["conv_x"]))
    bm = F.silu(_causal_conv(bm, bp["conv_b"]))
    cm = F.silu(_causal_conv(cm, bp["conv_c"]))

    dt = F.softplus(dt_raw.float() + bp["dt_bias"].float())
    y = ssd_forward(xh, bm, cm, dt, bp["a_log"], chunk=cfg.ssm.chunk_size)
    y = y + xh.float() * bp["d_skip"].float()[None, None, :, None]
    y = _gated_norm(y, z, bp["norm"], cfg.rms_norm_eps).to(dt_)
    return torch.einsum("bshp,hpd->bsd", y, bp["out_proj"].to(dt_))


def block_decode(bp, cfg: ModelConfig, state, x):
    """x: [B,1,D]; state: dict(conv_x, conv_b, conv_c, h). Returns (y,
    state)."""
    dt_ = x.dtype
    z = torch.einsum("bsd,dhp->bshp", x, bp["z_proj"].to(dt_))[:, 0]
    xh = torch.einsum("bsd,dhp->bshp", x, bp["x_proj"].to(dt_))[:, 0]
    bm = torch.einsum("bsd,dk->bsk", x, bp["b_proj"].to(dt_))[:, 0]
    cm = torch.einsum("bsd,dk->bsk", x, bp["c_proj"].to(dt_))[:, 0]
    dt_raw = torch.einsum("bsd,dh->bsh", x, bp["dt_proj"].to(dt_))[:, 0]

    def conv_step(cache, new, w):
        # cache: [B, W-1, ...feat]; new: [B, ...feat]
        seq = torch.cat([cache, new[:, None]], dim=1)   # [B, W, feat]
        out = torch.einsum("bw...,w...->b...", seq, w.to(new.dtype))
        return F.silu(out), seq[:, 1:]

    xh, cx = conv_step(state["conv_x"], xh, bp["conv_x"])
    bm, cb = conv_step(state["conv_b"], bm, bp["conv_b"])
    cm, cc = conv_step(state["conv_c"], cm, bp["conv_c"])

    dt = F.softplus(dt_raw.float() + bp["dt_bias"].float())
    y, h = ssd_decode_step(state["h"], xh, bm, cm, dt, bp["a_log"])
    y = y + xh.float() * bp["d_skip"].float()[None, :, None]
    y = _gated_norm(y, z, bp["norm"], cfg.rms_norm_eps)
    out = torch.einsum("bhp,hpd->bd", y.to(dt_), bp["out_proj"].to(dt_))
    return out[:, None], {"conv_x": cx, "conv_b": cb, "conv_c": cc, "h": h}


def state_spec(cfg: ModelConfig, layers: int, batch: int):
    d_inner, nh, hp, ds = dims(cfg)
    W = cfg.ssm.conv_width
    NL = layers
    cdt = L.torch_dtype(cfg.dtype)
    return {
        "conv_x": L.PSpec((NL, batch, W - 1, nh, hp),
                          ("layers", "cache_batch", None, "act_heads", "head_dim"),
                          init="zeros", dtype=cdt),
        "conv_b": L.PSpec((NL, batch, W - 1, ds),
                          ("layers", "cache_batch", None, "state"), init="zeros", dtype=cdt),
        "conv_c": L.PSpec((NL, batch, W - 1, ds),
                          ("layers", "cache_batch", None, "state"), init="zeros", dtype=cdt),
        "h": L.PSpec((NL, batch, nh, hp, ds),
                     ("layers", "cache_batch", "act_heads", "head_dim", "state"),
                     init="zeros", dtype=torch.float32),
    }


# ---------------------------------------------------------------------------
# Full LM
# ---------------------------------------------------------------------------

def _remat(fn, cfg: ModelConfig):
    """The JAX ``mamba._remat``'s mapping of the checkpoint policy: "none"
    runs ``fn`` as it is, "dots" checkpoints the whole layer keeping the
    matrix products' outputs, and every other policy ("full", and the
    dense family's "subblock" and "attn_only", which a block without
    attention has no part for) checkpoints the whole layer."""
    if cfg.remat_policy == "none":
        return fn
    dots = cfg.remat_policy == "dots"
    return lambda *args: L.checkpoint(fn, *args, dots=dots)


def forward_hidden(params, cfg: ModelConfig, tokens):
    """tokens [B, S] -> (final normed hidden [B,S,D], aux loss 0)."""
    x = T.embed_tokens(params, cfg, tokens)

    def body(x_, bp, nrm):
        return x_ + block_forward(bp, cfg, L.rmsnorm(x_, nrm, cfg.rms_norm_eps))

    body = _remat(body, cfg)
    for bp, nrm in zip(L.unstack_layers(params["blocks"]),
                       params["block_norms"].unbind(0)):
        x = body(x, bp, nrm)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.rmsnorm(x, params["final_norm"], cfg.rms_norm_eps), aux


def forward(params, cfg: ModelConfig, tokens):
    """tokens [B, S] -> (logits [B, S, V] f32, aux loss)."""
    x, aux = forward_hidden(params, cfg, tokens)
    return T.unembed(params, cfg, x), aux


def loss_fn(params, cfg: ModelConfig, batch):
    """Mean next-token cross entropy (f32 logits [B, S, V]); returns
    (loss, {"nll", "aux"}).  Plain for every ``cfg.loss_impl``: the JAX
    ``mamba.loss_fn`` reads no ``loss_impl`` either."""
    from repro_torch.train.losses import plain_xent
    logits, aux = forward(params, cfg, batch["tokens"])
    nll = plain_xent(logits, batch["labels"])
    return nll + aux, {"nll": nll, "aux": aux}


# ---------------------------------------------------------------------------
# Slot-cache decode: the cache is the recurrent state [NL, B, ...] (O(1)
# in the sequence), one row per slot.
# ---------------------------------------------------------------------------

def cache_spec(cfg: ModelConfig, batch: int, max_seq: int):
    return state_spec(cfg, cfg.num_layers, batch)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device):
    return L.zeros_tree(cache_spec(cfg, batch, max_seq), device)


def cache_shapes(cfg: ModelConfig, batch: int, max_seq: int):
    return L.shapes_tree(cache_spec(cfg, batch, max_seq))


def reset_cache_lane(cfg: ModelConfig, cache, lane_index: int):
    """Slot-cache lane reset: the slot cache is the state tree, so a
    recycled slot is zeroed exactly like a recycled paged lane."""
    return reset_paged_lane(cfg, cache, lane_index)


def decode_step(params, cfg: ModelConfig, cache, tokens, pos, fed=None):
    """tokens [B,1] -> (logits [B,1,V] f32, cache) on the slot cache;
    ``pos`` is unused.  A lane not in ``fed`` keeps its state bit for bit."""
    x, cache = decode_hidden(params, cfg, cache, tokens, pos, fed)
    return T.unembed(params, cfg, x), cache


def decode_hidden(params, cfg: ModelConfig, cache, tokens, pos, fed=None):
    """Slot-cache decode step up to (and including) the final norm; the
    state is updated in place, as on the paged path."""
    return decode_hidden_paged(params, cfg, cache, tokens, pos, None, fed)


# ---------------------------------------------------------------------------
# Paged decode: the O(1) recurrent state has no sequence blocks to page;
# the "paged" cache is per-lane state [NL, lanes, ...].  What the
# continuous-batching engine needs from an SSM family is fed-masking: the
# state is a running reduction, so a lane not fed a real token this call
# (idle, or another lane mid-prefill) keeps its state bit-frozen — an SSM
# update, unlike a KV write, cannot be overwritten later.
# ---------------------------------------------------------------------------

PAGED_HAS_BLOCKS = False    # O(1) state: no per-position pool blocks


def paged_cache_spec(cfg: ModelConfig, lanes: int, num_blocks: int,
                     block_size: int):
    return state_spec(cfg, cfg.num_layers, lanes)


def init_paged_cache(cfg: ModelConfig, lanes: int, num_blocks: int,
                     block_size: int, device):
    return L.zeros_tree(paged_cache_spec(cfg, lanes, num_blocks, block_size),
                        device)


def reset_paged_lane(cfg: ModelConfig, cache, lane_index: int):
    """Zero one lane's recurrent state IN PLACE (leaves are [NL, lanes,
    ...]): state is never overwritten before it is read, so a recycled
    lane would otherwise leak its previous occupant's state.  The serve
    engine resets lanes only while no decode step is in flight."""
    for leaf in cache.values():
        leaf[:, lane_index] = 0
    return cache


def masked_state(fed, new_state, old_state):
    """Per-lane select: advanced state where ``fed`` [B], frozen
    elsewhere."""
    def sel(new, old):
        m = fed.reshape((fed.shape[0],) + (1,) * (new.dim() - 1))
        return torch.where(m, new, old)
    return {k: sel(new_state[k], old_state[k]) for k in new_state}


def decode_step_paged(params, cfg: ModelConfig, cache, tokens, pos, tables,
                      fed=None):
    """tokens [B,1] -> (logits [B,1,V] f32, cache); ``pos`` and ``tables``
    are unused (no positions, no blocks).  The state is updated in place
    and returned."""
    x, cache = decode_hidden_paged(params, cfg, cache, tokens, pos, tables,
                                   fed)
    return T.unembed(params, cfg, x), cache


def decode_hidden_paged(params, cfg: ModelConfig, cache, tokens, pos, tables,
                        fed=None):
    """Paged decode step up to (and including) the final norm.  Each
    layer's new state is written over the old in place (the serve engine
    never has a prefill and a decode step in flight together)."""
    x = T.embed_tokens(params, cfg, tokens)
    for li, bp in enumerate(L.unstack_layers(params["blocks"])):
        st = {k: v[li] for k, v in cache.items()}
        h = L.rmsnorm(x, params["block_norms"][li], cfg.rms_norm_eps)
        y, new_st = block_decode(bp, cfg, st, h)
        if fed is not None:
            new_st = masked_state(fed, new_st, st)
        for k, v in new_st.items():
            st[k].copy_(v)
        x = x + y
    x = L.rmsnorm(x, params["final_norm"], cfg.rms_norm_eps)
    return x, cache
