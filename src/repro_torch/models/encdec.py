"""Whisper-style encoder-decoder, the audio family (whisper-tiny): the
JAX package's ``models/encdec.py`` — the encoder, the decoder with
cross-attention for training, the loss, and decode on the slot cache.
[arXiv:2212.04356]

The conv audio frontend is a stub, as in the JAX package: the encoder
takes precomputed frame embeddings ``[B, frames, d_model]``.  LayerNorm
with bias, GELU MLPs (the tanh form, ``jax.nn.gelu``'s default), learned
decoder positions, sinusoidal encoder positions and biased projections.
Layers are stacked and run by a Python loop, as in the port's other
families; attention goes through ``ops.flash_attention`` (the encoder and
the cross-attention non-causal, the decoder's self-attention causal) and
decode through ``ops.flash_decode``.

Like the JAX module it has no ``decode_hidden`` and no paged entries, so
the serving engine refuses it.  The slot cache's cross K/V (``xk``,
``xv``) start at zero, as the JAX ``init_cache`` makes them; a caller
fills them from ``encode`` and ``_enc_kv`` before decoding.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _ln_spec(n, NL=None):
    if NL is None:
        return {"scale": L.PSpec((n,), ("embed_nofsdp",), init="ones"),
                "bias": L.PSpec((n,), ("embed_nofsdp",), init="zeros")}
    return {"scale": L.PSpec((NL, n), ("layers", "embed_nofsdp"), init="ones"),
            "bias": L.PSpec((NL, n), ("layers", "embed_nofsdp"),
                            init="zeros")}


def _ln(x, p, eps):
    return L.layernorm(x, p["scale"], p["bias"], eps)


def param_spec(cfg: ModelConfig):
    D, V = cfg.d_model, cfg.vocab_size
    NE, ND = cfg.num_encoder_layers, cfg.num_layers
    return {
        "embed": L.PSpec((V, D), ("vocab", "embed"), init="embed"),
        "pos_embed": L.PSpec((min(cfg.max_position_embeddings, 1 << 16), D),
                             (None, "embed"), init="embed"),
        "encoder": {
            "attn": L.attn_spec(cfg, layers=NE),
            "mlp": L.mlp_spec(cfg, layers=NE),
            "ln1": _ln_spec(D, NE),
            "ln2": _ln_spec(D, NE),
        },
        "enc_final_ln": _ln_spec(D),
        "decoder": {
            "attn": L.attn_spec(cfg, layers=ND),
            "xattn": L.attn_spec(cfg, layers=ND),
            "mlp": L.mlp_spec(cfg, layers=ND),
            "ln1": _ln_spec(D, ND),
            "lnx": _ln_spec(D, ND),
            "ln2": _ln_spec(D, ND),
        },
        "dec_final_ln": _ln_spec(D),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator):
    """Random parameters in ``cfg.param_dtype`` on the generator's device."""
    return L.init_tree(param_spec(cfg), generator,
                       L.torch_dtype(cfg.param_dtype))


# the LayerNorms: their scales and biases are read in f32
LN_KEYS = ("ln1", "ln2", "lnx", "enc_final_ln", "dec_final_ln")


def cast_params(cfg: ModelConfig, params):
    """Cast the embeddings, projections, biases and MLPs to the compute
    dtype once, at load time; the LayerNorms' scales and biases stay
    f32, as ``layernorm`` reads them."""
    dt = L.torch_dtype(cfg.dtype)

    def walk(tree, keep=False):
        if isinstance(tree, dict):
            return {k: walk(v, keep or k in LN_KEYS) for k, v in tree.items()}
        return tree if keep else tree.to(dt)

    return walk(params)


def _remat(fn, cfg: ModelConfig):
    """The JAX ``encdec._remat``'s mapping: "none" runs the layer as it
    is; every other policy, "dots" included, checkpoints the whole
    layer."""
    if cfg.remat_policy == "none":
        return fn
    return lambda *args: L.checkpoint(fn, *args)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def encode(params, cfg: ModelConfig, encoder_embeds):
    """encoder_embeds [B, F, D] (the stub frontend's output) -> the
    encoder's output [B, F, D] in the compute dtype."""
    x = encoder_embeds.to(L.torch_dtype(cfg.dtype))
    frames = x.shape[1]
    sin = torch.from_numpy(L.sinusoidal_positions(frames, cfg.d_model))
    x = x + sin.to(x.device, x.dtype)[None]
    positions = torch.arange(frames, device=x.device)[None, :]
    eps = cfg.rms_norm_eps

    def body(x_, lp):
        h = _ln(x_, lp["ln1"], eps)
        q, k, v = L.attn_qkv(lp["attn"], h, positions, cfg, use_rope=False)
        o = L.attention(q, k, v, causal=False, chunk=cfg.attention_chunk)
        x_ = x_ + L.attn_out(lp["attn"], o)
        h = _ln(x_, lp["ln2"], eps)
        return x_ + L.mlp_apply(lp["mlp"], h, act=_gelu)

    body = _remat(body, cfg)
    for lp in L.unstack_layers(params["encoder"]):
        x = body(x, lp)
    return _ln(x, params["enc_final_ln"], eps)


# ---------------------------------------------------------------------------
# Decoder (training: the whole sequence; decode: one token and the caches)
# ---------------------------------------------------------------------------

def _xattn(cfg: ModelConfig, lp, x, enc_kv):
    """Cross-attention of one decoder layer against its encoder K/V
    [B, F, KVH, hd], non-causal."""
    ek, ev = enc_kv
    h = _ln(x, lp["lnx"], cfg.rms_norm_eps)
    dt = h.dtype
    q = torch.einsum("bsd,dhk->bshk", h, lp["xattn"]["wq"].to(dt))
    if "bq" in lp["xattn"]:
        q = q + lp["xattn"]["bq"].to(dt)
    o = L.attention(q, ek, ev, causal=False, chunk=cfg.attention_chunk)
    return x + L.attn_out(lp["xattn"], o)


def _enc_kv(cfg: ModelConfig, lp, enc_out):
    """One decoder layer's cross K/V from the encoder output [B, F, D]:
    (k, v) [B, F, KVH, hd], biased when the config is."""
    dt = enc_out.dtype
    k = torch.einsum("bfd,dhk->bfhk", enc_out, lp["xattn"]["wk"].to(dt))
    v = torch.einsum("bfd,dhk->bfhk", enc_out, lp["xattn"]["wv"].to(dt))
    if "bv" in lp["xattn"]:
        k = k + lp["xattn"]["bk"].to(dt)
        v = v + lp["xattn"]["bv"].to(dt)
    return k, v


def _logits(params, x):
    return torch.einsum("bsd,vd->bsv", x,
                        params["embed"].to(x.dtype)).float()


def decode_train(params, cfg: ModelConfig, tokens, enc_out):
    """tokens [B, S], enc_out [B, F, D] -> logits [B, S, V] f32."""
    dt = L.torch_dtype(cfg.dtype)
    x = params["embed"][tokens].to(dt)
    S = x.shape[1]
    x = x + params["pos_embed"][:S][None].to(dt)
    positions = torch.arange(S, device=x.device)[None, :]
    eps = cfg.rms_norm_eps

    def body(x_, lp, enc):
        h = _ln(x_, lp["ln1"], eps)
        q, k, v = L.attn_qkv(lp["attn"], h, positions, cfg, use_rope=False)
        o = L.attention(q, k, v, causal=True, chunk=cfg.attention_chunk)
        x_ = x_ + L.attn_out(lp["attn"], o)
        x_ = _xattn(cfg, lp, x_, _enc_kv(cfg, lp, enc))
        h = _ln(x_, lp["ln2"], eps)
        return x_ + L.mlp_apply(lp["mlp"], h, act=_gelu)

    body = _remat(body, cfg)
    for lp in L.unstack_layers(params["decoder"]):
        x = body(x, lp, enc_out)
    return _logits(params, _ln(x, params["dec_final_ln"], eps))


def forward(params, cfg: ModelConfig, tokens, encoder_embeds):
    """(logits [B, S, V] f32, aux loss 0)."""
    enc_out = encode(params, cfg, encoder_embeds)
    aux = torch.zeros((), dtype=torch.float32, device=enc_out.device)
    return decode_train(params, cfg, tokens, enc_out), aux


def loss_fn(params, cfg: ModelConfig, batch):
    """Mean next-token cross entropy of the decoder; returns (loss,
    {"nll", "aux"}).  Plain for every ``cfg.loss_impl``: the JAX
    ``encdec.loss_fn`` reads no ``loss_impl`` either."""
    from repro_torch.train.losses import plain_xent
    logits, aux = forward(params, cfg, batch["tokens"],
                          batch["encoder_embeds"])
    nll = plain_xent(logits, batch["labels"])
    return nll + aux, {"nll": nll, "aux": aux}


# ---------------------------------------------------------------------------
# Slot cache + decode
# ---------------------------------------------------------------------------

def cache_spec(cfg: ModelConfig, batch: int, max_seq: int):
    """Self-attention K/V [ND, batch, max_seq, KVH, hd] and the cross K/V
    [ND, batch, encoder_frames, KVH, hd], in the compute dtype."""
    ND, KVH, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim()
    frames = cfg.encoder_frames
    cdt = L.torch_dtype(cfg.dtype)
    kv_axes = ("layers", "cache_batch", "cache_seq", "act_kv_heads",
               "head_dim")
    x_axes = ("layers", "cache_batch", "frames", "act_kv_heads", "head_dim")
    return {
        "k": L.PSpec((ND, batch, max_seq, KVH, hd), kv_axes, init="zeros",
                     dtype=cdt),
        "v": L.PSpec((ND, batch, max_seq, KVH, hd), kv_axes, init="zeros",
                     dtype=cdt),
        "xk": L.PSpec((ND, batch, frames, KVH, hd), x_axes, init="zeros",
                      dtype=cdt),
        "xv": L.PSpec((ND, batch, frames, KVH, hd), x_axes, init="zeros",
                      dtype=cdt),
    }


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device):
    return L.zeros_tree(cache_spec(cfg, batch, max_seq), device)


def cache_shapes(cfg: ModelConfig, batch: int, max_seq: int):
    return L.shapes_tree(cache_spec(cfg, batch, max_seq))


def decode_step(params, cfg: ModelConfig, cache, tokens, pos, fed=None):
    """One decoder token: tokens [B,1], pos [B] -> (logits [B,1,V] f32,
    cache).  The self K/V are written at ``pos`` in place; the cross K/V
    come from the cache, every frame valid.  ``fed`` is accepted and
    ignored, as in the JAX package (K/V writes are position-indexed)."""
    del fed
    dt = L.torch_dtype(cfg.dtype)
    B = tokens.shape[0]
    rows = torch.arange(B, device=pos.device)
    x = params["embed"][tokens].to(dt)
    x = x + params["pos_embed"][pos][:, None].to(dt)
    eps = cfg.rms_norm_eps
    for li, lp in enumerate(L.unstack_layers(params["decoder"])):
        kc, vc = cache["k"][li], cache["v"][li]
        xk, xv = cache["xk"][li], cache["xv"][li]
        h = _ln(x, lp["ln1"], eps)
        q, k_new, v_new = L.attn_qkv(lp["attn"], h, pos[:, None], cfg,
                                     use_rope=False)
        kc[rows, pos] = k_new[:, 0]
        vc[rows, pos] = v_new[:, 0]
        x = x + L.attn_out(lp["attn"], L.decode_attention(q, kc, vc, pos))
        # cross attention: all frames valid (lengths = F)
        h = _ln(x, lp["lnx"], eps)
        qx = torch.einsum("bsd,dhk->bshk", h, lp["xattn"]["wq"].to(h.dtype))
        if "bq" in lp["xattn"]:
            qx = qx + lp["xattn"]["bq"].to(h.dtype)
        last = torch.full((B,), xk.shape[1] - 1, dtype=torch.int32,
                          device=pos.device)
        x = x + L.attn_out(lp["xattn"], L.decode_attention(qx, xk, xv, last))
        h = _ln(x, lp["ln2"], eps)
        x = x + L.mlp_apply(lp["mlp"], h, act=_gelu)
    return _logits(params, _ln(x, params["dec_final_ln"], eps)), cache
