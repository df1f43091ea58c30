"""Shared model building blocks (the JAX package's ``models/layers.py``:
the dense blocks with the hybrid family's per-site LoRA, the
encoder-decoder family's LayerNorm, sinusoid and non-causal attention,
and the MoE layer, with its expert-parallel dispatch).

Conventions, as in the JAX package:

* Parameters live in nested dicts of tensors.  The *structure* is
  declared once as a tree of :class:`PSpec` (shape + logical axes + init);
  ``init_tree`` materializes it from an explicit ``torch.Generator``.
* Layers carry a leading ``"layers"`` axis (stacked, as the JAX package
  scans over it; the port loops over it).
* Compute dtype is ``cfg.dtype`` (bf16 by default); softmax, norms and
  accumulations are f32.
* ``rmsnorm``, ``attention_dispatch`` and ``decode_attention`` go
  through ``kernels/ops.py``: the hand-written kernels for tensors on the
  card, their plain versions on the CPU.
* The MoE layer is plain tensor code, as in the JAX package (no Pallas
  kernel computes any of it): routing in f32, the expert products in the
  compute dtype.  Training on a mesh whose model axis splits the expert
  width, its expert block places its model-axis sums by hand
  (``_MoEBlockTP``).
* ``attention_impl="ring"`` splits the sequence over the mesh's model
  axis (``collectives/ring_attention.py``).  The model axis replicates
  every other layer: each computes the function GSPMD's placement does,
  once, as under FSDP.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch import sharding
from repro_torch.kernels import ops

# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"        # normal | zeros | ones | embed | ssm_a | ssm_dt
    fan_in: int | None = None   # overrides fan-in for "normal"
    dtype: Any = None           # overrides param dtype (a torch.dtype)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def torch_dtype(name: str) -> torch.dtype:
    """``cfg.dtype``/``cfg.param_dtype`` string -> torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def tree_leaves(tree, path=()):
    """(path, leaf) pairs of a nested dict in sorted-key order — the order
    ``jax.tree.flatten`` visits dict keys."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], path + (k,))
    else:
        yield path, tree


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_from_leaves(pairs):
    """The nested dict holding each (path, leaf) pair of ``pairs`` — the
    inverse of ``tree_leaves``."""
    out: dict = {}
    for path, leaf in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def init_tree(spec_tree, generator: torch.Generator,
              param_dtype: torch.dtype = torch.float32):
    """Materialize a parameter tree from a PSpec tree, on the generator's
    device.  Draws leaf by leaf in sorted-key order from ``generator``
    (the numbers differ from ``jax.random``'s for the same seed: weights
    cross between the packages through ``models/bridge.py``)."""
    device = generator.device

    def make(spec: PSpec):
        dtype = spec.dtype or param_dtype
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        if spec.init == "ssm_a":
            # A_log: log(uniform in [1, 16))
            u = torch.rand(spec.shape, generator=generator,
                           dtype=torch.float32, device=device)
            return torch.log(1.0 + 15.0 * u).to(dtype)
        if spec.init == "ssm_dt":
            # dt_bias: inverse softplus of a log-uniform dt in [1e-3, 1e-1]
            lo, hi = math.log(1e-3), math.log(1e-1)
            u = torch.rand(spec.shape, generator=generator,
                           dtype=torch.float32, device=device)
            dt = torch.exp(u * (hi - lo) + lo)
            return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
        if spec.init == "embed":
            std = 0.02
        elif spec.init == "normal":
            fan_in = spec.fan_in
            if fan_in is None:
                fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            std = 1.0 / math.sqrt(max(fan_in, 1))
        else:
            raise ValueError(f"init {spec.init!r} is not ported")
        v = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (v * std).to(dtype)

    return tree_from_leaves((path, make(spec))
                            for path, spec in tree_leaves(spec_tree))


def zeros_tree(spec_tree, device):
    """Zeros of every leaf of a PSpec tree (each spec carries its dtype),
    on ``device``: the caches."""
    return tree_from_leaves(
        (path, torch.zeros(spec.shape, dtype=spec.dtype, device=device))
        for path, spec in tree_leaves(spec_tree))


def unstack_layers(tree) -> list:
    """The per-layer trees of a stacked tree ([L, ...] leaves), as views:
    one ``unbind`` a leaf, whose backward stacks the L layers' gradients
    once.  Indexing one layer at a time would make each layer's backward
    fill and add a full [L, ...] gradient per leaf (L² layer-sized adds
    a step); the gradients are the same values."""
    if isinstance(tree, dict):
        per = {k: unstack_layers(v) for k, v in tree.items()}
        n = len(next(iter(per.values())))
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    return list(tree.unbind(0))


def axes_tree(spec_tree):
    """The tree of a PSpec tree's logical-axis tuples (the JAX package's
    ``axes_tree``)."""
    return tree_from_leaves((path, spec.axes)
                            for path, spec in tree_leaves(spec_tree))


def shapes_tree(spec_tree, param_dtype: torch.dtype = torch.float32):
    """The tree of a PSpec tree as tensors on the ``meta`` device: shapes
    and dtypes, no storage (the JAX package's ``ShapeDtypeStruct`` tree)."""
    return tree_from_leaves(
        (path, torch.empty(spec.shape, dtype=spec.dtype or param_dtype,
                           device="meta"))
        for path, spec in tree_leaves(spec_tree))


# ---------------------------------------------------------------------------
# Checkpointing (the JAX package's jax.checkpoint and its policies)
# ---------------------------------------------------------------------------

# The matrix products, as they reach the dispatcher (``matmul`` and
# ``einsum`` decompose into these).  The kernels of ``kernels/ops.py``
# launch through ctypes, so the dispatcher sees only their ``torch.empty``
# outputs: those are never saved, and a recompute launches the kernel
# into a fresh buffer.
_DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                      torch.ops.aten.bmm.default,
                      torch.ops.aten.baddbmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    if op in _DOT_OPS:
        return torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    return torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return torch.utils.checkpoint.create_selective_checkpoint_contexts(
        _save_dots)


def checkpoint(fn, *args, dots: bool = False):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant) while
    autograd records, and plainly otherwise.  Only the inputs are kept and
    the forward runs again in the backward; with ``dots`` the outputs of
    the matrix products are kept too and only the rest is recomputed, as
    ``jax.checkpoint_policies.checkpoint_dots`` keeps them.

    The recompute re-enters the caller's mesh (``sharding.set_mesh``)
    and training mode, read here at forward time: both are thread-local,
    and autograd runs a CUDA backward, and so the recompute, on a thread
    of its own, where neither is set.  So a recomputed layer takes the
    branches its forward took (the ring, the MoE block's
    tensor-parallel schedule)."""
    if not torch.is_grad_enabled():
        return fn(*args)
    mesh, training = sharding.current_mesh(), in_training()

    def context_fn():
        fwd, again = (_dots_context() if dots else
                      (contextlib.nullcontext(), contextlib.nullcontext()))
        return fwd, _recompute_in(mesh, training, again)

    # the models draw no random numbers: no RNG state to stash
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=context_fn)


@contextlib.contextmanager
def _recompute_in(mesh, training: bool, inner):
    with sharding.set_mesh(mesh), _training_as(training), inner:
        yield


# ---------------------------------------------------------------------------
# Norms / positional embeddings / activations
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps: float):
    return ops.rmsnorm(x, scale, eps)


def layernorm(x, scale, bias, eps: float):
    """LayerNorm over the last dim in f32 (population variance), the f32
    scale and bias applied, cast back to x's dtype; plain tensor code, as
    in the JAX package (no kernel computes it)."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def sinusoidal_positions(length: int, dim: int) -> np.ndarray:
    """[length, dim] f32: sin of pos / 10000^(2i/dim) in the first half,
    cos in the second (the encoder's positions)."""
    pos = np.arange(length)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / dim)
    return np.concatenate([np.sin(angle), np.cos(angle)],
                          axis=-1).astype(np.float32)


def rope(x, positions, theta: float):
    """Rotary embeddings. x: [..., S, H, hd]; positions: [..., S]."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., :, None].float() * freqs[None, :]  # [..., S, half]
    cos = torch.cos(angles)[..., :, None, :]   # [..., S, 1, half]
    sin = torch.sin(angles)[..., :, None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x, cap: float):
    if cap and cap > 0.0:
        return (torch.tanh(x / cap) * cap).to(x.dtype)
    return x


# ---------------------------------------------------------------------------
# Training mode
# ---------------------------------------------------------------------------

# Set by ``registry.loss_fn``.  The MoE block places its model-axis
# collectives by hand (``_moe_expert_block``) only when a backward pass
# follows, on a mesh whose model axis splits the expert width.
# Thread-local, as the mesh of ``sharding.set_mesh``: ``checkpoint``
# carries both into a recompute on autograd's thread.
_mode = threading.local()


@contextlib.contextmanager
def training_mode():
    with _training_as(True):
        yield


@contextlib.contextmanager
def _training_as(flag: bool):
    prev = getattr(_mode, "training", False)
    _mode.training = flag
    try:
        yield
    finally:
        _mode.training = prev


def in_training() -> bool:
    return getattr(_mode, "training", False)


# ---------------------------------------------------------------------------
# Causal self-attention
# ---------------------------------------------------------------------------

def attention_dispatch(cfg, q, k, v, *, causal: bool = True):
    """Attention for the forward pass: q [B,Sq,H,hd], k/v [B,Sk,KVH,hd].

    ``cfg.attention_impl="ring"`` with causal attention goes to
    ``collectives.ring_attention`` (the sequence split over the current
    mesh's model axis; plain attention without one).  Every other case
    ("xla", "xla_blockskip", "pallas", and non-causal "ring") goes
    through ``ops.flash_attention`` with the config's logit cap: the
    kernel on the card, its plain version on the CPU.  The JAX package's
    "xla" scan and the block-skip schedule compute the same function."""
    if cfg.attention_impl == "ring" and causal:
        from repro_torch.collectives.ring_attention import ring_attention
        return ring_attention(q, k, v, causal=True,
                              logit_cap=cfg.logit_softcap)
    return ops.flash_attention(q, k, v, causal=causal,
                               logit_cap=cfg.logit_softcap)


def attention(q, k, v, *, causal: bool, chunk: int = 1024):
    """Attention without a config (the encoder-decoder family's): q
    [B,Sq,H,hd], k/v [B,Sk,KVH,hd] through ``ops.flash_attention``.
    ``chunk`` is the JAX scan's key chunk, which does not change the
    function; non-causal attention takes any Sq and Sk."""
    del chunk
    return ops.flash_attention(q, k, v, causal=causal)


# ---------------------------------------------------------------------------
# Decode attention
# ---------------------------------------------------------------------------

def decode_attention(q, k_cache, v_cache, pos, *, logit_cap: float = 0.0):
    """Single-token attention against a cache.

    q: [B, 1, H, hd]; caches: [B, S, KVH, hd]; pos: [B] (index of the
    token just written: entries 0..pos are valid, so lengths = pos + 1).
    GQA by head grouping inside the kernel (no KV repeat)."""
    B, _, H, hd = q.shape
    lengths = (pos + 1).to(torch.int32)
    out = ops.flash_decode(q.reshape(B, H, hd), k_cache, v_cache, lengths,
                           logit_cap=logit_cap)
    return out.reshape(B, 1, H, hd)


# ---------------------------------------------------------------------------
# Attention block (params + apply), GQA + optional bias + RoPE
# ---------------------------------------------------------------------------

def padded_heads(cfg) -> tuple[int, int]:
    """(H, KVH) after optional padding to a multiple of cfg.pad_heads_to.

    Padding both H and KVH changes the GQA q→kv grouping, so this is an
    architecture variant (as in the JAX package), not a transform that
    keeps the model's function."""
    H, KVH = cfg.num_heads, cfg.num_kv_heads
    p = cfg.pad_heads_to
    if not p or not H:
        return H, KVH
    pad = lambda n: ((n + p - 1) // p) * p  # noqa: E731
    return pad(H), pad(KVH)


def attn_spec(cfg, layers: int | None = None, lora_rank: int = 0):
    D = cfg.d_model
    H, KVH = padded_heads(cfg)
    hd = cfg.resolved_head_dim()
    L = (layers,) if layers is not None else ()
    lax = ("layers",) if layers is not None else ()
    spec = {
        "wq": PSpec(L + (D, H, hd), lax + ("embed", "heads", "head_dim"), fan_in=D),
        "wk": PSpec(L + (D, KVH, hd), lax + ("embed", "kv_heads", "head_dim"), fan_in=D),
        "wv": PSpec(L + (D, KVH, hd), lax + ("embed", "kv_heads", "head_dim"), fan_in=D),
        "wo": PSpec(L + (H, hd, D), lax + ("heads", "head_dim", "embed"), fan_in=H * hd),
    }
    if cfg.qkv_bias:
        spec["bq"] = PSpec(L + (H, hd), lax + ("heads", "head_dim"), init="zeros")
        spec["bk"] = PSpec(L + (KVH, hd), lax + ("kv_heads", "head_dim"), init="zeros")
        spec["bv"] = PSpec(L + (KVH, hd), lax + ("kv_heads", "head_dim"), init="zeros")
    if lora_rank:
        for nm, outd, outax in (("q", (H, hd), ("heads", "head_dim")),
                                ("k", (KVH, hd), ("kv_heads", "head_dim")),
                                ("v", (KVH, hd), ("kv_heads", "head_dim"))):
            spec[f"lora_{nm}_a"] = PSpec(L + (D, lora_rank),
                                         lax + ("embed", None), fan_in=D)
            spec[f"lora_{nm}_b"] = PSpec(L + (lora_rank,) + outd,
                                         lax + (None,) + outax, init="zeros")
    return spec


def attn_qkv(p, x, positions, cfg, *, use_rope=True):
    """Project to q, k, v (with the LoRA deltas ``lora_{q,k,v}_{a,b}``
    where ``p`` has them, and optional bias) and apply RoPE.  The deltas
    x·a·b are added before the bias and RoPE, as in the JAX package."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    if "lora_q_a" in p:
        q, k, v = (t + torch.einsum(
            "bsr,rhk->bshk",
            torch.einsum("bsd,dr->bsr", x, p[f"lora_{nm}_a"].to(dt)),
            p[f"lora_{nm}_b"].to(dt)) for nm, t in (("q", q), ("k", k),
                                                    ("v", v)))
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_out(p, o):
    return torch.einsum("bshk,hkd->bsd", o, p["wo"].to(o.dtype))


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------

def mlp_spec(cfg, layers: int | None = None, d_ff: int | None = None):
    D = cfg.d_model
    Fd = d_ff if d_ff is not None else cfg.d_ff
    L = (layers,) if layers is not None else ()
    lax = ("layers",) if layers is not None else ()
    return {
        "wi_gate": PSpec(L + (D, Fd), lax + ("embed", "mlp"), fan_in=D),
        "wi_up": PSpec(L + (D, Fd), lax + ("embed", "mlp"), fan_in=D),
        "wo": PSpec(L + (Fd, D), lax + ("mlp", "embed"), fan_in=Fd),
    }


def mlp_apply(p, x, act=F.silu):
    dt = x.dtype
    g = torch.matmul(x, p["wi_gate"].to(dt))
    u = torch.matmul(x, p["wi_up"].to(dt))
    return torch.matmul(act(g) * u, p["wo"].to(dt))


# ---------------------------------------------------------------------------
# Mixture of experts (GShard capacity dispatch, Switch aux loss)
# ---------------------------------------------------------------------------

def moe_spec(cfg, layers: int | None = None):
    D, E = cfg.d_model, cfg.moe.num_experts
    Fd = cfg.moe.expert_d_ff
    L = (layers,) if layers is not None else ()
    lax = ("layers",) if layers is not None else ()
    return {
        "router": PSpec(L + (D, E), lax + ("embed", None), fan_in=D),
        "wi_gate": PSpec(L + (E, D, Fd), lax + ("experts", "embed", "expert_mlp"), fan_in=D),
        "wi_up": PSpec(L + (E, D, Fd), lax + ("experts", "embed", "expert_mlp"), fan_in=D),
        "wo": PSpec(L + (E, Fd, D), lax + ("experts", "expert_mlp", "embed"), fan_in=Fd),
    }


def _top_k(probs, k: int):
    """The ``k`` largest entries of the last dim and their indices, equal
    values in index order (``jax.lax.top_k``'s order; ``torch.topk``
    promises none, and bf16 router logits tie often)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_route(p, x, cfg):
    """Router + GShard capacity dispatch, shared by every MoE apply path.

    Returns ``(xg, dispatch, combine, aux)``: the grouped tokens
    ``[g, t, d]``, the dispatch mask and the combine weights
    ``[g, t, E, C]`` in x's dtype, and the Switch aux loss (f32).  Tokens
    go to their top-k experts one choice at a time (k-major), each at the
    next free place of its expert's capacity C; a token past C is
    dropped (its capacity row is all zeros).  The router's gradient flows
    through the gate values into ``combine`` and through the
    probabilities into the aux loss, never through the masks."""
    mc = cfg.moe
    B, S, D = x.shape
    T = B * S
    E, K = mc.num_experts, mc.top_k
    Gt = min(mc.group_size, T)
    if T % Gt != 0:
        Gt = T
    Gn = T // Gt
    C = max(1, int(math.ceil(Gt * K * mc.capacity_factor / E)))
    # capacity rounded to a multiple of 16, at most the group size
    C = int(min(Gt, ((C + 15) // 16) * 16))

    xg = x.reshape(Gn, Gt, D)
    logits = torch.matmul(xg, p["router"].to(x.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, gate_idx = _top_k(probs, K)                  # [g,t,K]
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    places = torch.arange(C, dtype=torch.float32, device=x.device)
    counts = torch.zeros((Gn, 1, E), dtype=torch.float32, device=x.device)
    combine = torch.zeros((Gn, Gt, E, C), dtype=x.dtype, device=x.device)
    sel_all = torch.zeros((Gn, Gt, E), dtype=torch.float32, device=x.device)
    for kk in range(K):
        sel_k = F.one_hot(gate_idx[:, :, kk], E).float()
        pos_k = counts + torch.cumsum(sel_k, dim=1) - sel_k  # [g,t,E]
        counts = counts + torch.sum(sel_k, dim=1, keepdim=True)
        keep_k = (pos_k < C).float() * sel_k
        # the token's place in its chosen expert, as a one-hot over C
        # (all zeros past the capacity, as jax.nn.one_hot gives)
        pos_tok = torch.sum(pos_k * sel_k, dim=-1)          # [g,t]
        cap_oh = (pos_tok[..., None] == places).to(x.dtype)  # [g,t,C]
        w_k = (gate_vals[:, :, kk:kk + 1] * keep_k).to(x.dtype)
        combine = combine + w_k[..., None] * cap_oh[:, :, None, :]
        sel_all = sel_all + sel_k
    dispatch = (combine > 0).to(x.dtype)

    # load-balance aux loss (Switch): E * sum_e mean prob * routed share
    me = torch.mean(probs, dim=(0, 1))
    fe = torch.mean(sel_all, dim=(0, 1)) / K
    aux = E * torch.sum(me * fe) * mc.aux_loss_weight
    return xg, dispatch, combine, aux


def _moe_dispatch(dispatch, xg):
    """[g,t,E,C] x [g,t,d] -> the dispatched tokens [g,E,C,d]."""
    return torch.einsum("gtec,gtd->gecd", dispatch, xg)


def _moe_expert_ffn(xe, wi_gate, wi_up, wo):
    """Every expert's SwiGLU on its dispatched tokens: [g,E,C,d] ->
    [g,E,C,d].  Each product is expert-local.  The input is made
    contiguous first, so that every path (moe_apply, expert-parallel
    native or user) hands the products the same layout and gets the same
    bits."""
    xe = xe.contiguous()
    h = (F.silu(torch.einsum("gecd,edf->gecf", xe, wi_gate))
         * torch.einsum("gecd,edf->gecf", xe, wi_up))
    return torch.einsum("gecf,efd->gecd", h, wo)


def _moe_combine(combine, ye):
    """[g,t,E,C] x [g,E,C,d] -> [g,t,d]."""
    return torch.einsum("gtec,gecd->gtd", combine, ye.contiguous())


# The tensor-parallel block is worth its combine-space sums only for wide
# experts (grok-1: F/tp = 8192 on 4 ranks); for many tiny experts
# (granite: F/tp = 128) the einsum branch stays, as in the JAX package.
MOE_TP_MIN_WIDTH = 512


def moe_tp_ranks(F_: int) -> int:
    """The model-axis ranks the MoE block splits the expert width ``F_``
    over: the current mesh's model axis when ``in_training()`` and that
    axis tp > 1 divides F into slices of at least ``MOE_TP_MIN_WIDTH``
    (the JAX package's condition for its hand-placed block), else 1."""
    mesh = sharding.current_mesh()
    tp = 1 if mesh is None else dict(mesh.shape).get("model", 1)
    if tp == 1 or F_ % tp or F_ // tp < MOE_TP_MIN_WIDTH or \
            not in_training():
        return 1
    return tp


def _moe_expert_block(xg, dispatch, combine, wi_gate, wi_up, wo):
    """Dispatch -> expert FFN -> combine.

    Training on a mesh whose model axis splits the expert width
    (``moe_tp_ranks``) takes the JAX package's tensor-parallel block
    with its hand-placed backward (``_MoEBlockTP``); everything else the
    einsum branch."""
    tp = moe_tp_ranks(wi_gate.shape[-1])
    if tp > 1:
        return _MoEBlockTP.apply(xg, dispatch, combine, wi_gate, wi_up, wo,
                                 tp)
    return _moe_combine(combine, _moe_expert_ffn(
        _moe_dispatch(dispatch, xg), wi_gate, wi_up, wo))


def _rank_slices(wi_gate, wi_up, wo, tp: int):
    """Rank r's slices of the expert width: ``wi_gate``/``wi_up``
    ``[E, d, F/tp]`` and ``wo`` ``[E, F/tp, d]`` (views; rank r of the
    stacked ``[tp, E, d, F/tp]`` the JAX ``P(None, None, "model")``
    places), r = 0 .. tp-1."""
    w = wi_gate.shape[-1] // tp
    return [(wi_gate[..., r * w:(r + 1) * w], wi_up[..., r * w:(r + 1) * w],
             wo[:, r * w:(r + 1) * w]) for r in range(tp)]


def _rank_sum(parts):
    """The psum over the model axis: the ranks' rows added in rank order."""
    total = parts[0]
    for t in parts[1:]:
        total = total + t
    return total


def _moe_blk_fwd_inner(xg, disp, comb, wi_gate, wi_up, wo, tp: int):
    """The tensor-parallel block's forward: each rank's expert FFN over
    its slice of F (a partial ``y`` [g, t, d]), the partials summed over
    the ranks.  Dispatch and combine are linear in the tokens, so the one
    model-axis sum of the forward is in token space, on ``y``."""
    xe = torch.einsum("gtec,gtd->gecd", disp, xg)            # every rank's
    parts = []
    for wg, wu, wo_r in _rank_slices(wi_gate, wi_up, wo, tp):
        h = (F.silu(torch.einsum("gecd,edf->gecf", xe, wg))
             * torch.einsum("gecd,edf->gecf", xe, wu))
        ye_p = torch.einsum("gecf,efd->gecd", h, wo_r)       # partial over F
        parts.append(torch.einsum("gtec,gecd->gtd", comb, ye_p))
    return _rank_sum(parts)


class _MoEBlockTP(torch.autograd.Function):
    """The JAX package's ``_make_moe_blk_vjp``: the forward of
    ``_moe_blk_fwd_inner``, saving only its inputs, and a hand-placed
    backward that recomputes each rank's forward intermediates locally.
    Its only cross-rank sums are those of ``d_xg`` [g, t, d] and
    ``d_comb`` [g, t, E, C], in token space; each rank's weight
    gradients stay on its slice and come back concatenated on F (each
    written into its slice of one gradient tensor).  The
    dispatch mask gets no gradient.  The JAX backward also sums the
    weight gradients over the batch (data) axes, whose ranks each hold
    some of the groups; the port's one pass over every group already
    sums over g.  ``tp`` is captured at forward time: the backward reads
    no mesh (autograd may run it on a thread of its own)."""

    @staticmethod
    def forward(ctx, xg, disp, comb, wi_gate, wi_up, wo, tp):
        ctx.save_for_backward(xg, disp, comb, wi_gate, wi_up, wo)
        ctx.tp = tp
        return _moe_blk_fwd_inner(xg, disp, comb, wi_gate, wi_up, wo, tp)

    @staticmethod
    def backward(ctx, dy):
        xg, disp, comb, wi_gate, wi_up, wo = ctx.saved_tensors
        dy = dy.to(xg.dtype)
        xe = torch.einsum("gtec,gtd->gecd", disp, xg)
        d_ye = torch.einsum("gtec,gtd->gecd", comb, dy)      # every rank's
        d_comb, d_xg = [], []
        # each rank's weight gradients land in its slice of F
        d_w = [torch.empty_like(t) for t in (wi_gate, wi_up, wo)]
        for (wg, wu, wo_r), (d_wg, d_wu, d_wo) in zip(
                _rank_slices(wi_gate, wi_up, wo, ctx.tp),
                _rank_slices(*d_w, ctx.tp)):
            # this rank's forward intermediates, recomputed
            g1 = torch.einsum("gecd,edf->gecf", xe, wg)
            u1 = torch.einsum("gecd,edf->gecf", xe, wu)
            sg = torch.sigmoid(g1.float())
            silu_g = (g1.float() * sg).to(g1.dtype)
            h = silu_g * u1
            ye_p = torch.einsum("gecf,efd->gecd", h, wo_r)
            d_comb.append(torch.einsum("gtd,gecd->gtec", dy, ye_p))
            d_h = torch.einsum("gecd,efd->gecf", d_ye, wo_r)
            d_wo.copy_(torch.einsum("gecf,gecd->efd", h, d_ye))
            d_silu_g = d_h * u1
            d_u1 = d_h * silu_g
            dsilu = (sg * (1 + g1.float() * (1 - sg))).to(g1.dtype)
            d_g1 = d_silu_g * dsilu
            d_xe = (torch.einsum("gecf,edf->gecd", d_g1, wg)
                    + torch.einsum("gecf,edf->gecd", d_u1, wu))
            d_wg.copy_(torch.einsum("gecd,gecf->edf", xe, d_g1))
            d_wu.copy_(torch.einsum("gecd,gecf->edf", xe, d_u1))
            d_xg.append(torch.einsum("gtec,gecd->gtd", disp, d_xe))
        return (_rank_sum(d_xg), None, _rank_sum(d_comb), *d_w, None)


def moe_apply(p, x, cfg):
    """GShard-style grouped capacity dispatch (einsum formulation):
    x [B,S,D] -> (y [B,S,D], aux loss).  For the explicitly placed
    expert-parallel variant see :func:`moe_apply_expert_parallel`."""
    B, S, D = x.shape
    xg, dispatch, combine, aux = _moe_route(p, x, cfg)
    dt = x.dtype
    y = _moe_expert_block(xg, dispatch.detach(), combine,
                          p["wi_gate"].to(dt), p["wi_up"].to(dt),
                          p["wo"].to(dt))
    return y.reshape(B, S, D), aux


def moe_dispatch_alltoall(xe, mesh, axis: str, *, reverse: bool = False,
                          coll=None, spec=None, timeout: float = 120.0):
    """Block-transpose the dispatched tensor between the group-sharded
    and the expert-sharded layouts: the MoE all-to-all, placed
    explicitly.

    ``xe`` is the global ``[G, E, C, d]`` dispatched tensor in the
    single-controller form of the port's collectives (every rank on one
    device).  Forward (``reverse=False``), rank s holds groups
    s·G/n .. of every expert and ends up holding every group's slice of
    its own experts; reverse undoes it.  Either way the global array is
    the same after the move.  Both dims must divide the axis size.

    The payload is the ``n·n`` blocks (source rank's groups x
    destination rank's experts), rank s's n outgoing blocks as its rows.
    ``coll=None`` is the native path: the block transpose of that
    rank-stacked payload in one tensor op.  A
    :class:`~repro_torch.collectives.nonblocking.UserCollectives` context
    sends the payload through the engine-driven Bruck ``ialltoall``
    instead.  All-to-all is pure data movement, so the two give the same
    bits."""
    n = dict(mesh.shape)[axis]
    G, E = xe.shape[0], xe.shape[1]
    if G % n or E % n:
        raise ValueError(
            f"moe_dispatch_alltoall: groups ({G}) and experts ({E}) must "
            f"divide the {axis!r} axis size ({n})")
    if n == 1:
        return xe
    Gl, El = G // n, E // n
    rest = tuple(xe.shape[2:])
    r_axes = tuple(range(4, 4 + len(rest)))
    blocks = xe.reshape(n, Gl, n, El, *rest)
    # block (s, r) of the payload: rank s sends it to rank r
    order = (2, 0, 1, 3) if reverse else (0, 2, 1, 3)
    pay = blocks.permute(order + r_axes).reshape(n * n, Gl, El, *rest)
    if coll is None:
        out = pay.reshape(n, n, Gl, El, *rest).transpose(0, 1)
    else:
        out = coll.ialltoall(pay, mesh, axis, spec=spec).wait(timeout=timeout)
        out = out.reshape(n, n, Gl, El, *rest)
    # out[i, j]: the block rank j sent to rank i
    if reverse:
        # (groups of i, experts of j) -> group-major global
        return out.permute((0, 2, 1, 3) + r_axes).reshape(G, E, *rest)
    # (groups of j, experts of i) -> group-major global
    return out.permute((1, 2, 0, 3) + r_axes).reshape(G, E, *rest)


def _moe_expert_ffn_sharded(mesh, axis: str):
    """The expert-sharded FFN: every contraction is expert-local, so the
    only collectives of the expert-parallel path are the two explicit
    all-to-alls around it.  Single-controller, as the port's
    collectives: every rank's experts in one batched product over the
    expert dim, whose leading factor is the rank."""
    n = dict(mesh.shape)[axis]

    def ffn(xed, wg, wu, wo):
        if xed.shape[1] % n or wg.shape[0] != xed.shape[1]:
            raise ValueError(
                f"expert-sharded FFN: experts ({xed.shape[1]}) must divide "
                f"the {axis!r} axis size ({n}) and match the weights "
                f"({wg.shape[0]})")
        return _moe_expert_ffn(xed, wg, wu, wo)

    return ffn


def moe_apply_expert_parallel(p, x, cfg, mesh, axis: str = "model", *,
                              coll=None, spec=None, timeout: float = 120.0):
    """Expert-parallel MoE with EXPLICIT all-to-all placement, the
    dispatch path for many-tiny-expert configs (granite-moe-3b-a800m:
    E=40 experts of F=512).

    Tokens are routed on the group-sharded layout, block-transposed to
    the expert shards (:func:`moe_dispatch_alltoall`), run through the
    expert-local FFN and transposed back for the combine.  With ``coll``
    the transposes are engine-driven user-space Bruck all-to-alls;
    without, the native block transpose.  The token math is the same
    tensor ops as :func:`moe_apply`'s on the same values, so the three
    paths agree bit for bit.  Returns (y, aux loss)."""
    B, S, D = x.shape
    xg, dispatch, combine, aux = _moe_route(p, x, cfg)
    dt = x.dtype
    xe = _moe_dispatch(dispatch, xg)                    # [G, E, C, d]
    xed = moe_dispatch_alltoall(xe, mesh, axis, coll=coll, spec=spec,
                                timeout=timeout)
    ye = _moe_expert_ffn_sharded(mesh, axis)(
        xed, p["wi_gate"].to(dt), p["wi_up"].to(dt), p["wo"].to(dt))
    ye = moe_dispatch_alltoall(ye, mesh, axis, reverse=True, coll=coll,
                               spec=spec, timeout=timeout)
    y = _moe_combine(combine, ye)
    return y.reshape(B, S, D), aux
