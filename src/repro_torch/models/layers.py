"""Shared model building blocks (the dense subset of the JAX package's
``models/layers.py``).

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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

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
    ``jax.checkpoint_policies.checkpoint_dots`` keeps them."""
    if not torch.is_grad_enabled():
        return fn(*args)
    kw = {"context_fn": _dots_context} if dots else {}
    # the models draw no random numbers: no RNG state to stash
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)


# ---------------------------------------------------------------------------
# Norms / positional embeddings / activations
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps: float):
    return ops.rmsnorm(x, scale, eps)


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
# Causal self-attention
# ---------------------------------------------------------------------------

def attention_dispatch(cfg, q, k, v, *, causal: bool = True):
    """Attention for the forward pass: q [B,Sq,H,hd], k/v [B,Sk,KVH,hd].

    Every ported ``cfg.attention_impl`` ("xla", "xla_blockskip",
    "pallas") goes through ``ops.flash_attention``: the kernel on the
    card, its plain version on the CPU.  The JAX package's "xla" scan and
    the block-skip schedule compute the same function; ring attention and
    a logit softcap, which the kernel lacks, raise (queued in ROADMAP)."""
    if cfg.attention_impl == "ring":
        raise NotImplementedError(
            "attention_impl='ring' is not ported (collectives slice)")
    if cfg.logit_softcap:
        raise NotImplementedError(
            f"logit_softcap={cfg.logit_softcap}: the flash_attention kernel "
            f"has no logit cap yet")
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


def attn_spec(cfg, layers: int | None = None):
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
    return spec


def attn_qkv(p, x, positions, cfg, *, use_rope=True):
    """Project to q, k, v (with optional bias) and apply RoPE."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
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
