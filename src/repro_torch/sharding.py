"""Logical-axis sharding rules (MaxText-style) with divisibility fallback:
the rule tables and their resolution, from the JAX package's
``sharding.py``.

Model code annotates every parameter and key activation with *logical*
axis names (``"embed"``, ``"heads"``, ``"vocab"`` …).  A rule table maps
each logical axis to an ordered list of candidate mesh-axis assignments;
at resolution time the first candidate whose mesh-axis-size product
divides the actual dimension is chosen, otherwise the dim is replicated.

A resolved spec is a tuple with one entry per leading dim, each ``None``
(replicated), one mesh axis name, or a tuple of names (composed axes),
trailing ``None``s trimmed — the JAX ``PartitionSpec``'s entries.  On the
port's single-controller mesh every rank lives on one device, so a spec
places nothing; it is what ``elastic.reshard_restore`` hands back beside
the restored tensors, and it raises where the JAX resolution raises.

The placement side — ``logical_sharding``, ``tree_shardings`` and
``shard_hint`` — resolves the same specs and places nothing either.
There is no GSPMD to act on them: what a spec would place, the callers
slice by hand, rank by rank.  The sharded serve engine computes each
model-axis rank's vocabulary slice of the unembed explicitly
(``models.transformer.unembed_ranks``) and gathers the slices with a
collective.  ``shard_hint(x, *axes)`` resolves against the mesh of the
innermost ``set_mesh`` block, returns ``x`` unchanged, and raises where
``resolve_spec`` raises; outside any ``set_mesh`` block it does nothing,
as the JAX ``shard_hint`` does outside a mesh context.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Mapping, Sequence

MeshAxes = tuple[str, ...]
Rules = Mapping[str, Sequence[MeshAxes]]

# Candidate mesh assignments per logical axis, in priority order.  Each
# candidate is a tuple of mesh axis names (composed axes) or () for
# "replicate".  "fsdp" axes shard parameters/optimizer state ZeRO-style.
# Default production rules for a ("pod", "data", "model") mesh.
DEFAULT_RULES: Rules = {
    # --- parameter / activation axes ---
    "embed":      (("pod", "data"), ("data",), ()),   # FSDP shard dim
    "embed_nofsdp": ((),),                             # replicated variant
    "mlp":        (("model",), ()),
    "heads":      (("model",), ()),
    "kv_heads":   (("model",), ()),
    "head_dim":   ((),),
    "qkv":        (("model",), ()),
    "vocab":      (("model",), ()),
    "experts":    (("model",), ()),
    "expert_mlp": (("model",), ()),
    "state":      ((),),                               # SSM state dim
    "conv":       ((),),
    "layers":     ((),),                               # scan axis
    # --- batch/sequence activation axes ---
    "batch":      (("pod", "data"), ("data",), ()),
    "act_seq":    ((),),                               # sequence (activations)
    "cache_seq":  (("model",), ()),                    # KV-cache sequence
    "cache_batch": (("pod", "data"), ("data",), ()),   # KV-cache batch rows
    "act_embed":  ((),),
    "act_heads":  (("model",), ()),
    "act_kv_heads": (("model",), ()),
    "act_mlp":    (("model",), ()),
    "act_vocab":  (("model",), ()),
    "act_experts": (("model",), ()),
    "expert_cap": (("model",), ()),                    # MoE capacity dim
    "act_expert_mlp": (("model",), ()),
    "moe_groups": (("pod", "data"), ("data",), ()),    # MoE token groups
    "frames":     ((),),                               # audio/vision frontend
}

_local = threading.local()


def current_rules() -> Rules:
    return getattr(_local, "rules", DEFAULT_RULES)


@contextlib.contextmanager
def axis_rules(rules: Rules):
    """Override the logical→mesh rule table within a scope."""
    prev = getattr(_local, "rules", DEFAULT_RULES)
    _local.rules = rules
    try:
        yield
    finally:
        _local.rules = prev


def merged_rules(overrides: Mapping[str, Sequence[MeshAxes]] | None) -> Rules:
    if not overrides:
        return dict(DEFAULT_RULES)
    out = dict(DEFAULT_RULES)
    out.update(overrides)
    return out


def _mesh_axis_size(mesh, axes: MeshAxes) -> int:
    n = 1
    shape = dict(mesh.shape)
    for a in axes:
        n *= shape[a]
    return n


def resolve_spec(logical_axes: Sequence[str | None], shape,
                 mesh, rules: Rules | None = None) -> tuple:
    """Resolve logical axes for a concrete shape into a spec tuple.

    Falls back to replication for any dim the preferred mesh axes do not
    divide, and never assigns the same mesh axis to two dims.  ``shape``
    is a sequence of ints or anything with a ``shape``."""
    rules = rules or current_rules()
    shape = tuple(getattr(shape, "shape", shape))
    assert len(logical_axes) == len(shape), (logical_axes, shape)
    mesh_shape = dict(mesh.shape)
    used: set[str] = set()
    parts: list = []
    for name, dim in zip(logical_axes, shape):
        if name is None:
            parts.append(None)
            continue
        candidates = rules.get(name)
        if candidates is None:
            raise KeyError(f"no sharding rule for logical axis {name!r}")
        chosen: MeshAxes = ()
        for cand in candidates:
            if any(a in used for a in cand):
                continue
            if any(a not in mesh_shape for a in cand):
                continue
            size = _mesh_axis_size(mesh, cand)
            if size == 1 or (dim % size == 0 and size > 1):
                chosen = cand
                break
        if chosen:
            used.update(chosen)
            parts.append(chosen if len(chosen) > 1 else chosen[0])
        else:
            parts.append(None)
    # trim trailing Nones (canonical form)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def spec_tree(tree_axes, tree_shapes, mesh, rules: Rules | None = None):
    """Map a tree of logical-axis tuples and a matching tree of shapes
    (tensors, or anything with ``shape``) to a tree of spec tuples."""
    if _is_axes(tree_axes):
        return resolve_spec(tree_axes, tree_shapes, mesh, rules)
    if isinstance(tree_axes, dict):
        return {k: spec_tree(v, tree_shapes[k], mesh, rules)
                for k, v in tree_axes.items()}
    if isinstance(tree_axes, (list, tuple)):
        parts = [spec_tree(a, s, mesh, rules)
                 for a, s in zip(tree_axes, tree_shapes)]
        # a NamedTuple (the int8 weights' QuantizedTensor) takes its
        # fields as arguments
        return (type(tree_axes)(*parts) if hasattr(tree_axes, "_fields")
                else type(tree_axes)(parts))
    raise TypeError(f"spec_tree: {type(tree_axes).__name__} is neither a "
                    f"logical-axis tuple nor a container")


# ---------------------------------------------------------------------------
# Placement: the resolved specs, and the current mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a resolved spec tuple — what JAX's ``NamedSharding``
    holds; ``tuple(jax_sharding.spec)`` equals ``spec``.  It places
    nothing on the port's single-controller mesh."""
    mesh: Any
    spec: tuple


def logical_sharding(logical_axes: Sequence[str | None], shape, mesh,
                     rules: Rules | None = None) -> NamedSharding:
    return NamedSharding(mesh, resolve_spec(logical_axes, shape, mesh, rules))


def tree_shardings(tree_axes, tree_shapes, mesh, rules: Rules | None = None):
    """Map a tree of logical-axis tuples and a matching tree of shapes to
    a tree of :class:`NamedSharding`."""
    if _is_axes(tree_axes):
        return logical_sharding(tree_axes, tree_shapes, mesh, rules)
    if isinstance(tree_axes, dict):
        return {k: tree_shardings(v, tree_shapes[k], mesh, rules)
                for k, v in tree_axes.items()}
    if isinstance(tree_axes, (list, tuple)):
        return type(tree_axes)(tree_shardings(a, s, mesh, rules)
                               for a, s in zip(tree_axes, tree_shapes))
    raise TypeError(f"tree_shardings: {type(tree_axes).__name__} is neither "
                    f"a logical-axis tuple nor a container")


def current_mesh():
    """The mesh of the innermost ``set_mesh`` block, or None."""
    return getattr(_local, "mesh", None)


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` the one ``shard_hint`` resolves against."""
    prev = getattr(_local, "mesh", None)
    _local.mesh = mesh
    try:
        yield mesh
    finally:
        _local.mesh = prev


def shard_hint(x, *logical_axes: str | None):
    """Check ``x``'s logical axes against the current mesh and return
    ``x`` unchanged (the JAX ``shard_hint`` constrains the placement
    there).  Outside a ``set_mesh`` block this is a no-op, so model code
    is written once."""
    mesh = current_mesh()
    if mesh is not None:
        resolve_spec(logical_axes, x.shape, mesh)
    return x
