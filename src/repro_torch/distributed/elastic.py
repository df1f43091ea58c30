"""Elastic scaling: rebuild the mesh after membership changes and restore
the latest checkpoint onto it (the port of the JAX package's
``distributed/elastic.py``).

Checkpoints store full (unsharded) tensors, so restoring onto a smaller
or larger mesh is a placement decision: the sharding rules are resolved
again against the new mesh.  On the port's rank-stacked mesh every rank
lives on the mesh's one device, so the restored tensors are the full
tensors on that device, returned beside the spec tree the rules give for
the new mesh (a spec a dim cannot take raises, as in JAX).  On a mesh
with one device per rank each device receives the block its spec gives
it, as JAX places a ``NamedSharding``.  ``remesh`` also builds a mesh
with one device per rank from the surviving devices.
Combined with ``AsyncCheckpointer``'s atomic commits, a membership loss
costs at most the work since the last committed step.
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch.launch.mesh import make_mesh
from repro_torch.sharding import axis_rules, merged_rules, spec_tree


def largest_pof2(n: int) -> int:
    if n < 1:
        raise ValueError(f"largest_pof2 needs n >= 1, got {n}")
    return 1 << (n.bit_length() - 1)


def plan_mesh(n_devices: int, *, prefer_model: int = 16) -> tuple[tuple, tuple]:
    """Pick a (data, model) mesh for an arbitrary surviving device count.

    Keeps the model axis at `prefer_model` when divisible (TP degree is a
    property of the model, not of the incident), otherwise the largest
    power-of-two that fits."""
    if n_devices < 1:
        # total membership loss is not a mesh-planning problem; surface
        # the survivor count instead of largest_pof2's shift-count error
        raise ValueError(
            f"plan_mesh: cannot build a mesh for {n_devices} surviving "
            f"device(s); at least 1 is required")
    n = largest_pof2(n_devices)
    model = prefer_model
    while model > 1 and n % model:
        model //= 2
    return (n // model, model), ("data", "model")


def remesh(n_devices: Optional[int] = None, prefer_model: int = 16,
           device=None, *, devices=None):
    """The survivors' ``(data, model)`` mesh of ranks on ``device``
    (``cuda`` unless the caller asks for another), or, given the
    surviving ``devices`` (one per rank), on the first of them the mesh
    takes, as the JAX package's mesh takes the first of
    ``jax.devices()``.  ``n_devices`` is the surviving rank count
    (default: ``len(devices)``, else 1: the one card)."""
    if n_devices is not None:
        n = n_devices
    else:
        n = len(devices) if devices is not None else 1
    if n < 1:
        raise ValueError(
            f"remesh: cannot rebuild a mesh for {n} surviving "
            f"device(s); at least 1 is required")
    shape, axes = plan_mesh(n, prefer_model=prefer_model)
    if devices is None:
        return make_mesh(shape, axes, device)
    devices = list(devices)
    if device is not None:
        raise ValueError("remesh takes device or devices, not both")
    if n > len(devices):
        raise ValueError(f"remesh: {n} survivor(s) on {len(devices)} "
                         f"device(s)")
    return make_mesh(shape, axes, devices=devices[:math.prod(shape)])


def reshard_restore(checkpointer, step: int, like_tree, axes_tree, new_mesh,
                    rules_overrides=None):
    """Restore checkpoint ``step`` onto ``new_mesh``: ``(tree, specs)``,
    the tree and its spec tree resolved for the new mesh.

    On a rank-stacked mesh the leaves are the full tensors on the mesh's
    device.  On a mesh with a device per rank each leaf is a
    ``RankShards`` whose shard ``r`` lives on ``new_mesh.devices[r]`` and
    is the block of the full tensor that the leaf's spec gives rank
    ``r``'s mesh coordinate (row-major over the axes, as
    ``jax.sharding.Mesh.devices``): the block JAX's
    ``NamedSharding(mesh, spec).devices_indices_map(shape)`` gives the
    r-th device.  These shards are device blocks, not rows of a stacked
    tensor (``to_stacked`` does not glue them back unless the spec
    splits only the leading dim); a leaf the spec replicates comes back
    whole on every device, a replica."""
    rules = merged_rules(rules_overrides)
    with axis_rules(rules):
        specs = spec_tree(axes_tree, like_tree, new_mesh)
    if not new_mesh.per_device:
        return checkpointer.restore(step, like_tree, new_mesh.device), specs
    full = checkpointer.restore(step, like_tree, "cpu")
    return _place_blocks(full, specs, new_mesh), specs


def _device_blocks(t, spec, mesh):
    """``t`` as a ``RankShards`` of the blocks ``spec`` gives the devices
    of a mesh with a device per rank (see ``reshard_restore``)."""
    from repro_torch.collectives.rank_shards import RankShards
    sizes = dict(mesh.shape)
    parts = []
    for r, dev in enumerate(mesh.devices):
        coord, rest = {}, r
        for name, size in reversed(list(zip(mesh.axis_names, mesh.sizes))):
            coord[name], rest = rest % size, rest // size
        index = []
        for dim, entry in enumerate(spec):
            if entry is None:
                index.append(slice(None))
                continue
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            pos, count = 0, 1
            for a in axes:
                pos, count = pos * sizes[a] + coord[a], count * sizes[a]
            width = t.shape[dim] // count
            index.append(slice(pos * width, (pos + 1) * width))
        parts.append(t[tuple(index)].to(dev, copy=True).contiguous())
    return RankShards(parts, replica=all(e is None for e in spec))


def _place_blocks(tree, specs, mesh):
    if isinstance(tree, dict):
        return {k: _place_blocks(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        parts = [_place_blocks(v, sp, mesh) for v, sp in zip(tree, specs)]
        return (type(tree)(*parts) if hasattr(tree, "_fields")
                else type(tree)(parts))
    return _device_blocks(tree, specs, mesh)
