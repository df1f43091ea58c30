"""Meshes of ranks for the port's single-controller collectives.

The JAX package lays a mesh over devices and runs each collective as a
``shard_map`` program whose payload is a global array sharded on its
leading dimension.  The port keeps that single-controller shape on one
card: a :class:`Mesh` names its axes and their sizes and holds ONE
``torch.device`` that carries every rank, and a collective's payload is
the same global tensor, rank ``r``'s shard being its ``r``-th slice of
the leading dimension (the rank-stacked form).  ``dict(mesh.shape)[axis]``
reads an axis size as it does on a JAX mesh.
"""
from __future__ import annotations

import collections
import math

import torch


class Mesh:
    """Axis names, their sizes, and the device that holds every rank.
    Equal meshes hash alike, so schedules cached per mesh are shared."""

    __slots__ = ("axis_names", "sizes", "device")

    def __init__(self, shape, axis_names, device):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} "
                             f"differ in length")
        if any(s < 1 for s in shape):
            raise ValueError(f"mesh axis sizes must be >= 1, got {shape}")
        self.axis_names = axis_names
        self.sizes = shape
        self.device = torch.device(device)

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        return collections.OrderedDict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def _key(self):
        return (self.axis_names, self.sizes, self.device)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        axes = ", ".join(f"{a}={s}" for a, s in zip(self.axis_names,
                                                    self.sizes))
        return f"Mesh({axes}, device={self.device})"


def make_mesh(shape, axes, device=None) -> Mesh:
    """A mesh of ``prod(shape)`` ranks on ``device`` (``cuda`` unless the
    caller asks for another; raises when CUDA is asked for and missing)."""
    from repro_torch import resolve_device
    return Mesh(shape, axes, resolve_device(device))


def make_host_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """A ``(data, model)`` mesh of ranks on one device (smoke tests)."""
    return make_mesh((max(1, data), max(1, model)), ("data", "model"), device)
