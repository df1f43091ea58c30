"""Meshes of ranks for the port's single-controller collectives.

The JAX package lays a mesh over devices and runs each collective as a
``shard_map`` program whose payload is a global array sharded on its
leading dimension.  The port keeps that single-controller shape on one
card: a :class:`Mesh` names its axes and their sizes and holds ONE
``torch.device`` that carries every rank, and a collective's payload is
the same global tensor, rank ``r``'s shard being its ``r``-th slice of
the leading dimension (the rank-stacked form).  ``dict(mesh.shape)[axis]``
reads an axis size as it does on a JAX mesh.

``make_production_mesh`` names the dry run's meshes (the JAX package's
16x16 and 2x16x16, so that the records compare, and "1x1", the one card
on which a dry run meets a measurement) on the ``meta`` device; ``H100_SXM``
holds the card's constants for the roofline.
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


# The dry run's meshes: name -> (shape, axes).
PRODUCTION_MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


def make_production_mesh(name: str = "16x16") -> Mesh:
    """One of ``PRODUCTION_MESHES`` by name (the JAX package's 16x16 and,
    its ``multi_pod``, 2x16x16) on the ``meta`` device: no rank holds
    storage."""
    shape, axes = PRODUCTION_MESHES[name]
    return Mesh(shape, axes, "meta")


# Hardware constants for the roofline and the kernels' bounds: one NVIDIA
# H100 SXM (NVIDIA's data sheet, dense rates, at its 700 W limit).
H100_SXM = {
    "name": "h100-sxm",
    "peak_flops_bf16": 989e12,      # tensor cores, dense
    "peak_flops_f32": 67e12,        # outside the tensor cores
    "hbm_bytes_per_s": 3.35e12,
    "hbm_bytes": 80e9,
    "nvlink_bytes_per_s": 450e9,    # per direction, to any card of the node
    "nvlink_domain": 8,             # cards of one node, all to all
    # per card across nodes: one 400 Gb/s NDR port
    "network_bytes_per_s": 50e9,
}


def peak_flops(dtype, hw: dict = H100_SXM) -> float:
    """The card's peak rate for operations on ``dtype`` (a torch dtype or
    its name): the tensor cores' for bf16 and f16, else f32's."""
    name = str(dtype).replace("torch.", "")
    return hw["peak_flops_bf16"] if name in ("bfloat16", "float16") \
        else hw["peak_flops_f32"]


def link_bytes_per_s(chips: int, hw: dict = H100_SXM) -> float:
    """The slowest link a collective over ``chips`` cards crosses: NVLink
    within one node, the network port beyond it."""
    return hw["nvlink_bytes_per_s"] if chips <= hw["nvlink_domain"] \
        else hw["network_bytes_per_s"]
