"""Meshes of ranks for the port's single-controller collectives.

The JAX package lays a mesh over devices and runs each collective as a
``shard_map`` program whose payload is a global array sharded on its
leading dimension.  The port keeps that single-controller shape in two
forms of :class:`Mesh`:

* **rank-stacked** (``make_mesh(shape, axes, device)``): ONE
  ``torch.device`` carries every rank, and a collective's payload is the
  same global tensor, rank ``r``'s shard being its ``r``-th slice of the
  leading dimension;
* **one device per rank** (``make_mesh(shape, axes, devices=[...])``):
  rank ``r`` lives on ``devices[r]`` (row-major over the axes, as
  ``jax.sharding.Mesh.devices`` is laid out), and a payload is a
  ``collectives.rank_shards.RankShards``, one local tensor per rank on its
  device; a round of a collective copies between the ranks' devices.

``dict(mesh.shape)[axis]`` reads an axis size as it does on a JAX mesh.

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
    """Axis names, their sizes, and where the ranks live: ``device`` (every
    rank on one device, the rank-stacked form) or ``devices`` (one device
    per rank, row-major over the axes).  Equal meshes hash alike, so
    schedules cached per mesh are shared.

    ``mesh.devices`` exists only in the per-device form: a rank-stacked
    mesh has no per-rank devices, and reading it raises (a repeated
    device would pass for the other form, whose payloads differ).
    ``mesh.device`` likewise raises in the per-device form.  A device list
    that names a card this machine lacks raises; a device listed twice is
    allowed (two ranks on one card), only as the caller lists it."""

    __slots__ = ("axis_names", "sizes", "_device", "_devices")

    def __init__(self, shape, axis_names, device=None, *, devices=None):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} "
                             f"differ in length")
        if any(s < 1 for s in shape):
            raise ValueError(f"mesh axis sizes must be >= 1, got {shape}")
        if (device is None) == (devices is None):
            raise ValueError("a Mesh takes one device (rank-stacked) or a "
                             "device per rank (devices=[...]), not both "
                             "or neither")
        self.axis_names = axis_names
        self.sizes = shape
        self._device = None
        self._devices = None
        if devices is None:
            self._device = torch.device(device)
            return
        devices = tuple(_present(d) for d in devices)
        if len(devices) != math.prod(shape):
            raise ValueError(f"mesh {shape} has {math.prod(shape)} ranks, "
                             f"the device list {len(devices)}")
        self._devices = devices

    @property
    def per_device(self) -> bool:
        """True in the one-device-per-rank form."""
        return self._devices is not None

    @property
    def device(self) -> torch.device:
        if self._devices is not None:
            raise ValueError(f"{self!r} has a device per rank, not one "
                             f"device: read mesh.devices")
        return self._device

    @property
    def devices(self) -> tuple:
        if self._devices is None:
            raise ValueError(f"{self!r} is rank-stacked on one device: it "
                             f"has no per-rank devices (read mesh.device)")
        return self._devices

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        return collections.OrderedDict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def _key(self):
        return (self.axis_names, self.sizes, self._device, self._devices)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        axes = ", ".join(f"{a}={s}" for a, s in zip(self.axis_names,
                                                    self.sizes))
        if self._devices is not None:
            return (f"Mesh({axes}, devices=["
                    + ", ".join(str(d) for d in self._devices) + "])")
        return f"Mesh({axes}, device={self._device})"


def _present(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index spelt out; raises
    when it names a card this machine lacks (no fallback)."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(f"mesh device {device}: CUDA is not available")
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"mesh device {device}: this machine has "
                           f"{torch.cuda.device_count()} CUDA device(s)")
    return torch.device("cuda", index)


def make_mesh(shape, axes, device=None, *, devices=None) -> Mesh:
    """A mesh of ``prod(shape)`` ranks: on ``device`` (``cuda`` unless the
    caller asks for another; raises when CUDA is asked for and missing),
    or, with ``devices``, rank ``r`` on ``devices[r]``."""
    if devices is not None:
        if device is not None:
            raise ValueError("make_mesh takes device or devices, not both")
        return Mesh(shape, axes, devices=devices)
    from repro_torch import resolve_device
    return Mesh(shape, axes, resolve_device(device))


def axis_ranks(mesh: Mesh, axis: str) -> list:
    """``mesh``'s rank indices (row-major) with ``axis`` varying fastest:
    for each position on the other axes (row-major), that position's
    ``axis`` ranks in rank order.  That is the order of ``RankShards``
    copies of blocks split over ``axis`` and replicated over the other
    axes (JAX's ``NamedSharding(mesh, P(axis))``); its first
    ``size(axis)`` ranks are ``axis_column``'s."""
    a = mesh.axis_names.index(axis)
    n, stride = mesh.sizes[a], math.prod(mesh.sizes[a + 1:])
    return [(o * n + i) * stride + s
            for o in range(mesh.size // (n * stride))
            for s in range(stride) for i in range(n)]


def axis_order(mesh: Mesh, axis: str) -> list:
    """A per-device ``mesh``'s devices in ``axis_ranks`` order."""
    return [mesh.devices[r] for r in axis_ranks(mesh, axis)]


def axis_column(mesh: Mesh, axis: str) -> Mesh:
    """The ranks of ``axis`` at position 0 on every other axis (a data
    axis's leaders), as a mesh of the same axes, the others of size 1, on
    their devices; ``mesh`` itself where it is rank-stacked or its other
    axes have one rank."""
    n = dict(mesh.shape)[axis]
    if not mesh.per_device or mesh.size == n:
        return mesh
    return Mesh(tuple(n if name == axis else 1 for name in mesh.axis_names),
                mesh.axis_names, devices=axis_order(mesh, axis)[:n])


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
