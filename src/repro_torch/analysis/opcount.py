"""Operation and byte counts of one step on ``meta`` tensors: the port's
counterpart of ``analysis/hlo.py``.

The JAX package parses the compiled HLO of a cell.  An eager PyTorch
program has no such artifact, so ``count`` runs the cell's step once on
``meta`` arguments (shapes, no storage, nothing computed) under a
``TorchDispatchMode`` that sees every aten op, and counts:

* ``flops``            — matrix products by ``torch.utils.flop_counter``'s
  formulas (2·M·N·K), plus one per output element of each pointwise op
  (and of each dtype conversion, as ``hlo.py``'s ``convert``), plus one
  per operand element of each reduction, as ``hlo.py`` counts its
  ``_ELEMENTWISE`` set and ``reduce``; split by the operands' dtype;
* ``bytes``            — operand plus result bytes of every aten op that
  moves data (views and allocations move none).  An eager program runs
  one kernel per op, so this is its device-memory traffic: the
  counterpart of ``hlo.py``'s unfused top-level ops;
* ``kernels``          — each hand-written kernel's launches and its own
  work (``kernels/ops.py`` hands it over through ``recording_work``:
  the kernel's formulas, never the plain version's S×S arithmetic, which
  on CPU tensors runs uncounted in the kernel's place);
* ``saved_bytes_peak`` — the most bytes autograd held saved at once
  (``torch.autograd.graph.saved_tensors_hooks``, counted once a storage
  and not at all for the step's arguments): with the arguments and the
  step's outputs, the counterpart of ``memory_analysis()``.

The collective bytes come from the plans the port's collectives build for
the cell's mesh (``collective_bytes``), without running any rank's pass.
"""
from __future__ import annotations

import collections
import contextlib
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import ops

aten = torch.ops.aten

# ops that move no data: allocations (their first write is counted where it
# happens) and metadata
_NO_TRAFFIC = {aten.empty, aten.empty_like, aten.empty_strided,
               aten.new_empty, aten.new_empty_strided, aten.detach,
               aten.alias, aten.lift_fresh, aten._local_scalar_dense}
_CONVERTS = {aten._to_copy, aten.copy_, aten.copy}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class OpCounter(TorchDispatchMode):
    """Counts every aten op run inside the block (see the module's
    docstring); ``with OpCounter() as c: ...`` then ``c.result()``."""

    def __init__(self):
        super().__init__()
        self.flops_by_dtype: dict = collections.defaultdict(float)
        self.bytes = 0
        self.ops = 0
        self.in_kernel = 0
        self.kernels = collections.defaultdict(
            lambda: {"launches": 0, "flops": 0, "bytes": 0})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if self.in_kernel:              # the plain version of a kernel
            return out
        self.ops += 1
        if packet in _NO_TRAFFIC or func.is_view:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        self.bytes += sum(nbytes(t) for t in ins) + sum(nbytes(t)
                                                        for t in outs)
        dtype = ins[0].dtype if ins else (outs[0].dtype if outs else None)
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
        elif torch.Tag.pointwise in func.tags:
            f = sum(t.numel() for t in outs)
        elif torch.Tag.reduction in func.tags:
            f = ins[0].numel() if ins else 0
        elif packet in _CONVERTS and ins and outs \
                and outs[0].dtype != ins[-1].dtype:
            f = outs[0].numel()
        else:
            f = 0
        if f:
            self.flops_by_dtype[str(dtype).replace("torch.", "")] += f
        return out

    def kernel_begin(self, name, work, dtype) -> None:
        """A kernel's launch and its work (``work()``: flops, bytes); the
        ops until ``kernel_end`` (the plain version, on the CPU, and what
        ``work`` reads) are not counted."""
        self.in_kernel += 1
        flops, nbytes_ = work()
        k = self.kernels[name]
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes_
        self.flops_by_dtype[str(dtype).replace("torch.", "")] += flops
        self.bytes += nbytes_

    def kernel_end(self) -> None:
        self.in_kernel -= 1


class SavedTracker:
    """The bytes autograd holds saved, at most, over the block: each saved
    tensor is wrapped, and a storage counts while any wrapper of it is
    alive (autograd drops them once the backward has used them)."""

    def __init__(self, exclude: set):
        self.exclude = exclude          # storages of the step's arguments
        self.refs: dict = collections.Counter()
        self.live = 0
        self.peak = 0

    def pack(self, t):
        key = _storage_key(t)
        if key in self.exclude:
            return t
        if self.refs[key] == 0:
            self.live += t.untyped_storage().nbytes()
            self.peak = max(self.peak, self.live)
        self.refs[key] += 1
        return _Saved(self, key, t)

    @staticmethod
    def unpack(x):
        return x.t if isinstance(x, _Saved) else x

    def release(self, key, size):
        self.refs[key] -= 1
        if self.refs[key] == 0:
            self.live -= size


class _Saved:
    __slots__ = ("tracker", "key", "t", "__weakref__")

    def __init__(self, tracker, key, t):
        self.tracker, self.key, self.t = tracker, key, t

    def __del__(self):
        self.tracker.release(self.key, self.t.untyped_storage().nbytes())


def count(step_fn, args: tuple, *, mesh=None) -> dict:
    """Run ``step_fn(*args)`` once on meta ``args`` (inside
    ``sharding.set_mesh(mesh)`` when given) and count it (on CPU tensors
the same counts, but for a kernel's plain version, which runs in its
place); the dict keeps
    ``hlo.analyze``'s keys where they mean something, plus ``kernels``,
    ``flops_by_dtype``, ``ops``, ``argument_bytes``, ``output_bytes``,
    ``saved_bytes_peak`` and ``seconds`` (the meta step's host time)."""
    from repro_torch import sharding
    arg_keys = {}
    for t in _tensors(args):
        arg_keys.setdefault(_storage_key(t), t.untyped_storage().nbytes())
    counter = OpCounter()
    saved = SavedTracker(set(arg_keys))
    t0 = time.perf_counter()
    with ops.recording_work(counter), \
            torch.autograd.graph.saved_tensors_hooks(saved.pack,
                                                     saved.unpack), \
            (sharding.set_mesh(mesh) if mesh is not None
             else contextlib.nullcontext()), counter:
        out = step_fn(*args)
    seconds = time.perf_counter() - t0
    outs = {}
    for t in _tensors(out):
        key = _storage_key(t)
        if key not in arg_keys:
            outs.setdefault(key, t.untyped_storage().nbytes())
    return {
        "flops": float(sum(counter.flops_by_dtype.values())),
        "flops_by_dtype": dict(counter.flops_by_dtype),
        "bytes": float(counter.bytes),
        "ops": counter.ops,
        "kernels": {k: dict(v) for k, v in sorted(counter.kernels.items())},
        "argument_bytes": sum(arg_keys.values()),
        "output_bytes": sum(outs.values()),
        "saved_bytes_peak": saved.peak,
        "seconds": seconds,
    }


# ---------------------------------------------------------------------------
# Collective payloads of a cell on a mesh
# ---------------------------------------------------------------------------

def data_ranks(mesh_shape: dict) -> int:
    return mesh_shape.get("pod", 1) * mesh_shape.get("data", 1)


# the plans' schedule (a plan's payload is the same under every one) and
# the train launcher's FSDP bucket size (``--fsdp-bucket-bytes``)
ALGORITHM, CHUNKS, FSDP_BUCKET_BYTES = "ring", 1, 1 << 22


def collective_bytes(cell) -> dict:
    """Per-device payload bytes by collective type of the cell's step on
    its mesh, from the plans the port's collectives build (nothing runs):

    * train — FSDP over the data ranks (``pod`` × ``data``): each flat
      bucket of ``FsdpLayout`` is all-gathered and its gradient
      reduce-scattered once a step;
    * decode — the vocab-sharded serve gather over the ``model`` axis: the
      all-gather of the [n, B, V/n] f32 partial logits;
    * prefill — none.

    A plan's payload is the rank-stacked global tensor, so a device's
    share is ``payload_bytes / n`` (the per-device operand JAX's HLO
    counts).  An axis of one rank moves nothing."""
    from repro_torch.collectives import nonblocking as nb
    from repro_torch.collectives.overlap import FsdpLayout
    from repro_torch.launch.mesh import Mesh
    shape = dict(cell.mesh.shape)
    out: dict = {}
    if cell.shape.kind == "train":
        n = data_ranks(shape)
        if n == 1:
            return out
        mesh = Mesh((n,), ("data",), "meta")
        layout = FsdpLayout(cell.abstract_args[0], n, FSDP_BUCKET_BYTES)
        for b, width in enumerate(layout.widths):
            dt = layout.bucket_dtype(b)
            ag = nb._plan_allgather(mesh, "data", (n, width // n), dt,
                                    ALGORITHM, CHUNKS)
            rs = nb._plan_reduce_scatter(mesh, "data", (n, width), dt,
                                         ALGORITHM, CHUNKS)
            out["all-gather"] = out.get("all-gather", 0) \
                + ag.payload_bytes / n
            out["reduce-scatter"] = out.get("reduce-scatter", 0) \
                + rs.payload_bytes / n
    elif cell.shape.kind == "decode":
        n = shape.get("model", 1)
        V = cell.cfg.vocab_size
        if n == 1 or V % n:
            return out
        mesh = Mesh((n,), ("model",), "meta")
        B = cell.shape.global_batch
        ag = nb._plan_allgather(mesh, "model", (n, B, V // n),
                                torch.float32, ALGORITHM, CHUNKS)
        out["all-gather"] = ag.payload_bytes / n
    return out
