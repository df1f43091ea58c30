"""The native collectives of a mesh with one device per rank.

The JAX package's native backend reduces inside the jitted step: XLA's
in-program ``psum`` / ``psum_scatter`` / ``all_gather``, which on GPUs
are NCCL's.  The port's counterpart takes ``RankShards`` payloads (one
tensor per rank, on its device) and runs, by where the ranks are:

* **every rank on a CUDA card of its own** (route ``"nccl"``): NCCL
  through PyTorch's single-process bindings (``torch.cuda.nccl``), one
  call over every rank's tensor, on each card's current stream.  Where
  NCCL is not available for those cards the call raises
  (``require_nccl``); nothing sums by copies instead;
* **ranks that share a device, or ranks on the CPU** (route
  ``"ordered"``, the plain version): the sum in rank order on rank 0's
  device, ``((x0 + x1) + x2) + x3``, each shard brought there with
  ``rank_shards.send`` and the result sent back the same way, so every
  copy is counted in ``rank_shards.transfers``.  On the CPU
  ``x.sum(0)`` over a contiguous ``[n, W]`` tensor of n <= 4 rows adds
  in that order, so the rank-stacked native step's sums equal these bit
  for bit.

``native_allreduce(xs, mean=...)`` gives every rank the sum (times 1/n
with ``mean``, as ``EngineGradReducer`` scales); ``native_reduce_scatter``
gives rank r block r of the sum's flattened elements; ``native_all_gather``
gives every rank the shards' flattened elements glued in rank order
(NCCL's flat layout: the caller reshapes).  The inputs are never written.
``routes`` counts the calls each route took; ``route(devices)`` says
which one a device list takes.

NCCL wants one contiguous tensor of one size and dtype a card.  Its
first call on a set of cards builds the communicator (hundreds of ms):
``warm(devices)`` does that outside a timed window.  Every rank's
producer must have run on its card's current stream (under
``rank_shards.device_context``): NCCL's kernels queue behind it there.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.collectives.rank_shards import RankShards, device_context, \
    send

# the calls each route took (which path a run's reductions went through)
routes = dict.fromkeys(("nccl", "ordered"), 0)
_routes_lock = threading.Lock()


def reset_routes() -> None:
    with _routes_lock:
        for k in routes:
            routes[k] = 0


def _count(name: str) -> None:
    with _routes_lock:
        routes[name] += 1


def route(devices) -> str:
    """``"nccl"`` where every one of two or more ranks is on a CUDA card of
    its own, else ``"ordered"``."""
    devices = [torch.device(d) for d in devices]
    if len(devices) > 1 and all(d.type == "cuda" for d in devices) \
            and len(set(devices)) == len(devices):
        return "nccl"
    return "ordered"


def nccl_available(devices) -> bool:
    """Whether PyTorch's NCCL bindings take tensors on ``devices``."""
    from torch.cuda import nccl
    return nccl.is_available([torch.empty(1, device=d) for d in devices])


def require_nccl(devices) -> None:
    """Raise where ``devices`` take the NCCL route and NCCL is not
    available for them (no fallback to copies)."""
    if route(devices) == "nccl" and not nccl_available(devices):
        raise RuntimeError(
            "the native collectives of ranks on distinct cards run on NCCL, "
            "and NCCL is not available for "
            + ", ".join(str(torch.device(d)) for d in devices))


def nccl_version() -> str:
    from torch.cuda import nccl
    return ".".join(str(v) for v in nccl.version())


def warm(devices) -> None:
    """Build the NCCL communicator of ``devices`` (nothing on the ordered
    route): one allreduce of an element a card, not counted in
    ``routes``."""
    if route(devices) == "nccl":
        from torch.cuda import nccl
        nccl.all_reduce([torch.zeros(1, device=d) for d in devices])


def _checked(xs: RankShards) -> list:
    """The shards for NCCL: contiguous, on distinct cards NCCL takes."""
    from torch.cuda import nccl
    tensors = list(xs.shards)
    if not nccl.is_available(tensors):
        require_nccl(xs.devices)
        raise ValueError(f"NCCL takes contiguous dense tensors, one a card: "
                         f"{xs!r}")
    return tensors


def _ordered_sum(xs: RankShards) -> torch.Tensor:
    """The shards' sum in rank order on rank 0's device."""
    first = xs.shards[0].device
    acc = xs.shards[0]
    for x in xs.shards[1:]:
        acc = acc + send(x, first)
    return acc


def plain_allreduce(xs: RankShards, *, mean: bool = False) -> RankShards:
    """The ordered route of ``native_allreduce``."""
    _count("ordered")
    with device_context(xs.shards[0].device):
        acc = _ordered_sum(xs)
        if mean:
            acc = acc * (1.0 / len(xs))
    return RankShards((send(acc, d) for d in xs.devices), replica=True)


def plain_reduce_scatter(xs: RankShards) -> RankShards:
    """The ordered route of ``native_reduce_scatter``."""
    _count("ordered")
    n = len(xs)
    with device_context(xs.shards[0].device):
        blocks = _ordered_sum(xs).reshape(n, -1)
    return RankShards(send(blocks[r], d) for r, d in enumerate(xs.devices))


def plain_all_gather(xs: RankShards) -> RankShards:
    """The ordered route of ``native_all_gather``."""
    _count("ordered")
    first = xs.shards[0].device
    with device_context(first):
        full = torch.cat([send(x, first).reshape(-1) for x in xs.shards])
    return RankShards((send(full, d) for d in xs.devices), replica=True)


def native_allreduce(xs: RankShards, *, mean: bool = False) -> RankShards:
    """Every rank the sum of the shards (their mean with ``mean``), a
    replica on the ranks' devices."""
    if route(xs.devices) == "ordered":
        return plain_allreduce(xs, mean=mean)
    from torch.cuda import nccl
    ins = _checked(xs)
    outs = [torch.empty_like(x) for x in ins]
    nccl.all_reduce(ins, outs)
    _count("nccl")
    if mean:
        for o in outs:
            with device_context(o.device):
                o.mul_(1.0 / len(outs))
    return RankShards(outs, replica=True)


def native_reduce_scatter(xs: RankShards) -> RankShards:
    """Rank r block r of the sum of the shards' flattened elements (1-D,
    ``numel / n`` of them; the numel must split over the ranks)."""
    n = len(xs)
    if xs.shards[0].numel() % n:
        raise ValueError(f"{xs!r} does not split over {n} ranks")
    if route(xs.devices) == "ordered":
        return plain_reduce_scatter(xs)
    from torch.cuda import nccl
    ins = [x.reshape(-1) for x in _checked(xs)]
    outs = [x.new_empty(x.numel() // n) for x in ins]
    nccl.reduce_scatter(ins, outs)
    _count("nccl")
    return RankShards(outs)


def native_all_gather(xs: RankShards) -> RankShards:
    """Every rank the shards' flattened elements glued in rank order (1-D,
    a replica)."""
    if route(xs.devices) == "ordered":
        return plain_all_gather(xs)
    from torch.cuda import nccl
    ins = [x.reshape(-1) for x in _checked(xs)]
    outs = [x.new_empty(x.numel() * len(ins)) for x in ins]
    nccl.all_gather(ins, outs)
    _count("nccl")
    return RankShards(outs, replica=True)
