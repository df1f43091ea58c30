"""Payloads of a mesh with one device per rank: ``RankShards``.

The port's counterpart of a JAX array sharded on its leading dimension
over a mesh of devices: a tuple of ``n`` local tensors, shard ``r`` on
``mesh.devices[r]`` (``launch.mesh``).  Glued along the leading dim in
rank order, the shards are the rank-stacked tensor of the other mesh
form: shard ``r`` is that tensor's rows ``r*k .. (r+1)*k``.  So a
schedule's stacked carry ``[n, ...]`` (rank ``r`` in row ``r``) is, in
this form, ``n`` shards of ``[1, ...]``, and every per-shard round does
to shard ``r`` what the stacked round does to row ``r``.

``RankShards.from_stacked(x, mesh)`` and ``to_stacked(device)`` convert
between the forms (tests and checks compare through them; the main path
never converts).  ``shape`` is the stacked tensor's shape, ``dtype`` the
shards' dtype.

A value every rank holds whole (a parameter replica, a reduced gradient)
is also a ``RankShards``, of equal copies (``replicate``); trees of such
leaves go through ``tree_shard`` (rank ``r``'s tree), ``tree_stack`` (the
inverse) and ``tree_keep`` (the first ``k`` ranks).  Which of the two a
leaf is, the leaf says: ``replica`` is True for copies of one value
(``replicate``, ``tree_stack(..., replica=True)``; ``tree_keep`` keeps
the mark) and False for the blocks of a stacked tensor (the default:
``from_stacked``, a collective's payloads, ZeRO shards).  Between the two,
``copies = c`` says the shards are ``c`` copies, one after the other, of
the ``n / c`` blocks of one stacked tensor (shard ``i * n / c + b`` is copy
``i`` of block ``b``): a tensor split over one axis of a 2-D mesh and
replicated over the other, as pipeline stages' parameters on a (data x
stage) mesh (``from_stacked(..., copies=c)``) or FSDP's blocks on a (data
x model) mesh (``spread`` copies blocks to the rest of their rows).
``dim = k`` says the
blocks split dim ``k`` of the stacked tensor instead of the leading one
(the MoE block's expert-width slices on a model axis: ``[E, d, F/n]``
blocks of ``[E, d, F]``, ``dim`` 2); ``to_stacked`` and the checkpoint
glue them along it.  The checkpoint saves a
replica once and the blocks glued (the first copy's); nothing infers the
mark from equal values.  ``local(fn, *xs)``
applies ``fn`` to each rank's shards, or to the tensors themselves in the
stacked form: the trailing-dim code of the schedules runs unchanged on
both.
"""
from __future__ import annotations

import contextlib
import threading

import torch


class RankShards:
    """One local tensor per rank, each on its rank's device.  Every shard
    has the same shape and dtype."""

    __slots__ = ("shards", "replica", "copies", "dim")

    def __init__(self, shards, *, replica: bool = False, copies: int = 1,
                 dim: int = 0):
        shards = tuple(shards)
        if not shards:
            raise ValueError("RankShards needs at least one shard")
        if copies < 1 or len(shards) % copies or (replica and copies > 1):
            raise ValueError(f"{len(shards)} shards are not {copies} copies "
                             f"of the same blocks"
                             + (" (a replica has one block)" if replica
                                else ""))
        first = shards[0]
        for s in shards:
            if not isinstance(s, torch.Tensor):
                raise TypeError(f"a shard is {type(s).__name__}, not a "
                                f"tensor")
            if s.shape != first.shape or s.dtype != first.dtype:
                raise ValueError(
                    f"shards differ: {tuple(first.shape)} {first.dtype} "
                    f"and {tuple(s.shape)} {s.dtype}")
        if dim and (replica or not 0 <= dim < first.dim()):
            raise ValueError(f"blocks of {tuple(first.shape)} cannot split "
                             f"dim {dim}" + (" (a replica has one block)"
                                             if replica else ""))
        self.shards = shards
        self.replica = replica
        self.copies = copies
        self.dim = dim

    @classmethod
    def from_stacked(cls, x: torch.Tensor, mesh=None, *,
                     devices=None, copies: int = 1,
                     dim: int = 0) -> "RankShards":
        """The stacked tensor ``x`` (its leading dim, or ``dim``, split
        over the mesh's ranks in order, or over ``devices``) as a copy on
        each rank's device; with ``copies`` split over ``n / copies``
        blocks, each block placed once in every copy.  Each block is
        contiguous on its device."""
        devices = mesh.devices if mesh is not None else tuple(devices)
        n = len(devices)
        if copies < 1 or n % copies:
            raise ValueError(f"{n} ranks do not hold {copies} copies")
        blocks = n // copies
        if x.dim() <= dim or x.shape[dim] % blocks:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"split over {blocks} ranks")
        k = x.shape[dim] // blocks
        return cls((x.narrow(dim, (r % blocks) * k, k)
                    .to(d, copy=True).contiguous()
                    for r, d in enumerate(devices)), copies=copies, dim=dim)

    @property
    def blocks(self) -> tuple:
        """The shards of one copy: every shard of blocks, the first ``n /
        copies`` of copies."""
        return self.shards[:len(self.shards) // self.copies]

    def to_stacked(self, device) -> torch.Tensor:
        """The shards (of one copy) glued along the leading dim (``dim``),
        on ``device``."""
        return torch.cat([s.to(device) for s in self.blocks], dim=self.dim)

    def map(self, fn) -> "RankShards":
        """``fn`` on each shard, the layout (replica, copies, dim) kept."""
        return RankShards((fn(s) for s in self.shards), replica=self.replica,
                          copies=self.copies, dim=self.dim)

    @property
    def devices(self) -> tuple:
        return tuple(s.device for s in self.shards)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def shape(self) -> torch.Size:
        s = list(self.shards[0].shape)
        if not s:
            raise ValueError("0-d shards have no stacked shape")
        s[self.dim] *= len(self.blocks)
        return torch.Size(s)

    def numel(self) -> int:
        return sum(s.numel() for s in self.shards)

    def element_size(self) -> int:
        return self.shards[0].element_size()

    def __len__(self) -> int:
        return len(self.shards)

    def __iter__(self):
        return iter(self.shards)

    def __getitem__(self, r: int) -> torch.Tensor:
        return self.shards[r]

    def __repr__(self):
        s = self.shards[0]
        return (f"RankShards({len(self.shards)} x {tuple(s.shape)} "
                f"{s.dtype}{' replicas' if self.replica else ''}"
                f"{f' ({self.copies} copies)' if self.copies > 1 else ''}"
                f"{f' split on dim {self.dim}' if self.dim else ''} on ["
                + ", ".join(str(d) for d in self.devices) + "])")


def local(fn, *xs):
    """``fn`` on each rank's shards of the ``RankShards`` in ``xs`` (one
    call per rank), or on ``xs`` themselves when they are tensors."""
    if isinstance(xs[0], RankShards):
        return RankShards(fn(*parts) for parts in zip(*(x.shards for x in xs)))
    return fn(*xs)


def replicate(t: torch.Tensor, devices) -> RankShards:
    """A copy of ``t`` on each of ``devices`` (a replica)."""
    return RankShards((t.to(d, copy=True) for d in devices), replica=True)


def device_context(device):
    """``device`` made the current CUDA device for the block (nothing off
    the card): a rank's kernels run with their own card current."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


# What ``send`` moved between ranks (the model axis's ring hops and
# block copies): sends and their bytes, the ring hops among them, and the
# bytes that crossed between two devices (none where ranks share one).
transfers = dict.fromkeys(("sends", "bytes", "hops", "hop_bytes",
                           "cross_bytes"), 0)
_transfers_lock = threading.Lock()


def send(t: torch.Tensor, device, *, hop: bool = False) -> torch.Tensor:
    """``t`` for a rank on ``device``: a copy there (asynchronous for the
    host; PyTorch fences a copy between two cards on both cards' current
    streams), or ``t`` itself where it already is.  Counted in
    ``transfers`` (``hop``: a ring hop); autograd differentiates it as the
    copy it is."""
    device = torch.device(device)
    nbytes = t.numel() * t.element_size()
    with _transfers_lock:
        transfers["sends"] += 1
        transfers["bytes"] += nbytes
        if hop:
            transfers["hops"] += 1
            transfers["hop_bytes"] += nbytes
        if t.device != device:
            transfers["cross_bytes"] += nbytes
    return t.to(device, non_blocking=True)


def spread(blocks: RankShards, devices) -> RankShards:
    """``blocks`` (one copy of blocks, shard ``b`` on ``devices[b]``) as
    ``len(devices) / len(blocks)`` copies on ``devices`` (the order of
    ``RankShards`` copies): the first copy the blocks themselves, every
    other shard block ``b`` sent to its device (``send``, counted in
    ``transfers``)."""
    n, devices = len(blocks), list(devices)
    if len(devices) % n:
        raise ValueError(f"{len(devices)} devices do not hold copies of "
                         f"{n} blocks")
    return RankShards((blocks.shards[i] if i < n else
                       send(blocks.shards[i % n], d)
                       for i, d in enumerate(devices)),
                      copies=len(devices) // n)


def reset_transfers() -> None:
    with _transfers_lock:
        for k in transfers:
            transfers[k] = 0


def _zip_map(fn, trees):
    """``fn(leaves)`` over the matching leaves of same-shaped trees (dicts,
    named tuples, lists, tuples; a ``RankShards`` is a leaf)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _zip_map(fn, [t[k] for t in trees]) for k in t0}
    if isinstance(t0, tuple) and hasattr(t0, "_fields"):
        return type(t0)(*[_zip_map(fn, [getattr(t, f) for t in trees])
                          for f in t0._fields])
    if isinstance(t0, (list, tuple)):
        return type(t0)(_zip_map(fn, list(parts)) for parts in zip(*trees))
    return fn(trees)


def tree_shard(tree, r: int):
    """Rank ``r``'s tree: each ``RankShards`` leaf replaced by shard
    ``r`` (other leaves kept)."""
    return _zip_map(lambda ls: ls[0].shards[r]
                    if isinstance(ls[0], RankShards) else ls[0], [tree])


def tree_stack(trees, *, replica: bool = False):
    """Per-rank trees of tensors -> one tree of ``RankShards`` leaves
    (replicas when ``replica``)."""
    return _zip_map(lambda ls: RankShards(ls, replica=replica), list(trees))


def tree_keep(tree, k: int):
    """The first ``k`` ranks of every ``RankShards`` leaf (a replica stays
    one)."""
    return _zip_map(lambda ls: RankShards(ls[0].shards[:k],
                                          replica=ls[0].replica)
                    if isinstance(ls[0], RankShards) else ls[0], [tree])


def replicate_tree(tree, devices):
    """Every tensor leaf of ``tree`` replicated onto ``devices``."""
    return _zip_map(lambda ls: replicate(ls[0], devices)
                    if isinstance(ls[0], torch.Tensor) else ls[0], [tree])


def ranks_view(x, n: int):
    """A global payload ``[n*k, ...]`` as the schedules' rank view: the
    stacked ``[n, k, ...]`` (a view), or each shard ``[k, ...]`` as
    ``[1, k, ...]``."""
    if isinstance(x, RankShards):
        return local(lambda t: t.unsqueeze(0), x)
    return x.unflatten(0, (n, x.shape[0] // n))


def global_view(y):
    """Inverse of ``ranks_view``."""
    return local(lambda t: t.flatten(0, 1), y)
