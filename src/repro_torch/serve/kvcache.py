"""KV cache backends: fixed slots and paged blocks.

* ``SlotCache`` — the fixed-slot baseline: B monolithic rows of the
  model cache, one request per row (``registry.decode_step``).  Memory
  for a request is ``max_seq`` positions whatever its length.
* ``PagedKVCache`` — the serving engine's: a fixed pool of fixed-size KV
  *blocks* plus a free-list ``BlockAllocator``.  A request owns only the
  blocks its sequence actually touches (its *block table* maps logical
  block k to a physical pool index), so the same bytes admit far more
  concurrent requests than fixed ``max_seq`` rows; the serve engine
  preempts under block pressure instead of rejecting at admission.

Physical block 0 is reserved as a scratch block: idle decode lanes point
their whole table at it, so the fused decode step's unconditional
write-at-``pos`` lands somewhere harmless.  The masked decode attention
never reads a position ``> pos``, and sequential writes mean a freshly
extended block is only ever read at offsets that were just written —
stale bytes in recycled blocks are unreachable.

The host-side logic is the JAX package's (``serve/kvcache.py``);
``positions()`` and ``block_tables()`` return tensors on the cache's
device.  ``checkpoint_lane``/``restore_lane`` carry one lane's KV prefix
and per-lane state across pools as host numpy, keyed as the JAX pool
keys them, so a snapshot of either package restores into the other's.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.collectives.rank_shards import RankShards, \
    device_context, tree_shard, tree_stack
from repro_torch.models import registry
from repro_torch.models.layers import tree_leaves


def to_device(a: np.ndarray, device):
    """Host array -> tensor on ``device``, or, given a tuple of devices (a
    mesh with a device per rank), a ``RankShards`` replica: one copy on
    each.  On the card the copy goes through pinned memory without
    blocking, so it queues behind the work already on the stream instead
    of waiting for it."""
    t = torch.from_numpy(a)
    if isinstance(device, tuple):
        if any(d.type == "cuda" for d in device):
            t = t.pin_memory()
        return RankShards((t.to(d, non_blocking=True, copy=True)
                           for d in device), replica=True)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


@dataclasses.dataclass
class Slot:
    index: int
    request_id: Optional[str] = None
    pos: int = 0              # next write position == #valid tokens
    done: bool = True


class SlotCache:
    """Fixed-slot cache: one monolithic ``max_seq`` row per request.

    Free slots are tracked in a min-heap (``assign`` is O(log B)) and
    live request ids in a dict, so assigning an id that is already
    resident raises instead of silently occupying two slots with the
    same stream.
    """

    def __init__(self, cfg, batch_slots: int, max_seq: int, device=None):
        self.cfg = cfg
        self.max_seq = max_seq
        self.device = resolve_device(device)
        self.cache = registry.init_cache(cfg, batch_slots, max_seq,
                                         self.device)
        self.slots = [Slot(i) for i in range(batch_slots)]
        self._free_heap = list(range(batch_slots))   # already sorted
        self._by_request: dict[str, Slot] = {}

    @property
    def free_count(self) -> int:
        return len(self._free_heap)

    def free_slots(self) -> list[Slot]:
        return [self.slots[i] for i in sorted(self._free_heap)]

    def assign(self, request_id: str) -> Optional[Slot]:
        if request_id in self._by_request:
            raise ValueError(
                f"request_id {request_id!r} is already assigned to slot "
                f"{self._by_request[request_id].index}")
        if not self._free_heap:
            return None
        slot = self.slots[heapq.heappop(self._free_heap)]
        slot.request_id = request_id
        slot.pos = 0
        slot.done = False
        self._by_request[request_id] = slot
        return slot

    def release(self, slot: Slot) -> None:
        if slot.request_id is not None:
            self._by_request.pop(slot.request_id, None)
        slot.request_id = None
        slot.done = True
        slot.pos = 0
        heapq.heappush(self._free_heap, slot.index)

    def positions(self) -> torch.Tensor:
        """Each slot's next write position, [B] int32 on the device."""
        return to_device(np.array([s.pos for s in self.slots], np.int32),
                         self.device)

    def active_mask(self) -> np.ndarray:
        return np.array([not s.done for s in self.slots])

    def active_count(self) -> int:
        return len(self.slots) - len(self._free_heap)

    def reset_lane(self, cache, slot_index: int):
        """Zero a slot's recurrent state (ssm family) before it serves a
        new request; nothing for the dense family."""
        return registry.reset_cache_lane(self.cfg, cache, slot_index)


class BlockAllocationError(RuntimeError):
    """Misuse of the allocator (double alloc, freeing foreign blocks)."""


class BlockAllocator:
    """Free-list allocator over a fixed pool of KV blocks.

    Blocks are identified by their physical pool index; index 0 is
    reserved (the scratch block) and never handed out.  Each owner
    (request id) holds an ordered list of blocks — its block table.

    Invariants (property-tested in tests/test_paged_kvcache.py, and on
    this copy in tests/test_torch_serve.py):
      * a physical block is owned by at most one request at a time;
      * ``len(free) + sum(owned) == num_blocks - 1`` always;
      * block tables of live requests never alias;
      * allocating for an id that already owns blocks raises.

    Out-of-memory is a *signal*, not an error: ``alloc``/``extend``
    return ``None`` when the pool cannot satisfy the request, and the
    caller (the serve scheduler) reacts — defer admission, or preempt a
    victim and retry.
    """

    RESERVED = 1        # physical block 0 = scratch

    def __init__(self, num_blocks: int):
        if num_blocks < self.RESERVED + 1:
            raise ValueError(f"need at least {self.RESERVED + 1} blocks, "
                             f"got {num_blocks}")
        self.num_blocks = num_blocks
        self._free = list(range(self.RESERVED, num_blocks))  # min-heap
        heapq.heapify(self._free)
        self._owned: dict[str, list[int]] = {}

    # -- introspection ----------------------------------------------------
    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - self.RESERVED

    def owners(self) -> list[str]:
        return list(self._owned)

    def blocks_of(self, request_id: str) -> list[int]:
        return list(self._owned.get(request_id, ()))

    # -- alloc / extend / free --------------------------------------------
    def alloc(self, request_id: str, n: int) -> Optional[list[int]]:
        """Allocate ``n`` blocks for a new owner; ``None`` if the pool
        cannot satisfy it (nothing is allocated partially)."""
        if request_id in self._owned:
            raise BlockAllocationError(
                f"{request_id!r} already owns {len(self._owned[request_id])} "
                f"blocks — free before re-allocating")
        if n < 1:
            raise ValueError(f"alloc needs n >= 1, got {n}")
        if n > len(self._free):
            return None
        blocks = [heapq.heappop(self._free) for _ in range(n)]
        self._owned[request_id] = blocks
        return list(blocks)

    def extend(self, request_id: str, n: int = 1) -> Optional[list[int]]:
        """Append ``n`` more blocks to an existing owner's table;
        ``None`` on OOM (the preemption trigger)."""
        if request_id not in self._owned:
            raise BlockAllocationError(f"{request_id!r} owns no blocks")
        if n < 1:
            raise ValueError(f"extend needs n >= 1, got {n}")
        if n > len(self._free):
            return None
        blocks = [heapq.heappop(self._free) for _ in range(n)]
        self._owned[request_id].extend(blocks)
        return list(blocks)

    def free(self, request_id: str) -> int:
        """Return ALL of an owner's blocks to the free list."""
        blocks = self._owned.pop(request_id, None)
        if blocks is None:
            raise BlockAllocationError(f"{request_id!r} owns no blocks")
        for b in blocks:
            heapq.heappush(self._free, b)
        return len(blocks)


@dataclasses.dataclass
class Lane:
    """One row of the fused decode batch.  A lane is compute residency
    (a seat in the [B, ...] decode step); KV memory residency is the
    block table behind it."""
    index: int
    request_id: Optional[str] = None
    pos: int = 0
    done: bool = True


class PagedKVCache:
    """Paged KV pool + decode-lane bookkeeping.

    Per-request block tables (``block_tables()`` → ``[lanes, max_blocks]``
    int32, scratch-0 for unallocated entries), ``assign(request_id,
    seq_len)`` which reserves the blocks the sequence's prefill will
    touch, and ``ensure(lane_index, pos)`` which lazily extends the table
    one block at a time as decode advances (``False`` = pool exhausted:
    the caller's preemption trigger).

    ``mesh`` is recorded and the pool lives on the mesh's device: every
    model-axis rank of the port's single-controller mesh reads the one
    pool (the JAX pool is replicated over the mesh).  On a mesh with a
    device per rank the pool is a replica per rank (``cache`` a tree of
    ``RankShards`` replicas, one ``init_paged_cache`` on each device):
    every replica takes the same writes, so the host-side allocator and
    tables stay single, and ``positions``/``block_tables``/``place`` give
    one copy per device.  ``checkpoint_lane`` reads rank 0's replica, as
    the JAX snapshot reads its replicated pool; ``restore_lane`` writes
    every replica.
    """

    def __init__(self, cfg, lanes: int, max_seq: int, *,
                 block_size: int = 16, num_blocks: int | None = None,
                 mesh=None, device=None):
        if not registry.supports_paged(cfg):
            raise ValueError(
                f"paged serving not supported for family {cfg.family!r}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.cfg = cfg
        self.max_seq = max_seq
        self.block_size = block_size
        self.max_blocks = -(-max_seq // block_size)       # ceil
        self.has_blocks = registry.paged_has_blocks(cfg)
        if num_blocks is None:
            # full backing: every lane can hold max_seq (pressure — and
            # preemption — require an explicit smaller pool)
            num_blocks = lanes * self.max_blocks + BlockAllocator.RESERVED
        self.num_blocks = num_blocks
        self.allocator = BlockAllocator(num_blocks)
        if self.has_blocks and self.allocator.usable_blocks < self.max_blocks:
            raise ValueError(
                f"pool of {num_blocks} blocks cannot hold one max_seq="
                f"{max_seq} request ({self.max_blocks} blocks of "
                f"{block_size}) — a lone request would deadlock")
        self.devices = None
        if mesh is not None and mesh.per_device:
            if device is not None:
                raise ValueError(f"{mesh!r} has a device per rank: the pool "
                                 f"takes no device= beside it")
            self.devices = mesh.devices
            device = mesh.devices[0]
        elif mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"device {mesh.device}")
            device = mesh.device
        self.mesh = mesh
        self.device = resolve_device(device)
        if self.devices is None:
            self.cache = registry.init_paged_cache(cfg, lanes, num_blocks,
                                                   block_size, self.device)
        else:
            self.cache = tree_stack(
                [registry.init_paged_cache(cfg, lanes, num_blocks,
                                           block_size, d)
                 for d in self.devices], replica=True)
        self.slots = [Lane(i) for i in range(lanes)]
        self._free_heap = list(range(lanes))
        self._by_request: dict[str, Lane] = {}
        self._tables = np.zeros((lanes, self.max_blocks), np.int32)

    # -- lane surface ------------------------------------------------------
    @property
    def free_count(self) -> int:
        return len(self._free_heap)

    def free_slots(self) -> list[Lane]:
        return [self.slots[i] for i in sorted(self._free_heap)]

    def place(self, a: np.ndarray):
        """A host array on the pool's device, or a copy on each of its
        devices (``to_device``)."""
        return to_device(a, self.devices or self.device)

    def positions(self):
        """Each lane's next write position, [lanes] int32 on the device
        (a copy on each device of a per-device pool)."""
        return self.place(np.array([s.pos for s in self.slots], np.int32))

    def active_mask(self) -> np.ndarray:
        return np.array([not s.done for s in self.slots])

    def active_count(self) -> int:
        return len(self.slots) - len(self._free_heap)

    def _leaves(self, cache) -> list:
        """(path, leaf) of ``cache``, rank 0's replica of a per-device
        pool."""
        if self.devices is not None:
            cache = tree_shard(cache, 0)
        return list(tree_leaves(cache))

    # -- paged assignment --------------------------------------------------
    def blocks_for(self, seq_len: int) -> int:
        """Blocks the prefill of a ``seq_len``-token sequence (plus the
        first decode write at position seq_len-1) will touch."""
        if not self.has_blocks:
            return 0
        return max(1, -(-seq_len // self.block_size))

    def assign(self, request_id: str, seq_len: int = 1) -> Optional[Lane]:
        """Claim a lane AND the blocks its prefill needs; ``None`` if
        either is unavailable (nothing is claimed partially)."""
        if request_id in self._by_request:
            raise ValueError(
                f"request_id {request_id!r} is already assigned to lane "
                f"{self._by_request[request_id].index}")
        if seq_len > self.max_seq:
            raise ValueError(f"seq_len {seq_len} exceeds max_seq "
                             f"{self.max_seq}")
        if not self._free_heap:
            return None
        if self.has_blocks:
            blocks = self.allocator.alloc(request_id,
                                          self.blocks_for(seq_len))
            if blocks is None:
                return None
        else:
            blocks = []
        lane = self.slots[heapq.heappop(self._free_heap)]
        lane.request_id = request_id
        lane.pos = 0
        lane.done = False
        self._by_request[request_id] = lane
        self._tables[lane.index, :] = 0
        for k, b in enumerate(blocks):
            self._tables[lane.index, k] = b
        return lane

    def ensure(self, lane_index: int, pos: int) -> bool:
        """Make sure the block holding position ``pos`` is allocated for
        the lane's request; ``False`` = pool exhausted (preempt or
        stall).  Decode advances one position at a time, so at most one
        new block is needed per call."""
        if not self.has_blocks:
            return True
        lane = self.slots[lane_index]
        if lane.done:
            raise BlockAllocationError(f"lane {lane_index} is free")
        need = pos // self.block_size
        owned = self.allocator.blocks_of(lane.request_id)
        if need < len(owned):
            return True
        if need >= self.max_blocks:
            raise BlockAllocationError(
                f"position {pos} exceeds lane capacity "
                f"{self.max_blocks * self.block_size}")
        new = self.allocator.extend(lane.request_id, need - len(owned) + 1)
        if new is None:
            return False
        for k, b in enumerate(new):
            self._tables[lane_index, len(owned) + k] = b
        return True

    def release(self, lane: Lane) -> None:
        """Free the lane and every block behind it (the preemption /
        completion / failure path all route through here, so blocks can
        never leak)."""
        if lane.request_id is not None:
            self._by_request.pop(lane.request_id, None)
            if self.has_blocks and self.allocator.blocks_of(lane.request_id):
                self.allocator.free(lane.request_id)
        lane.request_id = None
        lane.done = True
        lane.pos = 0
        self._tables[lane.index, :] = 0
        heapq.heappush(self._free_heap, lane.index)

    def block_tables(self):
        """Current tables as a tensor [lanes, max_blocks] int32 on the
        device (a copy on each device of a per-device pool) — one
        argument of the fused paged decode step."""
        return self.place(self._tables.copy())

    def reset_lane(self, cache, lane_index: int):
        """Zero a lane's per-lane (non-block) state in ``cache`` before
        prefill — recurrent SSM state survives release (there are no
        blocks to recycle), so a recycled lane must not leak its previous
        occupant's state into the next request.  Every replica of a
        per-device pool, each with its device current."""
        if self.devices is None:
            return registry.reset_paged_lane(self.cfg, cache, lane_index)
        out = []
        for r, d in enumerate(self.devices):
            with device_context(d):
                out.append(registry.reset_paged_lane(
                    self.cfg, tree_shard(cache, r), lane_index))
        return tree_stack(out, replica=True)

    # -- per-lane checkpoint / restore (KV migration) ----------------------
    # Leaf classification is by shape against the pool geometry: a leaf
    # whose dims 1/2 are (num_blocks, block_size) is block-pooled KV
    # (k/v and their int8 scales); a leaf whose dim 1 is the lane count is
    # lane-indexed recurrent state (the ssm family's).  Block leaves are
    # checked first so a coincidental lanes == num_blocks match cannot
    # misfile pooled KV.

    def _is_block_leaf(self, leaf) -> bool:
        return (self.has_blocks and leaf.dim() >= 3
                and leaf.shape[1] == self.num_blocks
                and leaf.shape[2] == self.block_size)

    def _is_lane_leaf(self, leaf) -> bool:
        return leaf.dim() >= 2 and leaf.shape[1] == len(self.slots)

    @property
    def has_lane_state(self) -> bool:
        """True iff the pool holds per-lane state (not block-pooled KV)
        that a decode step overwrites in place."""
        return any(self._is_lane_leaf(leaf) and not self._is_block_leaf(leaf)
                   for _, leaf in self._leaves(self.cache))

    def _used_blocks(self, pos: int) -> int:
        return -(-pos // self.block_size) if (self.has_blocks and pos) else 0

    def checkpoint_lane(self, lane_index: int) -> dict:
        """Snapshot one lane's KV prefix + per-lane state to host memory.

        Walks the block table: for pooled leaves, gathers the lane's
        owned physical blocks (positions ``0..pos-1`` live in the first
        ``ceil(pos/block_size)`` table entries); for lane-indexed leaves,
        captures the lane's row.  The result is plain numpy, keyed by the
        leaf's path as ``jax.tree_util.keystr`` writes it (``['k']``), so
        a membership change can carry a decoding request's KV onto a pool
        rebuilt for the surviving mesh instead of replaying its whole
        prefix.  bf16 leaves are kept as f32, which holds them exactly.
        The copies to the host wait for the work queued on the pool; a
        per-device pool is read from rank 0's replica."""
        lane = self.slots[lane_index]
        if lane.done:
            raise BlockAllocationError(f"lane {lane_index} is free")
        pos = lane.pos
        used = self._used_blocks(pos)
        table = torch.from_numpy(self._tables[lane_index, :used].copy()) \
            .to(self.device)
        blocks: dict[str, np.ndarray] = {}
        state: dict[str, np.ndarray] = {}
        for path, leaf in self._leaves(self.cache):
            key = keystr(path)
            if self._is_block_leaf(leaf):
                if used:
                    blocks[key] = _to_host(leaf[:, table])
            elif self._is_lane_leaf(leaf):
                state[key] = _to_host(leaf[:, lane_index])
        return {"pos": pos, "blocks": blocks, "state": state}

    def restore_lane(self, cache, lane_index: int, ckpt: dict):
        """Write a ``checkpoint_lane`` snapshot into this pool's ``cache``
        for an already-``assign``ed lane (whose table must cover
        ``ckpt['pos']`` positions — ``assign(request_id, seq_len=pos+1)``
        guarantees that), in place — into every replica of a per-device
        pool.  Returns the cache and sets the lane's position; the caller
        owns the engine-side bookkeeping."""
        lane = self.slots[lane_index]
        if lane.done:
            raise BlockAllocationError(f"lane {lane_index} is free")
        pos = int(ckpt["pos"])
        used = self._used_blocks(pos)
        if used and used > len(self.allocator.blocks_of(lane.request_id)):
            raise BlockAllocationError(
                f"lane {lane_index} owns too few blocks to restore "
                f"{pos} positions")
        devices = self.devices or (self.device,)
        replicas = [cache] if self.devices is None else \
            [tree_shard(cache, r) for r in range(len(devices))]
        host_table = torch.from_numpy(self._tables[lane_index, :used].copy())
        for device, replica in zip(devices, replicas):
            table = host_table.to(device)
            for path, leaf in tree_leaves(replica):
                key = keystr(path)
                if used and key in ckpt["blocks"]:
                    leaf[:, table] = _from_host(ckpt["blocks"][key], leaf)
                elif key in ckpt["state"]:
                    leaf[:, lane_index] = _from_host(ckpt["state"][key], leaf)
        lane.pos = pos
        return cache


def keystr(path) -> str:
    """A dict-tree path as ``jax.tree_util.keystr`` writes it:
    ``('k',)`` -> ``"['k']"``."""
    return "".join(f"[{k!r}]" for k in path)


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def _from_host(a, like: torch.Tensor) -> torch.Tensor:
    """A snapshot array (numpy, ml_dtypes' bf16 included) as a tensor of
    ``like``'s dtype on its device."""
    a = np.require(a, requirements=["C", "W"])   # a JAX array's is read-only
    if a.dtype.name == "bfloat16":          # ml_dtypes' bf16: same bits
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(like.device, like.dtype)
