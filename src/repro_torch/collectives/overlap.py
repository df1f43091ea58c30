"""Computation/communication overlap (paper §2.3–§2.4): the port of the
JAX package's ``collectives/overlap.py``.

* ``allreduce_tree`` / ``microbatched_grad_fn`` — bucketed gradient
  reduction with the user schedules, on rank-stacked trees;
* ``EngineGradReducer`` — DDP-style bucketed allreduce driven by the
  progress engine: persistent per-bucket schedules whose rounds run on
  the collective CUDA stream while the caller keeps computing;
* ``collective_matmul_ag`` / ``collective_matmul_rs`` — all-gather→matmul
  and matmul→reduce-scatter as ring loops that multiply the resident
  chunk while the next one moves (Wang et al.'s collective matmul).

Trees are nested dicts (keys in sorted order, as ``jax.tree.flatten``
visits them), lists and tuples; a rank-stacked leaf is ``[n, *shape]``,
rank r's value in row r.  On a mesh with a device per rank the
``EngineGradReducer`` takes ``RankShards`` leaves instead (rank r's
``[1, *shape]`` on its device) and returns each rank's reduced copy on
its device; FSDP's flat buckets are ``RankShards`` blocks likewise (rank
r's ``[1, W/n]`` shard and ``[1, W]`` gathered flat on its device), and
the ``FsdpReducer``'s reduce-scatters and chained gathers copy between
the devices.
"""
from __future__ import annotations

import functools
import threading
import time
from typing import Callable

import torch

from repro_torch.collectives import schedules as S
from repro_torch.collectives.rank_shards import RankShards, local
from repro_torch.core import debug


def tree_flatten(tree):
    """(leaves, unflatten): the leaves in ``jax.tree.flatten`` order and
    the function that rebuilds the tree's structure from new leaves."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        subs = [tree_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        subs = [tree_flatten(v) for v in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(s[0]) for s in subs]

    def unflatten(leaves):
        out, off = [], 0
        for (_, rebuild), size in zip(subs, sizes):
            out.append(rebuild(leaves[off:off + size]))
            off += size
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return [leaf for s in subs for leaf in s[0]], unflatten


# ---------------------------------------------------------------------------
# Bucketed gradient reduction
# ---------------------------------------------------------------------------

def _buckets(leaves, bucket_bytes: int, nbytes: Callable) -> list:
    """Per-dtype buckets of leaf indices, each closed once it holds
    ``bucket_bytes`` (one open bucket per dtype, so interleaved dtypes
    still coalesce)."""
    buckets, open_buckets, order = [], {}, []
    for i, leaf in enumerate(leaves):
        dt = leaf.dtype
        if dt not in open_buckets:
            open_buckets[dt] = [[], 0]
            order.append(dt)
        cur = open_buckets[dt]
        cur[0].append(i)
        cur[1] += nbytes(leaf)
        if cur[1] >= bucket_bytes:
            buckets.append(cur[0])
            open_buckets[dt] = [[], 0]
    for dt in order:
        if open_buckets[dt][0]:
            buckets.append(open_buckets[dt][0])
    return buckets


def bucket_tree(tree, bucket_bytes: int = 1 << 25):
    """Partition tree leaves into ~``bucket_bytes`` buckets (DDP-style):
    lists of leaf indices in ``tree_flatten`` order, one dtype each (a
    mixed concat would promote).  Non-tensor leaves raise."""
    leaves, _ = tree_flatten(tree)
    for i, leaf in enumerate(leaves):
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(
                f"bucket_tree: leaf {i} is {type(leaf).__name__}, not a "
                f"tensor; bucketed reduction needs tensor leaves (wrap "
                f"scalars in torch.as_tensor)")
    return _buckets(leaves, bucket_bytes,
                    lambda leaf: leaf.numel() * leaf.element_size())


def allreduce_tree(grads, algorithm: str = "psum",
                   bucket_bytes: int = 1 << 25):
    """Reduce a tree of rank-stacked gradients ``[n, *shape]`` across the
    ranks: every row becomes the sum.  ``psum`` is the plain sum; other
    names run the user schedules of ``schedules`` on per-dtype buckets
    (each in its leaves' own dtype)."""
    leaves, unflatten = tree_flatten(grads)
    if algorithm == "psum":
        return unflatten([g.sum(0, keepdim=True).expand_as(g).clone()
                          for g in leaves])
    fn = S.ALGORITHMS[algorithm]
    n = leaves[0].shape[0]
    red = [None] * len(leaves)
    for bucket in _buckets(leaves, bucket_bytes,
                           lambda g: g[0].numel() * g.element_size()):
        flat = fn(torch.cat([leaves[i].reshape(n, -1) for i in bucket], -1))
        off = 0
        for i in bucket:
            size = leaves[i][0].numel()
            red[i] = flat[:, off:off + size].reshape(leaves[i].shape)
            off += size
    return unflatten(red)


def microbatched_grad_fn(loss_fn: Callable, num_microbatches: int,
                         ranks: int | None = None,
                         algorithm: str = "psum",
                         bucket_bytes: int = 1 << 25):
    """``grad_fn(params, batch) -> (loss, grads)``: splits the batch into
    microbatches and accumulates f32 gradients of ``loss_fn(params, mb)
    -> (loss, aux)``, then averages.  With ``ranks`` the batch's leading
    dim is first split over that many ranks, each rank's gradients are
    stacked ``[n, *shape]`` and reduced with ``allreduce_tree`` (every
    row the sum), and the loss is the ranks' mean."""
    from repro_torch.models.layers import tree_from_leaves, tree_leaves

    def local(params, batch):
        paths, leaves = zip(*tree_leaves(params))

        def split(x):
            B = x.shape[0]
            assert B % num_microbatches == 0, (B, num_microbatches)
            return x.reshape((num_microbatches, B // num_microbatches)
                             + tuple(x.shape[1:]))

        mbs = {k: split(v) for k, v in batch.items()}
        loss, acc = 0.0, None
        for i in range(num_microbatches):
            with torch.enable_grad():
                ps = [p.detach().requires_grad_(True) for p in leaves]
                lv, _ = loss_fn(tree_from_leaves(zip(paths, ps)),
                                {k: v[i] for k, v in mbs.items()})
                g = torch.autograd.grad(lv, ps)
            loss = loss + lv.detach()
            acc = [x.float() for x in g] if acc is None else \
                [a + x.float() for a, x in zip(acc, g)]
        inv = 1.0 / num_microbatches
        return loss * inv, tree_from_leaves(
            zip(paths, [a * inv for a in acc]))

    def grad_fn(params, batch):
        if ranks is None:
            return local(params, batch)
        per = {k: v.reshape((ranks, v.shape[0] // ranks) + tuple(v.shape[1:]))
               for k, v in batch.items()}
        outs = [local(params, {k: v[r] for k, v in per.items()})
                for r in range(ranks)]
        stacked = {}
        for path, _ in tree_leaves(outs[0][1]):
            node = [o[1] for o in outs]
            for k in path:
                node = [t[k] for t in node]
            stacked[path] = torch.stack(node)
        grads = allreduce_tree(tree_from_leaves(stacked.items()), algorithm,
                               bucket_bytes)
        loss = torch.stack([o[0] for o in outs]).mean()
        return loss, grads

    return grad_fn


# ---------------------------------------------------------------------------
# Engine-driven bucketed gradient reduction (paper §4.7 at the host level)
# ---------------------------------------------------------------------------

def _flatten_bucket(leaves, n: int):
    """Stacked per-rank leaves [n, *shape] -> one [n, bucket] payload;
    ``RankShards`` leaves -> each rank's [1, bucket] on its device."""
    return local(lambda *gs: torch.cat([g.reshape(g.shape[0], -1)
                                        for g in gs], dim=-1), *leaves)


def _unflatten_bucket(flat, shapes: tuple, scale: float, n: int):
    """Reduced [n, bucket] payload (every row the cross-rank sum) back
    into reduced leaves [*shape] (row 0, multiplied by ``scale``); a
    ``RankShards`` payload into ``RankShards`` leaves, each rank's own
    row on its device."""
    if isinstance(flat, RankShards):
        per_rank = [_unflatten_bucket(t, shapes, scale, 1)
                    for t in flat.shards]
        return [RankShards(parts) for parts in zip(*per_rank)]
    del n
    out, off = [], 0
    for shape in shapes:
        size = 1
        for s in shape:
            size *= s
        leaf = flat[0, off:off + size].reshape(shape)
        out.append(leaf * scale if scale != 1.0 else leaf)
        off += size
    return out


class TreeReduction:
    """Handle for an in-flight engine-driven gradient reduction: one
    nonblocking collective request per bucket plus the reassembly plan.
    ``issue_s`` is the host time its issue took."""

    def __init__(self, reducer: "EngineGradReducer", requests, buckets,
                 shapes, dtypes, unflatten, num_leaves: int,
                 issue_s: float = 0.0):
        self.reducer = reducer
        self.requests = requests
        self._buckets = buckets
        self._shapes = shapes
        self._dtypes = dtypes
        self._unflatten = unflatten
        self._num_leaves = num_leaves
        self.issue_s = issue_s

    @property
    def is_complete(self) -> bool:
        return all(r.is_complete for r in self.requests)

    def wait(self, timeout: float | None = None):
        """Drive the engine until every bucket reduced; returns the
        reduced gradient tree (one copy of each leaf, on the stream that
        was current at issue; a ``RankShards`` of each rank's copy in the
        per-device form).  ``timeout`` is one overall deadline."""
        deadline = None if timeout is None else time.monotonic() + timeout
        for req in self.requests:
            remaining = None if deadline is None else \
                max(0.0, deadline - time.monotonic())
            req.wait(timeout=remaining)
        n = self.reducer.axis_size
        scale = (1.0 / n) if self.reducer.mean else 1.0
        red = [None] * self._num_leaves
        for req, bucket in zip(self.requests, self._buckets):
            shapes = tuple(self._shapes[i] for i in bucket)
            leaves = _unflatten_bucket(req.value(), shapes, scale, n)
            for i, leaf in zip(bucket, leaves):
                red[i] = local(lambda t, dt=self._dtypes[i]: t.to(dt), leaf)
        return self._unflatten(red)


class EngineGradReducer:
    """DDP-style bucketed gradient allreduce driven by the progress
    engine.

    Input gradients are rank-stacked trees — each leaf ``[axis_size,
    *shape]``, rank i's local gradient in row i — or, on a mesh with a
    device per rank, trees of ``RankShards`` leaves (rank i's ``[1,
    *shape]`` on its device; each rank flattens its own buckets there).
    ``iallreduce_tree``
    flattens the leaves into ~``bucket_bytes`` (per rank) buckets and
    starts one chunk-pipelined persistent allreduce per bucket, so the
    reductions progress on the collective stream while the caller keeps
    computing.  ``mean=True`` multiplies by 1/axis_size on reassembly.

    Buckets reduce through **persistent schedules**: the first step
    builds one ``PersistentCollective`` per (bucket ordinal, shape,
    dtype) and every later step re-``start``s it (MPI
    ``Allreduce_init``/``Start`` across the step loop), reusing its
    carries.  ``round_batch`` (None = auto from the bucket size) fuses
    consecutive rounds per dispatch."""

    def __init__(self, mesh, axis: str, *, engine=None, collectives=None,
                 algorithm: str = "ring", chunks: int = 4,
                 bucket_bytes: int = 1 << 25, mean: bool = True,
                 executor=None, round_batch: int | None = None,
                 epoch=None, spec=None):
        from repro_torch.collectives import nonblocking as NB
        if spec is not None:
            algorithm = spec.algorithm
            chunks = spec.chunks
            round_batch = spec.round_batch
        self.mesh = mesh
        self.axis = axis
        self.axis_size = dict(mesh.shape)[axis]
        self._algorithm_pref = algorithm
        self.algorithm = S.resolve_algorithm(algorithm, self.axis_size)
        self.chunks = chunks
        self.bucket_bytes = bucket_bytes
        self.mean = mean
        self.round_batch = round_batch
        self.epoch = epoch
        self.remeshes = 0
        self._own_coll = collectives is None
        self.coll = collectives if collectives is not None else \
            NB.UserCollectives(engine, executor=executor, name="gradreduce",
                               epoch=epoch)
        # (bucket ordinal, payload shape, dtype) -> PersistentCollective:
        # two same-shaped buckets in one step need two handles
        self._persistent: dict = {}

    def _handle(self, ordinal: int, flat):
        key = (ordinal, tuple(flat.shape), flat.dtype)
        handle = self._persistent.get(key)
        if handle is None:
            # warmup=False: the first start makes the carries
            handle = self.coll.allreduce_init(
                flat, self.mesh, self.axis, algorithm=self.algorithm,
                chunks=self.chunks, round_batch=self.round_batch,
                warmup=False, epoch=self.epoch)
            self._persistent[key] = handle
        return handle

    @property
    def dispatches_per_step(self) -> int:
        """Dispatch units a step's reduction costs (every bucket's
        chunks × rounds after fusion)."""
        return sum(h.dispatches_per_start for h in self._persistent.values())

    def remesh(self, mesh, axis: str | None = None) -> "EngineGradReducer":
        """Adopt the survivors' mesh (a mesh of fewer ranks, or of fewer
        devices in the per-device form): the old handles close (the
        payload's leading dim changes) and fresh ones build on the next
        ``iallreduce_tree``."""
        for handle in self._persistent.values():
            handle.close()
        self._persistent.clear()
        self.mesh = mesh
        if axis is not None:
            self.axis = axis
        self.axis_size = dict(mesh.shape)[self.axis]
        self.algorithm = S.resolve_algorithm(self._algorithm_pref,
                                             self.axis_size)
        self.remeshes += 1
        return self

    def iallreduce_tree(self, stacked_grads) -> TreeReduction:
        """Issue the bucketed reduction; returns at once."""
        t0 = time.perf_counter()
        leaves, unflatten = tree_flatten(stacked_grads)
        n = self.axis_size
        shapes = [tuple(g.shape[1:]) for g in leaves]
        dtypes = [g.dtype for g in leaves]
        buckets = _buckets(leaves, self.bucket_bytes,
                           lambda g: (g.numel() // max(1, g.shape[0]))
                           * g.element_size())
        requests = []
        for bi, bucket in enumerate(buckets):
            flat = _flatten_bucket([leaves[i] for i in bucket], n)
            handle = self._handle(bi, flat)
            if handle.active is not None and not handle.active.is_complete:
                # overlapping tree reductions: a one-shot issue rather
                # than a second start of an active handle
                requests.append(self.coll.iallreduce(
                    flat, self.mesh, self.axis, algorithm=self.algorithm,
                    chunks=self.chunks, round_batch=self.round_batch))
            else:
                requests.append(handle.start(flat))
        return TreeReduction(self, requests, buckets, shapes, dtypes,
                             unflatten, len(leaves),
                             time.perf_counter() - t0)

    def allreduce_tree(self, stacked_grads, timeout: float | None = None):
        """Blocking convenience: issue + engine-driven wait."""
        return self.iallreduce_tree(stacked_grads).wait(timeout=timeout)

    def close(self) -> None:
        for handle in self._persistent.values():
            handle.close()
        self._persistent.clear()
        if self._own_coll:
            self.coll.close()


# ---------------------------------------------------------------------------
# ZeRO-style FSDP on persistent reduce-scatter / all-gather handles
# ---------------------------------------------------------------------------

class FsdpLayout:
    """Flat-bucket layout for ZeRO-style parameter sharding.

    Computed once from a parameter-tree template: leaves (in
    ``tree_flatten`` order) are grouped into per-dtype buckets
    (:func:`bucket_tree` — one concatenated payload per bucket, never
    mixing dtypes), each bucket's flat width padded up to a multiple of
    the data-axis size ``n`` so rank ``r`` owns the contiguous block
    ``r`` of the flat bucket — exactly the block placement the ring and
    halving/doubling reduce-scatter schedules (and the plain sum over
    the rank dim) produce."""

    def __init__(self, params, n: int, bucket_bytes: int = 1 << 25):
        leaves, self._unflatten = tree_flatten(params)
        self.n = n
        self.shapes = [tuple(leaf.shape) for leaf in leaves]
        self.dtypes = [leaf.dtype for leaf in leaves]
        self.sizes = [int(leaf.numel()) for leaf in leaves]
        self.buckets = bucket_tree(params, bucket_bytes)
        self.widths = []                 # padded flat width, multiple of n
        self.totals = []                 # unpadded flat width
        for bucket in self.buckets:
            total = sum(self.sizes[i] for i in bucket)
            self.totals.append(total)
            self.widths.append(-(-total // n) * n)

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    def bucket_dtype(self, b: int):
        return self.dtypes[self.buckets[b][0]]

    def flatten_bucket(self, leaves, b: int) -> torch.Tensor:
        """Full (unstacked) leaves -> the padded flat bucket ``[W]``."""
        idx = self.buckets[b]
        dt = self.bucket_dtype(b)
        parts = [leaves[i].reshape(-1).to(dt) for i in idx]
        pad = self.widths[b] - self.totals[b]
        if pad:
            parts.append(parts[0].new_zeros((pad,)))
        return torch.cat(parts)

    def unflatten(self, flats):
        """Flat buckets ``[W]`` (one per bucket) -> the parameter tree; the
        leaves are views of the flats."""
        out = [None] * len(self.shapes)
        for b, flat in enumerate(flats):
            off = 0
            for i in self.buckets[b]:
                out[i] = flat[off:off + self.sizes[i]].view(self.shapes[i])
                off += self.sizes[i]
        return self._unflatten(out)

    def shard_params(self, params, mesh=None, axis: str = "data"):
        """Full params -> list of ``[n, W/n]`` shard stacks (row ``r`` is
        rank ``r``'s block — ZeRO-3 resident state), on ``mesh``'s device
        (default: the leaves' own).  On a mesh with a device per rank, one
        ``RankShards`` per bucket instead: data rank ``r``'s block ``[1,
        W/n]`` on its device (glued, the stack); where the mesh has other
        axes (a model axis) every rank of data rank ``r`` holds a copy of
        its block, as JAX places ``NamedSharding(mesh, P(axis))``: the
        shards are copies in ``launch.mesh.axis_order``, the first copy on
        ``axis``'s leaders.  ``axis`` names the data axis, whose size must
        be the layout's ``n``."""
        from repro_torch.launch.mesh import axis_order
        if mesh is not None and dict(mesh.shape)[axis] != self.n:
            raise ValueError(f"mesh axis {axis!r} has "
                             f"{dict(mesh.shape)[axis]} ranks, the layout "
                             f"{self.n}")
        leaves, _ = tree_flatten(params)
        out = []
        for b in range(self.num_buckets):
            flat = self.flatten_bucket(leaves, b).reshape(
                self.n, self.widths[b] // self.n)
            if mesh is not None and mesh.per_device:
                flat = RankShards.from_stacked(
                    flat, devices=axis_order(mesh, axis),
                    copies=mesh.size // self.n)
            elif mesh is not None:
                flat = flat.to(mesh.device)
            out.append(flat)
        return out

    def unshard_params(self, shards, device=None):
        """Shard stacks ``[n, W/n]``, or ``RankShards`` of the blocks (of
        copies, the first copy's) -> the full parameter tree (views of the
        stacks; the blocks glued on ``device``, default rank 0's — for
        checkpointing, eval and re-sharding; the training path gathers
        through the engine instead)."""
        return self.unflatten([
            (s.to_stacked(device if device is not None else s.devices[0])
             if isinstance(s, RankShards) else s).reshape(-1)
            for s in shards])


def _first_copy(x):
    """A ``RankShards`` of copies of blocks as its first copy (the data
    axis's leaders); anything else as it is."""
    if isinstance(x, RankShards) and x.copies > 1:
        return RankShards(x.blocks)
    return x


class FsdpReduction:
    """In-flight bucketed gradient reduce-scatter: one nonblocking
    collective request per flat bucket; ``wait`` returns the reduced
    shard stacks ``[n, W/n]`` (row ``r`` = rank ``r``'s grad-sum block,
    unscaled — the optimizer applies the 1/n data-parallel mean)."""

    def __init__(self, requests):
        self.requests = requests

    @property
    def is_complete(self) -> bool:
        return all(r.is_complete for r in self.requests)

    def wait(self, timeout: float | None = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        for req in self.requests:
            remaining = None if deadline is None else \
                max(0.0, deadline - time.monotonic())
            out.append(req.wait(timeout=remaining))
        return out


class FsdpGather:
    """In-flight chained parameter prefetch (the §4.6 continuation
    pattern): one persistent all-gather start per flat bucket, each
    start *chained* as a continuation instead of issued eagerly.

    Two chain shapes:

    * ``after=None`` — bucket ``i+1``'s start is attached to bucket
      ``i``'s completion: a self-propagating prefetch train that
      progresses on the collective stream while the caller computes.
    * ``after=[req, ...]`` (one request-like per bucket, e.g.
      ``FsdpReducer.future``s over the optimizer's updated shards) —
      bucket ``i``'s start fires when its *compute future* completes
      (a CUDA event recorded after the optimizer on the compute stream),
      so the gather for the next step begins the moment its shards are
      written, behind whatever the card still runs.

    ``blocked_s`` / ``window_s`` give the prefetch-overlap accounting:
    the fraction of the gather window the caller did *not* spend blocked
    in ``wait`` is communication hidden behind compute."""

    def __init__(self, reducer: "FsdpReducer", shards, after=None):
        if after is not None and len(after) != len(shards):
            raise ValueError(
                f"after must carry one request per bucket: "
                f"{len(after)} != {len(shards)}")
        self.reducer = reducer
        self._shards = shards
        self._after = after
        self._reqs: list = [None] * len(shards)
        self._exc: BaseException | None = None
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._t_done: float | None = None
        self.blocked_s = 0.0
        if not shards:
            self._t_done = self._t0
        elif after is None:
            self._start(0)
        else:
            q = reducer.coll.queue
            for i, fut in enumerate(after):
                q.attach(fut, functools.partial(self._on_upstream, i),
                         on_error=functools.partial(self._on_failed, i))

    # -- chain links (run inline on whichever thread progresses) ----------
    def _start(self, i: int) -> None:
        try:
            req = self.reducer._start_gather(i, self._shards[i])
        except BaseException as exc:  # noqa: BLE001 - surfaced by wait()
            with self._lock:
                self._exc = exc
            return
        with self._lock:
            self._reqs[i] = req
        if self._after is None and i + 1 < len(self._shards):
            self.reducer.coll.queue.attach(
                req, lambda _req: self._start(i + 1),
                on_error=functools.partial(self._on_failed, i))

    def _on_upstream(self, i: int, _req) -> None:
        self._start(i)

    def _on_failed(self, i: int, req) -> None:
        with self._lock:
            if self._exc is None:
                self._exc = req.exception or RuntimeError(
                    f"fsdp gather {i} failed")

    # -- waiting -----------------------------------------------------------
    def _drive_until(self, cond, deadline) -> None:
        from repro_torch.core.continuations import DEFERRED
        coll = self.reducer.coll
        eng, s, q = coll.engine, coll.stream, coll.queue
        while not cond():
            ex = eng.executor
            owned = ex is not None and ex.running and ex.owns(s)
            made = 0 if owned else eng.progress(s)
            if q.policy == DEFERRED:
                made += q.drain()
            if cond():
                return
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("fsdp gather wait timed out")
            if not made:
                time.sleep(20e-6)

    def wait(self, timeout: float | None = None):
        """Drive the engine until every bucket gathered; returns the
        gathered flat buckets ``[n, W]`` (every row a full copy).  Time
        spent blocked here is accumulated into ``blocked_s``."""
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        for i in range(len(self._shards)):
            t = time.monotonic()
            self._drive_until(
                lambda: self._reqs[i] is not None or self._exc is not None,
                deadline)
            with self._lock:
                req, exc = self._reqs[i], self._exc
            if req is None:
                raise exc
            remaining = None if deadline is None else \
                max(0.0, deadline - time.monotonic())
            out.append(req.wait(timeout=remaining))
            self.blocked_s += time.monotonic() - t
        if self._t_done is None:
            self._t_done = time.monotonic()
            self.reducer._note_gather(self)
        return out

    @property
    def window_s(self) -> float:
        end = self._t_done if self._t_done is not None else time.monotonic()
        return max(end - self._t0, 1e-9)

    @property
    def overlap_fraction(self) -> float:
        """Fraction of the gather window hidden behind caller compute."""
        return max(0.0, min(1.0, 1.0 - self.blocked_s / self.window_s))


class FsdpReducer:
    """ZeRO-style FSDP communication on the progress engine.

    Where :class:`EngineGradReducer` allreduces full gradients (every
    rank ends with every element), this reducer keeps optimizer state
    and parameters *sharded* over the data axis and moves half the wire
    bytes per step:

    * ``ireduce_scatter(flat_grads)`` — per-bucket stacked gradients
      ``[n, W]`` through persistent ``reduce_scatter_init`` handles; the
      reduced block lands on its owning rank as ``[n, W/n]``.
    * ``igather(shards, after=...)`` — persistent ``allgather_init``
      starts for the next step's full params, chained as continuations
      off compute futures (:class:`FsdpGather`), so gather rounds
      progress on the collective stream while the card still runs the
      optimizer.

    Handles are cached per (op, bucket ordinal, payload shape, dtype) —
    the MPI ``*_init``/``Start`` persistent pattern — and register under
    the membership ``epoch`` like every other persistent collective, so
    a membership change fails in-flight FSDP starts exactly once and
    ``remesh`` rebuilds on the survivors.  Works on any mesh whose
    ``axis`` names the data dimension; other mesh axes (``model``)
    replicate, so the payloads carry one row per data rank.  On a mesh
    with a device per rank every payload is a ``RankShards`` (rank r's
    row on its device) and ``future`` records an event on each card; a
    model axis there holds copies of the data ranks' blocks, and the
    reducer runs over the data axis's leaders alone (``mesh`` is
    ``launch.mesh.axis_column``'s): ``igather`` and ``future`` take the
    shards' first copy, the leaders' blocks."""

    def __init__(self, mesh, axis: str = "data", *, engine=None,
                 collectives=None, spec=None, algorithm: str = "ring",
                 chunks: int = 4, bucket_bytes: int = 1 << 25,
                 executor=None, round_batch: int | None = None,
                 epoch=None):
        from repro_torch.collectives import nonblocking as NB
        from repro_torch.launch.mesh import axis_column
        if spec is None:
            spec = NB.CollectiveSpec(backend="user", algorithm=algorithm,
                                     chunks=chunks, round_batch=round_batch)
        self.mesh = axis_column(mesh, axis)
        self.axis = axis
        self.axis_size = dict(mesh.shape)[axis]
        self._spec_pref = spec
        self.spec = spec.resolve(self.axis_size)
        self.bucket_bytes = bucket_bytes
        self.epoch = epoch
        self.remeshes = 0
        self._own_coll = collectives is None
        self.coll = collectives if collectives is not None else \
            NB.UserCollectives(engine, executor=executor, name="fsdp",
                               epoch=epoch)
        self._persistent: dict = {}
        debug.track_handle(self, "FsdpReducer")
        # prefetch-overlap accounting (totals across completed gathers)
        self.gathers = 0
        self.gather_blocked_s = 0.0
        self.gather_window_s = 0.0

    # -- persistent handles ------------------------------------------------
    def _handle(self, kind: str, ordinal: int, like):
        key = (kind, ordinal, tuple(like.shape), like.dtype)
        handle = self._persistent.get(key)
        if handle is None:
            init = self.coll.reduce_scatter_init if kind == "rs" \
                else self.coll.allgather_init
            handle = init(like, self.mesh, self.axis, spec=self.spec,
                          warmup=False, epoch=self.epoch)
            self._persistent[key] = handle
        return handle

    def _start_gather(self, ordinal: int, shard):
        handle = self._handle("ag", ordinal, shard)
        if handle.active is not None and not handle.active.is_complete:
            return self.coll.iallgather(shard, self.mesh, self.axis,
                                        spec=self.spec)
        return handle.start(shard)

    def _note_gather(self, gather: FsdpGather) -> None:
        self.gathers += 1
        self.gather_blocked_s += gather.blocked_s
        self.gather_window_s += gather.window_s

    @property
    def prefetch_overlap(self) -> float:
        """Aggregate overlap fraction across all completed gathers."""
        if self.gather_window_s <= 0.0:
            return 0.0
        return max(0.0, min(1.0, 1.0 - self.gather_blocked_s
                            / self.gather_window_s))

    @property
    def dispatches_per_step(self) -> int:
        """Dispatch units a step's reduce-scatters and gathers cost (every
        bucket's chunks × rounds after fusion)."""
        return sum(h.dispatches_per_start for h in self._persistent.values())

    # -- the two FSDP collectives -----------------------------------------
    def ireduce_scatter(self, flat_grads) -> FsdpReduction:
        """Issue one persistent reduce-scatter per flat grad bucket
        ``[n, W]``; returns immediately."""
        # close() clears the handle cache but nothing else marks the
        # reducer unusable — the debug tracker refuses a closed reducer
        debug.handle_check_open(self, "ireduce_scatter", kind="FsdpReducer")
        requests = []
        for bi, g in enumerate(flat_grads):
            handle = self._handle("rs", bi, g)
            if handle.active is not None and not handle.active.is_complete:
                requests.append(self.coll.ireduce_scatter(
                    g, self.mesh, self.axis, spec=self.spec))
            else:
                requests.append(handle.start(g))
        return FsdpReduction(requests)

    def igather(self, shards, after=None) -> FsdpGather:
        """Chained param prefetch over the shard stacks ``[n, W/n]``;
        see :class:`FsdpGather` for the two chain shapes."""
        debug.handle_check_open(self, "igather", kind="FsdpReducer")
        return FsdpGather(self, [_first_copy(s) for s in shards],
                          after=after)

    def future(self, tensors):
        """A compute future on the reducer's own collective stream: a CUDA
        event recorded now on the current (compute) stream, polled by the
        engine — the right upstream for ``igather``'s ``after=`` chain,
        since waiting the gather progresses exactly this stream."""
        from repro_torch.core.futures import torch_future
        return torch_future(self.coll.engine, _first_copy(tensors),
                            self.coll.stream)

    def gather(self, shards, timeout: float | None = None):
        """Blocking convenience: chained issue + engine-driven wait."""
        return self.igather(shards).wait(timeout=timeout)

    # -- lifecycle ---------------------------------------------------------
    def remesh(self, mesh, axis: str | None = None) -> "FsdpReducer":
        """Adopt the survivors' mesh: close the stale handles (payload
        shapes carry the old axis size), re-resolve the spec for the new
        axis size, and let fresh handles build lazily.  The *caller*
        re-shards params/optimizer state for the new axis size (shard
        widths change) — ``FsdpLayout`` + ``shard_params`` on the
        unsharded tree."""
        debug.handle_event(self, "rebuild", kind="FsdpReducer",
                           complete_probe=lambda: True)
        from repro_torch.launch.mesh import axis_column
        for handle in self._persistent.values():
            handle.close()
        self._persistent.clear()
        if axis is not None:
            self.axis = axis
        self.mesh = axis_column(mesh, self.axis)
        self.axis_size = dict(mesh.shape)[self.axis]
        self.spec = self._spec_pref.resolve(self.axis_size)
        self.remeshes += 1
        return self

    def close(self) -> None:
        debug.handle_event(self, "close", kind="FsdpReducer")
        for handle in self._persistent.values():
            handle.close()
        self._persistent.clear()
        if self._own_coll:
            self.coll.close()


# ---------------------------------------------------------------------------
# Collective matmul (all-gather / reduce-scatter fused into the GEMM loop)
# ---------------------------------------------------------------------------

def collective_matmul_ag(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``y = all_gather(x) @ w`` without materializing the gather, on
    rank-stacked operands: x ``[n, m, K]`` (rank r's rows), w ``[n, K,
    n_local]`` (rank r's columns) -> ``[n, n*m, n_local]``.  Each of the
    n steps multiplies the resident chunk while the ring ships the next."""
    n, m = x.shape[0], x.shape[1]
    if n == 1:
        return x @ w
    out = x.new_zeros((n, n, m, w.shape[-1]))
    table = S.rank_offsets(n, x.device)
    cur = x
    for step in range(n):
        part = cur @ w                          # compute the resident chunk
        pos = table[-step % n]
        idx = pos.view(n, 1, 1, 1).expand(n, 1, m, w.shape[-1])
        out.scatter_(1, idx, part.unsqueeze(1))
        if step != n - 1:
            cur = S.ring_shift(cur, 1)          # ship the next chunk
    return out.reshape(n, n * m, w.shape[-1])


def collective_matmul_rs(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``reduce_scatter(x @ w)`` over rows with the contraction sharded,
    rank-stacked: x ``[n, M, k_local]``, w ``[n, k_local, N]`` -> ``[n,
    M/n, N]`` (rank r keeps rows r·M/n:(r+1)·M/n fully reduced)."""
    n = x.shape[0]
    if n == 1:
        return x @ w
    partial_y = x @ w                           # [n, M, N] partial sums
    assert partial_y.shape[1] % n == 0
    red = S.ring_reduce_scatter(partial_y.movedim(1, -1))   # [n, N, M/n]
    return red.movedim(-1, 1)


def ag_matmul_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``all_gather(x, tiled) @ w`` on rank-stacked operands."""
    n = x.shape[0]
    gathered = x.reshape(1, n * x.shape[1], x.shape[2])
    return gathered @ w
