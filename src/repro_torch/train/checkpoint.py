"""Asynchronous checkpointing driven by the progress engine (the port of
the JAX package's ``train/checkpoint.py``, with the same on-disk layout).

A checkpoint save is the paper's Figure 1(c) multi-wait-block task:
(1) device→host copy (wait on the card), (2) serialize+write (wait on
storage I/O), (3) fsync+atomic-commit rename.  Every stage advances from
the engine's poll loop while training computes.

A ``RankShards`` leaf says which it is (``RankShards.replica``).  A
replica (the per-device data-parallel state, a step counter) is saved
from rank 0, as the JAX package saves a replicated array once, and
restored as a copy on each rank's device.  Blocks (FSDP's ZeRO shards,
rank ``r``'s ``[1, W/n]`` on its device) are saved glued in rank order,
the rank-stacked tensor's file byte for byte, and restored as rank ``r``'s
block on its device; copies of blocks (pipeline stages' parameters on a
(data x stage) mesh) are saved as one copy's blocks, and restored into
every copy.  Blocks split on another dim (``RankShards.dim``: the MoE
block's F-slices on a model axis) are glued along it, each block copied
to the host on its own card's stream and the gluing done in stage 2, so
the file is the unsliced tensor's and restores into the slices.

Stage 1 differs from the JAX package, where arrays are immutable: the
port's optimizer updates the parameters and moments in place on the same
CUDA stream.  So ``save_async`` itself enqueues every device→host copy
(into pinned host buffers, ``non_blocking=True``) on the current stream
and records a CUDA event after them: any update enqueued later on that
stream runs after the copies, and stage 2 starts once ``event.query()``
says they are done.  CPU tensors are cloned inside ``save_async``.

Layout (the JAX package's): ``step_N.tmp/`` holds one ``.npy`` per leaf,
named by the ``/``-joined path of dict keys (``.field`` for a named
tuple's field, the index for a list) with ``/`` replaced by ``__``, and a
``manifest.json`` {"step", "leaves": {path: file}}; every file is fsynced
before the directory is renamed to ``step_N/``, so a crash mid-save never
corrupts the latest checkpoint, and ``latest_step`` only ever sees
committed directories.  bf16 leaves are written as f32 (numpy has no
bf16; the widening is exact) and cast back by ``restore``.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.collectives.rank_shards import RankShards
from repro_torch.core.engine import DONE, NOPROGRESS, ProgressEngine, Stream
from repro_torch.core.futures import cuda_devices, io_pool, record_events
from repro_torch.core.request import Request


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _map_with_paths(fn: Callable[[str, Any], Any], tree, prefix=()):
    """``fn(path, leaf)`` over a tree of dicts, named tuples, lists and
    tuples, keeping its structure; paths as the JAX package names them."""
    if isinstance(tree, dict):
        return {k: _map_with_paths(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*[_map_with_paths(fn, getattr(tree, f),
                                            prefix + ("." + f,))
                            for f in tree._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_paths(fn, v, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(prefix), tree)


def _flat_with_paths(tree) -> list[tuple[str, Any]]:
    out: list[tuple[str, Any]] = []
    _map_with_paths(lambda name, leaf: out.append((name, leaf)), tree)
    return out


def _saved_parts(leaf) -> list:
    """The tensors a leaf's file is made of: rank 0's shard of a replica,
    every shard of blocks (glued in rank order; one copy's of copies),
    else the leaf."""
    if not isinstance(leaf, RankShards):
        return [leaf]
    return [leaf.shards[0]] if leaf.replica else list(leaf.blocks)


class _Glued:
    """Host copies of blocks to glue along ``dim`` once they landed."""

    def __init__(self, parts: list, dim: int):
        self.parts = parts
        self.dim = dim


def _to_host(leaf):
    """Stage 1 for one leaf: a host copy that later in-place updates of
    ``leaf`` cannot reach (an enqueued, not yet finished, copy for CUDA;
    each block's on its own card's stream)."""
    if isinstance(leaf, RankShards) and leaf.dim:
        return _Glued([_to_host(b) for b in leaf.blocks], leaf.dim)
    parts = _saved_parts(leaf)
    if not isinstance(parts[0], torch.Tensor):
        return np.array(parts[0])
    parts = [t.detach() for t in parts]
    if len(parts) > 1 and parts[0].dim() == 0:
        raise ValueError("RankShards of 0-d shards are not blocks of a "
                         "stacked tensor: mark a per-rank scalar as a "
                         "replica")
    if not any(t.is_cuda for t in parts):
        return parts[0].clone() if len(parts) == 1 else torch.cat(parts)
    shape = parts[0].shape if len(parts) == 1 else \
        (sum(t.shape[0] for t in parts),) + tuple(parts[0].shape[1:])
    buf = torch.empty(shape, dtype=parts[0].dtype, pin_memory=True)
    flat, off = buf.view(-1), 0
    for t in parts:
        flat[off:off + t.numel()].copy_(t.reshape(-1), non_blocking=True)
        off += t.numel()
    return buf


def _to_numpy(host) -> np.ndarray:
    if isinstance(host, _Glued):
        return np.concatenate([_to_numpy(h) for h in host.parts],
                              axis=host.dim)
    if isinstance(host, np.ndarray):
        return host
    if host.dtype == torch.bfloat16:
        host = host.float()
    return host.numpy()


class AsyncCheckpointer:
    """Engine-driven async checkpoint save/restore."""

    def __init__(self, directory: str, engine: ProgressEngine,
                 stream: Optional[Stream] = None, keep: int = 3):
        self.dir = directory
        self.engine = engine
        self.stream = stream
        self.keep = keep
        self.last_save_s: float | None = None   # save_async -> commit
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def save_async(self, step: int, tree: Any) -> Request:
        """Returns a Request completing at atomic commit."""
        t0 = time.perf_counter()
        req = Request(tag=f"ckpt-{step}")
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        # stage 1 launch: device→host copies enqueued NOW, before any
        # later in-place update on this stream
        flat = _flat_with_paths(tree)
        with torch.no_grad():
            leaves = [(name, _to_host(leaf)) for name, leaf in flat]
        # one event per card the copies were enqueued on
        events = record_events(cuda_devices(
            [_saved_parts(leaf) for _, leaf in flat]))
        state = {"phase": "d2h", "fut": None}

        def write():
            os.makedirs(tmp, exist_ok=True)
            manifest = {}
            for name, host in leaves:
                fname = name.replace("/", "__") + ".npy"
                with open(os.path.join(tmp, fname), "wb") as f:
                    np.save(f, _to_numpy(host))
                    f.flush()
                    os.fsync(f.fileno())
                manifest[name] = fname
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump({"step": step, "leaves": manifest}, f)
                f.flush()
                os.fsync(f.fileno())

        def poll(thing) -> str:
            if state["phase"] == "d2h":
                if all(e.query() for e in events):
                    state["fut"] = io_pool().submit(write)
                    state["phase"] = "write"
                return NOPROGRESS
            if state["fut"].done():
                exc = state["fut"].exception()
                if exc is not None:
                    req.fail(exc)
                    return DONE
                # stage 3: atomic commit
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._gc()
                self.last_save_s = time.perf_counter() - t0
                req.complete(step)
                return DONE
            return NOPROGRESS

        self.engine.async_start(poll, None, self.stream)
        return req

    def save_blocking(self, step: int, tree: Any) -> int:
        req = self.save_async(step, tree)
        return self.engine.wait(req, self.stream, timeout=600)

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp") \
                    and os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
        return max(steps) if steps else None

    def restore(self, step: int, like: Any, device=None) -> Any:
        """The tree saved at ``step``, shaped and typed like ``like``, on
        ``device`` (default: each leaf of ``like``'s own device; a
        ``RankShards`` replica of ``like`` gets a copy on each of its
        shards' devices, ``RankShards`` blocks each rank's rows on its
        device)."""
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)["leaves"]

        def load(name, leaf_like):
            arr = np.load(os.path.join(path, manifest[name]))
            t = torch.from_numpy(arr)
            if isinstance(leaf_like, RankShards):
                if not leaf_like.replica:
                    return RankShards.from_stacked(
                        t.to(leaf_like.dtype), devices=leaf_like.devices,
                        copies=leaf_like.copies, dim=leaf_like.dim)
                return RankShards((t.to(device=d, dtype=leaf_like.dtype,
                                        copy=True)
                                   for d in leaf_like.devices), replica=True)
            dev = device if device is not None else leaf_like.device
            return t.to(device=dev, dtype=leaf_like.dtype)

        return _map_with_paths(load, like)

    def _gc(self):
        all_steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.dir)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in all_steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)
