"""Bridging PyTorch's asynchronous CUDA work + host I/O into the progress engine.

The card is the "NIC" here: a kernel launch returns as soon as it is
queued on the current CUDA stream, and a ``torch.cuda.Event`` recorded
after it is the completion-queue entry; ``Event.query()`` is the poll.
``torch_future`` turns dispatched device work into a ``Request``;
``io_future`` wraps a thread-pool task (storage/network I/O) — both are
then progressed by the ONE collated engine rather than by per-subsystem
wait loops (the paper's interoperable-progress thesis).
"""
from __future__ import annotations

import concurrent.futures
import threading
from typing import Any, Callable, Optional

import torch

from repro_torch.core.engine import DONE, NOPROGRESS, ProgressEngine, Stream
from repro_torch.core.request import Request


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    shards = getattr(tree, "shards", None)    # a RankShards: one per rank
    if isinstance(shards, tuple):
        return list(shards)
    return [tree]


def cuda_devices(tensors) -> list:
    """The CUDA devices the tree's tensors live on, in order of first
    appearance."""
    seen: dict = {}
    for t in _leaves(tensors):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            seen.setdefault(t.device, None)
    return list(seen)


def record_events(devices) -> list:
    """One CUDA event recorded on each device's current stream."""
    events = []
    for d in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(d))
        events.append(ev)
    return events


def _host_ready(tensors) -> bool:
    """Leaves that are not tensors but answer ``is_ready()`` (a host
    stand-in for device work, as a JAX array answers it) must say so."""
    return all(t.is_ready() for t in _leaves(tensors)
               if not isinstance(t, torch.Tensor) and hasattr(t, "is_ready"))


def torch_future(engine: ProgressEngine, tensors: Any,
                 stream: Optional[Stream] = None,
                 on_complete: Callable[[Any], None] | None = None,
                 on_pending: Callable[[], None] | None = None) -> Request:
    """Request completing when the work queued so far on the current CUDA
    streams — the work that produces ``tensors`` — has finished.

    Call it right after dispatching that work: it records a
    ``torch.cuda.Event`` on the current stream of each device the tree's
    tensors live on (the shards of a ``RankShards`` each on its own) and
    polls every one with ``query()`` (never ``synchronize``), so the
    engine interleaves other subsystems while the cards run.  A tree
    holding no CUDA tensor is ready at the first poll, unless a leaf's
    ``is_ready()`` still says no.  The watched tensors ride along as the
    task's ``state``; ``on_pending``, if given, runs at each poll that
    finds the work still running.
    """
    req = Request(tag="torch")
    events = record_events(cuda_devices(tensors))

    def poll(thing) -> str:
        if all(e.query() for e in events) and _host_ready(tensors):
            if on_complete is not None:
                on_complete(tensors)
            req.complete(tensors)
            return DONE
        if on_pending is not None:
            on_pending()
        return NOPROGRESS

    engine.async_start(poll, tensors, stream)
    return req


# One small pool for genuinely-blocking host I/O (file writes, RPCs).
# The progress engine polls futures; the pool threads never touch the card.
_io_pool: concurrent.futures.ThreadPoolExecutor | None = None
_io_lock = threading.Lock()


def io_pool() -> concurrent.futures.ThreadPoolExecutor:
    global _io_pool
    if _io_pool is None:
        with _io_lock:
            if _io_pool is None:
                _io_pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=4, thread_name_prefix="repro-torch-io")
    return _io_pool


def io_future(engine: ProgressEngine, fn: Callable[[], Any],
              stream: Optional[Stream] = None,
              on_complete: Callable[[Any], None] | None = None) -> Request:
    """Run ``fn`` on the I/O pool; completion surfaces via the engine."""
    req = Request(tag="io")
    fut = io_pool().submit(fn)

    def poll(thing) -> str:
        if fut.done():
            try:
                value = fut.result()
            except BaseException as e:  # noqa: BLE001
                req.fail(e)
                return DONE
            if on_complete is not None:
                on_complete(value)
            req.complete(value)
            return DONE
        return NOPROGRESS

    engine.async_start(poll, None, stream)
    return req


def chain(engine: ProgressEngine, stages: list[Callable[[Any], Any]],
          stream: Optional[Stream] = None, initial: Any = None) -> Request:
    """Multi-wait-block task (paper Fig 1c / Fig 3c): each stage is
    launched when the previous completes, entirely inside poll_fn —
    the 'small block of code after each wait block' the paper identifies
    as the essence of progress (§2.4)."""
    req = Request(tag="chain")
    state = {"i": 0, "fut": None, "value": initial}

    def poll(thing) -> str:
        if state["fut"] is None:
            if state["i"] >= len(stages):
                req.complete(state["value"])
                return DONE
            stage = stages[state["i"]]
            state["fut"] = io_pool().submit(stage, state["value"])
            return NOPROGRESS
        if state["fut"].done():
            try:
                state["value"] = state["fut"].result()
            except BaseException as e:  # noqa: BLE001
                req.fail(e)
                return DONE
            state["fut"] = None
            state["i"] += 1
        return NOPROGRESS

    engine.async_start(poll, None, stream)
    return req
