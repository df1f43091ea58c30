"""Data pipeline with engine-driven prefetch (a copy of the JAX package's
``data/pipeline.py``; numpy only).

The pipeline is a *subsystem* of the progress engine (the paper's
"datatype engine" slot in Listing 1.1): a background fill task produces
batches into a bounded buffer; the trainer's ``next_batch`` never blocks
while the buffer is warm, and the buffer is refilled whenever *anyone*
drives progress — the data stall disappears into the compute phase.

The source here is a synthetic LM stream (seeded, reproducible, sharded
by host): the same arrays as the JAX package's ``SyntheticLM`` for the
same seed.  The prefetch machinery is source-agnostic.
"""
from __future__ import annotations

import collections
import threading
from typing import Iterator, Optional

import numpy as np

from repro_torch.core.engine import ProgressEngine, Stream
from repro_torch.core.futures import io_pool


class SyntheticLM:
    """Deterministic synthetic token stream (zipf-ish unigram mix with
    induced bigram structure so models actually have something to learn)."""

    def __init__(self, vocab_size: int, seq_len: int, batch_size: int,
                 seed: int = 0, shard: int = 0, num_shards: int = 1):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = batch_size
        self.rng = np.random.RandomState(seed * num_shards + shard + 1)
        # fixed random bigram table: next ~ 0.5 uniform + 0.5 f(prev)
        self._succ = self.rng.randint(0, vocab_size, size=(vocab_size,))

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.sample()

    def sample(self) -> dict:
        B, S, V = self.batch, self.seq + 1, self.vocab
        toks = np.empty((B, S), np.int32)
        toks[:, 0] = self.rng.randint(0, V, size=B)
        for t in range(1, S):
            coin = self.rng.rand(B) < 0.5
            toks[:, t] = np.where(coin, self._succ[toks[:, t - 1]],
                                  self.rng.randint(0, V, size=B))
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class PrefetchPipeline:
    """Bounded prefetch buffer filled from the engine's progress loop."""

    def __init__(self, source, engine: ProgressEngine,
                 stream: Optional[Stream] = None, depth: int = 4):
        self.source = iter(source)
        self.engine = engine
        self.stream = stream
        self.depth = depth
        self._buf: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._fut = None
        self.stalls = 0          # times next_batch had to block
        self.fills = 0
        # strict: an exhausted/broken source (StopIteration from next())
        # must surface to next_batch's caller, not silently unregister
        # the fill hook and leave next_batch spinning on an empty buffer
        self._sub = engine.register_subsystem(
            "data-pipeline", self._poll, cheap=True, priority=1, strict=True)

    def _poll(self) -> bool:
        """Engine subsystem hook: keep the buffer full, one fill in flight."""
        with self._lock:
            depth_now = len(self._buf)
            fut = self._fut
        if fut is not None:
            if not fut.done():
                return False
            batch = fut.result()
            with self._lock:
                self._buf.append(batch)
                self._fut = None
            self.fills += 1
            return True
        if depth_now < self.depth:
            self._fut = io_pool().submit(lambda: next(self.source))
            return False
        return False

    def next_batch(self):
        while True:
            with self._lock:
                if self._buf:
                    return self._buf.popleft()
            self.stalls += 1
            self.engine.progress(self.stream)

    def close(self):
        self.engine.unregister_subsystem(self._sub)
