"""Quickstart: the progress engine in five minutes (the JAX package's
``examples/quickstart.py``).

Walks the paper's core API (streams, async tasks, requests, collated
subsystems) and trains a tiny LM for a few steps with every async
subsystem (data prefetch, checkpointing) driven by ONE engine; the
device's work is harvested through a ``torch_future`` on the same
engine.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile
import time

import torch

from repro_torch.core import DONE, NOPROGRESS, ProgressEngine, Request


def demo_engine():
    print("== 1. MPIX-style async tasks ==")
    eng = ProgressEngine()
    deadline = time.monotonic() + 0.05

    def poll(thing):                     # paper Listing 1.2
        if time.monotonic() >= deadline:
            print(f"   task done (state={thing.state})")
            return DONE
        return NOPROGRESS

    eng.async_start(poll, {"job": 42})
    req = Request()
    eng.async_start(lambda t: (req.complete("hello"), DONE)[1])
    while not req.is_complete:           # MPIX_Request_is_complete
        eng.progress()                   # MPIX_Stream_progress
    eng.drain(timeout=5)
    print(f"   request value: {req.value()}")

    print("== 2. streams isolate contexts ==")
    s1, s2 = eng.stream("io"), eng.stream("net")
    eng.async_start(lambda t: DONE, None, s1)
    eng.progress(s2)                     # does NOT advance s1
    assert s1.pending == 1
    eng.progress(s1)
    assert s1.pending == 0
    print("   progress(s2) left s1 untouched — no cross-stream contention")


def demo_train(device) -> list:
    """Ten steps of a tiny LM; returns the logged metrics."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PrefetchPipeline, SyntheticLM
    from repro_torch.launch.steps import train_step_fn
    from repro_torch.models import registry
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_loop import Trainer, TrainLoopConfig

    print(f"== 3. tiny LM training with one collated engine ({device}) ==")
    cfg = get_config("smollm-360m").with_overrides(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, remat_policy="none")
    params = registry.init_params(
        cfg, torch.Generator(device=device).manual_seed(0))
    ocfg = opt_mod.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=50)
    opt_state = opt_mod.init(params)

    def to_device(b):
        return {k: torch.from_numpy(v.copy()).to(device) for k, v in b.items()}

    eng = ProgressEngine()
    pipe = PrefetchPipeline(map(to_device, iter(SyntheticLM(512, 32, 8,
                                                            seed=7))),
                            eng, depth=2)
    try:
        with tempfile.TemporaryDirectory() as ckdir:
            trainer = Trainer(train_step_fn(cfg, ocfg), params, opt_state,
                              pipe,
                              TrainLoopConfig(total_steps=10,
                                              checkpoint_every=5,
                                              checkpoint_dir=ckdir,
                                              log_every=2),
                              engine=eng,
                              hooks=[lambda s, m: print(
                                  f"   step {s}: loss={m['loss']:.3f} "
                                  f"({m['step_time_s'] * 1e3:.0f} ms)")])
            log = trainer.run()
    finally:
        pipe.close()
    if not log[-1]["loss"] < log[0]["loss"]:
        raise RuntimeError(f"the loss did not fall: {log[0]['loss']} -> "
                           f"{log[-1]['loss']}")
    print(f"   loss {log[0]['loss']:.3f} -> {log[-1]['loss']:.3f}; "
          f"data stalls: {pipe.stalls}")
    return log


def main(argv=None) -> list:
    from repro_torch import resolve_device
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    demo_engine()
    log = demo_train(device)
    print("quickstart OK")
    return log


if __name__ == "__main__":
    main()
