"""Event-driven continuous-batching server demo (paper §2.7 applied; the
JAX package's ``examples/serve_lm.py``).

Requests arrive while the engine runs; admission, prefill, fused decode
and completion events are all async tasks on ONE progress engine — no
per-request threads, no blocking waits.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --requests 6 \
        --slots 3 [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def tiny_config():
    from repro_torch.configs import get_config
    return get_config("qwen2-0.5b").with_overrides(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, remat_policy="none")


def prompts(n: int) -> list:
    """The demo's prompts: 2 to 5 tokens each, from a seeded numpy
    generator."""
    rng = np.random.RandomState(0)
    return [rng.randint(1, 250, size=rng.randint(2, 6)).astype(np.int32)
            for _ in range(n)]


def main(argv=None) -> list:
    """Serve; returns each request's generated tokens, in submit order."""
    from repro_torch import resolve_device
    from repro_torch.core import ProgressEngine
    from repro_torch.models import registry
    from repro_torch.serve.engine import GenRequest, ServeEngine

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = tiny_config()
    params = registry.init_params(
        cfg, torch.Generator(device=device).manual_seed(0))
    eng = ProgressEngine()
    srv = ServeEngine(cfg, params, eng, batch_slots=args.slots, max_seq=64,
                      device=device)
    reqs = []
    for i, prompt in enumerate(prompts(args.requests)):
        r = GenRequest(f"req{i}", prompt, max_new_tokens=args.max_new)
        srv.submit(r)
        reqs.append(r)
        # interleave arrivals with progress (requests land mid-flight)
        for _ in range(20):
            eng.progress()

    srv.run_until_idle(timeout=300)
    print(f"{'request':8s} {'prompt':>7s} {'out tokens':32s} "
          f"{'ttft(ms)':>9s} {'total(ms)':>9s}")
    for r in reqs:
        ttft = (r.first_token_at - r.submitted_at) * 1e3
        total = (r.finished_at - r.submitted_at) * 1e3
        print(f"{r.request_id:8s} {len(r.prompt):7d} "
              f"{str(r.out_tokens):32s} {ttft:9.1f} {total:9.1f}")
    generated = sum(len(r.out_tokens) for r in reqs)
    print(f"decode steps (fused over slots): {srv.steps} for {generated} "
          f"generated tokens -> continuous batching factor "
          f"{generated / max(srv.steps, 1):.2f}x")
    srv.close()
    return [list(r.out_tokens) for r in reqs]


if __name__ == "__main__":
    main()
