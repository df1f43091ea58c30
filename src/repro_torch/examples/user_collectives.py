"""Paper §4.7: user-level collectives against the native backend (the JAX
package's ``examples/user_collectives.py``).

The port's mesh holds its 8 ranks on one device, each rank's shard a
slice of a tensor's leading dim (``launch/mesh.py``); the native backend
sums over those slices in one op.  Shows every allreduce schedule
against it, times a single-int allreduce (the paper's Fig 13: the user
schedule against the native backend), drives nonblocking and persistent
allreduces on the engine, and the overlapped all-gather GEMM.

    PYTHONPATH=src python -m repro_torch.examples.user_collectives \
        [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

N = 8


def native_allreduce(x: torch.Tensor, n: int = N) -> torch.Tensor:
    """The native backend: every rank's block replaced by the sum of all
    ranks' blocks (x's leading dim holds the n ranks' shards)."""
    blocks = x.unflatten(0, (n, x.shape[0] // n))
    return blocks.sum(0, keepdim=True).expand_as(blocks).flatten(0, 1)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_us(fn, x, device, iters: int = 200) -> float:
    """Mean µs of ``fn(x)`` over ``iters`` calls, the device drained
    before and after (host clock)."""
    fn(x)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(x)
    _sync(device)
    del out
    return (time.perf_counter() - t0) / iters * 1e6


def main(argv=None) -> dict:
    """Run the demo; returns the largest error of every check and the Fig
    13 times in µs, by name."""
    from repro_torch import resolve_device
    from repro_torch.collectives import nonblocking as NB
    from repro_torch.collectives import schedules as S
    from repro_torch.collectives.overlap import collective_matmul_ag
    from repro_torch.core import ProgressEngine
    from repro_torch.launch.mesh import make_mesh

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    mesh = make_mesh((N,), ("x",), device)
    out: dict = {"errors": {}, "fig13_us": {}}

    print(f"== correctness vs the native backend ({N} ranks on {device}) ==")
    x = torch.randn(N, 4, 64, generator=gen, device=device)
    expected = native_allreduce(x)
    for name in S.ALGORITHMS:
        got = S.allreduce_under_shard_map(x, mesh, "x", name)
        err = float((got - expected).abs().max())
        out["errors"][name] = err
        print(f"   {name:22s} max err {err:.2e}")

    print("== Fig 13: single-int allreduce latency ==")
    one = torch.arange(N, dtype=torch.float32, device=device).reshape(N, 1)
    native_us = bench_us(native_allreduce, one, device)
    out["fig13_us"]["native"] = native_us
    print(f"   native (sum over ranks) {native_us:8.1f} µs")
    for name in S.ALGORITHMS:
        us = bench_us(lambda v, a=name: S.allreduce_under_shard_map(
            v, mesh, "x", a), one, device)
        out["fig13_us"][name] = us
        print(f"   {name:22s} {us:8.1f} µs ({us / native_us:.1f}x native)")

    print("== nonblocking engine-driven iallreduce (chunk-pipelined) ==")
    eng = ProgressEngine()
    coll = NB.UserCollectives(eng)
    try:
        big = torch.randn(N, 4096, generator=gen, device=device)
        want = big.sum(0)
        for alg, K in (("ring", 1), ("ring", 4), ("recursive_doubling", 2)):
            req = coll.iallreduce(big, mesh, "x", algorithm=alg, chunks=K)
            state = "pending" if not req.is_complete else "complete"
            t0 = time.perf_counter()
            res = req.wait(timeout=120)
            ms = (time.perf_counter() - t0) * 1e3
            err = float((res[0] - want).abs().max())
            out["errors"][f"iallreduce {alg} chunks={K}"] = err
            print(f"   {alg:22s} chunks={K} at issue: {state}; "
                  f"{req.rounds_done} rounds in {ms:6.1f} ms, max err "
                  f"{err:.2e}")
        print("== persistent schedules + round batching (MPI *_init/Start) ==")
        h = coll.allreduce_init(big, mesh, "x", algorithm="ring", chunks=4)
        t0 = time.perf_counter()
        for _ in range(3):
            p = torch.randn(big.shape, generator=gen, device=device)
            res = h.start(p).wait(timeout=120)
            err = float((res[0] - p.sum(0)).abs().max())
            out["errors"]["persistent ring chunks=4"] = max(
                err, out["errors"].get("persistent ring chunks=4", 0.0))
        ms = (time.perf_counter() - t0) / 3 * 1e3
        print(f"   ring chunks=4 persistent: round_batch={h.round_batch}, "
              f"{h.dispatches_per_start} dispatch(es)/start, "
              f"{h.starts} rebinds at {ms:6.1f} ms each")
        h.close()
    finally:
        coll.close()

    print("== collective matmul (overlapped all-gather GEMM) ==")
    xm = torch.randn(N, 8, 32, generator=gen, device=device)
    w = torch.randn(N, 32, 16, generator=gen, device=device)
    got = collective_matmul_ag(xm, w)
    want = xm.reshape(N * 8, 32)[None] @ w
    err = float((got - want).abs().max())
    out["errors"]["collective_matmul_ag"] = err
    print(f"   AG-matmul max err {err:.2e} (each step's GEMM overlaps the "
          f"next chunk's ring shift)")
    return out


if __name__ == "__main__":
    main()
