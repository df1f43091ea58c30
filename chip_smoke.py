#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

1. build   — nvcc builds the kernel library from ``src/repro_torch/csrc``
             for sm_90a (commands and seconds printed);
2. kernels — each hand-written kernel against its plain PyTorch version
             on the card, at the serve path's shapes, in bf16 and f32,
             with the tolerance stated; timed with CUDA events beside
             its bound and one PyTorch library call (a yardstick only);
3. serve   — the port's serving launcher (``repro_torch.launch.serve``)
             at full qwen2-0.5b width: 16 requests through 8 lanes on
             the progress engine, caller-driven and then with two
             progress workers.  Launch counters are zeroed just before
             and read just after each run, and must show every fused
             decode/prefill call went through both kernels.  Between
             the two runs, fused decode calls are timed: host wall clock
             (unprofiled) against device busy time (profiled);
4. check   — full-width f32 decode steps on the card (kernels) against
             the same steps on the CPU (plain versions).

Prints the card's name and power limit, then one JSON line of kernel
figures, then ``{"ok": true, "device": {...}}`` as the last line.  Exits
non-zero without a result when CUDA is missing, and when run outside a
checkout of the repository (it imports ``src/repro_torch``).
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is the
# larger of its bytes over the memory rate and its flops over the rate of
# its inputs' type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOLS = {torch.float32: dict(atol=2e-5, rtol=2e-5),     # tests/test_kernels.py
        torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}

ARCH = "qwen2-0.5b"
LANES, MAX_SEQ, BLOCK = 8, 1024, 16
MIN_PROMPT, MAX_PROMPT, MAX_NEW, REQUESTS = 16, 256, 32, 16
L2_BYTES = 50 * 2**20


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, args_list, iters: int = 200) -> float:
    """Mean ms of ``fn(*args)`` over ``iters`` launches, cycling through
    ``args_list`` (copies of the inputs, so they are not all in L2)."""
    for a in args_list[:3]:
        fn(*a)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, args_list, iters: int = 50) -> float:
    """Mean device time of ``fn(*args)`` in ms: the summed duration of the
    CUDA kernels the profiler records over ``iters`` calls.  Unlike
    ``time_ms`` it excludes the gaps while the host enqueues, which at
    these sizes are most of the wall time."""
    for a in args_list[:3]:
        fn(*a)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    return sum(e.time_range.elapsed_us() for e in kernels) / iters / 1e3


def copies_for(nbytes: int, iters: int = 200) -> int:
    """Input copies enough to stream twice the L2 cache per cycle."""
    return min(iters, max(1, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


def fmt(times: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in times.items())


def check_close(name, got, want, dtype) -> float:
    err = (got.float() - want.float()).abs()
    tol = TOLS[dtype]
    bad = err > tol["atol"] + tol["rtol"] * want.float().abs()
    if not torch.isfinite(got.float()).all() or bad.any():
        raise AssertionError(
            f"{name} {dtype}: {int(bad.sum())} elements off the plain "
            f"version beyond atol={tol['atol']} rtol={tol['rtol']} "
            f"(max abs err {float(err.max()):.3e})")
    return float(err.max())


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_rmsnorm(gen) -> dict:
    from repro_torch.kernels.rmsnorm import rmsnorm_fwd, rmsnorm_fwd_plain
    D, eps = 896, 1e-6
    row = None
    for N in (LANES, LANES * MAX_PROMPT):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(N, D, generator=gen, device="cuda").to(dtype)
            s = torch.randn(D, generator=gen, device="cuda") + 1.0
            got = rmsnorm_fwd(x, s, eps)
            torch.cuda.synchronize()
            err = check_close("rmsnorm_fwd", got, rmsnorm_fwd_plain(x, s, eps),
                              dtype)
            nbytes = 2 * x.numel() * x.element_size() + s.numel() * 4
            args = [(x.clone(), s) for _ in range(copies_for(nbytes))]
            fns = {"kernel": lambda a, b: rmsnorm_fwd(a, b, eps),
                   "plain": lambda a, b: rmsnorm_fwd_plain(a, b, eps),
                   "F.rms_norm": lambda a, b: F.rms_norm(a, (D,), b.to(dtype),
                                                         eps)}
            dev = {k: device_ms(f, args) for k, f in fns.items()}
            paced = {k: time_ms(f, args) for k, f in fns.items()}
            ms, plain_ms, lib_ms = dev.values()
            bound = max(nbytes / HBM_BYTES_PER_S,
                        4 * x.numel() / PEAK_FLOPS[dtype]) * 1e3
            log(f"kernel rmsnorm_fwd N={N} D={D} {str(dtype)[6:]}: max abs "
                f"err {err:.3e} (atol/rtol {TOLS[dtype]['atol']}); device ms "
                f"{fmt(dev)}; back-to-back ms per call {fmt(paced)}; bound "
                f"{bound:.6f} ms (bytes)")
            if N == LANES and dtype == torch.bfloat16:     # the serve path
                row = dict(name="rmsnorm_fwd", route="cuda",
                           source="src/repro_torch/csrc/rmsnorm.cu",
                           replaces="src/repro/kernels/rmsnorm.py:41",
                           max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound, bound_by="bytes",
                           library_ms=lib_ms)
    return row


def kernel_flash_decode(gen) -> dict:
    from repro_torch.kernels.decode_attention import (flash_decode,
                                                      flash_decode_plain)
    B, H, KVH, hd = LANES, 14, 2, 64
    S = -(-MAX_SEQ // BLOCK) * BLOCK          # the serve phase's view length
    row = None
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn(B, H, hd, generator=gen, device="cuda").to(dtype)
        k = torch.randn(B, S, KVH, hd, generator=gen, device="cuda").to(dtype)
        v = torch.randn(B, S, KVH, hd, generator=gen, device="cuda").to(dtype)
        lengths = torch.randint(1, S + 1, (B,), generator=gen, device="cuda",
                                dtype=torch.int32)
        got = flash_decode(q, k, v, lengths)
        torch.cuda.synchronize()
        err = check_close("flash_decode", got,
                          flash_decode_plain(q, k, v, lengths), dtype)
        es = q.element_size()
        valid = int(lengths.sum())
        nbytes = (2 * q.numel() * es + 2 * valid * KVH * hd * es + 4 * B)
        flops = 4 * valid * H * hd
        args = [(q, k.clone(), v.clone(), lengths)
                for _ in range(copies_for(2 * k.numel() * es))]
        pos = torch.arange(S, device="cuda")
        mask = (pos[None, :] < lengths[:, None])[:, None, None, :]

        def sdpa(q_, k_, v_, _len):
            return F.scaled_dot_product_attention(
                q_[:, :, None], k_.transpose(1, 2), v_.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)

        fns = {"kernel": flash_decode, "plain": flash_decode_plain,
               "sdpa": sdpa}
        dev = {k: device_ms(f, args) for k, f in fns.items()}
        paced = {k: time_ms(f, args) for k, f in fns.items()}
        ms, plain_ms, lib_ms = dev.values()
        bound = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]) * 1e3
        log(f"kernel flash_decode B={B} H={H} KVH={KVH} hd={hd} S={S} "
            f"{str(dtype)[6:]} (sum lengths {valid}): max abs err {err:.3e} "
            f"(atol/rtol {TOLS[dtype]['atol']}); device ms {fmt(dev)}; "
            f"back-to-back ms per call {fmt(paced)}; bound {bound:.6f} ms "
            f"(bytes)")
        if dtype == torch.bfloat16:                          # the serve path
            row = dict(name="flash_decode", route="cuda",
                       source="src/repro_torch/csrc/flash_decode.cu",
                       replaces="src/repro/kernels/decode_attention.py:80",
                       max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound,
                       bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                       >= flops / PEAK_FLOPS[dtype] else "operations",
                       library_ms=lib_ms)
    return row


# ---------------------------------------------------------------------------
# phase 3: the serve path
# ---------------------------------------------------------------------------

def serve(workers: int):
    from repro_torch.kernels import _lib
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models.layers import tree_leaves
    argv = ["--arch", ARCH, "--scale", "full", "--device", "cuda",
            "--slots", str(LANES), "--max-seq", str(MAX_SEQ),
            "--kv-block-size", str(BLOCK), "--requests", str(REQUESTS),
            "--min-prompt", str(MIN_PROMPT), "--max-prompt", str(MAX_PROMPT),
            "--max-new", str(MAX_NEW), "--progress-workers", str(workers)]
    args = serve_mod.build_parser().parse_args(argv)
    _lib.reset_launches()
    report = serve_mod.run(args)
    launches = dict(_lib.launches)
    srv, cfg = report.server, report.server.cfg
    log(f"serve [{workers} progress workers] " + "\n  ".join(report.format()))
    calls = report.steps + report.prefill_calls
    want = {"rmsnorm_fwd": calls * (2 * cfg.num_layers + 1),
            "flash_decode": calls * cfg.num_layers}
    log(f"serve launches {launches}, expected {want} for {calls} fused calls")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    short = [r.request_id for r in report.requests
             if len(r.out_tokens) != MAX_NEW or r.done_req.failed]
    if short:
        raise AssertionError(f"requests without {MAX_NEW} tokens: {short}")
    off = [p for p, t in [*tree_leaves(srv.params),
                          *tree_leaves(srv.slots.cache)]
           if t.device.type != "cuda"]
    if off:
        raise AssertionError(f"tensors off the card: {off}")
    if (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.d_ff, cfg.vocab_size) != (24, 896, 14, 2, 4864, 151936):
        raise AssertionError(f"not the full qwen2-0.5b width: {cfg}")
    lat = report.latency
    log(f"serve summary [{workers} workers]: decode steps {report.steps}, "
        f"prefill calls {report.prefill_calls}, "
        f"{report.tokens / report.wall_s:.2f} tokens/s, mean decode step "
        f"{srv.mean_step_ms():.3f} ms, wall {report.wall_s:.3f} s, TTFT p50 "
        f"{lat.ttft_ms_p50:.1f} ms p99 {lat.ttft_ms_p99:.1f} ms")
    return launches, srv


def time_breakdown(srv, calls: int = 10) -> None:
    """Where a fused decode call's time goes: host wall clock against the
    device time the profiler records, on the served engine's weights and
    pool, with the 8 lanes at prompt-like positions.  The wall clock comes
    from a pass without the profiler, whose own host cost would count as
    idle card time; the device time from a second, profiled pass."""
    from repro_torch.models import registry
    cfg = srv.cfg
    rs = np.random.RandomState(3)
    dev = srv.device
    toks = torch.from_numpy(rs.randint(0, cfg.vocab_size, (LANES, 1))
                            .astype(np.int32)).to(dev)
    pos = torch.from_numpy(rs.randint(MIN_PROMPT, MAX_PROMPT + MAX_NEW, LANES)
                           .astype(np.int32)).to(dev)
    nb = srv.slots.max_blocks
    tables = (1 + torch.arange(LANES * nb, dtype=torch.int32,
                               device=dev)).reshape(LANES, nb)

    def step():
        registry.decode_step_paged(srv.params, cfg, srv.slots.cache, toks,
                                   pos, tables)

    def wall_ms() -> float:
        t0 = time.perf_counter()
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / calls

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    wall = wall_ms()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        wall_profiled = wall_ms()
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            key = e.name.split("(")[0][-60:]
            by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values()) / calls / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"time: fused decode call (8 lanes, 24 layers): wall {wall:.3f} ms "
        f"({wall_profiled:.3f} ms under the profiler), device busy "
        f"{busy:.3f} ms, device idle share {1 - busy / wall:.3f}; top "
        f"device time per call: "
        + "; ".join(f"{k} {v / calls / 1e3:.4f} ms" for k, v in top))


# ---------------------------------------------------------------------------
# phase 4: full-width f32 decode, card (kernels) vs CPU (plain versions)
# ---------------------------------------------------------------------------

def reference_check() -> None:
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.models.layers import tree_map
    cfg = get_config(ARCH).with_overrides(dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = registry.init_params(cfg, gen)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    B, nb = LANES, 4
    tables = (1 + torch.arange(B * nb, dtype=torch.int32)).reshape(B, nb)
    caches = {dev: registry.init_paged_cache(cfg, B, 1 + B * nb, BLOCK, dev)
              for dev in ("cuda", "cpu")}
    rs = np.random.RandomState(2)
    pos = rs.randint(0, 8, size=B).astype(np.int32)
    worst = 0.0
    for step in range(4):
        toks = torch.from_numpy(
            rs.randint(0, cfg.vocab_size, size=(B, 1)).astype(np.int32))
        p = torch.from_numpy(pos)
        got, caches["cuda"] = registry.decode_step_paged(
            params, cfg, caches["cuda"], toks.cuda(), p.cuda(), tables.cuda())
        want, caches["cpu"] = registry.decode_step_paged(
            cpu_params, cfg, caches["cpu"], toks, p, tables)
        got = got.cpu()
        if got.shape != (B, 1, cfg.vocab_size) or not torch.isfinite(got).all():
            raise AssertionError(f"bad logits {tuple(got.shape)}")
        err = (got - want).abs()
        if (err > 1e-3 + 1e-3 * want.abs()).any():
            raise AssertionError(f"card vs CPU logits differ: max abs err "
                                 f"{float(err.max()):.3e}")
        if not torch.equal(got.argmax(-1), want.argmax(-1)):
            raise AssertionError("card vs CPU greedy tokens differ")
        worst = max(worst, float(err.max()))
        pos = pos + 1 + step
    log(f"check: full-width f32 decode, card kernels vs CPU plain versions, "
        f"4 steps x {B} lanes: max abs logit err {worst:.3e} (atol/rtol "
        f"1e-3), greedy tokens equal")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _lib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}; card {torch.cuda.get_device_name(0)}")

    info = _lib.build()
    for cmd in info.commands:
        log("build: " + " ".join(cmd))
    log(f"build: {info.path.name} in {info.seconds:.1f} s"
        + ("" if info.commands else " (already built)"))
    _lib.lib()

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [kernel_rmsnorm(gen), kernel_flash_decode(gen)]

    launches, srv = serve(workers=0)
    time_breakdown(srv)
    del srv
    serve(workers=2)
    for row in rows:
        row["launches"] = launches[row["name"]]
    reference_check()
    log(f"total {time.perf_counter() - t_start:.1f} s")

    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(smi)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
