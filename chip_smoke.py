#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

1. build   — nvcc builds the kernel library from ``src/repro_torch/csrc``
             for sm_90a (commands and seconds printed);
2. kernels — each hand-written kernel against its plain PyTorch version
             on the card, at the serve and train paths' shapes, in bf16
             and f32, with the tolerance stated; timed with the profiler
             and CUDA events beside its bound and, where one exists, one
             PyTorch library call (a yardstick only);
3. serve   — the port's serving launcher (``repro_torch.launch.serve``)
             at full qwen2-0.5b width: 16 requests through 8 lanes on
             the progress engine, caller-driven and then with two
             progress workers.  Launch counters are zeroed just before
             and read just after each run, and must show every fused
             decode/prefill call went through both kernels.  Between
             the two runs, fused decode calls are timed: host wall clock
             (unprofiled) against device busy time (profiled);
4. train   — the port's training launcher (``repro_torch.launch.train``)
             at full smollm-360m width: 6 steps of batch 8 x 1024 tokens,
             caller-driven and then with two progress workers, each from
             a fresh checkpoint directory.  The launch counters must show
             every step went through rmsnorm_fwd, rmsnorm_bwd and
             flash_attention as many times as the step's derivation says;
             the final async checkpoint must restore to the same tensors.
             Between the two runs, one step is timed as in phase 3;
5. check   — full-width f32 decode steps, and one full-width two-layer
             f32 train step, on the card (kernels) against the same steps
             on the CPU (plain versions).

Prints the card's name and power limit, then one JSON line of kernel
figures, then ``{"ok": true, "device": {...}}`` as the last line.  Exits
non-zero without a result when CUDA is missing, and when run outside a
checkout of the repository (it imports ``src/repro_torch``).
"""
from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import tempfile
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
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "smollm-360m", 8, 1024, 6
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


NO_PROFILER: list = []      # set once the profiler has recorded nothing


def profile_kernels(run):
    """Device time in us per kernel name over ``run()``, from
    ``torch.profiler``, and ``run()``'s result.  Empty when the profiler
    records no device time: some machines give it no CUPTI access."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            key = e.name.split("(")[0][-60:]
            by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us()
    if not by_name and not NO_PROFILER:
        NO_PROFILER.append(True)
        log("profiler: no device events on this machine; every 'device ms' "
            "below is the CUDA-event time of back-to-back launches, and "
            "device busy time is not measured")
    return by_name, out


def device_ms(fn, args_list, iters: int = 50) -> tuple[float, str]:
    """Mean device time of ``fn(*args)`` in ms and the timer it came from.
    From ``"profiler"``: the summed duration of the CUDA kernels the
    profiler records over ``iters`` calls, which excludes the gaps while
    the host enqueues (at these sizes most of the wall time).  Without
    profiler events, from ``"cuda_events"``: ``time_ms``'s back-to-back
    time, gaps included."""
    for a in args_list[:3]:
        fn(*a)
    torch.cuda.synchronize()

    def run():
        for i in range(iters):
            fn(*args_list[i % len(args_list)])

    by_name, _ = profile_kernels(run)
    if not by_name:
        return time_ms(fn, args_list, iters), "cuda_events"
    return sum(by_name.values()) / iters / 1e3, "profiler"


def measure(fns: dict, args_list, dev_iters: int = 50,
            paced_iters: int = 200):
    """Device ms (``device_ms``) and back-to-back ms (``time_ms``) of each
    of ``fns`` on the same inputs, and the timer of the device ms: one
    name, or ``"mixed"`` if the profiler recorded some calls only."""
    dev, sources = {}, set()
    for name, fn in fns.items():
        dev[name], source = device_ms(fn, args_list, dev_iters)
        sources.add(source)
    paced = {name: time_ms(fn, args_list, paced_iters)
             for name, fn in fns.items()}
    return dev, paced, sources.pop() if len(sources) == 1 else "mixed"


def busy_text(by_name: dict, n: int, wall: float, unit: str, top: int) -> str:
    """Device busy time, idle share and top kernels per ``unit``, from
    ``profile_kernels`` over ``n`` units that took ``wall`` ms each."""
    if not by_name:
        return "device busy not measured (no profiler events)"
    busy = sum(by_name.values()) / n / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return (f"device busy {busy:.3f} ms, device idle share "
            f"{1 - busy / wall:.3f}; top device time per {unit}: "
            + "; ".join(f"{k} {v / n / 1e3:.4f} ms" for k, v in ranked))


def copies_for(nbytes: int, iters: int = 200) -> int:
    """Input copies enough to stream twice the L2 cache per cycle."""
    return min(iters, max(1, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


def fmt(times: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in times.items())


def check_close(name, got, want, dtype, tol=None) -> float:
    err = (got.float() - want.float()).abs()
    tol = tol or TOLS[dtype]
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
    row = None
    # the serve path's (qwen2-0.5b: decode, prefill chunk) and the train
    # path's (smollm-360m: the whole batch) shapes
    for N, D, eps in ((LANES, 896, 1e-6), (LANES * MAX_PROMPT, 896, 1e-6),
                      (TRAIN_BATCH * TRAIN_SEQ, 960, 1e-5)):
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
            dev, paced, source = measure(fns, args)
            bound = max(nbytes / HBM_BYTES_PER_S,
                        4 * x.numel() / PEAK_FLOPS[dtype]) * 1e3
            log(f"kernel rmsnorm_fwd N={N} D={D} {str(dtype)[6:]}: max abs "
                f"err {err:.3e} (atol/rtol {TOLS[dtype]['atol']}); device ms "
                f"({source}) {fmt(dev)}; back-to-back ms per call "
                f"{fmt(paced)}; bound {bound:.6f} ms (bytes)")
            fig = dict(shape=f"x [{N}, {D}] {str(dtype)[6:]}",
                       max_abs_err=err, ms=dev["kernel"],
                       plain_ms=dev["plain"], ms_source=source,
                       bound_ms=bound, bound_by="bytes",
                       library_ms=dev["F.rms_norm"])
            if N == LANES and dtype == torch.bfloat16:     # the serve path
                row = dict(name="rmsnorm_fwd", route="cuda",
                           source="src/repro_torch/csrc/rmsnorm.cu",
                           replaces="src/repro/kernels/rmsnorm.py:41", **fig)
            elif D == 960 and dtype == torch.bfloat16:     # the train path
                row["train_shape"] = fig
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
        dev, paced, source = measure(fns, args)
        bound = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]) * 1e3
        log(f"kernel flash_decode B={B} H={H} KVH={KVH} hd={hd} S={S} "
            f"{str(dtype)[6:]} (sum lengths {valid}): max abs err {err:.3e} "
            f"(atol/rtol {TOLS[dtype]['atol']}); device ms ({source}) "
            f"{fmt(dev)}; back-to-back ms per call {fmt(paced)}; bound "
            f"{bound:.6f} ms (bytes)")
        if dtype == torch.bfloat16:                          # the serve path
            row = dict(name="flash_decode", route="cuda",
                       source="src/repro_torch/csrc/flash_decode.cu",
                       replaces="src/repro/kernels/decode_attention.py:80",
                       shape=f"q [{B}, {H}, {hd}], k/v [{B}, {S}, {KVH}, "
                             f"{hd}] bfloat16",
                       max_abs_err=err, ms=dev["kernel"],
                       plain_ms=dev["plain"], ms_source=source,
                       bound_ms=bound,
                       bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                       >= flops / PEAK_FLOPS[dtype] else "operations",
                       library_ms=dev["sdpa"])
    return row


def kernel_rmsnorm_bwd(gen) -> dict:
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd, rmsnorm_bwd_plain
    eps, row = 1e-5, None
    for N, D in ((TRAIN_BATCH * TRAIN_SEQ, 960), (LANES, 896)):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(N, D, generator=gen, device="cuda").to(dtype)
            g = torch.randn(N, D, generator=gen, device="cuda").to(dtype)
            s = torch.randn(D, generator=gen, device="cuda") + 1.0
            dx, part = rmsnorm_bwd(x, s, g, eps)
            torch.cuda.synchronize()
            want_dx, want_part = rmsnorm_bwd_plain(x, s, g, eps)
            err = check_close("rmsnorm_bwd dx", dx, want_dx, dtype)
            # the summed dscale: tests/test_kernels.py:121-122
            ds_err = check_close("rmsnorm_bwd dscale", part.sum(0),
                                 want_part.sum(0), dtype,
                                 dict(atol=1e-3, rtol=1e-3))
            es = x.element_size()
            nbytes = 3 * x.numel() * es + part.numel() * 4 + D * 4
            args = [(x.clone(), s, g.clone()) for _ in range(copies_for(nbytes))]
            fns = {"kernel": lambda a, b, c: rmsnorm_bwd(a, b, c, eps),
                   "plain": lambda a, b, c: rmsnorm_bwd_plain(a, b, c, eps)}
            dev, paced, source = measure(fns, args)
            bound = max(nbytes / HBM_BYTES_PER_S,
                        12 * x.numel() / PEAK_FLOPS[dtype]) * 1e3
            log(f"kernel rmsnorm_bwd N={N} D={D} {str(dtype)[6:]}: max abs "
                f"err dx {err:.3e} (atol/rtol {TOLS[dtype]['atol']}), summed "
                f"dscale {ds_err:.3e} (atol/rtol 1e-3); device ms "
                f"({source}) {fmt(dev)}; back-to-back ms per call {fmt(paced)}; bound "
                f"{bound:.6f} ms (bytes); no single PyTorch call computes it")
            if N == TRAIN_BATCH * TRAIN_SEQ and dtype == torch.bfloat16:
                row = dict(name="rmsnorm_bwd", route="cuda",
                           source="src/repro_torch/csrc/rmsnorm.cu",
                           replaces="src/repro/kernels/rmsnorm.py:61",
                           shape=f"x, g [{N}, {D}] bfloat16",
                           max_abs_err=err, ms=dev["kernel"],
                           plain_ms=dev["plain"], ms_source=source,
                           bound_ms=bound, bound_by="bytes", library_ms=None)
    return row


def kernel_flash_attention(gen) -> dict:
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    row = None
    shapes = ((TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 15, 5, 64),  # the train path
              (2, 1000, 1000, 6, 3, 64))                       # ragged
    for B, Sq, Sk, H, KVH, hd in shapes:
        for causal in (True, False):
            for dtype in (torch.bfloat16, torch.float32):
                q = torch.randn(B, Sq, H, hd, generator=gen,
                                device="cuda").to(dtype)
                k = torch.randn(B, Sk, KVH, hd, generator=gen,
                                device="cuda").to(dtype)
                v = torch.randn(B, Sk, KVH, hd, generator=gen,
                                device="cuda").to(dtype)
                got = flash_attention(q, k, v, causal=causal)
                torch.cuda.synchronize()
                err = check_close(
                    "flash_attention", got,
                    flash_attention_plain(q, k, v, causal=causal), dtype)
                es = q.element_size()
                nbytes = (2 * q.numel() + 2 * k.numel()) * es
                # (query, key) pairs the mask leaves: what this run computes
                pairs = sum(min(Sk, i + Sk - Sq + 1) for i in range(Sq)) \
                    if causal else Sq * Sk
                flops = 4 * B * H * pairs * hd
                args = [(q, k.clone(), v.clone())
                        for _ in range(copies_for(nbytes))]

                def sdpa(q_, k_, v_):
                    return F.scaled_dot_product_attention(
                        q_.transpose(1, 2), k_.transpose(1, 2),
                        v_.transpose(1, 2), is_causal=causal,
                        enable_gqa=True).transpose(1, 2)

                fns = {"kernel": lambda a, b, c: flash_attention(
                           a, b, c, causal=causal),
                       "plain": lambda a, b, c: flash_attention_plain(
                           a, b, c, causal=causal),
                       "sdpa": sdpa}
                dev, paced, source = measure(fns, args, dev_iters=20,
                                             paced_iters=50)
                t_bytes = nbytes / HBM_BYTES_PER_S
                t_ops = flops / PEAK_FLOPS[dtype]
                bound = max(t_bytes, t_ops) * 1e3
                by = "bytes" if t_bytes >= t_ops else "operations"
                log(f"kernel flash_attention B={B} Sq={Sq} Sk={Sk} H={H} "
                    f"KVH={KVH} hd={hd} causal={causal} {str(dtype)[6:]}: "
                    f"max abs err {err:.3e} (atol/rtol "
                    f"{TOLS[dtype]['atol']}); device ms ({source}) "
                    f"{fmt(dev)}; "
                    f"back-to-back ms per call {fmt(paced)}; bound "
                    f"{bound:.6f} ms ({by}: {flops / 1e9:.2f} GFLOP, "
                    f"{nbytes / 1e6:.1f} MB); kernel "
                    f"{flops / dev['kernel'] / 1e9:.1f} TFLOP/s")
                if (Sq == TRAIN_SEQ and causal
                        and dtype == torch.bfloat16):  # the train path
                    row = dict(name="flash_attention", route="cuda",
                               source="src/repro_torch/csrc/flash_attention.cu",
                               replaces="src/repro/kernels/flash_attention.py:96",
                               shape=f"q [{B}, {Sq}, {H}, {hd}], k/v [{B}, "
                                     f"{Sk}, {KVH}, {hd}] causal bfloat16",
                               max_abs_err=err, ms=dev["kernel"],
                               plain_ms=dev["plain"], ms_source=source,
                               bound_ms=bound, bound_by=by,
                               library_ms=dev["sdpa"])
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
    # under no_grad the training kernels must not launch at all
    want = {"rmsnorm_fwd": calls * (2 * cfg.num_layers + 1),
            "rmsnorm_bwd": 0, "flash_attention": 0,
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
    by_name, wall_profiled = profile_kernels(wall_ms)
    log(f"time: fused decode call (8 lanes, 24 layers): wall {wall:.3f} ms "
        f"({wall_profiled:.3f} ms under the profiler), "
        + busy_text(by_name, calls, wall, "call", 6))


# ---------------------------------------------------------------------------
# phase 4: the train path
# ---------------------------------------------------------------------------

def train(workers: int):
    from repro_torch.kernels import _lib
    from repro_torch.launch import train as train_mod
    from repro_torch.models import registry
    from repro_torch.models.layers import tree_leaves
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")  # no resume
    try:
        args = train_mod.build_parser().parse_args([
            "--arch", TRAIN_ARCH, "--scale", "full", "--device", "cuda",
            "--global-batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--steps", str(TRAIN_STEPS), "--ckpt-dir", ckpt_dir])
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launches()
        report = train_mod.run(args, log_every=1, progress_workers=workers)
        launches = dict(_lib.launches)
        cfg, tr = report.cfg, report.trainer
        if (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                cfg.resolved_head_dim(), cfg.d_ff, cfg.vocab_size,
                cfg.tie_embeddings, cfg.rms_norm_eps, cfg.dtype,
                cfg.param_dtype, cfg.remat_policy) != (
                32, 960, 15, 5, 64, 2560, 49152, True, 1e-5, "bfloat16",
                "float32", "full"):
            raise AssertionError(f"not the full smollm-360m width: {cfg}")
        per_step = train_mod.kernel_launches_per_step(cfg)
        want = {k: v * TRAIN_STEPS for k, v in per_step.items()}
        log(f"train launches {launches}, expected {want} ({per_step} per "
            f"step x {TRAIN_STEPS} steps)")
        if launches != want:
            raise AssertionError(f"launch counts {launches} != {want}")
        losses = [m["loss"] for m in report.log]
        if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"bad loss trajectory {losses}")
        off = [p for p, t in [*tree_leaves(tr.params),
                              *tree_leaves(tr.opt_state.mu),
                              *tree_leaves(tr.opt_state.nu)]
               if t.device.type != "cuda"]
        if off or tr.opt_state.step.device.type != "cuda":
            raise AssertionError(f"tensors off the card: {off}")
        latest = tr.ckpt.latest_step()
        if latest != TRAIN_STEPS - 1:
            raise AssertionError(f"last committed checkpoint {latest}")
        state = {"params": tr.params, "opt_state": tr.opt_state}
        back = tr.ckpt.restore(latest, state, device="cuda")
        diff = [p for (p, a), (_, b) in zip(tree_leaves(back["params"]),
                                            tree_leaves(tr.params))
                if not torch.equal(a, b)]
        for name in ("mu", "nu"):
            diff += [(name, p) for (p, a), (_, b) in zip(
                tree_leaves(getattr(back["opt_state"], name)),
                tree_leaves(getattr(tr.opt_state, name)))
                if not torch.equal(a, b)]
        if diff or not torch.equal(back["opt_state"].step,
                                   tr.opt_state.step):
            raise AssertionError(f"checkpoint restores other values: {diff}")
        steps_s = [m["step_time_s"] for m in report.log[1:]]
        mean_s = sum(steps_s) / len(steps_s)
        tokens = TRAIN_BATCH * TRAIN_SEQ
        flops = registry.model_flops(cfg, tokens, training=True,
                                     seq_len=TRAIN_SEQ)
        log(f"train [{workers} progress workers]: losses "
            f"{[round(x, 6) for x in losses]}; mean step {mean_s * 1e3:.3f} "
            f"ms (steps 1-{TRAIN_STEPS - 1}; step 0 "
            f"{report.log[0]['step_time_s'] * 1e3:.3f} ms), "
            f"{tokens / mean_s:.1f} tokens/s, model {flops / mean_s / 1e12:.2f} "
            f"TFLOP/s ({flops / 1e12:.2f} TFLOP a step by registry.model_flops); "
            f"checkpoint of step {latest} committed {tr.ckpt.last_save_s:.3f} "
            f"s after save_async and restored equal; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; wall "
            f"{report.wall_s:.3f} s")
        return launches, report
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def train_time_breakdown(report, steps: int = 3) -> None:
    """Where a train step's time goes: host wall clock of unprofiled
    steps against the device time the profiler records over as many
    profiled steps, on the trained weights and one fixed batch."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train as train_mod
    from repro_torch.train import optimizer as opt_mod
    tr, cfg = report.trainer, report.cfg
    step = train_mod.make_train_step(cfg, opt_mod.AdamWConfig(
        lr=3e-3, warmup_steps=5, total_steps=10))
    batch = {k: torch.from_numpy(v.copy()).cuda() for k, v in
             SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=9)
             .sample().items()}
    state = {"p": tr.params, "o": tr.opt_state}

    def wall_ms() -> float:
        t0 = time.perf_counter()
        for _ in range(steps):
            state["p"], state["o"], _ = step(state["p"], state["o"], batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    wall_ms()
    wall = wall_ms()
    by_name, wall_profiled = profile_kernels(wall_ms)
    log(f"time: train step (smollm-360m, {TRAIN_BATCH}x{TRAIN_SEQ} tokens, "
        f"32 layers, remat full): wall {wall:.3f} ms ({wall_profiled:.3f} ms "
        f"under the profiler), " + busy_text(by_name, steps, wall, "step", 8))


# ---------------------------------------------------------------------------
# phase 5: full-width f32 decode, card (kernels) vs CPU (plain versions)
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


def leaf_errors(label, names, got, want, limit) -> float:
    """Per leaf, ``max|got - want|`` over ``max|want|``; raises if any leaf
    is not finite or its share exceeds ``limit``.  Returns the worst."""
    worst = 0.0
    for name, a, b in zip(names, got, want):
        share = float((a - b).abs().max() / b.abs().max())
        if not torch.isfinite(a).all() or not share <= limit:
            raise AssertionError(
                f"{label} {'/'.join(name)}: card vs CPU max abs err "
                f"{float((a - b).abs().max()):.3e}, {share:.3e} of the "
                f"leaf's largest entry (limit {limit:g})")
        worst = max(worst, share)
    return worst


def train_reference_check() -> None:
    """One f32 train step of a two-layer smollm-360m at full width (B=2,
    S=128) on the card (kernels) and on the CPU (plain versions), from the
    same weights and batch.  Both sides are f32 with TF32 off: only the
    order of the sums differs (cuBLAS and the kernels' tiles against the
    CPU's).  Each stage is held to its own inputs, with a limit scaled to
    each leaf, since a typical gradient entry (~1e-3) is smaller than any
    fixed absolute limit worth having:

    - loss: |a - b| <= 1e-5 |b|;
    - gradients: max|a - b| <= 1e-4 max|b| per leaf;
    - AdamW update (new - old): the card's optimizer and the CPU's, each
      applied to the card's gradients, max|a - b| <= 1e-4 max|b| per leaf.
      The two end-to-end steps' updates are not compared entry by entry:
      the first step's mhat / sqrt(vhat) is g / (|g| + eps), which sends a
      gradient entry within summation noise of 0 to either sign of a full
      step."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.models.layers import (tree_from_leaves, tree_leaves,
                                           tree_map)
    from repro_torch.train import optimizer as opt_mod
    cfg = get_config(TRAIN_ARCH).with_overrides(num_layers=2, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = {"cuda": registry.init_params(cfg, gen)}
    params["cpu"] = tree_map(lambda t: t.cpu(), params["cuda"])
    names = [p for p, _ in tree_leaves(params["cpu"])]
    rs = np.random.RandomState(4)
    toks = rs.randint(0, cfg.vocab_size, size=(2, 129)).astype(np.int32)
    loss, grads = {}, {}
    for dev in ("cuda", "cpu"):
        batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(dev),
                 "labels": torch.from_numpy(toks[:, 1:]).to(dev)}
        leaves = [t.requires_grad_() for _, t in tree_leaves(params[dev])]
        out, _ = registry.loss_fn(params[dev], cfg, batch)
        grads[dev] = torch.autograd.grad(out, leaves)
        loss[dev] = float(out.detach())
    ocfg = opt_mod.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=10)
    update, gnorm = {}, {}
    for dev in ("cuda", "cpu"):
        old = [t.detach().clone() for _, t in tree_leaves(params[dev])]
        gtree = tree_from_leaves((path, g.to(dev)) for path, g
                                 in zip(names, grads["cuda"]))
        new, _, m = opt_mod.apply(ocfg, opt_mod.init(params[dev]),
                                  params[dev], gtree)      # in place
        update[dev] = [(t.detach() - o).cpu()
                       for (_, t), o in zip(tree_leaves(new), old)]
        gnorm[dev] = float(m["grad_norm"])
    la, lb = loss["cuda"], loss["cpu"]
    if not math.isfinite(la) or not abs(la - lb) <= 1e-5 * abs(lb):
        raise AssertionError(f"card loss {la} vs CPU loss {lb}")
    g_worst = leaf_errors("gradient", names,
                          [g.cpu() for g in grads["cuda"]], grads["cpu"], 1e-4)
    u_worst = leaf_errors("AdamW update", names, update["cuda"],
                          update["cpu"], 1e-4)
    log(f"check: full-width two-layer f32 train step, card kernels vs CPU "
        f"plain versions (B=2, S=128): loss {la:.7f} vs {lb:.7f} (rel err "
        f"{abs(la - lb) / abs(lb):.3e}, limit 1e-5); worst leaf of "
        f"{len(names)}, max abs err over the leaf's largest entry: "
        f"gradients {g_worst:.3e} (limit 1e-4), AdamW update from the same "
        f"gradients {u_worst:.3e} (limit 1e-4; grad norm {gnorm['cuda']:.6f} "
        f"vs {gnorm['cpu']:.6f})")


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
    rows = [kernel_rmsnorm(gen), kernel_flash_decode(gen),
            kernel_rmsnorm_bwd(gen), kernel_flash_attention(gen)]
    log(f"kernels phase done at {time.perf_counter() - t_start:.1f} s")

    serve_launches, srv = serve(workers=0)
    time_breakdown(srv)
    del srv
    serve(workers=2)
    log(f"serve phase done at {time.perf_counter() - t_start:.1f} s")
    torch.cuda.empty_cache()
    train_launches, report = train(workers=0)
    train_time_breakdown(report)
    del report
    torch.cuda.empty_cache()
    train(workers=2)
    log(f"train phase done at {time.perf_counter() - t_start:.1f} s")
    # each kernel's launches on the main paths' caller-driven runs, per
    # path and summed (rmsnorm_fwd runs on both)
    for row in rows:
        row["launches_serve"] = serve_launches[row["name"]]
        row["launches_train"] = train_launches[row["name"]]
        row["launches"] = row["launches_serve"] + row["launches_train"]
    log(f"launches: serve run {serve_launches}, train run {train_launches}")
    reference_check()
    train_reference_check()
    log(f"total {time.perf_counter() - t_start:.1f} s")

    keys = ["name", "route", "source", "replaces", "launches",
            "launches_serve", "launches_train", "shape", "max_abs_err", "ms",
            "plain_ms", "ms_source", "bound_ms", "bound_by", "library_ms",
            "train_shape"]
    print(smi)
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
