"""Tour of every paper listing (1.1–1.7) mapped onto ``repro_torch.core``,
then the port's collectives, serving, recovery, pipeline, FSDP and
progress-safety tooling (the JAX package's
``examples/progress_engine_tour.py``; its ``shard_map`` and serve
collective sections run here on the port's collectives and engine, over
a mesh whose ranks share one device).

    PYTHONPATH=src python -m repro_torch.examples.progress_engine_tour \
        [--device cpu]
"""
from __future__ import annotations

import argparse
import threading
import time

import numpy as np
import torch

from repro_torch.core import (DEFERRED, DONE, INLINE, NOPROGRESS,
                              CompletionWatcher, ContinuationQueue,
                              EventQueue, GeneralizedRequest, ProgressEngine,
                              ProgressExecutor, Request, TaskQueue, stats)


def listing_1_1_collated_subsystems(eng):
    """MPICH's internal progress function as engine subsystems."""
    calls = []
    eng.register_subsystem("datatype", lambda: (calls.append("dt"), False)[1],
                           cheap=True, priority=0)
    eng.register_subsystem("collective", lambda: (calls.append("coll"), False)[1],
                           cheap=True, priority=1)
    eng.register_subsystem("shmem", lambda: (calls.append("shm"), False)[1],
                           cheap=True, priority=2)
    eng.register_subsystem("netmod", lambda: (calls.append("net"), True)[1],
                           cheap=False, priority=3)
    eng.progress()
    print(f"1.1 collated order: {calls} (netmod last, skipped when earlier "
          f"subsystems made progress)")


def listing_1_2_1_3_dummy_tasks(eng):
    lat = []
    counter = {"n": 10}
    for _ in range(10):
        deadline = time.perf_counter() + 0.01

        def poll(thing, deadline=deadline):
            now = time.perf_counter()
            if now >= deadline:
                lat.append((now - deadline) * 1e6)
                counter["n"] -= 1
                return DONE
            return NOPROGRESS

        eng.async_start(poll)
    while counter["n"] > 0:                 # the Listing 1.3 wait loop
        eng.progress()
    print(f"1.2/1.3 ten dummy tasks done; mean progress latency "
          f"{sum(lat) / len(lat):.1f} µs")


def listing_1_4_task_class(eng):
    q = TaskQueue(eng)
    t0 = time.perf_counter()
    reqs = [q.submit(lambda i=i: time.perf_counter() >= t0 + 0.002 * (i + 1))
            for i in range(5)]
    while not all(r.is_complete for r in reqs):
        eng.progress()
    print("1.4 task class: 5 in-order tasks via ONE poll hook (O(1)/progress)")


def listing_1_5_streams():
    eng = ProgressEngine()
    done = []

    def worker(tid):
        stream = eng.stream(f"t{tid}")
        counter = {"n": 5}
        deadline = time.perf_counter() + 0.005
        for _ in range(5):
            eng.async_start(
                lambda t: (DONE if time.perf_counter() >= deadline
                           and not counter.__setitem__("n", counter["n"] - 1)
                           else NOPROGRESS), None, stream)
        while counter["n"] > 0:
            eng.progress(stream)            # no cross-thread lock contention
        done.append(tid)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    print(f"1.5 streams: 4 threads × own stream, all drained: {sorted(done)}")


def listing_1_6_completion_events(eng):
    w = CompletionWatcher(eng)
    evq = EventQueue()
    reqs = [Request(tag=f"r{i}") for i in range(3)]
    for r in reqs:
        w.watch(r, lambda rr: evq.emit(f"{rr.tag} complete"))
    for r in reqs:
        r.complete()
    eng.progress()
    print(f"1.6 events: {evq.drain()} (handlers deferred out of poll path)")


def listing_1_7_generalized_request(eng):
    greq = GeneralizedRequest(query_fn=lambda st: "status",
                              free_fn=lambda st: None)
    deadline = time.perf_counter() + 0.01
    eng.async_start(lambda t: (greq.complete(), DONE)[1]
                    if time.perf_counter() >= deadline else NOPROGRESS)
    value = eng.wait(greq, timeout=5)       # MPI_Wait on the grequest
    greq.free()
    print(f"1.7 generalized request completed via async progress: {value!r}")


def progress_workers():
    """Progress workers (§4.4): instead of every thread hand-rolling its
    own ``while: engine.progress(stream)`` loop (Listing 1.5), hand the
    streams to a ProgressExecutor — N background threads own disjoint
    stream sets (work-stealing rebalances them) and the application just
    *waits* on requests: ``wait``/``wait_any``/``wait_some`` yield to the
    workers instead of polling."""
    eng = ProgressEngine()
    ex = ProgressExecutor(eng, num_workers=2)
    s1, s2 = ex.stream("even"), ex.stream("odd")
    reqs = [Request(tag=f"r{i}") for i in range(6)]
    for i, r in enumerate(reqs):
        deadline = time.perf_counter() + 0.002 * (i + 1)

        def poll(thing, r=r, deadline=deadline):
            if time.perf_counter() >= deadline:
                r.complete(r.tag)
                return DONE
            return NOPROGRESS

        eng.async_start(poll, None, s1 if i % 2 == 0 else s2)
    with ex:                                    # start; drain+join on exit
        first_idx, first = eng.wait_any(reqs, timeout=5)
        some = eng.wait_some(reqs, min_count=4, timeout=5)
        eng.wait_all(reqs, timeout=5)
        snap = stats.collect(eng, ex)
    if snap.total_contention:                   # disjoint streams: Fig 11
        raise AssertionError(f"contention {snap.total_contention}")
    print(f"workers: first={first.tag}, completion order {some}..., "
          f"contention={snap.total_contention} "
          f"(2 workers, 2 streams, zero shared-lock collisions)")


def continuations_post_attach_drain():
    """Continuations (§4.6 / the MPI Continuations papers): post work,
    attach a callback, drain — completion *pushes* into the application
    instead of being pulled by wait loops.

    Listing-style walkthrough:

        1. post        — async_start a task completing a Request
        2. attach      — queue.attach(request, callback[, on_error])
        3. drain       — DEFERRED policy: the owner thread executes ready
                         callbacks outside the progress path (bounded);
                         INLINE runs them on the progress thread instead
        4. chain       — then/when_all/node turn DAG dependencies into
                         completion-driven scheduling (no polling)
    """
    eng = ProgressEngine()

    # -- deferred: detection on progress, execution on the owner ----------
    q = ContinuationQueue(eng, policy=DEFERRED, name="tour")
    got = []
    req = Request(tag="post")
    deadline = time.perf_counter() + 0.002
    eng.async_start(lambda t: (req.complete("payload"), DONE)[1]
                    if time.perf_counter() >= deadline else NOPROGRESS)
    q.attach(req, lambda r: got.append(r.value()),
             on_error=lambda r: got.append(r.exception))
    while q.ready == 0:                 # progress detects the completion…
        eng.progress()
    n = q.drain(max_items=8)            # …the owner drains it (bounded)
    print(f"continuations: deferred drain ran {n} callback(s): {got}")

    # -- chaining: a diamond DAG with no polled dependencies --------------
    qi = ContinuationQueue(eng, policy=INLINE, name="tour-chain")
    a = qi.node(lambda: 2)
    b = qi.then(a, lambda v: v * 10)
    c = qi.then(a, lambda v: v + 1)
    d = qi.node(lambda bv, cv: bv + cv, deps=[b, c])
    for _ in range(6):
        eng.progress()
    print(f"continuations: diamond DAG via node/then -> {d.value()} "
          f"(fired {qi.executed} continuations, 0 polls by consumers)")


def tiny_qwen():
    from repro_torch.configs import get_config
    return get_config("qwen2-0.5b").with_overrides(
        num_layers=2, d_model=32, d_ff=64, vocab_size=64, num_heads=4,
        num_kv_heads=2, head_dim=16, remat_policy="none")


def nonblocking_collectives(device, n: int = 4):
    """User-space collectives on the engine (paper §4.7): the schedules
    of ``collectives/schedules.py`` as chunk-pipelined,
    continuation-chained round programs returning Request handles.

        1. issue    — coll.iallreduce(x, mesh, axis, algorithm=, chunks=)
                      returns a CollectiveRequest immediately (the rounds
                      have only been *scheduled* on the collective stream)
        2. overlap  — the application computes; any engine.progress /
                      executor worker drives round r, whose completion
                      continuation dispatches round r+1 per chunk
        3. wait     — req.wait() drives the stream to completion; the
                      result equals the native sum over the ranks

    The n ranks share ``device`` (``launch/mesh.py``)."""
    from repro_torch.collectives import nonblocking as NB
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((n,), ("x",), device)
    eng = ProgressEngine()
    coll = NB.UserCollectives(eng)
    x = torch.arange(n * 8, dtype=torch.float32, device=device).reshape(n, 8)
    native = x.sum(0, keepdim=True).expand(n, 8)
    req = coll.iallreduce(x, mesh, "x", algorithm="ring", chunks=2)
    issued_complete = req.is_complete       # False: rounds still queued
    out = req.wait(timeout=60)
    torch.testing.assert_close(out, native, atol=1e-5, rtol=0)
    print(f"nonblocking collectives: iallreduce({req.algorithm}, "
          f"chunks={req.num_chunks}) complete_at_issue={issued_complete}, "
          f"{req.rounds_done} rounds driven by the engine, matches the sum")

    # -- persistent collectives (MPI *_init / MPI_Start semantics) -----
    # allreduce_init fixes the plan (validation, chunk layout, join) and
    # builds every fused round program ONCE; start(payload) re-binds a
    # new payload to the same schedule.  The handle allows one
    # outstanding start (MPI semantics).
    handle = coll.allreduce_init(x, mesh, "x", algorithm="ring", chunks=2)
    for mul in (2.0, 3.0):
        out = handle.start(x * mul).wait(timeout=60)
        torch.testing.assert_close(out, native * mul, atol=1e-4, rtol=0)
    print(f"persistent collectives: {handle.starts} starts re-bound one "
          f"schedule (round_batch={handle.round_batch}, "
          f"{handle.dispatches_per_start} dispatch(es)/start), "
          f"each matching the sum")
    handle.close()
    coll.close()


def serve_collectives(device, n: int = 2):
    """Serve-side persistent collectives: with a model mesh axis the
    ServeEngine computes each rank's vocabulary slice of the logits and
    gathers them either natively (one concatenation) or by re-binding ONE
    persistent user-space all-gather per step, whose rounds run on the
    serve-collective stream; the gather's completion feeds the same
    detokenize stage.  Greedy token streams are identical across the
    unsharded, native and user paths."""
    from repro_torch.collectives.nonblocking import CollectiveSpec
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry
    from repro_torch.serve.engine import GenRequest, ServeEngine

    cfg = tiny_qwen()
    params = registry.init_params(
        cfg, torch.Generator(device=device).manual_seed(0))
    mesh = make_mesh((n,), ("model",), device)

    def serve(backend):
        eng = ProgressEngine()
        srv = ServeEngine(cfg, params, eng, batch_slots=2, max_seq=32,
                          mesh=mesh,
                          collective_spec=CollectiveSpec(backend=backend))
        done = srv.submit(GenRequest("tour", np.array([3, 4], np.int32),
                                     max_new_tokens=4))
        srv.run_until_idle(timeout=240)
        toks = done.value()
        starts = srv._ag_handle.starts if srv._ag_handle is not None else 0
        lat = srv.latency_snapshot()
        srv.close(timeout=60)
        return toks, starts, lat

    nat, _, _ = serve("native")
    usr, starts, lat = serve("user")
    if nat != usr:
        raise AssertionError(f"user stream {usr} != native {nat}")
    print(f"serve collectives: {len(usr)} tokens over a {n}-way model "
          f"axis, user == native stream, {starts} persistent all-gather "
          f"start(s); {lat.format()}")


def continuous_batching(device):
    """Continuous batching on a paged KV cache: admission when a lane AND
    enough blocks are free, prefill in fused chunks interleaved with
    decode, lazy block extension, and preemption of the youngest resident
    under block pressure; greedy streams are invariant to the pool
    shape."""
    from repro_torch.models import registry
    from repro_torch.serve.engine import GenRequest, ServeEngine

    cfg = tiny_qwen()
    params = registry.init_params(
        cfg, torch.Generator(device=device).manual_seed(0))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 63, size=rng.randint(2, 10)).astype(np.int32)
               for _ in range(12)]

    def serve(**kw):
        eng = ProgressEngine()
        srv = ServeEngine(cfg, params, eng, max_seq=32, device=device, **kw)
        reqs = [GenRequest(f"cb{i}", p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            srv.submit(r)
        srv.run_until_idle(timeout=240)
        lat, sched = srv.latency_snapshot(), srv.scheduler_snapshot()
        srv.close(timeout=60)
        return [list(r.out_tokens) for r in reqs], lat, sched

    lane3_toks, _, _ = serve(batch_slots=3)   # roomy pool, 3-lane cap
    # same cache bytes as 3 lanes x 32 positions: 24 blocks of 4 — but
    # 8 lanes, and a pool tight enough to exercise preemption
    wide_toks, lat, sched = serve(batch_slots=8, kv_block_size=4,
                                  kv_blocks=25, prefill_chunk=4)
    if wide_toks != lane3_toks:      # scheduling is invisible in output
        raise AssertionError("the wide pool's streams differ")
    print(f"continuous batching: 12 requests, wide pool == 3-lane cap "
          f"bit-exact; {sched.format()}; "
          f"queued ms p50 {lat.queued_ms_p50:.1f}")


def fault_tolerance(device):
    """Membership-aware fault tolerance, end to end: one
    ``MembershipEpoch`` ties the monitors to every persistent collective
    handle and to the engines consuming them.  Invalidating it mid-decode
    fails the in-flight step once, the engine checkpoints each decoding
    lane's KV prefix, remeshes on the survivors and re-admits; greedy
    decode is per-lane deterministic, so the recovered streams equal an
    undisturbed run's."""
    from repro_torch.collectives.nonblocking import MembershipEpoch
    from repro_torch.models import registry
    from repro_torch.serve.engine import GenRequest, ServeEngine

    cfg = tiny_qwen()
    params = registry.init_params(
        cfg, torch.Generator(device=device).manual_seed(0))
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, 63, size=rng.randint(2, 10)).astype(np.int32)
               for _ in range(8)]

    def serve(epoch=None, kill=False):
        eng = ProgressEngine()
        srv = ServeEngine(cfg, params, eng, batch_slots=3, max_seq=32,
                          kv_block_size=4, epoch=epoch, device=device)
        reqs = [GenRequest(f"ft{i}", p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            srv.submit(r)
        if kill:
            t0 = time.monotonic()
            while sum(len(r.out_tokens) for r in reqs) < 4 \
                    and time.monotonic() - t0 < 120:
                eng.progress()
            epoch.invalidate(survivors=1, reason="tour: simulated loss")
        srv.run_until_idle(timeout=240)
        lat, rm = srv.latency_snapshot(), srv.remeshes
        srv.close(timeout=60)
        return [list(r.out_tokens) for r in reqs], lat, rm

    ref, _, _ = serve()
    epoch = MembershipEpoch()
    got, lat, remeshes = serve(epoch=epoch, kill=True)
    if not (got == ref and lat.failed == 0 and remeshes == 1):
        raise AssertionError(f"recovery: remeshes={remeshes}, "
                             f"failed={lat.failed}, equal={got == ref}")
    print(f"fault tolerance: killed a device mid-decode; {remeshes} "
          f"remesh, {lat.completed} requests completed, streams "
          f"bit-identical to the undisturbed run")


def fsdp_sharded_training(device, n: int = 2):
    """ZeRO-style FSDP training on user-space collectives: ``FsdpLayout``
    flattens the parameters into per-dtype buckets of which rank r owns
    row r; each step all-gathers the full buckets and reduce-scatters
    the gradient buckets; the next step's gathers are chained off the
    updated shards' compute futures (``igather(after=...)``), and the
    user backend runs the same grad/apply programs as the native one, so
    the losses are bit-identical."""
    from repro_torch.collectives.nonblocking import CollectiveSpec
    from repro_torch.collectives.overlap import FsdpLayout, FsdpReducer
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import build_fsdp_programs
    from repro_torch.models import registry
    from repro_torch.train import optimizer as opt_mod

    mesh = make_mesh((n, 1), ("data", "model"), device)
    cfg = get_config("smollm-360m").with_overrides(
        num_layers=2, d_model=64, d_ff=128, vocab_size=256, num_heads=4,
        num_kv_heads=2, head_dim=16, remat_policy="none")
    STEPS = 4
    ocfg = opt_mod.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=STEPS)
    it = iter(SyntheticLM(cfg.vocab_size, 16, max(n, 2), seed=9))
    batches = [{k: torch.from_numpy(v.copy()).to(device)
                for k, v in next(it).items()} for _ in range(STEPS)]
    params = registry.init_params(
        cfg, torch.Generator(device=device).manual_seed(0))
    layout = FsdpLayout(params, n, 1 << 22)
    grad_fn, apply_fn, ag_fn, rs_fn = build_fsdp_programs(
        cfg, ocfg, mesh, layout, axis="data")

    def fresh_state():
        shards = layout.shard_params(params, mesh, "data")
        return shards, opt_mod.init_shards(shards)

    # native reference: the same programs, the bytes moved in the step
    sh, st = fresh_state()
    native_losses = []
    for b in batches:
        smets, flat_g = grad_fn(ag_fn(sh), b)
        sh, st, mets = apply_fn(sh, st, rs_fn(flat_g), smets)
        native_losses.append(float(mets["loss"]))

    # user backend: persistent engine handles + chained prefetch
    eng = ProgressEngine()
    red = FsdpReducer(mesh, "data", engine=eng,
                      spec=CollectiveSpec(backend="user", chunks=2),
                      bucket_bytes=1 << 22)
    sh, st = fresh_state()
    user_losses = []
    gather = red.igather(sh)                 # step 0: self-chained train
    for b in batches:
        flats = gather.wait(timeout=300)     # params for THIS step
        red._note_gather(gather)
        smets, flat_g = grad_fn(flats, b)
        gshards = red.ireduce_scatter(flat_g).wait(timeout=300)
        sh, st, mets = apply_fn(sh, st, gshards, smets)
        gather = red.igather(sh, after=[red.future(s) for s in sh])
        user_losses.append(float(mets["loss"]))
    gather.wait(timeout=300)                 # drain the last prefetch
    overlap = red.prefetch_overlap
    red.close()
    if user_losses != native_losses:
        raise AssertionError(f"{user_losses} != {native_losses}")
    print(f"fsdp: {layout.num_buckets} bucket(s) sharded over data={n}, "
          f"{STEPS} steps bit-identical to the native path (loss "
          f"{user_losses[-1]:.6f}); prefetch overlap {overlap:.3f} across "
          f"{red.gathers} chained gathers")


def pipeline_1f1b(device, S: int = 4):
    """Event-driven 1F1B pipeline parallelism: user-space nonblocking p2p
    hops between stages, the 1F1B grid as a continuation DAG (a cell runs
    when its inputs are ready: no polling, no phase barriers), exactly
    2(M+S-1) ticks and the (S-1)/(M+S-1) bubble, bit-identical to
    sequential accumulation and to ``gpipe``."""
    from repro_torch.collectives.p2p import P2P
    from repro_torch.distributed import pipeline as pl
    from repro_torch.launch.mesh import make_mesh

    M = 4
    mesh = make_mesh((S,), ("stage",), device)
    eng = ProgressEngine()

    # the transport on its own: a single forward ring hop
    p2p = P2P(eng)
    x = torch.arange(S * 4, dtype=torch.float32, device=device).reshape(S, 4)
    p2p.isend(x, mesh, "stage")
    got = p2p.irecv(x, mesh, "stage").wait(timeout=60)
    if not torch.equal(got, torch.roll(x, 1, dims=0)):
        raise AssertionError("the ring hop moved the wrong rows")
    p2p.close()

    d, h, mb = 8, 16, 2

    def stage_fn(p, xx):
        return xx + torch.tanh(xx @ p["w1"]) @ p["w2"]

    def loss_fn(y, t):
        return torch.mean((y - t) ** 2)

    gen = torch.Generator(device=device).manual_seed(0)
    params = {"w1": torch.randn(S, d, h, generator=gen, device=device) * 0.1,
              "w2": torch.randn(S, h, d, generator=gen, device=device) * 0.1}
    xs = torch.randn(M, mb, d, generator=gen, device=device)
    ts = torch.randn(M, mb, d, generator=gen, device=device)

    sched = pl.PipelineSchedule(stage_fn, mesh, "stage", S, loss_fn=loss_fn,
                                engine=eng, name="tour-pipe")
    ys = sched.apply(params, xs, timeout=300)
    gys = pl.gpipe(stage_fn, mesh, "stage", S)(params, xs)
    if not torch.equal(ys, gys):
        raise AssertionError("the DAG's forward is not gpipe's")
    loss, grads = sched.step(params, xs, ts, timeout=300)
    tm = sched.last_step_timing
    st = sched.stats()
    measured = 1.0 - sum(tm["cells"]) / (S * tm["grid_ticks"])
    analytic = pl.bubble_fraction(S, M, "1f1b")
    if abs(measured - analytic) >= 1e-12:
        raise AssertionError(f"bubble {measured} != {analytic}")
    print(f"1F1B pipeline: S={S} x M={M} -> {tm['grid_ticks']} ticks "
          f"(=2(M+S-1)), bubble measured={measured:.3f} == "
          f"analytic={analytic:.3f}, peak stash "
          f"{pl.peak_activation_microbatches(S, M, '1f1b')} microbatches; "
          f"loss={float(loss):.4f}, forward bit-identical to gpipe; "
          f"hops={st['hop_starts']}, blocking_waits={st['blocking_waits']} "
          f"(only the callers' — the DAG itself never polls)")
    sched.close()


def progress_safety_rules():
    """Progress-safety rules: the port's static analyzer
    (``repro_torch.analysis.progress_lint``) and the ``REPRO_DEBUG=1``
    runtime checkers (``repro_torch.core.debug``) enforce four rule
    families.  One deliberate violation per rule, each caught:

        PL001  blocking call reachable from a continuation body (a CUDA
               ``synchronize()`` included)
        PL002  persistent-handle lifecycle (the MPI *_init/start machine)
        PL003  lock-order inversion across function bodies
        PL004  donated buffer reused after the donating jit call (the
               JAX form: the port donates nothing, the rule stays so
               that both lints agree)
    """
    import textwrap

    from repro_torch.analysis import progress_lint
    from repro_torch.core.debug import (HandleTracker, LifecycleError,
                                        LockOrderError, LockOrderGraph,
                                        OrderedLock)

    def demo(rule, src):
        fs = progress_lint.lint_source(textwrap.dedent(src))
        if [f.rule for f in fs] != [rule]:
            raise AssertionError(fs)
        print(f"  {rule} caught: {fs[0].message}")

    demo("PL001", """
        import torch
        def setup(q, req):
            q.attach(req, lambda r: torch.cuda.synchronize())
    """)
    demo("PL002", """
        def f(coll, mesh, x):
            h = coll.allreduce_init(x, mesh, "i")
            h.start(x)
            h.start(x)
    """)
    demo("PL003", """
        class E:
            def a(self, q):
                with self._lock:
                    with q._qlock: pass
            def b(self, q):
                with q._qlock:
                    with self._lock: pass
    """)
    demo("PL004", """
        import jax
        def step(carry):
            f = jax.jit(lambda c: c + 1, donate_argnums=(0,))
            out = f(carry)
            return carry + out
    """)

    # runtime halves: the same rules where only execution shows the order
    g = LockOrderGraph()
    a, b = OrderedLock("A", g), OrderedLock("B", g)
    with a:
        with b:
            pass
    try:
        with b:
            a.acquire()
    except LockOrderError as e:
        print(f"  runtime lock-order: {str(e).split('.')[0]}")
    t = HandleTracker()
    h = type("H", (), {})()
    t.track(h, "DemoHandle")
    t.event(h, "close")
    try:
        t.event(h, "start")
    except LifecycleError as e:
        print(f"  runtime lifecycle: {e}")


def main(argv=None) -> None:
    from repro_torch import resolve_device
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    eng = ProgressEngine()
    listing_1_1_collated_subsystems(eng)
    listing_1_2_1_3_dummy_tasks(eng)
    listing_1_4_task_class(eng)
    listing_1_5_streams()
    listing_1_6_completion_events(eng)
    listing_1_7_generalized_request(eng)
    progress_workers()
    continuations_post_attach_drain()
    nonblocking_collectives(device)
    serve_collectives(device)
    continuous_batching(device)
    fault_tolerance(device)
    pipeline_1f1b(device)
    fsdp_sharded_training(device)
    progress_safety_rules()
    print("tour OK")


if __name__ == "__main__":
    main()
