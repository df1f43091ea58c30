"""Pipeline parallelism of the port: the 1F1B grid and its analytic
bubble, ``gpipe`` and the event-driven ``PipelineSchedule`` against the
sequential per-stage computation (bit for bit in the port) and against
the JAX package's ``gpipe``/``PipelineSchedule`` on the same numpy
inputs (one JAX child with 4 host devices; ``JAX_TOL``, f32), the DAG's
event-driven stats, and the launcher's ``--pipeline`` paths on the CPU.
With a device per stage (meshes of ``["cpu"] * S``) the schedule, gpipe
and the launcher's ``--rank-devices`` runs equal the stacked form bit
for bit, the launcher's checkpoint files too."""
import glob
import os
import contextlib
import io
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.distributed import pipeline as pl
from tests._multidevice import run_with_devices

M, D, H, MB = 8, 8, 16, 4
SGD_STEPS, LR = 3, 0.05
# the launcher's --pipeline rehearsal: (kind, data, stages) cases and its
# microbatches, microbatch rows and steps
LAUNCH_CASES = (("1f1b", 1, 4), ("1f1b", 2, 2), ("gpipe", 1, 4))
LAUNCH_M, LAUNCH_MB, LAUNCH_STEPS = 4, 4, 4
# the two libraries' f32 products and tanh differ in the last bits
JAX_TOL = dict(rtol=1e-5, atol=1e-6)

_JAX_CHILD = """
import sys, warnings
sys.path.insert(0, {root!r})
warnings.simplefilter("ignore")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.core import ProgressEngine, ProgressExecutor
from repro.distributed import pipeline as pl

M, d, h, mb = {M}, {D}, {H}, {MB}


def stage_fn(p, x):
    return x + jnp.tanh(x @ p["w1"]) @ p["w2"]


def loss_fn(y, t):
    return jnp.mean((y - t) ** 2)


engine = ProgressEngine()
ex = ProgressExecutor(engine, num_workers=2).start()
engine.attach_executor(ex)
res = {{}}
for S in (2, 4):
    rs = np.random.RandomState(S)
    params = {{"w1": (rs.randn(S, d, h) * 0.3).astype(np.float32),
              "w2": (rs.randn(S, h, d) * 0.3).astype(np.float32)}}
    xs = rs.randn(M, mb, d).astype(np.float32)
    ts = rs.randn(M, mb, d).astype(np.float32)
    for k, v in params.items():
        res[f"{{S}}/init/{{k}}"] = v
    res[f"{{S}}/xs"], res[f"{{S}}/ts"] = xs, ts
    mesh = Mesh(np.array(jax.devices()[:S]), ("stage",))
    sched = pl.PipelineSchedule(stage_fn, mesh, "stage", S, loss_fn=loss_fn,
                                engine=engine, executor=ex, name=f"p{{S}}")
    jp = jax.tree.map(jnp.asarray, params)
    res[f"{{S}}/apply"] = sched.apply(jp, jnp.asarray(xs), timeout=300)
    gp = pl.gpipe(stage_fn, mesh, "stage", S)
    res[f"{{S}}/gpipe"] = gp(jax.device_put(jp, NamedSharding(mesh,
                                                            P("stage"))),
                             jnp.asarray(xs))
    for step in range({steps}):
        loss, grads = sched.step(jp, jnp.asarray(xs), jnp.asarray(ts),
                                 timeout=300)
        res[f"{{S}}/loss{{step}}"] = loss
        for k in ("w1", "w2"):
            res[f"{{S}}/grad{{step}}/{{k}}"] = grads[k]
        jp = jax.tree.map(lambda p, g: p - {lr} * g, jp, grads)
    sched.close()

# the launcher's --pipeline rehearsal (launch/train.py's _run_pipeline)
# from the JAX pieces, on seeded numpy weights that the port's launcher
# is handed: each data row's PipelineSchedule on its own stage mesh (for
# gpipe the jitted tick loop at 1xS), the mean over the data axis, AdamW
from repro.train import optimizer as opt_mod
ocfg = opt_mod.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=10)
for kind, nd, S in {launch_cases!r}:
    tag = f"launch/{{kind}}/{{nd}}x{{S}}"
    rs = np.random.RandomState(10 * nd + S)
    params = {{"w1": (rs.randn(S, 16, 32) * 0.1).astype(np.float32),
              "w2": (rs.randn(S, 32, 16) * 0.1).astype(np.float32)}}
    for k, v in params.items():
        res[f"{{tag}}/init/{{k}}"] = v
    jp = jax.tree.map(jnp.asarray, params)
    opt = opt_mod.init(jp)
    rng = np.random.default_rng(7)
    teacher = rng.standard_normal((16, 16)).astype(np.float32) * 0.3
    lmesh = Mesh(np.array(jax.devices()[:nd * S]).reshape(nd, S),
                 ("data", "stage"))
    rows = []
    if kind == "gpipe":
        gmesh = Mesh(lmesh.devices[0], ("stage",))
        gp = pl.gpipe(stage_fn, gmesh, "stage", S)
        jp = jax.device_put(jp, NamedSharding(gmesh, P("stage")))

        def gp_loss(p, x, t, gp=gp):
            ys = gp(p, x)
            return jnp.mean(jnp.stack([loss_fn(ys[m], t[m])
                                       for m in range(x.shape[0])]))

        gstep = jax.jit(jax.value_and_grad(gp_loss))
    else:
        rows = [pl.PipelineSchedule(
            stage_fn, Mesh(lmesh.devices[r], ("stage",)), "stage", S,
            loss_fn=loss_fn, engine=engine, executor=ex,
            name=f"{{tag}}/{{r}}") for r in range(nd)]
    for step in range({launch_steps}):
        xs = rng.standard_normal((nd, {launch_m}, {launch_mb}, 16)) \
            .astype(np.float32)
        ts = xs @ teacher
        if kind == "gpipe":
            loss, grads = gstep(jp, jnp.asarray(xs[0]), jnp.asarray(ts[0]))
        else:
            outs = [rows[r].step(jp, jnp.asarray(xs[r]), jnp.asarray(ts[r]),
                                 timeout=300) for r in range(nd)]
            loss = np.mean([np.asarray(o[0]) for o in outs])
            grads = {{k: jnp.asarray(np.mean([np.asarray(o[1][k])
                                             for o in outs], axis=0))
                     for k in jp}}
        jp, opt, _ = opt_mod.apply(ocfg, opt, jp, grads)
        res[f"{{tag}}/loss{{step}}"] = loss
    for k in ("w1", "w2"):
        res[f"{{tag}}/final/{{k}}"] = jp[k]
    for r in rows:
        r.close()
ex.shutdown(drain=True, timeout=120)
np.savez({out!r}, **{{k: np.asarray(v) for k, v in res.items()}})
print("SAVED", len(res))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipe") / "ref.npz"
    root = str(Path(__file__).resolve().parents[1])
    log = run_with_devices(_JAX_CHILD.format(
        root=root, out=str(out), M=M, D=D, H=H, MB=MB, steps=SGD_STEPS,
        lr=LR, launch_cases=LAUNCH_CASES, launch_m=LAUNCH_M,
        launch_mb=LAUNCH_MB, launch_steps=LAUNCH_STEPS), n_devices=4,
        timeout=600)
    assert "SAVED" in log
    return dict(np.load(out))


def stage_fn(p, x):
    return x + torch.tanh(x @ p["w1"]) @ p["w2"]


def loss_fn(y, t):
    return torch.mean((y - t) ** 2)


@pytest.fixture
def executor():
    from repro_torch.core import ProgressEngine, ProgressExecutor
    eng = ProgressEngine()
    ex = ProgressExecutor(eng, num_workers=2).start()
    eng.attach_executor(ex)
    yield eng, ex
    ex.shutdown(drain=True, timeout=120)


def schedule(S, eng, ex, name="p"):
    from repro_torch.launch.mesh import make_mesh
    return pl.PipelineSchedule(stage_fn, make_mesh((S,), ("stage",), "cpu"),
                               "stage", S, loss_fn=loss_fn, engine=eng,
                               executor=ex, name=name)


def inputs(ref, S):
    params = {k: torch.from_numpy(ref[f"{S}/init/{k}"]) for k in ("w1", "w2")}
    return params, torch.from_numpy(ref[f"{S}/xs"]), \
        torch.from_numpy(ref[f"{S}/ts"])


def sequential_step(params, xs, ts, S):
    """The unpipelined reference: one microbatch at a time through every
    stage, each backward cell the schedule's own (the stage again on the
    stashed activation, ``torch.autograd.grad``), the per-stage
    accumulation in the same microbatch order and the same 1/M seed."""
    sched = pl.PipelineSchedule.__new__(pl.PipelineSchedule)
    sched.stage_fn, sched.loss_fn = stage_fn, loss_fn
    stage = [{k: v[s] for k, v in params.items()} for s in range(S)]
    keys = sorted(params)
    acc = [[torch.zeros_like(stage[s][k]) for k in keys] for s in range(S)]
    scale = torch.tensor(1.0 / M, dtype=torch.float32)
    losses = []
    for m in range(M):
        x, stash = xs[m], []
        for s in range(S - 1):
            stash.append(x)
            x = sched._fwd(stage[s], x)
        lm, dx, acc[S - 1] = sched._last_bwd(stage[S - 1], x, ts[m], scale,
                                             acc[S - 1])
        losses.append(lm)
        for s in range(S - 2, -1, -1):
            dx, acc[s] = sched._bwd(stage[s], stash[s], dx, acc[s])
    total = losses[0]
    for lm in losses[1:]:
        total = total + lm
    grads = {k: torch.stack([acc[s][i] for s in range(S)])
             for i, k in enumerate(keys)}
    return total * scale, grads


def test_bubble_fraction():
    assert pl.bubble_fraction(4, 4) == 3 / 7
    assert pl.bubble_fraction(1, 8) == 0.0
    assert abs(pl.bubble_fraction(4, 28) - 3 / 31) < 1e-12
    assert abs(pl.bubble_fraction(4, 8, "1f1b") - 0.2727) < 1e-4
    assert pl.bubble_fraction(4, 4, "1f1b") == pl.bubble_fraction(4, 4)
    assert pl.peak_activation_microbatches(4, 16, "gpipe") == 16
    assert pl.peak_activation_microbatches(4, 16, "1f1b") == 4
    assert pl.peak_activation_microbatches(8, 4, "1f1b") == 4
    with pytest.raises(ValueError):
        pl.bubble_fraction(4, 4, "interleaved")
    with pytest.raises(ValueError):
        pl.peak_activation_microbatches(4, 4, "zb-h1")


@pytest.mark.parametrize("S,Mb", [(1, 4), (2, 4), (2, 8), (3, 5), (4, 4),
                                  (4, 8), (4, 16)])
def test_grid_realizes_analytic_bubble_as_jax(S, Mb):
    """2(M+S-1) ticks, 2M cells per stage, peak stash min(S, M), the
    measured idle share equal to ``bubble_fraction`` (0.2727 at S=4,
    M=8), and the same cells, ticks and hops as the JAX package's grid."""
    from repro.distributed import pipeline as jpl
    g = pl._build_grid(S, Mb)
    assert g.ticks == 2 * (Mb + S - 1)
    assert len(g.ops) == 2 * S * Mb
    measured = 1 - len(g.ops) / (S * g.ticks)
    assert abs(measured - pl.bubble_fraction(S, Mb, "1f1b")) < 1e-12
    assert g.peak_stash == pl.peak_activation_microbatches(S, Mb, "1f1b")
    assert pl._build_grid(S, Mb, forward_only=True).ticks == Mb + S - 1
    jg = jpl._build_grid(S, Mb)
    assert [(o.stage, o.kind, o.mb, o.tick, o.src_hop) for o in g.ops] == \
        [(o.stage, o.kind, o.mb, o.tick, o.src_hop) for o in jg.ops]
    assert g.hop_edges == jg.hop_edges and g.hop_order == jg.hop_order


@pytest.mark.parametrize("S", [2, 4])
def test_forward_matches_sequential_gpipe_and_jax(ref, executor, S):
    """``apply`` (the forward-only DAG) bit for bit against the sequential
    chain and the port's ``gpipe``; within ``JAX_TOL`` of JAX's."""
    from repro_torch.launch.mesh import make_mesh
    eng, ex = executor
    params, xs, _ = inputs(ref, S)
    sched = schedule(S, eng, ex)
    ys = sched.apply(params, xs, timeout=300)
    seq = []
    for m in range(M):
        x = xs[m]
        for s in range(S):
            x = stage_fn({k: v[s] for k, v in params.items()}, x)
        seq.append(x)
    assert torch.equal(ys, torch.stack(seq))
    gp = pl.gpipe(stage_fn, make_mesh((S,), ("stage",), "cpu"), "stage", S)
    assert torch.equal(ys, gp(params, xs))
    np.testing.assert_allclose(ys.numpy(), ref[f"{S}/apply"], **JAX_TOL)
    np.testing.assert_allclose(ys.numpy(), ref[f"{S}/gpipe"], **JAX_TOL)
    sched.close()


@pytest.mark.parametrize("S", [2, 4])
def test_1f1b_step_bitwise_sequential_and_near_jax(ref, executor, S):
    """A 3-step SGD trajectory: the DAG's loss and gradients bit for bit
    against the sequential computation at every step, and within
    ``JAX_TOL`` of the JAX package's ``PipelineSchedule``; the only
    blocking wait is the caller's, once a call; hops ran as persistent
    p2p starts issued by executor workers."""
    eng, ex = executor
    params, xs, ts = inputs(ref, S)
    sched = schedule(S, eng, ex)
    p_dag = {k: v.clone() for k, v in params.items()}
    p_seq = {k: v.clone() for k, v in params.items()}
    for step in range(SGD_STEPS):
        loss, grads = sched.step(p_dag, xs, ts, timeout=300)
        sl, sg = sequential_step(p_seq, xs, ts, S)
        assert loss.numpy().tobytes() == sl.numpy().tobytes(), step
        for k in ("w1", "w2"):
            assert torch.equal(grads[k], sg[k]), (step, k)
            np.testing.assert_allclose(grads[k].numpy(),
                                       ref[f"{S}/grad{step}/{k}"],
                                       err_msg=f"{step}/{k}", **JAX_TOL)
        np.testing.assert_allclose(loss.item(), ref[f"{S}/loss{step}"],
                                   **JAX_TOL)
        p_dag = {k: p_dag[k] - LR * grads[k] for k in p_dag}
        p_seq = {k: p_seq[k] - LR * sg[k] for k in p_seq}
    st = sched.stats()
    assert st["blocking_waits"] == SGD_STEPS, st
    assert st["p2p_stream_completions"] > 0
    assert st["hop_starts"]["f"] > 0 and st["hop_starts"]["b"] > 0
    assert st["p2p_issued"] == st["p2p_completed"] > 0, st
    for chan in sched._chan.values():
        inner = chan.persistent.active
        assert inner is not None and \
            inner.issue_thread in ex.worker_thread_idents()
    timing = sched.last_step_timing
    assert timing["cells"] == [2 * M] * S
    assert timing["grid_ticks"] == 2 * (M + S - 1)
    assert 0.0 <= timing["bubble"] < 1.0
    sched.close()


def test_gpipe_gradients_match_sequential(ref):
    """Autograd through the port's ``gpipe`` tick loop: the gradients of
    the mean microbatch loss equal the 1F1B DAG's sequential reference
    within 1e-6 (the same math, summed in another order)."""
    from repro_torch.launch.mesh import make_mesh
    S = 4
    params, xs, ts = inputs(ref, S)
    gp = pl.gpipe(stage_fn, make_mesh((S,), ("stage",), "cpu"), "stage", S)
    ps = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    ys = gp(ps, xs)
    loss = torch.stack([loss_fn(ys[m], ts[m]) for m in range(M)]).mean()
    g = torch.autograd.grad(loss, [ps["w1"], ps["w2"]])
    sl, sg = sequential_step(params, xs, ts, S)
    np.testing.assert_allclose(loss.item(), sl.item(), rtol=1e-6)
    for got, k in zip(g, ("w1", "w2")):
        np.testing.assert_allclose(got.numpy(), sg[k].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_failing_cell_fails_the_step_once(executor):
    """A stage that raises fails the step's request (no hang); the next
    step of the same schedule runs."""
    eng, ex = executor
    S = 2
    calls = {"n": 0}

    def flaky(p, x):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("stage blew up")
        return stage_fn(p, x)

    from repro_torch.launch.mesh import make_mesh
    sched = pl.PipelineSchedule(flaky, make_mesh((S,), ("stage",), "cpu"),
                                "stage", S, loss_fn=loss_fn, engine=eng,
                                executor=ex, name="flaky")
    g = torch.Generator().manual_seed(1)
    params = {"w1": torch.randn(S, D, H, generator=g) * 0.3,
              "w2": torch.randn(S, H, D, generator=g) * 0.3}
    xs = torch.randn(M, MB, D, generator=g)
    with pytest.raises(RuntimeError, match="stage blew up"):
        sched.step(params, xs, xs, timeout=60)
    loss, _ = sched.step(params, xs, xs, timeout=60)
    assert torch.isfinite(loss)
    sched.close()


def test_failing_cell_with_a_hop_in_flight_frees_its_channel():
    """A cell fails while a hop of its step is still in flight on a
    persistent channel: the p2p stream is held, so the forward hop
    started after the first forward cell cannot retire.  The failed step
    cancels that hop before its request fails, so the next step's first
    hop finds the channel free (a hop left in flight makes that start
    raise "already has an active start") and the step runs to a finite
    loss once the stream is released."""
    from repro_torch.core import ProgressEngine
    from repro_torch.launch.mesh import make_mesh
    S = 2
    seen = {"calls": 0, "hop": None}
    box = {}

    def flaky(p, x):
        seen["calls"] += 1
        if seen["calls"] == 2:          # stage 0's second forward cell
            seen["hop"] = box["sched"]._chan["f"].persistent.active
            raise RuntimeError("stage blew up")
        return stage_fn(p, x)

    sched = pl.PipelineSchedule(flaky, make_mesh((S,), ("stage",), "cpu"),
                                "stage", S, loss_fn=loss_fn,
                                engine=ProgressEngine(), name="held")
    box["sched"] = sched
    stream = sched.p2p.stream
    poll = stream._poll_once
    held = {"on": True}
    stream._poll_once = lambda: 0 if held["on"] else poll()
    g = torch.Generator().manual_seed(2)
    params = {"w1": torch.randn(S, D, H, generator=g) * 0.3,
              "w2": torch.randn(S, H, D, generator=g) * 0.3}
    xs = torch.randn(M, MB, D, generator=g)
    with pytest.raises(RuntimeError, match="stage blew up"):
        sched.step(params, xs, xs, timeout=60)
    hop = seen["hop"]
    assert hop is not None, "no hop was in flight when the cell failed"
    # before the stream is released: a hop still in flight here makes the
    # next step's first start on its channel raise
    assert hop.is_complete and hop.cancelled, \
        "the failed step left its hop in flight on the persistent channel"
    held["on"] = False
    loss, _ = sched.step(params, xs, xs, timeout=60)
    assert torch.isfinite(loss)
    sched.close()


@pytest.mark.parametrize("kind,mesh", [("1f1b", "2x2"), ("1f1b", "1x4"),
                                       ("gpipe", "1x4")])
def test_launcher_pipeline_on_cpu(tmp_path, kind, mesh):
    """``launch.train --pipeline {1f1b,gpipe} --mesh DxS`` on the CPU:
    every step logged and finite; 1f1b rides the engine grad reducer
    over the data axis with one blocking wait a step per row."""
    from repro_torch.launch import train as launch
    args = launch.build_parser().parse_args(
        ["--device", "cpu", "--pipeline", kind, "--mesh", mesh,
         "--microbatches", "4", "--steps", "4", "--global-batch", "4",
         "--ckpt-dir", str(tmp_path)])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        report = launch.run(args, log_every=1)
    losses = [m["loss"] for m in report.log]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert report.trainer.cfg.pipeline == kind
    D = int(mesh.split("x")[0])
    if kind == "1f1b":
        assert len(report.rows) == D
        assert all(r.blocking_waits == 4 for r in report.rows)
        assert report.reducer.axis_size == D
        assert "pipe0 stats" in out.getvalue()
    else:
        assert report.reducer is None


def test_launcher_pipeline_refusals(tmp_path):
    from repro_torch.launch import train as launch
    parse = launch.build_parser().parse_args
    base = ["--device", "cpu", "--steps", "2", "--ckpt-dir", str(tmp_path)]
    for extra, what in ((["--pipeline", "gpipe", "--mesh", "2x2"],
                         "data dim 1"),
                        (["--pipeline", "1f1b", "--mesh", "2x2",
                          "--pipeline-stages", "4"], "contradicts"),
                        (["--pipeline", "1f1b", "--mesh", "2x2",
                          "--devices", "2"], "needs 4 ranks")):
        with pytest.raises(SystemExit, match=what):
            launch.run(parse(base + extra))


# ---------------------------------------------------------------------------
# a device per stage: meshes of ["cpu"] * S
# ---------------------------------------------------------------------------

def stage_mesh(S):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((S,), ("stage",), devices=["cpu"] * S)


def blocks(params, S):
    from repro_torch.collectives.rank_shards import RankShards
    return {k: RankShards.from_stacked(v, stage_mesh(S))
            for k, v in params.items()}


@pytest.mark.parametrize("S", [2, 4])
def test_1f1b_per_device_equals_stacked_sequential_and_near_jax(ref,
                                                                executor, S):
    """The 3-step SGD trajectory with a device per stage: each step's loss
    and gradients (``RankShards`` blocks, stage s's on its device) bit for
    bit against the stacked schedule and the sequential chain, within
    ``JAX_TOL`` of the JAX ``PipelineSchedule`` on S host devices; the
    forward equal to the stacked ``apply``."""
    from repro_torch.collectives.rank_shards import RankShards
    eng, ex = executor
    params, xs, ts = inputs(ref, S)
    stacked = schedule(S, eng, ex, name="s")
    per = pl.PipelineSchedule(stage_fn, stage_mesh(S), "stage", S,
                              loss_fn=loss_fn, engine=eng, executor=ex,
                              name="d")
    p_st = {k: v.clone() for k, v in params.items()}
    p_dev = blocks(params, S)
    for step in range(SGD_STEPS):
        loss, grads = per.step(p_dev, xs, ts, timeout=300)
        sl, sg = stacked.step(p_st, xs, ts, timeout=300)
        ql, qg = sequential_step(p_st, xs, ts, S)
        assert loss.numpy().tobytes() == sl.numpy().tobytes() == \
            ql.numpy().tobytes(), step
        for k in ("w1", "w2"):
            assert isinstance(grads[k], RankShards) and len(grads[k]) == S
            got = grads[k].to_stacked("cpu")
            assert torch.equal(got, sg[k]) and torch.equal(got, qg[k])
            np.testing.assert_allclose(got.numpy(),
                                       ref[f"{S}/grad{step}/{k}"],
                                       err_msg=f"{step}/{k}", **JAX_TOL)
        np.testing.assert_allclose(loss.item(), ref[f"{S}/loss{step}"],
                                   **JAX_TOL)
        p_st = {k: p_st[k] - LR * sg[k] for k in p_st}
        p_dev = blocks(p_st, S)
    assert torch.equal(per.apply(blocks(params, S), xs, timeout=300),
                       stacked.apply(params, xs, timeout=300))
    st = per.stats()
    assert st["blocking_waits"] == SGD_STEPS + 1
    assert st["hop_starts"] == stacked.stats()["hop_starts"]
    # every hop carries a row a stage; on ["cpu"] * S none leaves a device
    assert st["hop_rows"] == S * sum(st["hop_starts"].values()) > 0
    assert st["hop_rows_between_devices"] == 0
    assert st["p2p_issued"] == st["p2p_completed"] > 0
    per.close()
    stacked.close()


@pytest.mark.parametrize("S", [2, 4])
def test_gpipe_per_device_equals_stacked(ref, S):
    """``gpipe`` with a device per stage: the forward, the mean
    microbatch loss and the gradients through its tick loop (autograd
    through the copies between the stages' devices) bit for bit against
    the stacked ``gpipe``."""
    from repro_torch.launch.mesh import make_mesh
    params, xs, ts = inputs(ref, S)
    runs = []
    for mesh, ps in ((make_mesh((S,), ("stage",), "cpu"),
                      {k: v.clone().requires_grad_(True)
                       for k, v in params.items()}),
                     (stage_mesh(S), blocks(params, S))):
        if mesh.per_device:
            for v in ps.values():
                for t in v.shards:
                    t.requires_grad_(True)
        ys = pl.gpipe(stage_fn, mesh, "stage", S)(ps, xs)
        loss = torch.stack([loss_fn(ys[m], ts[m]) for m in range(M)]).mean()
        leaves = [t for k in ("w1", "w2") for t in (
            ps[k].shards if mesh.per_device else [ps[k]])]
        g = torch.autograd.grad(loss, leaves)
        grads = [torch.cat(g[:S]), torch.cat(g[S:])] if mesh.per_device \
            else list(g)
        runs.append((ys.detach(), loss.detach(), grads))
    (ys0, l0, g0), (ys1, l1, g1) = runs
    assert torch.equal(ys0, ys1) and torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def launcher_run(tmp_path, kind, mesh, extra=(), params=None):
    """``launch.train --pipeline kind --mesh mesh`` on the CPU (its seeded
    weights, or ``params``): (losses, {checkpoint file: bytes}, report)."""
    from repro_torch.launch import train as launch
    args = launch.build_parser().parse_args(
        ["--device", "cpu", "--pipeline", kind, "--mesh", mesh,
         "--microbatches", str(LAUNCH_M), "--steps", str(LAUNCH_STEPS),
         "--global-batch", str(LAUNCH_MB), "--ckpt-dir", str(tmp_path)]
        + list(extra))
    with contextlib.redirect_stdout(io.StringIO()):
        report = launch.run(args, params=params, log_every=1)
    files = {os.path.relpath(f, tmp_path): Path(f).read_bytes()
             for f in glob.glob(f"{tmp_path}/**/*.npy", recursive=True)}
    return [m["loss"] for m in report.log], files, report


@pytest.mark.parametrize("kind,mesh", [("1f1b", "1x4"), ("1f1b", "2x2"),
                                       ("gpipe", "1x4")])
def test_launcher_rank_devices_equals_stacked(tmp_path, kind, mesh):
    """``--rank-devices cpu,cpu,cpu,cpu``: rank (d, s) holds stage s's
    parameters and moments on its device; the losses of every step and
    every checkpoint file (the ``[S, ...]`` leaves, the moments, the step
    counter) equal the stacked launcher's bit for bit."""
    from repro_torch.collectives.rank_shards import RankShards
    want, want_files, _ = launcher_run(tmp_path / "stacked", kind, mesh)
    got, files, report = launcher_run(
        tmp_path / "devices", kind, mesh,
        ["--rank-devices", "cpu,cpu,cpu,cpu"])
    assert got == want and len(got) == 4
    assert files.keys() == want_files.keys() and len(files) == 7
    for name in files:
        assert files[name] == want_files[name], name
    D = int(mesh.split("x")[0])
    w1 = report.trainer.params["w1"]
    assert isinstance(w1, RankShards) and len(w1) == 4 and w1.copies == D
    if kind == "1f1b":
        assert report.reducer.axis_size == D
        assert all(r.mesh.per_device for r in report.rows)


@pytest.mark.parametrize("form", ["stacked", "devices"])
@pytest.mark.parametrize("kind,nd,S", LAUNCH_CASES)
def test_launcher_near_jax(ref, tmp_path, kind, nd, S, form):
    """The launcher's ``--pipeline`` run, rank-stacked or with a device per
    rank, handed the JAX child's weights: the loss of every step and the
    final ``[S, ...]`` weights within ``JAX_TOL`` of the JAX package's
    rehearsal (its rows' ``PipelineSchedule``, or gpipe's tick loop, the
    data-axis mean and ``optimizer.apply``) on the same batches."""
    from repro_torch.collectives.rank_shards import RankShards
    tag = f"launch/{kind}/{nd}x{S}"
    params = {k: torch.from_numpy(ref[f"{tag}/init/{k}"].copy())
              for k in ("w1", "w2")}
    handed = {k: v.clone() for k, v in params.items()}
    extra = ["--rank-devices", ",".join(["cpu"] * (nd * S))] \
        if form == "devices" else []
    losses, _, report = launcher_run(tmp_path, kind, f"{nd}x{S}", extra,
                                     params=params)
    np.testing.assert_allclose(
        losses, [ref[f"{tag}/loss{i}"] for i in range(LAUNCH_STEPS)],
        **JAX_TOL)
    for k in ("w1", "w2"):
        got = report.trainer.params[k]
        assert isinstance(got, RankShards) == (form == "devices")
        if form == "devices":
            got = got.to_stacked("cpu")
        np.testing.assert_allclose(got.numpy(), ref[f"{tag}/final/{k}"],
                                   err_msg=k, **JAX_TOL)
    # the launcher stepped copies of the weights it was handed
    assert all(torch.equal(params[k], handed[k]) for k in params)


def test_launcher_rank_devices_refusals(tmp_path):
    """A device list of another length than the mesh's ranks exits."""
    from repro_torch.launch import train as launch
    args = launch.build_parser().parse_args(
        ["--device", "cpu", "--pipeline", "1f1b", "--mesh", "2x2",
         "--steps", "2", "--ckpt-dir", str(tmp_path),
         "--rank-devices", "cpu,cpu"])
    with pytest.raises(SystemExit, match=r"names 2 device\(s\) for the "
                                         r"2x2 mesh's 4 ranks"):
        launch.run(args)
