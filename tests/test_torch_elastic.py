"""Membership-aware elastic recovery of the port: the mesh planning and
sharding rules against the JAX package's (pure Python there, called
in this process), ``reshard_restore``, the heartbeat monitor and the
watchdog with a ``MembershipEpoch``, FSDP handles invalidated in flight
on a 2-D mesh, and the chaos runs — 2 of 4 ranks killed mid-run, the
trainer remeshing and retrying the step — bit for bit against a
checkpoint-and-restart on the 2 survivors, data-parallel and FSDP."""
import contextlib
import io
import threading
import types

import pytest
import torch

from repro_torch.collectives import nonblocking as NB
from repro_torch.core import ProgressEngine
from repro_torch.distributed import elastic
from repro_torch.distributed.fault_tolerance import (HeartbeatMonitor,
                                                     StepWatchdog,
                                                     monitor_mesh)
from repro_torch.launch.mesh import make_mesh
from repro_torch import sharding as shd

TINY = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=256, num_heads=4,
            num_kv_heads=2, head_dim=16, remat_policy="none",
            dtype="float32")
FAKE_MESHES = [{"data": 4, "model": 2}, {"data": 2, "model": 2},
               {"data": 1, "model": 1}, {"data": 8, "model": 1},
               {"pod": 2, "data": 2, "model": 4}]


@pytest.mark.parametrize("prefer_model", [1, 2, 16])
def test_plan_mesh_and_remesh_match_jax(prefer_model):
    from repro.distributed import elastic as jel
    for n in range(1, 20):
        got = elastic.plan_mesh(n, prefer_model=prefer_model)
        assert got == jel.plan_mesh(n, prefer_model=prefer_model), n
        mesh = elastic.remesh(n, prefer_model=prefer_model, device="cpu")
        assert tuple(mesh.sizes) == got[0] and mesh.axis_names == got[1]
        assert elastic.largest_pof2(n) == jel.largest_pof2(n)


def test_elastic_errors_match_jax():
    from repro.distributed import elastic as jel
    for fn, jfn in ((lambda: elastic.largest_pof2(0),
                     lambda: jel.largest_pof2(0)),
                    (lambda: elastic.plan_mesh(0), lambda: jel.plan_mesh(0)),
                    (lambda: elastic.remesh(0, device="cpu"),
                     lambda: jel.remesh(0))):
        with pytest.raises(ValueError) as ours:
            fn()
        with pytest.raises(ValueError) as theirs:
            jfn()
        assert str(ours.value) == str(theirs.value)


def _fake(shape):
    return types.SimpleNamespace(shape=dict(shape))


@pytest.mark.parametrize("mesh_shape", FAKE_MESHES)
def test_resolve_spec_and_spec_tree_match_jax(mesh_shape):
    """Every logical axis of the rule table on dims that divide and do
    not, composed axes, reused axes; and the tiny smollm-360m's param
    spec tree: the port's spec tuples equal JAX's PartitionSpecs."""
    from repro import sharding as jshd
    from repro.configs import get_config as jget
    from repro.models import registry as jreg
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.layers import shapes_tree, tree_map
    mesh = _fake(mesh_shape)
    cases = [((name, None), (dim, 3)) for name in shd.DEFAULT_RULES
             for dim in (1, 6, 16, 7)]
    cases += [(("embed", "mlp"), (16, 8)), (("mlp", "heads"), (8, 8)),
              (("batch", "act_seq", "act_heads"), (8, 5, 4)),
              ((None, "vocab"), (3, 12)), (("embed_nofsdp",), (5,))]
    for axes, shape in cases:
        want = tuple(jshd.resolve_spec(axes, shape, mesh))
        assert shd.resolve_spec(axes, shape, mesh) == want, (axes, shape)
    with pytest.raises(KeyError):
        shd.resolve_spec(("nope",), (4,), mesh)
    spec = transformer.param_spec(get_config("smollm-360m")
                                  .with_overrides(**TINY))
    axes = tree_map(lambda s: s.axes, spec)
    got = shd.spec_tree(axes, shapes_tree(spec), mesh)
    jcfg = jget("smollm-360m").with_overrides(**TINY)
    want = jshd.spec_tree(jreg.param_axes(jcfg), jreg.param_shapes(jcfg),
                          mesh)

    def flat(t, path=()):
        if isinstance(t, dict):
            return {p: v for k, sub in t.items()
                    for p, v in flat(sub, path + (k,)).items()}
        return {path: tuple(t)}
    assert flat(got) == flat(want)
    # a rule override narrows the choice, as in JAX
    rules = shd.merged_rules({"embed": ((),)})
    with shd.axis_rules(rules):
        assert shd.resolve_spec(("embed",), (16,), mesh) == ()
    assert shd.current_rules() is shd.DEFAULT_RULES


SERVE_MESHES = [((1,), ("model",)), ((2,), ("model",)), ((4,), ("model",)),
                ((2, 2), ("data", "model"))]


@pytest.mark.parametrize("shape,names", SERVE_MESHES)
def test_placement_side_matches_jax_named_shardings(shape, names):
    """``logical_sharding`` and ``tree_shardings`` give the specs of the
    JAX ``NamedSharding``s (``tuple(sharding.spec)``) on the serve
    meshes, for the dense tree's params and paged pool and the logits;
    ``shard_hint`` resolves against the ``set_mesh`` mesh, returns its
    input unchanged and raises where ``resolve_spec`` raises."""
    from jax.sharding import AbstractMesh
    from repro import sharding as jshd
    from repro.configs import get_config as jget
    from repro.models import registry as jreg
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.layers import shapes_tree, tree_map
    mesh = make_mesh(shape, names, "cpu")
    jmesh = AbstractMesh(shape, names)
    cfg = get_config("qwen2-0.5b").with_overrides(**TINY)
    jcfg = jget("qwen2-0.5b").with_overrides(**TINY)
    cases = [(("batch", "act_seq", "act_vocab"), (8, 1, 256)),
             (("vocab", "embed"), (256, 64)), (("embed", "vocab"), (64, 6)),
             (("layers", None, "cache_seq", "act_kv_heads", "head_dim"),
              (2, 9, 4, 2, 16))]
    for axes, dims in cases:
        got = shd.logical_sharding(axes, dims, mesh)
        assert got.mesh is mesh
        assert got.spec == tuple(jshd.logical_sharding(axes, dims,
                                                       jmesh).spec)
    spec = transformer.param_spec(cfg)
    got = shd.tree_shardings(tree_map(lambda s: s.axes, spec),
                             shapes_tree(spec), mesh)
    want = jshd.tree_shardings(jreg.param_axes(jcfg), jreg.param_shapes(jcfg),
                               jmesh)

    def flat(t, path=()):
        if isinstance(t, dict):
            return {p: v for k, sub in t.items()
                    for p, v in flat(sub, path + (k,)).items()}
        return {path: tuple(t.spec)}
    assert flat(got) == flat(want)
    x = torch.zeros(8, 1, 256)
    assert shd.current_mesh() is None
    assert shd.shard_hint(x, "nope") is x          # no mesh: a no-op
    with shd.set_mesh(mesh):
        assert shd.current_mesh() is mesh
        assert shd.shard_hint(x, "batch", "act_seq", "act_vocab") is x
        assert transformer.unembed(
            {"embed": torch.ones(256, 64)},
            cfg.with_overrides(dtype="float32"),
            torch.ones(8, 1, 64)).shape == (8, 1, 256)
        with pytest.raises(KeyError):
            shd.shard_hint(x, "batch", "act_seq", "nope")
    assert shd.current_mesh() is None


def test_reshard_restore_from_4x2_onto_2x2(tmp_path):
    """Save on a (4,2) mesh, lose half the ranks, restore onto (2,2):
    values identical on the new mesh's device, specs resolved for the
    new mesh as JAX resolves them; an unknown logical axis raises."""
    from repro import sharding as jshd
    from repro_torch.train.checkpoint import AsyncCheckpointer
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(16, 8, generator=g), "b": torch.ones(8),
            "odd": torch.randn(5, 3, generator=g)}
    axes = {"w": ("embed", "mlp"), "b": ("mlp",), "odd": ("embed", "mlp")}
    mesh8 = make_mesh((4, 2), ("data", "model"), "cpu")
    ck = AsyncCheckpointer(str(tmp_path), ProgressEngine())
    ck.save_blocking(5, tree)
    shape, names = elastic.plan_mesh(4, prefer_model=2)
    assert shape == (2, 2)
    mesh4 = make_mesh(shape, names, "cpu")
    assert mesh4 != mesh8
    like = {k: torch.zeros_like(v) for k, v in tree.items()}
    restored, specs = elastic.reshard_restore(ck, 5, like, axes, mesh4)
    for k in tree:
        assert torch.equal(restored[k], tree[k]), k
        assert restored[k].device == mesh4.device
        want = tuple(jshd.resolve_spec(axes[k], tuple(tree[k].shape),
                                       _fake(mesh4.shape)))
        assert specs[k] == want, k
    assert specs["w"] == ("data", "model") and specs["odd"] == ()
    with pytest.raises(KeyError):
        elastic.reshard_restore(ck, 5, like, dict(axes, b=("nope",)), mesh4)


class TestHeartbeat:
    def test_concurrent_beat_and_poll(self):
        """Hammer beat() from threads while _poll sweeps with an
        advancing clock at the timeout edge: no deadlock, no peer lost
        for good (the last beat revives)."""
        eng = ProgressEngine()
        clock = {"t": 0.0}
        lock = threading.Lock()

        def now():
            with lock:
                return clock["t"]

        hb = HeartbeatMonitor(eng, ["p0", "p1"], timeout=1.0, clock=now)
        stop = threading.Event()

        def beater():
            while not stop.is_set():
                hb.beat("p0")

        threads = [threading.Thread(target=beater) for _ in range(4)]
        for t in threads:
            t.start()
        try:
            for _ in range(200):
                with lock:
                    clock["t"] += 0.6       # p1 dies; p0 is kept alive
                eng.progress()
        finally:
            stop.set()
            for t in threads:
                t.join()
        assert "p1" in hb.failed
        hb.beat("p0")
        assert "p0" in hb.alive

    def test_monitor_mesh_counts_ranks_per_peer(self):
        """On a (data=2, model=2) mesh: one peer per data rank, and a dead
        peer invalidates the epoch down to the surviving RANK count."""
        eng = ProgressEngine()
        clock = {"t": 0.0}
        epoch = NB.MembershipEpoch(n_devices=4)
        failed = []
        hb = monitor_mesh(eng, make_mesh((2, 2), ("data", "model"), "cpu"),
                          "data", timeout=5.0, epoch=epoch,
                          on_failure=failed.append, clock=lambda: clock["t"])
        assert sorted(hb.peers) == ["data0", "data1"]
        assert hb.devices_per_peer == 2
        clock["t"] = 3.0
        hb.beat("data0")
        clock["t"] = 6.0
        eng.progress()
        assert failed == ["data1"] and hb.alive == ["data0"]
        assert epoch.version == 1 and epoch.n_devices == 2
        eng.progress()
        assert epoch.version == 1           # flagged once


class TestWatchdog:
    def test_fires_once_and_invalidates_once(self):
        eng = ProgressEngine()
        clock = {"t": 0.0}
        epoch = NB.MembershipEpoch(n_devices=4)
        wd = StepWatchdog(eng, limit=10.0, clock=lambda: clock["t"],
                          epoch=epoch)
        wd.arm()
        clock["t"] = 11.0
        eng.progress()
        assert wd.fired == 1
        # a hung step keeps the membership: survivors == current ranks
        assert epoch.version == 1 and epoch.n_devices == 4
        clock["t"] = 1000.0
        eng.progress()
        eng.progress()
        assert wd.fired == 1 and epoch.version == 1
        wd.arm()
        clock["t"] = 2000.0
        eng.progress()
        assert wd.fired == 2 and epoch.version == 2

    def test_fired_watchdog_fails_the_inflight_start_once(self):
        """A persistent reduce-scatter started on an armed step that hangs
        (nobody progresses its stream): the watchdog's poll invalidates
        the epoch, the start fails with a retryable MembershipError
        exactly once, and the handle refuses a start until rebuilt."""
        eng = ProgressEngine()
        coll = NB.UserCollectives(eng)
        clock = {"t": 0.0}
        epoch = NB.MembershipEpoch(n_devices=4)
        mesh = make_mesh((4, 1), ("data", "model"), "cpu")
        x = torch.arange(4 * 8, dtype=torch.int32).reshape(4, 8)
        h = coll.reduce_scatter_init(x, mesh, "data", warmup=False,
                                     epoch=epoch)
        hung = []
        wd = StepWatchdog(eng, limit=5.0, clock=lambda: clock["t"],
                          epoch=epoch, on_hang=lambda: hung.append(1))
        wd.arm()
        req = h.start(x)
        assert not req.is_complete
        clock["t"] = 6.0
        eng.poll_subsystems()
        assert hung == [1] and req.is_complete and req.failed
        assert isinstance(req.exception, NB.MembershipError)
        assert coll.failed == 1
        eng.poll_subsystems()
        epoch.invalidate(survivors=4)
        assert coll.failed == 1 and wd.fired == 1
        with pytest.raises(NB.MembershipError):
            h.start(x)
        h.rebuild(mesh)
        out = h.start(x).wait(timeout=30)
        assert torch.equal(out, x.sum(0).reshape(4, 2))
        coll.close(drain=False)


# ---------------------------------------------------------------------------
# FSDP handles invalidated in flight on a 2-D mesh
# ---------------------------------------------------------------------------

def test_fsdp_invalidate_mid_reduce_scatter_2d_mesh():
    """On a (2,2) data x model mesh, invalidating the epoch while a
    persistent FSDP reduce-scatter is in flight fails that start exactly
    once with a retryable MembershipError; ``remesh`` onto the surviving
    (2,1) mesh replans the handles and the reducer sums exactly again."""
    from repro_torch.collectives.overlap import FsdpReducer
    eng = ProgressEngine()
    epoch = NB.MembershipEpoch(n_devices=4)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    red = FsdpReducer(mesh, "data", engine=eng,
                      spec=NB.CollectiveSpec(backend="user", chunks=2),
                      epoch=epoch)
    g = torch.arange(2 * 8, dtype=torch.int32).reshape(2, 8)
    r = red.ireduce_scatter([g])
    assert not r.is_complete
    epoch.invalidate(survivors=2, reason="chaos")
    failed_after = red.coll.failed
    assert failed_after >= 1
    with pytest.raises(NB.MembershipError) as ei:
        r.wait(timeout=30)
    assert ei.value.survivors == 2 and ei.value.version == 1
    epoch.invalidate(survivors=2)
    assert red.coll.failed == failed_after          # no double-fail
    red.remesh(make_mesh((2, 1), ("data", "model"), "cpu"))
    assert red.remeshes == 1 and red.axis_size == 2
    out = red.ireduce_scatter([g]).wait(timeout=60)
    assert torch.equal(out[0], (g[0] + g[1]).reshape(2, 4))
    sh = torch.arange(2 * 4, dtype=torch.int32).reshape(2, 4)
    full = red.gather([sh], timeout=60)
    assert torch.equal(full[0], sh.reshape(1, 8).repeat(2, 1))
    red.close()


def test_fsdp_invalidate_mid_prefetch_gather_2d_mesh():
    """A chained prefetch all-gather killed mid-start on a (2,2) mesh
    fails exactly once and surfaces the MembershipError from
    ``FsdpGather.wait``; so does a gather chained off a compute future
    whose start comes after the invalidation (the stale handle)."""
    from repro_torch.collectives.overlap import FsdpReducer
    from repro_torch.core import Request
    eng = ProgressEngine()
    epoch = NB.MembershipEpoch(n_devices=4)
    red = FsdpReducer(make_mesh((2, 2), ("data", "model"), "cpu"), "data",
                      engine=eng, spec=NB.CollectiveSpec(backend="user"),
                      epoch=epoch)
    sh = torch.arange(2 * 4, dtype=torch.int32).reshape(2, 4)
    red.gather([sh], timeout=30)                     # builds the handle
    gather = red.igather([sh])
    upstream = Request()
    chained = red.igather([sh], after=[upstream])
    epoch.invalidate(survivors=2, reason="chaos")
    failed_after = red.coll.failed
    assert failed_after >= 1
    with pytest.raises(NB.MembershipError) as ei:
        gather.wait(timeout=30)
    assert ei.value.survivors == 2
    upstream.complete(None)
    with pytest.raises(NB.MembershipError):
        chained.wait(timeout=30)
    epoch.invalidate(survivors=2)
    assert red.coll.failed == failed_after           # no double-fail
    red.close()


# ---------------------------------------------------------------------------
# Chaos: kill 2 of 4 ranks mid-run, against a restart on the survivors
# ---------------------------------------------------------------------------

STEPS, KILL = 6, 3


class ListPipe:
    def __init__(self, bs):
        self.bs = list(bs)

    def next_batch(self):
        return self.bs.pop(0)


def _setup():
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import registry
    from repro_torch.train import optimizer as opt
    cfg = get_config("smollm-360m").with_overrides(**TINY)
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=STEPS)
    it = iter(SyntheticLM(cfg.vocab_size, 16, 8, seed=3))
    batches = [{k: torch.from_numpy(v.copy()) for k, v in next(it).items()}
               for _ in range(STEPS)]
    params = registry.init_params(cfg, torch.Generator().manual_seed(0))
    return cfg, ocfg, batches, params


def _loop_cfg(tmp_path, name, steps):
    from repro_torch.train.train_loop import TrainLoopConfig
    return TrainLoopConfig(total_steps=steps, checkpoint_every=10 ** 6,
                           checkpoint_dir=str(tmp_path / name), log_every=1,
                           resume=False,
                           collective_spec=NB.CollectiveSpec(backend="user"))


def _kill_hook(losses, epoch, survivors=2):
    def hook(s, m):
        losses.append(m["loss"])
        if s == KILL - 1 and epoch is not None:
            epoch.invalidate(survivors=survivors, reason="chaos")
    return hook


def _dp_parts(cfg, ocfg):
    from repro_torch.launch.train import make_rank_grads
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_loop import UserCollectiveStep

    def apply_fn(params, opt_state, grads, sm):
        params, opt_state, om = opt.apply(ocfg, opt_state, params, grads)
        return params, opt_state, dict({k: v.mean() for k, v in sm.items()},
                                       **om)

    def split(ranks, reducer):
        return UserCollectiveStep(make_rank_grads(cfg, ranks), apply_fn,
                                  reducer)
    return split


def test_chaos_data_parallel_matches_restart_bitwise(tmp_path):
    """Data-parallel (``UserCollectiveStep``): invalidate after step
    KILL-1 on 4 ranks; the trainer remeshes onto 2 and retries, and the
    loss trajectory and final parameters equal running KILL steps on 4
    and restarting the rest on 2, bit for bit."""
    from repro_torch.collectives.overlap import EngineGradReducer
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_loop import Trainer
    cfg, ocfg, batches, params0 = _setup()
    split = _dp_parts(cfg, ocfg)
    mesh4 = elastic.remesh(4, prefer_model=1, device="cpu")

    eng = ProgressEngine()
    epoch = NB.MembershipEpoch(mesh=mesh4)
    red = EngineGradReducer(mesh4, "data", engine=eng, chunks=2, epoch=epoch)

    def remesh_fn(exc, params, opt_state):
        new_mesh = elastic.remesh(exc.survivors, prefer_model=1, device="cpu")
        red.remesh(new_mesh, "data")
        return split(dict(new_mesh.shape)["data"], red), params, opt_state

    losses = []
    params = tree_map(torch.clone, params0)
    tr = Trainer(None, params, opt.init(params), ListPipe(batches),
                 _loop_cfg(tmp_path, "a", STEPS), engine=eng,
                 split_step=split(4, red), epoch=epoch, remesh_fn=remesh_fn,
                 hooks=[_kill_hook(losses, epoch)])
    tr.run()
    red.close()
    assert tr.recoveries == 1 and red.remeshes == 1 and len(losses) == STEPS

    ref = []
    engA = ProgressEngine()
    redA = EngineGradReducer(mesh4, "data", engine=engA, chunks=2)
    params = tree_map(torch.clone, params0)
    trA = Trainer(None, params, opt.init(params), ListPipe(batches[:KILL]),
                  _loop_cfg(tmp_path, "b1", KILL), engine=engA,
                  split_step=split(4, redA), hooks=[_kill_hook(ref, None)])
    trA.run()
    redA.close()
    engB = ProgressEngine()
    redB = EngineGradReducer(elastic.remesh(2, prefer_model=1, device="cpu"),
                             "data", engine=engB, chunks=2)
    trB = Trainer(None, trA.params, trA.opt_state, ListPipe(batches[KILL:]),
                  _loop_cfg(tmp_path, "b2", STEPS - KILL), engine=engB,
                  split_step=split(2, redB), hooks=[_kill_hook(ref, None)])
    trB.run()
    redB.close()
    assert losses == ref
    for (k, a), (_, b) in zip(tree_leaves(tr.params),
                              tree_leaves(trB.params)):
        assert torch.equal(a, b), k


def _fsdp_state(params_tree, mesh, mu=None, nu=None, step=None):
    from repro_torch.collectives.overlap import FsdpLayout
    from repro_torch.train import optimizer as opt
    layout = FsdpLayout(params_tree, dict(mesh.shape)["data"], 1 << 16)
    shards = layout.shard_params(params_tree, mesh)
    if mu is None:
        return layout, shards, opt.init_shards(shards)
    return layout, shards, opt.AdamWState(step, layout.shard_params(mu, mesh),
                                          layout.shard_params(nu, mesh))


@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2)])
def test_chaos_fsdp_matches_restart_bitwise(tmp_path, mesh_shape):
    """FSDP (``FsdpStep``): kill 2 of 4 ranks after step KILL-1; the
    trainer drops the dead prefetch, unshards params and moments,
    re-shards them for the survivors' layout (step counter carried) and
    retries.  Against running KILL steps, unsharding, and restarting on
    the survivors' mesh: the same losses and parameters bit for bit."""
    from repro_torch.collectives.overlap import FsdpReducer
    from repro_torch.launch.train import build_fsdp_programs
    from repro_torch.train.train_loop import FsdpStep, Trainer
    cfg, ocfg, batches, params0 = _setup()
    spec = NB.CollectiveSpec(backend="user", chunks=2)
    mesh = make_mesh(mesh_shape, ("data", "model"), "cpu")
    model_dim = mesh_shape[1]

    def step_for(layout, mesh_, red):
        g, a, _, _ = build_fsdp_programs(cfg, ocfg, mesh_, layout)
        return FsdpStep(g, a, red, spec=spec)

    eng = ProgressEngine()
    epoch = NB.MembershipEpoch(mesh=mesh)
    red = FsdpReducer(mesh, "data", engine=eng, spec=spec, epoch=epoch)
    layout, shards, state = _fsdp_state(params0, mesh)
    box = {"layout": layout}

    def remesh_fn(exc, shards_, st):
        lay = box["layout"]
        new_mesh = elastic.remesh(exc.survivors, prefer_model=model_dim,
                                  device="cpu")
        red.remesh(new_mesh, "data")
        box["layout"], sh2, st2 = _fsdp_state(
            lay.unshard_params(shards_), new_mesh, lay.unshard_params(st.mu),
            lay.unshard_params(st.nu), st.step)
        return step_for(box["layout"], new_mesh, red), sh2, st2

    losses = []
    tr = Trainer(None, shards, state, ListPipe(batches),
                 _loop_cfg(tmp_path, "a", STEPS), engine=eng,
                 split_step=step_for(layout, mesh, red), epoch=epoch,
                 remesh_fn=remesh_fn, hooks=[_kill_hook(losses, epoch)])
    tr.run()
    red.close()
    assert tr.recoveries == 1 and red.remeshes == 1 and len(losses) == STEPS
    assert box["layout"].n == (2 if model_dim == 1 else 1)

    ref = []
    engA = ProgressEngine()
    redA = FsdpReducer(mesh, "data", engine=engA, spec=spec)
    layA, shA, stA = _fsdp_state(params0, mesh)
    trA = Trainer(None, shA, stA, ListPipe(batches[:KILL]),
                  _loop_cfg(tmp_path, "b1", KILL), engine=engA,
                  split_step=step_for(layA, mesh, redA),
                  hooks=[_kill_hook(ref, None)])
    trA.run()
    redA.close()
    mesh2 = elastic.remesh(2, prefer_model=model_dim, device="cpu")
    engB = ProgressEngine()
    redB = FsdpReducer(mesh2, "data", engine=engB, spec=spec)
    layB, shB, stB = _fsdp_state(
        layA.unshard_params(trA.params), mesh2,
        layA.unshard_params(trA.opt_state.mu),
        layA.unshard_params(trA.opt_state.nu), trA.opt_state.step)
    trB = Trainer(None, shB, stB, ListPipe(batches[KILL:]),
                  _loop_cfg(tmp_path, "b2", STEPS - KILL), engine=engB,
                  split_step=step_for(layB, mesh2, redB),
                  hooks=[_kill_hook(ref, None)])
    trB.run()
    redB.close()
    assert losses == ref
    for a, b in zip(tr.params, trB.params):
        assert torch.equal(a, b)
    assert tr.opt_state.step.item() == trB.opt_state.step.item() == STEPS


@pytest.mark.parametrize("fsdp", [False, True])
def test_launcher_chaos_kill_remeshes_once(tmp_path, fsdp):
    """``launch.train --devices 4 --collective-backend user --elastic
    --chaos-kill 2 --chaos-kill-step 2``: one remesh printed, one
    recovery, every step logged; the trajectory from the kill on equals
    the FSDP and data-parallel runs' (the same math on 2 ranks)."""
    from repro_torch.launch import train as launch
    args = launch.build_parser().parse_args(
        ["--device", "cpu", "--scale", "tiny", "--steps", "5",
         "--global-batch", "8", "--seq", "16", "--devices", "4",
         "--collective-backend", "user", "--elastic", "--chaos-kill", "2",
         "--chaos-kill-step", "2", "--ckpt-dir", str(tmp_path)]
        + (["--fsdp"] if fsdp else []))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        report = launch.run(args)
    text = out.getvalue()
    assert text.count("remesh: 2 survivor(s) -> mesh {'data': 2, "
                      "'model': 1}") == 1, text
    assert report.trainer.recoveries == 1
    assert [m["step"] for m in report.log] == list(range(5))
    assert report.reducer.remeshes == 1


def test_launcher_chaos_kill_on_a_model_axis_per_device(tmp_path):
    """``launch.train --mesh 2x2 --fsdp --collective-backend user
    --rank-devices cpu,cpu,cpu,cpu --chaos-kill 1 --heartbeat-timeout
    60``: one remesh onto 3 survivors, a (1, 2) mesh on the first two
    devices (the model dim kept); the losses equal the rank-stacked
    launcher's same run bit for bit, and the final blocks are copies on
    the survivors' two devices, equal to the stacked run's."""
    from repro_torch.launch import train as launch
    runs = {}
    for name, extra in (("stacked", []),
                        ("dev", ["--rank-devices", "cpu,cpu,cpu,cpu"])):
        args = launch.build_parser().parse_args(
            ["--device", "cpu", "--scale", "tiny", "--steps", "3",
             "--global-batch", "8", "--seq", "16", "--mesh", "2x2",
             "--fsdp", "--collective-backend", "user", "--chaos-kill", "1",
             "--chaos-kill-step", "1", "--heartbeat-timeout", "60",
             "--ckpt-dir", str(tmp_path / name)] + extra)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            runs[name] = launch.run(args)
        assert out.getvalue().count(
            "remesh: 3 survivor(s) -> mesh {'data': 1, 'model': 2}") == 1
    a, b = runs["stacked"], runs["dev"]
    assert b.trainer.recoveries == 1 and b.reducer.remeshes == 1
    assert [m["loss"] for m in b.log] == [m["loss"] for m in a.log]
    assert len(b.log) == 3
    for s, t in zip(b.trainer.params, a.trainer.params):
        assert s.copies == 2 and len(s) == 2
        assert torch.equal(s.shards[0], t) and torch.equal(s.shards[1], t)
    assert [int(x) for x in b.trainer.opt_state.step] == [3, 3]


# ---------------------------------------------------------------------------
# FSDP with a device per rank: the chaos runs against a restart
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("when", ["after_step", "mid_reduce_scatter"])
def test_chaos_fsdp_per_device_matches_restart_bitwise(tmp_path, when):
    """FSDP on a mesh with a device per rank (``["cpu"] * 4``): 2 of 4
    ranks killed after step KILL-1 (``after_step``), or while step KILL's
    reduce-scatter is in flight (``mid_reduce_scatter``: the start fails
    with a MembershipError, the step is retried).  The trainer re-shards
    params, moments and step counters onto the first 2 devices; the
    losses and parameters equal the rank-stacked restart's (KILL steps on
    4 ranks, the rest on 2) bit for bit."""
    red, layout = _chaos_fsdp_per_device(tmp_path, when, (4, 1), 2)
    assert red.mesh.devices == make_mesh(
        (4, 1), ("data", "model"), devices=["cpu"] * 4).devices[:2]
    assert layout.n == 2


@pytest.mark.parametrize("when", ["after_step", "mid_reduce_scatter"])
def test_chaos_fsdp_on_a_model_axis_per_device_matches_restart(tmp_path,
                                                                when):
    """FSDP on a 2x2 mesh with a device per rank (a copy of each data
    rank's blocks on both cards of its row): 1 of 4 ranks killed after
    step KILL-1 or mid reduce-scatter.  ``plan_mesh(3, prefer_model=2)``
    gives (1, 2): the launcher's ``fsdp_remesh`` puts one data row on the
    first two devices, the whole buckets on its leader and a copy on the
    other, the step counters carried; the losses and parameters equal the
    rank-stacked restart's (KILL steps on (2, 2), the rest on (1, 2)) bit
    for bit, and every copy its leader's."""
    red, layout = _chaos_fsdp_per_device(tmp_path, when, (2, 2), 3)
    assert dict(red.mesh.shape) == {"data": 1, "model": 1}
    assert layout.n == 1


def _chaos_fsdp_per_device(tmp_path, when, shape, survivors):
    """The chaos run on a per-device ``shape`` mesh against the stacked
    restart (``test_chaos_fsdp_per_device_matches_restart_bitwise``), the
    remesh as the launcher's (``fsdp_remesh``, ``prefer_model`` the model
    dim): the reducer and the survivors' layout."""
    from repro_torch.collectives.overlap import FsdpReducer
    from repro_torch.collectives.rank_shards import RankShards
    from repro_torch.launch.train import build_fsdp_programs, fsdp_remesh, \
        fsdp_state
    from repro_torch.train.train_loop import FsdpStep, Trainer
    cfg, ocfg, batches, params0 = _setup()
    spec = NB.CollectiveSpec(backend="user", chunks=2)
    D, M = shape
    mesh = make_mesh(shape, ("data", "model"), devices=["cpu"] * (D * M))

    def step_for(layout, mesh_, red):
        g, a, _, _ = build_fsdp_programs(cfg, ocfg, mesh_, layout)
        return FsdpStep(g, a, red, spec=spec)

    eng = ProgressEngine()
    epoch = NB.MembershipEpoch(mesh=mesh)
    red = FsdpReducer(mesh, "data", engine=eng, spec=spec, epoch=epoch)
    if when == "mid_reduce_scatter":
        start_rs, calls = red.ireduce_scatter, []

        def ireduce_scatter(flat_grads):
            reduction = start_rs(flat_grads)
            calls.append(1)
            if len(calls) == KILL + 1:          # step KILL's first attempt
                assert not reduction.is_complete
                epoch.invalidate(survivors=survivors, reason="chaos")
            return reduction
        red.ireduce_scatter = ireduce_scatter
    layout, shards, state = fsdp_state(params0, mesh, 1 << 16)
    assert isinstance(shards[0], RankShards) and shards[0].copies == M
    box = {"layout": layout}

    def remesh_fn(exc, shards_, st):
        new_mesh = elastic.remesh(exc.survivors, prefer_model=M,
                                  devices=mesh.devices[:exc.survivors])
        red.remesh(new_mesh, "data")
        box["layout"], sh2, st2 = fsdp_remesh(box["layout"], shards_, st,
                                              mesh, new_mesh, 1 << 16)
        box["mesh"] = new_mesh
        return step_for(box["layout"], new_mesh, red), sh2, st2

    losses = []
    tr = Trainer(None, shards, state, ListPipe(batches),
                 _loop_cfg(tmp_path, "a", STEPS), engine=eng,
                 split_step=step_for(layout, mesh, red), epoch=epoch,
                 remesh_fn=remesh_fn,
                 hooks=[_kill_hook(losses, epoch if when == "after_step"
                                   else None, survivors)])
    tr.run()
    red.close()
    assert tr.recoveries == 1 and red.remeshes == 1 and len(losses) == STEPS
    if when == "mid_reduce_scatter":
        assert red.coll.failed >= 1

    ref, final = _stacked_restart(tmp_path, shape, survivors, step_for)
    assert dict(box["mesh"].shape) == dict(elastic.remesh(
        survivors, prefer_model=M, device="cpu").shape)
    assert losses == ref
    for a, b in zip(tr.params, final):
        assert torch.equal(a.to_stacked("cpu"), b)
        for i, t in enumerate(a.shards):
            assert torch.equal(t, a.shards[i % len(a.blocks)])
    assert [int(s) for s in tr.opt_state.step] == [STEPS] * box["mesh"].size
    return red, box["layout"]


_RESTARTS: dict = {}


def _stacked_restart(tmp_path, shape, survivors, step_for):
    """KILL steps on a rank-stacked ``shape`` mesh, then the rest on the
    survivors' mesh (the model dim kept): the losses and final shard
    stacks.  Deterministic, so each is computed once in this module."""
    from repro_torch.collectives.overlap import FsdpReducer
    from repro_torch.train.train_loop import Trainer
    key = (shape, survivors)
    if key in _RESTARTS:
        return _RESTARTS[key]
    _, _, batches, params0 = _setup()
    spec = NB.CollectiveSpec(backend="user", chunks=2)
    ref = []
    meshA = make_mesh(shape, ("data", "model"), "cpu")
    engA = ProgressEngine()
    redA = FsdpReducer(meshA, "data", engine=engA, spec=spec)
    layA, shA, stA = _fsdp_state(params0, meshA)
    trA = Trainer(None, shA, stA, ListPipe(batches[:KILL]),
                  _loop_cfg(tmp_path, "b1", KILL), engine=engA,
                  split_step=step_for(layA, meshA, redA),
                  hooks=[_kill_hook(ref, None)])
    trA.run()
    redA.close()
    meshB = elastic.remesh(survivors, prefer_model=shape[1], device="cpu")
    engB = ProgressEngine()
    redB = FsdpReducer(meshB, "data", engine=engB, spec=spec)
    layB, shB, stB = _fsdp_state(
        layA.unshard_params(trA.params), meshB,
        layA.unshard_params(trA.opt_state.mu),
        layA.unshard_params(trA.opt_state.nu), trA.opt_state.step)
    trB = Trainer(None, shB, stB, ListPipe(batches[KILL:]),
                  _loop_cfg(tmp_path, "b2", STEPS - KILL), engine=engB,
                  split_step=step_for(layB, meshB, redB),
                  hooks=[_kill_hook(ref, None)])
    trB.run()
    redB.close()
    _RESTARTS[key] = ref, trB.params
    return _RESTARTS[key]
