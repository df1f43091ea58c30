"""Membership-aware recovery of the port's serving engine on the CPU.

* ``PagedKVCache.checkpoint_lane``/``restore_lane`` round trips into a
  pool whose block layout is shifted, for qwen2, mamba2 and zamba2 (the
  hybrid's pool: block-pooled K/V beside lane-indexed state); a JAX lane
  snapshot restores into the port's pool and decodes on as JAX does, and
  the port's snapshot restores into the JAX pool;
* a membership change fails the step, not the requests: mid decode
  (with KV migration), mid prefill and a watchdog-fired restart serve
  the no-failure streams — the port's and the JAX unsharded engine's —
  with one remesh, every request completed and none failed;
* a kill mid-gather on the user backend, down to 2 ranks and down to 1
  (the unsharded fallback), dense, mamba2 and zamba2 (whose decode
  state the failed step already advanced in place: their lanes replay);
* the launcher's ``--chaos-kill`` and its ``SystemExit``s;
* with a device per rank (``devices=["cpu"] * 4``, user backend): mid
  decode down to 2 ranks and to 1, and a kill mid gather, each serving
  the no-failure streams with the lanes restored into every survivor's
  pool replica; the launcher's ``--rank-devices`` with ``--chaos-kill``
  and its refusals.
"""
import contextlib
import dataclasses
import io
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduce_cfg
from repro.configs import get_config as jax_get_config
from repro.core import ProgressEngine as JaxProgressEngine
from repro.models import registry as jax_registry
from repro.serve.engine import GenRequest as JaxGenRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.kvcache import PagedKVCache as JaxPagedKVCache
from repro_torch.collectives import nonblocking as NB
from repro_torch.collectives.nonblocking import CollectiveSpec
from repro_torch.configs import get_config
from repro_torch.core import ProgressEngine
from repro_torch.distributed.fault_tolerance import StepWatchdog
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import bridge, registry
from repro_torch.serve.engine import GenRequest, ServeEngine
from repro_torch.serve.kvcache import (BlockAllocationError, PagedKVCache,
                                       to_device)

ARCHS = ("qwen2-0.5b", "mamba2-1.3b", "zamba2-1.2b")
# the lane snapshot's state keys, as jax.tree_util.keystr writes them
SSM_KEYS = {f"['{k}']" for k in ("conv_x", "conv_b", "conv_c", "h")}
HYBRID_SSM_KEYS = {f"['{t}']{k}" for t in ("ssm", "tail_ssm")
                   for k in SSM_KEYS}
SLOTS, MAX_SEQ, BLOCK = 3, 48, 4


def port_cfg(jcfg):
    return get_config(jcfg.name).with_overrides(
        **{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


@pytest.fixture(scope="module", params=ARCHS)
def tiny(request):
    jcfg = reduce_cfg(jax_get_config(request.param), dtype="float32")
    jparams = jax_registry.init_params(jcfg, jax.random.PRNGKey(0))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    return jcfg, jparams, port_cfg(jcfg), params


# ---------------------------------------------------------------------------
# lane checkpoint / restore
# ---------------------------------------------------------------------------

def feed(pool, decode, lane_index, toks, start, count):
    """Feed ``count`` tokens into one lane of ``pool`` from position
    ``start`` (the other lane idle), growing its table; the last call's
    logits."""
    fed = np.array([i == lane_index for i in range(2)])
    logits = None
    for t in range(start, start + count):
        assert pool.ensure(lane_index, t)
        pos = np.full((2,), t, np.int32)
        logits = decode(pool, toks[t], pos, fed)
        pool.slots[lane_index].pos = t + 1
    return logits


def port_decode(params, cfg):
    def run(pool, toks, pos, fed):
        out, pool.cache = registry.decode_step_paged(
            params, cfg, pool.cache, to_device(toks, pool.device),
            to_device(pos, pool.device), pool.block_tables(),
            to_device(fed, pool.device))
        return out.numpy()
    return run


def jax_decode(jparams, jcfg):
    step = jax.jit(lambda c, t, q, bt, f: jax_registry.decode_step_paged(
        jparams, jcfg, c, t, q, bt, f))

    def run(pool, toks, pos, fed):
        out, pool.cache = step(pool.cache, jnp.asarray(toks), jnp.asarray(pos),
                               jnp.asarray(pool.block_tables()),
                               jnp.asarray(fed))
        return np.asarray(out)
    return run


def tokens(cfg, n=10, seed=2):
    rs = np.random.RandomState(seed)
    return [np.full((2, 1), rs.randint(1, cfg.vocab_size), np.int32)
            for _ in range(n)]


def test_lane_round_trip_into_a_shifted_pool(tiny):
    """Checkpoint a lane after 6 tokens, restore it into a fresh pool
    whose block layout is shifted, decode 4 more: the logits equal the
    uninterrupted decode's bit for bit, and a second checkpoint equals
    the first."""
    _, _, cfg, params = tiny
    dec = port_decode(params, cfg)
    toks = tokens(cfg)
    pool = PagedKVCache(cfg, 2, 32, block_size=BLOCK, device="cpu")
    lane = pool.assign("req", seq_len=1)
    feed(pool, dec, lane.index, toks, 0, 6)
    ckpt = pool.checkpoint_lane(lane.index)
    assert ckpt["pos"] == 6
    assert all(isinstance(a, np.ndarray)
               for part in ("blocks", "state") for a in ckpt[part].values())
    if cfg.family == "hybrid":
        assert set(ckpt["blocks"]) == {"['attn_k']", "['attn_v']"}
        assert set(ckpt["state"]) == HYBRID_SSM_KEYS
        assert ckpt["blocks"]["['attn_k']"].shape[1] == 2  # ceil(6 / 4)
    elif pool.has_blocks:
        assert set(ckpt["blocks"]) == {"['k']", "['v']"} and not ckpt["state"]
        assert ckpt["blocks"]["['k']"].shape[1] == 2       # ceil(6 / 4)
    else:
        assert not ckpt["blocks"] and set(ckpt["state"]) == SSM_KEYS
    pool2 = PagedKVCache(cfg, 2, 32, block_size=BLOCK, device="cpu")
    pool2.assign("other", seq_len=9)                   # shift the layout
    lane2 = pool2.assign("req", seq_len=7)
    pool2.restore_lane(pool2.cache, lane2.index, ckpt)
    assert pool2.slots[lane2.index].pos == 6
    if pool.has_blocks:
        assert (pool2.block_tables()[lane2.index, :2].tolist()
                != pool.block_tables()[lane.index, :2].tolist())
    ckpt2 = pool2.checkpoint_lane(lane2.index)
    for part in ("blocks", "state"):
        assert ckpt2[part].keys() == ckpt[part].keys()
        for k in ckpt[part]:
            np.testing.assert_array_equal(ckpt2[part][k], ckpt[part][k])
    want = feed(pool, dec, lane.index, toks, 6, 4)
    got = feed(pool2, dec, lane2.index, toks, 6, 4)
    np.testing.assert_array_equal(got[lane2.index], want[lane.index])
    # a free lane, and a lane whose table cannot hold the prefix, refuse
    fresh = PagedKVCache(cfg, 2, 32, block_size=BLOCK, device="cpu")
    for fn in (lambda: fresh.checkpoint_lane(0),
               lambda: fresh.restore_lane(fresh.cache, 0, ckpt)):
        with pytest.raises(BlockAllocationError, match="is free"):
            fn()
    if pool.has_blocks:
        lane3 = fresh.assign("req", seq_len=1)
        with pytest.raises(BlockAllocationError, match="too few blocks"):
            fresh.restore_lane(fresh.cache, lane3.index, ckpt)


def test_jax_and_port_snapshots_restore_into_each_other(tiny):
    """A JAX lane snapshot restores into the port's pool, and the port's
    into the JAX pool; each then decodes on as the other does."""
    jcfg, jparams, cfg, params = tiny
    dec, jdec = port_decode(params, cfg), jax_decode(jparams, jcfg)
    toks = tokens(cfg)
    jpool = JaxPagedKVCache(jcfg, 2, 32, block_size=BLOCK)
    jlane = jpool.assign("req", seq_len=1)
    feed(jpool, jdec, jlane.index, toks, 0, 6)
    jckpt = jpool.checkpoint_lane(jlane.index)
    pool = PagedKVCache(cfg, 2, 32, block_size=BLOCK, device="cpu")
    pool.assign("other", seq_len=5)
    lane = pool.assign("req", seq_len=7)
    pool.restore_lane(pool.cache, lane.index, jckpt)
    # the port's snapshot of the restored lane is the JAX snapshot
    ckpt = pool.checkpoint_lane(lane.index)
    for part in ("blocks", "state"):
        assert ckpt[part].keys() == jckpt[part].keys()
        for k in jckpt[part]:
            np.testing.assert_array_equal(ckpt[part][k], jckpt[part][k])
    jpool2 = JaxPagedKVCache(jcfg, 2, 32, block_size=BLOCK)
    jpool2.assign("other", seq_len=9)
    jlane2 = jpool2.assign("req", seq_len=7)
    jpool2.cache = jpool2.restore_lane(jpool2.cache, jlane2.index, ckpt)
    want = feed(jpool, jdec, jlane.index, toks, 6, 4)[jlane.index]
    got = feed(pool, dec, lane.index, toks, 6, 4)[lane.index]
    back = feed(jpool2, jdec, jlane2.index, toks, 6, 4)[jlane2.index]
    # XLA's and PyTorch's CPU f32 sums differ in order; the lanes differ
    # between the pools, which moves XLA's last bits too
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(back, want, atol=1e-5, rtol=1e-5)
    assert np.argmax(got[-1]) == np.argmax(want[-1]) == np.argmax(back[-1])


# ---------------------------------------------------------------------------
# chaos: a membership change mid-flight; every request completes, exact
# ---------------------------------------------------------------------------

def chaos_prompts(cfg):
    rs = np.random.RandomState(4)
    return [rs.randint(1, cfg.vocab_size - 1,
                       size=rs.randint(4, 12)).astype(np.int32)
            for _ in range(8)]


KW = dict(batch_slots=SLOTS, max_seq=MAX_SEQ, kv_block_size=BLOCK,
          prefill_chunk=2)


@pytest.fixture(scope="module")
def streams(tiny):
    """The JAX unsharded engine's streams (one run) and the port's
    no-failure run, which must equal them."""
    jcfg, jparams, cfg, params = tiny
    ps = chaos_prompts(cfg)
    jsrv = JaxServeEngine(jcfg, jparams, JaxProgressEngine(), **KW)
    jreqs = [JaxGenRequest(f"r{i}", p, max_new_tokens=8)
             for i, p in enumerate(ps)]
    for r in jreqs:
        jsrv.submit(r)
    jsrv.run_until_idle(timeout=300)
    jsrv.close(timeout=60)
    want = [list(r.out_tokens) for r in jreqs]
    got, lat, srv = chaos_serve(cfg, params, ps)
    assert got == want and lat.completed == 8 and srv.remeshes == 0
    return cfg, params, ps, want


def chaos_serve(cfg, params, ps, *, kill=None, survivors=1, n=None,
                backend="native", watchdog=False, per_device=False):
    """Serve ``ps``; ``kill(srv, reqs)`` says when to invalidate the
    shared epoch (polled as the caller drives progress).  ``per_device``:
    the n ranks on a mesh of ``["cpu"] * n``."""
    eng = ProgressEngine()
    epoch = NB.MembershipEpoch(n_devices=n or 1)
    mesh = None
    if n and per_device:
        mesh = make_mesh((n,), ("model",), devices=["cpu"] * n)
    elif n:
        mesh = make_mesh((n,), ("model",), "cpu")
    srv = ServeEngine(cfg, params, eng, mesh=mesh,
                      device=None if per_device else "cpu", epoch=epoch,
                      collective_spec=CollectiveSpec(backend=backend,
                                                     chunks=2), **KW)
    reqs = [GenRequest(f"r{i}", p, max_new_tokens=8)
            for i, p in enumerate(ps)]
    for r in reqs:
        srv.submit(r)
    if kill is not None:
        t0 = time.monotonic()
        while not kill(srv, reqs):
            eng.progress()
            assert time.monotonic() - t0 < 120
        if watchdog:
            clock = {"t": 0.0}
            wd = StepWatchdog(eng, limit=10.0, clock=lambda: clock["t"],
                              epoch=epoch)
            wd.arm()
            clock["t"] = 11.0
            eng.progress()                   # fires: the epoch is invalidated
            assert wd.fired == 1 and epoch.invalidations == 1
        else:
            epoch.invalidate(survivors=survivors, reason="chaos")
    srv.run_until_idle(timeout=300)
    lat = srv.latency_snapshot()
    srv.close(timeout=60)
    return [list(r.out_tokens) for r in reqs], lat, srv


def tokens_out(k):
    return lambda srv, reqs: sum(len(r.out_tokens) for r in reqs) >= k


def mid_prefill(srv, reqs):
    """Lanes are mid-prefill (a chunk of 2 calls ran) and no token is out."""
    assert not any(r.out_tokens for r in reqs)
    return srv.sched.prefill_calls >= 2 and bool(srv._prefilling)


@pytest.mark.parametrize("case", ["mid_decode", "mid_prefill", "watchdog"])
def test_membership_change_keeps_every_request(streams, case):
    cfg, params, ps, want = streams
    kill = {"mid_decode": tokens_out(5), "mid_prefill": mid_prefill,
            "watchdog": tokens_out(2)}[case]
    got, lat, srv = chaos_serve(cfg, params, ps, kill=kill,
                                watchdog=case == "watchdog")
    assert got == want
    assert srv.remeshes == 1 and len(srv.recovery_s) == 1
    assert lat.completed == 8 and lat.failed == 0
    if case == "mid_decode":
        # decoding lanes migrated their KV (or state) instead of replaying
        assert srv.lanes_restored == srv.lanes_checkpointed > 0


@pytest.mark.parametrize("survivors", [2, 1])
def test_kill_mid_gather_on_the_user_backend(streams, survivors):
    """The epoch is invalidated with a gather start in flight: the start
    fails with a MembershipError, the step fails, not its requests; the
    engine rebuilds on 2 model ranks, or serves unsharded on 1.  Mamba2
    and zamba2 lanes, whose state the failed step already advanced in
    place, replay; dense lanes restore their KV."""
    cfg, params, ps, want = streams

    def in_flight(srv, reqs):
        h = srv._ag_handle
        return (sum(len(r.out_tokens) for r in reqs) >= 5 and h is not None
                and h.active is not None and not h.active.is_complete)

    got, lat, srv = chaos_serve(cfg, params, ps, kill=in_flight, n=4,
                                backend="user", survivors=survivors)
    assert got == want
    assert srv.remeshes == 1 and lat.completed == 8 and lat.failed == 0
    assert any(isinstance(e, NB.MembershipError) for e in srv.decode_errors)
    assert srv._model_shards == survivors and srv._sharded == (survivors > 1)
    if cfg.family in ("ssm", "hybrid"):
        assert srv.lanes_checkpointed == srv.lanes_restored == 0
    else:
        assert srv.lanes_restored == srv.lanes_checkpointed > 0


def gather_in_flight(srv, reqs):
    h = srv._ag_handle
    return (sum(len(r.out_tokens) for r in reqs) >= 5 and h is not None
            and h.active is not None and not h.active.is_complete)


@pytest.mark.parametrize("tiny", ["qwen2-0.5b", "mamba2-1.3b"],
                         indirect=True)
@pytest.mark.parametrize("case", ["mid_decode_2", "mid_decode_1",
                                  "mid_gather_2"])
def test_per_device_recovery_restores_every_survivor(streams, case):
    """4 model ranks on ``["cpu"] * 4`` (mid decode on the native
    gather, mid gather on the user one): the no-failure streams with one
    remesh, every request completed; the survivors' mesh
    takes the first devices (a lone survivor serves unsharded on the
    first); decoding lanes restored (not replayed, except the state the
    failed gather step advanced in place) into every survivor's pool
    replica, which end equal."""
    from repro_torch.collectives.rank_shards import RankShards
    from repro_torch.models.layers import tree_leaves
    cfg, params, ps, want = streams
    survivors = int(case[-1])
    gather = case.startswith("mid_gather")
    got, lat, srv = chaos_serve(
        cfg, params, ps, kill=gather_in_flight if gather else tokens_out(5),
        n=4, backend="user" if gather else "native", survivors=survivors,
        per_device=True)
    assert got == want
    assert srv.remeshes == 1 and lat.completed == 8 and lat.failed == 0
    assert srv._model_shards == survivors
    if gather:
        assert any(isinstance(e, NB.MembershipError)
                   for e in srv.decode_errors)
    if gather and cfg.family in ("ssm", "hybrid"):
        assert srv.lanes_checkpointed == srv.lanes_restored == 0
    else:
        assert srv.lanes_restored == srv.lanes_checkpointed > 0
    if survivors == 1:
        assert srv.mesh is None and srv.slots.devices is None
        assert not any(isinstance(t, RankShards)
                       for _, t in tree_leaves(srv.params))
        return
    assert srv.mesh.devices == (torch.device("cpu"),) * 2
    for path, leaf in tree_leaves(srv.slots.cache):
        assert isinstance(leaf, RankShards) and len(leaf) == 2, path
        assert torch.equal(leaf[0], leaf[1]), path


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def launch(argv):
    from repro_torch.launch import serve
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert serve.main(argv) == 0
    return out.getvalue()


def test_launcher_chaos_kill_remeshes_once():
    text = launch(["--device", "cpu", "--scale", "tiny", "--devices", "4",
                   "--model-shards", "4", "--collective-backend", "user",
                   "--chaos-kill", "2"])
    lines = [ln for ln in text.splitlines() if "remeshes=1" in ln]
    assert len(lines) == 1, text
    assert lines[0].startswith("chaos: killed 2 device(s) -> 2 survivors")
    assert "served 8 requests, 64 tokens" in text
    assert "model-shards=4 backend=user" in text
    assert "8 completed, 0 failed" in text


def test_launcher_rank_devices_chaos_kill_remeshes_once():
    """``--model-shards 4 --rank-devices cpu,cpu,cpu,cpu --chaos-kill 2``
    on both backends: one remesh, every request served, the same
    streams (the stacked launcher's chaos run is
    ``test_launcher_chaos_kill_remeshes_once``)."""
    from repro_torch.launch import serve
    base = ["--device", "cpu", "--scale", "tiny", "--model-shards", "4",
            "--chaos-kill", "2", "--rank-devices", "cpu,cpu,cpu,cpu"]
    runs = {}
    for name, extra in (("user", ["--collective-backend", "user"]),
                        ("native", [])):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            report = serve.run(serve.build_parser().parse_args(base + extra))
        lines = [ln for ln in out.getvalue().splitlines()
                 if "remeshes=1" in ln]
        assert len(lines) == 1 and lines[0].startswith(
            "chaos: killed 2 device(s) -> 2 survivors"), out.getvalue()
        assert report.latency.completed == 8 and report.latency.failed == 0
        runs[name] = [list(r.out_tokens) for r in report.requests]
    assert runs["user"] == runs["native"]
    assert sum(map(len, runs["user"])) == 64


def test_launcher_rank_devices_refusals():
    from repro_torch.launch import serve
    for argv, match in (
            (["--model-shards", "4", "--rank-devices", "cpu,cpu"],
             "names 2 device.s. for --model-shards 4"),
            (["--model-shards", "2", "--devices", "4", "--rank-devices",
              "cpu,cpu"], "--devices 4"),
            (["--model-shards", "2", "--rank-devices", "cpu,cuda:9"],
             "--rank-devices: mesh device cuda:9")):
        args = serve.build_parser().parse_args(["--device", "cpu"] + argv)
        with pytest.raises(SystemExit, match=match):
            serve.run(args)


def test_launcher_refuses_what_jax_refuses():
    from repro_torch.launch import serve
    for argv, match in (
            (["--collective-backend", "user"], "requires --model-shards"),
            (["--model-shards", "2"], "--model-shards 2 > 1 devices"),
            (["--devices", "2", "--model-shards", "4"], "4 > 2 devices")):
        args = serve.build_parser().parse_args(["--device", "cpu"] + argv)
        with pytest.raises(SystemExit, match=match):
            serve.run(args)


def test_launcher_cache_mode_as_jax(monkeypatch):
    """``--cache-mode``: ``paged`` (the default) serves as without the
    flag; ``slots`` exits with the JAX launcher's own message."""
    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve
    text = launch(["--device", "cpu", "--scale", "tiny", "--requests", "2",
                   "--max-new", "2", "--cache-mode", "paged"])
    assert "served 2 requests, 4 tokens" in text
    assert serve.build_parser().parse_args([]).cache_mode == "paged"
    monkeypatch.setattr("sys.argv", ["serve", "--cache-mode", "slots"])
    with pytest.raises(SystemExit) as want:
        jax_serve.main()
    args = serve.build_parser().parse_args(["--device", "cpu",
                                            "--cache-mode", "slots"])
    with pytest.raises(SystemExit) as got:
        serve.run(args)
    assert "--cache-mode slots was retired" in str(got.value)
    assert str(got.value) == str(want.value)
