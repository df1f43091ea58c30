"""The port's training slice against the JAX package on the CPU: AdamW,
the synthetic data stream, the checkpoint layout, the monitors, and the
trainer as a whole (the same 10-step loss trajectory from the same
bridged state and data), all in f32 with numpy-made inputs."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduce_cfg
from repro.configs import get_config as jax_get_config
from repro.core import ProgressEngine as JaxEngine
from repro.data.pipeline import PrefetchPipeline as JaxPrefetch
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models import registry as jax_registry
from repro.train import optimizer as jax_opt
from repro.train.checkpoint import AsyncCheckpointer as JaxCheckpointer
from repro.train.train_loop import Trainer as JaxTrainer
from repro.train.train_loop import TrainLoopConfig as JaxLoopConfig
from repro_torch.configs import get_config
from repro_torch.core import ProgressEngine
from repro_torch.data.pipeline import PrefetchPipeline, SyntheticLM
from repro_torch.distributed.fault_tolerance import (StepWatchdog,
                                                     StragglerDetector)
from repro_torch.launch import train as train_launch
from repro_torch.models import bridge
from repro_torch.models.layers import tree_leaves
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import AsyncCheckpointer
from repro_torch.train.train_loop import Trainer, TrainLoopConfig


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_adamw_apply_matches_jax():
    """Eight steps on identical gradients: warmup, cosine decay, past
    total_steps, bias correction, decay, and clipping (the gradients'
    norm is ~8 against clip_norm 0.5).  In place on the port's side."""
    ocfg = dict(lr=1e-2, warmup_steps=3, total_steps=6, clip_norm=0.5,
                weight_decay=0.1)
    rs = np.random.RandomState(0)
    p0 = {"a": {"w": rs.randn(5, 7).astype(np.float32)},
          "b": rs.randn(11).astype(np.float32)}
    jparams = jax.tree.map(jnp.asarray, p0)
    jstate = jax_opt.init(jparams)
    params = bridge.params_from_numpy(p0, device="cpu")
    state = opt.init(params)
    for _ in range(8):
        g = {"a": {"w": rs.randn(5, 7).astype(np.float32)},
             "b": rs.randn(11).astype(np.float32) * 3}
        jparams, jstate, jm = jax_opt.apply(
            jax_opt.AdamWConfig(**ocfg), jstate, jparams,
            jax.tree.map(jnp.asarray, g))
        same = params
        params, state, m = opt.apply(opt.AdamWConfig(**ocfg), state, params,
                                     bridge.params_from_numpy(g, "cpu"))
        assert params is same                   # updated in place
        assert int(state.step) == int(jstate.step)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-6, atol=1e-6)
        for ours, theirs in ((params, jparams), (state.mu, jstate.mu),
                             (state.nu, jstate.nu)):
            for (_, t), j in zip(tree_leaves(ours), jax.tree.leaves(theirs)):
                np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                           rtol=1e-6, atol=1e-6)


def test_opt_state_bridge():
    rs = np.random.RandomState(1)
    p = {"w": rs.randn(3, 2).astype(np.float32)}
    jstate = jax_opt.AdamWState(jnp.asarray(7, jnp.int32),
                                {"w": jnp.asarray(p["w"])},
                                {"w": jnp.asarray(p["w"] ** 2)})
    state = bridge.opt_state_from_numpy(np_tree(jstate), device="cpu")
    assert isinstance(state, opt.AdamWState)
    assert state.step.dtype == torch.int32 and int(state.step) == 7
    np.testing.assert_array_equal(state.nu["w"].numpy(), p["w"] ** 2)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shard", [0, 1])
def test_synthetic_lm_same_stream_as_jax(shard):
    ours = SyntheticLM(100, 16, 4, seed=3, shard=shard, num_shards=2)
    theirs = JaxSyntheticLM(100, 16, 4, seed=3, shard=shard, num_shards=2)
    for _ in range(3):
        a, b = ours.sample(), theirs.sample()
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(a[key], b[key])


def test_prefetch_fills_through_progress():
    eng = ProgressEngine()
    pipe = PrefetchPipeline(SyntheticLM(50, 8, 2), eng, depth=3)
    for _ in range(100000):
        if pipe.fills >= 3:
            break
        eng.progress()
    assert pipe.fills >= 3
    stalls = pipe.stalls
    assert pipe.next_batch()["tokens"].shape == (2, 8)
    assert pipe.stalls == stalls                 # a warm buffer: no stall
    pipe.close()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _small_state(seed):
    rs = np.random.RandomState(seed)
    p = {"embed": rs.randn(6, 4).astype(np.float32),
         "layers": {"ln1": rs.randn(2, 4).astype(np.float32)}}
    return p, jax_opt.AdamWState(jnp.asarray(seed, jnp.int32),
                                 jax.tree.map(lambda a: jnp.asarray(a * 2), p),
                                 jax.tree.map(lambda a: jnp.asarray(a * 3), p))


def test_checkpoint_layout_crosses_both_ways(tmp_path):
    """A tree the JAX checkpointer wrote restores in the port, and the
    other way round: the same file names, manifest and arrays."""
    p, jstate = _small_state(4)
    jtree = {"params": jax.tree.map(jnp.asarray, p), "opt_state": jstate}
    jeng = JaxEngine()
    JaxCheckpointer(str(tmp_path / "jax"), jeng).save_blocking(4, jtree)

    zeros = bridge.params_from_numpy(jax.tree.map(np.zeros_like, p), "cpu")
    like = {"params": zeros, "opt_state": opt.init(zeros)}
    ck = AsyncCheckpointer(str(tmp_path / "jax"), ProgressEngine())
    assert ck.latest_step() == 4
    got = ck.restore(4, like, device="cpu")
    assert int(got["opt_state"].step) == 4
    np.testing.assert_array_equal(got["params"]["embed"].numpy(), p["embed"])
    np.testing.assert_array_equal(got["opt_state"].nu["layers"]["ln1"].numpy(),
                                  p["layers"]["ln1"] * 3)

    eng = ProgressEngine()
    AsyncCheckpointer(str(tmp_path / "torch"), eng).save_blocking(4, got)
    for d in ("jax", "torch"):
        with open(tmp_path / d / "step_4" / "manifest.json") as f:
            man = json.load(f)
        assert man["step"] == 4
    assert sorted(os.listdir(tmp_path / "jax" / "step_4")) == \
        sorted(os.listdir(tmp_path / "torch" / "step_4"))
    back = JaxCheckpointer(str(tmp_path / "torch"), jeng).restore(4, jtree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_inplace_update_after_save_does_not_leak(tmp_path):
    """The optimizer updates params in place right after save_async: the
    saved step holds the values at the time of the call."""
    params = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4)}
    want = params["w"].clone()
    eng = ProgressEngine()
    ck = AsyncCheckpointer(str(tmp_path), eng)
    req = ck.save_async(0, {"params": params})
    params["w"].add_(100.0)                      # the next step, in place
    eng.wait(req, timeout=60)
    got = ck.restore(0, {"params": params})
    torch.testing.assert_close(got["params"]["w"], want)
    assert ck.last_save_s is not None and ck.last_save_s >= 0


def test_checkpoint_keeps_bf16_leaves(tmp_path):
    t = torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16)
    eng = ProgressEngine()
    ck = AsyncCheckpointer(str(tmp_path), eng, keep=1)
    ck.save_blocking(1, {"x": t})
    ck.save_blocking(2, {"x": t * 2})
    assert ck.latest_step() == 2 and not (tmp_path / "step_1").exists()
    got = ck.restore(2, {"x": t})["x"]
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, t * 2)


# ---------------------------------------------------------------------------
# monitors (tests/test_data_and_ft.py:87-136)
# ---------------------------------------------------------------------------

def test_straggler_detector():
    d = StragglerDetector(threshold=1.5)
    for _ in range(10):
        assert not d.record("chip0", 1.0)
    assert d.record("chip7", 2.0)           # 2x the EWMA
    assert not d.record("chip0", 1.05)
    assert d.flagged == {"chip7": 1}
    d = StragglerDetector(threshold=1.5)
    for _ in range(5):
        d.record("ok", 1.0)
    for _ in range(3):
        d.record("bad", 3.0)
    assert d.persistent_stragglers(min_count=3) == ["bad"]
    d = StragglerDetector(threshold=1.5)
    for _ in range(5):
        d.record("a", 1.0)
    d.record("a", 100.0)                    # huge outlier
    assert d.ewma < 1.5                     # mean unaffected


def test_step_watchdog_fires_and_disarms():
    eng = ProgressEngine()
    clock = {"t": 0.0}
    hangs = []
    wd = StepWatchdog(eng, limit=30.0, on_hang=lambda: hangs.append(1),
                      clock=lambda: clock["t"])
    wd.arm()
    clock["t"] = 10.0
    eng.progress()
    assert hangs == []
    clock["t"] = 31.0
    eng.progress()
    assert hangs == [1] and wd.fired == 1
    eng.progress()
    assert hangs == [1]                     # one-shot per arm
    wd.arm()
    wd.disarm()
    clock["t"] = 100.0
    eng.progress()
    assert wd.fired == 1


# ---------------------------------------------------------------------------
# the slice as a whole: the trainer
# ---------------------------------------------------------------------------

OCFG = dict(lr=1e-2, warmup_steps=2, total_steps=50)


def _tiny_cfgs():
    """tests/test_train_and_serve.py::tiny_setup's config, in f32."""
    jcfg = reduce_cfg(jax_get_config("smollm-360m"), num_layers=2,
                      d_model=32, d_ff=64, vocab_size=64, dtype="float32")
    return jcfg, get_config("smollm-360m").with_overrides(
        **{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})


def _jax_losses(tmp_path, jcfg, jparams, steps=10):
    ocfg = jax_opt.AdamWConfig(**OCFG)

    @jax.jit
    def step_fn(params, opt_state, batch):
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        (loss, aux), grads = jax.value_and_grad(
            lambda p: jax_registry.loss_fn(p, jcfg, batch), has_aux=True)(
            params)
        params, opt_state, om = jax_opt.apply(ocfg, opt_state, params, grads)
        return params, opt_state, dict(loss=loss, **om)

    eng = JaxEngine()
    pipe = JaxPrefetch(JaxSyntheticLM(64, 16, 4, seed=3), eng, depth=2)
    tl = JaxLoopConfig(total_steps=steps, checkpoint_every=100,
                       checkpoint_dir=str(tmp_path / "jax"), log_every=1)
    log = JaxTrainer(step_fn, jparams, jax_opt.init(jparams), pipe, tl,
                     engine=eng).run()
    pipe.close()
    return [m["loss"] for m in log]


def _port_trainer(tmp_path, cfg, params, opt_state, steps=10, **loop):
    train_step = train_launch.make_train_step(cfg, opt.AdamWConfig(**OCFG))

    def step_fn(params, opt_state, batch):
        return train_step(params, opt_state,
                          {k: torch.from_numpy(v) for k, v in batch.items()})

    eng = ProgressEngine()
    pipe = PrefetchPipeline(SyntheticLM(64, 16, 4, seed=3), eng, depth=2)
    tl = TrainLoopConfig(**{"total_steps": steps, "checkpoint_every": 100,
                            "checkpoint_dir": str(tmp_path / "torch"),
                            "log_every": 1, **loop})
    return Trainer(step_fn, params, opt_state, pipe, tl, engine=eng), pipe


def _run(trainer, pipe):
    try:
        return trainer.run()
    finally:
        pipe.close()


def test_trainer_matches_jax_trainer(tmp_path):
    """From the same bridged params and optimizer state, on the same
    SyntheticLM stream, the port's Trainer gives the JAX Trainer's 10-step
    loss trajectory within 1e-4 (f32)."""
    jcfg, cfg = _tiny_cfgs()
    jparams = jax_registry.init_params(jcfg, jax.random.PRNGKey(0))
    want = _jax_losses(tmp_path, jcfg, jparams)
    params = bridge.params_from_numpy(np_tree(jparams), device="cpu")
    state = bridge.opt_state_from_numpy(np_tree(jax_opt.init(jparams)),
                                        device="cpu")
    log = _run(*_port_trainer(tmp_path, cfg, params, state))
    assert [m["step"] for m in log] == list(range(10))
    np.testing.assert_allclose([m["loss"] for m in log], want,
                               atol=1e-4, rtol=1e-4)
    assert log[-1]["loss"] < log[0]["loss"]


def test_trainer_resumes_at_the_next_step(tmp_path):
    jcfg, cfg = _tiny_cfgs()
    jparams = jax_registry.init_params(jcfg, jax.random.PRNGKey(0))

    def fresh():
        p = bridge.params_from_numpy(np_tree(jparams), device="cpu")
        return p, opt.init(p)

    tr, pipe = _port_trainer(tmp_path, cfg, *fresh(), steps=4,
                             checkpoint_every=3)
    _run(tr, pipe)
    assert tr.ckpt.latest_step() == 3
    tr2, pipe2 = _port_trainer(tmp_path, cfg, *fresh(), steps=6,
                               checkpoint_every=3)
    log = _run(tr2, pipe2)
    assert tr2.start_step == 4
    assert [m["step"] for m in log] == [4, 5]
    assert int(tr2.opt_state.step) == 6


def test_trainer_with_progress_workers_trains_the_same(tmp_path):
    jcfg, cfg = _tiny_cfgs()
    jparams = jax_registry.init_params(jcfg, jax.random.PRNGKey(0))
    logs = []
    for workers in (0, 2):
        p = bridge.params_from_numpy(np_tree(jparams), device="cpu")
        tr, pipe = _port_trainer(tmp_path / f"w{workers}", cfg, p,
                                 opt.init(p), steps=5,
                                 progress_workers=workers)
        logs.append([m["loss"] for m in _run(tr, pipe)])
        assert tr.ckpt.latest_step() == 4
    assert logs[0] == logs[1]


def test_trainer_refuses_split_steps(tmp_path):
    """The Trainer refuses a "user" backend without a split step; it takes
    both split steps (``UserCollectiveStep``, see test_torch_dp_train.py;
    ``FsdpStep``, see test_torch_fsdp.py), a membership epoch and a
    ``remesh_fn`` (test_torch_elastic.py), its config following the
    split step's backend."""
    from repro_torch.collectives.nonblocking import CollectiveSpec, \
        MembershipEpoch
    from repro_torch.train.train_loop import FsdpStep
    cfg = TrainLoopConfig(checkpoint_dir=str(tmp_path))
    user = TrainLoopConfig(checkpoint_dir=str(tmp_path),
                           collective_spec=CollectiveSpec(backend="user"))
    with pytest.raises(ValueError, match="requires a split_step"):
        Trainer(None, {}, None, None, user, engine=ProgressEngine())
    epoch = MembershipEpoch(n_devices=4)
    tr = Trainer(None, {}, None, None, cfg, engine=ProgressEngine(),
                 split_step=FsdpStep(None, None, None), epoch=epoch,
                 remesh_fn=lambda *a: None)
    assert tr.cfg.collective_backend == "user" and tr.recoveries == 0
    assert tr.watchdog.epoch is epoch


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_microbatches_average_to_the_full_batch():
    jcfg, cfg = _tiny_cfgs()
    jparams = np_tree(jax_registry.init_params(jcfg, jax.random.PRNGKey(2)))
    batch = {k: torch.from_numpy(v)
             for k, v in SyntheticLM(64, 16, 4, seed=1).sample().items()}
    out = []
    for mb in (1, 2):
        p = bridge.params_from_numpy(jparams, device="cpu")
        step = train_launch.make_train_step(cfg, opt.AdamWConfig(**OCFG),
                                            microbatches=mb)
        p, state, m = step(p, opt.init(p), batch)
        out.append((p, m))
    np.testing.assert_allclose(float(out[0][1]["loss"]),
                               float(out[1][1]["loss"]), rtol=1e-5)
    for (_, a), (_, b) in zip(tree_leaves(out[0][0]), tree_leaves(out[1][0])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-5, rtol=1e-5)


def test_launcher_refuses_the_card_without_cuda(tmp_path):
    """The launcher's default device is the card: on a box without CUDA
    it raises instead of training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA: the refusal is for CPU-only boxes")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_launch.main(["--scale", "tiny", "--steps", "1",
                           "--ckpt-dir", str(tmp_path)])


def test_launcher_trains_on_the_cpu_and_resumes(tmp_path, capsys):
    argv = ["--device", "cpu", "--scale", "tiny", "--steps", "3", "--seq",
            "16", "--global-batch", "4", "--microbatches", "2",
            "--cast-bf16", "--ckpt-dir", str(tmp_path)]
    assert train_launch.main(argv) == 0
    assert "final loss" in capsys.readouterr().out
    report = train_launch.run(train_launch.build_parser().parse_args(
        argv[:5] + ["5"] + argv[6:]), log_every=1)
    assert [m["step"] for m in report.log] == [3, 4]
    assert all(np.isfinite(m["loss"]) for m in report.log)


@pytest.mark.parametrize("remat,mb", [("none", 1), ("full", 1), ("full", 2)])
def test_kernel_launches_per_step_as_derived(monkeypatch, remat, mb):
    """The per-step launch counts chip_smoke.py asserts on the card, held
    here against the calls the CPU path makes to each kernel's plain
    version (ops dispatches to exactly one of the two per launch)."""
    from repro_torch.kernels import ops
    calls = {"rmsnorm_fwd": 0, "rmsnorm_bwd": 0, "flash_attention": 0,
             "flash_decode": 0, "ssd_chunk": 0}

    def counting(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    for name, attr in (("rmsnorm_fwd", "rmsnorm_fwd_plain"),
                       ("rmsnorm_bwd", "rmsnorm_bwd_plain"),
                       ("flash_attention", "flash_attention_plain"),
                       ("flash_decode", "flash_decode_plain"),
                       ("ssd_chunk", "ssd_chunk_plain")):
        monkeypatch.setattr(ops, attr, counting(name, getattr(ops, attr)))
    _, cfg = _tiny_cfgs()
    cfg = cfg.with_overrides(remat_policy=remat, num_layers=3)
    params = bridge.params_from_numpy(np_tree(jax_registry.init_params(
        _tiny_cfgs()[0].with_overrides(num_layers=3), jax.random.PRNGKey(0))),
        device="cpu")
    step = train_launch.make_train_step(cfg, opt.AdamWConfig(**OCFG),
                                        microbatches=mb)
    batch = {k: torch.from_numpy(v)
             for k, v in SyntheticLM(64, 16, 4, seed=1).sample().items()}
    step(params, opt.init(params), batch)
    assert calls == train_launch.kernel_launches_per_step(cfg, mb)


def test_adamw_by_slices_equals_the_whole_leaf(monkeypatch):
    """A leaf above ``SLICE_ELEMS`` is updated a slice of its leading dim
    at a time: the same bits as the whole-leaf update, params and both
    moments, over two steps."""
    from repro_torch.train import optimizer as opt_mod
    g = torch.Generator().manual_seed(3)
    tree = {"a": torch.randn(7, 5, 3, generator=g), "b": torch.randn(4, generator=g),
            "c": torch.randn(2, 3, generator=g)}
    grads = [{k: torch.randn(v.shape, generator=g) for k, v in tree.items()}
             for _ in range(2)]
    cfg = opt_mod.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4)
    outs = []
    for elems in (1 << 26, 10):
        monkeypatch.setattr(opt_mod, "SLICE_ELEMS", elems)
        params = {k: v.clone() for k, v in tree.items()}
        state = opt_mod.init(params)
        for gr in grads:
            params, state, _ = opt_mod.apply(cfg, state, params, gr)
        outs.append((params, state))
    assert len(opt_mod._slices(tree["a"])) == 7      # a row of 15 a slice
    for k in tree:
        assert torch.equal(outs[0][0][k], outs[1][0][k])
        assert torch.equal(outs[0][1].mu[k], outs[1][1].mu[k])
        assert torch.equal(outs[0][1].nu[k], outs[1][1].nu[k])
