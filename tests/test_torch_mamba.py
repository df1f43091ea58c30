"""The port's mamba2 family (ssm) against the JAX package on the CPU, in
f32 with bridged weights and numpy-made inputs: config and parameter
tree, the training forward, loss and every gradient leaf, the paged
decode with a ``fed`` mask, the serving engine's greedy streams, the
trainer's loss trajectory, the launch counts of a train step, and the
analytical counts."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from conftest import reduce_cfg
from repro.configs import get_config as jax_get_config
from repro.core import ProgressEngine as JaxEngine
from repro.data.pipeline import PrefetchPipeline as JaxPrefetch
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models import registry as jax_registry
from repro.serve.engine import GenRequest as JaxGenRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.train import optimizer as jax_opt
from repro.train.train_loop import Trainer as JaxTrainer
from repro.train.train_loop import TrainLoopConfig as JaxLoopConfig
from repro_torch.configs import get_config
from repro_torch.core import ProgressEngine
from repro_torch.data.pipeline import PrefetchPipeline, SyntheticLM
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.models import bridge, mamba, registry
from repro_torch.models.layers import tree_leaves
from repro_torch.serve.engine import GenRequest, ServeEngine
from repro_torch.train import optimizer as opt
from repro_torch.train.train_loop import Trainer, TrainLoopConfig

ARCH = "mamba2-1.3b"
# f32 summation order differs between XLA's and PyTorch's CPU matmuls
TOL = dict(atol=1e-4, rtol=1e-4)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_cfg(jcfg):
    """The port's config with the same fields as a (reduced) JAX config."""
    return get_config(jcfg.name).with_overrides(
        **{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def tiny(**kw):
    """tests/conftest.reduce_cfg's mamba2-1.3b (d_model 64, head_dim 16,
    nh 8, d_state 16, chunk 8), in f32, and the port's twin."""
    jcfg = reduce_cfg(jax_get_config(ARCH), dtype="float32", **kw)
    return jcfg, port_cfg(jcfg)


def test_config_equals_jax():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jax_get_config(ARCH))


def test_param_tree_equals_jax_and_inits_in_range():
    jcfg, cfg = tiny()
    shapes = jax.tree.map(lambda s: tuple(s.shape),
                          jax_registry.param_shapes(jcfg))
    params = registry.init_params(cfg, torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda t: tuple(t.shape), params) == shapes
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(params))
    a_log = params["blocks"]["a_log"]          # log U[1, 16)
    assert float(a_log.min()) >= 0.0 and float(a_log.max()) < np.log(16.0)
    dt = F.softplus(params["blocks"]["dt_bias"])   # log-uniform [1e-3, 1e-1]
    assert float(dt.min()) >= 1e-3 * (1 - 1e-4)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-4)


def test_cast_params_keeps_the_ssm_scalars_f32():
    _, cfg = tiny()
    cfg = cfg.with_overrides(dtype="bfloat16")
    cast = registry.cast_params(
        cfg, registry.init_params(cfg, torch.Generator().manual_seed(0)))
    for path, t in tree_leaves(cast):
        want = torch.float32 if path[-1] in mamba.F32_KEYS else torch.bfloat16
        assert t.dtype == want, path


def test_model_flops_and_param_count_match_jax():
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    n = registry.param_count(cfg)
    assert n == jax_registry.param_count(jcfg)
    assert 1.3e9 < n < 1.4e9
    for kw in (dict(training=True, seq_len=1024),
               dict(training=False, seq_len=1024),
               dict(training=False, decode_cache_len=512),
               dict(training=True, include_attention=False)):
        assert registry.model_flops(cfg, 8192, **kw) == \
            jax_registry.model_flops(jcfg, 8192, **kw)


# ---------------------------------------------------------------------------
# training forward, loss and gradients
# ---------------------------------------------------------------------------

def _train_setup(remat, S, B=2, **kw):
    jcfg, cfg = tiny(remat_policy=remat, **kw)
    jparams = jax_registry.init_params(jcfg, jax.random.PRNGKey(1))
    params = bridge.params_from_numpy(np_tree(jparams), device="cpu")
    rs = np.random.RandomState(S)
    toks = rs.randint(0, jcfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return jcfg, jparams, cfg, params, batch


# S=32: four chunks of 8 (the inter-chunk recurrence runs); S=12: not a
# multiple of the chunk, so one chunk of Q=S
@pytest.mark.parametrize("S", [32, 12])
def test_forward_and_loss_match_jax(S):
    jcfg, jparams, cfg, params, batch = _train_setup("none", S)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jlogits, _ = jax_registry.forward(jparams, jcfg, jbatch)
    logits, aux = registry.forward(params, cfg, tbatch)
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    jloss, _ = jax_registry.loss_fn(jparams, jcfg, jbatch)
    loss, m = registry.loss_fn(params, cfg, tbatch)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    np.testing.assert_allclose(float(m["nll"]), float(jloss), **TOL)


def _grads_match_jax(jcfg, jparams, cfg, params, batch):
    """The port's loss and every leaf of its autograd gradient against
    the JAX loss and jax.grad of it, on one batch."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_registry.loss_fn(p, jcfg, jbatch)[0])(jparams)
    leaves = [t.requires_grad_() for t in jax.tree.leaves(params)]
    loss, _ = registry.loss_fn(params, cfg, {k: torch.from_numpy(v)
                                             for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    jleaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(jleaves) == 16
    for g, jg in zip(grads, jleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)


# "subblock" and "attn_only": the JAX mamba._remat checkpoints the whole
# layer under every policy but "none" and "dots", and so does the port
@pytest.mark.parametrize("S", [32, 12])
@pytest.mark.parametrize("remat", ["none", "full", "subblock", "attn_only"])
def test_gradients_match_jax(remat, S):
    """The loss and every leaf of the port's autograd gradient against
    jax.grad of the JAX loss; ops.ssd_chunk's backward recomputes through
    the oracle, and under every policy but "none" each layer is
    checkpointed and recomputed."""
    _grads_match_jax(*_train_setup(remat, S))


def test_loss_impl_is_plain_xent_as_jax():
    """The JAX ``mamba.loss_fn`` reads no ``loss_impl``: under
    "chunked_vocab" the port's loss and gradients equal the JAX ones."""
    _grads_match_jax(*_train_setup("none", 32, loss_impl="chunked_vocab"))


def test_unported_training_options_raise(tmp_path):
    """Ring attention at the hybrid family's shared attention block,
    which raised before it was ported, is held against the JAX model:
    zamba2-1.2b's "ring" loss without a mesh and under a (1, 4) mesh
    equals the JAX loss of the same config without a mesh and under
    JAX's (1, 4) mesh, within 1e-5 ("dots" is held in
    tests/test_torch_options.py, the hybrid family in
    tests/test_torch_hybrid.py)."""
    from tests.test_torch_ring import jax_ring_losses, port_ring_losses
    jcfg = reduce_cfg(jax_get_config("zamba2-1.2b"), dtype="float32")
    cfg = port_cfg(jcfg)
    jparams = jax_registry.init_params(jcfg, jax.random.PRNGKey(0))
    params = bridge.params_from_numpy(np_tree(jparams), device="cpu")
    toks = np.random.RandomState(8).randint(
        0, cfg.vocab_size, (2, 9)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    got = port_ring_losses(params, cfg, batch)
    want = jax_ring_losses(
        'reduce_cfg(get_config("zamba2-1.2b"), dtype="float32", '
        'attention_impl="ring")', jparams, batch, tmp_path)
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ---------------------------------------------------------------------------
# paged decode
# ---------------------------------------------------------------------------

def test_decode_step_paged_matches_jax_with_frozen_lanes():
    """Six steps over 4 lanes at mixed positions: the logits and every
    state leaf match JAX, and a lane left out of ``fed`` keeps its state
    bit for bit."""
    jcfg, cfg = tiny()
    B = 4
    jparams = jax_registry.init_params(jcfg, jax.random.PRNGKey(0))
    params = bridge.params_from_numpy(np_tree(jparams), device="cpu")
    jcache = jax_registry.init_paged_cache(jcfg, B, 1, 16)
    cache = bridge.cache_from_numpy(np_tree(jcache), device="cpu")
    assert cache["h"].dtype == torch.float32
    assert cache["h"].shape == (2, B, 8, 16, 16)
    tables = np.zeros((B, 1), np.int32)
    step = jax.jit(lambda p, c, t, q, bt, fd: jax_registry.decode_step_paged(
        p, jcfg, c, t, q, bt, fd))
    rs = np.random.RandomState(3)
    pos = np.array([0, 5, 2, 9], np.int32)
    for i in range(6):
        toks = rs.randint(0, cfg.vocab_size, size=(B, 1)).astype(np.int32)
        fed = np.ones(B, bool) if i < 2 else rs.rand(B) < 0.5
        fed[0] = i != 3                           # lane 0 frozen at step 3
        jl, jcache = step(jparams, jcache, jnp.asarray(toks),
                          jnp.asarray(pos), jnp.asarray(tables),
                          jnp.asarray(fed))
        before = {k: v.clone() for k, v in cache.items()}
        logits, cache = registry.decode_step_paged(
            params, cfg, cache, torch.from_numpy(toks), torch.from_numpy(pos),
            torch.from_numpy(tables), torch.from_numpy(fed))
        assert logits.shape == (B, 1, cfg.vocab_size)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
        for k in cache:
            np.testing.assert_allclose(cache[k].numpy(),
                                       np.asarray(jcache[k]), **TOL)
            for lane in np.flatnonzero(~fed):
                assert torch.equal(cache[k][:, lane], before[k][:, lane])
        pos = pos + fed.astype(np.int32)


def test_reset_paged_lane_zeroes_one_lane():
    _, cfg = tiny()
    cache = registry.init_paged_cache(cfg, 3, 1, 16, "cpu")
    for v in cache.values():
        v.fill_(1.0)
    out = registry.reset_paged_lane(cfg, cache, 1)
    assert not registry.paged_has_blocks(cfg)
    for v in out.values():
        assert torch.all(v[:, 1] == 0) and torch.all(v[:, 0] == 1) \
            and torch.all(v[:, 2] == 1)


def _prompts(n, vocab, lo=2, hi=12, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, vocab - 1, size=rs.randint(lo, hi)).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("n_requests", [4, 10])
def test_serve_streams_match_jax(n_requests):
    """The port's ServeEngine yields the JAX ServeEngine's greedy token
    streams from the same bridged weights and arrivals.  With 10 requests
    through 4 lanes, lanes are recycled: each recycled lane's state is
    zeroed (``reset_paged_lane``) before its next prefill."""
    jcfg, cfg = tiny()
    jparams = jax_registry.init_params(jcfg, jax.random.PRNGKey(0))
    params = bridge.params_from_numpy(np_tree(jparams), device="cpu")
    prompts = _prompts(n_requests, cfg.vocab_size)

    jeng = JaxEngine()
    jsrv = JaxServeEngine(jcfg, jparams, jeng, batch_slots=4, max_seq=32)
    jreqs = [JaxGenRequest(f"r{i}", p, max_new_tokens=5)
             for i, p in enumerate(prompts)]
    for r in jreqs:
        jsrv.submit(r)
    jsrv.run_until_idle(timeout=300)
    jsrv.close(timeout=60)

    srv = ServeEngine(cfg, params, ProgressEngine(), batch_slots=4,
                      max_seq=32, device="cpu")
    reqs = [GenRequest(f"r{i}", p, max_new_tokens=5)
            for i, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    srv.run_until_idle(timeout=300)
    lat = srv.latency_snapshot()
    srv.close(timeout=60)
    assert lat.completed == n_requests and lat.failed == 0
    assert [list(r.out_tokens) for r in reqs] == \
        [list(r.out_tokens) for r in jreqs]


# ---------------------------------------------------------------------------
# training: trainer, launch counts, launchers
# ---------------------------------------------------------------------------

OCFG = dict(lr=1e-2, warmup_steps=2, total_steps=50)


def test_trainer_matches_jax_trainer(tmp_path):
    """From the same bridged params and optimizer state, on the same
    SyntheticLM stream (S=16: two chunks), the port's Trainer gives the
    JAX Trainer's 10-step loss trajectory within 1e-4 (f32)."""
    jcfg, cfg = tiny(vocab_size=64)
    jparams = jax_registry.init_params(jcfg, jax.random.PRNGKey(0))
    ocfg = jax_opt.AdamWConfig(**OCFG)

    @jax.jit
    def jstep(params, opt_state, batch):
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        loss, grads = jax.value_and_grad(
            lambda p: jax_registry.loss_fn(p, jcfg, batch)[0])(params)
        params, opt_state, om = jax_opt.apply(ocfg, opt_state, params, grads)
        return params, opt_state, dict(loss=loss, **om)

    jeng = JaxEngine()
    jpipe = JaxPrefetch(JaxSyntheticLM(64, 16, 4, seed=3), jeng, depth=2)
    want = [m["loss"] for m in JaxTrainer(
        jstep, jparams, jax_opt.init(jparams), jpipe,
        JaxLoopConfig(total_steps=10, checkpoint_every=100,
                      checkpoint_dir=str(tmp_path / "jax"), log_every=1),
        engine=jeng).run()]
    jpipe.close()

    params = bridge.params_from_numpy(np_tree(jparams), device="cpu")
    state = bridge.opt_state_from_numpy(np_tree(jax_opt.init(jparams)),
                                        device="cpu")
    train_step = train_launch.make_train_step(cfg, opt.AdamWConfig(**OCFG))

    def step_fn(params, opt_state, batch):
        return train_step(params, opt_state,
                          {k: torch.from_numpy(v) for k, v in batch.items()})

    eng = ProgressEngine()
    pipe = PrefetchPipeline(SyntheticLM(64, 16, 4, seed=3), eng, depth=2)
    try:
        log = Trainer(step_fn, params, state, pipe, TrainLoopConfig(
            total_steps=10, checkpoint_every=100,
            checkpoint_dir=str(tmp_path / "torch"), log_every=1),
            engine=eng).run()
    finally:
        pipe.close()
    np.testing.assert_allclose([m["loss"] for m in log], want, **TOL)
    assert log[-1]["loss"] < log[0]["loss"]


# "subblock" and "attn_only" recompute the whole layer, as "full" does
@pytest.mark.parametrize("remat,mb", [("none", 1), ("full", 1), ("none", 2),
                                      ("full", 2), ("subblock", 1),
                                      ("attn_only", 1)])
def test_kernel_launches_per_step_as_derived(monkeypatch, remat, mb):
    """The ssm family's per-step launch counts, which chip_smoke.py
    asserts on the card, held against the calls the CPU path makes to
    each kernel's plain version (ops dispatches to exactly one of the two
    per launch)."""
    from repro_torch.kernels import ops
    names = {"rmsnorm_fwd": "rmsnorm_fwd_plain",
             "rmsnorm_bwd": "rmsnorm_bwd_plain",
             "flash_attention": "flash_attention_plain",
             "flash_decode": "flash_decode_plain",
             "ssd_chunk": "ssd_chunk_plain"}
    calls = dict.fromkeys(names, 0)

    def counting(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    for name, attr in names.items():
        monkeypatch.setattr(ops, attr, counting(name, getattr(ops, attr)))
    jcfg, cfg = tiny(num_layers=3, vocab_size=64)
    cfg = cfg.with_overrides(remat_policy=remat)
    params = bridge.params_from_numpy(np_tree(jax_registry.init_params(
        jcfg, jax.random.PRNGKey(0))), device="cpu")
    step = train_launch.make_train_step(cfg, opt.AdamWConfig(**OCFG),
                                        microbatches=mb)
    batch = {k: torch.from_numpy(v)
             for k, v in SyntheticLM(64, 16, 4, seed=1).sample().items()}
    step(params, opt.init(params), batch)
    assert calls == train_launch.kernel_launches_per_step(cfg, mb)
    assert calls["ssd_chunk"] == (1 if remat == "none" else 2) * 3 * mb
    if remat != "none":
        assert calls == train_launch.kernel_launches_per_step(
            cfg.with_overrides(remat_policy="full"), mb)


def test_launchers_shrink_the_ssm_and_run_on_the_cpu(tmp_path, capsys):
    cfg = serve_launch.make_config(ARCH, "tiny")
    assert (cfg.ssm.d_state, cfg.ssm.head_dim, cfg.ssm.chunk_size,
            cfg.d_model, cfg.num_layers) == (16, 16, 16, 64, 2)
    assert serve_launch.make_config(ARCH, "full") == get_config(ARCH)
    assert train_launch.main(["--arch", ARCH, "--device", "cpu", "--scale",
                              "tiny", "--steps", "2", "--seq", "24",
                              "--ckpt-dir", str(tmp_path)]) == 0
    assert "final loss" in capsys.readouterr().out
    report = serve_launch.run(serve_launch.build_parser().parse_args(
        ["--arch", ARCH, "--device", "cpu", "--scale", "tiny",
         "--requests", "5", "--slots", "2", "--max-new", "3"]))
    assert report.tokens == 15
    assert all(r.done_req.is_complete and not r.done_req.failed
               for r in report.requests)


def test_trainer_checkpoints_the_mamba_tree_at_the_last_step(tmp_path):
    """The Trainer saves the last step whatever the interval, as the JAX
    Trainer does, and the nested mamba tree (``blocks`` dict, f32 SSM
    scalars) and its moments restore to the same tensors."""
    _, cfg = tiny(vocab_size=64)
    params = registry.init_params(cfg, torch.Generator().manual_seed(0))
    train_step = train_launch.make_train_step(cfg, opt.AdamWConfig(**OCFG))
    eng = ProgressEngine()
    pipe = PrefetchPipeline(SyntheticLM(64, 16, 2, seed=3), eng, depth=1)
    try:
        tr = Trainer(lambda p, o, b: train_step(
            p, o, {k: torch.from_numpy(v) for k, v in b.items()}),
            params, opt.init(params), pipe, TrainLoopConfig(
                total_steps=2, checkpoint_every=100,
                checkpoint_dir=str(tmp_path / "ck"), log_every=1),
            engine=eng)
        log = tr.run()
    finally:
        pipe.close()
    assert len(log) == 2 and tr.ckpt.latest_step() == 1
    state = {"params": tr.params, "opt_state": tr.opt_state}
    back = tr.ckpt.restore(1, state)
    pairs = [(tr.params, back["params"])] + [
        (getattr(tr.opt_state, f), getattr(back["opt_state"], f))
        for f in ("mu", "nu")]
    for want, got in pairs:
        want, got = list(tree_leaves(want)), list(tree_leaves(got))
        assert [p for p, _ in got] == [p for p, _ in want]
        assert any(p[0] == "blocks" and len(p) == 2 for p, _ in want)
        for (path, a), (_, b) in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), path
    assert torch.equal(back["opt_state"].step, tr.opt_state.step)
