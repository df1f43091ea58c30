"""The port's decode options against the JAX package on the CPU: the int8
KV cache (its quantizer bit for bit, ties included), the slot-cache path
of both families, ``SlotCache``, lane resets, the int8 weights of
``serve/quantization.py`` and their decode step, and ``ServeEngine`` on
an int8 KV pool.

Tolerances: f32 logits and cache values within 1e-5 of the largest
entry (f32 sums run in another order in XLA and PyTorch); int8 values
and frozen states bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduce_cfg
from repro.configs import get_config as jax_get_config
from repro.core import ProgressEngine as JaxProgressEngine
from repro.models import registry as jax_registry
from repro.models import transformer as jax_transformer
from repro.serve import quantization as jax_qz
from repro.serve.engine import GenRequest as JaxGenRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.kvcache import PagedKVCache as JaxPagedKVCache
from repro.serve.kvcache import SlotCache as JaxSlotCache
from repro_torch.configs import get_config
from repro_torch.core import ProgressEngine
from repro_torch.models import bridge, registry, transformer
from repro_torch.models.layers import tree_leaves
from repro_torch.serve import quantization as qz
from repro_torch.serve.engine import GenRequest, ServeEngine
from repro_torch.serve.kvcache import PagedKVCache, SlotCache


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_cfg(jcfg):
    return get_config(jcfg.name).with_overrides(
        **{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def assert_close(got, want):
    """Within 1e-5 of the largest entry; int8 values bit for bit."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == np.int8:
        np.testing.assert_array_equal(got, want)
        return
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def cache_np(cache):
    return {k: (v.float().numpy() if v.dtype == torch.bfloat16
                else v.numpy()) for k, v in cache.items()}


# ---------------------------------------------------------------------------
# the int8 quantizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_is_bitwise_jax_with_ties(dtype):
    """Rows whose largest magnitude is 127 have a scale of exactly 1, so
    their x.5 entries sit on exact ties, rounded half to even on both
    sides; the other rows are random, and one is all zeros (the 1e-12
    clamp)."""
    rs = np.random.RandomState(0)
    t = rs.randn(4, 3, 16).astype(np.float32) * 3
    t[0, 0] = np.array([127, 0.5, 1.5, 2.5, -2.5, -3.5, 126.5, -0.5,
                        4.5, 5.5, -126.5, 0, 3, 7.25, -8.75, 9.5], np.float32)
    t[1, 2] = -t[0, 0]
    t[2, 1] = 0.0
    jt = jnp.asarray(t, dtype)
    jq, js = jax_transformer._quantize_kv(jt)
    q, s = transformer._quantize_kv(torch.from_numpy(t).to(getattr(torch,
                                                                   dtype)))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert set(q.numpy()[0, 0, 1:8].tolist()) == {0, 2, -2, -4, 126, 0}


# ---------------------------------------------------------------------------
# slot and paged decode, bf16 and int8 K/V
# ---------------------------------------------------------------------------

def _model(arch="qwen2.5-3b", **over):
    jcfg = reduce_cfg(jax_get_config(arch), dtype="float32", **over)
    jparams = jax_registry.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, port_cfg(jcfg), \
        bridge.params_from_numpy(np_tree(jparams), device="cpu")


B, BS, NB, MAX_SEQ = 3, 4, 4, 16


def _steps(seed=1, n=6):
    """n steps of (tokens, positions), lane 1 recycled (back to position
    0, a new request over the old one's stale cache) at step 3."""
    rs = np.random.RandomState(seed)
    pos = np.array([0, 3, 7], np.int32)
    out = []
    for i in range(n):
        if i == 3:
            pos[1] = 0
        out.append((rs.randint(0, 256, size=(B, 1)).astype(np.int32),
                    pos.copy()))
        pos = pos + 1
    return out


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("path", ["slot", "paged"])
def test_decode_matches_jax(path, kv):
    jcfg, jparams, cfg, params = _model(kv_cache_dtype=kv)
    tables = 1 + np.random.RandomState(0).permutation(B * NB) \
        .reshape(B, NB).astype(np.int32)
    if path == "slot":
        jcache = jax_registry.init_cache(jcfg, B, MAX_SEQ)
        cache = registry.init_cache(cfg, B, MAX_SEQ, "cpu")
        jstep = jax.jit(lambda p, c, t, q: jax_registry.decode_step(
            p, jcfg, c, t, q))
        step = lambda c, t, q: registry.decode_step(params, cfg, c, t, q)  # noqa: E731
    else:
        jcache = jax_registry.init_paged_cache(jcfg, B, 1 + B * NB, BS)
        cache = registry.init_paged_cache(cfg, B, 1 + B * NB, BS, "cpu")
        jstep = jax.jit(lambda p, c, t, q: jax_registry.decode_step_paged(
            p, jcfg, c, t, q, jnp.asarray(tables)))
        step = lambda c, t, q: registry.decode_step_paged(  # noqa: E731
            params, cfg, c, t, q, torch.from_numpy(tables))
    keys = {"bf16": {"k", "v"},
            "int8": {"k", "v", "k_scale", "v_scale"}}[kv]
    assert set(cache) == set(jcache) == keys
    for toks, pos in _steps():
        jl, jcache = jstep(jparams, jcache, jnp.asarray(toks),
                           jnp.asarray(pos))
        logits, cache = step(cache, torch.from_numpy(toks),
                             torch.from_numpy(pos))
        assert_close(logits.numpy(), jl)
        for key in keys:
            assert_close(cache_np(cache)[key], jcache[key])
    if kv == "int8":
        assert cache["k"].dtype == torch.int8
        assert cache["k_scale"].shape[-1] == 1


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_slot_and_paged_paths_agree(kv):
    """The same prompts through the slot cache and the paged pool (tables
    whose view is as long as the slot row): the same logits, bit for
    bit, since the paged view holds the same values."""
    _, _, cfg, params = _model(kv_cache_dtype=kv)
    slot = registry.init_cache(cfg, B, NB * BS, "cpu")
    pool = registry.init_paged_cache(cfg, B, 1 + B * NB, BS, "cpu")
    tables = torch.from_numpy(
        (1 + np.arange(B * NB)[::-1].copy()).reshape(B, NB).astype(np.int32))
    for toks, pos in _steps(seed=2):
        t, p = torch.from_numpy(toks), torch.from_numpy(pos)
        a, slot = registry.decode_step(params, cfg, slot, t, p)
        b, pool = registry.decode_step_paged(params, cfg, pool, t, p, tables)
        assert torch.equal(a, b)


def test_int8_pool_is_half_the_bf16_pool():
    cfg = get_config("qwen2.5-3b")
    sizes = {}
    for kv in ("bf16", "int8"):
        spec = transformer.paged_cache_spec(
            cfg.with_overrides(kv_cache_dtype=kv), 8, 513, 16)
        sizes[kv] = sum(np.prod(s.shape) * s.dtype.itemsize
                        for s in spec.values())
    # int8 values plus one f32 scale per 128 of them
    assert sizes["int8"] / sizes["bf16"] == pytest.approx(0.5 + 4 / 256)


def test_cache_shapes_equal_jax():
    for arch, kv in (("qwen2.5-3b", "bf16"), ("qwen2.5-3b", "int8"),
                     ("mamba2-1.3b", "bf16")):
        jcfg = jax_get_config(arch).with_overrides(kv_cache_dtype=kv)
        want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                            jax_registry.cache_shapes(jcfg, 8, 1024))
        got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                           registry.cache_shapes(port_cfg(jcfg), 8, 1024))
        assert got == want


# ---------------------------------------------------------------------------
# SlotCache and lane resets
# ---------------------------------------------------------------------------

def test_slot_cache_matches_jax():
    jcfg, _, cfg, _ = _model()
    ours, theirs = SlotCache(cfg, 4, MAX_SEQ, device="cpu"), \
        JaxSlotCache(jcfg, 4, MAX_SEQ)
    trace = []
    for c in (ours, theirs):
        got = []
        slots = [c.assign(f"r{i}") for i in range(3)]
        got.append([s.index for s in slots])
        slots[0].pos, slots[2].pos = 5, 2
        with pytest.raises(ValueError, match="already assigned"):
            c.assign("r1")
        c.release(slots[1])
        got.append([c.free_count, [s.index for s in c.free_slots()],
                    c.active_mask().tolist(), c.active_count(),
                    np.asarray(c.positions()).tolist()])
        got.append([c.assign("r3").index, c.assign("r4").index,
                    c.assign("r5")])
        got.append(np.asarray(c.positions()).tolist())
        trace.append(got)
    assert trace[0] == trace[1]
    assert ours.positions().dtype == torch.int32
    assert set(ours.cache) == set(theirs.cache)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-1.3b"])
def test_reset_cache_lane_matches_jax(arch):
    """The ssm family zeroes the slot's state (every leaf), the dense
    family leaves its K/V as they are."""
    jcfg, _, cfg, _ = _model(arch)
    rs = np.random.RandomState(5)
    init = jax.tree.map(
        lambda s: rs.randn(*s.shape).astype(s.dtype),
        jax_registry.cache_shapes(jcfg, 3, MAX_SEQ))
    want = jax_registry.reset_cache_lane(
        jcfg, jax.tree.map(jnp.asarray, init), 1)
    got = registry.reset_cache_lane(
        cfg, bridge.cache_from_numpy(init, device="cpu"), 1)
    for key in want:
        np.testing.assert_array_equal(cache_np(got)[key],
                                      np.asarray(want[key]))
    ours = SlotCache(cfg, 3, MAX_SEQ, device="cpu")
    ours.cache = bridge.cache_from_numpy(init, device="cpu")
    ours.reset_lane(ours.cache, 2)
    zeroed = cfg.family == "ssm"
    assert all(bool((v[:, 2] == 0).all()) == zeroed
               for v in ours.cache.values())


def test_paged_reset_lane_keeps_int8_pool_and_scales():
    jcfg, _, cfg, _ = _model(kv_cache_dtype="int8")
    ours = PagedKVCache(cfg, 2, MAX_SEQ, block_size=BS, device="cpu")
    theirs = JaxPagedKVCache(jcfg, 2, MAX_SEQ, block_size=BS)
    assert set(ours.cache) == set(theirs.cache) == {"k", "v", "k_scale",
                                                    "v_scale"}
    for v in ours.cache.values():
        v.fill_(3)
    before = {k: v.clone() for k, v in ours.cache.items()}
    out = ours.reset_lane(ours.cache, 1)
    assert out is ours.cache
    assert all(torch.equal(out[k], before[k]) for k in before)


def test_mamba_slot_decode_matches_jax_and_freezes_unfed_lanes():
    """Five slot-cache steps with lane 0 unfed at step 2 and slot 1 reset
    (recycled) at step 3: logits and every state leaf match JAX, and the
    unfed lane's state does not move, bit for bit."""
    jcfg, jparams, cfg, params = _model("mamba2-1.3b")
    jcache = jax_registry.init_cache(jcfg, B, MAX_SEQ)
    cache = registry.init_cache(cfg, B, MAX_SEQ, "cpu")
    rs = np.random.RandomState(6)
    for i in range(5):
        toks = rs.randint(0, 256, size=(B, 1)).astype(np.int32)
        fed = np.ones(B, bool)
        fed[0] = i != 2
        if i == 3:
            jcache = jax_registry.reset_cache_lane(jcfg, jcache, 1)
            cache = registry.reset_cache_lane(cfg, cache, 1)
        before = {k: v[:, 0].clone() for k, v in cache.items()}
        pos = np.zeros(B, np.int32)
        jl, jcache = jax_registry.decode_step(
            jparams, jcfg, jcache, jnp.asarray(toks), jnp.asarray(pos),
            jnp.asarray(fed))
        logits, cache = registry.decode_step(
            params, cfg, cache, torch.from_numpy(toks), torch.from_numpy(pos),
            torch.from_numpy(fed))
        assert_close(logits.numpy(), jl)
        for key in jcache:
            assert_close(cache_np(cache)[key], jcache[key])
        if i == 2:
            assert all(torch.equal(cache[k][:, 0], before[k]) for k in cache)


# ---------------------------------------------------------------------------
# int8 weights
# ---------------------------------------------------------------------------

MIN = 1024          # the reduced model's matrices are under the 65536 default


def test_quantize_and_dequantize_tree_equal_jax():
    jcfg, jparams, cfg, params = _model("llama3-405b")   # untied lm_head
    jq = jax_qz.quantize_tree(jparams, MIN)
    q = qz.quantize_tree(params, MIN)
    assert jax.tree.structure(jax.tree.map(lambda a: 0, q,
                                           is_leaf=lambda x: isinstance(
                                               x, qz.QuantizedTensor))) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, jq, is_leaf=lambda x:
                                        isinstance(x, jax_qz.QuantizedTensor)))
    bridged = bridge.params_from_numpy(np_tree(jq), device="cpu")
    n = 0
    for (path, got), (_, br), want in zip(
            tree_leaves(q), tree_leaves(bridged),
            jax.tree.leaves(jq, is_leaf=lambda x: isinstance(
                x, jax_qz.QuantizedTensor))):
        if isinstance(want, jax_qz.QuantizedTensor):
            n += 1
            assert isinstance(got, qz.QuantizedTensor)
            assert isinstance(br, qz.QuantizedTensor)
            np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
            np.testing.assert_array_equal(got.scale.numpy(),
                                          np.asarray(want.scale))
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert n >= 5            # embed, lm_head and the stacked matrices
    assert qz.quantized_bytes(q) == jax_qz.quantized_bytes(jq)
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        got = qz.dequantize_tree(q, dt)
        want = jax_qz.dequantize_tree(jq, jdt)
        for (_, a), b in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32))


def _axes_dict(tree):
    return tree if not isinstance(tree, dict) else \
        {k: _axes_dict(v) for k, v in tree.items()}


def test_quantized_shapes_and_axes_equal_jax():
    """At qwen2.5-3b's full width (shapes only, nothing allocated)."""
    jcfg = jax_get_config("qwen2.5-3b")
    jshapes = jax_registry.param_shapes(jcfg)
    meta = jax.tree.map(lambda s: torch.empty(
        s.shape, dtype=getattr(torch, str(s.dtype)), device="meta"), jshapes)
    got = qz.quantized_shapes(meta)
    want = jax_qz.quantized_shapes(jshapes)
    flat = lambda t: [(tuple(x.shape), str(x.dtype).replace("torch.", ""))  # noqa: E731
                      for x in jax.tree.leaves(t)]
    assert flat(got) == flat(want)
    jaxes = jax_registry.param_axes(jcfg)
    gaxes = qz.quantized_axes(_axes_dict(jaxes), meta)
    waxes = jax_qz.quantized_axes(jaxes, jshapes)

    def as_tuples(tree):
        if isinstance(tree, dict):
            return {k: as_tuples(v) for k, v in tree.items()}
        return tuple(tree) if type(tree).__name__ == "QuantizedTensor" \
            else ("plain", tree)
    assert as_tuples(gaxes) == as_tuples(waxes)


def test_decode_step_q_matches_jax_serve_step_q():
    """The body of the JAX ``serve_step_q`` (dequantize the tree to the
    compute dtype, then ``registry.decode_step``) at f32, four steps."""
    jcfg, jparams, cfg, params = _model()
    jq = jax_qz.quantize_tree(jparams, MIN)
    q = bridge.params_from_numpy(np_tree(jq), device="cpu")
    jcache = jax_registry.init_cache(jcfg, B, MAX_SEQ)
    cache = registry.init_cache(cfg, B, MAX_SEQ, "cpu")

    def jstep(qp, c, t, p):
        return jax_registry.decode_step(
            jax_qz.dequantize_tree(qp, jnp.dtype(jcfg.dtype)), jcfg, c, t, p)

    for toks, pos in _steps(seed=3, n=4):
        jl, jcache = jstep(jq, jcache, jnp.asarray(toks), jnp.asarray(pos))
        logits, cache = registry.decode_step_q(
            q, cfg, cache, torch.from_numpy(toks), torch.from_numpy(pos))
        assert_close(logits.numpy(), jl)


# ---------------------------------------------------------------------------
# ServeEngine on an int8 KV pool
# ---------------------------------------------------------------------------

def _prompts(n, vocab, lo=2, hi=12, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, vocab - 1, size=rs.randint(lo, hi)).astype(np.int32)
            for _ in range(n)]


def test_serve_engine_int8_kv_streams_match_jax():
    jcfg, jparams, cfg, params = _model("qwen2-0.5b", kv_cache_dtype="int8")
    prompts = _prompts(8, cfg.vocab_size, seed=4)
    kw = dict(batch_slots=4, max_seq=32, kv_block_size=4, kv_blocks=17)
    streams = []
    for make, gen in ((lambda: JaxServeEngine(jcfg, jparams,
                                              JaxProgressEngine(), **kw),
                       JaxGenRequest),
                      (lambda: ServeEngine(cfg, params, ProgressEngine(),
                                           device="cpu", **kw), GenRequest)):
        srv = make()
        reqs = [gen(f"r{i}", p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            srv.submit(r)
        srv.run_until_idle(timeout=300)
        srv.close(timeout=60)
        assert all(r.done_req.is_complete and not r.done_req.failed
                   for r in reqs)
        streams.append([list(r.out_tokens) for r in reqs])
    assert srv.slots.cache["k"].dtype == torch.int8
    assert streams[0] == streams[1]


def test_serve_engine_refuses_the_slot_cache():
    _, _, cfg, params = _model()
    with pytest.raises(ValueError, match="cache_mode='slots' was retired"):
        ServeEngine(cfg, params, ProgressEngine(), cache_mode="slots",
                    device="cpu")
    with pytest.raises(ValueError, match="must be 'paged'"):
        ServeEngine(cfg, params, ProgressEngine(), cache_mode="ring",
                    device="cpu")
