"""The port's paged KV cache and serving engine.

* ``BlockAllocator``/``PagedKVCache`` keep the invariants
  tests/test_paged_kvcache.py checks on the JAX package;
* with the same bridged weights and the same arrivals, the port's
  ``ServeEngine(device="cpu")`` yields the JAX ``ServeEngine``'s greedy
  token streams exactly, in f32 — with a roomy pool, under forced
  preemption, and driven by progress workers.
"""
import jax
import numpy as np
import pytest
import torch

from conftest import reduce_cfg
from repro.configs import get_config as jax_get_config
from repro.core import ProgressEngine as JaxProgressEngine
from repro.models import registry as jax_registry
from repro.serve.engine import GenRequest as JaxGenRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.core import ProgressEngine, ProgressExecutor
from repro_torch.models import bridge
from repro_torch.serve.engine import GenRequest, ServeEngine, _BucketBacklog
from repro_torch.serve.kvcache import (BlockAllocationError, BlockAllocator,
                                       PagedKVCache)


@pytest.fixture(scope="module")
def tiny_cfg():
    return get_config("qwen2-0.5b").with_overrides(
        num_layers=2, d_model=64, d_ff=128, vocab_size=256, num_heads=4,
        num_kv_heads=2, head_dim=16, remat_policy="none")


# ---------------------------------------------------------------------------
# allocator / cache invariants
# ---------------------------------------------------------------------------

def check_invariants(ba: BlockAllocator) -> None:
    owned = {o: ba.blocks_of(o) for o in ba.owners()}
    all_owned = [b for blocks in owned.values() for b in blocks]
    assert len(all_owned) == len(set(all_owned))      # no aliasing
    assert 0 not in all_owned                         # scratch never handed out
    assert ba.free_count + len(all_owned) == ba.usable_blocks
    assert not set(ba._free) & set(all_owned)


@pytest.mark.parametrize("seed", range(4))
def test_allocator_invariants_seeded(seed):
    rs = np.random.RandomState(seed)
    ba = BlockAllocator(17)
    owners = [f"r{i}" for i in range(6)]
    for _ in range(300):
        op, owner, n = (rs.choice(["alloc", "extend", "free"]),
                        owners[rs.randint(6)], int(rs.randint(1, 5)))
        live = owner in ba.owners()
        if op == "alloc":
            if live:
                with pytest.raises(BlockAllocationError):
                    ba.alloc(owner, n)
            else:
                before = ba.free_count
                got = ba.alloc(owner, n)
                assert (got is None) == (n > before)
        elif op == "extend":
            if not live:
                with pytest.raises(BlockAllocationError):
                    ba.extend(owner, n)
            else:
                ba.extend(owner, n)
        elif not live:
            with pytest.raises(BlockAllocationError):
                ba.free(owner)
        else:
            assert ba.free(owner) >= 1
        check_invariants(ba)


def test_paged_cache_assign_ensure_release(tiny_cfg):
    pc = PagedKVCache(tiny_cfg, 2, 16, block_size=4, num_blocks=7,
                      device="cpu")
    assert pc.cache["k"].shape == (2, 7, 4, 2, 16)
    assert pc.cache["k"].dtype == torch.bfloat16
    lane = pc.assign("a", seq_len=6)                  # 2 blocks
    assert lane is not None and pc.allocator.free_count == 4
    with pytest.raises(ValueError, match="already assigned"):
        pc.assign("a")
    assert pc.assign("b", seq_len=16) is not None     # 4 blocks: pool full
    assert pc.assign("c") is None                     # no lane left
    pc.slots[lane.index].pos = 8
    assert pc.ensure(lane.index, 8) is False          # OOM signals, no raise
    tables = pc.block_tables()
    assert tables.dtype == torch.int32 and tables.shape == (2, 4)
    assert torch.count_nonzero(tables[lane.index]) == 2
    assert pc.positions().tolist() == [8, 0]
    pc.release(pc.slots[lane.index])
    assert pc.allocator.free_count == 2
    assert torch.count_nonzero(pc.block_tables()[lane.index]) == 0
    with pytest.raises(ValueError, match="cannot hold one max_seq"):
        PagedKVCache(tiny_cfg, 2, 16, block_size=4, num_blocks=4,
                     device="cpu")


def test_bucket_backlog_orders_by_seq_and_length():
    bb = _BucketBacklog()

    def req(seq, n):
        r = GenRequest(f"q{seq}", np.arange(n, dtype=np.int32))
        r.seq, r.replay = seq, r.prompt
        return r

    for seq, n in ((3, 4), (1, 5), (2, 40)):
        bb.push(req(seq, n))
    popped = [bb.pop_fitting(lambda r: "lane")[0].seq for _ in range(3)]
    assert popped == [1, 2, 3]


# ---------------------------------------------------------------------------
# engine: the JAX ServeEngine's token streams, exactly
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bridged():
    jcfg = reduce_cfg(jax_get_config("qwen2-0.5b"), dtype="float32")
    jparams = jax_registry.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config("qwen2-0.5b").with_overrides(
        num_layers=2, d_model=64, d_ff=128, vocab_size=256, num_heads=4,
        num_kv_heads=2, head_dim=16, remat_policy="none", dtype="float32")
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    return jcfg, jparams, cfg, params


def _prompts(n, vocab, lo=2, hi=12, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, vocab - 1, size=rs.randint(lo, hi)).astype(np.int32)
            for _ in range(n)]


def _serve_jax(jcfg, jparams, prompts, max_new, **kw):
    eng = JaxProgressEngine()
    srv = JaxServeEngine(jcfg, jparams, eng, batch_slots=4, max_seq=32, **kw)
    reqs = [JaxGenRequest(f"r{i}", p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    srv.run_until_idle(timeout=300)
    sched = srv.scheduler_snapshot()
    srv.close(timeout=60)
    return [list(r.out_tokens) for r in reqs], sched


def _serve_port(cfg, params, prompts, max_new, workers=0, **kw):
    eng = ProgressEngine()
    ex = ProgressExecutor(eng, workers) if workers else None
    srv = ServeEngine(cfg, params, eng, batch_slots=4, max_seq=32,
                      executor=ex, device="cpu", **kw)
    if ex is not None:
        ex.start()
    reqs = [GenRequest(f"r{i}", p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    try:
        for r in reqs:
            srv.submit(r)
        srv.run_until_idle(timeout=300)
        lat, sched = srv.latency_snapshot(), srv.scheduler_snapshot()
        srv.close(timeout=60)
    finally:
        if ex is not None:
            ex.shutdown(drain=True, timeout=60)
    assert all(r.done_req.is_complete and not r.done_req.failed
               for r in reqs)
    return [list(r.out_tokens) for r in reqs], lat, sched


def test_streams_match_jax_roomy_pool(bridged):
    jcfg, jparams, cfg, params = bridged
    prompts = _prompts(10, cfg.vocab_size)
    ref, jsched = _serve_jax(jcfg, jparams, prompts, 5)
    got, lat, sched = _serve_port(cfg, params, prompts, 5)
    assert got == ref
    assert lat.completed == 10 and lat.failed == 0
    assert sched.prefill_calls == jsched.prefill_calls


def test_streams_match_jax_under_preemption(bridged):
    jcfg, jparams, cfg, params = bridged
    prompts = _prompts(12, cfg.vocab_size)
    kw = dict(kv_block_size=4, kv_blocks=11, prefill_chunk=4)
    ref, jsched = _serve_jax(jcfg, jparams, prompts, 12, **kw)
    got, lat, sched = _serve_port(cfg, params, prompts, 12, **kw)
    assert got == ref
    assert sched.preemptions > 0 and lat.preempted > 0   # pressure happened
    assert sched.preemptions == jsched.preemptions
    assert lat.completed == 12 and lat.failed == 0


def test_streams_match_jax_with_progress_workers(bridged):
    jcfg, jparams, cfg, params = bridged
    prompts = _prompts(8, cfg.vocab_size, seed=2)
    ref, _ = _serve_jax(jcfg, jparams, prompts, 6, kv_block_size=8)
    got, lat, _ = _serve_port(cfg, params, prompts, 6, workers=2,
                              kv_block_size=8)
    assert got == ref and lat.completed == 8


def test_serve_engine_defaults_to_the_card(bridged):
    _, _, cfg, params = bridged
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA: the refusal is for CPU-only boxes")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg, params, ProgressEngine())
