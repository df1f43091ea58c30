"""The port's mesh with one device per rank, on the CPU.

A mesh of ``["cpu"] * n`` holds one device per rank; its payloads are
``RankShards`` (one local tensor per rank), and a round's hops are
copies between the ranks' tensors.  Every test holds that form against
the rank-stacked form of the same case bit for bit: every user-space
collective (each op × algorithm, n ∈ {2, 3, 4, 8}, int32, f32 and bf16,
chunks 1 and 4, round batch 1 and auto, one-shot and persistent with
restart, rebind and rebuild), the whole-schedule functions, the engine
grad reducer on a bucketed tree (and after a remesh to fewer devices),
the checkpoint of replicated state; and ``Mesh``'s equality, hashing and
refusals, ``RankShards``' round trips.  The JAX package is not needed
here: ``tests/test_torch_collectives.py`` holds the per-device form
against the JAX user schedules."""
import itertools
import warnings

import pytest
import torch

from repro_torch.collectives import nonblocking as NB
from repro_torch.collectives import schedules as S
from repro_torch.collectives.rank_shards import (RankShards, replicate,
                                                 replicate_tree, tree_keep,
                                                 tree_shard, tree_stack)
from repro_torch.core import ProgressEngine
from repro_torch.launch.mesh import Mesh, make_mesh

NS = (2, 3, 4, 8)
DTYPES = (torch.int32, torch.float32, torch.bfloat16)
OPS = ([("allreduce", a) for a in S.ALGORITHMS]
       + [(op, a) for op in ("reduce_scatter", "allgather")
          for a in ("ring", "halving_doubling")]
       + [("alltoall", "bruck")])
CASES = list(itertools.product((1, 4), (1, None)))    # chunks, round batch


def shape_of(op: str, n: int) -> tuple:
    """A global payload shape per op (the last dims odd where the op
    allows, so the ring family pads)."""
    return {"allreduce": (n * 2, 3, 37), "reduce_scatter": (n * 2, 2, n * 8),
            "allgather": (n * 2, 2, 6), "alltoall": (n * n, 5)}[op]


def draw(shape, dtype, gen):
    if dtype == torch.int32:
        return torch.randint(-8, 8, shape, generator=gen, dtype=dtype)
    return torch.randn(shape, generator=gen).to(dtype)


def meshes(n: int):
    """(rank-stacked, per-device) meshes of n ranks on the CPU."""
    return (make_mesh((n,), ("x",), "cpu"),
            make_mesh((n,), ("x",), devices=["cpu"] * n))


def kwargs(op, alg, chunks, batch):
    kw = dict(chunks=chunks, round_batch=batch)
    if op != "alltoall":
        kw["algorithm"] = alg
    return kw


@pytest.fixture(scope="module")
def coll():
    c = NB.UserCollectives(ProgressEngine())
    yield c
    c.close()
    assert c.failed == 0


def stacked(got) -> torch.Tensor:
    assert isinstance(got, RankShards)
    assert got.devices == (torch.device("cpu"),) * len(got)
    return got.to_stacked("cpu")


@pytest.mark.parametrize("op,alg", OPS)
@pytest.mark.parametrize("n", NS)
def test_one_shot_collectives_equal_the_stacked_form(coll, n, op, alg):
    smesh, dmesh = meshes(n)
    gen = torch.Generator().manual_seed(1000 * n + OPS.index((op, alg)))
    for dt in DTYPES:
        x = draw(shape_of(op, n), dt, gen)
        xs = RankShards.from_stacked(x, dmesh)
        for chunks, batch in CASES:
            kw = kwargs(op, alg, chunks, batch)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")      # n = 3: ring fallbacks
                want = getattr(coll, "i" + op)(x, smesh, "x", **kw) \
                    .wait(timeout=60)
                got = getattr(coll, "i" + op)(xs, dmesh, "x", **kw) \
                    .wait(timeout=60)
            assert torch.equal(stacked(got), want), (dt, chunks, batch)
        # the payload's shards are read, never written
        assert torch.equal(xs.to_stacked("cpu"), x)


@pytest.mark.parametrize("op,alg", OPS)
@pytest.mark.parametrize("n", NS)
def test_persistent_collectives_equal_the_stacked_form(coll, n, op, alg):
    """A persistent handle per form: two starts on one payload (the
    restart), then a start on other values (the rebind), each equal to
    the stacked handle's; a stacked payload on the per-device handle is
    refused."""
    smesh, dmesh = meshes(n)
    gen = torch.Generator().manual_seed(2000 * n + OPS.index((op, alg)))
    for dt in DTYPES:
        xa, xb = (draw(shape_of(op, n), dt, gen) for _ in range(2))
        for chunks, batch in CASES:
            kw = kwargs(op, alg, chunks, batch)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                hs = getattr(coll, op + "_init")(xa, smesh, "x", **kw)
                hd = getattr(coll, op + "_init")(
                    RankShards.from_stacked(xa, dmesh), dmesh, "x", **kw)
            for x in (xa, xa, xb):
                want = hs.start(x).wait(timeout=60)
                got = hd.start(RankShards.from_stacked(x, dmesh)) \
                    .wait(timeout=60)
                assert torch.equal(stacked(got), want), (dt, chunks, batch)
            assert hd.starts == 3 and hd.dispatches_per_start \
                == hs.dispatches_per_start
            with pytest.raises(ValueError, match="RankShards"):
                hd.start(xa)
            hs.close()
            hd.close()


def test_persistent_rebuild_on_fewer_devices():
    """An epoch invalidation fails the in-flight per-device start
    retryably; the handle refuses to start until it is rebuilt on the
    survivors' devices, and then equals a stacked handle on that many
    ranks (the payload keeps its global shape: more rows a rank)."""
    coll = NB.UserCollectives(ProgressEngine())
    epoch = NB.MembershipEpoch(4)
    _, dmesh = meshes(4)
    gen = torch.Generator().manual_seed(3)
    x = draw((8, 40), torch.float32, gen)
    h = coll.allreduce_init(RankShards.from_stacked(x, dmesh), dmesh, "x",
                            chunks=4, round_batch=1, epoch=epoch)
    req = h.start(RankShards.from_stacked(x, dmesh))
    epoch.invalidate(survivors=2, reason="test")
    with pytest.raises(NB.MembershipError):
        req.wait(timeout=60)
    with pytest.raises(NB.MembershipError, match="stale"):
        h.start(RankShards.from_stacked(x, dmesh))
    smesh2, dmesh2 = meshes(2)
    h.rebuild(dmesh2)
    got = h.start(RankShards.from_stacked(x, dmesh2)).wait(timeout=60)
    want = coll.iallreduce(x, smesh2, "x", chunks=4,
                           round_batch=1).wait(timeout=60)
    assert torch.equal(stacked(got), want)
    assert h.rebuilds == 1 and coll.failed == 1
    h.close()
    coll.close()


@pytest.mark.parametrize("n", NS)
def test_whole_schedules_equal_the_stacked_form(n):
    """The blocking schedule functions on a ``RankShards`` of ``[1, ...]``
    shards (rank r's row of the stacked ``[n, ...]``), in every dtype."""
    _, dmesh = meshes(n)
    gen = torch.Generator().manual_seed(n)
    pow2 = not n & (n - 1)
    fns = [S.ring_allreduce, S.bidirectional_ring_allreduce,
           S.ring_all_gather]
    if pow2:
        fns += [S.recursive_doubling_allreduce,
                S.recursive_halving_doubling_allreduce,
                S.recursive_doubling_all_gather]
    for dt in DTYPES:
        x = draw((n, 3, 37), dt, gen)
        for fn in fns:
            got = fn(RankShards.from_stacked(x, dmesh))
            assert torch.equal(stacked(got), fn(x)), (fn.__name__, dt)
        y = draw((n, 2, n * 4), dt, gen)
        rs = [S.ring_reduce_scatter] + \
            ([S.recursive_halving_reduce_scatter] if pow2 else [])
        for fn in rs:
            got = fn(RankShards.from_stacked(y, dmesh))
            assert torch.equal(stacked(got), fn(y)), (fn.__name__, dt)
        z = draw((n, n, 5), dt, gen)
        got = stacked(S.bruck_alltoall(RankShards.from_stacked(z, dmesh)))
        assert torch.equal(got, S.bruck_alltoall(z))
        assert torch.equal(got, z.transpose(0, 1))


def test_engine_grad_reducer_on_a_bucketed_tree():
    """Per-rank gradient trees (f32 and bf16 leaves, 32-byte buckets, so
    three buckets) through the engine grad reducer in
    both forms, three steps on persistent handles, then a remesh to 2
    devices: each rank's reduced copy equals the stacked reducer's."""
    from repro_torch.collectives.overlap import EngineGradReducer
    smesh, dmesh = meshes(4)
    gen = torch.Generator().manual_seed(7)

    def tree(n):
        return {"w": draw((n, 3, 5), torch.float32, gen),
                "b": draw((n, 7), torch.float32, gen).to(torch.bfloat16),
                "e": {"u": draw((n, 11), torch.float32, gen)}}

    def as_shards(t, mesh):
        return {k: as_shards(v, mesh) if isinstance(v, dict)
                else RankShards.from_stacked(v, mesh) for k, v in t.items()}

    def check(got, want):
        for k, v in want.items():
            if isinstance(v, dict):
                check(got[k], v)
                continue
            assert isinstance(got[k], RankShards)
            for s in got[k].shards:
                assert s.dtype == v.dtype and torch.equal(s, v), k

    rs = EngineGradReducer(smesh, "x", engine=ProgressEngine(), chunks=2,
                           bucket_bytes=32)
    rd = EngineGradReducer(dmesh, "x", engine=ProgressEngine(), chunks=2,
                           bucket_bytes=32)
    for _ in range(3):
        g = tree(4)
        check(rd.allreduce_tree(as_shards(g, dmesh), timeout=60),
              rs.allreduce_tree(g, timeout=60))
    assert len(rd._persistent) == len(rs._persistent) > 2
    assert rd.dispatches_per_step == rs.dispatches_per_step
    smesh2, dmesh2 = meshes(2)
    rs.remesh(smesh2)
    rd.remesh(dmesh2)
    g = tree(2)
    check(rd.allreduce_tree(as_shards(g, dmesh2), timeout=60),
          rs.allreduce_tree(g, timeout=60))
    rs.close()
    rd.close()


def test_mesh_forms_equality_hashing_and_repr():
    a = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    b = Mesh((2, 2), ("data", "model"), devices=[torch.device("cpu")] * 4)
    c = make_mesh((2, 2), ("data", "model"), "cpu")
    d = make_mesh((2, 2), ("data", "model"),
                  devices=["cpu", "cpu", "meta", "cpu"])
    assert a == b and hash(a) == hash(b) and len({a, b, c, d}) == 3
    assert a != c and a != d
    assert a.per_device and not c.per_device
    assert a.devices == (torch.device("cpu"),) * 4 and a.size == 4
    assert dict(a.shape) == {"data": 2, "model": 2}
    assert repr(a) == "Mesh(data=2, model=2, devices=[cpu, cpu, cpu, cpu])"
    assert repr(c) == "Mesh(data=2, model=2, device=cpu)"
    # the rank-stacked form has no per-rank devices; the per-device form
    # no single device
    with pytest.raises(ValueError, match="no per-rank devices"):
        c.devices
    with pytest.raises(ValueError, match="read mesh.devices"):
        a.device


def test_mesh_refuses_what_it_cannot_place():
    with pytest.raises(ValueError, match="has 4 ranks, the device list 3"):
        make_mesh((4,), ("x",), devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="not both"):
        make_mesh((2,), ("x",), "cpu", devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="not both or neither"):
        Mesh((2,), ("x",))
    # a card this machine lacks: no fallback to fewer cards or the CPU
    absent = f"cuda:{torch.cuda.device_count()}"
    with pytest.raises(RuntimeError, match="mesh device"):
        make_mesh((2,), ("x",), devices=["cpu", absent])


def test_rank_shards_round_trips_and_refusals():
    _, dmesh = meshes(4)
    gen = torch.Generator().manual_seed(4)
    for shape in ((4, 3), (8, 2, 5), (12,)):
        x = draw(shape, torch.float32, gen)
        xs = RankShards.from_stacked(x, dmesh)
        assert xs.shape == x.shape and xs.dtype == x.dtype and len(xs) == 4
        assert xs.numel() == x.numel() and xs.element_size() == 4
        assert torch.equal(xs.to_stacked("cpu"), x)
        assert [tuple(s.shape) for s in xs] == \
            [(shape[0] // 4,) + shape[1:]] * 4
        xs[0].zero_()                       # the shards are copies
        assert not torch.equal(xs.to_stacked("cpu"), x)
    with pytest.raises(ValueError, match="does not split over 4"):
        RankShards.from_stacked(torch.zeros(6, 2), dmesh)
    with pytest.raises(ValueError, match="shards differ"):
        RankShards([torch.zeros(2), torch.zeros(3)])
    with pytest.raises(TypeError, match="not a tensor"):
        RankShards([torch.zeros(2), 1.0])


def test_payload_form_must_match_the_mesh(coll):
    smesh, dmesh = meshes(2)
    x = torch.zeros(4, 6)
    with pytest.raises(ValueError, match="must be a RankShards"):
        coll.iallreduce(x, dmesh, "x")
    with pytest.raises(ValueError, match="needs a mesh with a device per"):
        coll.iallreduce(RankShards.from_stacked(x, dmesh), smesh, "x")
    elsewhere = RankShards([torch.zeros(2, 6), torch.zeros(2, 6,
                                                           device="meta")])
    with pytest.raises(ValueError, match="the mesh's ranks on"):
        coll.iallreduce(elsewhere, dmesh, "x")
    grid = make_mesh((2, 2), ("x", "y"), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="must hold every rank"):
        coll.iallreduce(RankShards.from_stacked(torch.zeros(4, 6), meshes(
            2)[1]), grid, "x")


def test_replica_trees_and_their_checkpoint(tmp_path):
    """``replicate_tree``/``tree_shard``/``tree_stack``/``tree_keep`` over
    dicts and AdamW's named tuple; the checkpoint saves rank 0's replica
    under the stacked run's paths and restores a copy on every rank's
    device."""
    from repro_torch.core.futures import torch_future
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.checkpoint import AsyncCheckpointer
    gen = torch.Generator().manual_seed(5)
    params = {"a": torch.randn(3, 4, generator=gen),
              "b": {"c": torch.randn(5, generator=gen)}}
    state = opt_mod.init(params)
    devices = [torch.device("cpu")] * 3
    rp, rst = replicate_tree(params, devices), replicate_tree(state,
                                                              devices)
    assert isinstance(rst, opt_mod.AdamWState)
    assert isinstance(rp["b"]["c"], RankShards) and len(rp["a"]) == 3
    assert rp["a"][1] is not params["a"] and torch.equal(rp["a"][1],
                                                         params["a"])
    back = tree_stack([tree_shard(rp, r) for r in range(3)])
    assert all(x is y for x, y in zip(back["a"], rp["a"]))
    assert len(tree_keep(rst, 2).mu["b"]["c"]) == 2
    eng = ProgressEngine()
    assert eng.wait(torch_future(eng, (rp, rst)), timeout=10)[0] is rp
    ck = AsyncCheckpointer(str(tmp_path / "dev"), eng)
    ck.save_blocking(0, {"params": rp, "opt_state": rst})
    ref = AsyncCheckpointer(str(tmp_path / "ref"), eng)
    ref.save_blocking(0, {"params": params, "opt_state": state})
    assert sorted(p.name for p in (tmp_path / "dev" / "step_0").iterdir()) \
        == sorted(p.name for p in (tmp_path / "ref" / "step_0").iterdir())
    rp["a"][0].add_(1.0)              # rank 0's replica changes after save
    got = ck.restore(0, {"params": rp, "opt_state": rst})
    for r in range(3):
        assert torch.equal(got["params"]["a"][r], params["a"])
        assert got["params"]["a"][r] is not got["params"]["a"][0] or r == 0
    assert isinstance(got["opt_state"].step, RankShards)
    assert replicate(torch.ones(2), devices).devices == tuple(devices)


def test_copies_of_blocks_and_their_checkpoint(tmp_path):
    """``RankShards`` copies (a (data x stage) mesh's stage blocks): shard
    ``d * k + b`` is block b, ``blocks`` and ``to_stacked`` one copy's,
    AdamW's fresh state keeps the mark; the checkpoint saves one copy's
    blocks, the stacked tensor's file byte for byte, and restores every
    copy."""
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.checkpoint import AsyncCheckpointer
    x = torch.arange(24.0).reshape(4, 6)
    devices = ["cpu"] * 8
    c = RankShards.from_stacked(x, devices=devices, copies=2)
    assert len(c) == 8 and c.copies == 2 and len(c.blocks) == 4
    assert all(torch.equal(c[d * 4 + b], x[b:b + 1])
               for d in range(2) for b in range(4))
    assert torch.equal(c.to_stacked("cpu"), x) and c.shape == x.shape
    assert "2 copies" in repr(c)
    with pytest.raises(ValueError, match="not 3 copies"):
        RankShards(c.shards, copies=3)
    with pytest.raises(ValueError, match="a replica has one block"):
        RankShards(c.shards, replica=True, copies=2)
    state = opt_mod.init({"w": c})
    assert state.mu["w"].copies == 2 and state.step.replica
    eng = ProgressEngine()
    AsyncCheckpointer(str(tmp_path / "dev"), eng).save_blocking(
        0, {"params": {"w": c}, "opt_state": state})
    AsyncCheckpointer(str(tmp_path / "ref"), eng).save_blocking(
        0, {"params": {"w": x}, "opt_state": opt_mod.init({"w": x})})
    names = sorted(p.name for p in (tmp_path / "ref" / "step_0").iterdir())
    assert names == sorted(p.name for p in
                           (tmp_path / "dev" / "step_0").iterdir())
    for name in names:
        assert (tmp_path / "dev" / "step_0" / name).read_bytes() == \
            (tmp_path / "ref" / "step_0" / name).read_bytes(), name
    c[5].add_(1.0)                      # a copy's block changes after save
    got = AsyncCheckpointer(str(tmp_path / "dev"), eng).restore(
        0, {"params": {"w": c}, "opt_state": state})["params"]["w"]
    assert got.copies == 2 and all(torch.equal(got[d * 4 + b], x[b:b + 1])
                                   for d in range(2) for b in range(4))


def test_elastic_remesh_takes_the_surviving_devices():
    from repro_torch.distributed import elastic
    devs = ["cpu", "cpu", "meta"]
    m = elastic.remesh(3, prefer_model=1, devices=devs)
    assert dict(m.shape) == {"data": 2, "model": 1}
    assert m.devices == (torch.device("cpu"),) * 2
    assert elastic.remesh(devices=devs[:1], prefer_model=1).size == 1
    with pytest.raises(ValueError, match="survivor"):
        elastic.remesh(4, devices=devs)
    with pytest.raises(ValueError, match="not both"):
        elastic.remesh(2, device="cpu", devices=devs)
