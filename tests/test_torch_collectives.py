"""The port's user-space collectives against the JAX package on the CPU.

One JAX child with 8 host devices (``tests/_multidevice.run_with_devices``:
JAX fixes its device count at first init) runs every schedule × op on
meshes of n ∈ {2, 3, 4, 8} of its devices — the whole-schedule
functions under ``shard_map``, the nonblocking ops at several chunk
counts and round batches, and the native ``psum`` / ``psum_scatter`` /
``all_gather`` / ``all_to_all`` — on numpy inputs made from a seed, and
saves the outputs to an ``.npz``.  The port runs the same inputs through
its schedules (one-shot and persistent, every round batch) in both mesh
forms — rank-stacked, and one device per rank (``RankShards`` on a mesh
of ``["cpu"] * n``) — and must give the JAX user schedules' outputs bit
for bit, in int32 and f32; int32 outputs equal the native collectives
bit for bit, f32 ones within 1e-6 relative.
Also here: compression, collective matmul, and the algorithm table.
"""
import itertools
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from tests._multidevice import run_with_devices

NS = (2, 3, 4, 8)
ALGS = ("ring", "bidir", "recursive_doubling", "halving_doubling")
RS_AG_ALGS = ("ring", "halving_doubling")
# (chunks, round_batch) the port runs; the JAX child runs each chunk
# count once, fully batched (round_batch=None at these sizes): JAX's own
# tests hold its batched and per-round issues equal bit for bit, and a
# JAX per-round program compiles per round, shape and dtype
AR_CASES = [(1, 1), (1, None), (3, 1), (3, None), (3, 2)]
RS_CASES = [(1, 1), (4, 1), (4, None)]
AG_CASES = [(1, 1), (3, 1), (3, None)]
A2A_CASES = [(1, 1), (5, 1), (5, None)]
DTYPES = ("int32", "float32")


def chunk_counts(cases):
    return sorted({k for k, _ in cases})


def inputs(n):
    """The numpy payloads of mesh size n (global shapes, leading dim
    sharded), from one seed per (n, op, dtype)."""
    out = {}
    for dt in DTYPES:
        rs = np.random.RandomState(100 * n + (dt == "float32"))

        def make(shape):
            if dt == "int32":
                return rs.randint(-8, 8, size=shape).astype(np.int32)
            return rs.randn(*shape).astype(np.float32)

        out[("ar", dt)] = make((n * 2, 3, 33))
        out[("rs", dt)] = make((n * 2, 2, n * 8))
        out[("ag", dt)] = make((n * 2, 2, 6))
        out[("a2a", dt)] = make((n * n, 5))
    return out


_JAX_CHILD = """
import sys, warnings
sys.path.insert(0, {root!r})
warnings.simplefilter("ignore")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro import compat
from repro.core import ProgressEngine
from repro.collectives import nonblocking as NB
from repro.collectives import schedules as S
from repro.collectives import compression as C
from repro.collectives import overlap as O
from tests.test_torch_collectives import (
    NS, ALGS, RS_AG_ALGS, AR_CASES, RS_CASES, AG_CASES, A2A_CASES, DTYPES,
    chunk_counts, inputs)

res = {{}}
eng = ProgressEngine()
coll = NB.UserCollectives(eng)

def smap(fn, mesh, in_specs=P("x"), out_specs=P("x")):
    return jax.jit(compat.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                    out_specs=out_specs))

for n in NS:
    mesh = Mesh(np.array(jax.devices()[:n]), ("x",))
    ins = inputs(n)
    for dt in DTYPES:
        x = jnp.asarray(ins[("ar", dt)])
        res[f"ar/{{n}}/native/{{dt}}"] = smap(lambda v: jax.lax.psum(v, "x"),
                                            mesh)(x)
        for alg in ALGS:
            res[f"ar/{{n}}/{{alg}}/whole/{{dt}}"] = jax.jit(
                lambda v: S.allreduce_under_shard_map(v, mesh, "x", alg))(x)
            for K in chunk_counts(AR_CASES):
                res[f"ar/{{n}}/{{alg}}/{{K}}/{{dt}}"] = coll.iallreduce(
                    x, mesh, "x", algorithm=alg, chunks=K).wait(timeout=300)
        x = jnp.asarray(ins[("rs", dt)])
        res[f"rs/{{n}}/native/{{dt}}"] = smap(lambda v: jax.lax.psum_scatter(
            v, "x", scatter_dimension=v.ndim - 1, tiled=True), mesh)(x)
        res[f"rs/{{n}}/ring/whole/{{dt}}"] = smap(
            lambda v: S.ring_reduce_scatter(v, "x"), mesh)(x)
        if not n & (n - 1):
            res[f"rs/{{n}}/halving_doubling/whole/{{dt}}"] = smap(
                lambda v: S.recursive_halving_reduce_scatter(v, "x"), mesh)(x)
        for alg in RS_AG_ALGS:
            for K in chunk_counts(RS_CASES):
                res[f"rs/{{n}}/{{alg}}/{{K}}/{{dt}}"] = coll.ireduce_scatter(
                    x, mesh, "x", algorithm=alg, chunks=K).wait(timeout=300)
        x = jnp.asarray(ins[("ag", dt)])
        res[f"ag/{{n}}/native/{{dt}}"] = smap(lambda v: jax.lax.all_gather(
            v, "x", axis=v.ndim - 1, tiled=True), mesh)(x)
        res[f"ag/{{n}}/ring/whole/{{dt}}"] = smap(
            lambda v: S.ring_all_gather(v, "x"), mesh)(x)
        if not n & (n - 1):
            res[f"ag/{{n}}/halving_doubling/whole/{{dt}}"] = smap(
                lambda v: S.recursive_doubling_all_gather(v, "x"), mesh)(x)
        for alg in RS_AG_ALGS:
            for K in chunk_counts(AG_CASES):
                res[f"ag/{{n}}/{{alg}}/{{K}}/{{dt}}"] = coll.iallgather(
                    x, mesh, "x", algorithm=alg, chunks=K).wait(timeout=300)
        x = jnp.asarray(ins[("a2a", dt)])
        res[f"a2a/{{n}}/native/{{dt}}"] = smap(lambda v: jax.lax.all_to_all(
            v.reshape(n, 1, 5), "x", 0, 0, tiled=False).reshape(n, 5),
            mesh)(x)
        res[f"a2a/{{n}}/bruck/whole/{{dt}}"] = smap(
            lambda v: S.bruck_alltoall(v, "x"), mesh)(x)
        for K in chunk_counts(A2A_CASES):
            res[f"a2a/{{n}}/bruck/{{K}}/{{dt}}"] = coll.ialltoall(
                x, mesh, "x", chunks=K).wait(timeout=300)
coll.close()
# compression, collective matmul (4 ranks)
mesh = Mesh(np.array(jax.devices()[:4]), ("x",))
rs = np.random.RandomState(7)
xc = rs.randn(4, 8, 300).astype(np.float32)
res["cq/q"], res["cq/s"] = C.quantize_int8(jnp.asarray(xc), 64)
res["cq/deq"] = C.dequantize_int8(res["cq/q"], res["cq/s"], 300)
res["cq/allreduce"] = smap(lambda v: C.compressed_allreduce(v, "x", 64),
                           mesh)(jnp.asarray(xc))
g = rs.randn(4, 6, 50).astype(np.float32)
e = rs.randn(4, 6, 50).astype(np.float32) * 1e-3
ef = C.ErrorFeedback("x", 64)
red, new_e = smap(lambda gg, ee: jax.tree.map(
    lambda t: t[None], ef.reduce_with_feedback({{"w": gg[0]}}, {{"w": ee[0]}})),
    mesh, in_specs=(P("x"), P("x")), out_specs=P("x"))(jnp.asarray(g),
                                                      jnp.asarray(e))
res["ef/red"], res["ef/err"] = red["w"], new_e["w"]
xm = rs.randn(32, 16).astype(np.float32)
wm = rs.randn(16, 64).astype(np.float32)
res["cm/ag"] = smap(lambda a, b: O.collective_matmul_ag(a, b, "x"), mesh,
                    in_specs=(P("x"), P(None, "x")),
                    out_specs=P(None, "x"))(jnp.asarray(xm), jnp.asarray(wm))
xr = rs.randn(32, 64).astype(np.float32)
wr = rs.randn(64, 48).astype(np.float32)
res["cm/rs"] = smap(lambda a, b: O.collective_matmul_rs(a, b, "x"), mesh,
                    in_specs=(P(None, "x"), P("x", None)),
                    out_specs=P("x", None))(jnp.asarray(xr), jnp.asarray(wr))
for k, v in (("cm/xm", xm), ("cm/wm", wm), ("cm/xr", xr), ("cm/wr", wr),
             ("cq/x", xc), ("ef/g", g), ("ef/e", e)):
    res[k] = v
np.savez({out!r}, **{{k: np.asarray(v) for k, v in res.items()}})
print("SAVED", len(res))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("coll") / "ref.npz"
    root = str(Path(__file__).resolve().parents[1])
    log = run_with_devices(_JAX_CHILD.format(root=root, out=str(out)),
                           n_devices=8, timeout=900)
    assert "SAVED" in log
    return dict(np.load(out))


def port_mesh(n):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((n,), ("x",), "cpu")


def port_meshes(n):
    """Both forms: the rank-stacked mesh, and a device per rank."""
    from repro_torch.launch.mesh import make_mesh
    return port_mesh(n), make_mesh((n,), ("x",), devices=["cpu"] * n)


def as_form(fn, x, mesh):
    """``fn`` on the stacked ``x``, or on its ``RankShards`` (each rank's
    rows) on a mesh with a device per rank, the result stacked again."""
    if not mesh.per_device:
        return fn(x)
    from repro_torch.collectives.rank_shards import RankShards
    return fn(RankShards.from_stacked(x, mesh)).to_stacked("cpu")


@pytest.fixture(scope="module")
def coll():
    from repro_torch.collectives import nonblocking as NB
    from repro_torch.core import ProgressEngine
    c = NB.UserCollectives(ProgressEngine())
    yield c
    c.close()
    assert c.failed == 0


def _run(coll, op, x, mesh, persistent, **kw):
    """One issue through the one-shot op, or through a persistent handle
    started twice (the second start must give the same result); on a
    mesh with a device per rank through ``as_form``."""
    if mesh.per_device:
        return as_form(lambda xs: _run_form(coll, op, xs, mesh, persistent,
                                            **kw), x, mesh)
    return _run_form(coll, op, x, mesh, persistent, **kw)


def _run_form(coll, op, x, mesh, persistent, **kw):
    from repro_torch.collectives.rank_shards import local
    if not persistent:
        return getattr(coll, "i" + op)(x, mesh, "x", **kw).wait(timeout=60)
    h = getattr(coll, op + "_init")(x, mesh, "x", **kw)
    first = local(torch.clone, h.start(x).wait(timeout=60))
    again = h.start(local(torch.clone, x)).wait(timeout=60)
    assert all(torch.equal(a, b) for a, b in zip(
        getattr(first, "shards", [first]), getattr(again, "shards", [again])))
    assert h.starts == 2
    h.close()
    return first


def _check_native(got, native, dt):
    if dt == "int32":
        np.testing.assert_array_equal(got, native)
    else:
        np.testing.assert_allclose(got, native, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("alg", ALGS)
@pytest.mark.parametrize("n", NS)
def test_allreduce_equals_jax_user_schedule(ref, coll, n, alg):
    from repro_torch.collectives import schedules as S
    ins = inputs(n)
    for dt, mesh in itertools.product(DTYPES, port_meshes(n)):
        x = torch.from_numpy(ins[("ar", dt)])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")          # n = 3: pow2 fallback
            whole = as_form(lambda v: S.allreduce_under_shard_map(
                v, mesh, "x", alg), x, mesh).numpy()
            np.testing.assert_array_equal(
                whole, ref[f"ar/{n}/{alg}/whole/{dt}"],
                err_msg=f"whole {dt} {mesh}")
            _check_native(whole, ref[f"ar/{n}/native/{dt}"], dt)
            for K, rb in AR_CASES:
                want = ref[f"ar/{n}/{alg}/{K}/{dt}"]
                for persistent in (False, True):
                    got = _run(coll, "allreduce", x, mesh, persistent,
                               algorithm=alg, chunks=K, round_batch=rb)
                    np.testing.assert_array_equal(
                        got.numpy(), want,
                        err_msg=f"{dt} K={K} rb={rb} persistent={persistent}"
                                f" {mesh}")
                    _check_native(got.numpy(), ref[f"ar/{n}/native/{dt}"], dt)


@pytest.mark.parametrize("op,cases,inp", [
    ("reduce_scatter", RS_CASES, "rs"), ("allgather", AG_CASES, "ag")])
@pytest.mark.parametrize("alg", RS_AG_ALGS)
@pytest.mark.parametrize("n", NS)
def test_rs_ag_equal_jax_user_schedule(ref, coll, n, alg, op, cases, inp):
    from repro_torch.collectives import schedules as S
    ins = inputs(n)
    whole_fn = {("rs", "ring"): S.ring_reduce_scatter,
                ("rs", "halving_doubling"): S.recursive_halving_reduce_scatter,
                ("ag", "ring"): S.ring_all_gather,
                ("ag", "halving_doubling"): S.recursive_doubling_all_gather}
    for dt, mesh in itertools.product(DTYPES, port_meshes(n)):
        x = torch.from_numpy(ins[(inp, dt)])
        native = ref[f"{inp}/{n}/native/{dt}"]
        key = f"{inp}/{n}/{alg}/whole/{dt}"
        if key in ref:
            whole = as_form(whole_fn[(inp, alg)], x.unflatten(0, (n, -1)),
                            mesh).flatten(0, 1)
            np.testing.assert_array_equal(whole.numpy(), ref[key],
                                          err_msg=str(mesh))
            _check_native(whole.numpy(), native, dt)
        for K, rb in cases:
            want = ref[f"{inp}/{n}/{alg}/{K}/{dt}"]
            for persistent in (False, True):
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")  # n = 3: ring fallback
                    got = _run(coll, op, x, mesh, persistent, algorithm=alg,
                               chunks=K, round_batch=rb)
                np.testing.assert_array_equal(
                    got.numpy(), want,
                    err_msg=f"{dt} K={K} rb={rb} persistent={persistent} "
                            f"{mesh}")
                _check_native(got.numpy(), native, dt)


@pytest.mark.parametrize("n", NS)
def test_alltoall_equals_jax_bruck(ref, coll, n):
    from repro_torch.collectives import schedules as S
    ins = inputs(n)
    for dt, mesh in itertools.product(DTYPES, port_meshes(n)):
        x = torch.from_numpy(ins[("a2a", dt)])
        native = ref[f"a2a/{n}/native/{dt}"]
        whole = as_form(S.bruck_alltoall, x.unflatten(0, (n, n)),
                        mesh).flatten(0, 1)
        np.testing.assert_array_equal(whole.numpy(),
                                      ref[f"a2a/{n}/bruck/whole/{dt}"])
        np.testing.assert_array_equal(whole.numpy(), native)   # a transpose
        for K, rb in A2A_CASES:
            for persistent in (False, True):
                got = _run(coll, "alltoall", x, mesh, persistent, chunks=K,
                           round_batch=rb)
                np.testing.assert_array_equal(
                    got.numpy(), ref[f"a2a/{n}/bruck/{K}/{dt}"],
                    err_msg=str(mesh))
                np.testing.assert_array_equal(got.numpy(), native)


def test_compression_equals_jax(ref):
    from repro_torch.collectives import compression as C
    x = torch.from_numpy(ref["cq/x"])
    q, s = C.quantize_int8(x, 64)
    np.testing.assert_array_equal(q.numpy(), ref["cq/q"])
    np.testing.assert_array_equal(s.numpy(), ref["cq/s"])
    np.testing.assert_array_equal(C.dequantize_int8(q, s, 300).numpy(),
                                  ref["cq/deq"])
    got = C.compressed_allreduce(x, 64).numpy()
    # XLA contracts each hop's dequantize multiply into its add (one
    # rounding, an FMA); torch rounds twice: a few f32 ulps apart
    np.testing.assert_allclose(got, ref["cq/allreduce"], rtol=1e-6,
                               atol=1e-6)
    exact = np.broadcast_to(ref["cq/x"].sum(0, keepdims=True), got.shape)
    rel = np.abs(got - exact) / (np.abs(exact) + 1e-3)
    assert rel.mean() < 0.05, rel.mean()     # int8: a few % relative error


def test_error_feedback_equals_jax(ref):
    from repro_torch.collectives.compression import ErrorFeedback
    ef = ErrorFeedback(block=64)
    g = {"w": torch.from_numpy(ref["ef/g"])}
    e = {"w": torch.from_numpy(ref["ef/e"])}
    red, new_e = ef.reduce_with_feedback(g, e)
    np.testing.assert_allclose(red["w"].numpy(), ref["ef/red"], rtol=1e-6,
                               atol=1e-6)                # the FMA, as above
    np.testing.assert_allclose(new_e["w"].numpy(), ref["ef/err"], rtol=1e-6,
                               atol=1e-6)
    zeros = ef.init(g)
    assert zeros["w"].shape == g["w"].shape and not zeros["w"].any()


def test_error_feedback_preserves_signal():
    """With EF, the accumulated applied update converges to the true
    gradient (the bias cancels), as the JAX package's test holds."""
    from repro_torch.collectives.compression import (dequantize_int8,
                                                     quantize_int8)
    g_true = torch.from_numpy(
        np.random.RandomState(0).randn(512).astype(np.float32)) * 1e-3
    err = torch.zeros(512)
    applied = torch.zeros(512)
    for _ in range(20):
        target = g_true + err
        q, s = quantize_int8(target, 64)
        sent = dequantize_int8(q, s, 512)
        err = target - sent
        applied = applied + sent
    np.testing.assert_allclose((applied / 20).numpy(), g_true.numpy(),
                               atol=2e-4)


def test_collective_matmul_matches_jax(ref):
    """Stacked operands: rank r's rows of x and columns of w (AG), and
    rank r's contraction slice (RS); the products' summation order is
    the library's, so within 1e-5 of the JAX outputs."""
    from repro_torch.collectives import overlap as O
    n = 4
    xm, wm = torch.from_numpy(ref["cm/xm"]), torch.from_numpy(ref["cm/wm"])
    xs = xm.unflatten(0, (n, -1))                        # [4, 8, 16]
    ws = wm.unflatten(1, (n, -1)).permute(1, 0, 2)       # [4, 16, 16]
    got = O.collective_matmul_ag(xs, ws)                 # [4, 32, 16]
    want = torch.from_numpy(ref["cm/ag"])                # [32, 64]
    np.testing.assert_allclose(got.permute(1, 0, 2).reshape(32, 64).numpy(),
                               want.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(O.ag_matmul_reference(xs, ws).numpy(),
                               got.numpy(), rtol=1e-5, atol=1e-5)
    xr, wr = torch.from_numpy(ref["cm/xr"]), torch.from_numpy(ref["cm/wr"])
    got = O.collective_matmul_rs(xr.unflatten(1, (n, -1)).permute(1, 0, 2),
                                 wr.unflatten(0, (n, -1)))   # [4, 8, 48]
    np.testing.assert_allclose(got.reshape(32, 48).numpy(), ref["cm/rs"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.reshape(32, 48).numpy(),
                               (xr @ wr).numpy(), rtol=1e-4, atol=1e-4)


def test_algorithm_table_and_resolution_as_jax():
    from repro.collectives import schedules as JS
    from repro_torch.collectives import schedules as S
    assert list(S.ALGORITHMS) == list(JS.ALGORITHMS)
    assert S.POW2_ONLY == JS.POW2_ONLY
    assert S.RS_AG_ALGORITHMS == JS.RS_AG_ALGORITHMS
    assert S.ring_perm(5) == JS.ring_perm(5)
    assert S.ring_perm(5, reverse=True) == JS.ring_perm(5, reverse=True)
    with pytest.raises(ValueError, match="unknown allreduce algorithm"):
        S.resolve_algorithm("nope", 4)
    with pytest.warns(RuntimeWarning, match="power-of-two"):
        assert S.resolve_algorithm("halving_doubling", 6) == "ring"
    with pytest.warns(RuntimeWarning, match="no allgather decomposition"):
        assert S.resolve_rs_ag_algorithm("bidir", 4, op="allgather") == "ring"
    assert S.resolve_rs_ag_algorithm("halving_doubling", 8) \
        == "halving_doubling"
    with pytest.raises(ValueError, match="power-of-two"):
        S.recursive_doubling_allreduce(torch.zeros(3, 4))


def test_bucket_tree_matches_jax():
    """Per-dtype buckets of ~bucket_bytes, one open bucket per dtype, in
    the JAX package's leaf order; non-tensor leaves raise."""
    import jax.numpy as jnp
    from repro.collectives.overlap import bucket_tree as jax_bucket_tree
    from repro_torch.collectives.overlap import bucket_tree
    shapes = {"a": ((100,), "float32"), "b": ((50,), "bfloat16"),
              "c": ((300,), "float32"), "d": ((10,), "bfloat16"),
              "e": {"f": ((7, 9), "float32"), "g": ((400,), "bfloat16")}}

    def make(spec, zeros, dt):
        if isinstance(spec, dict):
            return {k: make(v, zeros, dt) for k, v in spec.items()}
        return zeros(spec[0], dt(spec[1]))

    tree = make(shapes, lambda s, d: torch.zeros(s, dtype=d),
                lambda n: getattr(torch, n))
    jtree = make(shapes, jnp.zeros, jnp.dtype)
    for bucket_bytes in (64, 600, 1 << 20):
        assert bucket_tree(tree, bucket_bytes) == \
            jax_bucket_tree(jtree, bucket_bytes), bucket_bytes
    with pytest.raises(TypeError, match="not a tensor"):
        bucket_tree({"x": 1.0})


def test_allreduce_tree_schedules_equal_the_sum():
    """Rank-stacked gradient trees through every user schedule (per-dtype
    buckets) and the plain sum: every row is the ranks' sum, exactly on
    integer-valued payloads."""
    from repro_torch.collectives.overlap import allreduce_tree
    rs = np.random.RandomState(5)
    tree = {"w": torch.from_numpy(rs.randint(-8, 8, (4, 8, 16))
                                  .astype(np.float32)),
            "b": torch.from_numpy(rs.randint(-8, 8, (4, 16))
                                  .astype(np.float32)).to(torch.bfloat16)}
    for alg in ("psum",) + ALGS:
        out = allreduce_tree(tree, alg, bucket_bytes=256)
        for k, g in tree.items():
            want = g.float().sum(0, keepdim=True).expand_as(g).to(g.dtype)
            assert out[k].dtype == g.dtype
            assert torch.equal(out[k], want), (alg, k)


def test_microbatched_grad_fn_is_the_batch_gradient():
    """Microbatch accumulation (and, over ranks, the stacked per-rank
    gradients reduced by ``allreduce_tree``) give the whole batch's
    gradient: the ranks' sum of their local means, as the JAX package's
    in-``shard_map`` psum."""
    from repro_torch.collectives.overlap import microbatched_grad_fn
    rs = np.random.RandomState(6)
    w = torch.from_numpy(rs.randn(5, 3).astype(np.float32))
    batch = {"x": torch.from_numpy(rs.randn(8, 5).astype(np.float32)),
             "y": torch.from_numpy(rs.randn(8, 3).astype(np.float32))}

    def loss_fn(params, b):
        return ((b["x"] @ params["w"] - b["y"]) ** 2).mean(), {}

    p = w.clone().requires_grad_(True)
    full = torch.autograd.grad(loss_fn({"w": p}, batch)[0], p)[0]
    loss, grads = microbatched_grad_fn(loss_fn, 2)({"w": w}, batch)
    np.testing.assert_allclose(grads["w"].numpy(), full.numpy(), rtol=1e-5,
                               atol=1e-6)
    for alg in ("psum", "ring"):
        loss, grads = microbatched_grad_fn(loss_fn, 2, ranks=2,
                                           algorithm=alg)({"w": w}, batch)
        assert grads["w"].shape == (2, 5, 3)
        for r in range(2):
            np.testing.assert_allclose(grads["w"][r].numpy(),
                                       2 * full.numpy(), rtol=1e-5,
                                       atol=1e-6)
        np.testing.assert_allclose(float(loss),
                                   float(loss_fn({"w": w}, batch)[0]),
                                   rtol=1e-6)
