"""ZeRO-style FSDP of the port against the JAX package.

One JAX child with 4 host devices computes, on numpy inputs made from
seeds: the JAX ``FsdpLayout`` (bucket order, widths, flat buckets) of a
mixed f32/int32 tree; two ``apply_shards`` steps; the native
``psum_scatter``/``all_gather`` on int32 payloads; and a 10-step FSDP
trajectory of a 2-layer smollm-360m (d_model 64, f32) on (1,1), (2,1)
and (2,2) meshes.  That trajectory is the JAX *native* FSDP path built
from pieces that run on the installed JAX: each rank's
``jax.value_and_grad(registry.loss_fn)`` outside any mesh (the model's
shard hints then do nothing), flattened with ``FsdpLayout.flatten_bucket``,
then the ``rs_fn``, ``apply_fn`` and ``ag_fn`` of
``build_fsdp_programs``, which never call the model.

The port runs the same weights (bridged through numpy) and batches
through its native FSDP step and through the ``Trainer`` with an
``FsdpStep`` on the ``FsdpReducer``.  Tolerances: ``LOSS_TOL`` and
``PARAM_TOL`` against JAX (f32, two libraries' products and sums); user
against native bit for bit (on these meshes the data axis has at most 2
ranks, and a two-term sum is the same in any order; the all-gather only
copies).

With a device per rank (``devices=["cpu"] * n``, n in {2, 4}; the child
also runs the (4,1) trajectory) the shards, the user and native
trajectories, the launcher's runs on both backends and their checkpoint
files equal the rank-stacked form's bit for bit, and so hold the JAX
reference within the same limits (the native pair there is
``collectives.native_devices``, held against JAX's ``psum_scatter`` /
``all_gather`` on int32 too); the child
also gives JAX's ``NamedSharding.devices_indices_map`` on a 2x2 mesh,
which ``reshard_restore`` onto a per-device 2x2 mesh must place."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tests._multidevice import run_with_devices

MESHES = [(1, 1), (2, 1), (2, 2)]
TRAJ_MESHES = MESHES + [(4, 1)]   # the child's trajectories
# reshard_restore onto a per-device 2x2 mesh: (leaf, spec, shape) as JAX
# places them, and the logical axes (with one rule override) that
# resolve to those specs
PLACEMENTS = [("w", ("data", "model"), (16, 8)), ("b", ("model",), (8,)),
              ("odd", (), (5, 3)), ("both", (("data", "model"),), (16, 3)),
              ("col", (None, "data"), (3, 8))]
PLACEMENT_AXES = {"w": ("embed", "mlp"), "b": ("mlp",),
                  "odd": ("embed", "mlp"), "both": ("both", None),
                  "col": (None, "embed")}
PLACEMENT_RULES = {"both": (("data", "model"),)}
STEPS = 10
BUCKET = 1 << 16                  # several buckets of the 2-layer model
# against the JAX native FSDP path, f32: the losses, and the parameters
# after 10 steps.  AdamW divides each moment by the root of its second
# moment, so an element whose gradient is near zero carries the two
# libraries' f32 noise into its update at full step size: 4.4e-5 at most
# (attention's wo, one element of 8192, on the (1,1) mesh), lr 3e-3
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-5, atol=1e-4)
APPLY_TOL = dict(rtol=1e-6, atol=1e-7)
TINY = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=256, num_heads=4,
            num_kv_heads=2, head_dim=16, remat_policy="none",
            dtype="float32")

_JAX_CHILD = """
import json, sys, warnings
sys.path.insert(0, {root!r})
warnings.simplefilter("ignore")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro import compat
from repro.collectives.overlap import FsdpLayout
from repro.configs import get_config
from repro.data.pipeline import SyntheticLM
from repro.launch.train import build_fsdp_programs
from repro.models import registry
from repro.train import optimizer as opt_mod

res = {{}}
rs = np.random.RandomState(3)
tree = {{"a": rs.randn(7).astype(np.float32),
        "b": rs.randn(3, 5).astype(np.float32),
        "c": np.arange(4, dtype=np.int32),
        "d": {{"e": rs.randn(11).astype(np.float32),
              "f": np.arange(6, dtype=np.int32) - 2}}}}
for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
    res["tree/" + "/".join(str(p.key) for p in path)] = leaf
jt = jax.tree.map(jnp.asarray, tree)
for n in (1, 3, 4):
    for bb in (1 << 20, 40):
        lay = FsdpLayout(jt, n, bb)
        key = f"lay/{{n}}/{{bb}}"
        res[key + "/meta"] = np.asarray(json.dumps(
            [lay.buckets, lay.widths, lay.totals]))
        leaves = jax.tree.leaves(jt)
        for b in range(lay.num_buckets):
            res[f"{{key}}/flat{{b}}"] = lay.flatten_bucket(leaves, b)

# apply_shards: two steps, without and with clipping
for clip, mag in (("noclip", 0.01), ("clip", 10.0)):
    shards = [rs.randn(4, 6).astype(np.float32),
              rs.randn(4, 3).astype(np.float32)]
    grads = [[(rs.randn(4, w) * mag).astype(np.float32) for w in (6, 3)]
             for _ in range(2)]
    ocfg = opt_mod.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    st = opt_mod.init_shards([jnp.asarray(s) for s in shards])
    sh = [jnp.asarray(s) for s in shards]
    for i, g in enumerate(grads):
        res[f"ap/{{clip}}/g{{i}}"] = np.concatenate(g, axis=1)
        sh, st, om = opt_mod.apply_shards(ocfg, st, sh,
                                          [jnp.asarray(x) for x in g],
                                          grad_scale=0.25)
        res[f"ap/{{clip}}/norm{{i}}"] = om["grad_norm"]
        res[f"ap/{{clip}}/lr{{i}}"] = om["lr"]
    res[f"ap/{{clip}}/s0"] = np.concatenate(shards, axis=1)
    res[f"ap/{{clip}}/shards"] = np.concatenate([np.asarray(s) for s in sh], 1)
    res[f"ap/{{clip}}/mu"] = np.concatenate([np.asarray(s) for s in st.mu], 1)
    res[f"ap/{{clip}}/nu"] = np.concatenate([np.asarray(s) for s in st.nu], 1)

# the native FSDP collectives on int32
for n in (2, 4):
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    g = rs.randint(-1000, 1000, size=(n, 8 * n)).astype(np.int32)
    sh = rs.randint(-1000, 1000, size=(n, 6)).astype(np.int32)
    rs_fn = jax.jit(compat.shard_map(
        lambda v: jax.lax.psum_scatter(v[0], "data", scatter_dimension=0,
                                       tiled=True)[None],
        mesh=mesh, in_specs=(P("data"),), out_specs=P("data")))
    ag_fn = jax.jit(compat.shard_map(
        lambda v: jax.lax.all_gather(v[0], "data", tiled=True)[None],
        mesh=mesh, in_specs=(P("data"),), out_specs=P("data")))
    res[f"coll/{{n}}/g"], res[f"coll/{{n}}/sh"] = g, sh
    res[f"coll/{{n}}/rs"] = rs_fn(jnp.asarray(g))
    res[f"coll/{{n}}/ag"] = ag_fn(jnp.asarray(sh))

# the native FSDP trajectory, from pieces that run on this JAX
cfg = get_config("smollm-360m").with_overrides(**{tiny!r})
params = registry.init_params(cfg, jax.random.PRNGKey(0))
for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
    res["init/" + "/".join(str(p.key) for p in path)] = np.asarray(leaf)
ocfg = opt_mod.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps={steps})
vg = jax.jit(lambda p, b: jax.value_and_grad(
    registry.loss_fn, has_aux=True)(p, cfg, b))
it = iter(SyntheticLM(cfg.vocab_size, 16, 4, seed=11))
batches = [{{k: jnp.asarray(v) for k, v in next(it).items()}}
           for _ in range({steps})]
for dd, mm in {meshes!r}:
    mesh = Mesh(np.array(jax.devices()[:dd * mm]).reshape(dd, mm),
                ("data", "model"))
    layout = FsdpLayout(params, dd, {bucket})
    _, apply_fn, ag_fn, rs_fn = build_fsdp_programs(cfg, ocfg, mesh, layout)
    shd = NamedSharding(mesh, P("data"))
    shards = layout.shard_params(params, mesh, "data")
    st = opt_mod.AdamWState(jnp.zeros((), jnp.int32),
                            [jax.device_put(jnp.zeros_like(s), shd)
                             for s in shards],
                            [jax.device_put(jnp.zeros_like(s), shd)
                             for s in shards])
    losses = []
    per = 4 // dd
    for b in batches:
        flats = [np.asarray(f) for f in ag_fn(shards)]
        rows, mets = [], []
        for r in range(dd):
            pr = layout.unflatten([jnp.asarray(f[r]) for f in flats])
            (loss, m), g = vg(pr, {{k: v[r * per:(r + 1) * per]
                                   for k, v in b.items()}})
            gl = [l.astype(jnp.float32) for l in jax.tree.leaves(g)]
            rows.append([layout.flatten_bucket(gl, i)
                         for i in range(layout.num_buckets)])
            mets.append({{"loss": loss}})
        flat_g = [jax.device_put(jnp.stack([rows[r][i] for r in range(dd)]),
                                 shd) for i in range(layout.num_buckets)]
        smets = {{k: jax.device_put(jnp.stack([m_[k] for m_ in mets]), shd)
                 for k in mets[0]}}
        shards, st, om = apply_fn(shards, st, rs_fn(flat_g), smets)
        losses.append(float(om["loss"]))
    key = f"traj/{{dd}}x{{mm}}"
    res[key + "/losses"] = np.asarray(losses)
    res[key + "/widths"] = np.asarray(layout.widths)
    final = layout.unshard_params(shards)
    for path, leaf in jax.tree_util.tree_flatten_with_path(final)[0]:
        res[key + "/final/" + "/".join(str(p.key) for p in path)] = \\
            np.asarray(leaf)

# where a NamedSharding of a 2x2 mesh puts each block
mesh22 = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
for name, spec, shape in {placements!r}:
    idx = NamedSharding(mesh22, P(*spec)).devices_indices_map(shape)
    for r, dev in enumerate(mesh22.devices.flat):
        res[f"place/{{name}}/{{r}}"] = np.asarray(
            [[sl.start or 0, n if sl.stop is None else sl.stop]
             for sl, n in zip(idx[dev], shape)])
np.savez({out!r}, **{{k: np.asarray(v) for k, v in res.items()}})
print("SAVED", len(res))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("fsdp") / "ref.npz"
    root = str(Path(__file__).resolve().parents[1])
    log = run_with_devices(_JAX_CHILD.format(
        root=root, out=str(out), tiny=TINY, steps=STEPS, meshes=TRAJ_MESHES,
        bucket=BUCKET, placements=PLACEMENTS), n_devices=4, timeout=600)
    assert "SAVED" in log
    return dict(np.load(out))


def unflatten(ref, prefix):
    tree = {}
    for key, value in ref.items():
        if key.startswith(prefix + "/"):
            node = tree
            parts = key[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = value
    return tree


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def flat_numpy(tree, prefix=""):
    from repro_torch.models.layers import tree_leaves
    return {prefix + "/".join(p): t.detach().numpy()
            for p, t in tree_leaves(tree)}


@pytest.mark.parametrize("n", [1, 3, 4])
def test_layout_matches_jax(ref, n):
    """Bucket order, widths (padded to a multiple of n) and each flat
    bucket equal to the JAX ``FsdpLayout``'s, bit for bit, for one
    bucket per dtype and for small buckets; shard/unshard round trip."""
    from repro_torch.collectives.overlap import FsdpLayout
    tree = to_torch(unflatten(ref, "tree"))
    for bb in (1 << 20, 40):
        lay = FsdpLayout(tree, n, bb)
        key = f"lay/{n}/{bb}"
        buckets, widths, totals = json.loads(str(ref[key + "/meta"]))
        assert (lay.buckets, lay.widths, lay.totals) == \
            (buckets, widths, totals)
        assert all(w % n == 0 for w in lay.widths)
        shards = lay.shard_params(tree)
        for b in range(lay.num_buckets):
            want = ref[f"{key}/flat{b}"]
            assert shards[b].shape == (n, widths[b] // n)
            np.testing.assert_array_equal(shards[b].reshape(-1).numpy(), want)
            assert shards[b].dtype == lay.bucket_dtype(b)
        back = flat_numpy(lay.unshard_params(shards))
        want = flat_numpy(tree)
        assert back.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(back[k], want[k], err_msg=k)


@pytest.mark.parametrize("clip", ["noclip", "clip"])
def test_apply_shards_matches_jax(ref, clip):
    """Two ``apply_shards`` steps on stacked [4, W/4] shards with
    ``grad_scale`` 1/4 (the norm's sum over the rank dim is the JAX
    package's single sum here): shards, moments, grad norm and lr within
    ``APPLY_TOL``; padded zero tails stay zero."""
    from repro_torch.train import optimizer as opt
    ocfg = opt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    s0 = torch.from_numpy(ref[f"ap/{clip}/s0"])
    shards = [s0[:, :6].clone(), s0[:, 6:].clone(),
              torch.zeros(4, 2)]                   # an all-padding bucket
    st = opt.init_shards(shards)
    for i in range(2):
        g = torch.from_numpy(ref[f"ap/{clip}/g{i}"])
        shards, st, om = opt.apply_shards(
            ocfg, st, shards, [g[:, :6], g[:, 6:], torch.zeros(4, 2)],
            grad_scale=0.25)
        np.testing.assert_allclose(om["grad_norm"].item(),
                                   ref[f"ap/{clip}/norm{i}"], **APPLY_TOL)
        np.testing.assert_allclose(om["lr"].item(), ref[f"ap/{clip}/lr{i}"],
                                   **APPLY_TOL)
    assert st.step.item() == 2
    for name, got in (("shards", shards), ("mu", st.mu), ("nu", st.nu)):
        np.testing.assert_allclose(torch.cat(got[:2], 1).numpy(),
                                   ref[f"ap/{clip}/{name}"], err_msg=name,
                                   **APPLY_TOL)
        assert not got[2].any()


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("algorithm", ["ring", "halving_doubling"])
def test_reduce_scatter_and_gather_match_jax_int32(ref, n, algorithm):
    """The ``FsdpReducer``'s persistent reduce-scatter and chained
    all-gather handles against JAX's ``psum_scatter``/``all_gather`` on
    int32, bit for bit (1 and 2 chunks; each handle started twice), and
    the native pair of ``build_fsdp_programs`` likewise."""
    from repro_torch.collectives import CollectiveSpec, FsdpReducer
    from repro_torch.core import ProgressEngine
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import build_fsdp_programs
    g = torch.from_numpy(ref[f"coll/{n}/g"])
    sh = torch.from_numpy(ref[f"coll/{n}/sh"])
    mesh = make_mesh((n, 1), ("data", "model"), "cpu")
    for chunks in (1, 2):
        red = FsdpReducer(mesh, "data", engine=ProgressEngine(),
                          spec=CollectiveSpec(backend="user",
                                              algorithm=algorithm,
                                              chunks=chunks))
        for _ in range(2):
            got = red.ireduce_scatter([g, g.flip(0)]).wait(timeout=60)
            np.testing.assert_array_equal(got[0].numpy(),
                                          ref[f"coll/{n}/rs"])
            np.testing.assert_array_equal(got[1].numpy(),
                                          ref[f"coll/{n}/rs"])
            full = red.gather([sh, sh], timeout=60)
            for f in full:
                np.testing.assert_array_equal(f.numpy(), ref[f"coll/{n}/ag"])
        assert red.gathers == 2 and len(red._persistent) == 4
        assert red.dispatches_per_step > 0
        red.close()

    class Layout:
        widths = [8 * n]
    Layout.n = n
    _, _, ag_fn, rs_fn = build_fsdp_programs(None, None, mesh, Layout)
    np.testing.assert_array_equal(rs_fn([g])[0].numpy(), ref[f"coll/{n}/rs"])
    np.testing.assert_array_equal(ag_fn([sh])[0].numpy(), ref[f"coll/{n}/ag"])


_TRAJECTORIES: dict = {}


def assert_copies_equal(leaves):
    """Each ``RankShards`` leaf's every copy equals its first copy (the
    data axis's leaders) bit for bit."""
    for leaf in leaves:
        n = len(leaf.blocks)
        for i, t in enumerate(leaf.shards):
            assert torch.equal(t, leaf.shards[i % n]), (leaf, i)


def _port_trajectory(ref, dd, mm, user, tmp_path, per_device=False):
    """10 FSDP steps of the port on a (dd, mm) mesh (``per_device``: a
    device per rank, ``["cpu"] * (dd * mm)``): losses, final params, the
    reducer (user) or None.  A per-device run checks after every step
    that each copy of a block (a model axis) equals its leader's, the
    shards' and the moments'.  The runs are deterministic, so each
    rank-stacked one runs once in this module and is kept."""
    key = (dd, mm, user)
    if not per_device and key in _TRAJECTORIES:
        return _TRAJECTORIES[key]
    out = _run_trajectory(ref, dd, mm, user, tmp_path, per_device)
    if not per_device:
        _TRAJECTORIES[key] = out
    return out


def _run_trajectory(ref, dd, mm, user, tmp_path, per_device):
    from repro_torch.collectives import CollectiveSpec, FsdpLayout, \
        FsdpReducer
    from repro_torch.configs import get_config
    from repro_torch.core import ProgressEngine
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import build_fsdp_programs
    from repro_torch.models import bridge
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_loop import FsdpStep, Trainer, \
        TrainLoopConfig
    cfg = get_config("smollm-360m").with_overrides(**TINY)
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=STEPS)
    params = bridge.params_from_numpy(unflatten(ref, "init"), device="cpu")
    mesh = make_mesh((dd, mm), ("data", "model"),
                     devices=["cpu"] * (dd * mm)) \
        if per_device else make_mesh((dd, mm), ("data", "model"), "cpu")
    layout = FsdpLayout(params, dd, BUCKET)
    np.testing.assert_array_equal(layout.widths,
                                  ref[f"traj/{dd}x{mm}/widths"])
    grad_fn, apply_fn, ag_fn, rs_fn = build_fsdp_programs(cfg, ocfg, mesh,
                                                          layout)
    shards = layout.shard_params(params, mesh)
    state = opt.init_shards(shards)
    it = iter(SyntheticLM(cfg.vocab_size, 16, 4, seed=11))
    batches = [{k: torch.from_numpy(v.copy()) for k, v in next(it).items()}
               for _ in range(STEPS)]
    if not user:
        losses = []
        for b in batches:
            smets, fg = grad_fn(ag_fn(shards), b)
            shards, state, m = apply_fn(shards, state, rs_fn(fg), smets)
            losses.append(m["loss"].item())
            if per_device:
                assert_copies_equal([*shards, *state.mu, *state.nu])
        return losses, layout.unshard_params(shards), None

    class ListPipe:
        def __init__(self, bs):
            self.bs = list(bs)

        def next_batch(self):
            return self.bs.pop(0)

    eng = ProgressEngine()
    spec = CollectiveSpec(backend="user", chunks=2)
    reducer = FsdpReducer(mesh, "data", engine=eng, spec=spec,
                          bucket_bytes=BUCKET)
    losses = {}
    hooks = [lambda s, m: losses.__setitem__(s, m["loss"])]
    if per_device:
        hooks.append(lambda s, m: assert_copies_equal(
            [*tr.params, *tr.opt_state.mu, *tr.opt_state.nu]))
    tr = Trainer(None, shards, state, ListPipe(batches), TrainLoopConfig(
        total_steps=STEPS, checkpoint_every=10 ** 6,
        checkpoint_dir=str(tmp_path / f"{dd}x{mm}"), log_every=1,
        resume=False, collective_spec=spec), engine=eng,
        split_step=FsdpStep(grad_fn, apply_fn, reducer, spec=spec),
        hooks=hooks)
    tr.run()
    reducer.close()
    assert tr.cfg.collective_backend == "user"
    return [losses[s] for s in range(STEPS)], \
        layout.unshard_params(tr.params), reducer


@pytest.mark.parametrize("dd,mm", MESHES)
def test_trajectory_matches_jax_native(ref, dd, mm, tmp_path):
    """The port's native and user FSDP trajectories against the JAX
    native FSDP path: 10 losses within ``LOSS_TOL`` and the final
    parameters within ``PARAM_TOL``."""
    want_losses = ref[f"traj/{dd}x{mm}/losses"]
    want = {k[len(f"traj/{dd}x{mm}/final/"):]: v for k, v in ref.items()
            if k.startswith(f"traj/{dd}x{mm}/final/")}
    for user in (False, True):
        losses, final, _ = _port_trajectory(ref, dd, mm, user, tmp_path)
        np.testing.assert_allclose(losses, want_losses, **LOSS_TOL)
        got = flat_numpy(final)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                       **PARAM_TOL)


@pytest.mark.parametrize("dd,mm", MESHES)
def test_user_matches_native_bitwise(ref, dd, mm, tmp_path):
    """The ``Trainer``/``FsdpReducer`` path against the port's native
    FSDP step, bit for bit: the same losses and final parameters; with
    more than one data rank the prefetch hid part of its gathers."""
    native, n_final, _ = _port_trajectory(ref, dd, mm, False, tmp_path)
    user, u_final, reducer = _port_trajectory(ref, dd, mm, True, tmp_path)
    assert user == native
    a, b = flat_numpy(u_final), flat_numpy(n_final)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert reducer.gathers == STEPS
    if dd > 1:
        assert reducer.prefetch_overlap > 0


def test_launcher_fsdp_user_matches_native(tmp_path):
    """``launch.train --devices 4 --fsdp`` on both backends (tiny, f32 on
    the CPU): the same losses (4 ranks: the ring's sum order differs
    from the plain sum, so within 1e-6), the fsdp line and the prefetch
    overlap printed, launches per step derived for 4 ranks."""
    import contextlib
    import io

    from repro_torch.launch import train as launch
    runs = {}
    for backend in ("native", "user"):
        args = launch.build_parser().parse_args([
            "--device", "cpu", "--scale", "tiny", "--steps", "4",
            "--global-batch", "8", "--seq", "16", "--devices", "4",
            "--fsdp", "--collective-backend", backend,
            "--ckpt-dir", str(tmp_path / backend)])
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            report = launch.run(args, log_every=1)
        runs[backend] = [m["loss"] for m in report.log]
        assert "fsdp: 1 bucket(s)" in out.getvalue()
        assert ("prefetch overlap" in out.getvalue()) == (backend == "user")
        assert report.layout.n == 4
        ck = report.trainer.ckpt.latest_step()
        assert ck == 3
    assert len(runs["user"]) == 4
    np.testing.assert_allclose(runs["user"], runs["native"], rtol=1e-6)


def test_launcher_fsdp_refusals(tmp_path):
    from repro_torch.launch import train as launch
    parse = launch.build_parser().parse_args
    base = ["--device", "cpu", "--scale", "tiny", "--steps", "2",
            "--ckpt-dir", str(tmp_path)]
    for extra, what in (
            (["--fsdp", "--devices", "4", "--microbatches", "2"],
             "does not compose"),
            (["--fsdp", "--devices", "4", "--cast-bf16"], "does not compose"),
            (["--mesh", "2x2", "--collective-backend", "user"],
             "requires --fsdp"),
            (["--fsdp", "--devices", "4", "--chaos-kill", "1"],
             "require --collective-backend user")):
        with pytest.raises(SystemExit, match=what):
            launch.run(parse(base + extra))


# ---------------------------------------------------------------------------
# a device per rank: ZeRO shards as RankShards blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_shard_params_per_device_equal_the_stacks(ref, n):
    """On a mesh with a device per rank, ``shard_params`` gives one
    ``RankShards`` of blocks per bucket, rank r's ``[1, W/n]`` on its
    device; glued they are the stacked ``[n, W/n]`` bit for bit, and
    ``unshard_params`` round trips (int32 buckets too)."""
    from repro_torch.collectives import FsdpLayout
    from repro_torch.collectives.rank_shards import RankShards
    from repro_torch.launch.mesh import make_mesh
    tree = to_torch(unflatten(ref, "tree"))
    mesh = make_mesh((n, 1), ("data", "model"), devices=["cpu"] * n)
    for bb in (1 << 20, 40):
        lay = FsdpLayout(tree, n, bb)
        stacked = lay.shard_params(tree)
        blocks = lay.shard_params(tree, mesh)
        assert len(blocks) == lay.num_buckets > 0
        for s, b in zip(stacked, blocks):
            assert isinstance(b, RankShards) and not b.replica
            assert b.devices == mesh.devices and b[0].shape == (1,) + \
                tuple(s.shape[1:])
            assert torch.equal(b.to_stacked("cpu"), s)
        back, want = flat_numpy(lay.unshard_params(blocks)), flat_numpy(tree)
        assert back.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(back[k], want[k], err_msg=k)


@pytest.mark.parametrize("dd", [2, 4])
def test_user_trajectory_per_device_equals_the_stacked_one(ref, dd,
                                                           tmp_path):
    """The ``Trainer``'s user FSDP trajectory with a device per rank
    (``["cpu"] * dd``): the losses and final parameters of the
    rank-stacked trajectory bit for bit, and so the JAX native FSDP
    reference's within ``LOSS_TOL``/``PARAM_TOL``; one compute future a
    device, the prefetch chained off them."""
    stacked, s_final, _ = _port_trajectory(ref, dd, 1, True, tmp_path)
    losses, final, reducer = _port_trajectory(ref, dd, 1, True, tmp_path,
                                              per_device=True)
    assert reducer.mesh.per_device and reducer.gathers == STEPS
    assert losses == stacked
    got, want = flat_numpy(final), flat_numpy(s_final)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(losses, ref[f"traj/{dd}x1/losses"],
                               **LOSS_TOL)
    for k in want:
        np.testing.assert_allclose(got[k], ref[f"traj/{dd}x1/final/{k}"],
                                   err_msg=k, **PARAM_TOL)


@pytest.mark.parametrize("backend", ["user", "native"])
def test_launcher_rank_devices_fsdp_equals_the_stacked_run(tmp_path,
                                                           backend):
    """``launch.train --devices 4 --fsdp --collective-backend {user,native}
    --rank-devices cpu,cpu,cpu,cpu``: the stacked run's losses on the same
    backend bit for bit, the shards ``RankShards`` blocks with a replica
    step counter on every rank's device, and the last checkpoint's files
    equal the stacked run's byte for byte; it restores equal.  The native
    pair took the ordered route (ranks on the CPU): four ranks' sums in
    rank order are the stacked sums over the rank dim."""
    import contextlib
    import io

    from repro_torch.collectives import native_devices
    from repro_torch.collectives.rank_shards import RankShards
    from repro_torch.launch import train as launch
    runs = {}
    for name, extra in (("stacked", []),
                        ("dev", ["--rank-devices", "cpu,cpu,cpu,cpu"])):
        args = launch.build_parser().parse_args([
            "--device", "cpu", "--scale", "tiny", "--steps", "3",
            "--global-batch", "8", "--seq", "16", "--devices", "4",
            "--fsdp", "--collective-backend", backend,
            "--ckpt-dir", str(tmp_path / name)] + extra)
        native_devices.reset_routes()
        with contextlib.redirect_stdout(io.StringIO()):
            runs[name] = launch.run(args, log_every=1)
    layout = runs["dev"].layout
    assert native_devices.routes == {
        "nccl": 0, "ordered": 3 * 2 * layout.num_buckets
        if backend == "native" else 0}
    assert (runs["dev"].reducer is None) == (backend == "native")
    a, b = runs["stacked"], runs["dev"]
    assert [m["loss"] for m in b.log] == [m["loss"] for m in a.log]
    tr = b.trainer
    assert all(isinstance(s, RankShards) and not s.replica
               and len(s) == 4 for s in tr.params)
    assert tr.opt_state.step.replica and len(tr.opt_state.step) == 4
    for s, t in zip(tr.params, a.trainer.params):
        assert torch.equal(s.to_stacked("cpu"), t)
    da = tmp_path / "stacked" / "smollm-360m-fsdp" / "step_2"
    db = tmp_path / "dev" / "smollm-360m-fsdp" / "step_2"
    names = sorted(p.name for p in da.iterdir())
    assert names == sorted(p.name for p in db.iterdir())
    for name in names:
        assert (da / name).read_bytes() == (db / name).read_bytes(), name
    got = tr.ckpt.restore(2, {"params": tr.params,
                              "opt_state": tr.opt_state})
    for s, t in zip(got["params"], tr.params):
        assert s.devices == t.devices and torch.equal(s.to_stacked("cpu"),
                                                      t.to_stacked("cpu"))
    assert got["opt_state"].step.replica
    assert [int(x) for x in got["opt_state"].step] == [3] * 4


def test_native_trajectory_per_device_on_a_model_axis(ref, tmp_path):
    """The native FSDP step on a 2x2 mesh with a device per rank
    (``["cpu"] * 4``: the pair of ``collectives.native_devices`` over the
    two leaders, the ordered route): the losses and final parameters of
    the rank-stacked native (2, 2) trajectory bit for bit (a two-term sum
    is the same in any order), every copy its leader's after every step,
    and so the JAX native FSDP reference on (2, 2) within
    ``LOSS_TOL``/``PARAM_TOL``.  Four ranks' sums in rank order are held
    bit for bit by the launcher's native run below."""
    stacked, s_final, _ = _port_trajectory(ref, 2, 2, False, tmp_path)
    losses, final, _ = _port_trajectory(ref, 2, 2, False, tmp_path,
                                        per_device=True)
    assert losses == stacked
    got, want = flat_numpy(final), flat_numpy(s_final)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(losses, ref["traj/2x2/losses"], **LOSS_TOL)
    for k in want:
        np.testing.assert_allclose(got[k], ref[f"traj/2x2/final/{k}"],
                                   err_msg=k, **PARAM_TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_native_pair_per_device_matches_jax_int32(ref, n):
    """``native_reduce_scatter`` / ``native_all_gather`` /
    ``native_allreduce`` over ``RankShards`` on ``["cpu"] * n`` against
    JAX's ``psum_scatter`` / ``all_gather`` on int32, bit for bit (the
    allreduce's every rank the whole sum), each result on its rank's
    device, the inputs unchanged; and the per-device ``ag_fn``/``rs_fn``
    of ``build_fsdp_programs`` likewise."""
    from repro_torch.collectives import native_devices as ND
    from repro_torch.collectives.rank_shards import RankShards
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import build_fsdp_programs
    g = torch.from_numpy(ref[f"coll/{n}/g"])
    sh = torch.from_numpy(ref[f"coll/{n}/sh"])
    mesh = make_mesh((n, 1), ("data", "model"), devices=["cpu"] * n)
    gs, shs = RankShards.from_stacked(g, mesh), RankShards.from_stacked(sh,
                                                                        mesh)
    ND.reset_routes()
    rs = ND.native_reduce_scatter(gs)
    ag = ND.native_all_gather(shs)
    ar = ND.native_allreduce(gs)
    assert ND.routes == {"nccl": 0, "ordered": 3}
    np.testing.assert_array_equal(torch.stack(rs.shards).numpy(),
                                  ref[f"coll/{n}/rs"])
    np.testing.assert_array_equal(torch.stack(ag.shards).numpy(),
                                  ref[f"coll/{n}/ag"])
    for s in ar.shards:
        np.testing.assert_array_equal(s[0].numpy(),
                                      ref[f"coll/{n}/rs"].reshape(-1))
    assert ar.replica and ag.replica and not rs.replica
    assert torch.equal(gs.to_stacked("cpu"), g)
    assert torch.equal(shs.to_stacked("cpu"), sh)

    class Layout:
        widths = [8 * n]
    Layout.n = n
    _, _, ag_fn, rs_fn = build_fsdp_programs(None, None, mesh, Layout)
    got = rs_fn([gs])[0]
    assert got.devices == mesh.devices and got[0].shape == (1, 8)
    np.testing.assert_array_equal(got.to_stacked("cpu").numpy(),
                                  ref[f"coll/{n}/rs"])
    full = ag_fn([shs])[0]
    assert full[0].shape == (1, 6 * n)
    np.testing.assert_array_equal(full.to_stacked("cpu").numpy(),
                                  ref[f"coll/{n}/ag"])


def test_user_trajectory_per_device_on_a_model_axis(ref, tmp_path):
    """The ``Trainer``'s user FSDP trajectory on a 2x2 mesh with a device
    per rank: every rank of data rank d holds a copy of its blocks and
    moments, the reducer runs over the two leaders (a (2, 1) column), and
    after every step each copy equals its leader's; the losses and final
    parameters equal the rank-stacked (2, 2) trajectory's bit for bit, and
    hold the JAX native FSDP reference on (2, 2) within ``LOSS_TOL``/
    ``PARAM_TOL``."""
    stacked, s_final, _ = _port_trajectory(ref, 2, 2, True, tmp_path)
    losses, final, reducer = _port_trajectory(ref, 2, 2, True, tmp_path,
                                              per_device=True)
    assert dict(reducer.mesh.shape) == {"data": 2, "model": 1}
    assert reducer.mesh.per_device and reducer.gathers == STEPS
    assert losses == stacked
    got, want = flat_numpy(final), flat_numpy(s_final)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(losses, ref["traj/2x2/losses"], **LOSS_TOL)
    for k in want:
        np.testing.assert_allclose(got[k], ref[f"traj/2x2/final/{k}"],
                                   err_msg=k, **PARAM_TOL)


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_launcher_fsdp_on_a_model_axis_per_device(tmp_path, mesh,
                                                  monkeypatch):
    """``launch.train --mesh DxM --fsdp --collective-backend user
    --rank-devices cpu,...`` (D·M devices): every rank of data rank d
    holds a copy of its blocks, moments and a step counter; after every
    AdamW step each copy equals its leader's bit for bit, and the grad
    norm adds D partials (one a data rank, not one a copy); the losses
    and grad norms equal the stacked ``--mesh DxM --fsdp`` run's and the
    per-device ``--mesh Dx1`` run's bit for bit, the shards the stacked
    run's, and the last checkpoint's files the stacked run's byte for
    byte; it restores into every copy."""
    import contextlib
    import io

    from repro_torch.collectives.rank_shards import RankShards
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import axis_order, make_mesh
    from repro_torch.train import optimizer as opt
    D, M = (int(v) for v in mesh.split("x"))
    partials, steps = [], []
    real_sq, real_apply = opt._sum_squares, opt._apply_shards_per_device

    def apply_and_check(cfg, state, shards, grads, scale):
        out = real_apply(cfg, state, shards, grads, scale)
        assert_copies_equal([*out[0], *out[1].mu, *out[1].nu])
        steps.append(1)
        return out

    monkeypatch.setattr(opt, "_sum_squares",
                        lambda *a: partials.append(1) or real_sq(*a))
    monkeypatch.setattr(opt, "_apply_shards_per_device", apply_and_check)
    runs = {}
    for name, extra in (
            ("stacked", ["--mesh", mesh]),
            ("column", ["--mesh", f"{D}x1", "--rank-devices",
                        ",".join(["cpu"] * D)]),
            ("dev", ["--mesh", mesh, "--rank-devices",
                     ",".join(["cpu"] * (D * M))])):
        args = launch.build_parser().parse_args([
            "--device", "cpu", "--scale", "tiny", "--steps", "2",
            "--global-batch", "8", "--seq", "16", "--fsdp",
            "--collective-backend", "user",
            "--ckpt-dir", str(tmp_path / name)] + extra)
        partials.clear()
        steps.clear()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            runs[name] = launch.run(args, log_every=1)
    assert f"a copy on each of model={M} card(s) a row" in out.getvalue()
    assert len(steps) == 2 and len(partials) == 2 * D
    a, c, b = runs["stacked"], runs["column"], runs["dev"]
    for key in ("loss", "grad_norm"):
        want = [m[key] for m in a.log]
        assert [m[key] for m in b.log] == want == [m[key] for m in c.log]
    tr = b.trainer
    devices = axis_order(make_mesh((D, M), ("data", "model"),
                                   devices=["cpu"] * (D * M)), "data")
    for s, t in zip(tr.params, a.trainer.params):
        assert isinstance(s, RankShards) and s.copies == M
        assert len(s) == D * M and list(s.devices) == devices
        assert torch.equal(s.to_stacked("cpu"), t)
    assert tr.opt_state.step.replica and len(tr.opt_state.step) == D * M
    assert b.reducer.axis_size == D
    da = tmp_path / "stacked" / "smollm-360m-fsdp" / "step_1"
    db = tmp_path / "dev" / "smollm-360m-fsdp" / "step_1"
    names = sorted(p.name for p in da.iterdir())
    assert names == sorted(p.name for p in db.iterdir())
    for name in names:
        assert (da / name).read_bytes() == (db / name).read_bytes(), name
    got = tr.ckpt.restore(1, {"params": tr.params,
                              "opt_state": tr.opt_state})
    for s, t in zip(got["params"], tr.params):
        assert s.copies == M
        for x, y in zip(s.shards, t.shards):
            assert torch.equal(x, y)
    assert [int(x) for x in got["opt_state"].step] == [2] * (D * M)


def test_reshard_restore_onto_a_per_device_mesh(ref, tmp_path):
    """Save full tensors, restore onto a 2x2 mesh with a device per rank:
    each leaf a ``RankShards`` whose shard r is the block JAX's
    ``NamedSharding(mesh, spec).devices_indices_map(shape)`` gives the
    r-th device of the same mesh (composed axes and a non-leading dim
    too), a replicated leaf whole on every device; the specs as JAX's;
    an unknown logical axis raises."""
    from repro_torch.collectives.rank_shards import RankShards
    from repro_torch.core import ProgressEngine
    from repro_torch.distributed import elastic
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.checkpoint import AsyncCheckpointer
    gen = torch.Generator().manual_seed(4)
    tree = {name: torch.randn(shape, generator=gen)
            for name, _, shape in PLACEMENTS}
    ck = AsyncCheckpointer(str(tmp_path), ProgressEngine())
    ck.save_blocking(7, tree)
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    like = {k: torch.zeros_like(v) for k, v in tree.items()}
    restored, specs = elastic.reshard_restore(
        ck, 7, like, PLACEMENT_AXES, mesh, rules_overrides=PLACEMENT_RULES)
    for name, spec, shape in PLACEMENTS:
        assert specs[name] == spec, name
        leaf = restored[name]
        assert isinstance(leaf, RankShards) and leaf.devices == mesh.devices
        assert leaf.replica == (spec == ())
        for r in range(4):
            bounds = ref[f"place/{name}/{r}"]
            want = tree[name][tuple(slice(int(a), int(b)) for a, b in bounds)]
            assert torch.equal(leaf[r], want), (name, r)
    with pytest.raises(KeyError):
        elastic.reshard_restore(ck, 7, like, dict(PLACEMENT_AXES,
                                                  b=("nope",)), mesh)
