"""Data-parallel training of the port against the JAX package: tiny
smollm-360m in f32, 4 ranks, 3 steps.

The JAX side is the JAX launcher itself, ``repro.launch.train --devices 4
--mesh 4x1 --collective-backend user``, in a child with 4 host devices
(its config forced to f32, its trainer logging every step, its model's
shard hints kept out of the manual ``shard_map`` region as the launcher
intends); the child also saves the weights that launcher draws from
``PRNGKey(0)``.  The port's launcher runs the same weights (bridged through numpy) on the same
``SyntheticLM`` stream, once with ``--devices 4 --collective-backend
user`` (per-rank gradients, the engine grad reducer's ring allreduce,
AdamW on the mean) and once natively on one rank.  The per-step losses
agree within 1e-5, the final parameters within 1e-5 of the port's own
native run and within 2e-5 of the JAX launcher's (``PARAM_TOL``).

With ``--rank-devices cpu,cpu,cpu,cpu`` each rank holds its own replica
of the weights and AdamW state (a mesh with one device per rank): its
losses and every replica's final parameters equal the rank-stacked run's
bit for bit (a chaos kill's too), and hold the JAX launcher within the
same limits.  On the native backend the ranks' gradients meet in
``collectives.native_devices`` (ranks on the CPU: the sum in rank order
on rank 0's device): every replica equals a plain composition (the
stacked ``make_rank_grads`` gradients summed over the rank dim, times
1/4, then AdamW) bit for bit, and the losses hold the port's stacked
native run (also in 2 microbatches) and the JAX launcher.

The port's runs that several tests compare with run once a module
(fixtures)."""
import argparse
from pathlib import Path

import numpy as np
import pytest
import torch

from tests._multidevice import run_with_devices

STEPS = 3
ARGV = ["--arch", "smollm-360m", "--scale", "tiny", "--steps", str(STEPS),
        "--global-batch", "8", "--seq", "16"]
TOL = dict(rtol=1e-5, atol=1e-5)
# parameters against the JAX launcher: AdamW divides each moment by the
# root of its second moment, so an embedding row's small gradient carries
# its f32 noise (the libraries' product orders differ) into the update at
# full step size — 1.03e-5 at most, 17 of 106816 values above 1e-6
PARAM_TOL = dict(rtol=1e-5, atol=2e-5)

_JAX_CHILD = """
import dataclasses, sys, warnings
sys.path.insert(0, {root!r})
warnings.simplefilter("ignore")
import jax, numpy as np
import repro.configs as configs
import repro.train.train_loop as tl
from repro.launch import train as launch
from repro.models import registry
from examples.train_lm import SCALES

base_get = configs.get_config
configs.get_config = lambda arch: base_get(arch).with_overrides(
    dtype="float32")
runs = []


class LoggingTrainer(tl.Trainer):
    def __init__(self, *a, **kw):
        a = list(a)
        a[4] = dataclasses.replace(a[4], log_every=1)
        super().__init__(*a, **kw)
        runs.append(self)


tl.Trainer = LoggingTrainer

# The launcher traces its per-rank gradient inside shard_map, where its
# model's shard hints are meant to do nothing; on the installed JAX the
# manual region's abstract mesh is visible to them and the hint raises.
# Hide a fully manual mesh from them (the hints place, they never compute).
import repro.sharding as shd
_mesh_of = shd._abstract_mesh


def _outside_manual():
    mesh = _mesh_of()
    types = getattr(mesh, "axis_types", ()) if mesh is not None else ()
    if types and all("Manual" in str(t) for t in types):
        return None
    return mesh


shd._abstract_mesh = _outside_manual
cfg = configs.get_config("smollm-360m").with_overrides(**SCALES["tiny"])
init = registry.init_params(cfg, jax.random.PRNGKey(0))
sys.argv = ["train"] + {argv!r} + [
    "--devices", "4", "--mesh", "4x1", "--collective-backend", "user",
    "--ckpt-dir", {ckpt!r}]
assert launch.main() == 0
tr = runs[0]
flat = {{}}
for prefix, tree in (("init", init), ("final", tr.params)):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        flat[prefix + "/" + key] = np.asarray(leaf)
flat["losses"] = np.asarray([m["loss"] for m in tr.metrics_log])
flat["steps"] = np.asarray([m["step"] for m in tr.metrics_log])
np.savez({out!r}, **flat)
print("SAVED")
"""


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


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    out = tmp / "ref.npz"
    log = run_with_devices(_JAX_CHILD.format(
        root=str(Path(__file__).resolve().parents[1]), argv=ARGV,
        ckpt=str(tmp / "ckpt"), out=str(out)), n_devices=4, timeout=600)
    assert "SAVED" in log
    return dict(np.load(out))


@pytest.fixture(scope="module")
def user_run(jax_run, tmp_path_factory):
    """The rank-stacked ``--devices 4 --mesh 4x1 --collective-backend
    user`` run: (report, losses, final)."""
    return port_run(tmp_path_factory.mktemp("user"), jax_run, USER4)


@pytest.fixture(scope="module")
def native_run(jax_run, tmp_path_factory):
    """The port's native run of the whole batch on one rank."""
    return port_run(tmp_path_factory.mktemp("native"), jax_run, [])


@pytest.fixture(scope="module")
def user_devices_run(jax_run, tmp_path_factory):
    """``USER4 --rank-devices cpu,cpu,cpu,cpu``: (report, losses)."""
    return port_run_devices(tmp_path_factory.mktemp("user_dev"), jax_run,
                            USER4 + RANK_DEVICES)


@pytest.fixture(scope="module")
def native_devices_run(jax_run, tmp_path_factory):
    """``--devices 4 --collective-backend native --rank-devices
    cpu,cpu,cpu,cpu``: (report, losses, routes taken)."""
    from repro_torch.collectives import native_devices
    native_devices.reset_routes()
    report, losses = port_run_devices(tmp_path_factory.mktemp("native_dev"),
                                      jax_run, NATIVE4 + RANK_DEVICES)
    return report, losses, dict(native_devices.routes)


def port_run(tmp_path, ref, extra):
    from repro_torch.launch import train as launch
    from repro_torch.launch.serve import make_config
    from repro_torch.models import bridge
    from repro_torch.models.layers import tree_leaves
    args = launch.build_parser().parse_args(
        ARGV + ["--device", "cpu", "--ckpt-dir", str(tmp_path)] + extra)
    cfg = make_config(args.arch, args.scale).with_overrides(dtype="float32")
    params = bridge.params_from_numpy(unflatten(ref, "init"), device="cpu")
    report = launch.run(args, config=cfg, params=params, log_every=1)
    losses = [m["loss"] for m in report.log]
    final = {"/".join(p): t.detach().numpy()
             for p, t in tree_leaves(report.trainer.params)}
    return report, losses, final


def replicas(report):
    """Every rank's final parameters of a ``--rank-devices`` run, as numpy
    by path: {path: [rank 0's, rank 1's, ...]}."""
    from repro_torch.collectives.rank_shards import RankShards
    from repro_torch.models.layers import tree_leaves
    out = {}
    for path, leaf in tree_leaves(report.trainer.params):
        assert isinstance(leaf, RankShards), path
        out["/".join(path)] = [s.detach().numpy() for s in leaf.shards]
    return out


RANK_DEVICES = ["--rank-devices", "cpu,cpu,cpu,cpu"]
USER4 = ["--devices", "4", "--mesh", "4x1", "--collective-backend", "user"]
NATIVE4 = ["--devices", "4", "--mesh", "4x1", "--collective-backend",
           "native"]


def test_rank_devices_equal_the_stacked_run_bit_for_bit(user_run,
                                                        user_devices_run):
    """A replica on each rank's device: the losses, and every replica's
    final parameters, equal the rank-stacked run's bit for bit."""
    _, losses, final = user_run
    report, dev_losses = user_devices_run
    assert dev_losses == losses
    got = replicas(report)
    assert got.keys() == final.keys()
    for k, reps in got.items():
        assert len(reps) == 4
        for r, v in enumerate(reps):
            np.testing.assert_array_equal(v, final[k], err_msg=f"{k} {r}")
    assert [str(d) for d in report.reducer.mesh.devices] == ["cpu"] * 4
    assert len(report.trainer.reduce_issue_s) == STEPS


def test_rank_devices_match_the_jax_launcher(jax_run, user_devices_run):
    """The ``--rank-devices`` run against the JAX launcher's
    ``--devices 4 --collective-backend user``: losses within 1e-5, every
    replica's parameters within ``PARAM_TOL``."""
    report, losses = user_devices_run
    np.testing.assert_allclose(losses, jax_run["losses"], **TOL)
    want = {k[len("final/"):]: v for k, v in jax_run.items()
            if k.startswith("final/")}
    got = replicas(report)
    assert got.keys() == want.keys()
    for k in want:
        for v in got[k]:
            np.testing.assert_allclose(v, want[k], err_msg=k, **PARAM_TOL)


def test_rank_devices_chaos_kill_equals_the_stacked_chaos_run(jax_run,
                                                              tmp_path):
    """``--elastic --chaos-kill 1`` after step 1: both forms remesh once
    onto 2 ranks (the per-device run onto the first 2 of the 3 surviving
    devices, keeping their replicas) and log the same losses."""
    chaos = USER4 + ["--elastic", "--chaos-kill", "1", "--chaos-kill-step",
                     "1"]
    a, losses, final = port_run(tmp_path / "stacked", jax_run, chaos)
    b, dev_losses = port_run_devices(tmp_path / "dev", jax_run,
                                     chaos + RANK_DEVICES)
    assert dev_losses == losses and len(losses) == STEPS
    assert a.trainer.recoveries == b.trainer.recoveries == 1
    assert b.reducer.remeshes == 1 and b.reducer.axis_size == 2
    for k, reps in replicas(b).items():
        assert len(reps) == 2
        for v in reps:
            np.testing.assert_array_equal(v, final[k], err_msg=k)


def port_run_devices(tmp_path, ref, extra):
    """``port_run`` for a ``--rank-devices`` run: (report, losses)."""
    from repro_torch.launch import train as launch
    from repro_torch.launch.serve import make_config
    from repro_torch.models import bridge
    args = launch.build_parser().parse_args(
        ARGV + ["--device", "cpu", "--ckpt-dir", str(tmp_path)] + extra)
    cfg = make_config(args.arch, args.scale).with_overrides(dtype="float32")
    params = bridge.params_from_numpy(unflatten(ref, "init"), device="cpu")
    report = launch.run(args, config=cfg, params=params, log_every=1)
    return report, [m["loss"] for m in report.log]


@pytest.mark.parametrize("extra,what", [
    (["--pipeline", "gpipe", "--mesh", "2x2"], "data dim 1"),
    (["--rank-devices", "cpu,cpu"], "names 2 device.s. for 4"),
    (["--mesh", "2x2", "--elastic"], "--collective-backend user on a 2-D "
                                     "mesh requires --fsdp"),
    (["--collective-backend", "native", "--chaos-kill", "1"],
     "require --collective-backend user"),
    (["--collective-backend", "native", "--fsdp", "--microbatches", "2"],
     "does not compose"),
    (["--collective-backend", "native", "--fsdp", "--cast-bf16"],
     "does not compose"),
    (["--collective-backend", "native", "--microbatches", "4"],
     "does not split into 4 microbatch"),
], ids=["pipeline", "length", "model-axis-elastic", "native-elastic",
        "native-fsdp-microbatches", "native-fsdp-cast-bf16",
        "native-microbatches-split"])
def test_rank_devices_refuses_what_the_jax_launcher_refuses(tmp_path, extra,
                                                            what):
    from repro_torch.launch import train as launch
    argv = ARGV + ["--device", "cpu", "--ckpt-dir", str(tmp_path),
                   "--devices", "4", "--collective-backend", "user",
                   "--rank-devices", "cpu,cpu,cpu,cpu"] + extra
    with pytest.raises(SystemExit, match=what):
        launch.run(launch.build_parser().parse_args(argv))


def plain_native_run(ref):
    """The native per-device step as a plain composition on the CPU, the
    launcher's batches, schedule and weights: each step the stacked
    ``make_rank_grads`` gradients ``[4, ...]`` summed over the rank dim
    and multiplied by 1/4, then ``optimizer.apply``; (losses, final)."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train as launch
    from repro_torch.launch.serve import make_config
    from repro_torch.models import bridge
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.train import optimizer as opt
    args = launch.build_parser().parse_args(ARGV)
    cfg = make_config(args.arch, args.scale).with_overrides(dtype="float32")
    params = bridge.params_from_numpy(unflatten(ref, "init"), device="cpu")
    state = opt.init(params)
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=10)
    grad_fn = launch.make_rank_grads(cfg, 4)
    it = iter(SyntheticLM(cfg.vocab_size, args.seq, args.global_batch,
                          seed=5))
    losses = []
    for _ in range(STEPS):
        batch = {k: torch.from_numpy(v.copy()) for k, v in next(it).items()}
        mets, grads = grad_fn(params, batch)
        mean = tree_map(lambda g: g.sum(0) * (1.0 / 4), grads)
        params, state, _ = opt.apply(ocfg, state, params, mean)
        losses.append(mets["loss"].mean().item())
    return losses, {"/".join(p): t.detach().numpy()
                    for p, t in tree_leaves(params)}


def test_native_rank_devices_equal_the_plain_composition(jax_run,
                                                         native_devices_run):
    """``--collective-backend native --rank-devices cpu,cpu,cpu,cpu``: the
    losses and every replica's final parameters equal the plain
    composition's bit for bit (the ranks' sum in rank order on rank 0's
    device is the stacked sum over dim 0), the replicas equal to each
    other; every reduction took the ordered route."""
    report, losses, routes = native_devices_run
    want_losses, want = plain_native_run(jax_run)
    assert losses == want_losses and len(losses) == STEPS
    got = replicas(report)
    assert got.keys() == want.keys()
    for k, reps in got.items():
        assert len(reps) == 4
        for r, v in enumerate(reps):
            np.testing.assert_array_equal(v, want[k], err_msg=f"{k} {r}")
    assert routes["nccl"] == 0 and routes["ordered"] == STEPS * len(got)
    assert report.reducer is None
    assert report.trainer.cfg.collective_backend == "native"


def test_native_rank_devices_match_the_jax_launcher(jax_run,
                                                    native_devices_run):
    """The native per-device run against the JAX launcher's: losses
    within 1e-5, every replica's parameters within ``PARAM_TOL``."""
    report, losses, _ = native_devices_run
    np.testing.assert_allclose(losses, jax_run["losses"], **TOL)
    want = {k[len("final/"):]: v for k, v in jax_run.items()
            if k.startswith("final/")}
    for k, reps in replicas(report).items():
        for v in reps:
            np.testing.assert_allclose(v, want[k], err_msg=k, **PARAM_TOL)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_native_rank_devices_hold_the_stacked_native_run(
        jax_run, native_devices_run, tmp_path, microbatches):
    """The native per-device run (with ``--microbatches 2``: each rank its
    share of each microbatch, ``make_row_grads``) against the port's
    stacked native run with the same flags: losses within 1e-5, the
    replicas equal to each other bit for bit and within 1e-5 of the
    stacked run's parameters."""
    mb = ["--microbatches", str(microbatches)]
    _, want_losses, want = port_run(tmp_path / "stacked", jax_run,
                                    NATIVE4 + mb)
    if microbatches == 1:
        report, losses, _ = native_devices_run
    else:
        report, losses = port_run_devices(tmp_path / "dev", jax_run,
                                          NATIVE4 + mb + RANK_DEVICES)
    assert len(losses) == STEPS
    np.testing.assert_allclose(losses, want_losses, **TOL)
    got = replicas(report)
    assert got.keys() == want.keys()
    for k, reps in got.items():
        for v in reps:
            np.testing.assert_array_equal(v, reps[0], err_msg=k)
        np.testing.assert_allclose(reps[0], want[k], err_msg=k, **TOL)


def test_user_backend_matches_the_jax_launcher(jax_run, user_run):
    """``--devices 4 --collective-backend user``: the JAX launcher's
    per-step losses within 1e-5, its final parameters within
    ``PARAM_TOL``."""
    report, losses, final = user_run
    assert jax_run["steps"].tolist() == list(range(STEPS))
    np.testing.assert_allclose(losses, jax_run["losses"], **TOL)
    want = {k[len("final/"):]: v for k, v in jax_run.items()
            if k.startswith("final/")}
    assert final.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(final[k], want[k], err_msg=k, **PARAM_TOL)
    assert report.trainer.cfg.collective_backend == "user"
    assert report.reducer.axis_size == 4 and report.reduce_dispatches > 0
    assert len(report.trainer.reduce_issue_s) == STEPS


def test_user_backend_matches_the_native_single_rank_run(user_run,
                                                        native_run):
    """The port's 4-rank user-backend run against its own native run of
    the whole batch on one rank: the same losses and parameters within
    1e-5 (the mean of four per-rank gradients is the batch gradient)."""
    _, losses, final = user_run
    report, native_losses, native = native_run
    assert report.reducer is None
    assert report.trainer.cfg.collective_backend == "native"
    np.testing.assert_allclose(losses, native_losses, **TOL)
    for k in native:
        np.testing.assert_allclose(final[k], native[k], err_msg=k, **TOL)


def test_launcher_refuses_what_waits_for_later_slices(tmp_path):
    from repro_torch.launch import train as launch
    parse = launch.build_parser().parse_args
    for extra, what in ((["--mesh", "2x2", "--collective-backend", "user"],
                         "requires --fsdp"),
                        (["--devices", "4", "--mesh", "2x1"], "does not hold"),
                        (["--devices", "3", "--collective-backend", "user"],
                         "does not split"),
                        (["--devices", "4", "--collective-backend", "user",
                          "--microbatches", "2"], "microbatches")):
        args = parse(ARGV + ["--device", "cpu", "--ckpt-dir",
                             str(tmp_path)] + extra)
        with pytest.raises(SystemExit, match=what):
            launch.run(args)
    assert isinstance(parse(ARGV), argparse.Namespace)
