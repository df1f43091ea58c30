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
native run and within 2e-5 of the JAX launcher's (``PARAM_TOL``)."""
import argparse
from pathlib import Path

import numpy as np
import pytest

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


def test_user_backend_matches_the_jax_launcher(jax_run, tmp_path):
    """``--devices 4 --collective-backend user``: the JAX launcher's
    per-step losses within 1e-5, its final parameters within
    ``PARAM_TOL``."""
    report, losses, final = port_run(
        tmp_path, jax_run, ["--devices", "4", "--mesh", "4x1",
                            "--collective-backend", "user"])
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


def test_user_backend_matches_the_native_single_rank_run(jax_run, tmp_path):
    """The port's 4-rank user-backend run against its own native run of
    the whole batch on one rank: the same losses and parameters within
    1e-5 (the mean of four per-rank gradients is the batch gradient)."""
    _, losses, final = port_run(tmp_path / "user", jax_run, [
        "--devices", "4", "--collective-backend", "user"])
    report, native_losses, native = port_run(tmp_path / "native", jax_run,
                                             [])
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
