"""The non-dense families under data-parallel, FSDP and elastic training,
shared by ``test_torch_families_*.py`` (one file a group of families, so
that ``--dist loadfile`` runs them side by side).

The JAX side is the JAX launcher itself, ``repro.launch.train --scale
tiny --devices 2 --collective-backend user``, in one child a file with 2
host devices, its config forced to f32 and its trainer logging every
step; the child saves the weights the launcher draws from ``PRNGKey(0)``
and the losses.  Two patches let the launcher's per-rank gradient trace
on the installed JAX, inside its ``shard_map``: the model's shard hints
see no fully manual mesh (as in ``test_torch_dp_train.py``), and the
``shard_map`` is built without the varying-axes check, which the SSD
scan's carry (``repro/models/mamba.py``) does not pass there.  Neither
changes what the launcher computes.

The port's launcher runs the same weights (bridged through numpy) on the
same ``SyntheticLM`` stream, 2 ranks on the CPU."""
from __future__ import annotations

import contextlib
import io
from pathlib import Path

import numpy as np

from tests._multidevice import run_with_devices

ROOT = Path(__file__).resolve().parents[1]
STEPS = 2
KILL = 0           # the chaos hook fires after this step; the next retries
TOL = dict(rtol=1e-5, atol=1e-5)
# FSDP against data-parallel: ``test_torch_fsdp.py``'s f32 loss limits
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
USER2 = ["--devices", "2", "--collective-backend", "user"]


def argv(arch: str, steps: int = STEPS) -> list:
    return ["--arch", arch, "--scale", "tiny", "--steps", str(steps),
            "--global-batch", "4", "--seq", "16"]


_JAX_CHILD = """
import dataclasses, sys, warnings
sys.path.insert(0, {root!r})
warnings.simplefilter("ignore")
import jax, numpy as np
import repro.configs as configs
import repro.sharding as shd
import repro.train.train_loop as tl
from repro import compat
from repro.launch import train as launch

base_get = configs.get_config
configs.get_config = lambda arch: base_get(arch).with_overrides(
    dtype="float32")
runs = []


class LoggingTrainer(tl.Trainer):
    def __init__(self, *a, **kw):
        a = list(a)
        a[4] = dataclasses.replace(a[4], log_every=1)
        super().__init__(*a, **kw)
        self.init_params = a[1]
        runs.append(self)


tl.Trainer = LoggingTrainer
_mesh_of = shd._abstract_mesh


def _outside_manual():
    mesh = _mesh_of()
    types = getattr(mesh, "axis_types", ()) if mesh is not None else ()
    if types and all("Manual" in str(t) for t in types):
        return None
    return mesh


shd._abstract_mesh = _outside_manual
_shard_map = compat.shard_map
compat.shard_map = lambda f, **kw: _shard_map(f, **dict(
    {{"check_vma": False}}, **kw))
flat = {{}}
for arch in {archs!r}:
    sys.argv = ["train"] + {argv!r}[arch] + [
        "--devices", "2", "--collective-backend", "user",
        "--ckpt-dir", {ckpt!r}]
    assert launch.main() == 0
    tr = runs[-1]
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tr.init_params)[0]:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        flat[arch + "/init/" + key] = np.asarray(leaf)
    flat[arch + "/losses"] = np.asarray([m["loss"] for m in tr.metrics_log])
np.savez({out!r}, **flat)
print("SAVED")
"""


def jax_launcher_runs(tmp, archs) -> dict:
    """The JAX launcher's ``--devices 2 --collective-backend user`` run of
    each of ``archs``, in one child: ``{arch/init/...: weights,
    arch/losses: losses}``."""
    out = tmp / "ref.npz"
    log = run_with_devices(_JAX_CHILD.format(
        root=str(ROOT), archs=list(archs), argv={a: argv(a) for a in archs},
        ckpt=str(tmp / "ckpt"), out=str(out)), n_devices=2, timeout=600)
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


def port_run(tmp_path, ref, arch, extra, *, steps: int = STEPS):
    """The port's launcher on ``arch`` at the tiny scale in f32, from the
    JAX child's weights: (report, losses)."""
    from repro_torch.launch import train as launch
    from repro_torch.launch.serve import make_config
    from repro_torch.models import bridge
    args = launch.build_parser().parse_args(
        argv(arch, steps) + ["--device", "cpu", "--ckpt-dir", str(tmp_path)]
        + extra)
    cfg = make_config(arch, "tiny").with_overrides(dtype="float32")
    params = bridge.params_from_numpy(unflatten(ref, arch + "/init"),
                                      device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        report = launch.run(args, config=cfg, params=params, log_every=1)
    return report, [m["loss"] for m in report.log]


def files_equal(a: Path, b: Path) -> None:
    """Two checkpoint directories hold the same files, byte for byte."""
    names = sorted(f.name for f in a.iterdir())
    assert names and names == sorted(f.name for f in b.iterdir())
    for f in names:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


def leaves_equal(a, b) -> None:
    """Two trees of tensors, or of ``RankShards`` against tensors (every
    replica), equal bit for bit."""
    import torch

    from repro_torch.collectives.rank_shards import RankShards
    from repro_torch.models.layers import tree_leaves
    got, want = tree_leaves(a), tree_leaves(b)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, x), (_, y) in zip(got, want):
        for t in x.shards if isinstance(x, RankShards) else (x,):
            assert torch.equal(t, y), path


# ---------------------------------------------------------------------------
# the tests, each parametrized over a file's families
# ---------------------------------------------------------------------------

_DP: dict = {}


def dp_run(tmp_path, ref, arch):
    """The port's ``--devices 2 --collective-backend user`` run, once a
    family in this process: (report, losses)."""
    if arch not in _DP:
        _DP[arch] = port_run(tmp_path / "dp", ref, arch, USER2)
    return _DP[arch]


def check_dp_matches_the_jax_launcher(ref, tmp_path, arch):
    _, losses = dp_run(tmp_path, ref, arch)
    assert len(losses) == STEPS
    np.testing.assert_allclose(losses, ref[arch + "/losses"], **TOL)


def check_rank_devices_equal_the_stacked_run(ref, tmp_path, arch):
    stacked, losses = dp_run(tmp_path, ref, arch)
    report, dev = port_run(tmp_path / "dev", ref, arch,
                           USER2 + ["--rank-devices", "cpu,cpu"])
    assert dev == losses
    assert [str(d) for d in report.reducer.mesh.devices] == ["cpu"] * 2
    leaves_equal(report.trainer.params, stacked.trainer.params)


def check_fsdp_user_equals_native(ref, tmp_path, arch):
    _, dp = dp_run(tmp_path, ref, arch)
    runs = {}
    for name, extra in (
            ("user", USER2 + ["--fsdp"]),
            ("native", ["--devices", "2", "--fsdp"]),
            ("dev", USER2 + ["--fsdp", "--rank-devices", "cpu,cpu"])):
        runs[name] = port_run(tmp_path / name, ref, arch, extra)[1]
    assert runs["user"] == runs["native"] == runs["dev"]
    step = f"step_{STEPS - 1}"
    for name in ("native", "dev"):
        files_equal(tmp_path / "user" / f"{arch}-fsdp" / step,
                    tmp_path / name / f"{arch}-fsdp" / step)
    np.testing.assert_allclose(runs["user"], dp, **LOSS_TOL)


def check_chaos_kill_equals_a_restart(ref, tmp_path, arch, monkeypatch):
    from repro_torch.data import pipeline
    report, chaos = port_run(tmp_path / "chaos", ref, arch, USER2 + [
        "--elastic", "--chaos-kill", "1", "--chaos-kill-step", str(KILL)])
    assert report.trainer.recoveries == 1 and len(chaos) == STEPS
    # KILL + 1 steps on 2 ranks, then the rest on the survivor, resumed
    # from the checkpoint on the stream's next batch
    _, first = port_run(tmp_path / "restart", ref, arch, USER2,
                        steps=KILL + 1)
    real = pipeline.SyntheticLM

    def resumed(*a, **kw):
        it = iter(real(*a, **kw))
        for _ in range(KILL + 1):
            next(it)
        return it

    monkeypatch.setattr(pipeline, "SyntheticLM", resumed)
    survivor, rest = port_run(tmp_path / "restart", ref, arch, [
        "--devices", "1", "--collective-backend", "user"])
    assert first + rest == chaos
    leaves_equal(report.trainer.params, survivor.trainer.params)
