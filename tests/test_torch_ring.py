"""The model axis in training, against the JAX package on the CPU: ring
attention (``collectives/ring_attention.py``) and the MoE block's
tensor-parallel schedule (``layers._MoEBlockTP``), each on its own and
in whole models; the train launcher's ``--mesh DxM`` native path.

One JAX child with 4 host devices (``tests/_multidevice.run_with_devices``)
computes the references: JAX's ``ring_attention`` under ``(data, model)``
meshes of 2 and 4 model ranks (its ``custom_vjp`` and, with a logit cap,
its AD), and ``jax.value_and_grad`` of ``registry.loss_fn`` under a
``(1, 4)`` mesh for reduced smollm-360m with "ring", grok-1 with
``expert_d_ff=2048`` (F/tp = 512: the ring's capped body and the MoE
block's hand-placed VJP) and zamba2-1.2b with "ring" at its shared
block.  A second child runs the JAX train launcher on ``--mesh 1x4``.
Inputs are numpy-seeded, weights bridged through numpy, all in f32.

Tolerances: the ring's output 1e-5 and its gradients 1e-4 absolute (XLA
and PyTorch sum in other orders); losses 1e-5 relative; a model's
gradient leaves within 1e-4 of the leaf's largest entry; the launchers'
per-step losses 1e-5.  The fallbacks and the other-thread backward are
held bit for bit.

The model axis with a device per rank (``make_mesh(..., devices=["cpu"]
* n)``, the CPU's stand-in for a card a rank) is held bit for bit against
the rank-stacked form: the ring on its own, whole models (their backward
on another thread), and the train launcher's ``--mesh 1xM --rank-devices``
(its losses and checkpoint files); ``--mesh 2x2 --rank-devices`` within
1e-5 of the stacked run, and every per-device run against the JAX
launcher's losses within 1e-5."""
import dataclasses
import importlib
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from tests._multidevice import run_with_devices

ROOT = Path(__file__).resolve().parents[1]
B_OP, S_OP, H_OP, KVH_OP, HD_OP = 2, 128, 6, 2, 32
B_MODEL, S_MODEL = 2, 32
MODELS = ("smollm", "grok", "zamba2")
STEPS = 3
ARGV = ["--arch", "smollm-360m", "--scale", "tiny", "--steps", str(STEPS),
        "--global-batch", "8", "--seq", "16"]
GROK_ARGV = ["--arch", "grok-1-314b"] + ARGV[2:]

# the reduced configs, built alike in the child and here: conftest's
# reduce_cfg in f32 with "ring"; grok's experts 2048 wide, so that 4
# model ranks split them into the JAX block's 512 minimum
_CONFIGS = """
def model_cfg(name):
    from conftest import reduce_cfg
    from repro.configs import get_config
    arch = {"smollm": "smollm-360m", "grok": "grok-1-314b",
            "zamba2": "zamba2-1.2b"}[name]
    cfg = reduce_cfg(get_config(arch), dtype="float32",
                     attention_impl="ring")
    if name == "grok":
        cfg = cfg.with_overrides(moe=cfg.moe.__class__(
            num_experts=4, top_k=2, expert_d_ff=2048, group_size=64))
    return cfg
"""

_JAX_CHILD = """
import sys, warnings
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
warnings.simplefilter("ignore")
import jax, jax.numpy as jnp, numpy as np
from repro import compat
from repro.collectives.ring_attention import ring_attention
from repro.models import registry
"""

_JAX_CHILD_BODY = """
out = {{}}
rs = np.random.RandomState(0)
q = rs.randn({B}, {S}, {H}, {HD}).astype(np.float32)
k = rs.randn({B}, {S}, {KVH}, {HD}).astype(np.float32)
v = rs.randn({B}, {S}, {KVH}, {HD}).astype(np.float32)
do = rs.randn({B}, {S}, {H}, {HD}).astype(np.float32)
for n in (2, 4):
    mesh = compat.make_mesh((4 // n, n), ("data", "model"))
    for cap in (0.0, 30.0):
        f = lambda q_, k_, v_: ring_attention(q_, k_, v_, causal=True,
                                              logit_cap=cap)
        with compat.set_mesh(mesh):
            o, vjp = jax.vjp(jax.jit(f), q, k, v)
            grads = vjp(jnp.asarray(do))
        for name, t in zip(("o", "dq", "dk", "dv"), (o,) + tuple(grads)):
            out[f"op/{{n}}/{{int(cap)}}/{{name}}"] = np.asarray(t)


def with_lora(params):
    lrs = np.random.RandomState(7)
    lora = {{kk: jnp.asarray((0.3 * lrs.randn(*vv.shape)).astype(np.float32))
            for kk, vv in params["site_lora"].items()}}
    return dict(params, site_lora=lora)


mesh = compat.make_mesh((1, 4), ("data", "model"))
for name in {models!r}:
    cfg = model_cfg(name)
    params = registry.init_params(cfg, jax.random.PRNGKey(1))
    if name == "zamba2":
        params = with_lora(params)
    trs = np.random.RandomState(2)
    toks = trs.randint(0, cfg.vocab_size, size=({BM}, {SM} + 1)).astype(
        np.int32)
    batch = {{"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])}}
    with compat.set_mesh(mesh):
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: registry.loss_fn(p, cfg, batch), has_aux=True))(params)
    out[f"model/{{name}}/loss"] = np.asarray(loss)
    out[f"model/{{name}}/tokens"] = toks
    for prefix, tree in (("init", params), ("grad", grads)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(getattr(p, "key", p)) for p in path)
            out[f"model/{{name}}/{{prefix}}/{{key}}"] = np.asarray(leaf)
np.savez({out!r}, **out)
print("SAVED")
"""

_JAX_LAUNCHER_CHILD = """
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
    dtype="float32", attention_impl="ring")
runs = []


class LoggingTrainer(tl.Trainer):
    def __init__(self, *a, **kw):
        a = list(a)
        a[4] = dataclasses.replace(a[4], log_every=1)
        super().__init__(*a, **kw)
        self.init_params = a[1]
        runs.append(self)


tl.Trainer = LoggingTrainer
cfg = configs.get_config("smollm-360m").with_overrides(**SCALES["tiny"])
init = registry.init_params(cfg, jax.random.PRNGKey(0))
sys.argv = ["train"] + {argv!r} + [
    "--devices", "4", "--mesh", "1x4", "--ckpt-dir", {ckpt!r}]
assert launch.main() == 0
tr = runs[0]
flat = {{}}
for path, leaf in jax.tree_util.tree_flatten_with_path(init)[0]:
    key = "/".join(str(getattr(p, "key", p)) for p in path)
    flat["init/" + key] = np.asarray(leaf)
flat["losses"] = np.asarray([m["loss"] for m in tr.metrics_log])
flat["steps"] = np.asarray([m["step"] for m in tr.metrics_log])
# the same run in 2 microbatches a step (build_cell's accumulation)
sys.argv = ["train"] + {argv!r} + [
    "--devices", "4", "--mesh", "1x4", "--microbatches", "2",
    "--ckpt-dir", {ckpt!r} + "-mb"]
assert launch.main() == 0
flat["mb_losses"] = np.asarray([m["loss"] for m in runs[1].metrics_log])
# grok-1 at 2x2 with experts 2048 wide (the scale's d_ff halved): each
# model rank's F-slice is 1024 wide, so the MoE block splits F
SCALES["tiny"] = dict(SCALES["tiny"], d_ff=4096)
sys.argv = ["train"] + {grok_argv!r} + [
    "--devices", "4", "--mesh", "2x2", "--ckpt-dir", {ckpt!r}]
assert launch.main() == 0
tr = runs[2]
for path, leaf in jax.tree_util.tree_flatten_with_path(tr.init_params)[0]:
    key = "/".join(str(getattr(p, "key", p)) for p in path)
    flat["grok_init/" + key] = np.asarray(leaf)
flat["grok_losses"] = np.asarray([m["loss"] for m in tr.metrics_log])
np.savez({out!r}, **flat)
print("SAVED")
"""


_JAX_LOSS_CHILD = """
import sys, warnings
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
warnings.simplefilter("ignore")
import jax, jax.numpy as jnp, numpy as np
from conftest import reduce_cfg
from repro import compat
from repro.configs import get_config
from repro.models import registry
cfg = {cfg_expr}
ref = dict(np.load({npz!r}))
params = {{}}
for key, value in ref.items():
    if key.startswith("p/"):
        node = params
        parts = key[2:].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {{}})
        node[parts[-1]] = jnp.asarray(value)
batch = {{k: jnp.asarray(ref[k]) for k in ("tokens", "labels")}}
loss = jax.jit(lambda p: registry.loss_fn(p, cfg, batch)[0])
print("NO_MESH", repr(float(loss(params))))
with compat.set_mesh(compat.make_mesh((1, 4), ("data", "model"))):
    loss = jax.jit(lambda p: registry.loss_fn(p, cfg, batch)[0])
    print("MESH", repr(float(loss(params))))
"""


def jax_ring_losses(cfg_expr: str, jparams, batch, tmp_path) -> tuple:
    """The JAX loss of ``cfg_expr`` (a config built from ``get_config``
    and conftest's ``reduce_cfg``) on numpy weights and batch, without a
    mesh and under a ``(data=1, model=4)`` mesh of 4 host devices, from
    a child: (no-mesh loss, mesh loss)."""
    import jax
    npz = tmp_path / "ring_loss_in.npz"
    flat = {"tokens": batch["tokens"], "labels": batch["labels"]}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        flat["p/" + key] = np.asarray(leaf)
    np.savez(npz, **flat)
    log = run_with_devices(_JAX_LOSS_CHILD.format(
        root=str(ROOT), tests=str(ROOT / "tests"), cfg_expr=cfg_expr,
        npz=str(npz)), n_devices=4, timeout=600)
    got = dict(line.split(" ", 1) for line in log.splitlines()
               if line.startswith(("NO_MESH ", "MESH ")))
    return float(got["NO_MESH"]), float(got["MESH"])


def port_ring_losses(params, cfg, batch) -> tuple:
    """The port's loss of ``cfg`` with "ring", without a mesh (plain
    attention) and under a ``(1, 4)`` host mesh (the ring, which a spy
    sees run), with autograd recording: (no-mesh loss, mesh loss)."""
    from repro_torch import sharding
    from repro_torch.models import registry
    RA = ring_module()
    cfg = cfg.with_overrides(attention_impl="ring")
    tb = {k: torch.from_numpy(batch[k]) for k in ("tokens", "labels")}
    rings = []
    real = (RA._RingAttention.apply, RA._ring_body)
    RA._RingAttention.apply = lambda *a: rings.append(1) or real[0](*a)
    RA._ring_body = lambda *a, **kw: rings.append(1) or real[1](*a, **kw)
    try:
        with torch.enable_grad():
            no_mesh = float(registry.loss_fn(params, cfg, tb)[0].detach())
            assert not rings
            with sharding.set_mesh(host_mesh(1, 4)):
                mesh = float(registry.loss_fn(params, cfg, tb)[0].detach())
            assert rings
    finally:
        RA._RingAttention.apply, RA._ring_body = real
    return no_mesh, mesh


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
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("ring") / "ref.npz"
    code = (_JAX_CHILD.format(root=str(ROOT), tests=str(ROOT / "tests"))
            + _CONFIGS + _JAX_CHILD_BODY.format(
                out=str(out), B=B_OP, S=S_OP, H=H_OP, KVH=KVH_OP, HD=HD_OP,
                BM=B_MODEL, SM=S_MODEL, models=MODELS))
    log = run_with_devices(code, n_devices=4, timeout=600)
    assert "SAVED" in log
    return dict(np.load(out))


def model_cfg(name):
    """The port's twin of the child's config."""
    from repro_torch.configs import get_config
    scope = {}
    exec(_CONFIGS, scope)
    jcfg = scope["model_cfg"](name)
    return get_config(jcfg.name).with_overrides(
        **{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def ring_module():
    """``collectives/ring_attention.py`` itself (the package exports its
    function under the module's name)."""
    return importlib.import_module("repro_torch.collectives.ring_attention")


def host_mesh(data, model):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((data, model), ("data", "model"), "cpu")


def op_inputs():
    rs = np.random.RandomState(0)
    shapes = ((B_OP, S_OP, H_OP, HD_OP), (B_OP, S_OP, KVH_OP, HD_OP),
              (B_OP, S_OP, KVH_OP, HD_OP), (B_OP, S_OP, H_OP, HD_OP))
    return [torch.from_numpy(rs.randn(*s).astype(np.float32))
            for s in shapes]


# ---------------------------------------------------------------------------
# ring_attention on its own
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [0, 30])
@pytest.mark.parametrize("n", [2, 4])
def test_ring_attention_matches_jax(jax_ref, monkeypatch, n, cap):
    """Causal GQA (6 heads over 2 KV heads) on n model ranks: the output
    and dq/dk/dv against JAX's ``ring_attention`` — cap 0 through the
    port's ``_RingAttention`` backward ring against JAX's
    ``custom_vjp``, cap 30 through autograd of ``_ring_body`` against
    JAX's AD of its body."""
    from repro_torch import sharding
    from repro_torch.collectives import ring_attention
    RA = ring_module()
    q, k, v, do = op_inputs()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    called = []
    real = RA._RingAttention.apply
    monkeypatch.setattr(RA._RingAttention, "apply",
                        lambda *a: called.append(1) or real(*a))
    with sharding.set_mesh(host_mesh(4 // n, n)):
        o = ring_attention(*leaves, causal=True, logit_cap=float(cap))
    assert called == ([1] if cap == 0 else [])
    grads = torch.autograd.grad(o, leaves, do)
    want = {name: jax_ref[f"op/{n}/{cap}/{name}"]
            for name in ("o", "dq", "dk", "dv")}
    np.testing.assert_allclose(o.detach().numpy(), want["o"], atol=1e-5,
                               rtol=0)
    for name, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(g.numpy(), want[name], atol=1e-4, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("case", ["no_mesh", "tp1", "indivisible",
                                  "non_causal"])
def test_fallbacks_equal_flash_attention_bit_for_bit(case):
    """Without a mesh, on a 1-rank model axis, with S not a multiple of
    the axis, and for non-causal attention, "ring" is plain attention:
    ``ops.flash_attention``'s plain version, bit for bit, forward and
    backward."""
    import contextlib

    from repro_torch import sharding
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models import layers as L
    cfg = get_config("smollm-360m").with_overrides(attention_impl="ring")
    q, k, v, do = op_inputs()
    causal = case != "non_causal"
    if case == "indivisible":
        q, k, v, do = (t[:, :S_OP - 2] for t in (q, k, v, do))
    mesh = {"no_mesh": None, "tp1": host_mesh(4, 1)}.get(case,
                                                        host_mesh(1, 4))
    ctx = sharding.set_mesh(mesh) if mesh else contextlib.nullcontext()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    with ctx:
        o = L.attention_dispatch(cfg, *leaves, causal=causal)
    assert torch.equal(o, flash_attention_plain(q, k, v, causal=causal))
    from repro_torch.kernels import ops
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ro = ops.flash_attention(*ref_leaves, causal=causal)
    for a, b in zip(torch.autograd.grad(o, leaves, do),
                    torch.autograd.grad(ro, ref_leaves, do)):
        assert torch.equal(a, b)


def device_mesh(data, model):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((data, model), ("data", "model"),
                     devices=["cpu"] * (data * model))


class RingSpy:
    """Counts the calls of the stacked ring (``_RingAttention``,
    ``_ring_body``) and of the per-device one (``_ring_per_device``), one
    an attention each."""

    def __init__(self, monkeypatch):
        RA = ring_module()
        self.calls = {"stacked": 0, "devices": 0}
        for owner, name, kind in ((RA._RingAttention, "apply", "stacked"),
                                  (RA, "_ring_body", "stacked"),
                                  (RA, "_ring_per_device", "devices")):
            real = getattr(owner, name)

            def spy(*a, _real=real, _kind=kind, **kw):
                self.calls[_kind] += 1
                return _real(*a, **kw)

            monkeypatch.setattr(owner, name, spy)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("cap", [0, 30])
@pytest.mark.parametrize("n", [2, 4])
def test_ring_per_device_equals_the_stacked_ring(jax_ref, monkeypatch, n,
                                                 cap, causal):
    """The ring with rank r's blocks on its own device (a ``(1, n)`` mesh
    of ``cpu`` listed n times) against the rank-stacked ring: the output
    and dq/dk/dv bit for bit, causal and not, cap 0 (the custom backward
    ring) and 30 (autograd through every hop); the per-device mesh never
    takes the stacked branch (a spy), and the causal runs hold JAX's
    ``ring_attention`` within the limits above."""
    from repro_torch import sharding
    from repro_torch.collectives import ring_attention
    q, k, v, do = op_inputs()
    spy = RingSpy(monkeypatch)
    got = {}
    for form, mesh in (("stacked", host_mesh(1, n)),
                       ("devices", device_mesh(1, n))):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = dict(spy.calls)
        with sharding.set_mesh(mesh):
            o = ring_attention(*leaves, causal=causal, logit_cap=float(cap))
        got[form] = [o.detach(), *torch.autograd.grad(o, leaves, do)]
        ran = {kind: spy.calls[kind] - before[kind] for kind in spy.calls}
        assert ran[form] >= 1 and ran[{"stacked": "devices",
                                       "devices": "stacked"}[form]] == 0
    for name, a, b in zip(("o", "dq", "dk", "dv"), got["stacked"],
                          got["devices"]):
        assert torch.equal(a, b), name
    if causal:
        for name, g in zip(("o", "dq", "dk", "dv"), got["devices"]):
            np.testing.assert_allclose(
                g.numpy(), jax_ref[f"op/{n}/{cap}/{name}"],
                atol=1e-5 if name == "o" else 1e-4, rtol=0, err_msg=name)


def test_ring_per_device_needs_a_row_mesh_and_its_leader():
    """A per-device mesh with a data axis above 1, or q away from rank 0's
    device, raises: the ring never falls back onto one device."""
    from repro_torch import sharding
    from repro_torch.collectives import ring_attention
    from repro_torch.launch.mesh import make_mesh
    q, k, v, _ = op_inputs()
    with sharding.set_mesh(device_mesh(2, 2)), \
            pytest.raises(ValueError, match="one data row's mesh"):
        ring_attention(q, k, v)
    mesh = make_mesh((1, 2), ("data", "model"), devices=["meta", "cpu"])
    with sharding.set_mesh(mesh), pytest.raises(ValueError, match="leader"):
        ring_attention(q, k, v)


@pytest.mark.parametrize("policy", ["none", "full"])
@pytest.mark.parametrize("name", MODELS)
def test_model_on_a_per_device_row_equals_the_stacked_model(name, policy,
                                                            monkeypatch):
    """``registry.loss_fn`` of each model with "ring" under a ``(1, 4)``
    mesh with a device per rank, its weights placed by
    ``bridge.params_on_model_axis`` (grok's experts as F-slices, the rest
    replicated on the leader), the backward run on a thread that set no
    mesh and no training mode (autograd's device thread): the loss and
    every gradient (the F-slices' glued along F) equal the rank-stacked
    ``(1, 4)`` run's bit for bit, and only the per-device ring and MoE
    block run."""
    from repro_torch import sharding
    from repro_torch.collectives.rank_shards import RankShards
    from repro_torch.models import bridge, registry
    from repro_torch.models import layers as L
    cfg = model_cfg(name).with_overrides(remat_policy=policy)
    params = registry.init_params(cfg, torch.Generator().manual_seed(0))
    toks = np.random.RandomState(6).randint(
        0, cfg.vocab_size, size=(B_MODEL, S_MODEL + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    spy = RingSpy(monkeypatch)
    blocks = {"tp": 0, "devices": 0}
    for owner, kind in ((L._MoEBlockTP, "tp"), (L._MoEBlockPerDevice,
                                                "devices")):
        monkeypatch.setattr(owner, "apply", lambda *a, _r=owner.apply,
                            _k=kind: blocks.__setitem__(_k, blocks[_k] + 1)
                            or _r(*a))
    paths, leaves = zip(*L.tree_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    with sharding.set_mesh(host_mesh(1, 4)):
        loss, _ = registry.loss_fn(params, cfg, batch)
    want = [loss.detach(), *torch.autograd.grad(loss, leaves)]
    assert spy.calls["devices"] == 0
    seen = dict(spy.calls, **blocks)
    mesh = device_mesh(1, 4)
    placed = bridge.params_on_model_axis(params, cfg, mesh)
    sliced = {p for p, t in L.tree_leaves(placed) if not t.replica}
    assert sliced == ({("layers", "moe", k) for k in ("wi_gate", "wi_up",
                                                     "wo")}
                      if name == "grok" else set())
    tree = L.tree_map(lambda t: t.shards[0] if t.replica else
                      RankShards(t.shards, dim=t.dim), placed)
    tensors = [u for _, t in L.tree_leaves(tree)
               for u in (t.shards if isinstance(t, RankShards) else (t,))]
    for t in tensors:
        t.requires_grad_(True)
    with sharding.set_mesh(mesh):
        loss, _ = registry.loss_fn(tree, cfg, batch)
    out = []
    th = threading.Thread(target=lambda: out.append(
        torch.autograd.grad(loss, tensors)))
    th.start()
    th.join()
    assert out, "the backward on the other thread failed"
    it = iter(out[0])
    got = [loss.detach()]
    for _, t in L.tree_leaves(tree):
        if isinstance(t, RankShards):
            got.append(torch.cat([next(it) for _ in t.shards], dim=t.dim))
        else:
            got.append(next(it))
    for label, a, b in zip(("loss",) + paths, want, got):
        assert torch.equal(a, b), label
    assert spy.calls["stacked"] == seen["stacked"]
    assert spy.calls["devices"] == seen["stacked"]
    assert blocks == {"tp": seen["tp"], "devices": seen["tp"]}


# ---------------------------------------------------------------------------
# the MoE block's tensor-parallel schedule
# ---------------------------------------------------------------------------

def moe_inputs(F_=2048, E=4, d=64, g=2, t=64, C=48, seed=3):
    rs = np.random.RandomState(seed)
    xg = torch.from_numpy(rs.randn(g, t, d).astype(np.float32))
    # a top-2 capacity dispatch: each token in 2 distinct experts' slots
    disp = np.zeros((g, t, E, C), np.float32)
    comb = np.zeros((g, t, E, C), np.float32)
    for gi in range(g):
        fill = np.zeros(E, int)
        for ti in range(t):
            for e in rs.choice(E, 2, replace=False):
                if fill[e] < C:
                    disp[gi, ti, e, fill[e]] = 1.0
                    comb[gi, ti, e, fill[e]] = rs.rand()
                    fill[e] += 1
    ws = [(rs.randn(*s) / np.sqrt(s[-2])).astype(np.float32)
          for s in ((E, d, F_), (E, d, F_), (E, F_, d))]
    return ([xg, torch.from_numpy(disp), torch.from_numpy(comb)]
            + [torch.from_numpy(w) for w in ws])


def test_moe_tp_block_matches_the_einsum_branch():
    """4 model ranks over F = 2048: the output and the gradients of the
    tokens, the combine weights and the three expert weights against the
    einsum branch (1e-5 of each tensor's largest entry); the dispatch
    mask gets none."""
    from repro_torch import sharding
    from repro_torch.models import layers as L
    xs = moe_inputs()
    dy = torch.from_numpy(np.random.RandomState(4).randn(
        *xs[0].shape).astype(np.float32))
    out, grads = {}, {}
    for mode in ("tp", "einsum"):
        leaves = [t.clone().requires_grad_(i != 1) for i, t in enumerate(xs)]
        if mode == "tp":
            with sharding.set_mesh(host_mesh(1, 4)), L.training_mode():
                assert L.moe_tp_ranks(2048) == 4
                y = L._moe_expert_block(*leaves)
        else:
            y = L._moe_expert_block(*leaves)
        out[mode] = y.detach()
        grads[mode] = torch.autograd.grad(
            y, [leaves[i] for i in (0, 2, 3, 4, 5)], dy)
    top = float(out["einsum"].abs().max())
    assert float((out["tp"] - out["einsum"]).abs().max()) <= 1e-5 * top
    for name, a, b in zip(("xg", "comb", "wi_gate", "wi_up", "wo"),
                          grads["tp"], grads["einsum"]):
        assert a.shape == b.shape, name
        err = float((a - b).abs().max())
        assert err <= 1e-5 * float(b.abs().max()), (name, err)


@pytest.mark.parametrize("F_,mesh,training,taken", [
    (2048, None, True, False),          # no mesh
    (2048, (4, 1), True, False),        # a model axis of 1
    (2048, (1, 4), False, False),       # not training
    (2048, (1, 3), True, False),        # F % tp != 0
    (2048, (1, 8), True, False),        # F / tp = 256 < 512
    (2048, (1, 4), True, True),         # F / tp = 512
    (1024, (2, 2), True, True),         # F / tp = 512 on a 2-D mesh
])
def test_moe_tp_branch_taken_exactly_under_jax_condition(
        monkeypatch, F_, mesh, training, taken):
    """``moe_apply`` takes the tensor-parallel block exactly when JAX's
    ``_moe_expert_block`` takes its ``shard_map`` branch: a mesh whose
    model axis tp > 1 divides F into slices of at least 512, in training
    (a spy counts the block's calls)."""
    import contextlib

    from repro_torch import sharding
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    calls = []
    real = L._MoEBlockTP.apply
    monkeypatch.setattr(L._MoEBlockTP, "apply",
                        lambda *a: calls.append(a[-1]) or real(*a))
    base = get_config("grok-1-314b")
    cfg = base.with_overrides(d_model=64, dtype="float32", moe=dataclasses
                              .replace(base.moe, num_experts=4,
                                       expert_d_ff=F_, group_size=64))
    p = L.init_tree(L.moe_spec(cfg), torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(5).randn(
        2, 64, 64).astype(np.float32))
    stack = contextlib.ExitStack()
    if mesh is not None:
        stack.enter_context(sharding.set_mesh(host_mesh(*mesh)))
    if training:
        stack.enter_context(L.training_mode())
    with stack:
        y, _ = L.moe_apply(p, x, cfg)
    assert calls == ([mesh[1]] if taken else [])
    assert torch.isfinite(y).all()


# ---------------------------------------------------------------------------
# a backward on another thread (autograd's CUDA device thread)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["none", "full", "subblock"])
@pytest.mark.parametrize("name", ["smollm", "grok"])
def test_backward_on_another_thread_matches(name, policy):
    """The forward under ``set_mesh`` and ``training_mode``, then
    ``backward`` from a thread that set neither (as autograd runs a CUDA
    backward, and a checkpoint's recompute with it): the gradients of a
    same-thread backward, bit for bit.  smollm's ring is the custom
    backward ring; grok's the capped body, and its MoE block the
    tensor-parallel schedule."""
    from repro_torch import sharding
    from repro_torch.models import layers as L
    from repro_torch.models import registry
    cfg = model_cfg(name).with_overrides(remat_policy=policy)
    params = registry.init_params(cfg, torch.Generator().manual_seed(0))
    toks = np.random.RandomState(6).randint(
        0, cfg.vocab_size, size=(B_MODEL, S_MODEL + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    leaves = [t for _, t in L.tree_leaves(params)]
    grads = {}
    for where in ("same", "other"):
        for t in leaves:
            t.grad = None
            t.requires_grad_(True)
        with sharding.set_mesh(host_mesh(1, 4)):
            loss, _ = registry.loss_fn(params, cfg, batch)
        if where == "same":
            loss.backward()
        else:
            errors = []

            def run():
                try:
                    assert sharding.current_mesh() is None
                    assert not L.in_training()
                    loss.backward()
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    errors.append(e)

            th = threading.Thread(target=run)
            th.start()
            th.join()
            if errors:
                raise errors[0]
        grads[where] = [t.grad.clone() for t in leaves]
    for a, b in zip(grads["same"], grads["other"]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# whole models against the JAX loss under a (1, 4) mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["none", "full"])
@pytest.mark.parametrize("name", MODELS)
def test_model_loss_and_gradients_match_jax_on_4_model_ranks(
        jax_ref, name, policy):
    """``registry.loss_fn`` under the port's ``(1, 4)`` mesh against JAX's
    ``value_and_grad`` under its ``(1, 4)`` mesh, from the same bridged
    weights and tokens: the loss and every gradient leaf.  The ring and
    (grok) the MoE block's tensor-parallel schedule are taken, as spies
    show; "full" recomputes each layer (group, for zamba2) in the
    backward."""
    from repro_torch import sharding
    RA = ring_module()
    from repro_torch.models import bridge, registry
    from repro_torch.models import layers as L
    cfg = model_cfg(name).with_overrides(remat_policy=policy)
    pre = f"model/{name}"
    params = bridge.params_from_numpy(unflatten(jax_ref, pre + "/init"),
                                      device="cpu")
    toks = jax_ref[pre + "/tokens"]
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    paths, leaves = zip(*L.tree_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    seen = {"ring": 0, "body": 0, "tp": 0}
    real = (RA._RingAttention.apply, RA._ring_body, L._MoEBlockTP.apply)
    RA._RingAttention.apply = lambda *a: seen.__setitem__(
        "ring", seen["ring"] + 1) or real[0](*a)
    RA._ring_body = lambda *a, **kw: seen.__setitem__(
        "body", seen["body"] + 1) or real[1](*a, **kw)
    L._MoEBlockTP.apply = lambda *a: seen.__setitem__(
        "tp", seen["tp"] + 1) or real[2](*a)
    try:
        with sharding.set_mesh(host_mesh(1, 4)):
            loss, _ = registry.loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        RA._RingAttention.apply, RA._ring_body, L._MoEBlockTP.apply = real
    sites = cfg.num_layers // cfg.shared_attn_every \
        if cfg.shared_attn_every else cfg.num_layers
    again = 2 if policy == "full" else 1
    assert seen == {"ring": 0 if cfg.logit_softcap else sites * again,
                    "body": sites * again if cfg.logit_softcap else 0,
                    "tp": cfg.num_layers * again if cfg.moe else 0}
    np.testing.assert_allclose(float(loss.detach()),
                               float(jax_ref[pre + "/loss"]),
                               rtol=1e-5)
    for path, g in zip(paths, grads):
        want = jax_ref[pre + "/grad/" + "/".join(path)]
        top = float(np.abs(want).max())
        err = float(np.abs(g.numpy() - want).max())
        assert err <= 1e-4 * top, ("/".join(path), err, top)


# ---------------------------------------------------------------------------
# the train launcher on a model axis
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_launcher(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring_launch")
    out = tmp / "ref.npz"
    log = run_with_devices(_JAX_LAUNCHER_CHILD.format(
        root=str(ROOT), argv=ARGV, grok_argv=GROK_ARGV,
        ckpt=str(tmp / "ckpt"), out=str(out)),
        n_devices=4, timeout=600)
    assert "SAVED" in log
    return dict(np.load(out))


def port_launch(tmp_path, ref, extra):
    from repro_torch.launch import train as launch
    from repro_torch.launch.serve import make_config
    from repro_torch.models import bridge
    args = launch.build_parser().parse_args(
        ARGV + ["--device", "cpu", "--ckpt-dir", str(tmp_path)] + extra)
    cfg = make_config(args.arch, args.scale).with_overrides(
        dtype="float32", attention_impl="ring")
    params = bridge.params_from_numpy(unflatten(ref, "init"), device="cpu")
    report = launch.run(args, config=cfg, params=params, log_every=1)
    return [m["loss"] for m in report.log]


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_launcher_model_axis_matches_the_jax_launcher(
        jax_launcher, tmp_path, mesh, monkeypatch):
    """``--mesh 1x4`` and ``--mesh 2x2`` on the native backend, tiny
    smollm-360m with "ring": the ring runs every step (a spy), and the
    per-step losses equal the JAX launcher's ``--devices 4 --mesh 1x4``
    within 1e-5, and the port's own single-rank run (no ring) within
    1e-5."""
    RA = ring_module()
    rings = []
    real = RA._RingAttention.apply
    monkeypatch.setattr(RA._RingAttention, "apply",
                        lambda *a: rings.append(a[0].shape[0]) or real(*a))
    losses = port_launch(tmp_path / "mesh", jax_launcher, ["--mesh", mesh])
    n = int(mesh.split("x")[1])
    assert rings and set(rings) == {n} and len(rings) == 2 * STEPS
    assert jax_launcher["steps"].tolist() == list(range(STEPS))
    np.testing.assert_allclose(losses, jax_launcher["losses"], rtol=1e-5,
                               atol=1e-5)
    rings.clear()
    single = port_launch(tmp_path / "single", jax_launcher, [])
    assert not rings
    np.testing.assert_allclose(losses, single, rtol=1e-5, atol=1e-5)


def test_user_backend_on_a_model_axis_needs_fsdp(tmp_path):
    """The user backend without ``--fsdp`` on a model axis exits with the
    JAX launcher's message."""
    from repro_torch.launch import train as launch
    args = launch.build_parser().parse_args(
        ARGV + ["--device", "cpu", "--ckpt-dir", str(tmp_path), "--mesh",
                "1x4", "--collective-backend", "user"])
    with pytest.raises(SystemExit, match="--collective-backend user on a "
                       "2-D mesh requires --fsdp"):
        launch.run(args)


def port_launch_report(tmp_path, ref, extra, *, grok: bool = False):
    """``port_launch``'s run: (report, losses, checkpoint directory).
    With ``grok``, the JAX child's grok-1 run: its argv, its experts 2048
    wide and its weights."""
    from repro_torch.launch import train as launch
    from repro_torch.launch.serve import make_config
    from repro_torch.models import bridge
    args = launch.build_parser().parse_args(
        (GROK_ARGV if grok else ARGV)
        + ["--device", "cpu", "--ckpt-dir", str(tmp_path)] + extra)
    cfg = make_config(args.arch, args.scale).with_overrides(
        dtype="float32", attention_impl="ring")
    if grok:
        cfg = cfg.with_overrides(d_ff=4096, moe=dataclasses.replace(
            cfg.moe, expert_d_ff=2048))
    params = bridge.params_from_numpy(
        unflatten(ref, "grok_init" if grok else "init"), device="cpu")
    report = launch.run(args, config=cfg, params=params, log_every=1)
    return (report, [m["loss"] for m in report.log],
            tmp_path / args.arch / f"step_{STEPS - 1}")


@pytest.mark.parametrize("mesh", ["1x4", "1x2", "2x2"])
def test_launcher_rank_devices_on_a_model_axis(jax_launcher, tmp_path, mesh,
                                               monkeypatch):
    """``--mesh DxM --rank-devices cpu,...`` (D·M of them, native backend):
    the per-device ring runs on every row's pass and the stacked one
    never (a spy); with one data row the losses and every checkpoint file
    equal the rank-stacked ``--mesh 1xM`` run's bit for bit, at 2x2 they
    hold it within 1e-5 (each row's pass, then the mean over the model
    columns' data ranks); every run holds the JAX launcher's losses
    within 1e-5."""
    D, M = (int(v) for v in mesh.split("x"))
    _, stacked, stacked_dir = port_launch_report(tmp_path / "stacked",
                                                 jax_launcher,
                                                 ["--mesh", mesh])
    spy = RingSpy(monkeypatch)
    report, losses, dev_dir = port_launch_report(
        tmp_path / "devices", jax_launcher,
        ["--mesh", mesh, "--rank-devices", ",".join(["cpu"] * (D * M))])
    assert spy.calls["stacked"] == 0 and spy.calls["devices"] > 0
    assert report.reducer.axis_size == D
    np.testing.assert_allclose(losses, jax_launcher["losses"], rtol=1e-5,
                               atol=1e-5)
    if D > 1:
        np.testing.assert_allclose(losses, stacked, rtol=1e-5, atol=1e-5)
        return
    assert losses == stacked
    names = sorted(f.name for f in stacked_dir.iterdir())
    assert names == sorted(f.name for f in dev_dir.iterdir())
    for f in names:
        assert (stacked_dir / f).read_bytes() == (dev_dir / f).read_bytes(), f


def test_launcher_grok_2x2_matches_the_jax_launcher(jax_launcher, tmp_path,
                                                    monkeypatch):
    """Tiny grok-1 with 2048-wide experts on ``--mesh 2x2`` (F/2 = 1024:
    the MoE block's F-slices engaged; each data row holds one whole group
    of 64 tokens), from the JAX child's weights: the stacked native run,
    whose grad norm adds the F-sliced leaves slice by slice, and
    ``--rank-devices cpu,cpu,cpu,cpu``, whose rows route on their own
    leaders and take the batch's routed shares into their aux losses,
    each hold the JAX launcher's ``--devices 4 --mesh 2x2`` losses within
    1e-5, and each other's within 1e-5."""
    from repro_torch.models import layers as L
    _, stacked, _ = port_launch_report(tmp_path / "stacked", jax_launcher,
                                       ["--mesh", "2x2"], grok=True)
    spy = RingSpy(monkeypatch)
    rows = []
    real = L.moe_rows_aux
    monkeypatch.setattr(L, "moe_rows_aux",
                        lambda *a: rows.append(1) or real(*a))
    report, losses, _ = port_launch_report(
        tmp_path / "devices", jax_launcher,
        ["--mesh", "2x2", "--rank-devices", "cpu,cpu,cpu,cpu"], grok=True)
    assert spy.calls["stacked"] == 0 and spy.calls["devices"] > 0
    assert len(rows) == STEPS and report.reducer.axis_size == 2
    assert len(jax_launcher["grok_losses"]) == STEPS
    for got in (stacked, losses):
        np.testing.assert_allclose(got, jax_launcher["grok_losses"],
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(losses, stacked, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_launcher_rank_devices_microbatches(jax_launcher, tmp_path, mesh,
                                            monkeypatch):
    """``--mesh DxM --microbatches 2 --rank-devices cpu,...`` (native
    backend, "ring"): each row's share of each microbatch runs on its
    leader through the per-device ring, the stacked ring never; with one
    data row the losses and every checkpoint file equal the rank-stacked
    ``--mesh 1xM --microbatches 2`` run's bit for bit, at 2x2 within 1e-5;
    the stacked and per-device runs hold the JAX launcher's ``--devices 4
    --mesh 1x4 --microbatches 2`` losses within 1e-5."""
    D, M = (int(v) for v in mesh.split("x"))
    extra = ["--mesh", mesh, "--microbatches", "2"]
    _, stacked, stacked_dir = port_launch_report(tmp_path / "stacked",
                                                 jax_launcher, extra)
    spy = RingSpy(monkeypatch)
    report, losses, dev_dir = port_launch_report(
        tmp_path / "devices", jax_launcher,
        extra + ["--rank-devices", ",".join(["cpu"] * (D * M))])
    assert spy.calls["stacked"] == 0
    # a forward a layer, 2 layers, 2 microbatches, D rows
    assert spy.calls["devices"] == 2 * 2 * D * STEPS
    assert set(report.log[0]) >= {"nll", "aux", "loss"}
    assert report.log[0]["aux"] == 0
    for got in (stacked, losses):
        np.testing.assert_allclose(got, jax_launcher["mb_losses"],
                                   rtol=1e-5, atol=1e-5)
    if D > 1:
        np.testing.assert_allclose(losses, stacked, rtol=1e-5, atol=1e-5)
        return
    assert losses == stacked
    names = sorted(f.name for f in stacked_dir.iterdir())
    assert names == sorted(f.name for f in dev_dir.iterdir())
    for f in names:
        assert (stacked_dir / f).read_bytes() == (dev_dir / f).read_bytes(), f
