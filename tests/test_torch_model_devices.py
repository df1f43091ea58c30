"""The model axis with a device per rank, against its rank-stacked form
on the CPU (each rank's "device" is ``cpu``, listed once a rank): the MoE
block's tensor-parallel schedule over F-slices on the ranks' devices
(``layers._MoEBlockPerDevice``) against ``_MoEBlockTP``, the F-slices'
layout (``RankShards.dim``) and checkpoint, the optimizer over placed
leaves, the data rows' aux losses from the batch's routed shares, and
the train launcher's ``--mesh DxM --rank-devices`` with tiny grok-1 whose
experts are 2048 wide, so that the MoE block splits them into F-slices.
Everything is held bit for bit, but the rows' aux losses (within 1e-6 of
the batch's) and the 2x2 run (within 1e-5 of the stacked run: its rows'
gradients meet in a mean).  The ring and the JAX comparisons are in
``test_torch_ring.py``."""
import dataclasses

import numpy as np
import pytest
import torch

GROK_ARGV = ["--arch", "grok-1-314b", "--scale", "tiny", "--steps", "3",
             "--global-batch", "8", "--seq", "16"]


def host_mesh(data, model):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((data, model), ("data", "model"), "cpu")


def device_mesh(data, model):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((data, model), ("data", "model"),
                     devices=["cpu"] * (data * model))


def moe_inputs(F_, E=4, d=64, g=2, t=64, C=48, seed=3):
    """Tokens, a top-2 capacity dispatch, its combine weights and the
    three expert weights, from numpy."""
    rs = np.random.RandomState(seed)
    xg = rs.randn(g, t, d).astype(np.float32)
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
    return [torch.from_numpy(a) for a in [xg, disp, comb] + ws]


@pytest.mark.parametrize("n", [2, 4])
def test_moe_block_per_device_equals_the_tp_block(n, monkeypatch):
    """n model ranks over F = 512·n: rank r's ``wi_gate``/``wi_up`` ``[E,
    d, F/n]`` and ``wo`` ``[E, F/n, d]`` as ``RankShards`` on its device;
    ``y`` and the gradients of the tokens, the combine weights and every
    F-slice (glued along F) equal the stacked tensor-parallel block's bit
    for bit, each slice's gradient on its rank's device, and the stacked
    block never runs on the per-device mesh."""
    from repro_torch import sharding
    from repro_torch.collectives.rank_shards import RankShards
    from repro_torch.models import layers as L
    xs = moe_inputs(512 * n)
    dy = torch.from_numpy(np.random.RandomState(4).randn(
        *xs[0].shape).astype(np.float32))
    got = {}
    for form in ("stacked", "devices"):
        leaves = [t.clone().requires_grad_(i != 1) for i, t in enumerate(xs)]
        if form == "stacked":
            mesh, ws = host_mesh(1, n), leaves[3:]
            wrt = ws
        else:
            mesh = device_mesh(1, n)
            ws = [RankShards.from_stacked(t, mesh, dim=dim)
                  for t, dim in zip(xs[3:], (2, 2, 1))]
            wrt = [s.requires_grad_(True) for w in ws for s in w.shards]
            monkeypatch.setattr(L._MoEBlockTP, "apply", None)
        with sharding.set_mesh(mesh), L.training_mode():
            y = L._moe_expert_block(leaves[0], leaves[1], leaves[2], *ws)
        grads = list(torch.autograd.grad(y, [leaves[0], leaves[2], *wrt],
                                         dy))
        if form == "devices":
            for r, g in enumerate(grads[2:]):
                assert g.device == ws[0].shards[r % n].device
            grads = grads[:2] + [torch.cat(grads[2 + k * n:2 + (k + 1) * n],
                                           dim=(2, 2, 1)[k])
                                 for k in range(3)]
        got[form] = [y.detach()] + grads
    for name, a, b in zip(("y", "xg", "comb", "wi_gate", "wi_up", "wo"),
                          got["stacked"], got["devices"]):
        assert torch.equal(a, b), name


def test_moe_block_per_device_refuses_what_it_cannot_place():
    """No fallback onto one device: whole expert weights on a per-device
    mesh whose model axis splits F raise, and so do F-slices outside
    training or on a mesh whose model axis is not theirs."""
    from repro_torch import sharding
    from repro_torch.collectives.rank_shards import RankShards
    from repro_torch.models import layers as L
    xs = moe_inputs(1024)
    mesh = device_mesh(1, 2)
    slices = [RankShards.from_stacked(t, mesh, dim=dim)
              for t, dim in zip(xs[3:], (2, 2, 1))]
    with sharding.set_mesh(mesh), L.training_mode(), \
            pytest.raises(ValueError, match="F-slices on the model ranks"):
        L._moe_expert_block(*xs)
    with sharding.set_mesh(mesh), pytest.raises(ValueError,
                                                match="only in training"):
        L._moe_expert_block(*xs[:3], *slices)
    with sharding.set_mesh(device_mesh(1, 4)), L.training_mode(), \
            pytest.raises(ValueError, match="only in training"):
        L._moe_expert_block(*xs[:3], *slices)


def test_blocks_split_on_a_later_dim_round_trip_and_checkpoint(tmp_path):
    """``RankShards`` blocks split on dim 1, two copies of two blocks:
    ``to_stacked``, ``shape`` and ``map`` keep the split; the checkpoint
    writes the unsplit tensor's file byte for byte and restores each
    rank's slice on its device."""
    from repro_torch.collectives.rank_shards import RankShards
    from repro_torch.core import ProgressEngine
    from repro_torch.train.checkpoint import AsyncCheckpointer
    x = torch.arange(2 * 6 * 3, dtype=torch.float32).reshape(2, 6, 3)
    rs = RankShards.from_stacked(x, devices=["cpu"] * 4, copies=2, dim=1)
    assert [tuple(s.shape) for s in rs.shards] == [(2, 3, 3)] * 4
    assert all(s.is_contiguous() for s in rs.shards)
    assert rs.shape == x.shape and rs.dim == 1 and rs.copies == 2
    assert torch.equal(rs.to_stacked("cpu"), x)
    assert torch.equal(rs.shards[2], x[:, :3]) and \
        torch.equal(rs.shards[3], x[:, 3:])
    doubled = rs.map(lambda t: t * 2)
    assert (doubled.dim, doubled.copies) == (1, 2)
    assert torch.equal(doubled.to_stacked("cpu"), 2 * x)
    ck = AsyncCheckpointer(str(tmp_path / "dev"), ProgressEngine())
    ck.save_blocking(0, {"w": rs})
    ref = AsyncCheckpointer(str(tmp_path / "ref"), ProgressEngine())
    ref.save_blocking(0, {"w": x})
    assert (tmp_path / "dev" / "step_0" / "w.npy").read_bytes() == \
        (tmp_path / "ref" / "step_0" / "w.npy").read_bytes()
    back = ck.restore(0, {"w": rs})["w"]
    assert (back.dim, back.copies, len(back)) == (1, 2, 4)
    for a, b in zip(back.shards, rs.shards):
        assert torch.equal(a, b)


def test_adamw_over_placed_leaves_equals_the_stacked_step():
    """AdamW over a tree placed on a 2x2 mesh (a replica on each row's
    leader, the F-sliced leaves as blocks on every rank) against the
    stacked ``apply`` with those leaves' norms taken slice by slice
    (``splits``): the parameters, the moments, the grad norm and the lr
    bit for bit after two steps, each slice stepped with its rank's
    counter."""
    from repro_torch.collectives.rank_shards import RankShards, replicate
    from repro_torch.models.layers import tree_leaves
    from repro_torch.train import optimizer as opt
    mesh = device_mesh(2, 2)
    gen = torch.Generator().manual_seed(5)
    params = {"a": torch.randn(6, 4, generator=gen),
              "w": torch.randn(3, 8, generator=gen) * 5}
    grads = [{"a": torch.randn(6, 4, generator=gen) * 3,
              "w": torch.randn(3, 8, generator=gen) * 3} for _ in range(2)]
    cfg = opt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)

    def placed(tree):
        return {"a": replicate(tree["a"], mesh.devices[::2]),
                "w": RankShards.from_stacked(tree["w"], mesh, copies=2,
                                             dim=1)}

    sp = {k: v.clone() for k, v in params.items()}
    s_state = opt.init(sp)
    dp = placed(params)
    d_state = opt.init(dp)
    assert len(d_state.step) == 4 and len(d_state.mu["a"]) == 2
    for g in grads:
        sp, s_state, s_met = opt.apply(cfg, s_state, sp, g,
                                       splits={("w",): (1, 2)})
        dp, d_state, d_met = opt.apply(cfg, d_state, dp, placed(g))
        assert torch.equal(s_met["grad_norm"], d_met["grad_norm"])
        assert torch.equal(s_met["lr"], d_met["lr"])
    for tree_s, tree_d in ((sp, dp), (s_state.mu, d_state.mu),
                           (s_state.nu, d_state.nu)):
        for (path, s), (_, d) in zip(tree_leaves(tree_s),
                                     tree_leaves(tree_d)):
            if d.replica:
                assert all(torch.equal(s, x) for x in d.shards), path
                continue
            k = len(d.blocks)
            for c in range(d.copies):
                got = RankShards(d.shards[c * k:(c + 1) * k], dim=d.dim)
                assert torch.equal(s, got.to_stacked("cpu")), path


def grok_run(tmp_path, extra, **moe):
    from repro_torch.launch import train as launch
    from repro_torch.launch.serve import make_config
    args = launch.build_parser().parse_args(
        GROK_ARGV + ["--device", "cpu", "--ckpt-dir", str(tmp_path)] + extra)
    cfg = make_config(args.arch, args.scale)
    cfg = cfg.with_overrides(dtype="float32", attention_impl="ring",
                             vocab_size=1024, moe=dataclasses.replace(
                                 cfg.moe, **{"expert_d_ff": 2048, **moe}))
    report = launch.run(args, config=cfg, log_every=1)
    return report, [m["loss"] for m in report.log]


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_launcher_grok_f_slices_on_the_ranks(tmp_path, mesh, monkeypatch):
    """Tiny grok-1 (its vocabulary cut to 1024) with 2048-wide experts
    (F/2 = 1024: the MoE block's F-slices engaged) through ``--mesh DxM
    --rank-devices``: the per-device block runs and the stacked one
    never; rank (d, m) holds slice m of every expert weight and its
    moments, the leaders the replicas, every rank a step counter; with one
    row the losses and every checkpoint file equal the stacked ``--mesh
    1x2`` run's bit for bit; the checkpoint restores into the slices
    equal.  At 2x2 each row routes its 64 tokens, one whole group of the
    batch's routing, and takes the batch's routed shares into its aux
    loss, so the losses hold the stacked ``--mesh 2x2`` run's, which
    routes the whole batch, within 1e-5."""
    from repro_torch.models import layers as L
    from repro_torch.models.layers import tree_leaves
    D, M = (int(v) for v in mesh.split("x"))
    _, stacked = grok_run(tmp_path / "stacked", ["--mesh", mesh])
    calls = {"devices": 0}
    real = L._MoEBlockPerDevice.apply
    monkeypatch.setattr(L._MoEBlockTP, "apply", None)
    monkeypatch.setattr(L._MoEBlockPerDevice, "apply", lambda *a: calls.
                        __setitem__("devices", calls["devices"] + 1)
                        or real(*a))
    report, losses = grok_run(tmp_path / "devices", [
        "--mesh", mesh, "--rank-devices", ",".join(["cpu"] * (D * M))])
    assert calls["devices"] > 0
    tr = report.trainer
    sliced = {("layers", "moe", k): dim
              for k, dim in (("wi_gate", 3), ("wi_up", 3), ("wo", 2))}
    for tree in (tr.params, tr.opt_state.mu, tr.opt_state.nu):
        for path, leaf in tree_leaves(tree):
            if path in sliced:
                assert (len(leaf), leaf.copies, leaf.dim) == (
                    D * M, D, sliced[path]), path
            else:
                assert leaf.replica and len(leaf) == D, path
    assert len(tr.opt_state.step) == D * M
    if D > 1:
        np.testing.assert_allclose(losses, stacked, rtol=1e-5, atol=1e-5)
    else:
        assert losses == stacked
        step = tmp_path / "stacked" / "grok-1-314b" / "step_2"
        dev = tmp_path / "devices" / "grok-1-314b" / "step_2"
        names = sorted(f.name for f in step.iterdir())
        assert names == sorted(f.name for f in dev.iterdir())
        for f in names:
            assert (step / f).read_bytes() == (dev / f).read_bytes(), f
    like = {"params": tr.params, "opt_state": tr.opt_state}
    back = tr.ckpt.restore(2, like)
    for (path, a), (_, b) in zip(tree_leaves(back["params"]),
                                 tree_leaves(tr.params)):
        assert (a.replica, a.copies, a.dim) == (b.replica, b.copies, b.dim)
        for x, y in zip(a.shards, b.shards):
            assert torch.equal(x, y), path


def test_rows_aux_is_the_batch_aux():
    """Two rows of one batch, each a whole group of the batch's routing
    (``moe_rows_route_alike``), routed apart under ``moe_route_stats``:
    their dispatch and combine equal the batch's group by group, the mean
    of ``moe_rows_aux`` holds the batch's aux loss within 1e-6, and the
    router's gradient of the rows' aux losses over 2 holds the batch's
    within 1e-6."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.launch.serve import make_config
    from repro_torch.models import layers as L
    cfg = make_config("grok-1-314b", "tiny").with_overrides(
        dtype="float32", moe=MoEConfig(num_experts=4, top_k=2,
                                       expert_d_ff=64, group_size=32))
    assert L.moe_rows_route_alike(cfg, 4 * 16, 2)
    assert not L.moe_rows_route_alike(cfg, 2 * 16, 2)
    rs = np.random.RandomState(6)
    x = torch.from_numpy(rs.randn(4, 16, cfg.d_model).astype(np.float32))
    router = torch.from_numpy(rs.randn(cfg.d_model, 4).astype(np.float32))
    router.requires_grad_(True)
    _, disp, comb, aux = L._moe_route({"router": router}, x, cfg)
    (want,) = torch.autograd.grad(aux, router)
    stats, parts = [], []
    for half in (x[:2], x[2:]):
        with L.moe_route_stats() as st:
            parts.append(L._moe_route({"router": router}, half, cfg))
        stats.append(st)
    assert all(len(st) == 1 for st in stats)
    assert torch.equal(torch.cat([p[1] for p in parts]), disp)
    assert torch.equal(torch.cat([p[2] for p in parts]), comb)
    rows = L.moe_rows_aux(cfg, stats, ["cpu", "cpu"])
    mean = (rows[0] + rows[1]) / 2
    np.testing.assert_allclose(float(mean.detach()), float(aux.detach()),
                               rtol=1e-6)
    (got,) = torch.autograd.grad(mean, router)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))
    # the rows' own aux losses are another function of the router
    own = (parts[0][3] + parts[1][3]) / 2
    assert abs(float((own - aux).detach())) > 1e-6 * abs(float(aux.detach()))


def test_launcher_refuses_rows_that_split_a_moe_group(tmp_path):
    """``--mesh 2x2 --rank-devices`` with tiny grok-1 on 4 x 16 tokens:
    each row's 32 tokens are half of the batch's one group of 64, which
    the rows cannot route apart as the batch does, so the launcher exits
    naming ROADMAP item 12c before it trains."""
    with pytest.raises(SystemExit, match="item 12c"):
        grok_run(tmp_path, ["--global-batch", "4", "--mesh", "2x2",
                            "--rank-devices", "cpu,cpu,cpu,cpu"])


def test_launcher_grok_2x2_microbatches(tmp_path, monkeypatch):
    """Tiny grok-1 with 1024-wide experts (F-slices of 512 on 2 model
    ranks) in MoE groups of 16 on ``--mesh 2x2 --microbatches 2
    --rank-devices cpu,cpu,cpu,cpu`` over 4 x 16 tokens, 2 steps: each
    row's share of each microbatch is one whole group, the rows take each
    microbatch's routed shares into their aux losses (``moe_rows_aux``
    once a microbatch), and the losses hold the stacked ``--mesh 2x2
    --microbatches 2`` run's within 1e-5."""
    from repro_torch.models import layers as L
    from repro_torch.models.layers import tree_leaves
    extra = ["--steps", "2", "--global-batch", "4", "--mesh", "2x2",
             "--microbatches", "2"]
    moe = dict(group_size=16, expert_d_ff=1024)
    _, stacked = grok_run(tmp_path / "stacked", extra, **moe)
    rows = []
    real = L.moe_rows_aux
    monkeypatch.setattr(L, "moe_rows_aux",
                        lambda *a: rows.append(1) or real(*a))
    report, losses = grok_run(tmp_path / "devices", extra + [
        "--rank-devices", "cpu,cpu,cpu,cpu"], **moe)
    sliced = [path for path, t in tree_leaves(report.trainer.params)
              if not t.replica]
    assert len(sliced) == 3             # wi_gate, wi_up, wo: F-slices
    assert len(rows) == 2 * 2 and len(losses) == 2
    assert report.reducer.axis_size == 2
    np.testing.assert_allclose(losses, stacked, rtol=1e-5, atol=1e-5)


def test_launcher_refuses_rows_that_split_a_microbatch_group(tmp_path):
    """``--mesh 2x2 --microbatches 2 --rank-devices`` with tiny grok-1 on
    8 x 16 tokens: the batch's 128 tokens are two groups, but each
    microbatch's 64 are one, which its two rows would split; the launcher
    exits naming ROADMAP item 12c before it trains."""
    with pytest.raises(SystemExit, match="microbatch's 64 tokens.*item 12c"):
        grok_run(tmp_path, ["--mesh", "2x2", "--microbatches", "2",
                            "--rank-devices", "cpu,cpu,cpu,cpu"])
