"""The port's dry run (``launch/dryrun.py``, ``analysis/opcount.py``,
``analysis/roofline.py``) and the registry and shape functions it
stands on, on the CPU.

* ``input_specs``, ``param_shapes``, ``param_axes``, ``cache_shapes`` and
  ``cache_axes`` against the JAX package's for every config (and every
  assigned shape): keys, shapes and dtypes exactly;
* ``analytical_bytes`` and ``model_flops`` exactly equal to JAX's floats
  for every config, shape and mesh;
* each kernel's work formula (``*_work``, beside the kernels) against the
  arithmetic ``chip_smoke.py`` used for the kernels' bounds before it
  moved there: equal at every row shape of the kernels JSON;
* the counter on meta tensors against the same counter on real CPU
  tensors (the kernels' plain versions running in their place) for
  reduced cells: equal counts, and useful_ratio <= 1 on one card;
* no meta tensor reaches the kernel library;
* two full-width cells, grok-1 ``train_4k`` and zamba2 ``long_500k``,
  run to a record, and the dry run's command line writes one record per
  cell."""
import json

import jax
import numpy as np
import pytest
import torch

from repro.analysis import roofline as jax_roofline
from repro.configs import get_config as jax_get_config
from repro.configs import list_configs
from repro.configs import shapes as jax_shapes
from repro.models import registry as jax_registry
from repro_torch.analysis import opcount
from repro_torch.analysis import roofline
from repro_torch.configs import get_config
from repro_torch.configs import shapes
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.kernels import _lib
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (H100_SXM, PRODUCTION_MESHES,
                                     make_mesh, make_production_mesh)
from repro_torch.launch.steps import build_cell
from repro_torch.models import registry
from repro_torch.models.layers import tree_leaves

MESH_SHAPES = {name: dict(zip(axes, shape))
               for name, (shape, axes) in PRODUCTION_MESHES.items()}


def _axes_leaf(x):
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def jflat(tree, axes=False) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=_axes_leaf if axes else None)[0]
    return {tuple(str(getattr(k, "key", k)) for k in p): v
            for p, v in leaves}


def same_specs(jtree: dict, ttree: dict, what: str) -> None:
    assert jtree.keys() == ttree.keys(), what
    for k in jtree:
        assert tuple(jtree[k].shape) == tuple(ttree[k].shape), (what, k)
        assert str(jtree[k].dtype) == str(ttree[k].dtype).replace(
            "torch.", ""), (what, k)
        assert ttree[k].device.type == "meta", (what, k)


@pytest.mark.parametrize("arch", list_configs())
def test_shapes_axes_and_input_specs_match_jax(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    same_specs(jflat(jax_registry.param_shapes(jcfg)),
               dict(tree_leaves(registry.param_shapes(cfg))), "params")
    assert jflat(jax_registry.param_axes(jcfg), axes=True) == \
        dict(tree_leaves(registry.param_axes(cfg)))
    same_specs(jflat(jax_registry.cache_shapes(jcfg, 4, 64)),
               dict(tree_leaves(registry.cache_shapes(cfg, 4, 64))), "cache")
    assert jflat(jax_registry.cache_axes(jcfg, 4, 64), axes=True) == \
        dict(tree_leaves(registry.cache_axes(cfg, 4, 64)))
    for name, jshape in jax_shapes.SHAPES.items():
        want = jax_shapes.input_specs(jcfg, jshape)
        got = shapes.input_specs(cfg, shapes.get_shape(name))
        same_specs({(k,): v for k, v in want.items()},
                   {(k,): v for k, v in got.items()}, name)


@pytest.mark.parametrize("arch", list_configs())
def test_analytical_bytes_and_model_flops_equal_jax(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    for name, jshape in jax_shapes.SHAPES.items():
        shape = shapes.get_shape(name)
        tokens = jshape.global_batch * (jshape.seq_len
                                        if jshape.kind != "decode" else 1)
        kw = dict(training=jshape.kind == "train",
                  seq_len=jshape.seq_len if jshape.kind != "decode" else 0,
                  decode_cache_len=jshape.seq_len
                  if jshape.kind == "decode" else 0)
        assert registry.model_flops(cfg, tokens, **kw) == \
            jax_registry.model_flops(jcfg, tokens, **kw), name
        for mesh_name, mesh_shape in MESH_SHAPES.items():
            chips = int(np.prod(list(mesh_shape.values())))
            for wb in (2.0, 1.0):
                assert roofline.analytical_bytes(
                    cfg, shape, chips, mesh_shape, weight_bytes=wb) == \
                    jax_roofline.analytical_bytes(
                        jcfg, jshape, chips, mesh_shape, weight_bytes=wb), \
                    (name, mesh_name, wb)


# ---------------------------------------------------------------------------
# the kernels' work formulas against chip_smoke.py's earlier arithmetic
# ---------------------------------------------------------------------------

def old_rmsnorm_fwd(N, D, es):
    return 4 * N * D, 2 * N * D * es + D * 4


def old_rmsnorm_bwd(N, D, es):
    nb = -(-N // 32)
    return 12 * N * D, 3 * N * D * es + nb * D * 4 + D * 4


def old_flash_decode(B, H, KVH, hd, valid, es):
    return (4 * valid * H * hd,
            2 * B * H * hd * es + 2 * valid * KVH * hd * es + 4 * B)


def old_flash_attention(B, Sq, Sk, H, KVH, hd, causal, es):
    pairs = sum(min(Sk, i + Sk - Sq + 1) for i in range(Sq)) \
        if causal else Sq * Sk
    return 4 * B * H * pairs * hd, (2 * B * Sq * H * hd
                                    + 2 * B * Sk * KVH * hd) * es


def old_ssd_chunk(Bc, Q, nh, hp, ds, es, dt_es):
    pairs = Q * (Q + 1) // 2
    return (2 * Bc * (pairs * ds + pairs * nh * hp + Q * nh * hp * ds),
            (2 * Bc * Q * nh * hp + 2 * Bc * Q * ds) * es + Bc * Q * nh * dt_es
            + 4 * (nh + Bc * nh * hp * ds + Bc * nh))


# every row shape of PERF.md's kernel table (qwen2-0.5b, smollm, mamba2,
# qwen2.5-3b, granite, grok, pixtral, zamba2, whisper), and the new ones
NORM_SHAPES = [(8, 896), (8192, 960), (8, 2048), (8192, 2048), (8, 1536),
               (8192, 1536), (8, 6144), (4096, 5120), (128, 896),
               (32768, 896), (65536, 960)]
DECODE_SHAPES = [(8, 14, 2, 64, 1024), (8, 16, 2, 128, 1024),
                 (8, 24, 8, 64, 1024), (8, 48, 8, 128, 1024),
                 (8, 32, 32, 64, 1024), (8, 6, 6, 64, 448),
                 (8, 6, 6, 64, 1500), (128, 14, 2, 64, 32768),
                 (1, 32, 32, 64, 524288)]
ATTN_SHAPES = [(8, 1024, 1024, 15, 5, 64), (2, 1000, 1000, 6, 3, 64),
               (8, 1024, 1024, 16, 2, 128), (8, 1024, 1024, 24, 8, 64),
               (2, 1024, 1024, 48, 8, 128), (8, 1024, 1024, 32, 32, 64),
               (8, 1500, 1500, 6, 6, 64), (8, 1024, 1500, 6, 6, 64),
               (2, 2048, 2048, 32, 8, 128), (1, 32768, 32768, 14, 2, 64),
               (1, 1024, 32768, 14, 2, 64)]
SSD_SHAPES = [(32, 256, 64, 64, 128), (1, 64, 8, 32, 32),
              (2, 128, 16, 64, 64), (1, 256, 8, 64, 128),
              (2, 1000, 8, 64, 128), (32, 256, 64, 64, 64)]


def test_kernel_work_formulas_equal_the_old_bound_arithmetic():
    from repro_torch.kernels.decode_attention import flash_decode_work
    from repro_torch.kernels.flash_attention import flash_attention_work
    from repro_torch.kernels.rmsnorm import (rmsnorm_bwd_work,
                                             rmsnorm_fwd_work)
    from repro_torch.kernels.ssd_scan import ssd_chunk_work
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        es = dtype.itemsize
        for N, D in NORM_SHAPES:
            rows.append((f"rmsnorm_fwd {N}x{D}", old_rmsnorm_fwd(N, D, es),
                         rmsnorm_fwd_work(N, D, dtype)))
            rows.append((f"rmsnorm_bwd {N}x{D}", old_rmsnorm_bwd(N, D, es),
                         rmsnorm_bwd_work(N, D, dtype)))
        for B, H, KVH, hd, S in DECODE_SHAPES:
            rows.append((f"flash_decode {B},{H},{KVH},{hd},{S}",
                         old_flash_decode(B, H, KVH, hd, B * S, es),
                         flash_decode_work(B, H, KVH, hd, B * S, dtype)))
        for B, Sq, Sk, H, KVH, hd in ATTN_SHAPES:
            for causal in (True, False):
                if Sq > 4096 and causal:
                    continue     # the old per-row sum is the slow part
                rows.append((f"flash_attention {B},{Sq},{Sk},{H},{KVH},{hd} "
                             f"causal={causal}",
                             old_flash_attention(B, Sq, Sk, H, KVH, hd,
                                                 causal, es),
                             flash_attention_work(B, Sq, Sk, H, KVH, hd,
                                                  causal, dtype)))
        for shape in SSD_SHAPES:
            for dt_dtype in (torch.float32, dtype):
                rows.append((f"ssd_chunk {shape} dt {dt_dtype}",
                             old_ssd_chunk(*shape, es, dt_dtype.itemsize),
                             ssd_chunk_work(*shape, dtype, dt_dtype)))
    for name, old, new in rows:
        print(f"{name}: old (flops, bytes) {old}, new {new}")
        assert tuple(old) == tuple(new), name


def test_causal_pairs_at_32768_queries_in_closed_form():
    from repro_torch.kernels.flash_attention import attention_pairs
    assert attention_pairs(32768, 32768, True) == 32768 * 32769 // 2
    assert attention_pairs(1024, 32768, True) == sum(
        i + 32768 - 1024 + 1 for i in range(1024))


# ---------------------------------------------------------------------------
# the counter: meta against the CPU, and the library never reached
# ---------------------------------------------------------------------------

def reduced_cell(arch, kind, device_mesh="meta", **over):
    cfg = get_config(arch)
    kw = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=256,
              remat_policy="full", dtype="float32")
    if cfg.num_heads:
        kw.update(num_heads=4, num_kv_heads=2, head_dim=16)
    if cfg.ssm:
        kw["ssm"] = cfg.ssm.__class__(d_state=16, expand=2, head_dim=16,
                                      chunk_size=16)
    if cfg.shared_attn_every:
        kw.update(num_layers=4, shared_attn_every=2, shared_attn_lora_rank=4)
    if cfg.is_encoder_decoder:
        kw.update(num_encoder_layers=2, encoder_frames=16,
                  max_position_embeddings=256)
    kw.update(over)
    mesh = make_mesh((1, 1), ("data", "model"), device_mesh)
    return build_cell(cfg.with_overrides(**kw), ShapeSpec("t", 64, 4, kind),
                      mesh)


KEYS = ("flops", "flops_by_dtype", "bytes", "ops", "kernels",
        "argument_bytes", "output_bytes", "saved_bytes_peak")


@pytest.mark.parametrize("arch,kind", [
    ("smollm-360m", "train"), ("qwen2-0.5b", "prefill"),
    ("zamba2-1.2b", "decode"), ("whisper-tiny", "decode")])
def test_meta_counts_equal_the_cpu_run(arch, kind):
    """The same step on meta and on real CPU tensors gives the same counts
    (on the CPU each kernel's plain version runs uncounted in its place,
    and every decode lane sits at the cache's last position, so the
    kernels' work is the same).  Cells whose ops decompose differently
    on the two devices (``F.one_hot``'s range check, a reshape that must
    copy a CPU tensor's layout) are left out."""
    cell = reduced_cell(arch, kind)
    meta = opcount.count(cell.step_fn, cell.abstract_args)
    cpu = opcount.count(cell.step_fn, cell.materialize(
        "cpu", torch.Generator().manual_seed(0)))
    for k in KEYS:
        assert meta[k] == cpu[k], (k, meta[k], cpu[k])
    assert meta["kernels"], "the step ran no kernel"


def test_train_launch_counts_match_the_derived_counts():
    from repro_torch.launch.train import kernel_launches_per_step
    for arch in ("smollm-360m", "mamba2-1.3b", "zamba2-1.2b"):
        cell = reduced_cell(arch, "train")
        got = opcount.count(cell.step_fn, cell.abstract_args)["kernels"]
        want = kernel_launches_per_step(cell.cfg)
        assert {k: v["launches"] for k, v in got.items()} == \
            {k: v for k, v in want.items() if v}, arch


def test_no_meta_tensor_reaches_the_kernel_library(monkeypatch):
    def refuse():
        raise AssertionError("the kernel library was loaded")
    monkeypatch.setattr(_lib, "lib", refuse)
    monkeypatch.setattr(_lib, "build", refuse)
    for arch, kind in (("smollm-360m", "train"), ("mamba2-1.3b", "train"),
                       ("zamba2-1.2b", "decode")):
        cell = reduced_cell(arch, kind)
        opcount.count(cell.step_fn, cell.abstract_args)
    # the kernels' own wrappers refuse a meta tensor before any launch
    from repro_torch.kernels.decode_attention import flash_decode
    from repro_torch.kernels.rmsnorm import rmsnorm_fwd
    with pytest.raises(ValueError, match="CUDA device"):
        rmsnorm_fwd(torch.empty(4, 8, device="meta"),
                    torch.empty(8, device="meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        flash_decode(torch.empty(1, 2, 8, device="meta"),
                     torch.empty(1, 4, 2, 8, device="meta"),
                     torch.empty(1, 4, 2, 8, device="meta"),
                     torch.empty(1, dtype=torch.int32, device="meta"))


def test_reduced_record_on_one_card_is_consistent():
    cell = reduced_cell("smollm-360m", "train")
    counts = opcount.count(cell.step_fn, cell.abstract_args)
    mf = registry.model_flops(cell.cfg, 4 * 64, training=True, seq_len=64)
    rl = roofline.from_counts(counts, arch="x", shape="t", mesh_name="1x1",
                              chips=1, model_flops=mf, cfg=cell.cfg,
                              shape_spec=cell.shape,
                              mesh_shape={"data": 1, "model": 1})
    assert 0 < rl.useful_ratio <= 1
    assert rl.collective_s == 0 and not rl.lengths_assumed_full
    assert rl.memory_s_counted_upper > 0 and rl.dominant in (
        "compute", "memory")
    bf = counts["flops_by_dtype"]
    assert rl.compute_s == pytest.approx(
        sum(bf.values()) / H100_SXM["peak_flops_f32"])


def test_collective_bytes_of_a_train_and_a_decode_cell():
    cfg = get_config("qwen2-0.5b")
    mesh = make_production_mesh(name="16x16")
    cell = build_cell(cfg, ShapeSpec("t", 4096, 16, "train"), mesh)
    coll = opcount.collective_bytes(cell)
    from repro_torch.collectives.overlap import FsdpLayout
    layout = FsdpLayout(cell.abstract_args[0], 16, 1 << 22)
    total = sum(w * 4 for w in layout.widths)      # f32 master buckets
    assert coll == {"all-gather": total / 16, "reduce-scatter": total}
    dcell = build_cell(cfg, ShapeSpec("t", 32768, 8, "decode"), mesh)
    # each model rank's operand: its [B, V/16] f32 slice of the logits
    assert opcount.collective_bytes(dcell) == {
        "all-gather": 8 * cfg.vocab_size // 16 * 4}
    one = build_cell(cfg, ShapeSpec("t", 4096, 16, "train"),
                     make_production_mesh(name="1x1"))
    assert opcount.collective_bytes(one) == {}


def test_production_meshes():
    for name, chips in (("1x1", 1), ("16x16", 256), ("2x16x16", 512)):
        mesh = make_production_mesh(name=name)
        assert mesh.size == chips and mesh.device.type == "meta"
        assert "x".join(map(str, mesh.sizes)) == name
    assert make_production_mesh("2x16x16").axis_names == (
        "pod", "data", "model")


# ---------------------------------------------------------------------------
# full-width cells and the command line
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", [("grok-1-314b", "train_4k"),
                                        ("zamba2-1.2b", "long_500k")])
def test_full_width_meta_cell_runs_to_a_record(arch, shape):
    rec = dryrun.run_cell(arch, shape, "1x1")
    assert rec["status"] == "ok", rec
    rl = rec["roofline"]
    assert rl["flops_per_device"] > 0 and rl["bytes_per_device"] > 0
    assert rl["bound_s"] == max(rl["compute_s"], rl["memory_s"],
                                rl["collective_s"])
    assert 0 < rl["useful_ratio"] <= 1
    assert rec["memory"]["bytes_in_use_per_device"] > 0
    if shape == "long_500k":
        # 6 shared-attention sites, one flash_decode each, over 524288 keys
        assert rec["kernels"]["flash_decode"]["launches"] == 6
        assert rl["lengths_assumed_full"]
    else:
        assert rec["kernels"]["flash_attention"]["launches"] > 0
    json.dumps(rec)


def test_command_line_writes_a_record_per_cell(tmp_path):
    out = tmp_path / "dry.jsonl"
    argv = ["--arch", "qwen2-0.5b,mamba2-1.3b", "--shape",
            "decode_32k,long_500k", "--mesh", "all", "--out", str(out)]
    assert dryrun.main(argv) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(recs) == 2 * 2 * 3
    assert {r["status"] for r in recs} == {"ok", "skipped"}
    skipped = [r for r in recs if r["status"] == "skipped"]
    assert {(r["arch"], r["shape"]) for r in skipped} == {
        ("qwen2-0.5b", "long_500k")}
    assert dryrun.main(argv + ["--skip-done"]) == 0
    assert len(out.read_text().splitlines()) == 12
