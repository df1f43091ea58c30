"""Dry run of every (arch × shape × mesh) cell on ``meta`` tensors: the
port's counterpart of the JAX package's ``launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh 1x1 \
        --out results/dryrun_torch.jsonl
    PYTHONPATH=src python -m repro_torch.analysis.report \
        results/dryrun_torch.jsonl

The JAX dry run lowers and compiles each cell for 512 placeholder
devices and reads the compiled HLO.  Here nothing is compiled and no
device is needed: ``build_cell`` gives the step and its ``meta``
arguments, and ``analysis.opcount.count`` runs one data rank's step on
them (the global batch over the ``pod`` × ``data`` ranks; the model axis
replicates in the port) and counts its operations, bytes, kernels and
saved activations; ``analysis.roofline.from_counts`` turns that into
the H100 roofline.  One JSONL record per cell, with the keys
``analysis/report.py`` reads; where a JAX column has no counterpart the
record says what it holds instead:

* ``lower_s``   — ``build_cell``'s seconds (no lowering);
* ``compile_s`` — the meta step's seconds on the host (no compile);
* ``memory``    — per device: ``argument_bytes`` by the cell's
  placements (a leaf's bytes over the ranks its spec splits it across),
  ``saved_bytes`` (the most autograd holds saved at once; JAX's
  ``temp_bytes``), ``output_bytes`` (the outputs that are not updated
  arguments; JAX's output less its aliases), and their sum
  ``bytes_in_use_per_device``;
* ``kernels``   — each hand-written kernel's launches, flops and bytes
  in the step (JAX's ``xla_cost_analysis_flops_while_once`` has no
  counterpart).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback


def _parse_value(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v in ("true", "True"):
        return True
    if v in ("false", "False"):
        return False
    return v


def local_batch(global_batch: int, data_ranks: int) -> int:
    """One data rank's batch: the global batch split over the data ranks,
    or whole where they do not divide it (a batch of 1 replicates)."""
    return global_batch // data_ranks if global_batch % data_ranks == 0 \
        else global_batch


def sharded_bytes(tree, specs, mesh) -> float:
    """Bytes a device holds of a tree of ``meta`` tensors placed by a
    matching tree of spec tuples: each leaf over the ranks of the mesh
    axes its spec names."""
    from repro_torch.models.layers import tree_leaves
    sizes = dict(mesh.shape)
    total = 0.0
    for (path, t), (_, spec) in zip(tree_leaves(_leaves(tree)),
                                    tree_leaves(_leaves(specs))):
        ranks = 1
        for entry in spec or ():
            for axis in (entry if isinstance(entry, tuple)
                         else (entry,) if entry else ()):
                ranks *= sizes[axis]
        total += t.numel() * t.element_size() / ranks
    return total


def _leaves(tree):
    """A tree with NamedTuple nodes (the AdamW state, int8 weights) as dicts,
    so ``tree_leaves`` walks its tensors and their specs alike."""
    if hasattr(tree, "_fields"):
        return {f: _leaves(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, dict):
        return {k: _leaves(v) for k, v in tree.items()}
    return tree


def run_cell(arch: str, shape_name: str, mesh_name: str,
             cfg_overrides: dict | None = None,
             cell_kwargs: dict | None = None,
             batch: int | None = None) -> dict:
    """One cell's record.  ``batch`` replaces the shape's global batch (a
    cell cut to fit one card: its counts and bound are then the cut
    cell's, for a measurement of the same cell to meet)."""
    from repro_torch.analysis import opcount
    from repro_torch.analysis import roofline as roofline_mod
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import (ShapeSpec, get_shape,
                                            shape_applicable)
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import registry

    cfg = get_config(arch, **(cfg_overrides or {}))
    shape = get_shape(shape_name)
    if batch is not None:
        shape = ShapeSpec(shape.name, shape.seq_len, batch, shape.kind)
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": why}
    cell_kwargs = cell_kwargs or {}
    mesh = make_production_mesh(name=mesh_name)
    mesh_shape = dict(mesh.shape)
    chips = mesh.size
    t0 = time.perf_counter()
    cell = build_cell(cfg, shape, mesh, **cell_kwargs)
    dp = opcount.data_ranks(mesh_shape)
    local = ShapeSpec(shape.name, shape.seq_len,
                      local_batch(shape.global_batch, dp), shape.kind)
    local_cell = build_cell(cfg, local, mesh, **cell_kwargs)
    t_build = time.perf_counter() - t0
    counts = opcount.count(local_cell.step_fn, local_cell.abstract_args,
                           mesh=mesh)
    coll = opcount.collective_bytes(local_cell)

    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mf = registry.model_flops(
        cfg, tokens, training=(shape.kind == "train"),
        seq_len=shape.seq_len if shape.kind != "decode" else 0,
        decode_cache_len=shape.seq_len if shape.kind == "decode" else 0)
    arg_bytes = sum(sharded_bytes(a, s, mesh) for a, s in
                    zip(cell.abstract_args, cell.in_shardings))
    in_use = arg_bytes + counts["saved_bytes_peak"] + counts["output_bytes"]
    wb = 1.0 if cell_kwargs.get("int8_weights") else 2.0
    rl = roofline_mod.from_counts(
        counts, arch=arch, shape=shape_name, mesh_name=mesh_name,
        chips=chips, model_flops=mf, bytes_in_use=in_use, cfg=cfg,
        shape_spec=shape, mesh_shape=mesh_shape, weight_bytes=wb,
        coll_by_type=coll)
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "ok",
        "global_batch": shape.global_batch, "local_batch": local.global_batch,
        "lower_s": round(t_build, 2), "compile_s": round(counts["seconds"], 2),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": counts["output_bytes"],
            "saved_bytes": counts["saved_bytes_peak"],
            "bytes_in_use_per_device": in_use,
        },
        "ops": counts["ops"],
        "kernels": counts["kernels"],
        "roofline": rl.to_dict(),
    }


def main(argv=None) -> int:
    from repro_torch.configs import list_configs
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch.mesh import PRODUCTION_MESHES

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both", "1x1", "all"],
                    help="single: 16x16; multi: 2x16x16; both: those two "
                         "(as the JAX dry run); 1x1: one card; all: the "
                         "three")
    ap.add_argument("--out", default="results/dryrun_torch.jsonl")
    ap.add_argument("--skip-done", action="store_true",
                    help="skip cells already recorded in --out")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="ModelConfig override, e.g. remat_policy=dots")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--cast-bf16", action="store_true",
                    help="cast params to bf16 before use")
    ap.add_argument("--decode-ws", action="store_true",
                    help="weight-stationary decode placement rules")
    ap.add_argument("--int8-weights", action="store_true",
                    help="serve with per-channel int8 weights")
    ap.add_argument("--tag", default="", help="annotation stored in records")
    ap.add_argument("--rules", default="",
                    help="rule overrides 'act_seq=model;mlp=;heads=' "
                         "(axes +-separated, empty = replicate)")
    args = ap.parse_args(argv)

    cfg_overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        cfg_overrides[k] = _parse_value(v)
    rules_overrides = {}
    for item in filter(None, args.rules.split(";")):
        k, v = item.split("=", 1)
        if v:
            rules_overrides[k] = (tuple(v.split("+")), ())
        else:
            rules_overrides[k] = ((),)
    cell_kwargs = dict(microbatches=args.microbatches,
                       cast_params_bf16=args.cast_bf16,
                       decode_weight_stationary=args.decode_ws,
                       int8_weights=args.int8_weights,
                       rules_overrides=rules_overrides)

    archs = list_configs() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": ["16x16"], "multi": ["2x16x16"],
              "both": ["16x16", "2x16x16"], "1x1": ["1x1"],
              "all": list(PRODUCTION_MESHES)}[args.mesh]

    done = set()
    if args.skip_done and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r["arch"], r["shape"], r["mesh"]))
                except json.JSONDecodeError:
                    pass

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    n_ok = n_fail = n_skip = 0
    t_start = time.perf_counter()
    with open(args.out, "a") as out:
        for arch in archs:
            for shape_name in shapes:
                for mesh_name in meshes:
                    if (arch, shape_name, mesh_name) in done:
                        continue
                    tag = f"{arch} × {shape_name} × {mesh_name}"
                    try:
                        rec = run_cell(arch, shape_name, mesh_name,
                                       cfg_overrides, cell_kwargs)
                    except Exception as e:  # noqa: BLE001 — a record per cell
                        rec = {"arch": arch, "shape": shape_name,
                               "mesh": mesh_name, "status": "error",
                               "error": f"{type(e).__name__}: {e}",
                               "trace": traceback.format_exc()[-2000:]}
                    if args.tag:
                        rec["tag"] = args.tag
                    if cfg_overrides or args.microbatches > 1 \
                            or args.cast_bf16 or args.decode_ws \
                            or args.int8_weights or rules_overrides:
                        rec["variant"] = {"overrides": cfg_overrides,
                                          **cell_kwargs}
                    out.write(json.dumps(rec) + "\n")
                    out.flush()
                    if rec["status"] == "ok":
                        n_ok += 1
                        r = rec["roofline"]
                        mem = rec["memory"]["bytes_in_use_per_device"]
                        print(f"[OK]   {tag}: meta step={rec['compile_s']}s "
                              f"dominant={r['dominant']} "
                              f"frac={r['roofline_fraction']:.3f} "
                              f"mem/dev={mem / 1e9:.2f}GB", flush=True)
                    elif rec["status"] == "skipped":
                        n_skip += 1
                        print(f"[SKIP] {tag}: {rec['reason']}", flush=True)
                    else:
                        n_fail += 1
                        print(f"[FAIL] {tag}: {rec['error']}", flush=True)
    print(f"done: {n_ok} ok, {n_fail} failed, {n_skip} skipped in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
