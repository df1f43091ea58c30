"""Render the dry run's JSONL records as roofline tables (the JAX
package's ``analysis/report.py``; the same tables, cell for cell, for the
same records).

    PYTHONPATH=src python -m repro_torch.analysis.report \
        results/dryrun_torch.jsonl [roofline|dryrun]

For the port's records (``launch/dryrun.py``) the columns read: compute,
memory and collective — the H100 terms of ``analysis/roofline.py``; frac
— useful compute at the card's bf16 peak over the bound; useful — model
FLOPs over the counted FLOPs of every chip; compile — the meta step's
seconds on the host (nothing is compiled); FLOPs/dev — one data rank's
counted step; mem/dev — its arguments by placement, saved activations
and outputs.
"""
from __future__ import annotations

import json
import sys


def load(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(l) for l in f if l.strip()]


def fmt_bytes(b) -> str:
    if b is None:
        return "-"
    if b >= 1e12:
        return f"{b / 1e12:.2f}TB"
    if b >= 1e9:
        return f"{b / 1e9:.2f}GB"
    if b >= 1e6:
        return f"{b / 1e6:.1f}MB"
    return f"{b / 1e3:.0f}KB"


def fmt_s(x) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.0f}µs"


def roofline_table(rows: list[dict], mesh: str) -> str:
    out = ["| arch | shape | dominant | compute | memory | collective | "
           "frac | useful | mem/dev |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["status"] != "ok" or r["mesh"] != mesh:
            continue
        rl = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | **{rl['dominant']}** "
            f"| {fmt_s(rl['compute_s'])} | {fmt_s(rl['memory_s'])} "
            f"| {fmt_s(rl['collective_s'])} | {rl['roofline_fraction']:.3f} "
            f"| {rl['useful_ratio']:.3f} "
            f"| {fmt_bytes(r['memory']['bytes_in_use_per_device'])} |")
    return "\n".join(out)


def dryrun_table(rows: list[dict]) -> str:
    out = ["| arch | shape | mesh | status | compile | FLOPs/dev | "
           "coll bytes/dev (AG/AR/RS/A2A/CP) | mem/dev |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["status"] == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"SKIP ({r['reason'][:40]}…) | | | | |")
            continue
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"ERROR | | | | |")
            continue
        rl = r["roofline"]
        cb = rl["coll_by_type"]
        coll = "/".join(fmt_bytes(cb.get(k, 0)) for k in
                        ("all-gather", "all-reduce", "reduce-scatter",
                         "all-to-all", "collective-permute"))
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok "
            f"| {r['compile_s']}s | {rl['flops_per_device']:.3g} "
            f"| {coll} | {fmt_bytes(r['memory']['bytes_in_use_per_device'])} |")
    return "\n".join(out)


MESH_TITLES = {"1x1": "One card (1×1)",
               "16x16": "Single-pod (16×16 = 256 chips)",
               "2x16x16": "Multi-pod (2×16×16 = 512 chips)"}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    rows = load(argv[0] if argv else "results/dryrun_torch.jsonl")
    which = argv[1] if len(argv) > 1 else "roofline"
    if which == "roofline":
        meshes = [m for m in MESH_TITLES if any(r["mesh"] == m for r in rows)]
        for i, mesh in enumerate(meshes):
            print(("\n" if i else "") + f"### {MESH_TITLES[mesh]}\n")
            print(roofline_table(rows, mesh))
    else:
        print(dryrun_table(rows))


if __name__ == "__main__":
    main()
