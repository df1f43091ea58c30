#!/usr/bin/env python3
"""Two trees' pipeline launchers on one card, in turns.

    python3 chip_launcher_ab.py OLD_TREE NEW_TREE

Runs ``launch.train --pipeline 1f1b --mesh DxS`` (rank-stacked, on
``cuda:0``, ``chip_smoke.py``'s pipeline inputs: 8 microbatches of 8 rows)
for ``STEPS`` steps at each of ``MESHES``, every tree in a process of its
own, in the order old, new, new, old, ``ROUNDS`` times: two versions of
the launcher are compared on one card within one run.  Prints, per run
and mesh, the step times on the host clock (the mean and median of the
steps after the first two) and the losses; then per mesh each tree's
run medians, their median, the old tree's own spread and whether every
run's losses were the same; then the card's name and power limit.  A
tree is a checkout of the repository, for example a parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists.
Needs one card; exits non-zero if any run fails.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

MESHES, STEPS, ROUNDS = ("1x4", "2x2"), 30, 3

PROGRAM = """
import json, shutil, sys, tempfile
sys.path.insert(0, "src")
from repro_torch.launch import train
out = {{}}
for mesh in {meshes!r}:
    ckpt = tempfile.mkdtemp(prefix="launcher_ab_")
    try:
        args = train.build_parser().parse_args([
            "--device", "cuda", "--pipeline", "1f1b", "--mesh", mesh,
            "--microbatches", "8", "--global-batch", "8",
            "--steps", "{steps}", "--ckpt-dir", ckpt])
        rep = train.run(args, log_every=1)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    out[mesh] = {{"step_ms": [m["step_time_s"] * 1e3 for m in rep.log],
                 "losses": [m["loss"] for m in rep.log],
                 "dispatches": rep.reduce_dispatches}}
print("AB " + json.dumps(out))
"""


def run_tree(tree: Path) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", PROGRAM.format(meshes=MESHES, steps=STEPS)],
        cwd=tree, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"{tree}: exit {proc.returncode}")
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("AB "))
    return json.loads(line[3:])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("new", type=Path)
    a = ap.parse_args()
    medians, losses = {}, {}
    for name, tree in (("old", a.old), ("new", a.new), ("new", a.new),
                       ("old", a.old)) * ROUNDS:
        res = run_tree(tree.resolve())
        for mesh, r in res.items():
            later = r["step_ms"][2:]
            medians.setdefault((mesh, name), []).append(
                statistics.median(later))
            losses.setdefault(mesh, set()).add(tuple(r["losses"]))
            print(f"{name} {tree} --mesh {mesh}: step ms mean "
                  f"{statistics.mean(later):.3f} median "
                  f"{statistics.median(later):.3f} (steps 2-"
                  f"{len(r['step_ms']) - 1}); reducer dispatches a step "
                  f"{r['dispatches']}; losses {r['losses']}", flush=True)
    for mesh in MESHES:
        old, new = medians[(mesh, "old")], medians[(mesh, "new")]
        q = statistics.quantiles(old, n=4)
        print(f"--mesh {mesh}: the runs' median step ms, old "
              f"{[round(v, 3) for v in old]}, new "
              f"{[round(v, 3) for v in new]}; median of the runs old "
              f"{statistics.median(old):.3f}, new "
              f"{statistics.median(new):.3f}; old's own spread (its "
              f"quartiles' distance) {q[2] - q[0]:.3f}; every run's "
              f"losses {'the same' if len(losses[mesh]) == 1 else 'DIFFER'}"
              f" in both trees")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
