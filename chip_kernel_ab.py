#!/usr/bin/env python3
"""Two trees' kernels on one card, in turns.

    python3 chip_kernel_ab.py [--phases P1,P2,...] OLD_TREE NEW_TREE

Runs kernel phases of each tree's own ``chip_smoke.py`` (each kernel
checked against its plain version, then timed beside its bound and, where
one exists, a PyTorch yardstick), every tree in a process of its own, in
the order old, new, new, old: two versions of a kernel are compared on one
card within one run.  ``--phases`` names the phases, each a function
``kernel_<phase>`` of ``chip_smoke.py``: ``flash_decode``,
``flash_attention`` (the default pair), ``rmsnorm`` (``rmsnorm_fwd``),
``rmsnorm_bwd``, ``ssd_chunk``.  A tree is a checkout of the repository,
for example a parent commit unpacked with ``git archive`` into a directory
that ``.gitignore`` lists; each builds its kernels into its own
``build/``.  Needs one card; exits non-zero if any run fails.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

KNOWN = ("flash_decode", "flash_attention", "rmsnorm", "rmsnorm_bwd",
         "ssd_chunk")
DEFAULT = "flash_decode,flash_attention"


def program(phases: list[str]) -> str:
    return ("import torch, chip_smoke\n"
            "torch.backends.cuda.matmul.allow_tf32 = False\n"
            "torch.backends.cudnn.allow_tf32 = False\n"
            "gen = torch.Generator(device='cuda').manual_seed(0)\n"
            + "".join(f"chip_smoke.kernel_{p}(gen)\n" for p in phases))


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=DEFAULT,
                    help=f"comma-separated, of {', '.join(KNOWN)}")
    ap.add_argument("old")
    ap.add_argument("new")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = [p for p in phases if p not in KNOWN]
    if unknown or not phases:
        print(f"unknown phases {unknown}: choose from {KNOWN}", file=sys.stderr)
        return 2
    old, new = Path(args.old).resolve(), Path(args.new).resolve()
    code = program(phases)
    for label, tree in (("old", old), ("new", new), ("new", new),
                        ("old", old)):
        if not (tree / "chip_smoke.py").exists():
            print(f"{tree}: no chip_smoke.py", file=sys.stderr)
            return 2
        print(f"== {label}: {tree} ({', '.join(phases)})", flush=True)
        rc = subprocess.run([sys.executable, "-c", code], cwd=tree).returncode
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
