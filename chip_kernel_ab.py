#!/usr/bin/env python3
"""Two trees' attention kernels on one card, in turns.

    python3 chip_kernel_ab.py OLD_TREE NEW_TREE

Runs the ``flash_decode`` and ``flash_attention`` kernel phases of each
tree's own ``chip_smoke.py`` (each kernel checked against its plain
version, then timed beside its bound and the ``sdpa`` yardstick), every
tree in a process of its own, in the order old, new, new, old: two
versions of a kernel are compared on one card within one run.  A tree is
a checkout of the repository, for example a parent commit unpacked with
``git archive`` into a directory that ``.gitignore`` lists; each builds
its kernels into its own ``build/``.  Needs one card; exits non-zero if
any run fails.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

PHASES = (
    "import torch, chip_smoke\n"
    "torch.backends.cuda.matmul.allow_tf32 = False\n"
    "torch.backends.cudnn.allow_tf32 = False\n"
    "gen = torch.Generator(device='cuda').manual_seed(0)\n"
    "chip_smoke.kernel_flash_decode(gen)\n"
    "chip_smoke.kernel_flash_attention(gen)\n")


def main(argv: list[str]) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = (Path(a).resolve() for a in argv)
    for label, tree in (("old", old), ("new", new), ("new", new),
                        ("old", old)):
        if not (tree / "chip_smoke.py").exists():
            print(f"{tree}: no chip_smoke.py", file=sys.stderr)
            return 2
        print(f"== {label}: {tree}", flush=True)
        rc = subprocess.run([sys.executable, "-c", PHASES], cwd=tree).returncode
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
