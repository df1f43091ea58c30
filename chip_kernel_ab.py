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

    python3 chip_kernel_ab.py --bits OLD_TREE NEW_TREE

runs the two attention kernels of each tree (uncapped: the call both
trees take) on the same seeded inputs at the train and serve paths'
heads, in bf16 and f32, and fails unless every output has the same bits
in both trees: a change that must leave a kernel's arithmetic as it was
(grok-1's logit cap, a template flag whose cap-0 instantiation is the
old code) is held to it.
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


BITS = """
import hashlib, sys, torch
sys.path.insert(0, "src")
from repro_torch.kernels.decode_attention import flash_decode
from repro_torch.kernels.flash_attention import flash_attention
torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator(device="cuda").manual_seed(0)


def digest(t):
    torch.cuda.synchronize()
    raw = t.contiguous().view(torch.uint8).cpu().numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()[:24]


def randn(*shape, scale=1.0):
    return torch.randn(*shape, generator=gen, device="cuda") * scale


for dtype in (torch.bfloat16, torch.float32):
    # smollm-360m, qwen2.5-3b, granite-moe and grok-1 heads
    for B, S, H, KVH, hd in ((8, 1024, 15, 5, 64), (8, 1024, 16, 2, 128),
                             (8, 1024, 24, 8, 64), (2, 1024, 48, 8, 128)):
        for causal in (True, False):
            q, k, v = (randn(B, S, n, hd, scale=2.0).to(dtype)
                       for n in (H, KVH, KVH))
            print("flash_attention", B, S, H, KVH, hd, causal, dtype,
                  digest(flash_attention(q, k, v, causal=causal)))
        q = randn(B, H, hd, scale=2.0).to(dtype)
        k, v = (randn(B, S, KVH, hd).to(dtype) for _ in range(2))
        lengths = torch.randint(1, S + 1, (B,), generator=gen,
                                device="cuda", dtype=torch.int32)
        print("flash_decode", B, S, H, KVH, hd, dtype,
              digest(flash_decode(q, k, v, lengths)))
"""


def same_bits(old: Path, new: Path) -> int:
    outs = []
    for label, tree in (("old", old), ("new", new)):
        print(f"== {label}: {tree} (attention kernels' bits)", flush=True)
        res = subprocess.run([sys.executable, "-c", BITS], cwd=tree,
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        outs.append(res.stdout.splitlines())
    for a, b in zip(*outs):
        print(("same  " if a == b else "DIFFER") + " " + b, flush=True)
    if outs[0] != outs[1] or not outs[0]:
        print("the two trees' kernels give other bits", file=sys.stderr)
        return 1
    print(f"same bits in both trees: {len(outs[0])} outputs")
    return 0


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=DEFAULT,
                    help=f"comma-separated, of {', '.join(KNOWN)}")
    ap.add_argument("--bits", action="store_true",
                    help="compare the attention kernels' output bits")
    ap.add_argument("old")
    ap.add_argument("new")
    args = ap.parse_args(argv)
    if args.bits:
        return same_bits(Path(args.old).resolve(), Path(args.new).resolve())
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
