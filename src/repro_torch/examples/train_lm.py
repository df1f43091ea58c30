"""End-to-end training driver with checkpoint/restart (the JAX package's
``examples/train_lm.py``).

Any registered architecture is selectable; ``--scale tiny|small|full``
shrinks the config (``full`` keeps its published widths).  Demonstrates:
engine-driven prefetch + async checkpointing, restart (rerun the same
command — it resumes from the last committed step), straggler stats.

    PYTHONPATH=src python -m repro_torch.examples.train_lm \
        --arch smollm-360m --scale tiny --steps 30 [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

# The example scales, which the launchers read too.
SCALES = {
    # ~1M params: fast CPU demo
    "tiny": dict(num_layers=2, d_model=64, d_ff=128, vocab_size=512,
                 num_heads=4, num_kv_heads=2, head_dim=16, remat_policy="none"),
    # ~25M params: slower but meaningful loss curves on CPU
    "small": dict(num_layers=4, d_model=256, d_ff=1024, vocab_size=4096,
                  num_heads=8, num_kv_heads=4, head_dim=32, remat_policy="none"),
    "full": {},
}


def make_config(arch: str, scale: str):
    """``arch`` at ``scale``, as the JAX example shrinks it (the MoE's
    experts take half the scale's d_ff)."""
    from repro_torch.configs import get_config
    overrides = dict(SCALES[scale])
    cfg = get_config(arch)
    if overrides:
        if cfg.moe:
            overrides["moe"] = cfg.moe.__class__(
                num_experts=4, top_k=2, expert_d_ff=overrides["d_ff"] // 2,
                group_size=64)
            overrides["d_ff"] = overrides["d_ff"] // 2
        if cfg.ssm:
            overrides["ssm"] = cfg.ssm.__class__(
                d_state=16, expand=2, head_dim=16, chunk_size=16)
        if cfg.shared_attn_every:
            overrides.update(num_layers=5, shared_attn_every=2,
                             shared_attn_lora_rank=8)
        if cfg.is_encoder_decoder:
            overrides.update(num_encoder_layers=2, encoder_frames=16,
                             max_position_embeddings=256)
        cfg = cfg.with_overrides(**overrides)
    return cfg


def build_parser() -> argparse.ArgumentParser:
    from repro_torch.configs import list_configs
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="smollm-360m", choices=list_configs())
    ap.add_argument("--scale", default="tiny", choices=list(SCALES))
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv=None) -> dict:
    """Train; returns the committed step it resumed from (None for a fresh
    start), the first step it ran, the logged metrics and the trainer."""
    from repro_torch import resolve_device
    from repro_torch.core import ProgressEngine
    from repro_torch.data.pipeline import PrefetchPipeline, SyntheticLM
    from repro_torch.launch.steps import train_step_fn
    from repro_torch.models import registry
    from repro_torch.models.layers import tree_leaves
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_loop import Trainer, TrainLoopConfig

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = make_config(args.arch, args.scale)
    params = registry.init_params(
        cfg, torch.Generator(device=device).manual_seed(0))
    n = sum(p.numel() for _, p in tree_leaves(params))
    print(f"arch={args.arch} scale={args.scale} params={n / 1e6:.1f}M "
          f"device={device}")

    ocfg = opt_mod.AdamWConfig(lr=args.lr, warmup_steps=5,
                               total_steps=max(args.steps, 10))
    opt_state = opt_mod.init(params)

    def make_batch(b):
        batch = {k: torch.from_numpy(v.copy()).to(device)
                 for k, v in b.items()}
        if cfg.is_encoder_decoder:
            batch["encoder_embeds"] = torch.ones(
                (batch["tokens"].shape[0], cfg.encoder_frames, cfg.d_model),
                dtype=torch.bfloat16, device=device)
        return batch

    eng = ProgressEngine()
    src = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=11)
    pipe = PrefetchPipeline(map(make_batch, iter(src)), eng, depth=3)
    trainer = Trainer(
        train_step_fn(cfg, ocfg), params, opt_state, pipe,
        TrainLoopConfig(total_steps=args.steps, checkpoint_every=10,
                        checkpoint_dir=os.path.join(args.ckpt_dir, args.arch),
                        log_every=5, resume=True),
        engine=eng,
        hooks=[lambda s, m: print(
            f"step {s:4d} loss={m['loss']:.4f} gnorm={m['grad_norm']:.2f} "
            f"lr={m['lr']:.2e} {m['step_time_s'] * 1e3:.0f}ms", flush=True)])
    resumed = trainer.ckpt.latest_step()
    if resumed is not None:
        print(f"resuming from committed step {resumed}")
    try:
        log = trainer.run()
    finally:
        pipe.close()
    if log:
        print(f"done: loss {log[0]['loss']:.4f} -> {log[-1]['loss']:.4f}; "
              f"stragglers flagged: {dict(trainer.straggler.flagged)}")
    else:
        print(f"done: nothing to do, committed step {resumed} is the last "
              f"of --steps {args.steps}")
    return {"resumed_from": resumed, "start_step": trainer.start_step,
            "log": log, "trainer": trainer}


if __name__ == "__main__":
    main()
