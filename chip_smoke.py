#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

1. build   — nvcc builds the kernel library from ``src/repro_torch/csrc``
             for sm_90a (commands and seconds printed);
2. kernels — each of the five hand-written kernels against its plain
             PyTorch version on the card, at the serve and train paths'
             shapes, in bf16 and f32, with the tolerance stated; timed
             with the profiler and CUDA events beside its bound and,
             where one exists, one PyTorch library call (a yardstick
             only);
3. serve   — the port's serving launcher (``repro_torch.launch.serve``)
             at full qwen2-0.5b width (16 requests of 16 to 96 prompt
             tokens through 8 lanes, caller-driven, and then with two progress workers at 2 of
             its 24 layers), at full mamba2-1.3b width (16 requests
             through 8 lanes, caller-driven, at 12 of its 48 layers) and
             at full qwen2.5-3b width with int8 K/V (as qwen2-0.5b,
             caller-driven, at 6 of its 36 layers).  Launch
             counters are zeroed just before and read just after each
             run, and must show every fused decode/prefill call went
             through its kernels and no training kernel.  After each
             caller-driven run one fused decode call is timed: host wall
             clock (unprofiled) against device busy time (profiled).
             On the qwen2.5-3b engine's weights: the slot cache against
             the paged pool (bf16 and int8 K/V), and int8 weights
             (``decode_step_q``) against bf16;
4. train   — the port's training launcher (``repro_torch.launch.train``)
             at full smollm-360m width (caller-driven and then with two
             progress workers at 8 of its 32 layers, each from a fresh
             checkpoint directory;
             the final async checkpoint must restore to the same
             tensors) and at full mamba2-1.3b width (caller-driven, at
             6 of its 48 layers, checked alike): 3 steps of batch
             8 x 1024 tokens.  The launch
             counters must show every step went through its kernels as
             many times as ``kernel_launches_per_step`` derives; after
             each caller-driven run one step is timed as in phase 3.
             Then qwen2.5-3b at full width through ``make_train_step``
             (vocab-chunked loss, "subblock" remat, 4 steps of 8 x 1024
             tokens; at step 0 the chunked loss equals the plain one);
6. remat   — one forward and backward of full-width smollm-360m under
             each checkpoint policy, and of mamba2-1.3b (8 layers) under
             "full" and "dots": the same gradients as "full", the derived
             launches, each policy's time and peak memory;
7. check   — full-width f32 decode steps (qwen2.5-3b with int8 K/V at 2
             layers) and one full-width two-layer f32 train step of each
             family, on the card (kernels) against the same steps on the
             CPU (plain versions); then the event and task classes on
             the card (``TaskQueue``, ``TaskGraph``, ``CompletionWatcher``
             and ``EventQueue`` over CUDA events, driven by the engine,
             no poll synchronizing);
8. collectives — the user-space collectives (``repro_torch.collectives``)
             on the card: every op × algorithm at 2, 3, 4 and 8 ranks,
             chunks 1 and 4, round batch 1 and auto, one-shot and
             persistent; int32 bit for bit against the plain reference,
             f32 and bf16 bit for bit against the same schedule on the
             CPU, no synchronize; compressed_allreduce, a P2P channel
             and a persistent allreduce restarted 20 times (no new
             allocation); the polls that found a round pending; then a
             256 MiB ring allreduce beside a chain of bf16 GEMMs, each
             stream's busy time and their overlap (printed);
9. train_dp — the train launcher data-parallel at full smollm-360m
             width: 4 ranks on the card (``--devices 4 --collective-backend
             user``, ring, 4 chunks, 32 MiB buckets), 3 steps of 8 x 1024
             tokens under the Trainer, launch counts, the checkpoint
             restored equal, the losses within a stated tolerance of the
             single-card run's; one step's time, the reducer's device
             time and its overlap; step 0's reduced gradient against the
             single-card gradient (full width bf16, and two layers f32);
10. parallel — FSDP at full smollm-360m width (``--devices 4 --fsdp``,
             4 MiB buckets, ring, 4 chunks, 3 steps of 8 x 1024 tokens) on
             the user backend (``FsdpStep`` on the ``FsdpReducer``) and the
             native one: launch counts, the checkpoint restored equal, the
             losses against native FSDP, data-parallel and the single
             card within limits stated before the run; one step's device
             time per stream; step 0's gather bit for bit.  Elastic: 2 of
             4 ranks killed at step 2 of 5 (data-parallel and FSDP, 2
             layers) against a checkpoint-and-restart on the survivors;
             the watchdog failing a hung start once.  Pipeline: 1F1B at
             S = 4, M = 8 on 4 stage CUDA streams, bit for bit against the
             sequential cells, its measured bubble; ``--pipeline 1f1b
             --mesh 2x4`` through the launcher.

11. serve_sharded — the serve launcher at full qwen2-0.5b width on 4
             model ranks of the card (``--devices 4 --model-shards 4``, the
             16 requests through 8 lanes of phase 3) on the user backend
             (a persistent all-gather, ring, 2 chunks: the main path; its
             launches; one gather start a step; its streams against phase
             3's, within a limit stated before the run); one call's device
             time per stream; at 2 of the 24 layers the user backend
             caller-driven (its streams held by phase 16), the native one
             (every fused call's concatenated partial logits against the
             unsharded unembed) and two progress workers, both serving
             the caller-driven streams bit for bit; an executor never
             started serves; mamba2-1.3b on 2 ranks at 12
             of its 48 layers, user = native; membership changes mid
             decode (down to 2 ranks and to 1), mid prefill and by the
             watchdog against a run without failure (at 2 layers);
             ``--chaos-kill 2`` (at 2 layers); a lane
             checkpointed after 40 tokens restored into a shifted pool
             decodes on bit for bit.
12. moe    — granite-moe-3b-a800m at full width served at 8 of its 32
             layers (16 short
             requests through 8 lanes over phase 3's 1024-position view,
             caller-driven; its launches, one fused call timed, the slot
             cache against the paged pool) and trained through the train
             launcher at 4 of its 32 layers (3 steps of 8 x 1024 tokens,
             "full" remat, the aux loss of each step finite, the ~6 GB
             checkpoint restored equal); grok-1-314b served at full widths at 2
             of its 64 layers, every flash_decode launch with its logit
             cap of 30; one granite MoE layer expert-parallel on 4 model
             ranks, the user-space all-to-all against the native block
             transpose and ``moe_apply``, bit for bit.  The kernels phase
             holds both attention kernels with the cap at grok's heads
             (cap 0: the uncapped kernel's bits) and the norms and
             attention at granite's shapes; phase 7 holds granite's loss,
             gradients and paged decode at 2 layers, card against CPU.
13. families — zamba2-1.2b at full width and 13 of its 38 layers served
             (16 short requests through 8 lanes over phase 3's
             1024-position view, caller-driven; 18 rmsnorm_fwd and 2
             flash_decode a fused call, one call timed, the slot cache against the
             paged pool bit for bit) and trained through the train
             launcher at 7 of its layers (3 steps of 8 x 1024 tokens,
             "full" remat, the launches as derived, the checkpoint
             restored equal);
             whisper-tiny trained so (encoder embeddings of ones, as the
             JAX launcher feeds them) and decoded on the slot cache (8
             lanes, the encoder over seeded frames [8, 1500, 384], the
             cross K/V filled per layer, 32 greedy tokens, 8 flash_decode
             a call); pixtral-12b at full widths and 4 of its 40 layers
             through ``make_train_step`` (1024 vision embeddings before
             1024 text tokens, 4 steps, the chunked loss equal to the
             plain one at step 0); then, in f32 at full widths, card
             against CPU: zamba2 at one group and a tail (decode logits,
             loss, every gradient), whisper at 2 + 2 layers (decode with
             the cross K/V, loss, gradients), pixtral at 2 layers (the
             loss with vision embeddings).  The kernels phase holds every
             kernel at these families' shapes (G = 1, non-causal Sq 1024
             against Sk 1500, flash_decode over 1500 keys, ssd_chunk at
             d_state 64, pixtral's norms and heads).

14. context — the model axis in training: smollm-360m at full width and
             all 32 layers trained through the train launcher with
             ``attention_impl="ring"`` on ``--mesh 1x4`` (3 steps of 8 x
             1024 tokens, "full" remat; no flash_attention launch, the
             norms of the single-card run, the checkpoint restored
             equal), one step's time; the ring's device time at that
             shape against the flash_attention launches it replaces;
             in f32 at full widths (2 layers, S 128) the ring held against
             the CPU, against "xla" (the flash_attention kernel) and under
             "full" and "subblock" remat (whose backward autograd runs on
             its device thread) against "none"; the MoE block's
             tensor-parallel schedule at grok-1's widths on 4 model ranks
             against the einsum branch in f32, and both timed in bf16.

15. cells  — ``launch/steps.py``'s cells at the assigned shapes
             (``configs/shapes.py``) on the card: qwen2-0.5b
             ``decode_32k`` at all 128 lanes, every lane at position
             32767 (51.5 GB of bf16 K/V filled in place from a seeded
             generator), with bf16 weights and with int8 weights on the
             same cache; zamba2-1.2b ``long_500k`` (flash_decode over
             524288 keys at its 6 sites); qwen2-0.5b ``prefill_32k`` at 1
             of its 32 sequences (flash_attention at 32768 queries);
             smollm-360m ``train_4k`` at 16 of its 256 sequences, in 8
             microbatches of 2, bf16 cast.  Each: one step's time (CUDA
             events), its launches against the dry run's meta count of
             the same cell (and train's against
             ``kernel_launches_per_step``), its peak memory, the dry
             run's one-card bound and the time over it; then each card
             against the CPU in f32 at 2 layers (zamba2: one group and
             a tail; prefill over 4096 positions).  The dry run over
             every registered config x assigned shape on 1x1 runs on the
             host (two processes, half the configs each) after the
             timed steps, beside those checks and the five examples on
             the card (``train_lm --scale full --steps 4``, then resumed
             to step 5), for at most ``DRYRUN_BUDGET_S`` (else the
             cells' own records only).  The kernels phase holds
             flash_decode at the two decode shapes and
             flash_attention at 32768 queries on its last 1024 query
             rows, in bf16 to a limit scaled to the output's rms, which
             zeros and the output over half the keys fail.

16. devices — a mesh with one device per rank (``launch.mesh``'s
             ``devices=`` form; distinct cards cuda:0..3 on a machine
             with four or more, else cuda:0 listed four times, which a
             line says; peer access printed for every pair of distinct
             cards), run after phase 11: every op × algorithm at 2 and 4
             ranks, int32, f32 and bf16, chunks 1 and 4, round batch 1
             and auto, one-shot and persistent, each bit for bit against
             the rank-stacked run on cuda:0 (int32 also against the
             plain reference) under ``set_sync_debug_mode("error")``; a
             persistent ring allreduce of 256 MiB a rank restarted 20
             times (``memory_allocated`` of every device unchanged, ms an
             allreduce, and on distinct cards the bus bandwidth as
             nccl-tests define it), and beside it the native one
             (``collectives.native_devices``: NCCL on distinct cards,
             its version logged, else the sum in rank order on cuda:0;
             the same checks, the route logged); phase 9's
             data-parallel smollm-360m
             run with ``--rank-devices`` (a replica of the weights and
             AdamW state on each rank's device): its losses equal phase
             9's bit for bit, the replicas equal on every device, the
             checkpoint (rank 0's replica) restored equal, per device the
             port's kernel launches a step (each wrapper's count filed
             under the card current at its launch: its ranks' share of a
             single-card step's; the profiler's events beside it), busy
             ms and idle share (profiler) and peak memory; a chaos kill
             of 1 of 4 ranks at step 1 of 3, at 2 layers, rank-stacked and
             per device, the losses equal bit for bit; the same run on
             the native backend (the mean through
             ``native_allreduce`` in the step): losses within
             ``DP_LOSS_ATOL`` of phase 9's, the replicas equal, each
             card's launches its ranks' single-card passes, the route,
             step ms beside the user run's and a profiled step's busy
             and idle a card; and FSDP on the native backend with a
             device per rank against phase 10's native run (within
             ``FSDP_NATIVE_ATOL``, bit for bit logged), the same
             figures.  Then FSDP with a
             device per rank: phase 10's user run, 3 steps, with
             rank r's ZeRO blocks, moments, step counter and pass on its
             card, under ``no_sync`` (its losses equal phase 10's bit for
             bit; each card's launches its ranks' share of a single-card
             step; the checkpoint, the stacked run's files, restored
             equal; ``reshard_restore`` of it onto the per-device mesh,
             each card its block; a profiled step: busy and idle a card,
             the prefetch overlap); a chaos kill of 2 of 4 ranks at 2
             layers, the survivors on the first 2 cards, bit for bit
             against a restart there.  And sharded serving with a device
             per model rank: qwen2-0.5b at full width and 2 layers on 4
             ranks (16 requests through 8 lanes), user (ring, 2 chunks)
             and native bit for bit, one gather start a step, against
             phase 11's stacked streams at 2 layers; a recovery mid
             decode, 4 -> 2 ranks, lanes restored into both survivors'
             pools; at full depth one fused call's launches on each card
             (49 ``rmsnorm_fwd`` and 24 ``flash_decode`` a rank), its
             partial logits gathered to cuda:0 against the stacked
             ``unembed_ranks`` of rank 0's hidden state, its host wall,
             each card's busy time and idle share and the gather's
             device time.  Then the non-dense families at full width
             (mamba2 at 2 layers, zamba2 at 7, whisper-tiny whole,
             granite-moe at 2; pixtral at 1, its data-parallel pair
             only and only on cards of their own), data-parallel and
             FSDP on 2 ranks with ``--rank-devices``, each bit for bit
             its stacked run, each card's launches of ``rmsnorm_fwd``,
             ``rmsnorm_bwd``, ``flash_attention`` and ``ssd_chunk`` its
             ranks' single-card passes.  Its model-axis part runs after
             phase 14, whose
             losses it takes: phase 14's run (smollm-360m, full width, 32
             layers, "ring" on --mesh 1x4) with ``--rank-devices`` (the
             ring's blocks on the model ranks' cards, the replicated
             layers on the leader's), its losses phase 14's bit for bit,
             each card's launches its leaders' single-card norms and no
             flash_attention (the other ranks' none), the checkpoint
             restored equal; one profiled step (each card's busy ms, idle
             share and peak memory, the sends and ring hops between
             ranks and the bytes that cross cards); the ring alone at the
             train shape, bit for bit the stacked ring's under
             ``set_sync_debug_mode("error")``; ``--mesh 2x2
             --rank-devices`` in f32 within 1e-5 of the stacked run, at 2
             layers and with tiny grok-1 (experts 2048 wide, each data
             row one whole group of the batch's MoE routing); grok-1's
             MoE block with each rank's F-slices on
             its card, bit for bit the stacked tensor-parallel block in
             f32 (TF32 off), both timed in bf16, each card's peak memory.
             Then FSDP on ``--mesh 2x2 --rank-devices`` at full
             width and 2 layers (each data row's blocks copied on both
             cards of its row, the pass and the collectives on the
             leaders), its losses and grad norms bit for bit the stacked
             2x2 run's, every copy its leader's, each card's launches
             (the leaders' single-card step, none elsewhere), the sends
             a step, peak memory, a profiled step; its chaos kill of 1 of
             4 ranks at 2 layers (a remesh to (1, 2)) bit for bit the
             stacked chaos run; ``--microbatches 2`` on the model axis:
             smollm-360m "ring" on --mesh 1x4 at 2 layers bit for bit
             the stacked run (launches, sends, peaks, a profiled step),
             tiny grok-1 on --mesh 2x2 within 1e-5 of it.  Last, MoE
             groups that span the data rows on --mesh 2x2
             --rank-devices (the rows in lockstep, each group routed on
             the row holding its first token): granite-moe at full width
             and 2 layers over 8 x 192 tokens (three groups of 512, the
             middle one split), tiny grok-1 over 4 x 16 tokens and in 2
             microbatches over 8 x 16, each within 1e-5 of its stacked
             run with PyTorch's stream-mismatch warning made an error,
             each leader's card its single-card norms, the sends a step.

``python3 chip_smoke.py --only parallel`` runs the build, the single-card
and data-parallel train runs and phase 10 alone, and prints no result;
``--only serve-sharded`` the build, phase 3's caller-driven qwen2-0.5b run
and phase 11; ``--only moe`` the build, the two attention kernels' checks
and phase 12 with granite's card-against-CPU checks; ``--only families``
the build, the kernels at the new shapes and phase 13 with its checks;
``--only context`` the build and phase 14; ``--only cells`` the build,
the kernels at the assigned shapes and phase 15; ``--only devices`` the
build, phase 9's data-parallel run, phase 10's user FSDP run, phase 11's
stacked caller-driven run at 2 layers and phase 16 (on a call with four
cards, across them; phase 10's native FSDP run too); ``--only
model-devices`` the build, phase 14's stacked ring run and phase 16's
model-axis part; ``--only families-devices`` the build and phase 16's
non-dense families; ``--only native-devices`` the build, phase 9's
data-parallel run, phase 10's native FSDP run and phase 16's 256 MiB
allreduces (user and native), its data-parallel run and the native
backend's runs with a device per rank.

Prints the versions of torch, CUDA and Python first, and at the end the
card's name and power limit, then one JSON line of kernel figures, then
``{"ok": true, "device": {...}}`` as the last line.  Exits non-zero
without a result when CUDA is missing, and when run outside a checkout
of the repository (it imports ``src/repro_torch``).
"""
from __future__ import annotations

import contextlib
import gc
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

TOLS = {torch.float32: dict(atol=2e-5, rtol=2e-5),     # tests/test_kernels.py
        torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}

ARCH = "qwen2-0.5b"
LANES, MAX_SEQ, BLOCK = 8, 1024, 16
MIN_PROMPT, MAX_PROMPT, MAX_NEW, REQUESTS = 16, 256, 32, 16
# the longest prompt of the qwen serve runs (phases 3, 11 and 16; 256,
# MAX_PROMPT, before it was cut for the script's time limit when phase
# 16 gained the non-dense families and the MoE rows: prefill goes one
# token a fused call, so a prompt's length is its calls).  TRAIN_STEPS
# was 6 before that cut too, and 4 before phase 16 gained the native
# backend's runs with a device per rank
SERVE_MAX_PROMPT = 96
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "smollm-360m", 8, 1024, 3
# the mamba2 paths: serve 16 requests through 8 lanes (each lane serves
# two, so recycled lanes are zeroed on the card); train as the dense path
# (8 x 1024 tokens, 3 steps)
MAMBA = "mamba2-1.3b"
M_MIN_PROMPT, M_MAX_PROMPT, M_MAX_NEW, M_REQUESTS, M_MAX_SEQ = 16, 64, 16, 16, 128
MAMBA_D = 2048                      # mamba2-1.3b's d_model: its norms' width
# qwen2.5-3b: served with int8 K/V as qwen2-0.5b is served (8 lanes, 16
# requests), trained with the vocab-chunked loss and "subblock" remat for
# 4 steps of 8 x 1024 tokens
QWEN3B, Q3_D, Q3_TRAIN_STEPS = "qwen2.5-3b", 2048, 4
POLICIES = ("full", "none", "subblock", "attn_only", "dots")
# the two-worker qwen2-0.5b serve run is cut to this depth (of 24) to keep
# the whole run near its time budget; the caller-driven run keeps 24
SERVE_WORKERS_LAYERS = 2
# the two-worker smollm-360m train run's depth (of 32), for the same
TRAIN_WORKERS_LAYERS = 8
MAMBA_DOTS_LAYERS = 8               # the mamba2 "dots" check's depth
# cut so that the whole run stays well inside its time limit with the MoE
# phase: qwen2.5-3b's int8 K/V serve run (of 36 layers), mamba2-1.3b's
# serve and train runs (of 48; the train run's from 24 to 12, with its
# checkpoint, for phase 15, and to 6 for phase 16's families and MoE
# rows); the serve runs' depths pay for phase 16
Q3_SERVE_LAYERS, MAMBA_SERVE_LAYERS, MAMBA_TRAIN_LAYERS = 6, 12, 6
# the MoE family: granite-moe-3b-a800m trained as smollm-360m is (3 steps
# of 8 x 1024 tokens) and served with the mamba2 path's short requests
# over phase 3's 1024-position view; grok-1-314b served at full widths at
# the depth one card holds (its f32 weights beside the bf16 ones while
# the engine casts them), through the logit-capped flash_decode
GRANITE, GRANITE_D = "granite-moe-3b-a800m", 1536
GROK, GROK_D, GROK_SERVE_LAYERS = "grok-1-314b", 6144, 2
LOGIT_CAP = 30.0                    # grok-1's logit_softcap
CAP_Q_SCALE = 8.0                   # capped kernel inputs: q scaled so scores reach the cap
# the last three families (phase 13): zamba2-1.2b served with the mamba2
# path's short requests over phase 3's 1024-position view and trained as
# smollm-360m is; whisper-tiny trained so, and decoded on the slot cache
# (32 greedy tokens, its decoder's 448 positions, the cross K/V of its
# 1500 encoder frames); pixtral-12b trained at 4 of its 40 layers (its
# f32 training state: 1.34 B embedding and head parameters, ~4.4 GB a
# layer) with 1024 vision patches before 1024 text tokens
ZAMBA, ZAMBA_D = "zamba2-1.2b", 2048
WHISPER, WHISPER_D, WHISPER_FRAMES = "whisper-tiny", 384, 1500
WHISPER_MAX_SEQ, WHISPER_NEW = 448, 32
PIXTRAL, PIXTRAL_D, PIXTRAL_LAYERS, PIXTRAL_STEPS = "pixtral-12b", 5120, 4, 4
PIXTRAL_BATCH, PIXTRAL_PATCHES = 2, 1024
# granite-moe's train run (of 32 layers): its 40 GB checkpoint was the
# script's largest item; at 16 layers it was ~21 GB, at 8 (for phase 15)
# ~11 GB, at 4 (for phase 16) ~6 GB.  zamba2-1.2b's train run: 7 of its
# 38 layers (a group of 6 and the tail; 13 before phase 16's families)
GRANITE_TRAIN_LAYERS = 4
ZAMBA_TRAIN_LAYERS = 7
# granite-moe's and zamba2-1.2b's serve runs (of 32 and 38 layers; zamba2
# 2 groups of 6 and the tail), cut for phase 16 (16 and 19 before the
# non-dense families' runs there)
GRANITE_SERVE_LAYERS, ZAMBA_SERVE_LAYERS = 8, 13
# phase 14: smollm-360m trained with "ring" on a model axis of 4 ranks
# (3 steps since phase 16's families and MoE rows, 5 before)
RING_MESH, RING_STEPS = "1x4", 3
SSD_TOLS = {torch.float32: dict(states=3e-5, decay=1e-5),   # test_kernels.py
            torch.bfloat16: dict(states=3e-2, decay=1e-5)}
L2_BYTES = 50 * 2**20


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(work: tuple, dtype) -> tuple[float, str]:
    """The least ms one H100 SXM could take for ``work`` (flops, bytes;
    the ``*_work`` formula beside each kernel) on ``dtype``: the larger of
    the bytes over the memory rate and the flops over the peak rate of
    the type (``launch.mesh.H100_SXM``, NVIDIA's data sheet, dense), and
    which of the two it is."""
    from repro_torch.launch.mesh import H100_SXM, peak_flops
    flops, nbytes = work
    t_bytes = nbytes / H100_SXM["hbm_bytes_per_s"]
    t_ops = flops / peak_flops(dtype)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, args_list, iters: int = 200) -> float:
    """Mean ms of ``fn(*args)`` over ``iters`` launches, cycling through
    ``args_list`` (copies of the inputs, so they are not all in L2)."""
    for a in args_list[:3]:
        fn(*a)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


NO_PROFILER: list = []      # set once the profiler has recorded nothing


def kernel_key(name: str) -> str:
    """A device event's name without its argument list (the port's kernels
    live in an anonymous namespace, whose parentheses are not an argument
    list), cut to 60 characters unless it is one of the port's kernels."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    return name if "repro_torch::" in name else name[-60:]


def profile_kernels(run, counts: dict | None = None):
    """Device time in us per kernel name over ``run()``, from
    ``torch.profiler``, and ``run()``'s result.  Empty when the profiler
    records no device time: some machines give it no CUPTI access.
    ``counts``, if given, gets the number of events per kernel name."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            key = kernel_key(e.name)
            by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us()
            if counts is not None:
                counts[key] = counts.get(key, 0) + 1
    if not by_name and not NO_PROFILER:
        NO_PROFILER.append(True)
        log("profiler: no device events on this machine; every 'device ms' "
            "below is the CUDA-event time of back-to-back launches, and "
            "device busy time is not measured")
    return by_name, out


def device_ms(fn, args_list, iters: int = 50) -> tuple[float, str]:
    """Mean device time of ``fn(*args)`` in ms and the timer it came from.
    From ``"profiler"``: the summed duration of the CUDA kernels the
    profiler records over ``iters`` calls, which excludes the gaps while
    the host enqueues (at these sizes most of the wall time).  Without
    profiler events, or when the profiler dropped some (a kernel's count
    of events not a multiple of ``iters``), from ``"cuda_events"``:
    ``time_ms``'s back-to-back time, gaps included."""
    for a in args_list[:3]:
        fn(*a)
    torch.cuda.synchronize()

    def run():
        for i in range(iters):
            fn(*args_list[i % len(args_list)])

    counts: dict[str, int] = {}
    by_name, _ = profile_kernels(run, counts)
    if not by_name or any(n % iters for n in counts.values()):
        return time_ms(fn, args_list, iters), "cuda_events"
    return sum(by_name.values()) / iters / 1e3, "profiler"


def measure(fns: dict, args_list, dev_iters: int = 50,
            paced_iters: int = 200):
    """Device ms (``device_ms``) and back-to-back ms (``time_ms``) of each
    of ``fns`` on the same inputs, and the timer of the device ms: one
    name, or ``"mixed"`` if the profiler recorded some calls only."""
    dev, sources = {}, set()
    for name, fn in fns.items():
        dev[name], source = device_ms(fn, args_list, dev_iters)
        sources.add(source)
    paced = {name: time_ms(fn, args_list, paced_iters)
             for name, fn in fns.items()}
    return dev, paced, sources.pop() if len(sources) == 1 else "mixed"


def busy_text(by_name: dict, n: int, wall: float, unit: str, top: int) -> str:
    """Device busy time, idle share and top kernels per ``unit``, from
    ``profile_kernels`` over ``n`` units that took ``wall`` ms each."""
    if not by_name:
        return "device busy not measured (no profiler events)"
    busy = sum(by_name.values()) / n / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    ours = [(k.split("::")[-1], v) for k, v in ranked if "repro_torch::" in k]
    return (f"device busy {busy:.3f} ms, device idle share "
            f"{1 - busy / wall:.3f}; top device time per {unit}: "
            + "; ".join(f"{k} {v / n / 1e3:.4f} ms" for k, v in ranked[:top])
            + f"; the port's kernels per {unit}: "
            + "; ".join(f"{k} {v / n / 1e3:.4f} ms" for k, v in ours))


def copies_for(nbytes: int, iters: int = 200) -> int:
    """Input copies enough to stream twice the L2 cache per cycle."""
    return min(iters, max(1, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


def fmt(times: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in times.items())


def off_limit(got, want, tol) -> torch.Tensor:
    """Where ``got`` is off ``want`` beyond ``tol`` (its atol a number or a
    tensor that broadcasts against ``want``)."""
    return (got.float() - want.float()).abs() \
        > tol["atol"] + tol["rtol"] * want.float().abs()


def tol_text(tol) -> str:
    atol = tol["atol"]
    if torch.is_tensor(atol):
        return (f"atol {SCALED_ATOL:g} x each sequence's rms, "
                f"{float(atol.min()):.3e}-{float(atol.max()):.3e}, rtol "
                f"{tol['rtol']:g}")
    return f"atol/rtol {atol:g}/{tol['rtol']:g}"


def check_close(name, got, want, dtype, tol=None) -> float:
    err = (got.float() - want.float()).abs()
    tol = tol or TOLS[dtype]
    bad = off_limit(got, want, tol)
    if not torch.isfinite(got.float()).all() or bad.any():
        raise AssertionError(
            f"{name} {dtype}: {int(bad.sum())} elements off the plain "
            f"version beyond {tol_text(tol)} (max abs err "
            f"{float(err.max()):.3e})")
    return float(err.max())


# At the assigned shapes an output element averages v over 32768 or
# 524288 keys, so its rms is ~sqrt(e / keys) (~0.009, ~0.002 for unit
# normal inputs): below the bf16 atol of TOLS, which a kernel that wrote
# zeros would pass.  There a bf16 output is held to SCALED_ATOL times its
# own sequence's rms (and the rtol of TOLS), and the limit is shown to
# reject zeros and the output over half the keys (a combine or a key loop
# that dropped half of its splits or tiles).
SCALED_ATOL = 0.1


def scaled_tol(want, dtype) -> dict:
    if dtype != torch.bfloat16:
        return TOLS[dtype]
    w = want.float()
    rms = w.pow(2).mean(dim=tuple(range(1, w.dim())), keepdim=True).sqrt()
    return dict(atol=SCALED_ATOL * rms, rtol=TOLS[dtype]["rtol"])


def rejects(name, want, tol, wrong: dict) -> str:
    """That ``tol`` rejects each of the ``wrong`` outputs; the share of
    elements off in each."""
    parts = []
    for what, out in wrong.items():
        off = off_limit(out, want, tol)
        if not off.any():
            raise AssertionError(f"{name}: the limit ({tol_text(tol)}) "
                                 f"does not reject {what}")
        parts.append(f"{what}: {100 * float(off.float().mean()):.1f}% of "
                     f"elements off")
    return "the limit rejects " + "; ".join(parts)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# the row key of a norm kernel's figures at a path's shape other than its
# main one, by (N == LANES, D)
SHAPE_KEYS = {(False, 960, 1e-5): "train_shape",
              (True, MAMBA_D, 1e-5): "serve_mamba_shape",
              (False, MAMBA_D, 1e-5): "train_mamba_shape",
              (True, Q3_D, 1e-6): "serve_qwen2_5_3b_shape",
              (False, Q3_D, 1e-6): "train_qwen2_5_3b_shape",
              (True, GRANITE_D, 1e-6): "serve_granite_shape",
              (False, GRANITE_D, 1e-6): "train_granite_shape",
              (True, GROK_D, 1e-5): "serve_grok_shape",
              (False, PIXTRAL_D, 1e-5): "train_pixtral_shape"}


# the serve paths' (qwen2-0.5b: decode, prefill chunk; mamba2-1.3b,
# zamba2-1.2b, qwen2.5-3b, granite-moe and grok-1: a fused call) and the
# train paths' (smollm-360m, mamba2-1.3b and zamba2-1.2b, qwen2.5-3b,
# granite-moe, pixtral-12b: the whole batch) shapes; zamba2's norms are
# mamba2's shapes and eps
RMSNORM_SHAPES = ((LANES, 896, 1e-6), (LANES * MAX_PROMPT, 896, 1e-6),
                  (TRAIN_BATCH * TRAIN_SEQ, 960, 1e-5),
                  (LANES, MAMBA_D, 1e-5),
                  (TRAIN_BATCH * TRAIN_SEQ, MAMBA_D, 1e-5),
                  (LANES, Q3_D, 1e-6), (TRAIN_BATCH * TRAIN_SEQ, Q3_D, 1e-6),
                  (LANES, GRANITE_D, 1e-6),
                  (TRAIN_BATCH * TRAIN_SEQ, GRANITE_D, 1e-6),
                  (LANES, GROK_D, 1e-5),
                  (PIXTRAL_BATCH * 2 * TRAIN_SEQ, PIXTRAL_D, 1e-5))


def kernel_rmsnorm(gen, shapes=RMSNORM_SHAPES) -> dict:
    from repro_torch.kernels.rmsnorm import (rmsnorm_fwd, rmsnorm_fwd_path,
                                             rmsnorm_fwd_plain,
                                             rmsnorm_fwd_work)
    row = dict(name="rmsnorm_fwd", route="cuda",
               source="src/repro_torch/csrc/rmsnorm.cu",
               replaces="src/repro/kernels/rmsnorm.py:41")
    for N, D, eps in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(N, D, generator=gen, device="cuda").to(dtype)
            s = torch.randn(D, generator=gen, device="cuda") + 1.0
            got = rmsnorm_fwd(x, s, eps)
            torch.cuda.synchronize()
            err = check_close("rmsnorm_fwd", got, rmsnorm_fwd_plain(x, s, eps),
                              dtype)
            work = rmsnorm_fwd_work(N, D, dtype)
            nbytes = work[1]
            args = [(x.clone(), s) for _ in range(copies_for(nbytes))]
            fns = {"kernel": lambda a, b: rmsnorm_fwd(a, b, eps),
                   "plain": lambda a, b: rmsnorm_fwd_plain(a, b, eps),
                   "F.rms_norm": lambda a, b: F.rms_norm(a, (D,), b.to(dtype),
                                                         eps)}
            dev, paced, source = measure(fns, args)
            bound_ms, by = bound(work, dtype)
            log(f"kernel rmsnorm_fwd N={N} D={D} eps={eps} {str(dtype)[6:]} (path "
                f"{rmsnorm_fwd_path(D, dtype)}): max abs "
                f"err {err:.3e} (atol/rtol {TOLS[dtype]['atol']}); device ms "
                f"({source}) {fmt(dev)}; back-to-back ms per call "
                f"{fmt(paced)}; bound {bound_ms:.6f} ms ({by})")
            if dtype != torch.bfloat16:
                continue
            fig = dict(shape=f"x [{N}, {D}] bfloat16",
                       path=rmsnorm_fwd_path(D, dtype),
                       max_abs_err=err, ms=dev["kernel"],
                       plain_ms=dev["plain"], ms_source=source,
                       bound_ms=bound_ms, bound_by=by,
                       library_ms=dev["F.rms_norm"])
            if (N, D) == (LANES, 896):                      # the serve path
                row.update(fig)
            elif D != 896:
                row[SHAPE_KEYS[N == LANES, D, eps]] = fig
    return row


SERVE_VIEW = -(-MAX_SEQ // BLOCK) * BLOCK     # the serve phases' view length
# ((B, H, KVH, hd), logit cap, row key, cache length S, every length S):
# the serve paths' heads (qwen2-0.5b, qwen2.5-3b, granite-moe, grok-1
# capped, zamba2-1.2b G = 1) over the serve view, and whisper-tiny's
# decode (G = 1): self-attention over its 448 positions, cross-attention
# over all 1500 encoder frames (not a multiple of the 64-key tile)
DECODE_CASES = (((LANES, 14, 2, 64), 0.0, None, SERVE_VIEW, False),
                ((LANES, 16, 2, 128), 0.0, "serve_qwen2_5_3b_shape",
                 SERVE_VIEW, False),
                ((LANES, 24, 8, 64), 0.0, "serve_granite_shape", SERVE_VIEW,
                 False),
                ((LANES, 48, 8, 128), LOGIT_CAP, "serve_grok_shape",
                 SERVE_VIEW, False),
                ((LANES, 32, 32, 64), 0.0, "serve_zamba2_shape", SERVE_VIEW,
                 False),
                ((LANES, 6, 6, 64), 0.0, "serve_whisper_self_shape",
                 WHISPER_MAX_SEQ, False),
                ((LANES, 6, 6, 64), 0.0, "serve_whisper_cross_shape",
                 WHISPER_FRAMES, True))
# the last three families' decode shapes (phase 13)
FAMILY_DECODE_CASES = DECODE_CASES[-3:]
# the assigned decode shapes (phase 15), every lane at its cache's end:
# qwen2-0.5b decode_32k at 128 lanes, zamba2-1.2b long_500k's sites (G = 1,
# 9 splits of 58304 keys)
ASSIGNED_DECODE_CASES = (((128, 14, 2, 64), 0.0, "decode_32k_shape", 32768,
                          True),
                         ((1, 32, 32, 64), 0.0, "long_500k_shape", 524288,
                          True))
DECODE_CASES = DECODE_CASES + ASSIGNED_DECODE_CASES


def kernel_flash_decode(gen, cases=DECODE_CASES) -> dict:
    """flash_decode against its plain version at the serve paths' heads
    (qwen2-0.5b G = 7 hd 64, qwen2.5-3b G = 8 hd 128, granite-moe G = 3
    hd 64) and, with grok-1's logit cap, at grok's (G = 6, hd 128; q
    scaled by ``CAP_Q_SCALE`` so that scores reach the cap).  A capped
    row has no library figure (no single PyTorch call caps the scores),
    and the same inputs with cap 0 must give the uncapped kernel's bits."""
    from repro_torch.kernels.decode_attention import (decode_split_keys,
                                                      decode_splits,
                                                      flash_decode,
                                                      flash_decode_plain,
                                                      flash_decode_work)
    row = dict(name="flash_decode", route="cuda",
               source="src/repro_torch/csrc/flash_decode.cu",
               replaces="src/repro/kernels/decode_attention.py:80")
    for ((B, H, KVH, hd), cap, key, S, full), dtype in itertools.product(
            cases, (torch.bfloat16, torch.float32)):
        # a cache of 1 GiB or more: fewer timed calls (the plain version
        # reads it in f32), and in f32 (no row of the JSON) held, not timed
        big = B * S * KVH * hd * 2 >= 2**30
        many = S >= 32768                   # the assigned shapes' keys
        iters = (10, 20) if big else (50, 200)
        split_keys = decode_split_keys(B, KVH, S)
        splits = decode_splits(B, KVH, S)
        grid = (f"{splits * KVH * B} CTAs ({splits} splits of {split_keys} "
                f"keys x {KVH} KV heads x {B} sequences) + combine "
                f"{-(-B * H * hd // 128)} CTAs")
        q = torch.randn(B, H, hd, generator=gen, device="cuda")
        q = (q * CAP_Q_SCALE if cap else q).to(dtype)
        k = torch.randn(B, S, KVH, hd, generator=gen, device="cuda").to(dtype)
        v = torch.randn(B, S, KVH, hd, generator=gen, device="cuda").to(dtype)
        lengths = (torch.full((B,), S, dtype=torch.int32, device="cuda")
                   if full else
                   torch.randint(1, S + 1, (B,), generator=gen, device="cuda",
                                 dtype=torch.int32))
        got = flash_decode(q, k, v, lengths, logit_cap=cap)
        torch.cuda.synchronize()
        want = flash_decode_plain(q, k, v, lengths, logit_cap=cap)
        tol = scaled_tol(want, dtype) if many else TOLS[dtype]
        err = check_close("flash_decode", got, want, dtype, tol)
        reject_text = ""
        if many:
            # what a combine that kept the first half of the splits gives
            # (half the keys where there is one split)
            kept = (splits // 2) * split_keys if splits > 1 else S // 2
            half = flash_decode_plain(q, k, v, lengths.clamp(max=kept),
                                      logit_cap=cap)
            reject_text = "; " + rejects(
                "flash_decode", want, tol,
                {"zeros": torch.zeros_like(got),
                 f"the output over the first {kept} keys": half})
            del half
        del want
        cap_text = ""
        if cap:
            bits = torch.equal(flash_decode(q, k, v, lengths, logit_cap=0.0),
                               flash_decode(q, k, v, lengths))
            moved = float((got.float() - flash_decode_plain(
                q, k, v, lengths).float()).abs().max())
            if not bits:
                raise AssertionError("flash_decode with cap 0 is not the "
                                     "uncapped kernel's bits")
            cap_text = (f"; logit cap {cap:g}: the cap moves the output by up "
                        f"to {moved:.3e}, cap 0 gives the uncapped kernel's "
                        f"bits")
        if big and dtype == torch.float32:
            log(f"kernel flash_decode B={B} H={H} KVH={KVH} hd={hd} S={S} "
                f"float32: max abs err {err:.3e} ({tol_text(tol)}); grid "
                f"{grid}; not timed{reject_text}")
            continue
        es = q.element_size()
        valid = int(lengths.sum())
        work = flash_decode_work(B, H, KVH, hd, valid, dtype)
        args = [(q, k.clone(), v.clone(), lengths)
                for _ in range(copies_for(2 * k.numel() * es))]
        pos = torch.arange(S, device="cuda")
        mask = (pos[None, :] < lengths[:, None])[:, None, None, :]

        def sdpa(q_, k_, v_, _len):
            return F.scaled_dot_product_attention(
                q_[:, :, None], k_.transpose(1, 2), v_.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)

        fns = {"kernel": lambda *a: flash_decode(*a, logit_cap=cap),
               "plain": lambda *a: flash_decode_plain(*a, logit_cap=cap)}
        if not cap:
            fns["sdpa"] = sdpa
        dev, paced, source = measure(fns, args, *iters)
        bound_ms, by = bound(work, dtype)
        kv_bytes = 2 * valid * KVH * hd * es
        log(f"kernel flash_decode B={B} H={H} KVH={KVH} hd={hd} S={S} "
            f"{str(dtype)[6:]} logit_cap={cap:g} (sum lengths {valid}): max "
            f"abs err {err:.3e} ({tol_text(tol)}); grid {grid}; "
            f"device ms ({source}) {fmt(dev)}; back-to-back ms per call "
            f"{fmt(paced)}; bound {bound_ms:.6f} ms ({by}); kernel "
            f"{kv_bytes / dev['kernel'] / 1e6:.1f} GB/s of valid K/V bytes "
            f"({kv_bytes / 1e6:.3f} MB){cap_text}{reject_text}")
        if dtype != torch.bfloat16:
            continue
        fig = dict(shape=f"q [{B}, {H}, {hd}], k/v [{B}, {S}, {KVH}, "
                         f"{hd}] bfloat16"
                   + (f", logit_cap {cap:g}" if cap else ""), grid=grid,
                   max_abs_err=err, ms=dev["kernel"],
                   plain_ms=dev["plain"], ms_source=source,
                   bound_ms=bound_ms, bound_by=by,
                   library_ms=dev.get("sdpa"))
        if key is None:                                     # the serve path
            row.update(fig)
        else:
            row[key] = fig
    return row


def fused_rms_norm_backward(x, g, w, eps):
    """The yardstick of ``rmsnorm_bwd``: one PyTorch call that gives dx and
    the whole dweight, ``aten._fused_rms_norm_backward``, and the ``rstd``
    it reads (from ``aten._fused_rms_norm``, so outside any timed window);
    None and the reason where the card's torch has no CUDA kernel for it."""
    D = x.shape[1]
    try:
        rstd = torch.ops.aten._fused_rms_norm(x, [D], w, eps)[1]
        torch.ops.aten._fused_rms_norm_backward(g, x, [D], rstd, w,
                                                [True, True])
    except (AttributeError, NotImplementedError, RuntimeError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return rstd, ""


RMSNORM_BWD_SHAPES = ((TRAIN_BATCH * TRAIN_SEQ, 960, 1e-5), (LANES, 896, 1e-5),
                      (TRAIN_BATCH * TRAIN_SEQ, MAMBA_D, 1e-5),
                      (LANES, MAMBA_D, 1e-5),
                      (TRAIN_BATCH * TRAIN_SEQ, Q3_D, 1e-6),
                      (TRAIN_BATCH * TRAIN_SEQ, GRANITE_D, 1e-6),
                      (LANES, GRANITE_D, 1e-6),
                      (PIXTRAL_BATCH * 2 * TRAIN_SEQ, PIXTRAL_D, 1e-5))


def kernel_rmsnorm_bwd(gen, shapes=RMSNORM_BWD_SHAPES) -> dict:
    from repro_torch.kernels.rmsnorm import (rmsnorm_bwd, rmsnorm_bwd_plain,
                                             rmsnorm_bwd_work)
    row = dict(name="rmsnorm_bwd", route="cuda",
               source="src/repro_torch/csrc/rmsnorm.cu",
               replaces="src/repro/kernels/rmsnorm.py:61")
    for N, D, eps in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(N, D, generator=gen, device="cuda").to(dtype)
            g = torch.randn(N, D, generator=gen, device="cuda").to(dtype)
            s = torch.randn(D, generator=gen, device="cuda") + 1.0
            dx, part = rmsnorm_bwd(x, s, g, eps)
            torch.cuda.synchronize()
            want_dx, want_part = rmsnorm_bwd_plain(x, s, g, eps)
            err = check_close("rmsnorm_bwd dx", dx, want_dx, dtype)
            # the summed dscale: tests/test_kernels.py:121-122
            ds_err = check_close("rmsnorm_bwd dscale", part.sum(0),
                                 want_part.sum(0), dtype,
                                 dict(atol=1e-3, rtol=1e-3))
            work = rmsnorm_bwd_work(N, D, dtype)
            nbytes = work[1]
            w = s.to(dtype)     # the library takes weight in x's dtype
            rstd, why = fused_rms_norm_backward(x, g, w, eps)
            args = [(x.clone(), s, g.clone(), rstd, w)
                    for _ in range(copies_for(nbytes))]
            fns = {"kernel": lambda a, b, c, *_: rmsnorm_bwd(a, b, c, eps),
                   "plain": lambda a, b, c, *_: rmsnorm_bwd_plain(a, b, c,
                                                                  eps),
                   # like with like: the caller's sum of the partials
                   # (kernels/ops.py) beside the library's whole dweight
                   "kernel+sum": lambda a, b, c, *_: rmsnorm_bwd(
                       a, b, c, eps)[1].sum(0)}
            if rstd is not None:
                fns["library"] = lambda a, _b, c, r, w_: \
                    torch.ops.aten._fused_rms_norm_backward(
                        c, a, [D], r, w_, [True, True])
                lib_dx = fns["library"](*args[0])[0]
                lib_text = (f"library aten._fused_rms_norm_backward: dx max "
                            f"abs diff from the plain version "
                            f"{float((lib_dx.float() - want_dx.float()).abs().max()):.3e}"
                            f" (weight in {str(dtype)[6:]})")
            else:
                lib_text = (f"no single PyTorch call computes it on this "
                            f"card (aten._fused_rms_norm_backward: {why})")
            dev, paced, source = measure(fns, args)
            bound_ms, by = bound(work, dtype)
            log(f"kernel rmsnorm_bwd N={N} D={D} eps={eps} {str(dtype)[6:]}: max abs "
                f"err dx {err:.3e} (atol/rtol {TOLS[dtype]['atol']}), summed "
                f"dscale {ds_err:.3e} (atol/rtol 1e-3); device ms "
                f"({source}) {fmt(dev)}; back-to-back ms per call "
                f"{fmt(paced)}; bound {bound_ms:.6f} ms ({by}); {lib_text}")
            if N == LANES or dtype != torch.bfloat16:
                continue
            fig = dict(shape=f"x, g [{N}, {D}] bfloat16",
                       max_abs_err=err, ms=dev["kernel"],
                       ms_with_sum=dev["kernel+sum"],
                       plain_ms=dev["plain"], ms_source=source,
                       bound_ms=bound_ms, bound_by=by,
                       library_ms=dev.get("library"))
            if D == 960:                                   # the train path
                row.update(fig)
            else:
                row[SHAPE_KEYS[False, D, eps]] = fig
    return row


# the last three families' attention: zamba2's shared site (G = 1),
# whisper-tiny's encoder (non-causal over 1500 frames), decoder
# self-attention (causal, G = 1) and cross-attention (non-causal, Sq 1024
# against Sk 1500), pixtral-12b's layers (1024 patches and 1024 text
# tokens, G = 4, hd 128)
FAMILY_ATTENTION_SHAPES = (
    ((TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 32, 32, 64), (True,), 0.0,
     "train_zamba2_shape"),
    ((TRAIN_BATCH, WHISPER_FRAMES, WHISPER_FRAMES, 6, 6, 64), (False,), 0.0,
     "train_whisper_encoder_shape"),
    ((TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 6, 6, 64), (True,), 0.0,
     "train_whisper_self_shape"),
    ((TRAIN_BATCH, TRAIN_SEQ, WHISPER_FRAMES, 6, 6, 64), (False,), 0.0,
     "train_whisper_cross_shape"),
    ((PIXTRAL_BATCH, 2 * TRAIN_SEQ, 2 * TRAIN_SEQ, 32, 8, 128), (True,), 0.0,
     "train_pixtral_shape"))
# (B, Sq, Sk, H, KVH, hd), the causal flags (a row records the first),
# the cap, the row key ("": checked, not recorded)
ATTENTION_SHAPES = (
    ((TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 15, 5, 64), (True, False), 0.0,
     None),                                                   # the train path
    ((2, 1000, 1000, 6, 3, 64), (True, False), 0.0, ""),      # ragged
    # qwen2.5-3b's train path (G = 8, hd 128), causal only
    ((TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 16, 2, 128), (True,), 0.0,
     "train_qwen2_5_3b_shape"),
    # granite-moe's train path (G = 3, hd 64)
    ((TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 24, 8, 64), (True,), 0.0,
     "train_granite_shape"),
    # grok-1's heads (G = 6, hd 128) with its logit cap
    ((2, TRAIN_SEQ, TRAIN_SEQ, 48, 8, 128), (True,), LOGIT_CAP,
     "train_grok_shape"),
    *FAMILY_ATTENTION_SHAPES)
# qwen2-0.5b prefill_32k's attention (phase 15): the plain version's f32
# scores [1, 2, 7, 32768, 32768] (60 GB) do not fit, so the kernel is held
# on its last ATTENTION_TAIL query rows, which under the bottom-right
# causal mask are the plain version on q[:, -ATTENTION_TAIL:] against
# every key, and "plain" is timed on that slice
PREFILL_ATTENTION_SHAPES = (
    ((1, 32768, 32768, 14, 2, 64), (True,), 0.0, "prefill_32k_shape"),)
ATTENTION_SHAPES = ATTENTION_SHAPES + PREFILL_ATTENTION_SHAPES
ATTENTION_TAIL = 1024


def kernel_flash_attention(gen, shapes=ATTENTION_SHAPES) -> dict:
    """flash_attention against its plain version at the train paths'
    heads (smollm-360m, qwen2.5-3b, granite-moe), a ragged shape, and
    with grok-1's logit cap at grok's heads (q and k scaled by
    ``CAP_Q_SCALE`` ** 0.5 so that scores reach the cap; no library
    figure, and cap 0 must give the uncapped kernel's bits)."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain,
                                                     flash_attention_work)
    row = dict(name="flash_attention", route="cuda",
               source="src/repro_torch/csrc/flash_attention.cu",
               replaces="src/repro/kernels/flash_attention.py:96")
    for (B, Sq, Sk, H, KVH, hd), causals, cap, key in shapes:
        for causal in causals:
            for dtype in (torch.bfloat16, torch.float32):
                amp = CAP_Q_SCALE ** 0.5 if cap else 1.0
                q = (amp * torch.randn(B, Sq, H, hd, generator=gen,
                                       device="cuda")).to(dtype)
                k = (amp * torch.randn(B, Sk, KVH, hd, generator=gen,
                                       device="cuda")).to(dtype)
                v = torch.randn(B, Sk, KVH, hd, generator=gen,
                                device="cuda").to(dtype)
                got = flash_attention(q, k, v, causal=causal, logit_cap=cap)
                torch.cuda.synchronize()
                # more than 8 GB of plain f32 scores: the last rows only
                tail = ATTENTION_TAIL if B * H * Sq * Sk * 4 > 8 * 2**30 \
                    else 0
                want = flash_attention_plain(
                    q[:, -tail:] if tail else q, k, v, causal=causal,
                    logit_cap=cap)
                # the assigned shape's rows average over ~32768 keys
                tol = scaled_tol(want, dtype) if Sk >= 32768 \
                    else TOLS[dtype]
                err = check_close(
                    "flash_attention", got[:, -tail:] if tail else got,
                    want, dtype, tol)
                reject_text = ""
                if Sk >= 32768:
                    # what a key loop that dropped the later half of its
                    # tiles gives (bottom-right mask: the same rows)
                    half = flash_attention_plain(
                        q[:, -tail:] if tail else q, k[:, :Sk // 2],
                        v[:, :Sk // 2], causal=causal, logit_cap=cap)
                    reject_text = "; " + rejects(
                        "flash_attention", want, tol,
                        {"zeros": torch.zeros_like(want),
                         f"the output over the first {Sk // 2} keys": half})
                    del half
                del want
                if tail and dtype == torch.float32:
                    # no row of the JSON: held, not timed
                    log(f"kernel flash_attention B={B} Sq={Sq} Sk={Sk} H={H} "
                        f"KVH={KVH} hd={hd} causal={causal} float32 (held on "
                        f"the last {tail} query rows): max abs err "
                        f"{err:.3e} ({tol_text(tol)}); not timed"
                        f"{reject_text}")
                    continue
                cap_text = ""
                if cap:
                    bits = torch.equal(
                        flash_attention(q, k, v, causal=causal,
                                        logit_cap=0.0),
                        flash_attention(q, k, v, causal=causal))
                    moved = float((got.float() - flash_attention_plain(
                        q, k, v, causal=causal).float()).abs().max())
                    if not bits:
                        raise AssertionError("flash_attention with cap 0 is "
                                             "not the uncapped kernel's bits")
                    cap_text = (f"; logit cap {cap:g}: the cap moves the "
                                f"output by up to {moved:.3e}, cap 0 gives "
                                f"the uncapped kernel's bits")
                # the (query, key) pairs the mask leaves: what this run
                # computes
                flops, nbytes = flash_attention_work(B, Sq, Sk, H, KVH, hd,
                                                     causal, dtype)
                args = [(q, k.clone(), v.clone())
                        for _ in range(copies_for(nbytes))]

                def sdpa(q_, k_, v_):
                    return F.scaled_dot_product_attention(
                        q_.transpose(1, 2), k_.transpose(1, 2),
                        v_.transpose(1, 2), is_causal=causal,
                        enable_gqa=True).transpose(1, 2)

                fns = {"kernel": lambda a, b, c: flash_attention(
                           a, b, c, causal=causal, logit_cap=cap),
                       "plain": lambda a, b, c: flash_attention_plain(
                           a[:, -tail:] if tail else a, b, c, causal=causal,
                           logit_cap=cap)}
                if not cap:
                    fns["sdpa"] = sdpa
                dev, paced, source = measure(fns, args,
                                             dev_iters=5 if tail else 20,
                                             paced_iters=10 if tail else 50)
                bound_ms, by = bound((flops, nbytes), dtype)
                n_q = -(-Sq // 64)
                grid = (f"{n_q * H * B} CTAs ({n_q} query tiles of 64 x {H} "
                        f"heads x {B} sequences)")
                log(f"kernel flash_attention B={B} Sq={Sq} Sk={Sk} H={H} "
                    f"KVH={KVH} hd={hd} causal={causal} logit_cap={cap:g} "
                    f"{str(dtype)[6:]}"
                    + (f" (held and plain timed on the last {tail} query "
                       f"rows)" if tail else "") + ": "
                    f"max abs err {err:.3e} ({tol_text(tol)}); grid {grid}; "
                    f"device ms ({source}) "
                    f"{fmt(dev)}; "
                    f"back-to-back ms per call {fmt(paced)}; bound "
                    f"{bound_ms:.6f} ms ({by}: {flops / 1e9:.2f} GFLOP, "
                    f"{nbytes / 1e6:.1f} MB); kernel "
                    f"{flops / dev['kernel'] / 1e9:.1f} TFLOP/s{cap_text}"
                    f"{reject_text}")
                if key == "" or causal != causals[0] \
                        or dtype != torch.bfloat16:
                    continue
                fig = dict(shape=f"q [{B}, {Sq}, {H}, {hd}], k/v [{B}, "
                                 f"{Sk}, {KVH}, {hd}] "
                                 f"{'causal' if causal else 'non-causal'} "
                                 f"bfloat16"
                                 + (f", logit_cap {cap:g}" if cap else ""),
                           grid=grid,
                           max_abs_err=err, ms=dev["kernel"],
                           plain_ms=dev["plain"], ms_source=source,
                           bound_ms=bound_ms, bound_by=by,
                           library_ms=dev.get("sdpa"))
                if tail:
                    fig["plain_of"] = (f"the last {tail} query rows against "
                                       f"every key")
                if key is None:                         # the train path
                    row.update(fig)
                else:
                    row[key] = fig
    return row


SSD_TRAIN_SHAPE = (TRAIN_BATCH * TRAIN_SEQ // 256, 256, 64, 64, 128)
# zamba2-1.2b's train shape: mamba2's but d_state 64
SSD_ZAMBA2_SHAPE = SSD_TRAIN_SHAPE[:4] + (64,)
SSD_SHAPES = (SSD_TRAIN_SHAPE, (1, 64, 8, 32, 32), (2, 128, 16, 64, 64),
              (1, 256, 8, 64, 128), (2, 1000, 8, 64, 128), SSD_ZAMBA2_SHAPE)


def kernel_ssd_chunk(gen, shapes=SSD_SHAPES) -> dict:
    """ssd_chunk against its plain version at the mamba2 train path's
    shape (x [B*nc, Q, nh, hp] = [32, 256, 64, 64], ds 128), the three
    shapes of tests/test_kernels.py:136-139 and a ragged one-chunk
    sequence (Q = 1000), and zamba2-1.2b's train shape (ds 64), each with
    dt in f32 (as the model feeds it) and in x's dtype (as
    tests/test_kernels.py feeds it)."""
    from repro_torch.kernels.ssd_scan import (ssd_chunk, ssd_chunk_plain,
                                              ssd_chunk_work, ssd_grid,
                                              ssd_head_block)
    row = dict(name="ssd_chunk", route="cuda",
               source="src/repro_torch/csrc/ssd_chunk.cu",
               replaces="src/repro/kernels/ssd_scan.py:79")
    for shape in shapes:
        Bc, Q, nh, hp, ds = shape
        for dtype, dt_dtype in ((torch.bfloat16, torch.float32),
                                (torch.bfloat16, torch.bfloat16),
                                (torch.float32, torch.float32)):
            x = torch.randn(Bc, Q, nh, hp, generator=gen, device="cuda")
            b = torch.randn(Bc, Q, ds, generator=gen, device="cuda")
            c = torch.randn(Bc, Q, ds, generator=gen, device="cuda")
            dt = F.softplus(torch.randn(Bc, Q, nh, generator=gen,
                                        device="cuda")) * 0.1
            a_log = torch.rand(nh, generator=gen, device="cuda") * 2.0
            args = (x.to(dtype), b.to(dtype), c.to(dtype), dt.to(dt_dtype),
                    a_log)
            got = ssd_chunk(*args)
            torch.cuda.synchronize()
            want = ssd_chunk_plain(*args)
            tol = SSD_TOLS[dtype]
            err = check_close("ssd_chunk y", got[0], want[0], dtype)
            st_err = check_close("ssd_chunk states", got[1], want[1], dtype,
                                 dict(atol=tol["states"], rtol=tol["states"]))
            dec_err = check_close("ssd_chunk decay", got[2], want[2], dtype,
                                  dict(atol=tol["decay"], rtol=tol["decay"]))
            label = (f"kernel ssd_chunk B={Bc} Q={Q} nh={nh} hp={hp} ds={ds} "
                     f"{str(dtype)[6:]} dt {str(dt_dtype)[6:]}: max abs err "
                     f"y {err:.3e} (atol/rtol {TOLS[dtype]['atol']}), states "
                     f"{st_err:.3e} ({tol['states']}), decay {dec_err:.3e} "
                     f"({tol['decay']})")
            timed = (shape in (SSD_TRAIN_SHAPE, SSD_ZAMBA2_SHAPE)
                     and dt_dtype == torch.float32) or \
                (Q == 1000 and dtype == torch.bfloat16
                 and dt_dtype == torch.float32)
            if not timed:
                log(label)
                continue
            flops, nbytes = ssd_chunk_work(Bc, Q, nh, hp, ds, dtype, dt_dtype)
            copies = [tuple(t.clone() for t in args)
                      for _ in range(copies_for(nbytes))]
            fns = {"kernel": ssd_chunk, "plain": ssd_chunk_plain}
            dev, paced, source = measure(fns, copies, dev_iters=10,
                                         paced_iters=20)
            bound_ms, by = bound((flops, nbytes), dtype)
            # the device time of each of the call's two launches
            calls = 10
            by_name, _ = profile_kernels(lambda: [
                ssd_chunk(*copies[i % len(copies)]) for i in range(calls)])
            split = {k.split("::")[-1]: v / calls / 1e3
                     for k, v in by_name.items() if "repro_torch::" in k}
            if dtype == torch.bfloat16:
                hb = ssd_head_block(Bc, Q, nh)
                n_y, n_state = ssd_grid(Bc, Q, nh, hp, ds)
                grid = (f"{n_y + n_state} CTAs ({n_y} y: {-(-Q // 64)} query "
                        f"tiles of 64 x {-(-nh // hb)} blocks of {hb} heads x "
                        f"{Bc} chunks; {n_state} state) + prefix sums "
                        f"{-(-nh // 4) * Bc} CTAs")
            else:
                grid = (f"{(-(-Q // 64) + 1) * nh * Bc} CTAs + prefix sums "
                        f"{-(-nh // 4) * Bc} CTAs")
            log(f"{label}; grid {grid}; device ms ({source}) {fmt(dev)}; "
                f"launches: " + (", ".join(f"{k} {v:.4f}" for k, v in
                                           split.items()) or "not measured")
                + f"; back-to-back ms "
                f"per call {fmt(paced)}; bound {bound_ms:.6f} ms ({by}: "
                f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); no single "
                f"PyTorch call computes it")
            if shape in (SSD_TRAIN_SHAPE, SSD_ZAMBA2_SHAPE) \
                    and dtype == torch.bfloat16:
                fig = dict(shape=f"x [{Bc}, {Q}, {nh}, {hp}] bfloat16, b/c "
                                 f"[{Bc}, {Q}, {ds}], dt float32",
                           grid=grid, launch_split_ms=split,
                           max_abs_err=err, ms=dev["kernel"],
                           plain_ms=dev["plain"], ms_source=source,
                           bound_ms=bound_ms, bound_by=by, library_ms=None)
                if shape == SSD_TRAIN_SHAPE:
                    row.update(fig)
                else:
                    row["train_zamba2_shape"] = fig
    return row


# ---------------------------------------------------------------------------
# phase 3: the serve path
# ---------------------------------------------------------------------------

# per arch: (requests, min prompt, max prompt, new tokens, max_seq) and the
# full width its config must have
SERVE_RUNS = {ARCH: (REQUESTS, MIN_PROMPT, SERVE_MAX_PROMPT, MAX_NEW,
                     MAX_SEQ),
              QWEN3B: (REQUESTS, MIN_PROMPT, SERVE_MAX_PROMPT, MAX_NEW,
                       MAX_SEQ),
              MAMBA: (M_REQUESTS, M_MIN_PROMPT, M_MAX_PROMPT, M_MAX_NEW,
                      M_MAX_SEQ),
              GRANITE: (M_REQUESTS, M_MIN_PROMPT, M_MAX_PROMPT, M_MAX_NEW,
                        MAX_SEQ),
              GROK: (M_REQUESTS, M_MIN_PROMPT, M_MAX_PROMPT, M_MAX_NEW,
                     MAX_SEQ),
              ZAMBA: (M_REQUESTS, M_MIN_PROMPT, M_MAX_PROMPT, M_MAX_NEW,
                      MAX_SEQ)}


def full_width(cfg) -> tuple:
    if cfg.family == "ssm":
        return (cfg.num_layers, cfg.d_model, cfg.ssm.d_state,
                cfg.ssm.head_dim, cfg.ssm.expand, cfg.ssm.chunk_size,
                cfg.vocab_size, cfg.tie_embeddings)
    if cfg.family == "hybrid":
        return (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                cfg.resolved_head_dim(), cfg.d_ff, cfg.vocab_size,
                cfg.tie_embeddings, cfg.ssm.d_state, cfg.ssm.head_dim,
                cfg.ssm.expand, cfg.ssm.chunk_size, cfg.shared_attn_every,
                cfg.shared_attn_lora_rank)
    if cfg.family == "audio":
        return (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                cfg.resolved_head_dim(), cfg.d_ff, cfg.vocab_size,
                cfg.tie_embeddings, cfg.num_encoder_layers,
                cfg.encoder_frames)
    moe = () if cfg.moe is None else (cfg.moe.num_experts, cfg.moe.top_k,
                                      cfg.moe.expert_d_ff,
                                      cfg.moe.group_size)
    return (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim(), cfg.d_ff, cfg.vocab_size,
            cfg.tie_embeddings, cfg.logit_softcap) + moe


FULL_WIDTH = {ARCH: (24, 896, 14, 2, 64, 4864, 151936, True, 0.0),
              QWEN3B: (36, 2048, 16, 2, 128, 11008, 151936, True, 0.0),
              TRAIN_ARCH: (32, 960, 15, 5, 64, 2560, 49152, True, 0.0),
              MAMBA: (48, 2048, 128, 64, 2, 256, 50280, True),
              GRANITE: (32, GRANITE_D, 24, 8, 64, 512, 49155, True, 0.0,
                        40, 8, 512, 512),
              GROK: (64, GROK_D, 48, 8, 128, 32768, 131072, False, LOGIT_CAP,
                     8, 2, 32768, 1024),
              ZAMBA: (38, ZAMBA_D, 32, 32, 64, 8192, 32000, True, 64, 64, 2,
                      256, 6, 128),
              WHISPER: (4, WHISPER_D, 6, 6, 64, 1536, 51865, True, 4,
                        WHISPER_FRAMES),
              PIXTRAL: (40, PIXTRAL_D, 32, 8, 128, 14336, 131072, False,
                        0.0)}


def serve(workers: int, arch: str = ARCH, extra: tuple = (),
          requests: int | None = None, **cfg_overrides):
    """One full-width run of the serve launcher; ``extra`` are more of its
    flags (phase 11's sharding flags), ``requests`` cuts the requests of
    ``SERVE_RUNS``, ``cfg_overrides`` set config fields the launcher has
    no flags for (``kv_cache_dtype``).  Returns the launches, the closed
    engine and the launcher's report.  With ``--rank-devices`` among the
    flags each rank's pass launches its kernels on its own card."""
    from repro_torch.collectives.rank_shards import RankShards
    from repro_torch.kernels import _lib
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import transformer
    from repro_torch.models.layers import tree_leaves
    n_req, min_prompt, max_prompt, max_new, max_seq = SERVE_RUNS[arch]
    requests = requests or n_req
    argv = ["--arch", arch, "--scale", "full", "--device", "cuda",
            "--slots", str(LANES), "--max-seq", str(max_seq),
            "--kv-block-size", str(BLOCK), "--requests", str(requests),
            "--min-prompt", str(min_prompt), "--max-prompt", str(max_prompt),
            "--max-new", str(max_new), "--progress-workers", str(workers),
            *extra]
    args = serve_mod.build_parser().parse_args(argv)
    # a device per model rank (phase 16): every rank runs its own pass
    cards = distinct(args.rank_devices.split(",")) if args.rank_devices \
        else [torch.device("cuda", 0)]
    ranks = len(args.rank_devices.split(",")) if args.rank_devices else 1
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    _lib.reset_launches()
    report = serve_mod.run(args, **cfg_overrides)
    launches = dict(_lib.launches)
    peaks = [torch.cuda.max_memory_allocated(d) for d in cards]
    srv, cfg = report.server, report.server.cfg
    log(f"serve {arch} [{workers} progress workers{' '.join(('',) + extra)}] "
        + "\n  ".join(report.format()))
    calls = report.steps + report.prefill_calls
    NL = cfg.num_layers
    # under no_grad the training kernels must not launch at all; the ssm
    # family has one block norm a layer and no attention; the hybrid one
    # besides two norms and one attention at each of its sites
    want = dict.fromkeys(launches, 0)
    if cfg.family == "ssm":
        want["rmsnorm_fwd"] = calls * (NL + 1) * ranks
    elif cfg.family == "hybrid":
        sites = NL // cfg.shared_attn_every
        want.update(rmsnorm_fwd=calls * (NL + 2 * sites + 1) * ranks,
                    flash_decode=calls * sites * ranks)
    else:
        want.update(rmsnorm_fwd=calls * (2 * NL + 1) * ranks,
                    flash_decode=calls * NL * ranks)
    log(f"serve launches {launches}, expected {want} for {calls} fused calls "
        f"({want['rmsnorm_fwd'] // max(calls, 1)} rmsnorm_fwd a call"
        + (f", {ranks} ranks' passes" if ranks > 1 else "") + ")")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    short = [r.request_id for r in report.requests
             if len(r.out_tokens) != max_new or r.done_req.failed]
    if short:
        raise AssertionError(f"requests without {max_new} tokens: {short}")
    off = [p for p, t in [*tree_leaves(srv.params),
                          *tree_leaves(srv.slots.cache)]
           if any(x.device.type != "cuda" for x in
                  (t.shards if isinstance(t, RankShards) else (t,)))]
    if off:
        raise AssertionError(f"tensors off the card: {off}")
    depth = cfg_overrides.get("num_layers", FULL_WIDTH[arch][0])
    if full_width(cfg) != (depth,) + FULL_WIDTH[arch][1:]:
        raise AssertionError(f"not the full {arch} width: {cfg}")
    lat = report.latency
    pool = sum(t.numel() * t.element_size()
               for _, t in tree_leaves(srv.slots.cache))
    pool_text = f"pool {pool / 2**20:.1f} MiB"
    if cfg.kv_cache_dtype == "int8":
        spec = transformer.paged_cache_spec(
            cfg.with_overrides(kv_cache_dtype="bf16"), LANES,
            srv.slots.num_blocks, BLOCK)
        bf16 = sum(math.prod(v.shape) * 2 for v in spec.values())
        pool_text = (f"int8 K/V pool {pool / 2**20:.1f} MiB (values and "
                     f"scales) against {bf16 / 2**20:.1f} MiB in bf16, "
                     f"{pool / bf16:.4f} of it")
    log(f"serve summary {arch} [{workers} workers{' '.join(('',) + extra)}]: "
        f"{NL} of {FULL_WIDTH[arch][0]} layers"
        + (f", logit cap {cfg.logit_softcap:g} in every flash_decode launch"
           if cfg.logit_softcap else "") + "; decode steps "
        f"{report.steps}, prefill calls {report.prefill_calls}, "
        f"{report.tokens / report.wall_s:.2f} tokens/s, mean decode step "
        f"{srv.mean_step_ms():.3f} ms, wall {report.wall_s:.3f} s, TTFT p50 "
        f"{lat.ttft_ms_p50:.1f} ms p99 {lat.ttft_ms_p99:.1f} ms; {pool_text}; "
        f"peak device memory "
        + ", ".join(f"{d} {p / 2**30:.2f} GiB" if len(cards) > 1
                    else f"{p / 2**30:.2f} GiB" for d, p in zip(cards, peaks)))
    return launches, srv, report


def time_breakdown(srv, calls: int = 10) -> None:
    """Where a fused decode call's time goes: host wall clock against the
    device time the profiler records, on the served engine's weights and
    pool, with the 8 lanes at prompt-like positions.  The wall clock comes
    from a pass without the profiler, whose own host cost would count as
    idle card time; the device time from a second, profiled pass."""
    from repro_torch.models import registry
    cfg = srv.cfg
    rs = np.random.RandomState(3)
    dev = srv.device
    toks = torch.from_numpy(rs.randint(0, cfg.vocab_size, (LANES, 1))
                            .astype(np.int32)).to(dev)
    pos = torch.from_numpy(rs.randint(MIN_PROMPT, MAX_PROMPT + MAX_NEW, LANES)
                           .astype(np.int32)).to(dev)
    nb = srv.slots.max_blocks
    tables = (1 + torch.arange(LANES * nb, dtype=torch.int32,
                               device=dev)).reshape(LANES, nb)

    def step():
        registry.decode_step_paged(srv.params, cfg, srv.slots.cache, toks,
                                   pos, tables)

    def wall_ms() -> float:
        t0 = time.perf_counter()
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / calls

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    wall = wall_ms()
    by_name, wall_profiled = profile_kernels(wall_ms)
    log(f"time: fused decode call ({cfg.name}, {LANES} lanes, "
        f"{cfg.num_layers} layers): wall {wall:.3f} ms ({wall_profiled:.3f} "
        f"ms under the profiler), " + busy_text(by_name, calls, wall, "call", 6))


# ---------------------------------------------------------------------------
# phase 4: the train path
# ---------------------------------------------------------------------------

def train(workers: int, arch: str = TRAIN_ARCH, layers: int | None = None,
          mesh: str = "", over: dict | None = None,
          steps: int = TRAIN_STEPS):
    """One full-width run of the train launcher (at ``layers`` of the
    config's depth, if given; ``over`` other config fields, ``mesh`` the
    launcher's ``--mesh``, natively).  It ends with an async checkpoint
    of the last step (the Trainer's rule), which must restore to the same
    tensors."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.serve import make_config
    from repro_torch.models import registry
    from repro_torch.models.layers import tree_leaves
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")  # no resume
    try:
        args = train_mod.build_parser().parse_args([
            "--arch", arch, "--scale", "full", "--device", "cuda",
            "--global-batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--steps", str(steps), "--ckpt-dir", ckpt_dir]
            + (["--mesh", mesh] if mesh else []))
        model = train_mod.mesh_shape(args)[1]
        over = dict(over or {}, **({} if layers is None else
                                   {"num_layers": layers}))
        config = make_config(arch, "full").with_overrides(**over) \
            if over else None
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launches()
        report = train_mod.run(args, config=config, log_every=1,
                               progress_workers=workers)
        launches = dict(_lib.launches)
        cfg, tr = report.cfg, report.trainer
        depth = layers or FULL_WIDTH[arch][0]
        if full_width(cfg) != (depth,) + FULL_WIDTH[arch][1:] or (
                cfg.rms_norm_eps, cfg.dtype, cfg.param_dtype,
                cfg.remat_policy, cfg.loss_impl) != (
                get_config(arch).rms_norm_eps, "bfloat16", "float32", "full",
                "plain"):
            raise AssertionError(f"not the full {arch} width: {cfg}")
        per_step = train_mod.kernel_launches_per_step(cfg, model=model,
                                                      seq=TRAIN_SEQ)
        want = {k: v * steps for k, v in per_step.items()}
        log(f"train {arch} launches {launches}, expected {want} ({per_step} "
            f"per step x {steps} steps)")
        if launches != want:
            raise AssertionError(f"launch counts {launches} != {want}")
        losses = [m["loss"] for m in report.log]
        if len(losses) != steps or not all(map(math.isfinite, losses)):
            raise AssertionError(f"bad loss trajectory {losses}")
        aux_text = ""
        if cfg.moe is not None:
            # the Switch aux loss of every logged step, summed over layers
            auxes = [m["aux"] for m in report.log]
            if not all(math.isfinite(a) and a > 0 for a in auxes):
                raise AssertionError(f"bad aux losses {auxes}")
            aux_text = (f"; aux losses {[round(a, 7) for a in auxes]} (of "
                        f"the losses; {cfg.num_layers} layers x "
                        f"{cfg.moe.aux_loss_weight:g} x a balance near 1)")
        off = [p for p, t in [*tree_leaves(tr.params),
                              *tree_leaves(tr.opt_state.mu),
                              *tree_leaves(tr.opt_state.nu)]
               if t.device.type != "cuda"]
        if off or tr.opt_state.step.device.type != "cuda":
            raise AssertionError(f"tensors off the card: {off}")
        peak = torch.cuda.max_memory_allocated()
        total = torch.cuda.get_device_properties(0).total_memory
        if peak > 0.9 * total:
            raise AssertionError(f"peak device memory {peak / 2**30:.2f} GiB "
                                 f"is within 10% of the card's "
                                 f"{total / 2**30:.2f} GiB")
        # a state the card cannot hold twice restores one leaf at a time
        # (granite-moe: 3.30 B parameters, 40 GB of f32 state)
        state_bytes = sum(t.numel() * t.element_size() for _, t in
                          [*tree_leaves(tr.params),
                           *tree_leaves(tr.opt_state.mu),
                           *tree_leaves(tr.opt_state.nu)])
        ckpt_text = checkpoint_check(tr, steps - 1,
                                     leafwise=state_bytes > total / 4)
        steps_s = [m["step_time_s"] for m in report.log[1:]]
        mean_s = sum(steps_s) / len(steps_s)
        tokens = TRAIN_BATCH * TRAIN_SEQ
        flops = registry.model_flops(cfg, tokens, training=True,
                                     seq_len=TRAIN_SEQ)
        mesh_text = f", mesh {mesh}, attention {cfg.attention_impl}" \
            if mesh else ""
        log(f"train {arch} [{workers} progress workers{mesh_text}]: "
            f"{cfg.num_layers} of {FULL_WIDTH[arch][0]} layers; losses "
            f"{[round(x, 6) for x in losses]}; mean step {mean_s * 1e3:.3f} "
            f"ms (steps 1-{steps - 1}; step 0 "
            f"{report.log[0]['step_time_s'] * 1e3:.3f} ms), "
            f"{tokens / mean_s:.1f} tokens/s, model {flops / mean_s / 1e12:.2f} "
            f"TFLOP/s ({flops / 1e12:.2f} TFLOP a step by registry.model_flops); "
            f"{ckpt_text}; peak device memory {peak / 2**30:.2f} GiB; wall "
            f"{report.wall_s:.3f} s{aux_text}")
        return launches, report
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def checkpoint_check(tr, last: int, leafwise: bool = False) -> str:
    """The Trainer's final async checkpoint must be step ``last`` and
    restore to the same tensors (a parameter tree, or FSDP's list of
    shard stacks); returns the line that says so.  ``leafwise`` restores
    one leaf at a time, for a state the card cannot hold a second copy
    of."""
    from repro_torch.collectives.overlap import tree_flatten
    latest = tr.ckpt.latest_step()
    if latest != last:
        raise AssertionError(f"last committed checkpoint {latest}")
    state = {"params": tr.params, "opt_state": tr.opt_state}
    if leafwise:
        return checkpoint_check_leafwise(tr, latest, state)
    t0 = time.perf_counter()
    back = tr.ckpt.restore(latest, state, device="cuda")
    restore_s = time.perf_counter() - t0
    diff = [i for i, (a, b) in enumerate(zip(tree_flatten(back["params"])[0],
                                             tree_flatten(tr.params)[0]))
            if not same(a, b)]
    for name in ("mu", "nu"):
        diff += [(name, i) for i, (a, b) in enumerate(zip(
            tree_flatten(getattr(back["opt_state"], name))[0],
            tree_flatten(getattr(tr.opt_state, name))[0]))
            if not same(a, b)]
    if diff or not same(back["opt_state"].step, tr.opt_state.step):
        raise AssertionError(f"checkpoint restores other values: {diff}")
    return (f"checkpoint of step {latest} committed "
            f"{tr.ckpt.last_save_s:.3f} s after save_async and restored "
            f"equal in {restore_s:.3f} s")


def same(a, b) -> bool:
    """Two tensors, or two ``RankShards`` on the same devices, equal bit
    for bit."""
    from repro_torch.collectives.rank_shards import RankShards
    if isinstance(a, RankShards):
        return (isinstance(b, RankShards) and a.devices == b.devices
                and a.replica == b.replica
                and all(torch.equal(x, y) for x, y in zip(a, b)))
    return torch.equal(a, b)


def checkpoint_check_leafwise(tr, latest: int, state) -> str:
    """``tr.ckpt.restore`` of a one-leaf tree at each leaf's path (the
    checkpoint names leaves by path) onto the card, one leaf at a time,
    each against the trained leaf."""
    from repro_torch.train.checkpoint import _flat_with_paths
    diff, nbytes, t_restore = [], 0, 0.0
    for name, leaf in _flat_with_paths(state):
        parts = name.split("/")
        like = leaf
        for part in reversed(parts):
            like = {part: like}
        t0 = time.perf_counter()
        back = tr.ckpt.restore(latest, like, device="cuda")
        torch.cuda.synchronize()
        t_restore += time.perf_counter() - t0
        for part in parts:
            back = back[part]
        nbytes += back.numel() * back.element_size()
        if not torch.equal(back, leaf.detach()):
            diff.append(name)
        del back
    if diff:
        raise AssertionError(f"checkpoint restores other values: {diff}")
    return (f"checkpoint of step {latest} ({nbytes / 1e9:.2f} GB) committed "
            f"{tr.ckpt.last_save_s:.3f} s after save_async and restored "
            f"equal, one leaf at a time, in {t_restore:.3f} s")


def train_time_breakdown(report, steps: int = 3, mesh=None) -> None:
    """Where a train step's time goes: host wall clock of unprofiled
    steps against the device time the profiler records over as many
    profiled steps, on the trained weights and one fixed batch (under
    ``mesh``, a ``Mesh``, if given: the launcher's native step enters
    it)."""
    from repro_torch import sharding
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train as train_mod
    from repro_torch.train import optimizer as opt_mod
    tr, cfg = report.trainer, report.cfg
    plain_step = train_mod.make_train_step(cfg, opt_mod.AdamWConfig(
        lr=3e-3, warmup_steps=5, total_steps=10))

    def step(*a):
        with sharding.set_mesh(mesh):
            return plain_step(*a)

    batch = {k: torch.from_numpy(v.copy()).cuda() for k, v in
             SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=9)
             .sample().items()}
    if cfg.is_encoder_decoder:              # as the train launcher feeds it
        batch["encoder_embeds"] = torch.ones(
            TRAIN_BATCH, cfg.encoder_frames, cfg.d_model,
            dtype=torch.bfloat16, device="cuda")
    step_breakdown(cfg, step, {"p": tr.params, "o": tr.opt_state}, batch,
                   steps)


def step_breakdown(cfg, step, state, batch, steps: int, warm: bool = True):
    """Host wall clock of ``steps`` unprofiled train steps against the
    device time the profiler records over as many profiled steps."""
    def wall_ms() -> float:
        t0 = time.perf_counter()
        for _ in range(steps):
            state["p"], state["o"], _ = step(state["p"], state["o"], batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    if warm:
        wall_ms()
    wall = wall_ms()
    by_name, wall_profiled = profile_kernels(wall_ms)
    log(f"time: train step ({cfg.name}, {TRAIN_BATCH}x{TRAIN_SEQ} tokens, "
        f"{cfg.num_layers} layers, remat {cfg.remat_policy}, loss "
        f"{cfg.loss_impl}): wall {wall:.3f} ms ({wall_profiled:.3f} ms under "
        f"the profiler), " + busy_text(by_name, steps, wall, "step", 8))


# ---------------------------------------------------------------------------
# phase 5: full-width f32 decode, card (kernels) vs CPU (plain versions)
# ---------------------------------------------------------------------------

def reference_check(arch: str = ARCH, prep=None, **over) -> None:
    """f32 paged decode steps at ``arch``'s full width (``over``: fewer
    layers, int8 K/V) on the card and on the CPU from the same weights:
    logits within atol/rtol 1e-3 and the same greedy tokens.  With int8
    K/V the two sides' K/V differ by f32 rounding before they are
    rounded to int8, so an entry on the edge of a step lands one step
    (|x|max/127 of its row) apart; the int8 entries must be at most one
    step apart, and the logits are held to atol 5e-2 (what one step of a
    K or V entry moves a logit by here) and rtol 1e-3."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.models.layers import tree_map
    cfg = get_config(arch).with_overrides(dtype="float32", **over)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = registry.init_params(cfg, gen)
    if prep is not None:
        params = prep(params)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    B, nb = LANES, 4
    tables = (1 + torch.arange(B * nb, dtype=torch.int32)).reshape(B, nb)
    caches = {dev: registry.init_paged_cache(cfg, B, 1 + B * nb, BLOCK, dev)
              for dev in ("cuda", "cpu")}
    rs = np.random.RandomState(2)
    pos = rs.randint(0, 8, size=B).astype(np.int32)
    worst = 0.0
    atol = 5e-2 if cfg.kv_cache_dtype == "int8" else 1e-3
    for step in range(4):
        toks = torch.from_numpy(
            rs.randint(0, cfg.vocab_size, size=(B, 1)).astype(np.int32))
        p = torch.from_numpy(pos)
        got, caches["cuda"] = registry.decode_step_paged(
            params, cfg, caches["cuda"], toks.cuda(), p.cuda(), tables.cuda())
        want, caches["cpu"] = registry.decode_step_paged(
            cpu_params, cfg, caches["cpu"], toks, p, tables)
        got = got.cpu()
        if got.shape != (B, 1, cfg.vocab_size) or not torch.isfinite(got).all():
            raise AssertionError(f"bad logits {tuple(got.shape)}")
        err = (got - want).abs()
        if (err > atol + 1e-3 * want.abs()).any():
            raise AssertionError(f"card vs CPU logits differ: max abs err "
                                 f"{float(err.max()):.3e}")
        if not torch.equal(got.argmax(-1), want.argmax(-1)):
            raise AssertionError("card vs CPU greedy tokens differ")
        worst = max(worst, float(err.max()))
        pos = pos + 1 + step
    int8_text = ""
    if cfg.kv_cache_dtype == "int8":
        # the card's and the CPU's K/V differ by f32 rounding, so an entry
        # on the edge of a quantization step may land one step apart
        off = [int((caches["cuda"][k].cpu() != caches["cpu"][k]).sum())
               for k in ("k", "v")]
        steps_apart = max(int((caches["cuda"][k].cpu().int()
                               - caches["cpu"][k].int()).abs().max())
                          for k in ("k", "v"))
        int8_text = (f"; int8 K/V entries that differ card vs CPU: "
                     f"{sum(off)} of {2 * caches['cpu']['k'].numel()}, at "
                     f"most {steps_apart} quantization step apart")
        if steps_apart > 1:
            raise AssertionError("int8 K/V more than one step apart")
    log(f"check: full-width f32 decode ({arch}, {cfg.num_layers} layers, K/V "
        f"{cfg.kv_cache_dtype}), card kernels vs CPU plain versions, "
        f"4 steps x {B} lanes: max abs logit err {worst:.3e} (atol {atol:g}, "
        f"rtol 1e-3), greedy tokens equal{int8_text}")


def shares(got, want) -> list[float]:
    """Per leaf, ``max|got - want|`` over ``max|want|``."""
    return [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(got, want)]


def leaf_errors(label, names, got, want, limit, spacing=None) -> list[float]:
    """``shares(got, want)``; raises if any leaf is not finite or its error
    exceeds ``limit`` of its largest entry plus, where given,
    ``spacing[i]``: the f32 spacing of the values the compared quantities
    were taken from, below which no difference of them can be told
    apart."""
    out = shares(got, want)
    for i, (name, a, b, share) in enumerate(zip(names, got, want, out)):
        top = float(b.abs().max())
        floor = spacing[i] if spacing is not None else 0.0
        if not torch.isfinite(a).all() or not share * top <= limit * top + floor:
            raise AssertionError(
                f"{label} {'/'.join(name)}: card vs CPU max abs err "
                f"{share * top:.3e}, {share:.3e} of the leaf's largest entry "
                f"(limit {limit:g}" + (f" plus {floor:.3e}" if floor else "")
                + ")")
    return out


def train_reference_check(arch: str = TRAIN_ARCH, seq: int = 128, over=None,
                          extra=None, prep=None, zero=()) -> None:
    """One f32 train step of a two-layer ``arch`` at full width (B=2,
    S=``seq``; ``over`` other config fields, ``extra(rs, cfg)`` more numpy
    inputs of the batch, ``prep(params)`` the weights made otherwise) on
    the card (kernels) and on the CPU (plain versions), from the same
    weights and batch.  Leaves whose last key is in ``zero`` have a
    gradient of zero in exact arithmetic (a key bias: softmax does not
    move when one constant is added to every score of a query), so each
    side's is only the rounding of its sums: they are held to
    max|g| <= 1e-6 of the step's largest gradient entry on both sides,
    not to each other.  Both sides are f32 with TF32 off: only the
    order of the sums differs (cuBLAS and the kernels' tiles against the
    CPU's).  Each stage is held to its own inputs, with a limit scaled to
    each leaf, since a typical gradient entry (~1e-3) is smaller than any
    fixed absolute limit worth having:

    - loss: |a - b| <= 1e-5 |b|;
    - gradients: max|a - b| <= 1e-4 max|b| per leaf;
    - AdamW update (new - old): the card's optimizer and the CPU's, each
      applied to the card's gradients, max|a - b| <= 1e-4 max|b| per
      leaf plus one f32 spacing of the leaf's largest updated parameter:
      new - old cannot resolve less, and for a norm scale near 1 after a
      step of ~6e-4 one rounding of new to the neighbouring f32 (1.2e-7)
      is already 1.8e-4 of the step.
      The two end-to-end steps' updates are not compared entry by entry:
      the first step's mhat / sqrt(vhat) is g / (|g| + eps), which sends a
      gradient entry within summation noise of 0 to either sign of a full
      step.

    Beside the three worst gradient leaves it prints their noise: how far
    the card's own gradients move when every weight moves to a
    neighbouring f32 in a random direction.  A leaf whose card-vs-CPU
    error is of that size differs by the f32 rounding of its sums, not
    by a fault of either side."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.models.layers import (tree_from_leaves, tree_leaves,
                                           tree_map)
    from repro_torch.train import optimizer as opt_mod
    cfg = get_config(arch).with_overrides(
        **{"num_layers": 2, "dtype": "float32", **(over or {})})
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = {"cuda": registry.init_params(cfg, gen)}
    if prep is not None:
        params["cuda"] = prep(params["cuda"])
    params["cpu"] = tree_map(lambda t: t.cpu(), params["cuda"])
    names = [p for p, _ in tree_leaves(params["cpu"])]
    rs = np.random.RandomState(4)
    toks = rs.randint(0, cfg.vocab_size, size=(2, seq + 1)).astype(np.int32)
    more = extra(rs, cfg) if extra is not None else {}
    loss, grads, batch = {}, {}, {}
    for dev in ("cuda", "cpu"):
        batch[dev] = {"tokens": torch.from_numpy(toks[:, :-1]).to(dev),
                      "labels": torch.from_numpy(toks[:, 1:]).to(dev),
                      **{k: torch.from_numpy(v).to(dev)
                         for k, v in more.items()}}
        leaves = [t.requires_grad_() for _, t in tree_leaves(params[dev])]
        out, _ = registry.loss_fn(params[dev], cfg, batch[dev])
        grads[dev] = torch.autograd.grad(out, leaves)
        loss[dev] = float(out.detach())
    ngen = torch.Generator(device="cuda").manual_seed(7)
    nudged = [torch.nextafter(t.detach(), torch.where(
        torch.rand(t.shape, generator=ngen, device="cuda") < 0.5,
        -math.inf, math.inf)).requires_grad_()
        for _, t in tree_leaves(params["cuda"])]
    out, _ = registry.loss_fn(tree_from_leaves(zip(names, nudged)), cfg,
                              batch["cuda"])
    noise = shares(torch.autograd.grad(out, nudged), grads["cuda"])
    ocfg = opt_mod.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=10)
    update, gnorm = {}, {}
    for dev in ("cuda", "cpu"):
        old = [t.detach().clone() for _, t in tree_leaves(params[dev])]
        gtree = tree_from_leaves((path, g.to(dev)) for path, g
                                 in zip(names, grads["cuda"]))
        new, _, m = opt_mod.apply(ocfg, opt_mod.init(params[dev]),
                                  params[dev], gtree)      # in place
        update[dev] = [(t.detach() - o).cpu()
                       for (_, t), o in zip(tree_leaves(new), old)]
        if dev == "cpu":
            tops = [t.detach().abs().max() for _, t in tree_leaves(new)]
            spacing = [float(torch.nextafter(m, m + 1) - m) for m in tops]
        gnorm[dev] = float(m["grad_norm"])
    la, lb = loss["cuda"], loss["cpu"]
    if not math.isfinite(la) or not abs(la - lb) <= 1e-5 * abs(lb):
        raise AssertionError(f"card loss {la} vs CPU loss {lb}")
    held = [i for i, n in enumerate(names) if n[-1] not in zero]
    top = max(float(g.abs().max()) for g in grads["cpu"])
    zero_worst = 0.0
    for i in set(range(len(names))) - set(held):
        worst = max(float(grads["cuda"][i].abs().max()),
                    float(grads["cpu"][i].abs().max()))
        if not worst <= 1e-6 * top:
            raise AssertionError(f"gradient {'/'.join(names[i])}: zero in "
                                 f"exact arithmetic, max |g| {worst:.3e} > "
                                 f"1e-6 of {top:.3e}")
        zero_worst = max(zero_worst, worst / top)
    g_err = dict(zip(held, leaf_errors(
        "gradient", [names[i] for i in held],
        [grads["cuda"][i].cpu() for i in held],
        [grads["cpu"][i] for i in held], 1e-4)))
    u_worst = max(leaf_errors("AdamW update", names, update["cuda"],
                              update["cpu"], 1e-4, spacing))
    top3 = sorted(held, key=lambda i: -g_err[i])[:3]
    zero_text = (f"; {len(names) - len(held)} key-bias leaves (zero in exact "
                 f"arithmetic): max |g| {zero_worst:.3e} of the largest "
                 f"gradient entry (limit 1e-6)" if zero else "")
    log(f"check: full-width {cfg.num_layers}-layer {arch} f32 train step, "
        f"card kernels vs CPU plain versions (B=2, S={seq}"
        + "".join(f", {k} {list(v.shape)}" for k, v in more.items())
        + f"): loss {la:.7f} vs {lb:.7f} (rel err "
        f"{abs(la - lb) / abs(lb):.3e}, limit 1e-5); worst leaf of "
        f"{len(names)}, max abs err over the leaf's largest entry: "
        f"gradients {g_err[top3[0]]:.3e} (limit 1e-4), AdamW update from the "
        f"same gradients {u_worst:.3e} (limit 1e-4 plus one f32 spacing of "
        f"the leaf's largest parameter; grad norm {gnorm['cuda']:.6f} vs "
        f"{gnorm['cpu']:.6f}); worst gradient leaves, card vs CPU (noise: "
        f"card vs card, every weight moved by one f32 ulp): "
        + "; ".join(f"{'/'.join(names[i])} {g_err[i]:.3e} (noise "
                    f"{noise[i]:.3e})" for i in top3) + zero_text)


def mamba_decode_check(steps: int = 4) -> None:
    """Four f32 decode steps of a two-layer mamba2-1.3b at full width, 8
    lanes, on the card (kernels) and on the CPU (plain versions), from the
    same weights and tokens; lane 0 is left out of ``fed`` at step 2.  The
    logits are held as the dense decode check holds them (atol/rtol 1e-3,
    greedy tokens equal), every state leaf to max|a - b| <= 1e-4 max|b|,
    and lane 0's state must not move at step 2, bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.models.layers import tree_map
    cfg = get_config(MAMBA).with_overrides(num_layers=2, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = registry.init_params(cfg, gen)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    B = LANES
    caches = {dev: registry.init_paged_cache(cfg, B, 1, BLOCK, dev)
              for dev in ("cuda", "cpu")}
    tables = torch.zeros(B, 1, dtype=torch.int32)
    rs = np.random.RandomState(6)
    pos = np.zeros(B, np.int32)
    worst, state_worst = 0.0, 0.0
    for step in range(steps):
        toks = torch.from_numpy(
            rs.randint(0, cfg.vocab_size, size=(B, 1)).astype(np.int32))
        fed = torch.ones(B, dtype=torch.bool)
        fed[0] = step != 2
        p = torch.from_numpy(pos)
        before = caches["cuda"]["h"][:, 0].clone()
        got, caches["cuda"] = registry.decode_step_paged(
            params, cfg, caches["cuda"], toks.cuda(), p.cuda(), tables.cuda(),
            fed.cuda())
        want, caches["cpu"] = registry.decode_step_paged(
            cpu_params, cfg, caches["cpu"], toks, p, tables, fed)
        got = got.cpu()
        if got.shape != (B, 1, cfg.vocab_size) or not torch.isfinite(got).all():
            raise AssertionError(f"bad logits {tuple(got.shape)}")
        err = (got - want).abs()
        if (err > 1e-3 + 1e-3 * want.abs()).any():
            raise AssertionError(f"card vs CPU mamba logits differ: max abs "
                                 f"err {float(err.max()):.3e}")
        if not torch.equal(got.argmax(-1), want.argmax(-1)):
            raise AssertionError("card vs CPU mamba greedy tokens differ")
        if step == 2 and not torch.equal(caches["cuda"]["h"][:, 0], before):
            raise AssertionError("an unfed lane's state moved")
        worst = max(worst, float(err.max()))
        names = sorted(caches["cpu"])
        state_worst = max(state_worst, *leaf_errors(
            "mamba decode state", [(n,) for n in names],
            [caches["cuda"][n].cpu() for n in names],
            [caches["cpu"][n] for n in names], 1e-4))
        pos = pos + fed.numpy().astype(np.int32)
    log(f"check: full-width two-layer mamba2-1.3b f32 decode, card kernels "
        f"vs CPU plain versions, {steps} steps x {B} lanes (lane 0 unfed at "
        f"step 2, its state unmoved): max abs logit err {worst:.3e} "
        f"(atol/rtol 1e-3), greedy tokens equal; worst state leaf "
        f"{state_worst:.3e} of its largest entry (limit 1e-4)")


# ---------------------------------------------------------------------------
# phase 6: qwen2.5-3b at full width — decode paths, int8 weights, training,
# checkpoint policies, and the event classes on the card
# ---------------------------------------------------------------------------

def decode_paths_check(srv, steps: int = 16, kvs=("bf16", "int8")) -> None:
    """The slot path (``decode_step``, max_seq the paged view's length)
    against the paged path, on the served engine's bf16 weights, with bf16
    and int8 K/V: the same tokens at the same positions (lanes at
    staggered starts) must give the same logits.  The paged view holds
    the slot row's values, so they are expected bit for bit; the largest
    difference is printed either way, and a difference beyond the bf16
    kernel tolerance fails."""
    from repro_torch.models import registry
    nb = -(-MAX_SEQ // BLOCK)
    rs = np.random.RandomState(7)
    tables = torch.from_numpy((1 + rs.permutation(LANES * nb)).reshape(
        LANES, nb).astype(np.int32)).cuda()
    toks = rs.randint(0, srv.cfg.vocab_size, size=(steps, LANES, 1))
    start = rs.randint(0, min(64, nb * BLOCK - steps), size=LANES)
    texts = []
    for kv in kvs:
        cfg = srv.cfg.with_overrides(kv_cache_dtype=kv)
        slot = registry.init_cache(cfg, LANES, nb * BLOCK, "cuda")
        pool = registry.init_paged_cache(cfg, LANES, 1 + LANES * nb, BLOCK,
                                         "cuda")
        worst, bitwise = 0.0, True
        for i in range(steps):
            t = torch.from_numpy(toks[i].astype(np.int32)).cuda()
            p = torch.from_numpy((start + i).astype(np.int32)).cuda()
            a, slot = registry.decode_step(srv.params, cfg, slot, t, p)
            b, pool = registry.decode_step_paged(srv.params, cfg, pool, t, p,
                                                 tables)
            if a.shape != (LANES, 1, cfg.vocab_size) or \
                    not torch.isfinite(a).all():
                raise AssertionError(f"bad slot-path logits {tuple(a.shape)}")
            bitwise &= torch.equal(a, b)
            worst = max(worst, float((a - b).abs().max()))
            check_close(f"slot vs paged decode ({kv} K/V)", a, b,
                        torch.bfloat16)
        texts.append(f"{kv} K/V " + ("bit for bit equal" if bitwise else
                                     f"max abs logit diff {worst:.3e}"))
        del slot, pool
    log(f"check: {srv.cfg.name} full-width decode, slot cache vs paged pool, "
        f"{steps} steps x {LANES} lanes, bf16 weights: " + "; ".join(texts))


def int8_weights_check(srv, steps: int = 8) -> None:
    """``registry.decode_step_q`` (int8 weights from ``quantize_tree``,
    dequantized at use: the JAX package's ``serve_step_q``) against
    ``decode_step`` on the bf16 weights they were made from, the same
    tokens fed to both: the largest logit difference and the share of
    greedy tokens that agree are printed; no limit is set for them."""
    from repro_torch.models import registry
    from repro_torch.serve import quantization as qz
    cfg = srv.cfg.with_overrides(kv_cache_dtype="bf16")
    q = qz.quantize_tree(srv.params)
    bf16 = qz.quantized_bytes(srv.params)
    caches = [registry.init_cache(cfg, LANES, 64, "cuda") for _ in range(2)]
    rs = np.random.RandomState(8)
    worst, agree = 0.0, 0
    for i in range(steps):
        t = torch.from_numpy(rs.randint(0, cfg.vocab_size, (LANES, 1))
                             .astype(np.int32)).cuda()
        p = torch.full((LANES,), i, dtype=torch.int32, device="cuda")
        a, caches[0] = registry.decode_step(srv.params, cfg, caches[0], t, p)
        b, caches[1] = registry.decode_step_q(q, cfg, caches[1], t, p)
        if not torch.isfinite(b).all():
            raise AssertionError("int8-weight logits are not finite")
        worst = max(worst, float((a - b).abs().max()))
        agree += int((a.argmax(-1) == b.argmax(-1)).sum())
    log(f"check: {cfg.name} full-width decode on int8 weights "
        f"(decode_step_q) vs the bf16 weights, {steps} steps x {LANES} "
        f"lanes: max abs logit diff {worst:.3e}, greedy tokens agree "
        f"{agree}/{steps * LANES}; weights {qz.quantized_bytes(q) / 2**30:.3f}"
        f" GiB in int8 against {bf16 / 2**30:.3f} GiB in bf16")


def train_qwen3b():
    """qwen2.5-3b at full width through ``make_train_step``: the
    vocab-chunked loss, "subblock" remat, f32 master params and moments,
    bf16 compute, 4 steps of 8 x 1024 tokens.  At step 0 the chunked loss
    must equal the plain loss on the same batch (no_grad forwards; both
    round the logits to bf16, but the plain path takes one product over
    the whole vocabulary and one log-sum-exp, so |a - b| <= 1e-4 |b|).
    Not the Trainer: its checkpoint of the last step would be ~37 GB."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import _lib
    from repro_torch.launch import train as train_mod
    from repro_torch.models import registry
    from repro_torch.train import optimizer as opt_mod
    cfg = get_config(QWEN3B).with_overrides(loss_impl="chunked_vocab",
                                            remat_policy="subblock")
    if full_width(cfg) != FULL_WIDTH[QWEN3B] or (
            cfg.dtype, cfg.param_dtype, cfg.loss_vocab_chunk) != (
            "bfloat16", "float32", 8192):
        raise AssertionError(f"not the full {QWEN3B} width: {cfg}")
    torch.cuda.reset_peak_memory_stats()
    params = registry.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    opt_state = opt_mod.init(params)
    src = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=5)
    batches = [{k: torch.from_numpy(v.copy()).cuda()
                for k, v in src.sample().items()}
               for _ in range(Q3_TRAIN_STEPS)]
    with torch.no_grad():
        chunked = float(registry.loss_fn(params, cfg, batches[0])[0])
        plain = float(registry.loss_fn(
            params, cfg.with_overrides(loss_impl="plain"), batches[0])[0])
    check_peak = torch.cuda.max_memory_allocated()
    if not math.isfinite(chunked) or abs(chunked - plain) > 1e-4 * abs(plain):
        raise AssertionError(f"chunked loss {chunked} vs plain {plain}")
    step = train_mod.make_train_step(cfg, opt_mod.AdamWConfig(
        lr=3e-3, warmup_steps=5, total_steps=10))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    times, losses = [], []
    for batch in batches:
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(_lib.launches)
    peak = torch.cuda.max_memory_allocated()
    per_step = train_mod.kernel_launches_per_step(cfg)
    want = {k: v * Q3_TRAIN_STEPS for k, v in per_step.items()}
    log(f"train {QWEN3B} launches {launches}, expected {want} ({per_step} "
        f"per step x {Q3_TRAIN_STEPS} steps)")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"bad loss trajectory {losses}")
    mean_s = sum(times[1:]) / len(times[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = registry.model_flops(cfg, tokens, training=True,
                                 seq_len=TRAIN_SEQ)
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"train {QWEN3B} (chunked_vocab loss, remat subblock, "
        f"{registry.param_count(cfg) / 1e9:.3f} B params): step-0 loss "
        f"chunked {chunked:.7f} vs plain {plain:.7f} (rel diff "
        f"{abs(chunked - plain) / abs(plain):.3e}, limit 1e-4; peak device "
        f"memory of the two no_grad losses {check_peak / 2**30:.2f} GiB); "
        f"losses {[round(x, 6) for x in losses]}; mean step "
        f"{mean_s * 1e3:.3f} ms (steps 1-{Q3_TRAIN_STEPS - 1}; step 0 "
        f"{times[0] * 1e3:.3f} ms), {tokens / mean_s:.1f} tokens/s, model "
        f"{flops / mean_s / 1e12:.2f} TFLOP/s ({flops / 1e12:.2f} TFLOP a "
        f"step by registry.model_flops); peak device memory "
        f"{peak / 2**30:.2f} GiB of {total / 2**30:.2f} GiB")
    step_breakdown(cfg, step, {"p": params, "o": opt_state}, batches[0], 1,
                   warm=False)
    return launches


def remat_check(arch: str = TRAIN_ARCH, policies=POLICIES,
                layers: int | None = None) -> dict:
    """One forward and backward of ``arch`` at full width (``layers``
    deep where given) under each checkpoint policy, from the same weights
    and batch (8 x 1024 tokens, bf16 compute, f32 weights): the gradients
    must equal the first policy's ("full"), expected bit for bit, else
    within 1e-4 of each leaf's largest entry (the limit of the card-vs-CPU
    gradient checks); the launches must be ``kernel_launches_per_step``'s.
    Prints each policy's time (a second pass, once the allocator holds its
    blocks) and its peak device memory above what was allocated before it
    (the weights, and the first policy's gradients)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import _lib
    from repro_torch.launch import train as train_mod
    from repro_torch.models import registry
    from repro_torch.models.layers import tree_leaves
    cfg0 = get_config(arch)
    if layers:
        cfg0 = cfg0.with_overrides(num_layers=layers)
    params = registry.init_params(
        cfg0, torch.Generator(device="cuda").manual_seed(11))
    names = [p for p, _ in tree_leaves(params)]
    leaves = [t.requires_grad_() for _, t in tree_leaves(params)]
    batch = {k: torch.from_numpy(v.copy()).cuda() for k, v in
             SyntheticLM(cfg0.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=12)
             .sample().items()}

    def grads_of(cfg):
        loss, _ = registry.loss_fn(params, cfg, batch)
        return torch.autograd.grad(loss, leaves)

    grads_of(cfg0.with_overrides(remat_policy=policies[0]))     # warm-up
    ref, texts, total = None, [], dict.fromkeys(_lib.launches, 0)
    for policy in policies:
        cfg = cfg0.with_overrides(remat_policy=policy)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _lib.reset_launches()
        grads = grads_of(cfg)
        torch.cuda.synchronize()
        launches = dict(_lib.launches)
        peak = torch.cuda.max_memory_allocated() - base
        # timed again once the allocator holds the policy's blocks
        t0 = time.perf_counter()
        grads_of(cfg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        want = train_mod.kernel_launches_per_step(cfg)
        if launches != want:
            raise AssertionError(f"{arch} remat {policy}: launch counts "
                                 f"{launches} != {want}")
        total = {k: total[k] + v for k, v in launches.items()}
        if ref is None:
            ref, same = grads, "the reference"
        elif all(torch.equal(a, b) for a, b in zip(grads, ref)):
            same = f"gradients equal {policies[0]}'s bit for bit"
        else:
            worst = max(leaf_errors(f"{arch} remat {policy} gradient", names,
                                    grads, ref, 1e-4))
            same = (f"gradients within {worst:.3e} of each leaf's largest "
                    f"entry of {policies[0]}'s (limit 1e-4)")
        texts.append(f"{policy}: {ms:.3f} ms, peak {peak / 2**30:.2f} GiB "
                     f"above the resident weights, launches {launches}, "
                     f"{same}")
        del grads
    log(f"check: {arch} full width ({cfg0.num_layers} layers), one forward "
        f"and backward of {TRAIN_BATCH}x{TRAIN_SEQ} tokens under each "
        f"checkpoint policy:\n  " + "\n  ".join(texts))
    return total


def events_check(launches: int = 6) -> None:
    """The event and task classes on the card: ``launches`` products on a
    side stream, each followed by a recorded ``torch.cuda.Event``; a
    ``TaskQueue`` (head-only polls) over the first four events and a
    ``TaskGraph`` diamond (a -> b, c -> d) over the last four, whose
    ``ready_fn``s call ``Event.query()``; a ``CompletionWatcher`` on every
    task's request emits into an ``EventQueue``; all driven by
    ``ProgressEngine.progress()``.  Every synchronize is made to raise
    while the engine is driven, and some poll must find its event not yet
    done (the host ran ahead of the card)."""
    from repro_torch.core import (CompletionWatcher, EventQueue,
                                  ProgressEngine, TaskGraph, TaskQueue)
    eng = ProgressEngine()
    side = torch.cuda.Stream()
    x = torch.randn(4096, 4096, device="cuda")
    torch.cuda.synchronize()
    events, outs = [], []
    with torch.cuda.stream(side):
        for _ in range(launches):
            outs.append(x @ x)
            ev = torch.cuda.Event()
            ev.record(side)
            events.append(ev)
    polls = {"queue": [0] * 4, "graph": dict.fromkeys("abcd", 0)}
    pending_seen, early = [0], []

    def ready(ev, count):
        def fn():
            count()
            done = ev.query()
            pending_seen[0] += not done
            return done
        return fn

    def bump(table, key):
        def count():
            table[key] += 1
            # head-only: a queued task is polled only once every task
            # before it has completed
            if table is polls["queue"] and not all(
                    r.is_complete for r in qreqs[:key]):
                early.append(key)
        return count

    q = TaskQueue(eng)
    g = TaskGraph(eng)
    evq = EventQueue()
    w = CompletionWatcher(eng)
    qreqs: list = []
    qreqs += [q.submit(ready(events[i], bump(polls["queue"], i)),
                      on_complete=lambda i=i: f"q{i}") for i in range(4)]
    ga = g.add(ready(events[2], bump(polls["graph"], "a")),
               on_complete=lambda: "a")
    gb = g.add(ready(events[3], bump(polls["graph"], "b")), deps=[ga],
               on_complete=lambda: "b")
    gc = g.add(ready(events[4], bump(polls["graph"], "c")), deps=[ga],
               on_complete=lambda: "c")
    gd = g.add(ready(events[5], bump(polls["graph"], "d")), deps=[gb, gc],
               on_complete=lambda: "d")
    for r in (*qreqs, ga, gb, gc, gd):
        w.watch(r, lambda r_: evq.emit(r_.value()))

    sweeps, deadline = 0, time.perf_counter() + 60
    with no_sync():
        while (q.pending or g.pending or w.pending) and \
                time.perf_counter() < deadline:
            eng.progress()
            sweeps += 1
    order = evq.drain()
    if q.pending or g.pending or w.pending:
        raise AssertionError("the tasks did not complete within 60 s")
    queue_order = [v for v in order if v.startswith("q")]
    graph_order = [v for v in order if not v.startswith("q")]
    if queue_order != ["q0", "q1", "q2", "q3"] or graph_order[0] != "a" or \
            graph_order[-1] != "d" or sorted(graph_order) != list("abcd"):
        raise AssertionError(f"completion order {order}")
    if not pending_seen[0]:
        raise AssertionError("no poll found its event pending")
    if early:
        raise AssertionError(f"queued tasks {early} polled before the tasks "
                             f"ahead of them completed")
    if not all(e.query() for e in events):
        raise AssertionError("an event is not done after its task completed")
    log(f"check: events and task classes on the card, {launches} products "
        f"of 4096x4096 f32 on a side stream: {sweeps} progress sweeps, "
        f"{pending_seen[0]} polls found their event pending, none "
        f"synchronized; completion order {order}; queue polls "
        f"{polls['queue']} (head only), graph polls {polls['graph']}")
    del outs


# ---------------------------------------------------------------------------
# phase 8: the user-space collectives on the card
# ---------------------------------------------------------------------------

COLL_NS = (2, 3, 4, 8)
COLL_DTYPES = (torch.int32, torch.float32, torch.bfloat16)
COLL_CHUNKS = (1, 4)
COLL_BATCHES = (1, None)            # per-round dispatch, and auto


def coll_cases(n: int) -> list:
    """(op, algorithm, global payload shape) of the collectives phase at
    n ranks: every allreduce schedule (n = 3 falls back to ring for the
    power-of-two ones), ring and halving/doubling reduce-scatter and
    all-gather, Bruck all-to-all."""
    from repro_torch.collectives import schedules as S
    cases = [("allreduce", a, (n * 2, 3, 1000)) for a in S.ALGORITHMS]
    cases += [(op, a, shape) for op, shape in
              (("reduce_scatter", (n * 2, 2, n * 64)),
               ("allgather", (n * 2, 2, 96)))
              for a in ("ring", "halving_doubling")]
    cases.append(("alltoall", "bruck", (n * n, 96)))
    return cases


def plain_collective(op: str, x: torch.Tensor, n: int) -> torch.Tensor:
    """The plain reference of an int32 collective: the stacked sum, a
    slice of it, the concatenation, the block transpose."""
    v = x.unflatten(0, (n, -1))
    if op == "allreduce":
        return v.sum(0, keepdim=True, dtype=x.dtype).expand_as(v).flatten(0, 1)
    if op == "reduce_scatter":
        s = v.sum(0, dtype=x.dtype)
        w = s.shape[-1] // n
        return torch.stack([s[..., r * w:(r + 1) * w]
                            for r in range(n)]).flatten(0, 1)
    if op == "allgather":
        g = torch.cat(list(v), dim=-1)
        return g.expand((n,) + tuple(g.shape)).flatten(0, 1)
    return v.transpose(0, 1).flatten(0, 1)


def run_collective(coll, op, alg, x, mesh, chunks, batch, persistent):
    """One collective through the one-shot op or a persistent handle."""
    import warnings
    kw = dict(chunks=chunks, round_batch=batch)
    if op != "alltoall":
        kw["algorithm"] = alg
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # the n = 3 ring fallbacks
        if persistent:
            h = getattr(coll, op + "_init")(x, mesh, "x", **kw)
            out = h.start(x).wait(timeout=120)
            h.close()
            return out
        return getattr(coll, "i" + op)(x, mesh, "x", **kw).wait(timeout=120)


class no_sync:
    """Every synchronize raises inside the block: the engine polls CUDA
    events there, it never blocks on them."""

    def __enter__(self):
        self.saved = (torch.cuda.synchronize, torch.cuda.Event.synchronize,
                      torch.cuda.Stream.synchronize)

        def refuse(*_a, **_k):
            raise AssertionError("a poll synchronized the card")

        torch.cuda.synchronize = torch.cuda.Event.synchronize = \
            torch.cuda.Stream.synchronize = refuse

    def __exit__(self, *exc):
        (torch.cuda.synchronize, torch.cuda.Event.synchronize,
         torch.cuda.Stream.synchronize) = self.saved


def collectives_phase() -> dict:
    """Every op × algorithm at n ∈ {2, 3, 4, 8} ranks on the card, chunks
    {1, 4}, round batch {1, auto}, one-shot and persistent: int32 bit for
    bit against the plain reference, f32 and bf16 bit for bit against the
    same schedule on the CPU.  Then compressed_allreduce against its CPU
    run, a P2P channel restarted 20 times, and a persistent allreduce
    restarted 20 times with no new allocation.  Returns the count of
    polls that found a round still running."""
    from repro_torch.collectives import compression as C
    from repro_torch.collectives import nonblocking as NB
    from repro_torch.collectives.p2p import P2P
    from repro_torch.core import ProgressEngine
    from repro_torch.launch.mesh import make_mesh
    eng = ProgressEngine()
    coll, host = NB.UserCollectives(eng), NB.UserCollectives(ProgressEngine())
    gen = torch.Generator().manual_seed(11)
    runs, t0 = 0, time.perf_counter()
    for n in COLL_NS:
        mesh, cmesh = make_mesh((n,), ("x",), "cuda"), \
            make_mesh((n,), ("x",), "cpu")
        for op, alg, shape in coll_cases(n):
            for dt in COLL_DTYPES:
                if dt == torch.int32:
                    xc = torch.randint(-8, 8, shape, generator=gen,
                                       dtype=torch.int32)
                else:
                    xc = torch.randn(shape, generator=gen).to(dt)
                x = xc.cuda()
                for chunks, batch, persistent in itertools.product(
                        COLL_CHUNKS, COLL_BATCHES, (False, True)):
                    with no_sync():
                        got = run_collective(coll, op, alg, x, mesh, chunks,
                                             batch, persistent)
                    want = plain_collective(op, xc, n) if dt == torch.int32 \
                        else run_collective(host, op, alg, xc, cmesh, chunks,
                                            batch, persistent)
                    if got.device.type != "cuda" or not torch.equal(
                            got.cpu(), want):
                        raise AssertionError(
                            f"{op}/{alg} n={n} {dt} chunks={chunks} round "
                            f"batch={batch} persistent={persistent}: the card "
                            f"differs from the "
                            + ("plain reference" if dt == torch.int32
                               else "CPU run"))
                    runs += 1
    grid_s = time.perf_counter() - t0
    # compressed_allreduce, int8 on the wire, against its CPU run
    xc = torch.randn(4, 8, 3000, generator=gen)
    got = C.compressed_allreduce(xc.cuda(), 2048).cpu()
    want = C.compressed_allreduce(xc, 2048)
    comp_err = float((got - want).abs().max())
    if comp_err > 1e-6 * float(want.abs().max()):
        raise AssertionError(f"compressed_allreduce card vs CPU {comp_err}")
    # a P2P channel restarted 20 times
    p2p = P2P(eng)
    mesh4 = make_mesh((4,), ("x",), "cuda")
    chan = p2p.channel_init(torch.zeros(4, 4096, device="cuda"), mesh4, "x")
    for i in range(20):
        x = torch.randn(4, 4096, generator=gen).cuda()
        with no_sync():
            chan.send.start(x)
            got = chan.recv.start().wait(timeout=60)
        if not torch.equal(got, torch.roll(x, 1, 0)):
            raise AssertionError(f"p2p channel start {i}: not the hop")
    p2p.close()
    # a persistent allreduce restarted 20 times: no new allocation
    x = torch.randint(-8, 8, (8, 1 << 23), generator=gen,
                      dtype=torch.int32).cuda()
    want = plain_collective("allreduce", x, 4)
    h = coll.allreduce_init(x, mesh4, "x", chunks=4, round_batch=1)
    mem = []
    out = None
    for _ in range(20):
        with no_sync():
            out = h.start(x).wait(timeout=60)
        mem.append(torch.cuda.memory_allocated())
        if not torch.equal(out, want):
            raise AssertionError("persistent restart: wrong result")
    if len(set(mem)) != 1:
        raise AssertionError(f"persistent restarts allocated: {mem}")
    h.close()
    coll.close()
    host.close()
    st, pending = coll.stream, coll.pending_polls
    log(f"collectives: {runs} runs on the card ({len(COLL_NS)} rank counts x "
        f"9 op/algorithm pairs x 3 dtypes x chunks {COLL_CHUNKS} x round "
        f"batch {COLL_BATCHES} x one-shot/persistent) in {grid_s:.1f} s, "
        f"int32 bit for bit against the plain reference, f32 and bf16 bit "
        f"for bit against the CPU run, no synchronize; compressed_allreduce "
        f"[4, 8, 3000] card vs CPU max abs diff {comp_err:.3e}; P2P channel "
        f"restarted 20 times; persistent ring allreduce [8, 8388608] int32 "
        f"(4 ranks, 4 chunks) restarted 20 times, memory_allocated "
        f"{mem[0]} B after every start; collective stream: {st.polls} polls, "
        f"{st.completions} completions; {pending} polls of a round's CUDA "
        f"event found the round still running")
    return pending


def stream_busy(prof) -> tuple[dict, float, float]:
    """Per CUDA stream, the busy time in ms (the union of its kernels'
    intervals) from a profiler run; the time two or more streams were
    busy at once; the time any stream was busy."""
    spans: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.setdefault(e.device_resource_id, []).append(
                (e.time_range.start, e.time_range.end))

    def union(iv):
        out = []
        for s, t in sorted(iv):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return out

    merged = {k: union(v) for k, v in spans.items()}
    busy = {k: sum(t - s for s, t in v) / 1e3 for k, v in merged.items()}
    edges = sorted([(s, 1) for v in merged.values() for s, _ in v]
                   + [(t, -1) for v in merged.values() for _, t in v])
    both, any_busy, depth, last = 0.0, 0.0, 0, None
    for x, d in edges:
        if depth >= 2:
            both += x - last
        if depth >= 1:
            any_busy += x - last
        depth += d
        last = x
    return busy, both / 1e3, any_busy / 1e3


def overlap_phase() -> int:
    """A 256 MiB f32 ring allreduce at n = 4 on the collective stream,
    then a chain of bf16 GEMMs on the compute stream, the engine
    progressing the rounds between them; the profiler's busy time of each
    stream and the time both were busy.  Printed, not asserted.  Returns
    the count of polls that found a round still running."""
    from repro_torch.collectives import nonblocking as NB
    from repro_torch.core import ProgressEngine
    from repro_torch.launch.mesh import make_mesh
    coll = NB.UserCollectives(ProgressEngine())
    mesh = make_mesh((4,), ("x",), "cuda")
    x = torch.randn(4, 16 << 20, device="cuda")            # 256 MiB
    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    # the products' outputs are made up front: a cudaMalloc inside the
    # chain would synchronize the card
    outs = torch.empty(24, 8192, 8192, device="cuda", dtype=torch.bfloat16)
    want = x.sum(0, keepdim=True)

    def run(gemms: int):
        req = coll.iallreduce(x, mesh, "x", chunks=4, round_batch=1)
        for i in range(gemms):
            torch.matmul(a, a, out=outs[i])
            coll.engine.progress(coll.stream)
        return req.wait(timeout=120)

    run(2)                                       # warm: carries, cuBLAS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run(0)
    torch.cuda.synchronize()
    alone = (time.perf_counter() - t0) * 1e3
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = run(24)
        torch.cuda.synchronize()
    if not torch.allclose(out[:1], want, rtol=1e-5, atol=1e-4):
        raise AssertionError("overlap allreduce: wrong sum")
    busy, both, any_busy = stream_busy(prof)
    roles = stream_roles(prof)
    coll.close()
    if len(busy) < 2:
        log(f"overlap: 256 MiB f32 ring allreduce (4 ranks, 4 chunks) alone "
            f"{alone:.3f} ms wall; {coll.pending_polls} polls found a round "
            f"running; device busy per stream not measured (the profiler "
            f"recorded {len(busy)} stream(s))")
        return coll.pending_polls
    coll_ms = sum(v for k, v in busy.items() if roles[k] == "collective")
    log(f"overlap: 256 MiB f32 ring allreduce (4 ranks, 4 chunks, per-round "
        f"dispatch) alone {alone:.3f} ms wall; beside 24 bf16 8192^3 GEMMs: "
        f"device busy (ms) "
        + ", ".join(f"{roles[k]} stream {v:.3f}" for k, v in busy.items())
        + f", any stream {any_busy:.3f}; both busy at once {both:.3f} ms"
        + (f" ({both / coll_ms:.3f} of the collective stream's busy time)"
           if coll_ms else "")
        + f"; {coll.pending_polls} polls found a round running")
    return coll.pending_polls


# ---------------------------------------------------------------------------
# phase 9: data-parallel training on the user-space collectives
# ---------------------------------------------------------------------------

DP_RANKS, DP_CHUNKS = 4, 4
DP_LOSS_ATOL = 5e-2          # bf16: the ranks' GEMMs see 2 rows, not 8
DP_GRAD_RTOL = {"bfloat16": 5e-2, "float32": 1e-5}   # relative L2


def train_dp(single_losses: list | None):
    """``launch.train`` data-parallel at full smollm-360m width: 4 ranks
    on the card, 8 x 1024 tokens (2 sequences a rank), ring, 4 chunks,
    32 MiB buckets, 3 steps under the Trainer, the last step checkpointed
    and restored equal; every loss finite and the trajectory within
    ``DP_LOSS_ATOL`` of the single-card run's (not compared when
    ``single_losses`` is None: ``--only devices`` runs no single card)."""
    from repro_torch.kernels import _lib
    from repro_torch.launch import train as train_mod
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train_dp_")
    try:
        args = train_mod.build_parser().parse_args([
            "--arch", TRAIN_ARCH, "--scale", "full", "--device", "cuda",
            "--global-batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--steps", str(TRAIN_STEPS), "--ckpt-dir", ckpt_dir,
            "--devices", str(DP_RANKS), "--mesh", f"{DP_RANKS}x1",
            "--collective-backend", "user", "--collective-algorithm", "ring",
            "--collective-chunks", str(DP_CHUNKS)])
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launches()
        report = train_mod.run(args, log_every=1)
        launches = dict(_lib.launches)
        cfg, tr = report.cfg, report.trainer
        if full_width(cfg) != FULL_WIDTH[TRAIN_ARCH]:
            raise AssertionError(f"not the full {TRAIN_ARCH} width: {cfg}")
        want = {k: v * TRAIN_STEPS for k, v in
                train_mod.kernel_launches_per_step(cfg, DP_RANKS).items()}
        if launches != want:
            raise AssertionError(f"launch counts {launches} != {want}")
        losses = [m["loss"] for m in report.log]
        if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"bad loss trajectory {losses}")
        if single_losses is not None:
            diff = max(abs(a - b) for a, b in zip(losses, single_losses))
            if diff > DP_LOSS_ATOL:
                raise AssertionError(f"data-parallel losses {losses} vs the "
                                     f"single card's {single_losses}")
            single_text = (f"single card "
                           f"{[round(v, 6) for v in single_losses]}, max "
                           f"diff {diff:.3e}, limit {DP_LOSS_ATOL}")
        else:
            single_text = "no single-card run in this partial run"
        peak = torch.cuda.max_memory_allocated()
        ckpt_text = checkpoint_check(tr, TRAIN_STEPS - 1)
        steps_s = [m["step_time_s"] for m in report.log[1:]]
        mean_s = sum(steps_s) / len(steps_s)
        issue = tr.reduce_issue_s[1:]
        red = report.reducer
        log(f"train_dp {TRAIN_ARCH} ({DP_RANKS} ranks on the card, "
            f"{red.algorithm}, {red.chunks} chunks, "
            f"{red.bucket_bytes >> 20} MiB buckets): launches {launches}; "
            f"losses {[round(v, 6) for v in losses]} ({single_text}); "
            f"mean step {mean_s * 1e3:.3f} ms (steps "
            f"1-{TRAIN_STEPS - 1}; step 0 "
            f"{report.log[0]['step_time_s'] * 1e3:.3f} ms), "
            f"{TRAIN_BATCH * TRAIN_SEQ / mean_s:.1f} tokens/s; reducer "
            f"{report.reduce_dispatches} dispatch units a step, host time "
            f"to issue {sum(issue) / len(issue) * 1e3:.3f} ms a step; "
            f"{ckpt_text}; peak device memory {peak / 2**30:.2f} GiB")
        return launches, report
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


GEMM_NAMES = ("gemm", "nvjet", "cutlass", "xmma", "sm90_")


def stream_roles(prof) -> dict:
    """Stream id -> "compute" (it ran a GEMM) or "collective"."""
    names: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            names.setdefault(e.device_resource_id, set()).add(e.name.lower())
    return {k: "compute" if any(g in nm for nm in v for g in GEMM_NAMES)
            else "collective" for k, v in names.items()}


def dp_time_breakdown(report, steps: int = 2) -> None:
    """One data-parallel step's time, on the trained weights and one
    fixed batch: host wall clock of unprofiled steps; from the profiler
    the device busy time (any stream) and idle share, the collective
    stream's busy time (the reducer's device time) and the share of it
    during which the compute stream was busy too."""
    from repro_torch.collectives.overlap import EngineGradReducer
    from repro_torch.core import ProgressEngine
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import optimizer as opt_mod
    tr, cfg = report.trainer, report.cfg
    ocfg = opt_mod.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=10)
    reducer = EngineGradReducer(make_mesh((DP_RANKS, 1), ("data", "model"),
                                          "cuda"), "data",
                                engine=ProgressEngine(), chunks=DP_CHUNKS)
    grad_fn = train_mod.make_rank_grads(cfg, DP_RANKS)
    batch = {k: torch.from_numpy(v.copy()).cuda() for k, v in
             SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=9)
             .sample().items()}
    state = {"p": tr.params, "o": tr.opt_state}

    def run(k=steps):
        t0 = time.perf_counter()
        for _ in range(k):
            _, g = grad_fn(state["p"], batch)
            reduction = reducer.iallreduce_tree(g)
            del g
            grads = reduction.wait(timeout=600)
            state["p"], state["o"], _ = opt_mod.apply(ocfg, state["o"],
                                                      state["p"], grads)
            del grads
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / k

    run(1)
    wall = run()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        wall_prof = run()
    reducer.close()
    busy, both, any_busy = stream_busy(prof)
    roles = stream_roles(prof)
    if not busy:
        log(f"time: train_dp step wall {wall:.3f} ms; device busy not "
            f"measured (no profiler events)")
        return
    coll = sum(v for k, v in busy.items() if roles[k] == "collective")
    log(f"time: train_dp step ({TRAIN_ARCH}, {DP_RANKS} ranks, "
        f"{TRAIN_BATCH}x{TRAIN_SEQ} tokens): wall {wall:.3f} ms "
        f"({wall_prof:.3f} ms under the profiler), device busy (any stream) "
        f"{any_busy / steps:.3f} ms, device idle share "
        f"{1 - any_busy / steps / wall:.3f}; per stream (ms a step) "
        + ", ".join(f"{roles[k]} {v / steps:.3f}" for k, v in busy.items())
        + f"; the reducer's device time {coll / steps:.3f} ms a step, "
        f"{both / steps:.3f} ms of it with the compute stream busy too "
        f"({both / coll if coll else 0:.3f} overlapped)")


def dp_gradient_check(layers: int | None = None) -> None:
    """Step 0's reduced mean gradient of the data-parallel path (4 ranks'
    ``make_rank_grads``, the engine grad reducer's ring) against the
    single-card gradient of the whole batch, on the same weights and
    batch: full width in bf16, or ``layers`` layers in f32; relative L2
    over every leaf within ``DP_GRAD_RTOL``."""
    from repro_torch.collectives.overlap import EngineGradReducer
    from repro_torch.configs import get_config
    from repro_torch.core import ProgressEngine
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry
    from repro_torch.models.layers import tree_leaves
    cfg = get_config(TRAIN_ARCH)
    if layers:
        cfg = cfg.with_overrides(num_layers=layers, dtype="float32")
    params = registry.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    batch = {k: torch.from_numpy(v.copy()).cuda() for k, v in
             SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=5)
             .sample().items()}
    leaves = [t.requires_grad_(True) for _, t in tree_leaves(params)]
    loss, _ = registry.loss_fn(params, cfg, batch)
    single = [g.float() for g in torch.autograd.grad(loss, leaves)]
    reducer = EngineGradReducer(make_mesh((DP_RANKS, 1), ("data", "model"),
                                          "cuda"), "data",
                                engine=ProgressEngine(), chunks=DP_CHUNKS)
    mets, stacked = train_mod.make_rank_grads(cfg, DP_RANKS)(params, batch)
    reduced = reducer.allreduce_tree(stacked, timeout=600)
    reducer.close()
    del stacked
    num = sum(float(((a - b) ** 2).sum()) for a, (_, b)
              in zip(single, tree_leaves(reduced)))
    den = sum(float((a ** 2).sum()) for a in single)
    rel = math.sqrt(num / den)
    limit = DP_GRAD_RTOL[cfg.dtype]
    dloss = abs(float(mets["loss"].mean()) - float(loss.detach()))
    log(f"check: train_dp step-0 gradient, {DP_RANKS} ranks reduced vs the "
        f"single card ({cfg.num_layers} layers, {cfg.dtype}): relative L2 "
        f"{rel:.3e} (limit {limit}); loss {float(loss.detach()):.7f}, "
        f"ranks' mean "
        f"diff {dloss:.3e}")
    if not rel <= limit:
        raise AssertionError(f"data-parallel gradient off by {rel:.3e}")


# ---------------------------------------------------------------------------
# phase 10: parallel training — FSDP, elastic recovery, the 1F1B pipeline
# ---------------------------------------------------------------------------

FSDP_BUCKET = 4 << 20        # the launcher's default --fsdp-bucket-bytes
# limits (PERF.md states them beside the predictions).  The bf16
# trajectory amplifies the f32 sum-order difference between the ring and
# the plain sum as it amplifies the single card's against data-parallel,
# so user vs native FSDP losses share that limit, and the sum order
# alone is held at step 0 (FSDP_RS_RTOL)
FSDP_NATIVE_ATOL = DP_LOSS_ATOL    # user vs native FSDP losses
FSDP_RS_RTOL = 1e-6          # step 0's reduce-scatter, user vs native, rel L2
FSDP_DP_ATOL = 1e-3          # vs the data-parallel run: same rank gradients
ELASTIC_LAYERS, ELASTIC_STEPS, ELASTIC_KILL = 2, 5, 2
ELASTIC_LOSS_ATOL = 1e-3     # chaos vs restart, held only if two identical
#                              restarts already differ (atomics)
PIPE_S, PIPE_M, PIPE_MB, PIPE_STEPS = 4, 8, 8, 5


def train_fsdp(backend: str):
    """``launch.train --devices 4 --fsdp`` at full smollm-360m width: 4
    ranks on the card, 8 x 1024 tokens, 4 MiB buckets, ring, 4 chunks,
    ``TRAIN_STEPS`` steps under the Trainer (``FsdpStep`` on the
    ``FsdpReducer`` for the user backend; the native pair in the step
    otherwise), launch counts;
    the user run's last checkpoint restored equal."""
    from repro_torch.kernels import _lib
    from repro_torch.launch import train as train_mod
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train_fsdp_")
    try:
        args = train_mod.build_parser().parse_args([
            "--arch", TRAIN_ARCH, "--scale", "full", "--device", "cuda",
            "--global-batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--steps", str(TRAIN_STEPS), "--ckpt-dir", ckpt_dir,
            "--devices", str(DP_RANKS), "--mesh", f"{DP_RANKS}x1", "--fsdp",
            "--fsdp-bucket-bytes", str(FSDP_BUCKET),
            "--collective-backend", backend, "--collective-algorithm", "ring",
            "--collective-chunks", str(DP_CHUNKS)])
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launches()
        with no_sync():
            report = train_mod.run(args, log_every=1)
        launches = dict(_lib.launches)
        cfg, tr = report.cfg, report.trainer
        if full_width(cfg) != FULL_WIDTH[TRAIN_ARCH]:
            raise AssertionError(f"not the full {TRAIN_ARCH} width: {cfg}")
        want = {k: v * TRAIN_STEPS for k, v in
                train_mod.kernel_launches_per_step(cfg, DP_RANKS).items()}
        if launches != want:
            raise AssertionError(f"launch counts {launches} != {want}")
        losses = [m["loss"] for m in report.log]
        if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"bad loss trajectory {losses}")
        if any(s.device.type != "cuda" for s in tr.params):
            raise AssertionError("shards off the card")
        peak = torch.cuda.max_memory_allocated()
        steps_s = [m["step_time_s"] for m in report.log[1:]]
        mean_s = sum(steps_s) / len(steps_s)
        text = f"fsdp {backend}: {report.layout.num_buckets} buckets"
        if backend == "user":
            red = report.reducer
            text += (f", prefetch overlap {red.prefetch_overlap:.3f} over "
                     f"{red.gathers} chained gathers, "
                     f"{report.reduce_dispatches} dispatch units a step "
                     f"(reduce-scatters and all-gathers); "
                     + checkpoint_check(tr, TRAIN_STEPS - 1))
        log(f"train_fsdp {TRAIN_ARCH} ({DP_RANKS} ranks on the card, "
            f"{FSDP_BUCKET >> 20} MiB buckets, ring, {DP_CHUNKS} chunks): "
            f"launches {launches}; losses {[round(v, 6) for v in losses]}; "
            f"mean step {mean_s * 1e3:.3f} ms (steps 1-{TRAIN_STEPS - 1}; "
            f"step 0 {report.log[0]['step_time_s'] * 1e3:.3f} ms), "
            f"{TRAIN_BATCH * TRAIN_SEQ / mean_s:.1f} tokens/s; {text}; peak "
            f"device memory {peak / 2**30:.2f} GiB")
        return launches, report, losses
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def hold_losses(name: str, got: list, want: list, limit: float) -> None:
    diff = max(abs(a - b) for a, b in zip(got, want))
    log(f"check: {name}: max loss diff {diff:.3e} (limit {limit})")
    if not diff <= limit:
        raise AssertionError(f"{name}: {got} vs {want}")


def fsdp_time_breakdown(report, steps: int = 2) -> None:
    """One FSDP step's time, on the trained shards and one fixed batch, as
    the Trainer runs it (gather waited, rank passes, reduce-scatter,
    sharded AdamW, the next gather chained off the optimizer's futures):
    host wall clock; from the profiler the device busy time and idle
    share, the collective stream's busy time (reduce-scatters and
    all-gathers) and the share of it during which the compute stream was
    busy too."""
    from repro_torch.collectives.overlap import FsdpReducer
    from repro_torch.core import ProgressEngine
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import optimizer as opt_mod
    tr, cfg = report.trainer, report.cfg
    mesh = make_mesh((DP_RANKS, 1), ("data", "model"), "cuda")
    ocfg = opt_mod.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=10)
    grad_fn, apply_fn, _, _ = train_mod.build_fsdp_programs(
        cfg, ocfg, mesh, report.layout)
    red = FsdpReducer(mesh, "data", engine=ProgressEngine(),
                      chunks=DP_CHUNKS, bucket_bytes=FSDP_BUCKET)
    batch = {k: torch.from_numpy(v.copy()).cuda() for k, v in
             SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=9)
             .sample().items()}
    state = {"s": tr.params, "o": tr.opt_state, "g": None}

    def run(k=steps):
        t0 = time.perf_counter()
        for _ in range(k):
            pending = state["g"] or red.igather(state["s"])
            flats = pending.wait(timeout=600)
            smets, fg = grad_fn(flats, batch)
            del flats
            gs = red.ireduce_scatter(fg).wait(timeout=600)
            del fg
            state["s"], state["o"], _ = apply_fn(state["s"], state["o"], gs,
                                                 smets)
            del gs
            state["g"] = red.igather(state["s"], after=[
                red.future(sh) for sh in state["s"]])
        state["g"].wait(timeout=600)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / k

    run(1)
    wall = run()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        wall_prof = run()
    dispatches = red.dispatches_per_step
    red.close()
    busy, both, any_busy = stream_busy(prof)
    roles = stream_roles(prof)
    if not busy:
        log(f"time: train_fsdp step wall {wall:.3f} ms; device busy not "
            f"measured (no profiler events)")
        return
    coll = sum(v for k, v in busy.items() if roles[k] == "collective")
    log(f"time: train_fsdp step ({TRAIN_ARCH}, {DP_RANKS} ranks, "
        f"{TRAIN_BATCH}x{TRAIN_SEQ} tokens): wall {wall:.3f} ms "
        f"({wall_prof:.3f} ms under the profiler), device busy (any stream) "
        f"{any_busy / steps:.3f} ms, device idle share "
        f"{1 - any_busy / steps / wall:.3f}; per stream (ms a step) "
        + ", ".join(f"{roles[k]} {v / steps:.3f}" for k, v in busy.items())
        + f"; reduce-scatters + all-gathers {coll / steps:.3f} ms of device "
        f"time a step ({dispatches} dispatch units), {both / steps:.3f} ms "
        f"of it with the compute stream busy too "
        f"({both / coll if coll else 0:.3f} overlapped)")


def fsdp_gather_check() -> None:
    """Step 0's collectives: the ``FsdpReducer``'s cold-start chained
    all-gather of the seeded weights' shards (what the FSDP run's first
    step waits for) — every row of every bucket bit for bit
    ``FsdpLayout.flatten_bucket`` of the weights; then the ranks'
    gradients on step 0's batch reduce-scattered by the reducer's ring
    against the native sum over the rank dim, relative L2 within
    ``FSDP_RS_RTOL`` (f32: the two add in another order)."""
    from repro_torch.collectives.overlap import (FsdpLayout, FsdpReducer,
                                                 tree_flatten)
    from repro_torch.configs import get_config
    from repro_torch.core import ProgressEngine
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry
    from repro_torch.train import optimizer as opt_mod
    cfg = get_config(TRAIN_ARCH)
    params = registry.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    mesh = make_mesh((DP_RANKS, 1), ("data", "model"), "cuda")
    layout = FsdpLayout(params, DP_RANKS, FSDP_BUCKET)
    shards = layout.shard_params(params, mesh)
    red = FsdpReducer(mesh, "data", engine=ProgressEngine(),
                      chunks=DP_CHUNKS, bucket_bytes=FSDP_BUCKET)
    with no_sync():
        flats = red.gather(shards, timeout=600)
    leaves, _ = tree_flatten(params)
    bad = [b for b in range(layout.num_buckets)
           if not torch.equal(flats[b], layout.flatten_bucket(leaves, b)
                              .expand(DP_RANKS, -1))]
    del params, leaves
    log(f"check: fsdp step-0 gather, {layout.num_buckets} buckets of "
        f"{sum(layout.widths)} values x {DP_RANKS} rows: "
        f"{'bit for bit' if not bad else f'buckets {bad} differ'} against "
        f"FsdpLayout.flatten_bucket")
    if bad:
        raise AssertionError(f"gathered flats differ in buckets {bad}")
    grad_fn, _, _, rs_fn = train_mod.build_fsdp_programs(
        cfg, opt_mod.AdamWConfig(), mesh, layout)
    batch = {k: torch.from_numpy(v.copy()).cuda() for k, v in
             SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=5)
             .sample().items()}
    _, flat_g = grad_fn(flats, batch)
    del flats
    with no_sync():
        user = red.ireduce_scatter(flat_g).wait(timeout=600)
    red.close()
    native = rs_fn(flat_g)
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(user, native))
    den = sum(float((b ** 2).sum()) for b in native)
    rel = math.sqrt(num / den)
    same = all(torch.equal(a, b) for a, b in zip(user, native))
    log(f"check: fsdp step-0 reduce-scatter, ring ({DP_CHUNKS} chunks) vs "
        f"the native sum over the rank dim: relative L2 {rel:.3e} (limit "
        f"{FSDP_RS_RTOL}){', bit for bit' if same else ''}")
    if not rel <= FSDP_RS_RTOL:
        raise AssertionError(f"fsdp reduce-scatter off by {rel:.3e}")


class _ListPipe:
    def __init__(self, batches):
        self.batches = list(batches)

    def next_batch(self):
        return self.batches.pop(0)


def elastic_run(fsdp: bool, cfg, ocfg, params0, batches, *, chaos: bool,
                devices=None):
    """Five steps at full width and ``ELASTIC_LAYERS`` layers on 4 ranks
    of the card (with ``devices``, FSDP only: rank r on ``devices[r]``,
    the survivors on the first 2).  ``chaos``: one Trainer with a
    membership epoch and a ``remesh_fn``; its hook invalidates the epoch
    down to 2 survivors after step ``ELASTIC_KILL`` - 1, so step
    ``ELASTIC_KILL`` fails, is remeshed (FSDP: unsharded and re-sharded
    for 2 ranks) and retried.  Otherwise the restart: ``ELASTIC_KILL``
    steps on 4 ranks, then a new Trainer on 2 ranks from that state.
    Returns (losses, final parameter leaves, the recovery's figures)."""
    from repro_torch.collectives.rank_shards import tree_keep
    from repro_torch.collectives.nonblocking import (CollectiveSpec,
                                                     MembershipEpoch)
    from repro_torch.collectives.overlap import (EngineGradReducer,
                                                 FsdpLayout, FsdpReducer,
                                                 tree_flatten)
    from repro_torch.core import ProgressEngine
    from repro_torch.distributed import elastic
    from repro_torch.launch import train as train_mod
    from repro_torch.models.layers import tree_map
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_loop import (FsdpStep, Trainer,
                                              TrainLoopConfig,
                                              UserCollectiveStep)
    spec = CollectiveSpec(backend="user", algorithm="ring", chunks=DP_CHUNKS)

    def state_for(mesh, params, mu=None, nu=None, step=None):
        if not fsdp:
            return None, params, opt_mod.init(params) if mu is None else \
                opt_mod.AdamWState(step, mu, nu)
        layout = FsdpLayout(params, dict(mesh.shape)["data"], FSDP_BUCKET)
        shards = layout.shard_params(params, mesh)
        if mu is None:
            return layout, shards, opt_mod.init_shards(shards)
        return layout, shards, opt_mod.AdamWState(
            step, layout.shard_params(mu, mesh), layout.shard_params(nu, mesh))

    def apply_dp(params, opt_state, grads, sm):
        params, opt_state, om = opt_mod.apply(ocfg, opt_state, params, grads)
        return params, opt_state, dict({k: v.mean() for k, v in sm.items()},
                                       **om)

    def split_for(layout, mesh, reducer):
        if not fsdp:
            return UserCollectiveStep(
                train_mod.make_rank_grads(cfg, dict(mesh.shape)["data"]),
                apply_dp, reducer, spec=spec)
        g, a, _, _ = train_mod.build_fsdp_programs(cfg, ocfg, mesh, layout)
        return FsdpStep(g, a, reducer, spec=spec)

    def reducer_for(mesh, eng, epoch=None):
        if fsdp:
            return FsdpReducer(mesh, "data", engine=eng, spec=spec,
                               bucket_bytes=FSDP_BUCKET, epoch=epoch)
        return EngineGradReducer(mesh, "data", engine=eng, spec=spec,
                                 epoch=epoch)

    def trainer(layout, mesh, params, state, bs, tmp, **kw):
        eng = kw.pop("engine", None) or ProgressEngine()
        red = kw.pop("reducer", None) or reducer_for(mesh, eng)
        losses = kw.pop("losses")
        hooks = [lambda s, m: losses.append(m["loss"])] + kw.pop("hooks", [])
        tr = Trainer(None, params, state, _ListPipe(bs), TrainLoopConfig(
            total_steps=len(bs), checkpoint_every=10 ** 6,
            checkpoint_dir=tmp, log_every=1, resume=False,
            collective_spec=spec), engine=eng,
            split_step=split_for(layout, mesh, red), hooks=hooks, **kw)
        with no_sync():
            tr.run()
        red.close()
        return tr

    def unshard(layout, params, state):
        if not fsdp:
            return params, state.mu, state.nu
        return (layout.unshard_params(params), layout.unshard_params(state.mu),
                layout.unshard_params(state.nu))

    def mesh_of(n):
        if devices is not None:
            return elastic.remesh(n, prefer_model=1, devices=devices[:n])
        return elastic.remesh(n, prefer_model=1, device="cuda")

    def keep(step, mesh):
        # the survivors' step counters (one a device in the per-device
        # form)
        return tree_keep(step, mesh.size) if devices is not None else step

    mesh4 = mesh_of(4)
    params = tree_map(torch.clone, params0)
    layout, p, st = state_for(mesh4, params)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    losses, info = [], {}
    try:
        if chaos:
            eng = ProgressEngine()
            epoch = MembershipEpoch(mesh=mesh4)
            red = reducer_for(mesh4, eng, epoch)
            box = {"layout": layout}

            def remesh_fn(exc, params_, state_):
                t0 = time.perf_counter()
                new_mesh = mesh_of(exc.survivors)
                red.remesh(new_mesh, "data")
                full, mu, nu = unshard(box["layout"], params_, state_)
                box["layout"], p2, st2 = state_for(
                    new_mesh, full, mu, nu, keep(state_.step, new_mesh))
                split = split_for(box["layout"], new_mesh, red)
                info["remesh_ms"] = (time.perf_counter() - t0) * 1e3
                return split, p2, st2

            def kill(s, m):
                if s == ELASTIC_KILL - 1:
                    epoch.invalidate(survivors=2, reason="chaos kill")

            tr = trainer(layout, mesh4, p, st, batches, tmp, engine=eng,
                         reducer=red, losses=losses, hooks=[kill],
                         epoch=epoch, remesh_fn=remesh_fn)
            if tr.recoveries != 1 or red.remeshes != 1:
                raise AssertionError(f"recoveries {tr.recoveries}, remeshes "
                                     f"{red.remeshes}")
            info["failed_starts"] = red.coll.failed
            info["step_ms"] = [m["step_time_s"] * 1e3
                               for m in tr.metrics_log]
            final = tr.params
            final_layout = box["layout"]
        else:
            trA = trainer(layout, mesh4, p, st, batches[:ELASTIC_KILL],
                          tmp + "/a", losses=losses)
            mesh2 = mesh_of(2)
            full, mu, nu = unshard(layout, trA.params, trA.opt_state)
            final_layout, p2, st2 = state_for(
                mesh2, full, mu, nu, keep(trA.opt_state.step, mesh2))
            del trA
            trB = trainer(final_layout, mesh2, p2, st2,
                          batches[ELASTIC_KILL:], tmp + "/b", losses=losses)
            final = trB.params
        if fsdp:
            final = final_layout.unshard_params(final)
        return losses, [t.detach().clone() for t in tree_flatten(final)[0]], info
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def elastic_phase() -> None:
    """Kill 2 of 4 ranks at step ``ELASTIC_KILL`` of ``ELASTIC_STEPS``,
    data-parallel and FSDP, at full width and ``ELASTIC_LAYERS`` layers;
    the trajectory from the kill on against a checkpoint-and-restart on
    the 2 survivors: bit for bit when two identical restarts agree bit
    for bit, else within ``ELASTIC_LOSS_ATOL``.  Then the watchdog on a
    hung step."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import registry
    from repro_torch.train import optimizer as opt_mod
    cfg = get_config(TRAIN_ARCH).with_overrides(num_layers=ELASTIC_LAYERS)
    ocfg = opt_mod.AdamWConfig(lr=3e-3, warmup_steps=2,
                               total_steps=ELASTIC_STEPS)
    it = iter(SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=5))
    batches = [{k: torch.from_numpy(v.copy()).cuda()
                for k, v in next(it).items()} for _ in range(ELASTIC_STEPS)]
    params0 = registry.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    for fsdp in (False, True):
        name = "fsdp" if fsdp else "data-parallel"
        ref1 = elastic_run(fsdp, cfg, ocfg, params0, batches, chaos=False)
        ref2 = elastic_run(fsdp, cfg, ocfg, params0, batches, chaos=False)
        free()
        chaos = elastic_run(fsdp, cfg, ocfg, params0, batches, chaos=True)
        same = ref1[0] == ref2[0] and all(
            torch.equal(a, b) for a, b in zip(ref1[1], ref2[1]))
        exact = chaos[0] == ref1[0] and all(
            torch.equal(a, b) for a, b in zip(chaos[1], ref1[1]))
        pdiff = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(chaos[1], ref1[1]))
        info = chaos[2]
        steps = info["step_ms"]
        after = steps[ELASTIC_KILL + 1:]
        log(f"elastic {name} ({ELASTIC_LAYERS} layers, {DP_RANKS} -> 2 ranks "
            f"at step {ELASTIC_KILL} of {ELASTIC_STEPS}): 1 recovery, "
            f"{info['failed_starts']} in-flight start(s) failed; remesh + "
            f"re-shard {info['remesh_ms']:.3f} ms, the recovered step "
            f"{steps[ELASTIC_KILL]:.3f} ms (failed attempt, remesh, retry; "
            f"steps on 4 ranks {[round(v, 3) for v in steps[1:ELASTIC_KILL]]}"
            f" ms, after it on 2 {[round(v, 3) for v in after]} ms); two "
            f"identical restarts {'agree' if same else 'differ'} bit for "
            f"bit; chaos vs restart losses {[round(v, 6) for v in chaos[0]]} "
            f"vs {[round(v, 6) for v in ref1[0]]}, "
            f"{'bit for bit' if exact else 'not bit for bit'}, max param "
            f"diff {pdiff:.3e}")
        if same and not exact:
            raise AssertionError(f"elastic {name}: the chaos run differs "
                                 f"from a deterministic restart")
        if not same:
            hold_losses(f"elastic {name} chaos vs restart", chaos[0],
                        ref1[0], ELASTIC_LOSS_ATOL)
        del ref1, ref2, chaos
        free()
    watchdog_check()


def watchdog_check() -> None:
    """A persistent reduce-scatter of a card payload started on an armed
    step that hangs (nobody progresses the collective stream): the
    watchdog's poll fires once, invalidates the epoch, and the in-flight
    start fails with a retryable MembershipError exactly once; rebuilt,
    the handle sums right."""
    from repro_torch.collectives import nonblocking as NB
    from repro_torch.core import ProgressEngine
    from repro_torch.distributed.fault_tolerance import StepWatchdog
    from repro_torch.launch.mesh import make_mesh
    eng = ProgressEngine()
    coll = NB.UserCollectives(eng, name="watchdog")
    epoch = NB.MembershipEpoch(n_devices=DP_RANKS)
    clock = {"t": 0.0}
    mesh = make_mesh((DP_RANKS, 1), ("data", "model"), "cuda")
    x = torch.arange(DP_RANKS * 4096, dtype=torch.int32,
                     device="cuda").reshape(DP_RANKS, 4096)
    h = coll.reduce_scatter_init(x, mesh, "data", chunks=DP_CHUNKS,
                                 warmup=False, epoch=epoch)
    hung = []
    wd = StepWatchdog(eng, limit=5.0, clock=lambda: clock["t"], epoch=epoch,
                      on_hang=lambda: hung.append(clock["t"]))
    with no_sync():
        wd.arm()
        req = h.start(x)
        pending = not req.is_complete
        clock["t"] = 6.0
        eng.poll_subsystems()
        eng.poll_subsystems()
        epoch_after = epoch.version
        failed = req.failed and isinstance(req.exception, NB.MembershipError)
        failed_starts = coll.failed
        h.rebuild(mesh)
        out = h.start(x).wait(timeout=60)
    ok = torch.equal(out, x.sum(0).reshape(DP_RANKS, -1))
    coll.close()
    log(f"check: watchdog on a hung step: start pending when it fired "
        f"{pending}, fired {wd.fired} time(s), epoch version {epoch_after}, "
        f"the start failed with MembershipError {failed}, failed starts "
        f"{failed_starts}; rebuilt handle sums {'right' if ok else 'WRONG'}")
    if not (pending and hung and wd.fired == 1 and epoch_after == 1
            and failed and failed_starts == 1 and ok):
        raise AssertionError("the watchdog did not fail the hung start once")


def pipe_inputs() -> tuple:
    """The pipeline checks' stacked parameters ``[S, ...]``, microbatches
    and targets on ``cuda:0`` (the launcher's residual-MLP widths)."""
    from repro_torch.launch import train as train_mod
    S, M, mb = PIPE_S, PIPE_M, PIPE_MB
    d, h = train_mod.PIPE_D_MODEL, train_mod.PIPE_D_HIDDEN
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = {"w1": torch.randn((S, d, h), generator=gen, device="cuda") * .3,
              "w2": torch.randn((S, h, d), generator=gen, device="cuda") * .3}
    xs = torch.randn((M, mb, d), generator=gen, device="cuda")
    ts = torch.randn((M, mb, d), generator=gen, device="cuda")
    return params, xs, ts


def pipe_sequential(sched, params, xs, ts) -> tuple:
    """The sequential reference on the card: the schedule's cells, one
    microbatch at a time, on the default stream; (loss, stacked grads)."""
    S, M = PIPE_S, PIPE_M
    stage = [{k: v[s] for k, v in params.items()} for s in range(S)]
    keys = sorted(params)
    acc = [[torch.zeros_like(stage[s][k]) for k in keys] for s in range(S)]
    scale = torch.tensor(1.0 / M, dtype=torch.float32, device="cuda")
    seq_losses = []
    for m in range(M):
        x, stash = xs[m], []
        for s in range(S - 1):
            stash.append(x)
            x = sched._fwd(stage[s], x)
        lm, dx, acc[S - 1] = sched._last_bwd(stage[S - 1], x, ts[m], scale,
                                             acc[S - 1])
        seq_losses.append(lm)
        for s in range(S - 2, -1, -1):
            dx, acc[s] = sched._bwd(stage[s], stash[s], dx, acc[s])
    seq_loss = seq_losses[0]
    for lm in seq_losses[1:]:
        seq_loss = seq_loss + lm
    return seq_loss * scale, {k: torch.stack([acc[s][i] for s in range(S)])
                              for i, k in enumerate(keys)}


def pipeline_phase() -> None:
    """1F1B at S = 4, M = 8 on 4 stage CUDA streams of the card (the
    launcher's residual-MLP stages): the forward equal to ``gpipe``'s, the
    loss and gradients of ``PIPE_STEPS`` steps bit for bit against the
    sequential per-stage computation on the card, one blocking wait a
    call; the bubble measured from ``last_step_timing`` against
    ``bubble_fraction(4, 8)``.  Then ``launch.train --pipeline 1f1b
    --mesh 2x4`` with the grad reducer over the data axis."""
    from repro_torch.core import ProgressEngine, ProgressExecutor
    from repro_torch.distributed import pipeline as pl
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh
    S, M, mb = PIPE_S, PIPE_M, PIPE_MB
    d, h = train_mod.PIPE_D_MODEL, train_mod.PIPE_D_HIDDEN
    params, xs, ts = pipe_inputs()
    eng = ProgressEngine()
    ex = ProgressExecutor(eng, num_workers=2).start()
    eng.attach_executor(ex)
    sched = pl.PipelineSchedule(
        train_mod.pipe_stage_fn, make_mesh((S,), ("stage",), "cuda"),
        "stage", S, loss_fn=train_mod.pipe_loss_fn, engine=eng, executor=ex,
        name="chip")
    out, bubbles, windows = [], [], []
    with no_sync():
        ys = sched.apply(params, xs, timeout=300)
        for _ in range(PIPE_STEPS):
            out.append(sched.step(params, xs, ts, timeout=300))
            bubbles.append(sched.last_step_timing["bubble"])
            windows.append(sched.last_step_timing["window_s"] * 1e3)
    stats = sched.stats()
    streams = len({id(c) for c in sched.cuda_streams})
    seq_loss, seq_grads = pipe_sequential(sched, params, xs, ts)
    keys = sorted(params)
    exact = all(torch.equal(loss, seq_loss) and all(
        torch.equal(g[k], seq_grads[k]) for k in keys) for loss, g in out)
    gp = pl.gpipe(train_mod.pipe_stage_fn, make_mesh((S,), ("stage",),
                                                     "cuda"), "stage", S)
    gp_same = torch.equal(ys, gp(params, xs))
    sched.close()
    ex.shutdown(drain=True, timeout=120)
    analytic = pl.bubble_fraction(S, M, "1f1b")
    later = bubbles[1:]
    log(f"pipeline 1f1b S={S} M={M} (mb {mb}, d_model {d}, hidden {h}, "
        f"{streams} stage CUDA streams): measured bubble "
        f"{sum(later) / len(later):.4f} (steps 1-{PIPE_STEPS - 1}: "
        f"{[round(b, 4) for b in later]}; step 0 {bubbles[0]:.4f}) vs "
        f"analytic {analytic:.4f}; step window "
        f"{[round(w, 3) for w in windows]} ms; loss and gradients vs "
        f"sequential on the card "
        f"{'bit for bit' if exact else 'NOT bit for bit'} over "
        f"{PIPE_STEPS} steps; forward vs gpipe "
        f"{'bit for bit' if gp_same else 'DIFFERS'}; blocking waits "
        f"{stats['blocking_waits']} for {PIPE_STEPS + 1} calls; hops "
        f"{stats['hop_starts']}, p2p completions "
        f"{stats['p2p_stream_completions']}")
    if not (exact and gp_same and streams == S
            and stats["blocking_waits"] == PIPE_STEPS + 1
            and stats["p2p_issued"] == stats["p2p_completed"] > 0):
        raise AssertionError(f"1f1b on the card failed its checks: {stats}")
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_pipe_")
    try:
        args = train_mod.build_parser().parse_args([
            "--device", "cuda", "--pipeline", "1f1b", "--mesh", "2x4",
            "--devices", "8", "--microbatches", str(M), "--global-batch",
            str(mb), "--steps", "4", "--ckpt-dir", ckpt_dir])
        with no_sync():
            report = train_mod.run(args, log_every=1)
        losses = [m["loss"] for m in report.log]
        steps_ms = [round(m["step_time_s"] * 1e3, 3) for m in report.log]
        waits = [r.blocking_waits for r in report.rows]
        log(f"pipeline launcher --pipeline 1f1b --mesh 2x4: losses "
            f"{[round(v, 6) for v in losses]}, step ms {steps_ms}, reducer "
            f"over data={report.reducer.axis_size} "
            f"({report.reduce_dispatches} dispatch units a step), blocking "
            f"waits per row {waits}")
        if len(losses) != 4 or not all(map(math.isfinite, losses)) \
                or waits != [4, 4] or report.reducer.axis_size != 2:
            raise AssertionError("the 1f1b launcher run failed its checks")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def parallel_phase(single_losses: list, dp_losses: list) -> tuple:
    """Phase 10: FSDP (user and native), the step-0 gather, the elastic
    recovery and the pipeline; returns the FSDP user run's launches and
    losses, and the native run's losses (phase 16's native FSDP run with
    a device per rank is held against them)."""
    launches, report, losses = train_fsdp("user")
    hold_losses("train_fsdp vs the single card", losses, single_losses,
                DP_LOSS_ATOL)
    hold_losses("train_fsdp vs train_dp", losses, dp_losses, FSDP_DP_ATOL)
    fsdp_time_breakdown(report)
    del report
    free()
    _, report, native = train_fsdp("native")
    del report
    free()
    hold_losses("train_fsdp user vs native", losses, native,
                FSDP_NATIVE_ATOL)
    fsdp_gather_check()
    free()
    elastic_phase()
    free()
    pipeline_phase()
    free()
    return launches, losses, native


# ---------------------------------------------------------------------------
# phase 16: a mesh with one device per rank
# ---------------------------------------------------------------------------

DEV_COLL_NS = (2, 4)
DEV_BIG_BYTES = 256 << 20       # each rank's buffer in the timed allreduce
DEV_RESTARTS = 20
DEV_CHAOS_LAYERS, DEV_CHAOS_KILL = 2, 1     # killed after step 1 of 3
DEV_KERNELS = ("rmsnorm_fwd", "rmsnorm_bwd", "flash_attention")


def rank_devices(n: int = DP_RANKS) -> list:
    """Distinct cards ``cuda:0 .. n-1`` on a machine with n or more, else
    ``cuda:0`` listed n times (the ranks then share it)."""
    if torch.cuda.device_count() >= n:
        return [f"cuda:{i}" for i in range(n)]
    return ["cuda:0"] * n


def distinct(devices) -> list:
    """The devices of a list, each once, in order."""
    return list(dict.fromkeys(torch.device(d) for d in devices))


def sync_all(devices) -> None:
    for d in distinct(devices):
        torch.cuda.synchronize(d)


# PyTorch's warning when a gradient reaches a leaf's AccumulateGrad from a
# node on another card's stream
STREAM_MISMATCH = ".*AccumulateGrad node's stream does not match"


@contextlib.contextmanager
def stream_mismatch_errors():
    """PyTorch's stream-mismatch warning made an error for the block."""
    torch.autograd.graph.set_warn_on_accumulate_grad_stream_mismatch(True)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=STREAM_MISMATCH)
        yield


class sync_errors:
    """``torch.cuda.set_sync_debug_mode("error")`` for the block: any
    call that would synchronize a card raises."""

    def __enter__(self):
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)


def devices_collectives(devices) -> None:
    """Every op × algorithm at n ∈ ``DEV_COLL_NS`` ranks on the first n of
    ``devices``, int32, f32 and bf16, chunks {1, 4}, round batch {1,
    auto}, one-shot and persistent: the per-device result equals the
    rank-stacked run of the same case on ``cuda:0`` bit for bit, and
    int32 the plain reference; every run under the sync debug mode
    "error"."""
    from repro_torch.collectives import nonblocking as NB
    from repro_torch.collectives.rank_shards import RankShards
    from repro_torch.core import ProgressEngine
    from repro_torch.launch.mesh import make_mesh
    coll = NB.UserCollectives(ProgressEngine())
    gen = torch.Generator().manual_seed(16)
    runs, t0 = 0, time.perf_counter()
    for n in DEV_COLL_NS:
        smesh = make_mesh((n,), ("x",), "cuda:0")
        dmesh = make_mesh((n,), ("x",), devices=devices[:n])
        for op, alg, shape in coll_cases(n):
            for dt in COLL_DTYPES:
                xc = torch.randint(-8, 8, shape, generator=gen,
                                   dtype=torch.int32) \
                    if dt == torch.int32 else \
                    torch.randn(shape, generator=gen).to(dt)
                x = xc.to("cuda:0")
                xs = RankShards.from_stacked(x, dmesh)
                sync_all(devices)
                for chunks, batch, persistent in itertools.product(
                        COLL_CHUNKS, COLL_BATCHES, (False, True)):
                    with sync_errors():
                        want = run_collective(coll, op, alg, x, smesh,
                                              chunks, batch, persistent)
                        got = run_collective(coll, op, alg, xs, dmesh,
                                             chunks, batch, persistent)
                    case = (f"{op}/{alg} n={n} {dt} chunks={chunks} round "
                            f"batch={batch} persistent={persistent}")
                    if not isinstance(got, RankShards) or [
                            str(d) for d in got.devices] != list(devices[:n]):
                        raise AssertionError(f"{case}: result not on the "
                                             f"ranks' devices")
                    if not torch.equal(got.to_stacked("cuda:0"), want):
                        raise AssertionError(f"{case}: the per-device form "
                                             f"differs from the stacked run")
                    if dt == torch.int32 and not torch.equal(
                            want.cpu(), plain_collective(op, xc, n)):
                        raise AssertionError(f"{case}: not the plain sum")
                    runs += 1
    coll.close()
    log(f"devices: {runs} per-device collective runs ({len(DEV_COLL_NS)} "
        f"rank counts x 9 op/algorithm pairs x 3 dtypes x chunks "
        f"{COLL_CHUNKS} x round batch {COLL_BATCHES} x one-shot/persistent) "
        f"in {time.perf_counter() - t0:.1f} s, each bit for bit against the "
        f"rank-stacked run on cuda:0 (int32 also against the plain "
        f"reference), every run under set_sync_debug_mode('error'); "
        f"{coll.pending_polls} polls found a round running")


def busy_by_device(prof) -> dict:
    """Device index -> ms its kernels and copies kept it busy (the union
    of their intervals) over a profiler run."""
    spans: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.setdefault(e.device_index, []).append(
                (e.time_range.start, e.time_range.end))
    busy = {}
    for d, iv in spans.items():
        merged = []
        for a, b in sorted(iv):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        busy[d] = sum(b - a for a, b in merged) / 1e3
    return busy


def host_top(prof, n: int, top: int = 6) -> str:
    """The host calls that took most of the host's own time over a
    profiler run with CPU activity, in ms per each of ``n`` units."""
    ranked = sorted((e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CPU),
                    key=lambda e: -e.self_cpu_time_total)[:top]
    return "; ".join(f"{e.key} {e.self_cpu_time_total / n / 1e3:.3f} ms "
                     f"({e.count // n} calls)" for e in ranked)


def devices_big_allreduce(devices) -> None:
    """A persistent ring allreduce of ``DEV_BIG_BYTES`` of int32 on each
    rank (4 chunks, per-round dispatch), restarted ``DEV_RESTARTS``
    times: ``memory_allocated`` of every device unchanged, the result the
    plain sum, the time per allreduce (host clock over the restarts,
    every card synchronized at both ends) and, on distinct cards, the
    bus bandwidth as nccl-tests define it, 2(n-1)/n x bytes / time (no
    NCCL or torch.distributed call is made: ``devices_native_allreduce``
    is the native row beside it).  Returns the ms an allreduce."""
    from repro_torch.collectives import nonblocking as NB
    from repro_torch.collectives.rank_shards import RankShards
    from repro_torch.core import ProgressEngine
    from repro_torch.launch.mesh import make_mesh
    n = len(devices)
    mesh = make_mesh((n,), ("x",), devices=devices)
    gen = torch.Generator(device="cuda:0").manual_seed(17)
    x = torch.randint(-8, 8, (n, DEV_BIG_BYTES // 4), generator=gen,
                      device="cuda:0", dtype=torch.int32)
    want = x.sum(0, dtype=torch.int32)
    xs = RankShards.from_stacked(x, mesh)
    del x
    coll = NB.UserCollectives(ProgressEngine())
    h = coll.allreduce_init(xs, mesh, "x", chunks=4, round_batch=1)
    cards = distinct(devices)
    out = h.start(xs).wait(timeout=120)
    del out
    sync_all(devices)
    mem, t0 = [], time.perf_counter()
    for _ in range(DEV_RESTARTS):
        out = h.start(xs).wait(timeout=120)
        mem.append(tuple(torch.cuda.memory_allocated(d) for d in cards))
    sync_all(devices)
    ms = (time.perf_counter() - t0) * 1e3 / DEV_RESTARTS
    for s in out.shards:
        if not torch.equal(s[0].to("cuda:0"), want):
            raise AssertionError("per-device 256 MiB allreduce: not the sum")
    if len(set(mem)) != 1:
        raise AssertionError(f"per-device restarts allocated: {mem}")
    # where the time goes: each card's busy time, and the host's calls
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(2):
            out = h.start(xs).wait(timeout=120)
        sync_all(devices)
        prof_ms = (time.perf_counter() - t1) * 1e3 / 2
    busy = busy_by_device(prof)
    trace_text = (f"under the profiler {prof_ms:.3f} ms an allreduce, device "
                  f"busy " + ", ".join(f"cuda:{d} {v / 2:.3f} ms"
                                       for d, v in sorted(busy.items()))
                  + f"; host's own time: {host_top(prof, 2)}") if busy \
        else "device busy not measured (no profiler events)"
    h.close()
    coll.close()
    if len(cards) == n:
        bus = 2 * (n - 1) / n * DEV_BIG_BYTES / (ms / 1e3) / 1e9
        bw_text = (f"bus bandwidth {bus:.3f} GB/s (2(n-1)/n x "
                   f"{DEV_BIG_BYTES >> 20} MiB / time; NVLink's 450 GB/s a "
                   f"direction is its ceiling)")
    else:
        bw_text = ("no bus bandwidth: the ranks share one card, so every "
                   "hop is a copy within it")
    log(f"devices: persistent ring allreduce of {DEV_BIG_BYTES >> 20} MiB "
        f"int32 a rank over {n} ranks on {devices} (4 chunks, per-round "
        f"dispatch), restarted {DEV_RESTARTS} times: {ms:.3f} ms an "
        f"allreduce; {bw_text}; memory_allocated after every start "
        + ", ".join(f"{d} {m} B" for d, m in zip(cards, mem[0]))
        + f"; the result the plain sum on every rank; {trace_text}")
    return ms


def devices_native_allreduce(devices, user_ms: float) -> None:
    """The native row beside ``devices_big_allreduce``'s: the same
    ``DEV_BIG_BYTES`` of int32 a rank through
    ``native_devices.native_allreduce`` (NCCL where every rank has a card
    of its own, else the sum in rank order on rank 0's card), warmed up
    (the communicator built), then called ``DEV_RESTARTS`` times: ms an
    allreduce (host clock, every card synchronized at both ends), the bus
    bandwidth on distinct cards, ``memory_allocated`` of every card after
    each call unchanged, the result the plain sum on every rank; which
    route ran, NCCL's version and ``torch.cuda.nccl.is_available`` for
    the ranks' tensors."""
    from repro_torch.collectives import native_devices
    from repro_torch.collectives.rank_shards import RankShards
    from repro_torch.launch.mesh import make_mesh
    n = len(devices)
    mesh = make_mesh((n,), ("x",), devices=devices)
    gen = torch.Generator(device="cuda:0").manual_seed(17)
    x = torch.randint(-8, 8, (n, DEV_BIG_BYTES // 4), generator=gen,
                      device="cuda:0", dtype=torch.int32)
    want = x.sum(0, dtype=torch.int32)
    xs = RankShards.from_stacked(x.view(n, -1), mesh).map(lambda t: t[0])
    del x
    cards = distinct(devices)
    route = native_devices.route(mesh.devices)
    available = native_devices.nccl_available(cards)
    version = native_devices.nccl_version() if available else "(none)"
    native_devices.reset_routes()
    native_devices.warm(mesh.devices)
    out = native_devices.native_allreduce(xs)
    sync_all(devices)
    mem, t0 = [], time.perf_counter()
    for _ in range(DEV_RESTARTS):
        out = native_devices.native_allreduce(xs)
        mem.append(tuple(torch.cuda.memory_allocated(d) for d in cards))
    sync_all(devices)
    ms = (time.perf_counter() - t0) * 1e3 / DEV_RESTARTS
    for s in out.shards:
        if not torch.equal(s.to("cuda:0"), want):
            raise AssertionError("native 256 MiB allreduce: not the sum")
    if len(set(mem)) != 1:
        raise AssertionError(f"native allreduce calls allocated: {mem}")
    calls = dict(native_devices.routes)
    if calls[route] != DEV_RESTARTS + 1 or sum(calls.values()) != \
            DEV_RESTARTS + 1:
        raise AssertionError(f"native allreduce routes {calls}, want "
                             f"{DEV_RESTARTS + 1} on {route}")
    del out, xs
    if len(cards) == n:
        bus = 2 * (n - 1) / n * DEV_BIG_BYTES / (ms / 1e3) / 1e9
        bw_text = (f"bus bandwidth {bus:.3f} GB/s (2(n-1)/n x "
                   f"{DEV_BIG_BYTES >> 20} MiB / time)")
    else:
        bw_text = "no bus bandwidth: the ranks share one card"
    path = (f"NCCL {version} (torch.cuda.nccl.all_reduce over the {n} "
            f"cards)" if route == "nccl" else
            "the sum in rank order on rank 0's card (the ranks share it)")
    log(f"devices: native allreduce of {DEV_BIG_BYTES >> 20} MiB int32 a "
        f"rank over {n} ranks on {devices}, route {route}: {path}; "
        f"torch.cuda.nccl.is_available(a tensor on each of {cards}) "
        f"{available}, NCCL {version}; {DEV_RESTARTS} calls after a "
        f"warm-up: {ms:.3f} "
        f"ms an allreduce (the user ring beside it: {user_ms:.3f} ms); "
        f"{bw_text}; memory_allocated after every call "
        + ", ".join(f"{d} {m} B" for d, m in zip(cards, mem[0]))
        + "; the result the plain sum on every rank")


def train_devices(dp_losses: list, devices):
    """``launch.train --rank-devices`` at full smollm-360m width: the run
    of phase 9 (4 ranks, ring, 4 chunks, 3 steps of 8 x 1024 tokens) with
    each rank's replica, gradients and AdamW state on its own device.
    Its losses equal phase 9's bit for bit; the launches are 4 ranks'
    passes; the final replicas equal bit for bit on every device; the
    checkpoint (rank 0's replica) restores equal."""
    import types

    from repro_torch.collectives.rank_shards import RankShards, tree_shard
    from repro_torch.kernels import _lib
    from repro_torch.launch import train as train_mod
    from repro_torch.models.layers import tree_leaves
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train_devices_")
    try:
        args = train_mod.build_parser().parse_args([
            "--arch", TRAIN_ARCH, "--scale", "full", "--device", "cuda",
            "--global-batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--steps", str(TRAIN_STEPS), "--ckpt-dir", ckpt_dir,
            "--devices", str(DP_RANKS), "--mesh", f"{DP_RANKS}x1",
            "--collective-backend", "user", "--collective-algorithm", "ring",
            "--collective-chunks", str(DP_CHUNKS),
            "--rank-devices", ",".join(devices)])
        for d in distinct(devices):
            torch.cuda.reset_peak_memory_stats(d)
        _lib.reset_launches()
        report = train_mod.run(args, log_every=1)
        launches = dict(_lib.launches)
        cfg, tr = report.cfg, report.trainer
        if full_width(cfg) != FULL_WIDTH[TRAIN_ARCH]:
            raise AssertionError(f"not the full {TRAIN_ARCH} width: {cfg}")
        want = {k: v * TRAIN_STEPS for k, v in
                train_mod.kernel_launches_per_step(cfg, DP_RANKS).items()}
        if launches != want:
            raise AssertionError(f"launch counts {launches} != {want}")
        losses = [m["loss"] for m in report.log]
        if losses != dp_losses:
            raise AssertionError(f"per-device losses {losses} differ from "
                                 f"the rank-stacked run's {dp_losses}")
        leaves = [t for _, t in [*tree_leaves(tr.params),
                                 *tree_leaves(tr.opt_state.mu),
                                 *tree_leaves(tr.opt_state.nu)]]
        for t in leaves:
            if not isinstance(t, RankShards) or [
                    str(d) for d in t.devices] != list(devices):
                raise AssertionError(f"a replica off its rank's device: {t}")
            for s in t.shards[1:]:
                if not torch.equal(s.to(t.shards[0].device), t.shards[0]):
                    raise AssertionError("the replicas differ")
        peaks = {str(d): torch.cuda.max_memory_allocated(d) / 2**30
                 for d in distinct(devices)}
        ckpt_text = checkpoint_check(types.SimpleNamespace(
            ckpt=tr.ckpt, params=tree_shard(tr.params, 0),
            opt_state=tree_shard(tr.opt_state, 0)), TRAIN_STEPS - 1)
        steps_s = [m["step_time_s"] for m in report.log[1:]]
        mean_s = sum(steps_s) / len(steps_s)
        issue = tr.reduce_issue_s[1:]
        log(f"train_devices {TRAIN_ARCH} ({DP_RANKS} ranks on {devices}, "
            f"ring, {DP_CHUNKS} chunks): launches {launches} (4 ranks' "
            f"passes); losses {[round(v, 6) for v in losses]}, bit for bit "
            f"those of the rank-stacked run (phase 9); the {len(leaves)} "
            f"replicated leaves equal on every device; mean step "
            f"{mean_s * 1e3:.3f} ms (steps 1-{TRAIN_STEPS - 1}; step 0 "
            f"{report.log[0]['step_time_s'] * 1e3:.3f} ms), "
            f"{TRAIN_BATCH * TRAIN_SEQ / mean_s:.1f} tokens/s; reducer "
            f"{report.reduce_dispatches} dispatch units a step, host time "
            f"to issue {sum(issue) / len(issue) * 1e3:.3f} ms a step; "
            f"{ckpt_text} (rank 0's replica); peak device memory "
            + ", ".join(f"{d} {v:.2f} GiB" for d, v in peaks.items()))
        return launches, report
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


class DeviceLaunches(dict):
    """``_lib.launches`` that also files each increment under the current
    CUDA device: a wrapper counts its launch with its kernel's card
    current (``_lib.stream_of`` refuses any other), on the host thread or
    autograd's device thread.  The profiler's kernel events name the
    device too, but a long trace can drop a few of them."""

    def __init__(self, base):
        super().__init__(base)
        self.by_device: dict = {}

    def __setitem__(self, name, value):
        added = value - self.get(name, 0)
        if added > 0:
            key = (torch.cuda.current_device(), name)
            self.by_device[key] = self.by_device.get(key, 0) + added
        super().__setitem__(name, value)


def kernel_of(name: str) -> str | None:
    """Which of ``DEV_KERNELS`` a device event's kernel belongs to."""
    if "repro_torch::" not in name:
        return None
    for k in DEV_KERNELS:
        if k in name:
            return k
    return None


def devices_time_breakdown(report, devices, steps: int = 1) -> None:
    """``steps`` per-device data-parallel steps on the trained replicas
    and one fixed batch (the launcher's split step: rank gradients, the
    reducer, AdamW on each replica): host wall clock unprofiled; per
    device the port's kernel launches (``DeviceLaunches``: each must be
    its ranks' share of a single-card step's; the profiler's count of
    them beside it) and, from the profiler, busy ms and idle share."""
    from repro_torch.collectives.overlap import EngineGradReducer
    from repro_torch.core import ProgressEngine
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import _lib
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import optimizer as opt_mod
    tr, cfg = report.trainer, report.cfg
    ocfg = opt_mod.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=10)
    mesh = make_mesh((DP_RANKS, 1), ("data", "model"), devices=devices)
    reducer = EngineGradReducer(mesh, "data", engine=ProgressEngine(),
                                chunks=DP_CHUNKS)
    grad_fn = train_mod.make_rank_grads(cfg, DP_RANKS, mesh=mesh)
    apply_fn = train_mod._apply_per_device(ocfg)
    batch = {k: torch.from_numpy(v.copy()).pin_memory() for k, v in
             SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=9)
             .sample().items()}
    state = {"p": tr.params, "o": tr.opt_state}

    def run(k=steps):
        t0 = time.perf_counter()
        for _ in range(k):
            mets, g = grad_fn(state["p"], batch)
            grads = reducer.iallreduce_tree(g).wait(timeout=600)
            del g
            state["p"], state["o"], _ = apply_fn(state["p"], state["o"],
                                                 grads, mets)
            del grads
        sync_all(devices)
        return (time.perf_counter() - t0) * 1e3 / k

    wall = run()
    base, counter = _lib.launches, DeviceLaunches(_lib.launches)
    _lib.launches = counter
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            wall_prof = run()
    finally:
        _lib.launches = base
        for k, v in counter.items():
            base[k] = v
    # the reducer's issue on the host (its 8-36 dispatch units a bucket)
    _, g = grad_fn(state["p"], batch)
    sync_all(devices)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as host_prof:
        reduction = reducer.iallreduce_tree(g)
    issue_ms = reduction.issue_s * 1e3
    reduction.wait(timeout=600)
    del g, reduction
    reducer.close()
    counts = {}
    for e in prof.events():
        k = kernel_of(e.name) \
            if e.device_type == torch.autograd.DeviceType.CUDA else None
        if k is not None:
            key = (e.device_index, k)
            counts[key] = counts.get(key, 0) + 1
    busy_all = busy_by_device(prof)
    single = train_mod.kernel_launches_per_step(cfg)
    if not busy_all:
        log(f"time: train_devices step wall {wall:.3f} ms; per-device "
            f"launches, busy time and idle not measured (no profiler "
            f"events)")
        return
    parts = []
    for d in distinct(devices):
        ranks = sum(torch.device(x) == d for x in devices)
        got = {k: counter.by_device.get((d.index, k), 0) / steps
               for k in DEV_KERNELS}
        want = {k: single[k] * ranks for k in DEV_KERNELS}
        if got != want:
            raise AssertionError(f"{d}: launches a step {got}, want {want} "
                                 f"({ranks} rank(s) x a single-card step)")
        seen = sum(counts.get((d.index, k), 0) for k in DEV_KERNELS)
        busy = busy_all.get(d.index, 0.0) / steps
        parts.append(f"{d}: {ranks} rank(s), launches a step "
                     f"{ {k: int(v) for k, v in got.items()} } (= {ranks} x "
                     f"a single-card step's; the profiler's events name "
                     f"{seen} of their {int(sum(got.values())) * steps}), "
                     f"device busy {busy:.3f} ms, idle share "
                     f"{1 - busy / wall_prof:.3f}")
    log(f"time: train_devices step ({TRAIN_ARCH}, {DP_RANKS} ranks on "
        f"{devices}, {TRAIN_BATCH}x{TRAIN_SEQ} tokens): wall {wall:.3f} ms "
        f"({wall_prof:.3f} ms under the profiler); " + "; ".join(parts)
        + f"; the reducer's issue {issue_ms:.3f} ms on the host (under the "
        f"profiler), its own time led by: {host_top(host_prof, 1)}")


def devices_chaos(devices) -> None:
    """``--elastic --chaos-kill 1 --chaos-kill-step DEV_CHAOS_KILL`` at
    full width and ``DEV_CHAOS_LAYERS`` layers, rank-stacked and per
    device: one remesh each (3 survivors: the JAX package's plan_mesh
    takes a mesh of 2, on the first 2 surviving devices), the losses
    equal bit for bit."""
    import contextlib
    import io

    from repro_torch.launch import train as train_mod
    from repro_torch.launch.serve import make_config
    cfg = make_config(TRAIN_ARCH, "full").with_overrides(
        num_layers=DEV_CHAOS_LAYERS)
    out = {}
    for name, extra in (("stacked", []),
                        ("per-device", ["--rank-devices",
                                        ",".join(devices)])):
        ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_devices_chaos_")
        try:
            args = train_mod.build_parser().parse_args([
                "--arch", TRAIN_ARCH, "--scale", "full", "--device", "cuda",
                "--global-batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                "--steps", str(TRAIN_STEPS), "--ckpt-dir", ckpt_dir,
                "--devices", str(DP_RANKS), "--mesh", f"{DP_RANKS}x1",
                "--collective-backend", "user", "--collective-chunks",
                str(DP_CHUNKS), "--elastic", "--chaos-kill", "1",
                "--chaos-kill-step", str(DEV_CHAOS_KILL)] + extra)
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                report = train_mod.run(args, config=cfg, log_every=1)
            lines = [ln for ln in text.getvalue().splitlines()
                     if ln.startswith(("chaos:", "remesh:"))]
            out[name] = ([m["loss"] for m in report.log], lines,
                         report.trainer.recoveries, report.reducer.mesh,
                         [m["step_time_s"] * 1e3 for m in report.log])
            del report
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        free()
    (a, la, ra, _, _), (b, lb, rb, mesh, ms) = out["stacked"], \
        out["per-device"]
    if a != b or not ra == rb == 1 or len(a) != TRAIN_STEPS:
        raise AssertionError(f"chaos: per-device {b} ({rb} recoveries) vs "
                             f"stacked {a} ({ra})")
    log(f"devices: chaos kill of 1 of {DP_RANKS} ranks at step "
        f"{DEV_CHAOS_KILL} ({DEV_CHAOS_LAYERS} layers, full width): "
        f"{' / '.join(lb)}; recovered onto {mesh}; losses "
        f"{[round(v, 6) for v in b]}, bit for bit the rank-stacked chaos "
        f"run's; step ms {[round(v, 3) for v in ms]}")


def native_step_breakdown(report, devices, what: str) -> str:
    """One more step of a native run with a device per rank (the
    Trainer's own ``step_fn`` on its trained state and one fixed batch)
    under the profiler: its host wall and each card's busy ms and idle
    share; the text that says so."""
    from repro_torch.data.pipeline import SyntheticLM
    tr, cfg = report.trainer, report.cfg
    batch = {k: torch.from_numpy(v.copy()).pin_memory() for k, v in
             SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=9)
             .sample().items()}

    def run() -> float:
        sync_all(devices)
        t0 = time.perf_counter()
        tr.params, tr.opt_state, _ = tr.step_fn(tr.params, tr.opt_state,
                                                batch)
        sync_all(devices)
        return (time.perf_counter() - t0) * 1e3

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        wall_prof = run()
    busy = busy_by_device(prof)
    if not busy:
        return (f"{what} step under the profiler {wall_prof:.3f} ms; busy "
                f"and idle a card not measured (no profiler events)")
    return (f"{what} step under the profiler {wall_prof:.3f} ms; "
            + "; ".join(
                f"cuda:{d} busy {v:.3f} ms, idle share "
                f"{1 - v / wall_prof:.3f}" for d, v in sorted(busy.items())))


def mean_step_ms(report) -> float:
    steps = [m["step_time_s"] for m in report.log[1:]]
    return sum(steps) * 1e3 / len(steps)


def native_route_text(devices, calls: dict, want: int) -> str:
    """The route the native collectives of ``devices`` took, held to
    ``want`` calls on it and none on the other; the text that says so."""
    from repro_torch.collectives import native_devices
    route = native_devices.route(devices)
    if calls[route] != want or sum(calls.values()) != want:
        raise AssertionError(f"native collectives' routes {calls}, want "
                             f"{want} on {route}")
    return (f"every reduction through NCCL {native_devices.nccl_version()} "
            f"({want} calls)" if route == "nccl" else
            f"every reduction the sum in rank order on rank 0's card ({want} "
            f"calls; the ranks share it)")


def train_native_devices(dp_losses: list, user_ms: float, devices):
    """``launch.train --collective-backend native --rank-devices`` at full
    smollm-360m width: phase 9's run (4 ranks, ``TRAIN_STEPS`` steps of 8 x
    1024 tokens) with each rank's replica, gradients and AdamW state on
    its device and the gradients' mean through
    ``native_devices.native_allreduce`` inside the step (NCCL on distinct
    cards, the sum in rank order on cuda:0 where the ranks share it).  Its
    losses within ``DP_LOSS_ATOL`` of phase 9's; every card's replica equal
    bit for bit; each card launches its ranks' single-card passes; the
    route logged; step ms and idle a card beside the user run's
    (``user_ms``, ``train_devices``).  Returns the launches."""
    from repro_torch.collectives import native_devices
    from repro_torch.collectives.rank_shards import RankShards
    from repro_torch.launch import train as train_mod
    from repro_torch.models.layers import tree_leaves
    native_devices.reset_routes()
    report, launches, counter, peaks, _ = train_counted([
        "--arch", TRAIN_ARCH, "--scale", "full", "--global-batch",
        str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--steps",
        str(TRAIN_STEPS), "--devices", str(DP_RANKS), "--mesh",
        f"{DP_RANKS}x1", "--collective-backend", "native",
        "--rank-devices", ",".join(devices)], None, devices, saves=False)
    calls = dict(native_devices.routes)
    cfg, tr = report.cfg, report.trainer
    if full_width(cfg) != FULL_WIDTH[TRAIN_ARCH]:
        raise AssertionError(f"not the full {TRAIN_ARCH} width: {cfg}")
    single = train_mod.kernel_launches_per_step(cfg)
    want = {k: v * DP_RANKS * TRAIN_STEPS for k, v in single.items()}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    card_text = per_card_launches(counter, devices, TRAIN_STEPS,
                                  {k: single[k] for k in DEV_KERNELS},
                                  "step")
    losses = [m["loss"] for m in report.log]
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"bad loss trajectory {losses}")
    hold_losses("train_native_devices vs train_dp (phase 9)", losses,
                dp_losses, DP_LOSS_ATOL)
    leaves = [t for _, t in [*tree_leaves(tr.params),
                             *tree_leaves(tr.opt_state.mu),
                             *tree_leaves(tr.opt_state.nu)]]
    for t in leaves:
        if not isinstance(t, RankShards) or [
                str(d) for d in t.devices] != list(devices):
            raise AssertionError(f"a replica off its rank's device: {t}")
        for s in t.shards[1:]:
            if not torch.equal(s.to(t.shards[0].device), t.shards[0]):
                raise AssertionError("the native replicas differ")
    route_text = native_route_text(
        devices, calls, TRAIN_STEPS * len(leaves) // 3)
    ms = mean_step_ms(report)
    breakdown = native_step_breakdown(report, devices, "one more native")
    log(f"train_native_devices {TRAIN_ARCH} ({DP_RANKS} ranks on "
        f"{devices}, native backend): {route_text}; launches {launches}; "
        f"a step on each card: {card_text}; losses "
        f"{[round(v, 6) for v in losses]}; the {len(leaves)} replicated "
        f"leaves equal on every device; mean step {ms:.3f} ms (the user "
        f"run's {user_ms:.3f}), {TRAIN_BATCH * TRAIN_SEQ / ms * 1e3:.1f} "
        f"tokens/s; {breakdown}; peak device memory "
        + per_card(distinct(devices), peaks, " GiB", ".2f"))
    del report
    free()
    return launches


DEV_FSDP_STEPS = TRAIN_STEPS   # the per-device FSDP runs (as phase 10's)
DEV_SERVE_LAYERS = 2        # the per-device serve runs' depth (of 24)


def per_card_launches(counter, devices, steps: int, per_rank: dict,
                      what: str) -> str:
    """Each card's launches (``DeviceLaunches``) a step or call held to its
    ranks' share, ``per_rank`` each; the text that says so."""
    parts = []
    for d in distinct(devices):
        ranks = sum(torch.device(x) == d for x in devices)
        got = {k: counter.by_device.get((d.index, k), 0) / steps
               for k in per_rank}
        want = {k: v * ranks for k, v in per_rank.items()}
        if got != want:
            raise AssertionError(f"{d}: launches a {what} {got}, want "
                                 f"{want} ({ranks} rank(s))")
        parts.append(f"{d} {ranks} rank(s) "
                     f"{ {k: int(v) for k, v in got.items()} }")
    return "; ".join(parts)


def counting_by_device():
    """Swap ``_lib.launches`` for a ``DeviceLaunches``; returns (base,
    counter) for ``restore_counts``."""
    from repro_torch.kernels import _lib
    base, counter = _lib.launches, DeviceLaunches(_lib.launches)
    _lib.launches = counter
    return base, counter


def restore_counts(base, counter) -> None:
    from repro_torch.kernels import _lib
    _lib.launches = base
    for k, v in counter.items():
        base[k] = v


def train_fsdp_devices(fsdp_losses: list, devices):
    """``launch.train --fsdp --rank-devices`` at full smollm-360m width:
    phase 10's user run (4 ranks, 4 MiB buckets, ring, 4 chunks, 8 x 1024
    tokens) for ``DEV_FSDP_STEPS`` steps with rank r's blocks, moments,
    step counter and pass on ``devices[r]``, under ``no_sync``.  Its
    losses equal phase 10's first ones bit for bit (the same schedule:
    ``total_steps`` is at least 10 in both); each card launches its ranks'
    share of a single-card step (the wrappers' counts filed by current
    card); the checkpoint restores equal, and ``reshard_restore`` of it
    onto the per-device mesh gives each card its ZeRO block."""
    from repro_torch.collectives.rank_shards import RankShards
    from repro_torch.distributed import elastic
    from repro_torch.kernels import _lib
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.checkpoint import AsyncCheckpointer
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_fsdp_devices_")
    try:
        args = train_mod.build_parser().parse_args([
            "--arch", TRAIN_ARCH, "--scale", "full", "--device", "cuda",
            "--global-batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--steps", str(DEV_FSDP_STEPS), "--ckpt-dir", ckpt_dir,
            "--devices", str(DP_RANKS), "--mesh", f"{DP_RANKS}x1", "--fsdp",
            "--fsdp-bucket-bytes", str(FSDP_BUCKET),
            "--collective-backend", "user", "--collective-algorithm", "ring",
            "--collective-chunks", str(DP_CHUNKS),
            "--rank-devices", ",".join(devices)])
        cards = distinct(devices)
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
        _lib.reset_launches()
        base, counter = counting_by_device()
        try:
            with no_sync():
                report = train_mod.run(args, log_every=1)
        finally:
            restore_counts(base, counter)
        launches = dict(_lib.launches)
        cfg, tr = report.cfg, report.trainer
        if full_width(cfg) != FULL_WIDTH[TRAIN_ARCH]:
            raise AssertionError(f"not the full {TRAIN_ARCH} width: {cfg}")
        single = train_mod.kernel_launches_per_step(cfg)
        want = {k: v * DP_RANKS * DEV_FSDP_STEPS for k, v in single.items()}
        if launches != want:
            raise AssertionError(f"launch counts {launches} != {want}")
        card_text = per_card_launches(
            counter, devices, DEV_FSDP_STEPS,
            {k: single[k] for k in DEV_KERNELS}, "step")
        losses = [m["loss"] for m in report.log]
        if losses != fsdp_losses[:DEV_FSDP_STEPS]:
            raise AssertionError(f"per-device FSDP losses {losses} differ "
                                 f"from the rank-stacked run's "
                                 f"{fsdp_losses[:DEV_FSDP_STEPS]}")
        for t in [*tr.params, *tr.opt_state.mu, *tr.opt_state.nu]:
            if not isinstance(t, RankShards) or t.replica or [
                    str(d) for d in t.devices] != list(devices):
                raise AssertionError(f"a block off its rank's device: {t}")
        if not tr.opt_state.step.replica:
            raise AssertionError("the step counters are not replicas")
        peaks = {str(d): torch.cuda.max_memory_allocated(d) / 2**30
                 for d in cards}
        ckpt_text = checkpoint_check(tr, DEV_FSDP_STEPS - 1)
        # reshard_restore of that checkpoint's flat stacks onto the
        # per-device mesh: the spec splits the rank dim over "data", so
        # each card gets its ZeRO block
        mesh = make_mesh((DP_RANKS, 1), ("data", "model"), devices=devices)
        like = {"params": [torch.empty(p.shape, dtype=p.dtype, device="meta")
                           for p in tr.params]}
        axes = {"params": [("batch", None)] * len(tr.params)}
        t0 = time.perf_counter()
        got, specs = elastic.reshard_restore(
            AsyncCheckpointer(tr.ckpt.dir, tr.ckpt.engine),
            DEV_FSDP_STEPS - 1, like, axes, mesh)
        reshard_s = time.perf_counter() - t0
        if any(sp != ("data",) for sp in specs["params"]) or not all(
                same(a, b) for a, b in zip(got["params"], tr.params)):
            raise AssertionError("reshard_restore placed other blocks")
        del got
        steps_s = [m["step_time_s"] for m in report.log[1:]]
        mean_s = sum(steps_s) / len(steps_s)
        red = report.reducer
        log(f"train_fsdp_devices {TRAIN_ARCH} ({DP_RANKS} ranks on "
            f"{devices}, {FSDP_BUCKET >> 20} MiB buckets, ring, {DP_CHUNKS} "
            f"chunks, under no_sync): launches {launches}; a step on each "
            f"card: {card_text}; losses {[round(v, 6) for v in losses]}, "
            f"bit for bit phase 10's first {DEV_FSDP_STEPS}; mean step "
            f"{mean_s * 1e3:.3f} ms (steps 1-{DEV_FSDP_STEPS - 1}; step 0 "
            f"{report.log[0]['step_time_s'] * 1e3:.3f} ms), "
            f"{TRAIN_BATCH * TRAIN_SEQ / mean_s:.1f} tokens/s; prefetch "
            f"overlap {red.prefetch_overlap:.3f} over {red.gathers} chained "
            f"gathers, {report.reduce_dispatches} dispatch units a step; "
            f"{ckpt_text} ({report.layout.num_buckets} buckets of blocks, "
            f"the stacked run's files); reshard_restore of it onto {mesh}: "
            f"each card its block, in {reshard_s:.3f} s; peak device "
            f"memory " + ", ".join(f"{d} {v:.2f} GiB"
                                   for d, v in peaks.items()))
        return launches, report
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def train_fsdp_native_devices(fsdp_native: list, devices):
    """``launch.train --fsdp --collective-backend native --rank-devices``
    at full smollm-360m width: phase 10's native run (4 ranks, 4 MiB
    buckets, 8 x 1024 tokens) for ``DEV_FSDP_STEPS`` steps with rank r's
    blocks, moments, step counter and pass on ``devices[r]``, the pair of
    ``native_devices`` (all-gather, reduce-scatter) inside the step.  Its
    losses within ``FSDP_NATIVE_ATOL`` of phase 10's native ones
    (``fsdp_native``; whether bit for bit is logged: the ordered route's
    sum is the stacked ``rs_fn``'s sum when every rank is on one card);
    the blocks on their ranks' devices; each card launches its ranks'
    share of a single-card step; the route logged; step ms and idle a
    card.  Returns the launches."""
    from repro_torch.collectives import native_devices
    from repro_torch.collectives.rank_shards import RankShards
    from repro_torch.launch import train as train_mod
    native_devices.reset_routes()
    report, launches, counter, peaks, _ = train_counted([
        "--arch", TRAIN_ARCH, "--scale", "full", "--global-batch",
        str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--steps",
        str(DEV_FSDP_STEPS), "--devices", str(DP_RANKS), "--mesh",
        f"{DP_RANKS}x1", "--fsdp", "--fsdp-bucket-bytes", str(FSDP_BUCKET),
        "--collective-backend", "native", "--rank-devices",
        ",".join(devices)], None, devices, saves=False)
    calls = dict(native_devices.routes)
    cfg, tr = report.cfg, report.trainer
    if full_width(cfg) != FULL_WIDTH[TRAIN_ARCH]:
        raise AssertionError(f"not the full {TRAIN_ARCH} width: {cfg}")
    single = train_mod.kernel_launches_per_step(cfg)
    want = {k: v * DP_RANKS * DEV_FSDP_STEPS for k, v in single.items()}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    card_text = per_card_launches(counter, devices, DEV_FSDP_STEPS,
                                  {k: single[k] for k in DEV_KERNELS},
                                  "step")
    losses = [m["loss"] for m in report.log]
    want_losses = fsdp_native[:DEV_FSDP_STEPS]
    if len(losses) != DEV_FSDP_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"bad loss trajectory {losses}")
    hold_losses("train_fsdp_native_devices vs train_fsdp native (phase 10)",
                losses, want_losses, FSDP_NATIVE_ATOL)
    for t in [*tr.params, *tr.opt_state.mu, *tr.opt_state.nu]:
        if not isinstance(t, RankShards) or t.replica or [
                str(d) for d in t.devices] != list(devices):
            raise AssertionError(f"a block off its rank's device: {t}")
    route_text = native_route_text(
        devices, calls, 2 * DEV_FSDP_STEPS * report.layout.num_buckets)
    ms = mean_step_ms(report)
    breakdown = native_step_breakdown(report, devices, "one more native")
    log(f"train_fsdp_native_devices {TRAIN_ARCH} ({DP_RANKS} ranks on "
        f"{devices}, {report.layout.num_buckets} buckets of "
        f"{FSDP_BUCKET >> 20} MiB, native backend): {route_text}; launches "
        f"{launches}; a step on each card: {card_text}; losses "
        f"{[round(v, 6) for v in losses]} (phase 10's native "
        f"{[round(v, 6) for v in want_losses]}: bit for bit "
        f"{losses == want_losses}); mean step {ms:.3f} ms, "
        f"{TRAIN_BATCH * TRAIN_SEQ / ms * 1e3:.1f} tokens/s; {breakdown}; "
        f"peak device memory "
        + per_card(distinct(devices), peaks, " GiB", ".2f"))
    del report
    free()
    return launches


def fsdp_devices_breakdown(report, devices, steps: int = 1,
                           shape: tuple = (DP_RANKS, 1)) -> None:
    """One per-device FSDP step on the trained blocks and one fixed batch,
    as the Trainer runs it (gather waited, each rank's pass on its card,
    reduce-scatter, AdamW on each card's blocks, the next gather chained
    off the optimizer's compute futures), under the profiler: each card's
    busy ms and idle share, beside the Trainer's unprofiled mean step;
    the prefetch overlap.  ``shape`` is the (data, model) mesh: on a model
    axis the passes and collectives run on the data axis's leaders and
    every copy of a block steps on its card."""
    from repro_torch.collectives.overlap import FsdpReducer
    from repro_torch.core import ProgressEngine
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import optimizer as opt_mod
    tr, cfg = report.trainer, report.cfg
    mesh = make_mesh(shape, ("data", "model"), devices=devices)
    ocfg = opt_mod.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=10)
    grad_fn, apply_fn, _, _ = train_mod.build_fsdp_programs(
        cfg, ocfg, mesh, report.layout)
    red = FsdpReducer(mesh, "data", engine=ProgressEngine(),
                      chunks=DP_CHUNKS, bucket_bytes=FSDP_BUCKET)
    batch = {k: torch.from_numpy(v.copy()).pin_memory() for k, v in
             SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=9)
             .sample().items()}
    state = {"s": tr.params, "o": tr.opt_state, "g": None}

    def run(k=steps):
        t0 = time.perf_counter()
        for _ in range(k):
            pending = state["g"] or red.igather(state["s"])
            flats = pending.wait(timeout=600)
            smets, fg = grad_fn(flats, batch)
            del flats
            gs = red.ireduce_scatter(fg).wait(timeout=600)
            del fg
            state["s"], state["o"], _ = apply_fn(state["s"], state["o"], gs,
                                                 smets)
            del gs
            state["g"] = red.igather(state["s"], after=[
                red.future(sh) for sh in state["s"]])
        state["g"].wait(timeout=600)
        sync_all(devices)
        return (time.perf_counter() - t0) * 1e3 / k

    steps_s = [m["step_time_s"] for m in report.log[1:]]
    wall = sum(steps_s) * 1e3 / len(steps_s)     # the Trainer's, unprofiled
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        wall_prof = run()
    overlap = red.prefetch_overlap
    red.close()
    busy = busy_by_device(prof)
    if not busy:
        log(f"time: fsdp_devices step wall {wall:.3f} ms; per-device busy "
            f"and idle not measured (no profiler events)")
        return
    log(f"time: fsdp_devices step ({TRAIN_ARCH}, {cfg.num_layers} layers, "
        f"mesh {shape[0]}x{shape[1]} on {devices}, {TRAIN_BATCH}x{TRAIN_SEQ} "
        f"tokens): the Trainer's mean "
        f"step {wall:.3f} ms ({wall_prof:.3f} ms a step under the "
        f"profiler); "
        + "; ".join(f"cuda:{d} busy {v / steps:.3f} ms, idle share "
                    f"{1 - v / steps / wall_prof:.3f}"
                    for d, v in sorted(busy.items()))
        + f"; prefetch overlap {overlap:.3f}")


def fsdp_devices_chaos(devices) -> None:
    """FSDP at full width and ``DEV_CHAOS_LAYERS`` layers with a device per
    rank: 2 of 4 ranks killed after step ``ELASTIC_KILL`` - 1, the
    survivors on the first 2 devices, against a restart there (phase 10's
    ``elastic_run``): bit for bit when two identical restarts agree bit
    for bit, else within ``ELASTIC_LOSS_ATOL``."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.serve import make_config
    from repro_torch.models import registry
    from repro_torch.train import optimizer as opt_mod
    cfg = make_config(TRAIN_ARCH, "full").with_overrides(
        num_layers=DEV_CHAOS_LAYERS)
    ocfg = opt_mod.AdamWConfig(lr=3e-3, warmup_steps=2,
                               total_steps=ELASTIC_STEPS)
    it = iter(SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=5))
    batches = [{k: torch.from_numpy(v.copy()).cuda()
                for k, v in next(it).items()} for _ in range(ELASTIC_STEPS)]
    params0 = registry.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    kw = dict(devices=devices)
    ref1 = elastic_run(True, cfg, ocfg, params0, batches, chaos=False, **kw)
    ref2 = elastic_run(True, cfg, ocfg, params0, batches, chaos=False, **kw)
    free()
    chaos = elastic_run(True, cfg, ocfg, params0, batches, chaos=True, **kw)
    same_refs = ref1[0] == ref2[0] and all(
        torch.equal(a, b) for a, b in zip(ref1[1], ref2[1]))
    exact = chaos[0] == ref1[0] and all(
        torch.equal(a, b) for a, b in zip(chaos[1], ref1[1]))
    info = chaos[2]
    log(f"devices: fsdp chaos kill of 2 of {DP_RANKS} ranks at step "
        f"{ELASTIC_KILL} of {ELASTIC_STEPS} ({DEV_CHAOS_LAYERS} layers, full "
        f"width, {devices} -> {devices[:2]}): 1 recovery, "
        f"{info['failed_starts']} in-flight start(s) failed, remesh + "
        f"re-shard {info['remesh_ms']:.3f} ms; two identical restarts "
        f"{'agree' if same_refs else 'differ'} bit for bit; chaos vs "
        f"restart losses {[round(v, 6) for v in chaos[0]]}, "
        f"{'bit for bit' if exact else 'not bit for bit'}")
    if same_refs and not exact:
        raise AssertionError("per-device fsdp chaos differs from a "
                             "deterministic restart")
    if not same_refs:
        hold_losses("per-device fsdp chaos vs restart", chaos[0], ref1[0],
                    ELASTIC_LOSS_ATOL)


def serve_devices(stacked: list, devices) -> dict:
    """qwen2-0.5b, full width at ``DEV_SERVE_LAYERS`` layers, on 4 model
    ranks with a card a rank (16 requests through 8 lanes, as phase 11):
    the user backend (ring, ``SHARD_CHUNKS`` chunks; the main path, its
    launches returned) and the native one, bit for bit, one gather start
    a step; both against phase 11's stacked caller-driven streams at this
    depth (``stacked``): bit for bit, else the share of agreeing tokens,
    held to ``SHARD_TOKEN_SHARE``.  Then the recovery mid decode, 4 -> 2
    ranks on the user backend (``devices_recovery``)."""
    from repro_torch.collectives.rank_shards import RankShards, tree_shard
    from repro_torch.models.layers import tree_leaves
    flags = ("--rank-devices", ",".join(devices))
    out, launches, params, cfg = {}, None, None, None
    for backend in ("user", "native"):
        with no_sync() if backend == "user" else contextlib.nullcontext():
            n_launch, srv, report = serve(
                workers=0, extra=sharded_flags(SHARDS, backend) + flags,
                num_layers=DEV_SERVE_LAYERS)
        check_sharded(report, SHARDS, backend)
        for path, t in [*tree_leaves(srv.params),
                        *tree_leaves(srv.slots.cache)]:
            if not isinstance(t, RankShards) or [
                    str(d) for d in t.devices] != list(devices):
                raise AssertionError(f"{path}: not a replica a rank: {t}")
        out[backend] = streams(report)
        if backend == "user":
            launches = n_launch
            cfg, params = srv.cfg, tree_shard(srv.params, 0)
        del srv, report
        free()
    share = token_share(out["user"], stacked)
    log(f"check: per-device sharded serve {ARCH} ({DEV_SERVE_LAYERS} "
        f"layers) on {devices}: user == native bit for bit "
        f"{out['user'] == out['native']}; against phase 11's stacked "
        f"streams {'bit for bit' if out['user'] == stacked else 'not bit for bit'}"
        f", {share:.4f} of the greedy tokens agree (limit "
        f"{SHARD_TOKEN_SHARE})")
    if out["user"] != out["native"]:
        raise AssertionError("per-device user and native streams differ")
    if share < SHARD_TOKEN_SHARE:
        raise AssertionError("per-device streams off the stacked ones")
    devices_recovery(cfg, params, devices)
    return launches


def devices_recovery(cfg, params, devices) -> None:
    """A membership change mid decode, 4 -> 2 ranks, on the user backend
    with a device per rank, held as ``recovery_phase`` holds its cases:
    lanes restored, not replayed, into the pool replica of both
    surviving cards (which end equal), the mesh on the first 2."""
    from repro_torch.collectives.nonblocking import MembershipEpoch
    from repro_torch.models.layers import tree_leaves
    rs = np.random.RandomState(11)
    lo, hi = RECOVERY_PROMPT
    prompts = [rs.randint(1, cfg.vocab_size - 1, size=rs.randint(lo, hi + 1))
               .astype(np.int32) for _ in range(RECOVERY_REQUESTS)]
    kw = dict(n=SHARDS, devices=devices)
    with no_sync():
        ref, _, _, _ = direct_serve(cfg, params, prompts, **kw)
        moved, _, _, _ = direct_serve(cfg, params, prompts, reverse=True,
                                      **kw)
        epoch = MembershipEpoch(n_devices=SHARDS)
        got, srv, lat, kill_ms = direct_serve(
            cfg, params, prompts, epoch=epoch, survivors=2,
            kill=lambda srv, reqs: sum(len(r.out_tokens)
                                       for r in reqs) >= 5, **kw)
    exact = moved == ref
    share = token_share(got, ref)
    equal = all(torch.equal(t[0], t[1].to(t[0].device))
                for _, t in tree_leaves(srv.slots.cache))
    log(f"check: per-device recovery mid decode -> 2 ranks "
        f"({DEV_SERVE_LAYERS} layers): remeshes {srv.remeshes}, mesh "
        f"{srv.mesh}, lanes checkpointed {srv.lanes_checkpointed}, "
        f"restored {srv.lanes_restored} into both survivors' pools (equal "
        f"at the end: {equal}), {lat.completed} completed, {lat.failed} "
        f"failed; rebuild {srv.recovery_s[0] * 1e3:.3f} ms, kill to idle "
        f"{kill_ms:.1f} ms; {share:.4f} of the tokens agree with the run "
        f"without failure (lanes moved between slots agree bit for bit: "
        f"{exact})")
    if srv.remeshes != 1 or not srv.lanes_restored or not equal or [
            str(d) for d in srv.mesh.devices] != list(devices[:2]):
        raise AssertionError("per-device recovery: not restored on both "
                             "survivors")
    if (got != ref) if exact else share < RECOVERY_TOKEN_SHARE:
        raise AssertionError("per-device recovery: streams differ")


def busy_by_stream(prof) -> tuple[dict, dict]:
    """(device index, stream) -> busy ms (the union of its events'
    intervals), and -> "compute" (it ran a GEMM) or "collective"."""
    spans, names = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            key = (e.device_index, e.device_resource_id)
            spans.setdefault(key, []).append((e.time_range.start,
                                              e.time_range.end))
            names.setdefault(key, set()).add(e.name.lower())
    busy = {}
    for key, iv in spans.items():
        merged = []
        for a, b in sorted(iv):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        busy[key] = sum(b - a for a, b in merged) / 1e3
    roles = {k: "compute" if any(g in nm for nm in v for g in GEMM_NAMES)
             else "collective" for k, v in names.items()}
    return busy, roles


def serve_devices_breakdown(devices, calls: int = 5) -> None:
    """qwen2-0.5b at full width and depth, a replica on each of 4 ranks'
    cards: one fused call (each rank's ``decode_hidden_paged`` and
    vocabulary slice on its card, then a start of the persistent
    user-space all-gather, waited by polling).  Each card's launches for
    one call (``rmsnorm_fwd`` 49 and ``flash_decode`` 24 a rank); the
    partial logits, gathered to ``cuda:0``, against the rank-stacked
    ``unembed_ranks`` of rank 0's hidden state within
    ``SHARD_LOGITS_ATOL``; host wall (unprofiled) against each card's
    busy time and idle share and the gather's device time."""
    from repro_torch.collectives.nonblocking import (CollectiveSpec,
                                                     UserCollectives)
    from repro_torch.collectives.rank_shards import RankShards, tree_shard
    from repro_torch.core import ProgressEngine
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import make_config
    from repro_torch.models import registry
    from repro_torch.serve.engine import ServeEngine
    cfg = make_config(ARCH, "full")
    params = registry.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    mesh = make_mesh((SHARDS,), ("model",), devices=devices)
    srv = ServeEngine(cfg, params, ProgressEngine(), batch_slots=LANES,
                      max_seq=MAX_SEQ, mesh=mesh, kv_block_size=BLOCK,
                      collective_spec=CollectiveSpec(backend="user",
                                                     chunks=SHARD_CHUNKS))
    del params
    rs = np.random.RandomState(3)
    toks = rs.randint(0, cfg.vocab_size, (LANES, 1)).astype(np.int32)
    pos = rs.randint(MIN_PROMPT, MAX_PROMPT + MAX_NEW, LANES).astype(np.int32)
    nb = srv.slots.max_blocks
    tables = (1 + np.arange(LANES * nb, dtype=np.int32)).reshape(LANES, nb)
    args = [srv.slots.place(a) for a in (toks, pos, tables)]
    base, counter = counting_by_device()
    try:
        part, _ = srv._decode(srv.slots.cache, *args, None)
    finally:
        restore_counts(base, counter)
    card_text = per_card_launches(
        counter, devices, 1, {"rmsnorm_fwd": 2 * cfg.num_layers + 1,
                              "flash_decode": cfg.num_layers}, "call")
    # rank 0's hidden state, unembedded by the stacked batched product
    first = mesh.devices[0]
    p0, c0 = tree_shard(srv.params, 0), tree_shard(srv.slots.cache, 0)
    with torch.cuda.device(first):
        hid, _ = registry.decode_hidden_paged(p0, cfg, c0, *(a[0]
                                                              for a in args))
        want = registry.unembed_ranks(p0, cfg, hid[:, -1], SHARDS)
    err = float((part.to_stacked(first) - want).abs().max())
    log(f"check: per-device partial logits of one full-depth fused call, "
        f"gathered to {first}, against the stacked unembed_ranks of rank "
        f"0's hidden state: max abs err {err:.3e} (limit "
        f"{SHARD_LOGITS_ATOL}); launches in the call: {card_text}")
    if not err <= SHARD_LOGITS_ATOL:
        raise AssertionError("per-device partial logits off the stacked")
    coll = UserCollectives(ProgressEngine(), name="breakdown")
    h = coll.allgather_init(RankShards(
        torch.empty((1, LANES, cfg.vocab_size // SHARDS), device=d)
        for d in mesh.devices), mesh, "model",
        spec=srv.collective_spec, warmup=True)

    def step():
        out, _ = srv._decode(srv.slots.cache, *args, None)
        return h.start(out).wait(timeout=60)

    def run(k=calls):
        t0 = time.perf_counter()
        for _ in range(k):
            step()
        sync_all(devices)
        return (time.perf_counter() - t0) * 1e3 / k

    run(1)
    wall = run()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        wall_prof = run()
    h.close()
    coll.close()
    srv.close()
    busy, roles = busy_by_stream(prof)
    head = (f"time: per-device sharded fused call ({ARCH}, {SHARDS} ranks "
            f"on {devices}, {LANES} lanes, user all-gather ring "
            f"{SHARD_CHUNKS} chunks): wall {wall:.3f} ms ({wall_prof:.3f} "
            f"ms under the profiler)")
    if not busy:
        log(head + "; device busy not measured (no profiler events)")
        return
    per_card = busy_by_device(prof)
    gather = sum(v for k, v in busy.items() if roles[k] == "collective")
    log(head + "; " + "; ".join(
        f"cuda:{d} busy {v / calls:.3f} ms, idle share "
        f"{1 - v / calls / wall_prof:.3f}" for d, v in sorted(per_card.items()))
        + f"; the gather's device time {gather / calls:.3f} ms a call "
        f"(its streams on every card)")


# the per-device pipeline launcher's meshes and steps; the timed
# all-to-all pairs of the per-device expert-parallel layer
DEV_PIPE_MESHES, DEV_PIPE_STEPS = ("1x4", "2x2"), 4
DEV_A2A_ITERS = 5


def per_card(devices, values: list, unit: str = "",
             fmt_: str = ".3f") -> str:
    return ", ".join(f"{d} {v:{fmt_}}{unit}"
                     for d, v in zip(devices, values))


def pipeline_devices(devices) -> None:
    """1F1B with stage s on ``devices[s]`` at ``PIPE_S``, ``PIPE_M``,
    ``PIPE_MB`` (``pipeline_phase``'s inputs): the loss and gradients of
    ``PIPE_STEPS`` steps bit for bit against the stacked schedule on
    ``cuda:0`` (``pipeline_phase``'s run) and the sequential per-stage
    computation, each gradient block on its stage's card; the forward
    equal to the per-device ``gpipe``'s; the measured bubble, the step
    window, each card's cell spans and idle share, the hops and copies a
    step, one blocking wait a call; then one profiled step's device busy
    time a card."""
    from repro_torch.collectives.rank_shards import RankShards
    from repro_torch.core import ProgressEngine, ProgressExecutor
    from repro_torch.distributed import pipeline as pl
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh
    S, M = PIPE_S, PIPE_M
    devices = devices[:S]
    params, xs, ts = pipe_inputs()
    smesh = make_mesh((S,), ("stage",), "cuda:0")
    dmesh = make_mesh((S,), ("stage",), devices=devices)
    blocks = {k: RankShards.from_stacked(v, dmesh) for k, v in params.items()}
    eng = ProgressEngine()
    ex = ProgressExecutor(eng, num_workers=2).start()
    eng.attach_executor(ex)
    kw = dict(loss_fn=train_mod.pipe_loss_fn, engine=eng, executor=ex)
    stacked = pl.PipelineSchedule(train_mod.pipe_stage_fn, smesh, "stage", S,
                                  name="chip-s", **kw)
    per = pl.PipelineSchedule(train_mod.pipe_stage_fn, dmesh, "stage", S,
                              name="chip-d", **kw)
    out, st_out, timings = [], [], []
    with no_sync():
        ys = per.apply(blocks, xs, timeout=300)
        before = per.stats()
        for _ in range(PIPE_STEPS):
            st_out.append(stacked.step(params, xs, ts, timeout=300))
            out.append(per.step(blocks, xs, ts, timeout=300))
            timings.append(per.last_step_timing)
    stats = per.stats()
    seq_loss, seq_grads = pipe_sequential(stacked, params, xs, ts)
    exact = all(
        torch.equal(loss.to("cuda:0"), sl) and torch.equal(sl, seq_loss)
        and all(isinstance(g[k], RankShards)
                and [str(d) for d in g[k].devices] == devices
                and torch.equal(g[k].to_stacked("cuda:0"), sg[k])
                and torch.equal(sg[k], seq_grads[k]) for k in params)
        for (loss, g), (sl, sg) in zip(out, st_out))
    gp = pl.gpipe(train_mod.pipe_stage_fn, dmesh, "stage", S)(blocks, xs)
    gp_same = torch.equal(ys, gp)
    on_cards = [str(c.device) for c in per.cuda_streams] == devices
    # one step under the profiler: each card's device busy time
    sync_all(devices)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        per.step(blocks, xs, ts, timeout=300)
        sync_all(devices)
        prof_ms = (time.perf_counter() - t0) * 1e3
    busy = busy_by_device(prof)
    per.close()
    stacked.close()
    ex.shutdown(drain=True, timeout=120)
    # what the steps' hops carried, counted by the schedule as it
    # started them
    hops, rows, cross = (
        (f(stats) - f(before)) / PIPE_STEPS
        for f in (lambda st: sum(st["hop_starts"].values()),
                  lambda st: st["hop_rows"],
                  lambda st: st["hop_rows_between_devices"]))
    later = timings[1:]
    bubble = sum(t["bubble"] for t in later) / len(later)
    window = [round(t["window_s"] * 1e3, 3) for t in timings]
    span = [sum(t["window_s"] - t["idle_s"][s] for t in later) / len(later)
            * 1e3 for s in range(S)]
    idle = [sum(t["idle_s"][s] / t["window_s"] for t in later) / len(later)
            for s in range(S)]
    busy_text_ = (f"device busy over one profiled step ({prof_ms:.3f} ms "
                  f"wall) " + ", ".join(
                      f"cuda:{d} {v:.3f} ms (device idle share "
                      f"{1 - v / prof_ms:.4f})"
                      for d, v in sorted(busy.items()))) if busy \
        else "device busy not measured (no profiler events)"
    log(f"devices: 1f1b with a stage per card, S={S} M={M} (mb {PIPE_MB}) "
        f"on {devices}: measured bubble {bubble:.4f} (steps 1-"
        f"{PIPE_STEPS - 1}) vs analytic "
        f"{pl.bubble_fraction(S, M, '1f1b'):.4f}; step window {window} ms; "
        f"each card's cell spans (host clock, issue to the engine seeing "
        f"the work done) " + per_card(devices, span, " ms")
        + ", idle share " + per_card(devices, idle, fmt_=".4f")
        + f"; {busy_text_}; a step (counted) {hops:g} hop starts, "
        f"{rows:g} row copies of which {cross:g} between two cards; "
        f"blocking waits "
        f"{stats['blocking_waits']} for {PIPE_STEPS + 1} calls; loss and "
        f"gradients vs the stacked schedule on cuda:0 and the sequential "
        f"computation {'bit for bit' if exact else 'NOT bit for bit'} over "
        f"{PIPE_STEPS} steps; forward vs the per-card gpipe "
        f"{'bit for bit' if gp_same else 'DIFFERS'}")
    if not (exact and gp_same and on_cards
            and stats["blocking_waits"] == PIPE_STEPS + 1
            and rows == hops * S > 0
            and stats["p2p_issued"] == stats["p2p_completed"] > 0):
        raise AssertionError(f"1f1b with a stage per card failed its "
                             f"checks: {stats}")


def pipeline_launcher_devices(devices) -> None:
    """``launch.train --pipeline 1f1b --rank-devices`` at each of
    ``DEV_PIPE_MESHES`` (rank (d, s) on ``devices[d*S + s]``): the losses
    of ``DEV_PIPE_STEPS`` steps bit for bit the stacked launcher's at the
    same mesh; the step ms and each card's idle share in the last step."""
    from repro_torch.launch import train as train_mod
    for mesh in DEV_PIPE_MESHES:
        runs = {}
        for name, extra in (("stacked", []),
                            ("devices", ["--rank-devices",
                                         ",".join(devices)])):
            ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_pipe_dev_")
            try:
                args = train_mod.build_parser().parse_args([
                    "--device", "cuda", "--pipeline", "1f1b", "--mesh", mesh,
                    "--microbatches", str(PIPE_M), "--global-batch",
                    str(PIPE_MB), "--steps", str(DEV_PIPE_STEPS),
                    "--ckpt-dir", ckpt_dir] + extra)
                with no_sync():
                    runs[name] = train_mod.run(args, log_every=1)
            finally:
                shutil.rmtree(ckpt_dir, ignore_errors=True)
        losses = {k: [m["loss"] for m in r.log] for k, r in runs.items()}
        rep = runs["devices"]
        steps_ms = [round(m["step_time_s"] * 1e3, 3) for m in rep.log]
        idle = [round(t["idle_s"][s] / t["window_s"], 4)
                for t in (r.last_step_timing for r in rep.rows)
                for s in range(len(t["idle_s"]))]
        log(f"devices: launch.train --pipeline 1f1b --mesh {mesh} "
            f"--rank-devices {','.join(devices)}: losses "
            f"{[round(v, 6) for v in losses['devices']]} "
            f"{'bit for bit' if losses['devices'] == losses['stacked'] else 'NOT equal to'}"
            f" the stacked launcher's; step ms {steps_ms} (stacked "
            f"{[round(m['step_time_s'] * 1e3, 3) for m in runs['stacked'].log]}"
            f"); last step's idle share a card (row-major) {idle}; reducer "
            f"over data={rep.reducer.axis_size} a stage column")
        if losses["devices"] != losses["stacked"] or \
                len(losses["devices"]) != DEV_PIPE_STEPS:
            raise AssertionError(f"--pipeline 1f1b --mesh {mesh} with a "
                                 f"device per rank: {losses}")


def expert_parallel_devices(devices, n: int = 4) -> None:
    """granite-moe-3b-a800m's MoE layer at full width (``x [8, 1024,
    1536]`` bf16: 16 groups of 512 tokens, 4 a rank; 40 experts, 10 a
    rank) with each rank's groups and experts on ``devices[r]``: user =
    native bit for bit, ``y`` within the bf16 limit of the stacked
    expert-parallel path on ``cuda:0`` and ``aux`` within 1e-6 relative;
    each card's peak memory; then the all-to-all pair (dispatch and its
    reverse) alone, user and native: wall, each card's device busy time,
    the bytes that cross cards and, on distinct cards, the bus
    bandwidth."""
    from repro_torch.collectives.nonblocking import UserCollectives
    from repro_torch.collectives.rank_shards import RankShards, \
        device_context, replicate
    from repro_torch.configs import get_config
    from repro_torch.core import ProgressEngine
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers
    devices = devices[:n]
    cfg = get_config(GRANITE)
    gen = torch.Generator(device="cuda").manual_seed(27)
    p = layers.tree_map(lambda t: t.to(torch.bfloat16),
                        layers.init_tree(layers.moe_spec(cfg), gen))
    x = torch.randn(TRAIN_BATCH, TRAIN_SEQ, GRANITE_D, generator=gen,
                    device="cuda").to(torch.bfloat16)
    smesh = make_mesh((n,), ("model",), "cuda:0")
    dmesh = make_mesh((n,), ("model",), devices=devices)
    cards = distinct(devices)
    coll = UserCollectives(ProgressEngine(), name="moe_a2a_devices")
    try:
        with torch.no_grad():
            y_ref, aux_ref = layers.moe_apply_expert_parallel(p, x, cfg,
                                                              smesh)
            pd = {k: replicate(v, devices) if k == "router"
                  else RankShards.from_stacked(v, dmesh)
                  for k, v in p.items()}
            xd = RankShards.from_stacked(x, dmesh)
            del p
            sync_all(devices)
            for d in cards:
                torch.cuda.reset_peak_memory_stats(d)
            y_nat, aux_nat = layers.moe_apply_expert_parallel(pd, xd, cfg,
                                                              dmesh)
            y_usr, aux_usr = layers.moe_apply_expert_parallel(
                pd, xd, cfg, dmesh, coll=coll)
            sync_all(devices)
            peaks = [torch.cuda.max_memory_allocated(d) / 2**30
                     for d in cards]
            if [str(d) for d in y_nat.devices] != devices or not (
                    all(torch.equal(a, b) for a, b in zip(y_nat, y_usr))
                    and torch.equal(aux_nat, aux_usr)):
                raise AssertionError("per-device expert parallelism: user "
                                     "and native differ")
            err = check_close("per-device expert-parallel y",
                              y_nat.to_stacked("cuda:0"), y_ref,
                              torch.bfloat16)
            aux_rel = abs(float(aux_nat) - float(aux_ref)) / abs(
                float(aux_ref))
            if aux_rel > 1e-6:
                raise AssertionError(f"per-device aux {float(aux_nat)} vs "
                                     f"{float(aux_ref)}: rel {aux_rel:.3e}")
            # the pair alone, on each rank's dispatched [G/n, E, C, d]
            xe = []
            for r, dev in enumerate(devices):
                with device_context(dev):
                    xg, disp, _, _, _ = layers._moe_route_parts(
                        {"router": pd["router"][r]}, xd[r], cfg)
                    xe.append(layers._moe_dispatch(disp, xg).contiguous())
            xe = RankShards(xe)

            def pair(c):
                fwd = layers.moe_dispatch_alltoall(xe, dmesh, "model",
                                                   coll=c)
                return fwd, layers.moe_dispatch_alltoall(
                    fwd, dmesh, "model", reverse=True, coll=c)

            walls, busy = {}, {}
            for name, c in (("user", coll), ("native", None)):
                fwd, back = pair(c)
                if not all(torch.equal(a, b) for a, b in zip(back, xe)):
                    raise AssertionError(f"the {name} pair moved values")
                sync_all(devices)
                t0 = time.perf_counter()
                for _ in range(DEV_A2A_ITERS):
                    pair(c)
                sync_all(devices)
                walls[name] = (time.perf_counter() - t0) * 1e3 \
                    / DEV_A2A_ITERS
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    pair(c)
                    sync_all(devices)
                busy[name] = busy_by_device(prof)
    finally:
        coll.close()
    rank_bytes = xe[0].numel() * xe[0].element_size()
    cross = (n - 1) / n * rank_bytes if len(cards) == n else 0.0
    if len(cards) == n:
        bw = {k: (n - 1) / n * rank_bytes / (v / 2 / 1e3) / 1e9
              for k, v in walls.items()}
        bw_text = ("bus bandwidth a one-way all-to-all, (n-1)/n x bytes a "
                   "rank / (pair wall / 2): " + ", ".join(
                       f"{k} {v:.3f} GB/s" for k, v in bw.items())
                   + " (NVLink's 450 GB/s a direction is its ceiling)")
    else:
        bw_text = ("no bus bandwidth: the ranks share one card, so every "
                   "block is a copy within it")
    busy_t = "; ".join(
        f"{k} pair device busy " + (", ".join(
            f"cuda:{d} {v:.3f} ms" for d, v in sorted(b.items()))
            if b else "not measured (no profiler events)")
        for k, b in busy.items())
    log(f"devices: expert parallelism with a card a rank ({GRANITE} layer, "
        f"x [{TRAIN_BATCH}, {TRAIN_SEQ}, {GRANITE_D}] bf16, {n} ranks on "
        f"{devices}, {cfg.moe.num_experts // n} experts and "
        f"{xe[0].shape[0]} groups a rank): user == native bit for bit; y vs "
        f"the stacked expert-parallel path max abs err {err:.3e} (bf16 "
        f"limit {tol_text(TOLS[torch.bfloat16])}), aux {float(aux_nat):.6f} "
        f"rel err {aux_rel:.3e}; each rank's dispatched "
        f"[{', '.join(map(str, xe[0].shape))}] bf16 is "
        f"{rank_bytes / 1e6:.1f} MB, of which {cross / 1e6:.1f} MB cross "
        f"cards each way; all-to-all pair wall: user {walls['user']:.3f} ms, "
        f"native {walls['native']:.3f} ms; {busy_t}; {bw_text}; peak "
        f"memory " + ", ".join(f"{d} {v:.2f} GiB"
                               for d, v in zip(cards, peaks)))


def stages_experts_phase(devices) -> None:
    """Phase 16's stage-per-card and expert-per-card parts."""
    t0 = time.perf_counter()
    pipeline_devices(devices)
    free()
    pipeline_launcher_devices(devices)
    free()
    expert_parallel_devices(devices)
    free()
    log(f"devices: pipeline and expert parts done in "
        f"{time.perf_counter() - t0:.1f} s")


# the non-dense families under data parallelism and FSDP with a device
# per rank, each against its rank-stacked run: full width at these depths
# (mamba2 of 48; zamba2 of 38: one group of 6 and its shared site, and a
# tail layer; whisper-tiny whole; granite of 32; pixtral of 40), on
# DEV_FAMILY_RANKS ranks, batch x seq tokens (text only: shorter than
# pixtral's 1024-patch image, as the train launchers feed it), these
# steps.  Pixtral runs only its data-parallel pair, and only where the
# ranks have cards of their own: its 1.6 billion f32 parameters even at
# one layer (the 131072-row embedding and head) make each replica with
# its AdamW moments, gradients and reduced gradients ~32 GB (47.7 GiB a
# card at peak), so two ranks do not fit on one 80 GB card, and the
# stacked FSDP run, whose gathered parameters, gradients and
# reduce-scatter buffers for both ranks sit on one card, does not fit
# either
DEV_FAMILIES = ((MAMBA, 2), (ZAMBA, 7), (WHISPER, 4), (GRANITE, 2),
                (PIXTRAL, 1))
DEV_FAMILY_OWN_CARDS = (PIXTRAL,)
DEV_FAMILY_RANKS, DEV_FAMILY_STEPS = 2, 2
DEV_FAMILY_TOKENS = (4, 256)
DEV_FAMILY_KERNELS = DEV_KERNELS + ("ssd_chunk",)


def families_devices() -> dict:
    """Data-parallel (``--devices 2 --collective-backend user``) and FSDP
    (``--fsdp`` on the same) training of mamba2, zamba2, whisper,
    granite-moe and pixtral at full width (``DEV_FAMILIES``' depths),
    each with ``--rank-devices`` against its rank-stacked run: the losses
    bit for bit; each card's launches of ``DEV_FAMILY_KERNELS`` its ranks'
    single-card passes (``kernel_launches_per_step``), filed by current
    card; no checkpoint written (phase 16's smollm runs check it).
    Pixtral's data-parallel pair only, where the ranks have cards of
    their own (``DEV_FAMILY_OWN_CARDS``).
    Returns the per-device runs' launches, summed."""
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.serve import make_config
    devices = rank_devices(DEV_FAMILY_RANKS)
    n = DEV_FAMILY_RANKS
    batch, seq = DEV_FAMILY_TOKENS
    total: dict = {}
    for arch, layers in DEV_FAMILIES:
        config = make_config(arch, "full").with_overrides(num_layers=layers)
        for mode, flags in (("data-parallel", []), ("FSDP", ["--fsdp"])):
            if arch in DEV_FAMILY_OWN_CARDS and (
                    flags or len(distinct(devices)) < n):
                log(f"devices: {arch} {mode} not run on {devices}: its "
                    f"stacked or per-device state does not fit one card")
                continue
            argv = ["--arch", arch, "--scale", "full", "--global-batch",
                    str(batch), "--seq", str(seq), "--steps",
                    str(DEV_FAMILY_STEPS), "--devices", str(n),
                    "--collective-backend", "user"] + flags
            t0 = time.perf_counter()
            stacked = train_counted(argv, config, devices, saves=False)[0]
            want = [m["loss"] for m in stacked.log]
            del stacked
            free()
            report, launches, counter, peaks, _ = train_counted(
                argv + ["--rank-devices", ",".join(devices)], config,
                devices, saves=False)
            cfg = report.cfg
            if full_width(cfg)[1:] != FULL_WIDTH[arch][1:]:
                raise AssertionError(f"not the full {arch} width: {cfg}")
            got = [m["loss"] for m in report.log]
            if got != want or len(got) != DEV_FAMILY_STEPS:
                raise AssertionError(f"{arch} {mode} --rank-devices losses "
                                     f"{got}, the stacked run's {want}")
            single = train_mod.kernel_launches_per_step(cfg)
            if launches != {k: v * n * DEV_FAMILY_STEPS
                            for k, v in single.items()}:
                raise AssertionError(f"{arch} {mode} launches {launches}, "
                                     f"want {single} x {n} ranks x "
                                     f"{DEV_FAMILY_STEPS}")
            cards = per_card_launches(
                counter, devices, DEV_FAMILY_STEPS,
                {k: single[k] for k in DEV_FAMILY_KERNELS}, "step")
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            log(f"devices: {arch} {mode}, full width at {cfg.num_layers} "
                f"layers, {n} ranks on {devices}, {batch}x{seq} tokens "
                f"({card_and_limit()}): "
                f"losses {[round(v, 6) for v in got]}, bit for bit the "
                f"stacked run's; a step on each card: {cards}; "
                f"{step_ms(report)}; peak memory "
                + per_card(distinct(devices), peaks, " GiB", ".2f")
                + f"; both runs {time.perf_counter() - t0:.1f} s")
            del report
            free()
    return total


def devices_phase(dp_losses: list, fsdp_losses: list, sharded: list,
                  fsdp_native: list) -> dict:
    """Phase 16: the mesh with one device per rank (distinct cards where
    the machine has 4, else cuda:0 four times): the collectives, the
    timed 256 MiB allreduce, user and native, data-parallel smollm-360m
    at full width against phase 9 (``dp_losses``), its per-device
    breakdown, a chaos kill, and its native run; FSDP against phase 10's
    user run (``fsdp_losses``), its breakdown and chaos, and its native
    run against phase 10's native run (``fsdp_native``); sharded serving
    against phase 11's streams at
    ``DEV_SERVE_LAYERS`` layers (``sharded``), its recovery and a
    full-depth fused call's breakdown; 1F1B with a stage per card, the
    pipeline launcher with a device per rank and granite's MoE layer with
    each rank's experts on its card (``stages_experts_phase``); the
    non-dense families under data parallelism and FSDP with a device per
    rank (``families_devices``).  Returns the four main paths'
    launches."""
    t0 = time.perf_counter()
    count = torch.cuda.device_count()
    devices = rank_devices()
    log(f"devices: torch.cuda.device_count() = {count}; the mesh's "
        f"devices {devices}"
        + ("" if count >= DP_RANKS else
           f" (this machine has {count} card(s): cuda:0 is listed "
           f"{DP_RANKS} times, so every copy between ranks stays on it)"))
    cards = distinct(devices)
    if len(cards) > 1:
        log("devices: peer access " + ", ".join(
            f"{i}->{j} {torch.cuda.can_device_access_peer(i, j)}"
            for i in range(len(cards)) for j in range(len(cards)) if i != j)
            + " (where False, a copy between the two is staged through "
            "the host)")
    devices_collectives(devices)
    free()
    native = native_devices_part(devices, dp_losses, fsdp_native)
    t1 = time.perf_counter()
    log(f"devices: data-parallel parts done in {t1 - t0:.1f} s")
    fsdp_launches, report = train_fsdp_devices(fsdp_losses, devices)
    fsdp_devices_breakdown(report, devices)
    del report
    free()
    fsdp_devices_chaos(devices)
    free()
    t2 = time.perf_counter()
    log(f"devices: FSDP parts done in {t2 - t1:.1f} s")
    serve_launches = serve_devices(sharded, devices)
    free()
    serve_devices_breakdown(devices)
    free()
    log(f"devices: sharded serving parts done in "
        f"{time.perf_counter() - t2:.1f} s")
    stages_experts_phase(devices)
    t3 = time.perf_counter()
    families = families_devices()
    log(f"devices: the non-dense families' parts done in "
        f"{time.perf_counter() - t3:.1f} s")
    log(f"devices phase: {time.perf_counter() - t0:.1f} s")
    return {"train_fsdp_devices": fsdp_launches,
            "serve_devices": serve_launches,
            "train_families_devices": families, **native}


def native_devices_part(devices, dp_losses: list, fsdp_native: list,
                        chaos: bool = True) -> dict:
    """Phase 16's data-parallel part and the native backend with a device
    per rank: the 256 MiB allreduce, user then native; data-parallel
    smollm-360m on the user backend (``train_devices``, its breakdown
    and, with ``chaos``, its chaos kill), then on the native backend
    (``train_native_devices``); FSDP on the native backend
    (``train_fsdp_native_devices``).  Returns the three runs' launches."""
    t0 = time.perf_counter()
    user_ms = devices_big_allreduce(devices)
    free()
    devices_native_allreduce(devices, user_ms)
    free()
    launches, report = train_devices(dp_losses, devices)
    user_step = mean_step_ms(report)
    devices_time_breakdown(report, devices)
    del report
    free()
    if chaos:
        devices_chaos(devices)
        free()
    t1 = time.perf_counter()
    native = train_native_devices(dp_losses, user_step, devices)
    fsdp_native_launches = train_fsdp_native_devices(fsdp_native, devices)
    log(f"devices: the native backend's runs a device per rank done in "
        f"{time.perf_counter() - t1:.1f} s (the part "
        f"{time.perf_counter() - t0:.1f} s)")
    return {"train_devices": launches, "train_native_devices": native,
            "train_fsdp_native_devices": fsdp_native_launches}


# ---------------------------------------------------------------------------
# phase 11: parallel serving — vocab-sharded decode, membership recovery
# ---------------------------------------------------------------------------

SHARDS, SHARD_CHUNKS, MAMBA_SHARDS = 4, 2, 2
# limits fixed before the first run (PERF.md states them beside the
# predictions): the concatenated partial logits against the unsharded
# unembed of the same hidden states (2 bf16 ulps of a logit under 16), and
# the share of greedy tokens the sharded streams share with phase 3's
SHARD_LOGITS_ATOL = 0.125
SHARD_TOKEN_SHARE = 0.9
# the recovery runs: 8 requests through the 8 lanes, prompts of 16 to 64
# tokens, 16 new tokens each; their streams are held bit for bit against
# a run without failure if two such runs agree bit for bit with the lanes
# in other slots, else to this share of agreeing tokens
RECOVERY_REQUESTS, RECOVERY_PROMPT, RECOVERY_NEW = 8, (16, 64), 16
RECOVERY_TOKEN_SHARE = 0.75


def streams(report) -> list:
    return [list(r.out_tokens) for r in report.requests]


def token_share(got: list, want: list) -> float:
    """The share of greedy tokens, position by position, two runs agree on."""
    same = sum(a == b for g, w in zip(got, want) for a, b in zip(g, w))
    return same / max(sum(len(w) for w in want), 1)


def sharded_flags(n: int, backend: str) -> tuple:
    flags = ("--devices", str(n), "--model-shards", str(n),
             "--collective-backend", backend)
    if backend == "user":
        flags += ("--collective-chunks", str(SHARD_CHUNKS))
    return flags


def check_sharded(report, n: int, backend: str) -> None:
    srv = report.server
    if report.model_shards != n or srv._model_shards != n:
        raise AssertionError(f"not {n} model ranks: {report.model_shards}")
    if backend == "user" and report.starts != report.steps:
        raise AssertionError(f"gather starts {report.starts} != decode "
                             f"steps {report.steps}")
    if not srv._rows_checked:
        raise AssertionError("the gathered rows were never checked")


def sharded_time_breakdown(srv, calls: int = 10) -> None:
    """One sharded fused call on the served engine's weights and pool —
    ``decode_hidden_paged``, the rank-stacked unembed, then a start of a
    persistent user-space all-gather of the same spec, waited by polling —
    host wall clock (unprofiled) against each stream's device busy time
    and their overlap (profiled), as ``dp_time_breakdown`` reads them."""
    from repro_torch.collectives.nonblocking import UserCollectives
    from repro_torch.core import ProgressEngine
    cfg, n = srv.cfg, srv._model_shards
    rs = np.random.RandomState(3)
    dev = srv.device
    toks = torch.from_numpy(rs.randint(0, cfg.vocab_size, (LANES, 1))
                            .astype(np.int32)).to(dev)
    pos = torch.from_numpy(rs.randint(MIN_PROMPT, MAX_PROMPT + MAX_NEW, LANES)
                           .astype(np.int32)).to(dev)
    nb = srv.slots.max_blocks
    tables = (1 + torch.arange(LANES * nb, dtype=torch.int32,
                               device=dev)).reshape(LANES, nb)
    coll = UserCollectives(ProgressEngine(), name="breakdown")
    like = torch.empty((n, LANES, cfg.vocab_size // n), device="meta")
    h = coll.allgather_init(like, srv.mesh, srv.model_axis,
                            spec=srv.collective_spec, warmup=True)

    def step():
        part, _ = srv._decode(srv.slots.cache, toks, pos, tables, None)
        return h.start(part).wait(timeout=60)

    def run(k=calls):
        t0 = time.perf_counter()
        for _ in range(k):
            step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / k

    run(2)
    wall = run()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        wall_prof = run()
    units = h.dispatches_per_start
    h.close()
    coll.close()
    busy, both, any_busy = stream_busy(prof)
    roles = stream_roles(prof)
    head = (f"time: sharded fused call ({cfg.name}, {n} model ranks, "
            f"{LANES} lanes, user all-gather ring {SHARD_CHUNKS} chunks, "
            f"{units} dispatch units a start): wall {wall:.3f} ms "
            f"({wall_prof:.3f} ms under the profiler)")
    if not busy:
        log(head + "; device busy not measured (no profiler events)")
        return
    coll_ms = sum(v for k, v in busy.items() if roles[k] == "collective")
    log(head + f", device busy (any stream) {any_busy / calls:.3f} ms, "
        f"device idle share {1 - any_busy / calls / wall:.3f}; per stream "
        f"(ms a call) "
        + ", ".join(f"{roles[k]} {v / calls:.3f}" for k, v in busy.items())
        + f"; the gather's device time {coll_ms / calls:.3f} ms a call, "
        f"{both / calls:.3f} ms of it with the compute stream busy too "
        f"({both / coll_ms if coll_ms else 0:.3f} overlapped)")


def direct_serve(cfg, params, prompts, *, n, backend="user", workers=0,
                 start=True, epoch=None, kill=None, watchdog=False,
                 survivors=None, prefill_chunk=8, reverse=False,
                 max_new=RECOVERY_NEW, devices=None):
    """``ServeEngine`` on the launcher's weights, driven here so that a
    membership change can land at a chosen point: ``kill(srv, reqs)``
    polled between progress calls; then the epoch is invalidated down to
    ``survivors``, or a step watchdog on a stepped clock fires.  With
    ``devices`` the n ranks are on ``devices[:n]``, one each.  Returns
    the streams, the closed engine, its latency snapshot and the ms from
    the kill to idle."""
    from repro_torch.collectives.nonblocking import CollectiveSpec
    from repro_torch.core import ProgressEngine, ProgressExecutor
    from repro_torch.distributed.fault_tolerance import StepWatchdog
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.engine import GenRequest, ServeEngine
    eng = ProgressEngine()
    ex = ProgressExecutor(eng, workers) if workers else None
    if ex is not None and start:
        ex.start()
    mesh = None
    if n > 1 and devices is not None:
        mesh = make_mesh((n,), ("model",), devices=devices[:n])
    elif n > 1:
        mesh = make_mesh((n,), ("model",), "cuda")
    srv = ServeEngine(cfg, params, eng, batch_slots=LANES, max_seq=MAX_SEQ,
                      executor=ex, mesh=mesh, kv_block_size=BLOCK,
                      collective_spec=CollectiveSpec(backend=backend,
                                                     chunks=SHARD_CHUNKS),
                      prefill_chunk=prefill_chunk, epoch=epoch)
    reqs = [GenRequest(f"req{i}", p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in (reqs[::-1] if reverse else reqs):
        srv.submit(r)
    kill_ms = None
    if kill is not None:
        t0 = time.monotonic()
        while not kill(srv, reqs):
            eng.progress()
            if time.monotonic() - t0 > 300:
                raise AssertionError("the kill point was never reached")
        t_kill = time.perf_counter()
        if watchdog:
            clock = {"t": 0.0}
            wd = StepWatchdog(eng, limit=10.0, clock=lambda: clock["t"],
                              epoch=epoch)
            wd.arm()
            clock["t"] = 11.0
            eng.poll_subsystems()
            if wd.fired != 1:
                raise AssertionError("the watchdog did not fire")
        else:
            epoch.invalidate(survivors=survivors, reason="chaos")
    srv.run_until_idle(timeout=600)
    if kill is not None:
        kill_ms = (time.perf_counter() - t_kill) * 1e3
    lat = srv.latency_snapshot()
    srv.close(timeout=60)
    if ex is not None and ex.running:
        ex.shutdown(drain=True, timeout=60)
    if lat.completed != len(reqs) or lat.failed:
        raise AssertionError(f"{lat.completed} of {len(reqs)} completed, "
                             f"{lat.failed} failed")
    return [list(r.out_tokens) for r in reqs], srv, lat, kill_ms


def recovery_phase(cfg, params) -> None:
    """Membership changes at full width (at ``DEV_SERVE_LAYERS`` layers,
    for the script's time) on the user backend, 4 model
    ranks, against a run of the same requests without failure: mid decode
    down to 2 ranks (KV restored, not replayed) and down to 1 (the
    unsharded fallback), mid prefill, and a watchdog-fired restart."""
    from repro_torch.collectives.nonblocking import MembershipEpoch
    rs = np.random.RandomState(11)
    lo, hi = RECOVERY_PROMPT
    prompts = [rs.randint(1, cfg.vocab_size - 1, size=rs.randint(lo, hi + 1))
               .astype(np.int32) for _ in range(RECOVERY_REQUESTS)]
    with no_sync():
        ref, _, _, _ = direct_serve(cfg, params, prompts, n=SHARDS)
        moved, _, _, _ = direct_serve(cfg, params, prompts, n=SHARDS,
                                      reverse=True)
    exact = moved == ref
    log(f"check: recovery reference ({RECOVERY_REQUESTS} requests, 8 lanes): "
        f"the same requests with every lane in another slot agree bit for "
        f"bit: {exact}; the recovery runs are held "
        + ("bit for bit" if exact
           else f"to a share of {RECOVERY_TOKEN_SHARE} agreeing tokens"))

    def out(k):
        return lambda srv, reqs: sum(len(r.out_tokens) for r in reqs) >= k

    def mid_prefill(srv, reqs):
        if any(r.out_tokens for r in reqs):
            raise AssertionError("a token came out before the kill")
        return srv.sched.prefill_calls >= 2 and bool(srv._prefilling)

    cases = [("mid decode -> 2 ranks", dict(kill=out(5), survivors=2)),
             ("mid decode -> 1 rank (unsharded)",
              dict(kill=out(5), survivors=1)),
             ("mid prefill -> 2 ranks",
              dict(kill=mid_prefill, survivors=2, prefill_chunk=2)),
             ("watchdog restart", dict(kill=out(5), watchdog=True))]
    for name, kw in cases:
        epoch = MembershipEpoch(n_devices=SHARDS)
        with no_sync():
            got, srv, lat, kill_ms = direct_serve(cfg, params, prompts,
                                                  n=SHARDS, epoch=epoch, **kw)
        share = token_share(got, ref)
        log(f"check: recovery {name} ({cfg.num_layers} layers): remeshes "
            f"{srv.remeshes}, model ranks "
            f"after {srv._model_shards}, lanes checkpointed "
            f"{srv.lanes_checkpointed}, restored {srv.lanes_restored}, "
            f"{lat.completed} completed, {lat.failed} failed; rebuild "
            f"{srv.recovery_s[0] * 1e3:.3f} ms, kill to idle {kill_ms:.1f} "
            f"ms; {share:.4f} of the tokens agree with the run without "
            f"failure")
        if srv.remeshes != 1:
            raise AssertionError(f"recovery {name}: {srv.remeshes} remeshes")
        if name.startswith("mid decode") and not srv.lanes_restored:
            raise AssertionError(f"recovery {name}: no lane was restored")
        if (got != ref) if exact else share < RECOVERY_TOKEN_SHARE:
            raise AssertionError(f"recovery {name}: streams differ")
        del srv
        free()


def lane_round_trip(cfg, params, first: int = 40, more: int = 8) -> None:
    """A decoding lane of the full-width pool checkpointed after ``first``
    tokens and restored into a fresh pool whose block layout is shifted
    (the lane keeps its row of the batch): ``more`` tokens decoded from
    each, the logits equal bit for bit."""
    from repro_torch.models import registry
    from repro_torch.serve.kvcache import PagedKVCache, to_device
    rs = np.random.RandomState(5)
    toks = [np.full((LANES, 1), rs.randint(1, cfg.vocab_size), np.int32)
            for _ in range(first + more)]
    fed = np.arange(LANES) == 1

    def feed(pool, start, count):
        outs = []
        for t in range(start, start + count):
            if not pool.ensure(1, t):
                raise AssertionError("pool exhausted")
            out, pool.cache = registry.decode_step_paged(
                params, cfg, pool.cache, to_device(toks[t], pool.device),
                to_device(np.full((LANES,), t, np.int32), pool.device),
                pool.block_tables(), to_device(fed, pool.device))
            pool.slots[1].pos = t + 1
            outs.append(out[1])
        return torch.cat(outs)

    pool = PagedKVCache(cfg, LANES, MAX_SEQ, block_size=BLOCK, device="cuda")
    pool.assign("pad", seq_len=1)
    if pool.assign("req", seq_len=1).index != 1:
        raise AssertionError("lane 1 expected")
    feed(pool, 0, first)
    t0 = time.perf_counter()
    ckpt = pool.checkpoint_lane(1)
    ckpt_ms = (time.perf_counter() - t0) * 1e3
    pool2 = PagedKVCache(cfg, LANES, MAX_SEQ, block_size=BLOCK, device="cuda")
    pool2.assign("other", seq_len=100)
    if pool2.assign("req", seq_len=first + 1).index != 1:
        raise AssertionError("lane 1 expected")
    t0 = time.perf_counter()
    pool2.restore_lane(pool2.cache, 1, ckpt)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    if torch.equal(pool2.block_tables()[1], pool.block_tables()[1]):
        raise AssertionError("the block layout did not shift")
    want, got = feed(pool, first, more), feed(pool2, first, more)
    nbytes = sum(a.nbytes for a in ckpt["blocks"].values())
    log(f"check: lane round trip ({cfg.name} pool, {first} tokens, "
        f"{nbytes / 2**20:.2f} MiB of f32 snapshot, checkpoint "
        f"{ckpt_ms:.3f} ms, restore {restore_ms:.3f} ms): {more} more "
        f"tokens' logits equal bit for bit: {torch.equal(got, want)}")
    if not torch.equal(got, want):
        raise AssertionError("the restored lane decodes differently")


def unstarted_executor_check(cfg, params) -> None:
    """An executor attached but never started: the engine drives every
    serve stream inline (the collective stream's rounds too) and serves
    the caller-driven streams."""
    from repro_torch.core import ProgressEngine, ProgressExecutor
    prompts = [np.arange(1, 17, dtype=np.int32),
               np.arange(40, 60, dtype=np.int32)]
    with no_sync():
        want, _, _, _ = direct_serve(cfg, params, prompts, n=SHARDS,
                                     max_new=8)
        got, _, _, _ = direct_serve(cfg, params, prompts, n=SHARDS,
                                    workers=2, start=False, max_new=8)
    log(f"check: an executor attached, never started: served {got == want}")
    if got != want:
        raise AssertionError("the unstarted executor served other streams")


def serve_sharded_phase(unsharded: list) -> tuple:
    """Phase 11.  qwen2-0.5b at full width on 4 model ranks of the card
    (16 requests through 8 lanes, as phase 3): the user backend (ring,
    2 chunks; the main path, its launches returned) against phase 3's
    streams (``unsharded``); at ``DEV_SERVE_LAYERS`` layers the user
    backend caller-driven (its streams returned too), the native backend
    with every fused call's partial logits held against the unsharded
    unembed, and two progress workers, both bit for bit the
    caller-driven streams; an unstarted executor;
    mamba2-1.3b on 2 ranks; the recovery cases; the launcher's
    ``--chaos-kill 2``; the lane round trip."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import registry, transformer
    with no_sync():
        launches, srv, report = serve(workers=0,
                                      extra=sharded_flags(SHARDS, "user"))
    check_sharded(report, SHARDS, "user")
    user = streams(report)
    del report
    sharded_time_breakdown(srv)
    cfg, params = srv.cfg, srv.params
    del srv
    free()
    # the caller-driven user run at phase 16's per-device serving depth:
    # the native backend and two progress workers are held against it,
    # and phase 16 holds its per-device runs against its streams
    depth = dict(num_layers=DEV_SERVE_LAYERS)
    with no_sync():
        _, srv, report = serve(workers=0, extra=sharded_flags(SHARDS, "user"),
                               **depth)
    caller = streams(report)
    # the recovery cases run at this depth too
    cfg_cut, params_cut = srv.cfg, srv.params
    del srv, report
    errs = []
    real = registry.unembed_ranks

    def held(params_, cfg_, x, n):
        part = real(params_, cfg_, x, n)
        full = transformer.unembed(params_, cfg_, x)
        errs.append((part.permute(1, 0, 2).reshape(full.shape) - full)
                    .abs().max())
        return part

    registry.unembed_ranks = held
    try:
        _, srv, report = serve(workers=0,
                               extra=sharded_flags(SHARDS, "native"), **depth)
    finally:
        registry.unembed_ranks = real
    check_sharded(report, SHARDS, "native")
    native = streams(report)
    del srv, report
    err = float(torch.stack(errs).max())
    share = token_share(user, unsharded)
    log(f"check: sharded serve {ARCH} on {SHARDS} ranks: native == user bit "
        f"for bit at {DEV_SERVE_LAYERS} layers {caller == native}; "
        f"{len(errs)} fused calls' concatenated partial logits against the "
        f"unsharded unembed: max abs err {err:.3e} (limit "
        f"{SHARD_LOGITS_ATOL}); {share:.4f} of the full-depth user run's "
        f"greedy tokens agree with phase 3's unsharded run (limit "
        f"{SHARD_TOKEN_SHARE})")
    if caller != native:
        raise AssertionError("user and native sharded streams differ")
    if err > SHARD_LOGITS_ATOL or share < SHARD_TOKEN_SHARE:
        raise AssertionError("the sharded logits are off the unsharded ones")
    free()
    with no_sync():
        _, srv, report = serve(workers=2, extra=sharded_flags(SHARDS, "user"),
                               **depth)
    check_sharded(report, SHARDS, "user")
    if streams(report) != caller:
        raise AssertionError("executor-driven starts served other streams")
    log(f"check: two progress workers (executor-driven starts) serve the "
        f"caller-driven streams bit for bit ({DEV_SERVE_LAYERS} of "
        f"{FULL_WIDTH[ARCH][0]} layers)")
    del srv, report
    free()
    unstarted_executor_check(cfg, params)
    free()
    m = {}
    for backend in ("user", "native"):
        with no_sync() if backend == "user" else contextlib.nullcontext():
            _, srv, report = serve(workers=0, arch=MAMBA, requests=LANES,
                                   extra=sharded_flags(MAMBA_SHARDS, backend),
                                   num_layers=MAMBA_SERVE_LAYERS)
        check_sharded(report, MAMBA_SHARDS, backend)
        m[backend] = streams(report)
        del srv, report
        free()
    log(f"check: sharded serve {MAMBA} on {MAMBA_SHARDS} ranks ({LANES} "
        f"requests): user == native bit for bit {m['user'] == m['native']}")
    if m["user"] != m["native"]:
        raise AssertionError("mamba2 user and native sharded streams differ")
    recovery_phase(cfg_cut, params_cut)
    del params_cut
    with no_sync():
        _, srv, report = serve(
            workers=0, requests=RECOVERY_REQUESTS,
            num_layers=DEV_SERVE_LAYERS,
            extra=sharded_flags(SHARDS, "user") + (
                "--chaos-kill", "2", "--min-prompt", "16",
                "--max-prompt", "64"))
    if report.remeshes != 1 or srv._model_shards != 2:
        raise AssertionError(f"--chaos-kill 2: {report.remeshes} remeshes")
    del srv, report
    free()
    lane_round_trip(cfg, params)
    free()
    return launches, caller


# ---------------------------------------------------------------------------
# phase 12: the MoE family — granite-moe-3b-a800m served and trained at
# full width, grok-1-314b served at full widths, expert parallelism
# ---------------------------------------------------------------------------

def expert_parallel_phase(n: int = 4) -> None:
    """One granite-moe MoE layer at full width on ``n`` model ranks of the
    card: x [8, 1024, 1536] bf16 is 16 groups of 512 tokens for 40
    experts of capacity 128, so each all-to-all moves the
    [16, 40, 128, 1536] bf16 dispatched tensor (252 MB).  ``moe_apply``,
    the expert-parallel path on the native block transpose and on the
    user-space Bruck all-to-all must agree bit for bit; then the two
    all-to-alls alone, user and native, profiled: the user rounds' device
    time (on the streams the native transposes never use) and dispatch
    units, against the native transposes' device time."""
    from repro_torch.collectives.nonblocking import UserCollectives
    from repro_torch.configs import get_config
    from repro_torch.core import ProgressEngine
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers
    cfg = get_config(GRANITE)
    gen = torch.Generator(device="cuda").manual_seed(11)
    p = layers.tree_map(lambda t: t.to(torch.bfloat16),
                        layers.init_tree(layers.moe_spec(cfg), gen))
    x = torch.randn(TRAIN_BATCH, TRAIN_SEQ, GRANITE_D, generator=gen,
                    device="cuda").to(torch.bfloat16)
    mesh = make_mesh((n,), ("model",), "cuda")
    coll = UserCollectives(ProgressEngine(), name="moe_a2a")
    reqs = []
    issue = coll.ialltoall

    def counted(*a, **kw):
        reqs.append(issue(*a, **kw))
        return reqs[-1]

    coll.ialltoall = counted
    try:
        with torch.no_grad():
            y_ref, aux_ref = layers.moe_apply(p, x, cfg)
            y_nat, aux_nat = layers.moe_apply_expert_parallel(p, x, cfg, mesh)
            y_usr, aux_usr = layers.moe_apply_expert_parallel(p, x, cfg, mesh,
                                                              coll=coll)
            torch.cuda.synchronize()
            if not (torch.equal(y_ref, y_nat) and torch.equal(y_nat, y_usr)
                    and torch.equal(aux_ref, aux_nat)
                    and torch.equal(aux_nat, aux_usr)):
                raise AssertionError(
                    "expert-parallel MoE differs from moe_apply: max abs "
                    f"diff native {float((y_nat - y_ref).abs().max()):.3e}, "
                    f"user {float((y_usr - y_ref).abs().max()):.3e}")
            if not torch.isfinite(y_ref.float()).all():
                raise AssertionError("MoE output is not finite")
            units = sum(r.rounds_total for r in reqs)
            xg, dispatch, _, _ = layers._moe_route(p, x, cfg)
            xe = layers._moe_dispatch(dispatch, xg).contiguous()

            def pair(c):
                fwd = layers.moe_dispatch_alltoall(xe, mesh, "model", coll=c)
                back = layers.moe_dispatch_alltoall(fwd, mesh, "model",
                                                    reverse=True, coll=c)
                return fwd, back

            fwd, back = pair(coll)
            if not (torch.equal(fwd, xe) and torch.equal(back, xe)):
                raise AssertionError("the all-to-all round trip moved values")
            # the native pair runs on the current stream alone: CUDA
            # events time it.  The user pair runs under the profiler:
            # its payload and reassembly copies on the current stream
            # (the default stream, whose CUPTI id is below those of the
            # streams made later), its rounds on the collective stream
            iters = 5
            pair(None)
            nat_ms = time_ms(lambda: pair(None), [()], iters)
            t0 = time.perf_counter()
            for _ in range(iters):
                pair(None)
            torch.cuda.synchronize()
            nat_wall = (time.perf_counter() - t0) * 1e3 / iters
            pair(coll)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(iters):
                    pair(coll)
                torch.cuda.synchronize()
                usr_wall = (time.perf_counter() - t0) * 1e3 / iters
            usr_busy = stream_busy(prof)[0]
            default = torch.cuda.current_stream() == torch.cuda.default_stream()
            current = {min(usr_busy)} if usr_busy and default else set()
    finally:
        coll.close()
    head = (f"check: expert-parallel MoE ({GRANITE} layer, x [{TRAIN_BATCH}, "
            f"{TRAIN_SEQ}, {GRANITE_D}] bf16, {xe.shape[0]} groups x "
            f"{cfg.moe.num_experts} experts x capacity {xe.shape[2]}, "
            f"{n} model ranks): moe_apply == native == user all-to-all, "
            f"bit for bit (y and aux {float(aux_ref):.6f}); each all-to-all "
            f"moves [{', '.join(map(str, xe.shape))}] bf16 "
            f"({xe.numel() * 2 / 1e6:.1f} MB); the user pair (dispatch and "
            f"combine) {units} dispatch units")
    nat_text = (f"the native pair {nat_ms:.3f} ms (CUDA events, its copies "
                f"on the current stream); wall a pair: user {usr_wall:.3f} "
                f"ms, native {nat_wall:.3f} ms")
    if len(usr_busy) < 2 or len(current) != 1:
        log(head + f"; {nat_text}; the user rounds' device time not measured "
            f"(profiler streams {sorted(usr_busy)}, current {current})")
        return
    rounds = sum(v for k, v in usr_busy.items() if k not in current)
    copies = sum(v for k, v in usr_busy.items() if k in current)
    log(head + f"; a user pair's device time: the rounds "
        f"{rounds / iters:.3f} ms on the collective stream, the payload and "
        f"reassembly copies {copies / iters:.3f} ms on the current stream; "
        + nat_text)


def moe_phase() -> dict:
    """The MoE paths, each with the launch counts set to 0 just before it
    and read just after (inside serve() and train()): granite-moe served
    (its fused call timed, the slot cache against the paged pool) and
    trained at full width, grok-1 served at full widths at
    ``GROK_SERVE_LAYERS`` of its 64 layers, then one granite MoE layer
    expert-parallel on 4 ranks."""
    runs = {}
    runs["serve_granite"], srv, report = serve(
        workers=0, arch=GRANITE, num_layers=GRANITE_SERVE_LAYERS)
    time_breakdown(srv)
    decode_paths_check(srv)
    del srv, report
    free()
    runs["serve_grok"], srv, report = serve(workers=0, arch=GROK,
                                            num_layers=GROK_SERVE_LAYERS)
    time_breakdown(srv)
    del srv, report
    free()
    runs["train_granite"], report = train(workers=0, arch=GRANITE,
                                          layers=GRANITE_TRAIN_LAYERS)
    train_time_breakdown(report, steps=1)
    del report
    free()
    expert_parallel_phase()
    free()
    return runs


# ---------------------------------------------------------------------------
# phase 13: the last three families (zamba2-1.2b, whisper-tiny, pixtral-12b)
# ---------------------------------------------------------------------------

def lora_nonzero(params):
    """zamba2's per-site LoRA b factors (zeros at init, where the deltas
    vanish) drawn from a seed, in place, for the card-vs-CPU checks."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    for k, v in params["site_lora"].items():
        if k.endswith("_b"):
            v.copy_(0.02 * torch.randn(v.shape, generator=gen, device="cuda"))
    return params


def whisper_frames(B: int, frames: int, d: int, device, seed: int = 12):
    """Seeded stand-ins for the stub audio frontend's frame embeddings."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(B, frames, d, generator=gen, device=device)


def whisper_cache(params, cfg, frames, max_seq):
    """A slot cache whose cross K/V hold the encoder's: ``encode`` over the
    frames, then ``_enc_kv`` of each decoder layer, stacked (the JAX
    ``init_cache`` leaves them zero and no JAX function fills them)."""
    from repro_torch.models import encdec, registry
    from repro_torch.models.layers import unstack_layers
    cache = registry.init_cache(cfg, frames.shape[0], max_seq, frames.device)
    enc = encdec.encode(params, cfg, frames)
    for li, lp in enumerate(unstack_layers(params["decoder"])):
        k, v = encdec._enc_kv(cfg, lp, enc)
        cache["xk"][li].copy_(k)
        cache["xv"][li].copy_(v)
    return cache


def whisper_decode(steps: int = WHISPER_NEW) -> dict:
    """whisper-tiny at full width (bf16 weights) decoded on the slot cache,
    8 lanes: the encoder over seeded frame embeddings [8, 1500, 384], the
    cross K/V filled per layer, then ``steps`` greedy tokens through
    ``registry.decode_step``, the launch counts set to 0 just before the
    decode and read just after: 2 flash_decode a layer a call (self over
    the written positions, cross over all 1500 frames), nothing else."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.models import registry
    cfg = get_config(WHISPER)
    if full_width(cfg) != FULL_WIDTH[WHISPER]:
        raise AssertionError(f"not the full {WHISPER} width: {cfg}")
    params = registry.cast_params(cfg, registry.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0)))
    frames = whisper_frames(LANES, cfg.encoder_frames, cfg.d_model, "cuda")
    with torch.no_grad():
        t0 = time.perf_counter()
        cache = whisper_cache(params, cfg, frames, WHISPER_MAX_SEQ)
        torch.cuda.synchronize()
        enc_ms = (time.perf_counter() - t0) * 1e3
        toks = torch.full((LANES, 1), 50257, dtype=torch.int32,
                          device="cuda")        # whisper's <|startoftranscript|>
        pos = torch.zeros(LANES, dtype=torch.int32, device="cuda")
        out = []
        torch.cuda.synchronize()
        _lib.reset_launches()
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = registry.decode_step(params, cfg, cache, toks, pos)
            toks = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            out.append(toks)
            pos = pos + 1
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
        launches = dict(_lib.launches)
    want = dict.fromkeys(launches, 0)
    want["flash_decode"] = steps * 2 * cfg.num_layers
    log(f"whisper decode launches {launches}, expected {want} for {steps} "
        f"calls ({2 * cfg.num_layers} flash_decode a call)")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if not torch.isfinite(logits).all() or logits.shape != (
            LANES, 1, cfg.vocab_size):
        raise AssertionError(f"bad whisper logits {tuple(logits.shape)}")
    tokens = torch.cat(out, 1).cpu()
    log(f"whisper {WHISPER} decode (bf16, {LANES} lanes, cross K/V of "
        f"{cfg.encoder_frames} frames, self K/V of {WHISPER_MAX_SEQ} "
        f"positions): encoder and cross K/V {enc_ms:.3f} ms; {steps} greedy "
        f"tokens a lane at {wall:.3f} ms a call (host wall), "
        f"{LANES * 1e3 / wall:.1f} tokens/s; lane 0's first tokens "
        f"{tokens[0, :8].tolist()}")
    return launches


def train_pixtral() -> dict:
    """pixtral-12b at full widths and ``PIXTRAL_LAYERS`` of its 40 layers
    through ``make_train_step``: ``PIXTRAL_PATCHES`` vision embeddings
    (seeded, bf16) before 1024 text tokens, batch 2, the vocab-chunked
    loss over the text positions, "full" remat, ``PIXTRAL_STEPS`` steps.
    At step 0 the chunked loss must equal the plain one (|a - b| <= 1e-4
    |b|, as phase 4's qwen2.5-3b).  Not the Trainer: the checkpoint of
    the last step would be ~39 GB."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import _lib
    from repro_torch.launch import train as train_mod
    from repro_torch.models import registry
    from repro_torch.train import optimizer as opt_mod
    cfg = get_config(PIXTRAL).with_overrides(num_layers=PIXTRAL_LAYERS,
                                             loss_impl="chunked_vocab")
    if full_width(cfg) != (PIXTRAL_LAYERS,) + FULL_WIDTH[PIXTRAL][1:] or (
            cfg.dtype, cfg.param_dtype, cfg.remat_policy) != (
            "bfloat16", "float32", "full"):
        raise AssertionError(f"not the full {PIXTRAL} width: {cfg}")
    torch.cuda.reset_peak_memory_stats()
    params = registry.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    opt_state = opt_mod.init(params)
    src = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, PIXTRAL_BATCH, seed=5)
    gen = torch.Generator(device="cuda").manual_seed(13)
    batches = []
    for _ in range(PIXTRAL_STEPS):
        b = {k: torch.from_numpy(v.copy()).cuda()
             for k, v in src.sample().items()}
        b["vision_embeds"] = torch.randn(
            PIXTRAL_BATCH, PIXTRAL_PATCHES, cfg.d_model, generator=gen,
            device="cuda").to(torch.bfloat16)
        batches.append(b)
    with torch.no_grad():
        chunked = float(registry.loss_fn(params, cfg, batches[0])[0])
        plain = float(registry.loss_fn(
            params, cfg.with_overrides(loss_impl="plain"), batches[0])[0])
    if not math.isfinite(chunked) or abs(chunked - plain) > 1e-4 * abs(plain):
        raise AssertionError(f"chunked loss {chunked} vs plain {plain}")
    step = train_mod.make_train_step(cfg, opt_mod.AdamWConfig(
        lr=3e-3, warmup_steps=5, total_steps=10))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    times, losses = [], []
    for batch in batches:
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(_lib.launches)
    peak = torch.cuda.max_memory_allocated()
    per_step = train_mod.kernel_launches_per_step(cfg)
    want = {k: v * PIXTRAL_STEPS for k, v in per_step.items()}
    log(f"train {PIXTRAL} launches {launches}, expected {want} ({per_step} "
        f"per step x {PIXTRAL_STEPS} steps)")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"bad loss trajectory {losses}")
    mean_s = sum(times[1:]) / len(times[1:])
    S = PIXTRAL_PATCHES + TRAIN_SEQ
    tokens = PIXTRAL_BATCH * S
    flops = registry.model_flops(cfg, tokens, training=True, seq_len=S)
    log(f"train {PIXTRAL} ({PIXTRAL_LAYERS} of 40 layers, "
        f"{registry.param_count(cfg) / 1e9:.3f} B params, {PIXTRAL_BATCH} x "
        f"({PIXTRAL_PATCHES} vision + {TRAIN_SEQ} text) positions, "
        f"chunked_vocab loss over the text, remat full): step-0 loss "
        f"chunked {chunked:.7f} vs plain {plain:.7f} (rel diff "
        f"{abs(chunked - plain) / abs(plain):.3e}, limit 1e-4); losses "
        f"{[round(x, 6) for x in losses]}; mean step {mean_s * 1e3:.3f} ms "
        f"(steps 1-{PIXTRAL_STEPS - 1}; step 0 {times[0] * 1e3:.3f} ms), "
        f"model {flops / mean_s / 1e12:.2f} TFLOP/s ({flops / 1e12:.2f} "
        f"TFLOP a step by registry.model_flops); peak device memory "
        f"{peak / 2**30:.2f} GiB")
    step_breakdown(cfg, step, {"p": params, "o": opt_state}, batches[0], 1,
                   warm=False)
    return launches


def whisper_reference_check(steps: int = 4) -> None:
    """Four f32 decode steps of whisper-tiny at full width and 2 encoder
    and 2 decoder layers, 8 lanes, on the card (kernels) and on the CPU
    (plain versions), from the same weights, frames [8, 1500, 384] and
    tokens, the cross K/V filled as ``whisper_decode`` fills them: the
    cross K/V held per leaf to max|a - b| <= 1e-4 max|b|, the logits as
    the dense decode check holds them (atol/rtol 1e-3, greedy tokens
    equal)."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.models.layers import tree_map
    cfg = get_config(WHISPER).with_overrides(
        num_layers=2, num_encoder_layers=2, dtype="float32")
    params = {"cuda": registry.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(1))}
    params["cpu"] = tree_map(lambda t: t.cpu(), params["cuda"])
    frames = whisper_frames(LANES, cfg.encoder_frames, cfg.d_model, "cuda")
    with torch.no_grad():
        caches = {dev: whisper_cache(params[dev], cfg, frames.to(dev), 64)
                  for dev in ("cuda", "cpu")}
    x_err = max(leaf_errors("whisper cross K/V", [("xk",), ("xv",)],
                            [caches["cuda"][k].cpu() for k in ("xk", "xv")],
                            [caches["cpu"][k] for k in ("xk", "xv")], 1e-4))
    rs = np.random.RandomState(8)
    pos = rs.randint(0, 8, size=LANES).astype(np.int32)
    worst = 0.0
    for step in range(steps):
        toks = torch.from_numpy(
            rs.randint(0, cfg.vocab_size, size=(LANES, 1)).astype(np.int32))
        p = torch.from_numpy(pos)
        with torch.no_grad():
            got, caches["cuda"] = registry.decode_step(
                params["cuda"], cfg, caches["cuda"], toks.cuda(), p.cuda())
            want, caches["cpu"] = registry.decode_step(
                params["cpu"], cfg, caches["cpu"], toks, p)
        got = got.cpu()
        err = (got - want).abs()
        if not torch.isfinite(got).all() or \
                (err > 1e-3 + 1e-3 * want.abs()).any():
            raise AssertionError(f"card vs CPU whisper logits differ: max abs "
                                 f"err {float(err.max()):.3e}")
        if not torch.equal(got.argmax(-1), want.argmax(-1)):
            raise AssertionError("card vs CPU whisper greedy tokens differ")
        worst = max(worst, float(err.max()))
        pos = pos + 1
    log(f"check: full-width whisper-tiny f32 decode (2+2 layers, cross K/V "
        f"of {cfg.encoder_frames} frames), card kernels vs CPU plain "
        f"versions, {steps} steps x {LANES} lanes: cross K/V {x_err:.3e} of "
        f"the leaf's largest entry (limit 1e-4); max abs logit err "
        f"{worst:.3e} (atol/rtol 1e-3), greedy tokens equal")


def pixtral_reference_check(patches: int = 64, text: int = 64) -> None:
    """The f32 loss of pixtral-12b at full widths and 2 layers with
    ``patches`` vision embeddings before ``text`` tokens (B=2), on the
    card and on the CPU from the same weights and inputs, the plain and
    the chunked loss each: |a - b| <= 1e-5 |b|."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.models.layers import tree_map
    cfg = get_config(PIXTRAL).with_overrides(num_layers=2, dtype="float32")
    params = {"cuda": registry.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(1))}
    params["cpu"] = tree_map(lambda t: t.cpu(), params["cuda"])
    rs = np.random.RandomState(9)
    toks = rs.randint(0, cfg.vocab_size, size=(2, text + 1)).astype(np.int32)
    vis = rs.randn(2, patches, cfg.d_model).astype(np.float32)
    texts = []
    for impl in ("plain", "chunked_vocab"):
        c = cfg.with_overrides(loss_impl=impl)
        loss = {}
        for dev in ("cuda", "cpu"):
            batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(dev),
                     "labels": torch.from_numpy(toks[:, 1:]).to(dev),
                     "vision_embeds": torch.from_numpy(vis).to(dev)}
            with torch.no_grad():
                loss[dev] = float(registry.loss_fn(params[dev], c, batch)[0])
        a, b = loss["cuda"], loss["cpu"]
        if not math.isfinite(a) or abs(a - b) > 1e-5 * abs(b):
            raise AssertionError(f"pixtral {impl} loss card {a} vs CPU {b}")
        texts.append(f"{impl} {a:.7f} vs {b:.7f} (rel err "
                     f"{abs(a - b) / abs(b):.3e})")
    log(f"check: full-width two-layer pixtral-12b f32 loss with {patches} "
        f"vision embeddings before {text} text tokens, card kernels vs CPU "
        f"plain versions (limit 1e-5 rel): " + "; ".join(texts))


def families_phase() -> dict:
    """Phase 13, each path with the launch counts set to 0 just before it
    and read just after: zamba2-1.2b served at full width (its fused call
    timed, the slot cache against the paged pool) and trained through
    the train launcher (the checkpoint restored equal); whisper-tiny
    trained through the train launcher (encoder embeddings as the JAX
    launcher feeds them) and decoded on the slot cache; pixtral-12b
    trained at ``PIXTRAL_LAYERS`` of its 40 layers with vision
    embeddings."""
    runs = {}
    runs["serve_zamba2"], srv, report = serve(
        workers=0, arch=ZAMBA, num_layers=ZAMBA_SERVE_LAYERS)
    time_breakdown(srv)
    decode_paths_check(srv, kvs=("bf16",))
    del srv, report
    free()
    runs["train_zamba2"], report = train(workers=0, arch=ZAMBA,
                                         layers=ZAMBA_TRAIN_LAYERS)
    train_time_breakdown(report, steps=1)
    del report
    free()
    runs["train_whisper"], report = train(workers=0, arch=WHISPER)
    train_time_breakdown(report, steps=1)
    del report
    free()
    runs["serve_whisper"] = whisper_decode()
    free()
    runs["train_pixtral"] = train_pixtral()
    free()
    return runs


def families_reference_checks() -> None:
    """Phase 13's card-vs-CPU checks in f32 at full widths: zamba2 at one
    group of 2 layers and a tail of 1 (LoRA b nonzero; decode logits, and
    one train step's loss, every gradient and the AdamW update), whisper
    at 2 + 2 layers (decode with the cross K/V filled, and one train
    step), pixtral at 2 layers (the loss with vision embeddings)."""
    zamba_small = dict(num_layers=3, shared_attn_every=2)
    reference_check(ZAMBA, prep=lora_nonzero, **zamba_small)
    train_reference_check(ZAMBA, over=zamba_small, prep=lora_nonzero)
    whisper_reference_check()
    train_reference_check(
        WHISPER, over=dict(num_encoder_layers=2), zero=("bk",),
        extra=lambda rs, cfg: {"encoder_embeds": rs.randn(
            2, cfg.encoder_frames, cfg.d_model).astype(np.float32)})
    pixtral_reference_check()


# ---------------------------------------------------------------------------
# phase 14: the model axis in training (ring attention, the MoE block's
# tensor-parallel schedule)
# ---------------------------------------------------------------------------

def ring_mesh(device: str = "cuda"):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(tuple(int(v) for v in RING_MESH.split("x")),
                     ("data", "model"), device)


def ring_attention_time() -> None:
    """At smollm-360m's train shape (q [8, 1024, 15, 64], k/v [8, 1024,
    5, 64], bf16, causal) on the ``RING_MESH`` model ranks: the ring's
    output against the flash_attention kernel's (bf16 tolerance), and
    the device time of the ring's forward and of its forward + backward
    against the kernel's forward and its forward + the oracle's
    backward; per step of the "full"-remat train path (each layer's
    forward twice, its backward once), the ring against the 2 x 32
    flash_attention launches it replaces."""
    from repro_torch import sharding
    from repro_torch.collectives.ring_attention import ring_attention
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    cfg = get_config(TRAIN_ARCH)
    B, S, H, KVH = TRAIN_BATCH, TRAIN_SEQ, cfg.num_heads, cfg.num_kv_heads
    hd, NL = cfg.resolved_head_dim(), cfg.num_layers
    gen = torch.Generator(device="cuda").manual_seed(21)
    mesh = ring_mesh()

    def draw(heads):
        return torch.randn((B, S, heads, hd), generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    args = [(draw(H), draw(KVH), draw(KVH), draw(H)) for _ in range(2)]

    def ring_fwd(q, k, v, do):
        with torch.no_grad(), sharding.set_mesh(mesh):
            return ring_attention(q, k, v, causal=True)

    def ring_fwd_bwd(q, k, v, do):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        with sharding.set_mesh(mesh):
            o = ring_attention(*leaves, causal=True)
        return torch.autograd.grad(o, leaves, do)

    def flash_fwd(q, k, v, do):
        with torch.no_grad():
            return ops.flash_attention(q, k, v, causal=True)

    def flash_fwd_bwd(q, k, v, do):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o = ops.flash_attention(*leaves, causal=True)
        return torch.autograd.grad(o, leaves, do)

    err = check_close("ring attention vs flash_attention", ring_fwd(*args[0]),
                      flash_fwd(*args[0]), torch.bfloat16)
    dev, paced, source = measure(
        {"ring_fwd": ring_fwd, "ring_fwd_bwd": ring_fwd_bwd,
         "flash_fwd": flash_fwd, "flash_fwd_bwd": flash_fwd_bwd}, args,
        dev_iters=4, paced_iters=4)
    ring_step = NL * (dev["ring_fwd"] + dev["ring_fwd_bwd"])
    flash_step = NL * (dev["flash_fwd"] + dev["flash_fwd_bwd"])
    log(f"time: ring attention at smollm-360m's train shape (q [{B}, {S}, "
        f"{H}, {hd}], k/v [{B}, {S}, {KVH}, {hd}], bf16, causal) on "
        f"{RING_MESH} (model ranks {dict(mesh.shape)['model']}; bf16 "
        f"products through bmm's f32 out_dtype); ring output vs the "
        f"flash_attention kernel's max abs err "
        f"{err:.3e} (bf16 atol/rtol 2e-2); device ms ({source}): "
        f"{fmt(dev)}; back to back: {fmt(paced)}; a \"full\" step's "
        f"attention ({NL} layers: forward, then forward + backward): ring "
        f"{ring_step:.3f} ms against flash_attention + the oracle backward "
        f"{flash_step:.3f} ms, whose {2 * NL} flash_attention launches "
        f"take {2 * NL * dev['flash_fwd']:.3f} ms")


def ring_reference_check(seq: int = 128) -> None:
    """One f32 loss and gradient of a two-layer smollm-360m at full width
    (B=2, S=``seq``, TF32 off) with "ring" on the ``RING_MESH`` model
    ranks, held against (a) the same on the CPU (plain versions), (b) the
    card with "xla" (the flash_attention kernel, no mesh), (c) the ring
    on the card under "full" and under "subblock" remat, whose backward
    autograd runs on its device thread, where no mesh and no training
    mode are set (``layers.checkpoint`` re-enters them): loss within
    1e-5 relative, every gradient leaf within 1e-4 of its largest entry
    (the card-vs-CPU limits of ``train_reference_check``).  The ring's
    runs launch no flash_attention, the "xla" run does."""
    from repro_torch import sharding
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.models import registry
    from repro_torch.models.layers import tree_leaves, tree_map
    cfg0 = get_config(TRAIN_ARCH).with_overrides(num_layers=2,
                                                 dtype="float32")
    params = {"cuda": registry.init_params(
        cfg0, torch.Generator(device="cuda").manual_seed(3))}
    params["cpu"] = tree_map(lambda t: t.cpu(), params["cuda"])
    names = [p for p, _ in tree_leaves(params["cpu"])]
    rs = np.random.RandomState(4)
    toks = rs.randint(0, cfg0.vocab_size, size=(2, seq + 1)).astype(np.int32)

    def run(dev, impl, policy="none"):
        cfg = cfg0.with_overrides(attention_impl=impl, remat_policy=policy)
        batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(dev),
                 "labels": torch.from_numpy(toks[:, 1:]).to(dev)}
        leaves = [t.requires_grad_() for _, t in tree_leaves(params[dev])]
        _lib.reset_launches()
        with sharding.set_mesh(ring_mesh(dev) if impl == "ring" else None):
            loss, _ = registry.loss_fn(params[dev], cfg, batch)
        # outside the mesh block, as a step's backward may run
        grads = [g.cpu() for g in torch.autograd.grad(loss, leaves)]
        flash = _lib.launches["flash_attention"]
        if dev == "cuda" and (flash == 0) != (impl == "ring"):
            raise AssertionError(f"{impl} {policy}: {flash} flash_attention "
                                 f"launches")
        return float(loss.detach()), grads

    ref = run("cuda", "ring")
    texts = []
    for label, (dev, impl, policy) in (
            ("CPU ring", ("cpu", "ring", "none")),
            ("card xla", ("cuda", "xla", "none")),
            ("card ring full", ("cuda", "ring", "full")),
            ("card ring subblock", ("cuda", "ring", "subblock"))):
        loss, grads = run(dev, impl, policy)
        if not abs(loss - ref[0]) <= 1e-5 * abs(loss):
            raise AssertionError(f"ring loss {ref[0]} vs {label} {loss}")
        if all(torch.equal(a, b) for a, b in zip(ref[1], grads)):
            g_text = "gradients equal bit for bit"
        else:
            worst = max(leaf_errors(f"ring vs {label} gradient", names,
                                    ref[1], grads, 1e-4))
            g_text = f"worst gradient leaf {worst:.3e}"
        texts.append(f"{label}: loss {loss:.7f} (rel err "
                     f"{abs(loss - ref[0]) / abs(loss):.3e}), {g_text}")
    log(f"check: full-width 2-layer {TRAIN_ARCH} f32 loss and gradients "
        f"(B=2, S={seq}, TF32 off), \"ring\" on the card on {RING_MESH} "
        f"(loss {ref[0]:.7f}) against (limits 1e-5 rel, 1e-4 of each "
        f"leaf's largest entry): " + "; ".join(texts))


def moe_tp_check(groups: int = 2) -> None:
    """The MoE block's tensor-parallel schedule at grok-1's widths (d
    6144, 8 experts of F 32768, top-2, ``groups`` groups of 1024 tokens,
    capacity from its factor 1.25) on the ``RING_MESH`` model ranks (F/tp
    = 8192), held against the einsum branch on the card in f32 with TF32
    off: the output and the gradients of the tokens, the combine weights
    and the three expert weights within 1e-4 of each tensor's largest
    entry.  Then both timed in bf16, forward and forward + backward.  The
    block runs alone: one grok layer's f32 training state does not fit
    the card."""
    from repro_torch import sharding
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    cfg = get_config(GROK)
    mc = cfg.moe
    D, E, Fd = cfg.d_model, mc.num_experts, mc.expert_d_ff
    gen = torch.Generator(device="cuda").manual_seed(31)

    def randn(*shape, fan_in=1):
        return torch.randn(shape, generator=gen, device="cuda") \
            / math.sqrt(fan_in)

    x = randn(groups, mc.group_size, D)
    xg, disp, comb, _ = L._moe_route({"router": randn(D, E, fan_in=D)}, x,
                                     cfg)
    del x
    weights = [randn(E, D, Fd, fan_in=D), randn(E, D, Fd, fan_in=D),
               randn(E, Fd, D, fan_in=Fd)]
    dy = randn(*xg.shape)
    mesh = ring_mesh()
    tp = dict(mesh.shape)["model"]
    C = comb.shape[-1]
    flops = 2 * groups * E * C * D * Fd     # one expert product

    def block(on_mesh, ins, grad=True):
        leaves = [t.detach().requires_grad_(grad and i != 1)
                  for i, t in enumerate(ins)]
        with sharding.set_mesh(mesh if on_mesh else None), \
                L.training_mode():
            want = tp if on_mesh else 1
            if L.moe_tp_ranks(Fd) != want:
                raise AssertionError(f"moe_tp_ranks {L.moe_tp_ranks(Fd)} "
                                     f"!= {want}")
            y = L._moe_expert_block(*leaves)
        if not grad:
            return y
        return y.detach(), torch.autograd.grad(
            y, [leaves[i] for i in (0, 2, 3, 4, 5)], dy.to(y.dtype))

    ins = [xg, disp, comb] + weights
    tp_y, tp_g = block(True, ins)
    ref_y, ref_g = block(False, ins)
    errs = []
    for name, a, b in zip(("y", "xg", "combine", "wi_gate", "wi_up", "wo"),
                          (tp_y,) + tuple(tp_g), (ref_y,) + tuple(ref_g)):
        top = float(b.abs().max())
        err = float((a - b).abs().max())
        if a.shape != b.shape or not torch.isfinite(a).all() \
                or not err <= 1e-4 * top:
            raise AssertionError(f"MoE tensor-parallel {name}: max abs err "
                                 f"{err:.3e} of {top:.3e} (limit 1e-4)")
        errs.append(f"{name} {err / top:.3e}")
    del tp_y, tp_g, ref_y, ref_g, ins
    free()
    ins = [t.to(torch.bfloat16) for t in [xg, disp, comb] + weights]
    del weights
    free()
    args = [tuple(ins)]
    times, paced, source = measure(
        {"tp_fwd": lambda *a: block(True, a, grad=False),
         "einsum_fwd": lambda *a: block(False, a, grad=False),
         "tp_fwd_bwd": lambda *a: block(True, a),
         "einsum_fwd_bwd": lambda *a: block(False, a)},
        args, dev_iters=3, paced_iters=3)
    peak = torch.cuda.max_memory_allocated()
    log(f"check: MoE tensor-parallel block at {GROK}'s widths (xg "
        f"[{groups}, {mc.group_size}, {D}], {E} experts of F {Fd}, top "
        f"{mc.top_k}, capacity {C}) on {tp} model ranks (F/tp "
        f"{Fd // tp}) against the einsum branch, f32 TF32 off, max abs err "
        f"over the largest entry (limit 1e-4): " + ", ".join(errs)
        + f"; bf16 device ms ({source}): {fmt(times)}; back to back: "
        f"{fmt(paced)}; expert products: forward 3 x {flops / 1e12:.3f} "
        f"TFLOP ({3 * flops / times['einsum_fwd'] / 1e9:.1f} TFLOP/s "
        f"einsum, {3 * flops / times['tp_fwd'] / 1e9:.1f} tensor-parallel), "
        f"peak device memory {peak / 2**30:.2f} GiB")


def context_phase() -> dict:
    """Phase 14, the path driven with the launch counts set to 0 just
    before it and read just after (inside ``train``): smollm-360m at full
    width and all 32 layers trained through the train launcher with
    "ring" on ``--mesh RING_MESH`` (no flash_attention launch, the norms
    of the single-card run); one step's time; the ring's device time
    against flash_attention's; then the ring's f32 checks and the MoE
    block's tensor-parallel schedule at grok-1's widths."""
    runs = {}
    runs["train_ring"], report = ring_train_run()
    ring_losses = [m["loss"] for m in report.log]
    train_time_breakdown(report, steps=1, mesh=ring_mesh())
    del report
    free()
    ring_attention_time()
    free()
    ring_reference_check()
    free()
    moe_tp_check()
    free()
    return runs, ring_losses


def ring_train_run():
    """Phase 14's run: smollm-360m at full width and 32 layers with "ring"
    on ``--mesh RING_MESH`` (rank-stacked), ``RING_STEPS`` steps; its
    launches (no flash_attention, the norms of the single-card run) and
    its report."""
    from repro_torch.launch import train as train_mod
    got, report = train(workers=0, mesh=RING_MESH,
                        over={"attention_impl": "ring"}, steps=RING_STEPS)
    single = train_mod.kernel_launches_per_step(report.cfg.with_overrides(
        attention_impl="xla"))
    if got["flash_attention"] != 0 or any(
            got[k] != v * RING_STEPS for k, v in single.items()
            if k != "flash_attention"):
        raise AssertionError(f"ring launches {got} against the single-card "
                             f"step's {single} x {RING_STEPS}")
    return got, report


# ---------------------------------------------------------------------------
# phase 16, its model-axis part: the ring's blocks and the MoE block's
# F-slices on the ranks' cards
# ---------------------------------------------------------------------------

# --mesh 2x2 --rank-devices against the stacked native --mesh 2x2: full
# width at this depth (of 32), f32, these steps, this relative limit on
# every step's loss
DEV_MODEL_2D, DEV_MODEL_LAYERS, DEV_MODEL_STEPS = "2x2", 2, 3
DEV_MODEL_REL = 1e-5
# and grok-1 at its tiny scale with these experts' width (F/2 = 1024: the
# MoE block's F-slices engaged) on batch x seq tokens: a row's 64 tokens
# are one whole group of the scale's routing
DEV_MODEL_GROK_F, DEV_MODEL_GROK_TOKENS = 2048, (8, 16)


def leader_launches(counter, devices, M: int, steps: int,
                    per_step: dict) -> str:
    """Each card's launches a step (``DeviceLaunches``) held to its rows'
    leaders' share: ``per_step`` a leader (rank (d, 0) on ``devices[d *
    M]``), nothing for any other rank; the text that says so."""
    leaders = [torch.device(d) for d in devices[::M]]
    parts = []
    for d in distinct(devices):
        n = leaders.count(d)
        got = {k: counter.by_device.get((d.index, k), 0) / steps
               for k in per_step}
        want = {k: v * n for k, v in per_step.items()}
        if got != want:
            raise AssertionError(f"{d}: launches a step {got}, want {want} "
                                 f"({n} leader(s) on it)")
        parts.append(f"{d} {n} leader(s), "
                     f"{sum(torch.device(x) == d for x in devices) - n} "
                     f"other rank(s): {({k: int(v) for k, v in got.items()})}")
    return "; ".join(parts)


def train_model_devices(ring_losses: list, devices):
    """``launch.train --mesh RING_MESH --rank-devices`` with "ring": phase
    14's run (smollm-360m, full width, 32 layers, ``RING_STEPS`` steps of
    8 x 1024 tokens) with the ring's blocks on the model ranks' cards and
    the replicated layers on the leader's.  Its losses equal phase 14's
    bit for bit; each card's launches (filed under the card current at
    each launch) are its leaders' single-card norms and no
    flash_attention, the other ranks' none; every leaf a replica on the
    leader; the checkpoint restores equal; each card's peak memory."""
    from repro_torch.collectives.rank_shards import RankShards
    from repro_torch.kernels import _lib
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.serve import make_config
    from repro_torch.models.layers import tree_leaves
    M = int(RING_MESH.split("x")[1])
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_model_devices_")
    try:
        args = train_mod.build_parser().parse_args([
            "--arch", TRAIN_ARCH, "--scale", "full", "--device", "cuda",
            "--global-batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--steps", str(RING_STEPS), "--ckpt-dir", ckpt_dir, "--mesh",
            RING_MESH, "--rank-devices", ",".join(devices)])
        config = make_config(TRAIN_ARCH, "full").with_overrides(
            attention_impl="ring")
        for d in distinct(devices):
            torch.cuda.reset_peak_memory_stats(d)
        base, counter = counting_by_device()
        try:
            _lib.reset_launches()
            counter.by_device.clear()
            report = train_mod.run(args, config=config, log_every=1)
            launches = dict(_lib.launches)
        finally:
            restore_counts(base, counter)
        cfg, tr = report.cfg, report.trainer
        if full_width(cfg) != FULL_WIDTH[TRAIN_ARCH]:
            raise AssertionError(f"not the full {TRAIN_ARCH} width: {cfg}")
        single = train_mod.kernel_launches_per_step(
            cfg.with_overrides(attention_impl="xla"))
        per_step = dict(single, flash_attention=0)
        if launches != {k: v * RING_STEPS for k, v in per_step.items()} \
                or not all(launches[k] for k in ("rmsnorm_fwd",
                                                 "rmsnorm_bwd")):
            raise AssertionError(f"model-axis launches {launches}, want "
                                 f"{per_step} x {RING_STEPS}")
        cards = leader_launches(counter, devices, M, RING_STEPS, per_step)
        losses = [m["loss"] for m in report.log]
        if losses != ring_losses:
            raise AssertionError(f"per-device ring losses {losses} differ "
                                 f"from phase 14's {ring_losses}")
        for path, t in tree_leaves(tr.params):
            if not (isinstance(t, RankShards) and t.replica
                    and [str(d) for d in t.devices] == devices[:1]):
                raise AssertionError(f"{path}: {t} is not a replica on the "
                                     f"leader")
        peaks = [torch.cuda.max_memory_allocated(d) / 2**30
                 for d in distinct(devices)]
        ckpt_text = checkpoint_check(tr, RING_STEPS - 1)
        steps_s = [m["step_time_s"] for m in report.log[1:]]
        mean_s = sum(steps_s) / len(steps_s)
        log(f"devices: model axis, {TRAIN_ARCH} at full width and "
            f"{cfg.num_layers} layers with \"ring\" on --mesh {RING_MESH} "
            f"--rank-devices {','.join(devices)}: losses "
            f"{[round(v, 6) for v in losses]}, bit for bit phase 14's; "
            f"launches {launches} ({RING_STEPS} steps; a card a step: "
            f"{cards}); mean step {mean_s * 1e3:.3f} ms (steps "
            f"1-{RING_STEPS - 1}; step 0 "
            f"{report.log[0]['step_time_s'] * 1e3:.3f} ms), "
            f"{TRAIN_BATCH * TRAIN_SEQ / mean_s:.1f} tokens/s; {ckpt_text}; "
            f"peak memory " + per_card(distinct(devices), peaks, " GiB",
                                       ".2f"))
        return launches, report
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def model_devices_breakdown(report, devices, microbatches: int = 1) -> None:
    """One profiled step of the model axis with a device per rank on the
    trained state (``make_row_grads`` over ``microbatches``, then AdamW
    over the placed leaves; one row, so no reduction): the host wall,
    each card's busy ms, idle share and peak memory, each card's launches
    (its leaders' norms), and what ``rank_shards.send`` moved between
    ranks in the step (the ring's hops among it) and how much of it
    crossed between cards."""
    from repro_torch.collectives import rank_shards
    from repro_torch.core import ProgressEngine
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import expert_width_dims
    from repro_torch.train import optimizer as opt_mod
    tr, cfg = report.trainer, report.cfg
    D, M = (int(v) for v in RING_MESH.split("x"))
    mesh = make_mesh((D, M), ("data", "model"), devices=devices)
    ocfg = opt_mod.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=10)
    grad_fn = train_mod.make_row_grads(cfg, mesh, microbatches=microbatches)
    batch = {k: torch.from_numpy(v.copy()).pin_memory() for k, v in
             SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=9)
             .sample().items()}
    state = {"p": tr.params, "o": tr.opt_state}

    cols = train_mod.model_columns(mesh, expert_width_dims(cfg, M),
                                   engine=ProgressEngine(), spec=None)

    def step():
        _, g = grad_fn(state["p"], batch)
        grads = cols.iallreduce_tree(g).wait(timeout=600)
        del g
        state["p"], state["o"], _ = opt_mod.apply(ocfg, state["o"],
                                                  state["p"], grads)
        sync_all(devices)

    # the state and the allocator are warm from the launcher's run
    t0 = time.perf_counter()
    step()
    wall = (time.perf_counter() - t0) * 1e3
    for d in distinct(devices):
        torch.cuda.reset_peak_memory_stats(d)
    rank_shards.reset_transfers()
    base, counter = counting_by_device()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            wall_prof = (time.perf_counter() - t0) * 1e3
    finally:
        restore_counts(base, counter)
    moved = dict(rank_shards.transfers)
    peaks = [torch.cuda.max_memory_allocated(d) / 2**30
             for d in distinct(devices)]
    single = train_mod.kernel_launches_per_step(
        cfg.with_overrides(attention_impl="xla"), microbatches)
    cards = leader_launches(counter, devices, M, 1,
                            dict(single, flash_attention=0))
    busy = busy_by_device(prof)
    busy_t = ("; ".join(f"cuda:{d} busy {v:.3f} ms, idle share "
                        f"{1 - v / wall_prof:.3f}"
                        for d, v in sorted(busy.items()))
              if busy else "busy and idle not measured (no profiler "
                           "events)")
    log(f"time: model-axis step ({TRAIN_ARCH}, {cfg.num_layers} layers, "
        f"--mesh {RING_MESH} on {devices}, {TRAIN_BATCH}x{TRAIN_SEQ} "
        f"tokens in {microbatches} microbatch(es)): wall {wall:.3f} ms ({wall_prof:.3f} ms under the "
        f"profiler); {busy_t}; launches a card: {cards}; sent between "
        f"ranks a step: {moved['sends']} tensors, {moved['bytes'] / 1e9:.3f} "
        f"GB, of them {moved['hops']} ring hops "
        f"({moved['hop_bytes'] / 1e9:.3f} GB); across cards "
        f"{moved['cross_bytes'] / 1e9:.3f} GB"
        + ("" if len(distinct(devices)) > 1 else
           " (the ranks share one card: a send there copies nothing)")
        + "; peak memory " + per_card(distinct(devices), peaks, " GiB",
                                      ".2f"))


def model_devices_2d(devices) -> None:
    """``--mesh DEV_MODEL_2D --rank-devices`` against the stacked native
    ``--mesh DEV_MODEL_2D``, every step's loss within ``DEV_MODEL_REL``
    relative, f32 with "ring", ``DEV_MODEL_STEPS`` steps: smollm-360m at
    full width and ``DEV_MODEL_LAYERS`` layers on 8 x 1024 tokens, and
    grok-1 at its tiny scale with experts ``DEV_MODEL_GROK_F`` wide (its
    F-slices on the model ranks) on ``DEV_MODEL_GROK_TOKENS``, each data
    row one whole group of the batch's MoE routing, whose aux losses take
    the batch's routed shares.  The per-device run takes each row's pass
    on its leader's card and averages the rows' gradients over each model
    column (the stacked run computes the whole batch at once)."""
    import dataclasses

    from repro_torch.launch import train as train_mod
    from repro_torch.launch.serve import make_config
    smollm = make_config(TRAIN_ARCH, "full").with_overrides(
        attention_impl="ring", num_layers=DEV_MODEL_LAYERS, dtype="float32")
    grok = make_config(GROK, "tiny").with_overrides(
        attention_impl="ring", dtype="float32", d_ff=2 * DEV_MODEL_GROK_F)
    grok = grok.with_overrides(moe=dataclasses.replace(
        grok.moe, expert_d_ff=DEV_MODEL_GROK_F))
    for arch, scale, config, (batch, seq), what in (
            (TRAIN_ARCH, "full", smollm, (TRAIN_BATCH, TRAIN_SEQ),
             f"{DEV_MODEL_LAYERS} layers"),
            (GROK, "tiny", grok, DEV_MODEL_GROK_TOKENS,
             f"tiny, experts {DEV_MODEL_GROK_F} wide")):
        losses, walls = {}, {}
        for name, extra in (("stacked", []),
                            ("devices", ["--rank-devices",
                                         ",".join(devices)])):
            ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_model_2d_")
            try:
                args = train_mod.build_parser().parse_args([
                    "--arch", arch, "--scale", scale, "--device", "cuda",
                    "--global-batch", str(batch), "--seq", str(seq),
                    "--steps", str(DEV_MODEL_STEPS), "--ckpt-dir", ckpt_dir,
                    "--mesh", DEV_MODEL_2D] + extra)
                report = train_mod.run(args, config=config, log_every=1)
            finally:
                shutil.rmtree(ckpt_dir, ignore_errors=True)
            losses[name] = [m["loss"] for m in report.log]
            walls[name] = [round(m["step_time_s"] * 1e3, 3)
                           for m in report.log]
            del report
            free()
        rel = [abs(a - b) / abs(b) for a, b in zip(losses["devices"],
                                                   losses["stacked"])]
        if len(rel) != DEV_MODEL_STEPS or not max(rel) <= DEV_MODEL_REL:
            raise AssertionError(f"{arch} --mesh {DEV_MODEL_2D} "
                                 f"--rank-devices losses {losses['devices']} "
                                 f"vs stacked {losses['stacked']}")
        log(f"devices: model axis --mesh {DEV_MODEL_2D} --rank-devices "
            f"{','.join(devices)} ({arch}, {what}, f32, \"ring\", {batch}x"
            f"{seq} tokens): losses "
            f"{[round(v, 7) for v in losses['devices']]} against the "
            f"stacked run's {[round(v, 7) for v in losses['stacked']]}, "
            f"worst rel err {max(rel):.3e} (limit {DEV_MODEL_REL:g}); step "
            f"ms {walls}")


# three more runs of the model-axis part: FSDP on --mesh
# DEV_FSDP_2D with a device per rank at full width and this depth (of
# 32), these steps; its chaos kill of one rank at DEV_CHAOS_LAYERS; and
# --microbatches DEV_MB on the model axis: smollm-360m "ring" on
# RING_MESH at full width and this depth (of 32), these steps, and tiny
# grok-1 (experts DEV_MODEL_GROK_F wide) on --mesh 2x2 over these tokens
# (a row's share of a microbatch one whole group of 64), these steps.
# The depths are cut for the script's time limit (at 8 layers these runs
# took ~58 s on one card, at 4 ~42 s; 2 since the MoE rows' runs)
DEV_FSDP_2D, DEV_FSDP_2D_LAYERS, DEV_FSDP_2D_STEPS = "2x2", 2, 3
DEV_MB, DEV_MB_LAYERS, DEV_MB_STEPS = 2, 2, 3
DEV_MB_GROK_TOKENS, DEV_MB_GROK_STEPS = (16, 16), 2


def card_and_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def train_counted(argv: list, config, devices, saves: bool = True):
    """``launch.train.run`` of ``argv`` with the launch counts set to 0
    just before and read just after, each launch filed under its card
    (``DeviceLaunches``), the peak memory of each of ``devices``' cards
    and what ``rank_shards.send`` moved: (report, launches, counter,
    peaks GiB, transfers).  The checkpoint directory is a fresh one,
    removed after.  Without ``saves`` the Trainer's checkpoint of the last
    step is not written (for runs that check no checkpoint: a full-width
    model's is gigabytes of disk)."""
    from repro_torch.collectives import rank_shards
    from repro_torch.kernels import _lib
    from repro_torch.launch import train as train_mod
    from repro_torch.train.checkpoint import AsyncCheckpointer
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_model_axis_")
    save = AsyncCheckpointer.save_async
    try:
        args = train_mod.build_parser().parse_args(
            argv + ["--device", "cuda", "--ckpt-dir", ckpt_dir])
        for d in distinct(devices):
            torch.cuda.reset_peak_memory_stats(d)
        rank_shards.reset_transfers()
        base, counter = counting_by_device()
        if not saves:
            AsyncCheckpointer.save_async = lambda self, step, tree: None
        try:
            _lib.reset_launches()
            counter.by_device.clear()
            report = train_mod.run(args, config=config, log_every=1)
            launches = dict(_lib.launches)
        finally:
            AsyncCheckpointer.save_async = save
            restore_counts(base, counter)
        peaks = [torch.cuda.max_memory_allocated(d) / 2**30
                 for d in distinct(devices)]
        return report, launches, counter, peaks, dict(rank_shards.transfers)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def step_ms(report) -> str:
    steps = [m["step_time_s"] for m in report.log[1:]]
    return (f"mean step {sum(steps) * 1e3 / len(steps):.3f} ms (steps "
            f"1-{len(report.log) - 1}; step 0 "
            f"{report.log[0]['step_time_s'] * 1e3:.3f} ms)")


def copies_equal(leaves) -> bool:
    """Every copy of each ``RankShards`` leaf equals its first copy (the
    data axis's leaders) bit for bit."""
    def equal(t, leader):
        return torch.equal(t.to(leader.device), leader)

    return all(equal(t, leaf.shards[i % len(leaf.blocks)])
               for leaf in leaves for i, t in enumerate(leaf.shards))


def fsdp_model_axis_devices(devices) -> dict:
    """``launch.train --mesh DEV_FSDP_2D --fsdp --collective-backend user
    --rank-devices`` at full smollm-360m width and ``DEV_FSDP_2D_LAYERS``
    layers, ``DEV_FSDP_2D_STEPS`` steps of 8 x 1024 tokens, 4 MiB
    buckets: each data row's blocks, moments and step counter copied on
    both cards of its row, its gather, pass and reduce-scatter on its
    leader's card over the leaders' column, the reduced blocks sent to
    the other card of the row, where every copy takes its own AdamW step.
    Against the rank-stacked ``--mesh DEV_FSDP_2D --fsdp`` run: the losses
    and grad norms bit for bit, the leaders' blocks the stacked shards,
    every copy its leader's; each card's launches its leaders'
    single-card step, none on the other ranks'; the sends between ranks
    and the bytes across cards a step; each card's peak memory; then one
    profiled step (``fsdp_devices_breakdown``): busy and idle a card.
    Returns the run's launches."""
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.serve import make_config
    D, M = (int(v) for v in DEV_FSDP_2D.split("x"))
    config = make_config(TRAIN_ARCH, "full").with_overrides(
        num_layers=DEV_FSDP_2D_LAYERS)
    argv = ["--arch", TRAIN_ARCH, "--scale", "full", "--global-batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--steps",
            str(DEV_FSDP_2D_STEPS), "--mesh", DEV_FSDP_2D, "--fsdp",
            "--fsdp-bucket-bytes", str(FSDP_BUCKET), "--collective-backend",
            "user", "--collective-algorithm", "ring", "--collective-chunks",
            str(DP_CHUNKS)]
    stacked = train_counted(argv, config, devices)[0]
    want = [(m["loss"], m["grad_norm"]) for m in stacked.log]
    want_shards = [s.clone() for s in stacked.trainer.params]
    want_ms = step_ms(stacked)
    del stacked
    free()
    report, launches, counter, peaks, moved = train_counted(
        argv + ["--rank-devices", ",".join(devices)], config, devices)
    cfg, tr = report.cfg, report.trainer
    if full_width(cfg)[1:] != FULL_WIDTH[TRAIN_ARCH][1:]:
        raise AssertionError(f"not the full {TRAIN_ARCH} width: {cfg}")
    got = [(m["loss"], m["grad_norm"]) for m in report.log]
    if got != want or len(got) != DEV_FSDP_2D_STEPS:
        raise AssertionError(f"--mesh {DEV_FSDP_2D} --fsdp --rank-devices "
                             f"(loss, grad norm) {got}, the stacked run's "
                             f"{want}")
    if not all(s.copies == M and torch.equal(s.to_stacked(w.device), w)
               for s, w in zip(tr.params, want_shards)):
        raise AssertionError("the leaders' blocks differ from the stacked "
                             "shards")
    if not copies_equal([*tr.params, *tr.opt_state.mu, *tr.opt_state.nu]):
        raise AssertionError("a copy of a block differs from its leader's")
    single = train_mod.kernel_launches_per_step(cfg)
    if launches != {k: v * D * DEV_FSDP_2D_STEPS
                    for k, v in single.items()} or not all(
                        launches[k] for k in DEV_KERNELS):
        raise AssertionError(f"--fsdp on a model axis launches {launches}, "
                             f"want {single} x {D} x {DEV_FSDP_2D_STEPS}")
    cards = leader_launches(counter, devices, M, DEV_FSDP_2D_STEPS,
                            {k: single[k] for k in DEV_KERNELS})
    log(f"devices: fsdp on --mesh {DEV_FSDP_2D} --rank-devices "
        f"{','.join(devices)} ({TRAIN_ARCH}, full width, {cfg.num_layers} "
        f"layers, {TRAIN_BATCH}x{TRAIN_SEQ} tokens, "
        f"{report.layout.num_buckets} buckets; {card_and_limit()}): losses "
        f"{[round(v[0], 6) for v in got]} and grad norms bit for bit the "
        f"stacked --mesh {DEV_FSDP_2D} --fsdp run's, the leaders' blocks its "
        f"shards, every copy (blocks and moments) its leader's; launches "
        f"{launches}; a step on each card: {cards}; sent between ranks a "
        f"step: {moved['sends'] / DEV_FSDP_2D_STEPS:g} reduced blocks "
        f"({moved['bytes'] / DEV_FSDP_2D_STEPS / 1e6:.3f} MB), across "
        f"cards {moved['cross_bytes'] / DEV_FSDP_2D_STEPS / 1e6:.3f} MB; "
        f"{step_ms(report)} (stacked: {want_ms}); peak memory "
        + per_card(distinct(devices), peaks, " GiB", ".2f"))
    fsdp_devices_breakdown(report, devices, shape=(D, M))
    return launches


def fsdp_model_axis_chaos(devices) -> None:
    """``--mesh DEV_FSDP_2D --fsdp --rank-devices --chaos-kill 1`` at full
    width and ``DEV_CHAOS_LAYERS`` layers, 4 steps: after step 1 one of 4
    ranks dies, ``plan_mesh(3, prefer_model=2)`` gives (1, 2) on the first
    two cards, the leader holding the whole buckets and the other card a
    copy, the step counters carried.  Against the rank-stacked run with
    the same kill (which equals a restart on (1, 2), phase 10 and the CPU
    tests): the losses bit for bit, one recovery, the survivors' blocks
    the stacked ones, every copy its leader's."""
    from repro_torch.launch.serve import make_config
    config = make_config(TRAIN_ARCH, "full").with_overrides(
        num_layers=DEV_CHAOS_LAYERS)
    argv = ["--arch", TRAIN_ARCH, "--scale", "full", "--global-batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--steps", "4",
            "--mesh", DEV_FSDP_2D, "--fsdp", "--fsdp-bucket-bytes",
            str(FSDP_BUCKET), "--collective-backend", "user",
            "--chaos-kill", "1", "--chaos-kill-step", "1"]
    runs = {}
    for name, extra in (("stacked", []),
                        ("devices", ["--rank-devices", ",".join(devices)])):
        report = train_counted(argv + extra, config, devices)[0]
        if report.trainer.recoveries != 1 or report.reducer.remeshes != 1:
            raise AssertionError(f"{name} chaos run: "
                                 f"{report.trainer.recoveries} recoveries")
        runs[name] = ([m["loss"] for m in report.log],
                      [round(m["step_time_s"] * 1e3, 3) for m in report.log],
                      report.trainer.params)
        del report
        free()
    (want, want_ms, stacked), (got, ms, blocks) = runs["stacked"], \
        runs["devices"]
    if got != want or len(got) != 4:
        raise AssertionError(f"per-device chaos losses {got}, the stacked "
                             f"chaos run's {want}")
    if not copies_equal(blocks) or not all(
            len(b) == 2 and torch.equal(b.shards[0], s.to(b.shards[0].device))
            for b, s in zip(blocks, stacked)):
        raise AssertionError("the survivors' blocks differ")
    log(f"devices: fsdp chaos kill of 1 of 4 ranks on --mesh {DEV_FSDP_2D} "
        f"--rank-devices ({DEV_CHAOS_LAYERS} layers, full width; "
        f"{card_and_limit()}): remesh to (1, 2) on {devices[:2]}, 1 "
        f"recovery; losses {[round(v, 6) for v in got]}, bit for bit the "
        f"stacked chaos run's; the survivors' blocks its, each copy its "
        f"leader's; step ms {ms} (stacked {want_ms})")


def microbatch_model_axis_devices(devices) -> dict:
    """``--mesh RING_MESH --microbatches DEV_MB --rank-devices`` (native
    backend, "ring") at full smollm-360m width and ``DEV_MB_LAYERS``
    layers, ``DEV_MB_STEPS`` steps of 8 x 1024 tokens: the row's share of
    each microbatch on its leader, the ring's blocks on the model ranks'
    cards.  Against the stacked run: the losses bit for bit; each card's
    launches its leader's norms times the microbatches, no
    flash_attention, the other ranks' none; peak memory a card; one
    profiled step (``model_devices_breakdown``).  Then tiny grok-1 with
    experts ``DEV_MODEL_GROK_F`` wide on ``--mesh 2x2 --microbatches
    DEV_MB`` over ``DEV_MB_GROK_TOKENS`` (each row's share of each
    microbatch one whole group), ``DEV_MB_GROK_STEPS`` steps: within
    ``DEV_MODEL_REL`` of the stacked run.  Returns the smollm run's
    launches."""
    import dataclasses

    from repro_torch.launch import train as train_mod
    from repro_torch.launch.serve import make_config
    M = int(RING_MESH.split("x")[1])
    config = make_config(TRAIN_ARCH, "full").with_overrides(
        attention_impl="ring", num_layers=DEV_MB_LAYERS)
    argv = ["--arch", TRAIN_ARCH, "--scale", "full", "--global-batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--steps",
            str(DEV_MB_STEPS), "--mesh", RING_MESH, "--microbatches",
            str(DEV_MB)]
    stacked = train_counted(argv, config, devices)[0]
    want = [m["loss"] for m in stacked.log]
    want_ms = step_ms(stacked)
    del stacked
    free()
    report, launches, counter, peaks, moved = train_counted(
        argv + ["--rank-devices", ",".join(devices)], config, devices)
    cfg = report.cfg
    if full_width(cfg)[1:] != FULL_WIDTH[TRAIN_ARCH][1:]:
        raise AssertionError(f"not the full {TRAIN_ARCH} width: {cfg}")
    losses = [m["loss"] for m in report.log]
    if losses != want or len(losses) != DEV_MB_STEPS:
        raise AssertionError(f"--microbatches {DEV_MB} --rank-devices "
                             f"losses {losses}, the stacked run's {want}")
    per_step = train_mod.kernel_launches_per_step(cfg, DEV_MB, M, TRAIN_SEQ)
    if launches != {k: v * DEV_MB_STEPS for k, v in per_step.items()} \
            or not all(launches[k] for k in ("rmsnorm_fwd", "rmsnorm_bwd")) \
            or per_step["flash_attention"]:
        raise AssertionError(f"microbatched model-axis launches {launches}, "
                             f"want {per_step} x {DEV_MB_STEPS}")
    cards = leader_launches(counter, devices, M, DEV_MB_STEPS,
                            {k: per_step[k] for k in DEV_KERNELS})
    log(f"devices: model axis --mesh {RING_MESH} --microbatches {DEV_MB} "
        f"--rank-devices {','.join(devices)} ({TRAIN_ARCH}, full width, "
        f"{cfg.num_layers} layers, \"ring\", {TRAIN_BATCH}x{TRAIN_SEQ} "
        f"tokens; {card_and_limit()}): losses "
        f"{[round(v, 6) for v in losses]}, bit for bit the stacked run's; "
        f"launches {launches}; a step on each card: {cards}; sent between "
        f"ranks a step: {moved['sends'] / DEV_MB_STEPS:g} tensors, of them "
        f"{moved['hops'] / DEV_MB_STEPS:g} ring hops; across cards "
        f"{moved['cross_bytes'] / DEV_MB_STEPS / 1e9:.3f} GB; "
        f"{step_ms(report)} (stacked: {want_ms}); peak memory "
        + per_card(distinct(devices), peaks, " GiB", ".2f"))
    model_devices_breakdown(report, devices, microbatches=DEV_MB)
    del report
    free()
    grok = make_config(GROK, "tiny").with_overrides(
        attention_impl="ring", dtype="float32", d_ff=2 * DEV_MODEL_GROK_F)
    grok = grok.with_overrides(moe=dataclasses.replace(
        grok.moe, expert_d_ff=DEV_MODEL_GROK_F))
    batch, seq = DEV_MB_GROK_TOKENS
    argv = ["--arch", GROK, "--scale", "tiny", "--global-batch", str(batch),
            "--seq", str(seq), "--steps", str(DEV_MB_GROK_STEPS), "--mesh",
            "2x2", "--microbatches", str(DEV_MB)]
    runs = {}
    for name, extra in (("stacked", []),
                        ("devices", ["--rank-devices", ",".join(devices)])):
        r = train_counted(argv + extra, grok, devices)[0]
        runs[name] = ([m["loss"] for m in r.log],
                      [round(m["step_time_s"] * 1e3, 3) for m in r.log])
        del r
        free()
    got, want = runs["devices"][0], runs["stacked"][0]
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    if len(rel) != DEV_MB_GROK_STEPS or not max(rel) <= DEV_MODEL_REL:
        raise AssertionError(f"{GROK} --mesh 2x2 --microbatches {DEV_MB} "
                             f"--rank-devices losses {got} vs stacked {want}")
    log(f"devices: model axis --mesh 2x2 --microbatches {DEV_MB} "
        f"--rank-devices ({GROK}, tiny, experts {DEV_MODEL_GROK_F} wide, "
        f"f32, \"ring\", {batch}x{seq} tokens): losses "
        f"{[round(v, 7) for v in got]} against the stacked run's "
        f"{[round(v, 7) for v in want]}, worst rel err {max(rel):.3e} "
        f"(limit {DEV_MODEL_REL:g}); step ms "
        f"{ {k: v[1] for k, v in runs.items()} }")
    return launches


# MoE groups that span data rows with a device per rank, each held
# against its stacked run within DEV_MODEL_REL: granite-moe at full
# width, this depth (of 32), f32, "ring", --mesh 2x2 over these tokens
# (three groups of 512, the middle one split between the rows), these
# steps; tiny grok-1 (experts DEV_MODEL_GROK_F wide) over these tokens
# (one group of 64, half on each row), and in DEV_MB microbatches over
# these (each microbatch's group split)
DEV_ROWS_GRANITE_LAYERS, DEV_ROWS_GRANITE_TOKENS = 2, (8, 192)
DEV_ROWS_STEPS = 3
DEV_ROWS_GROK_TOKENS, DEV_ROWS_GROK_MB_TOKENS = (4, 16), (8, 16)


def moe_rows_devices(devices) -> dict:
    """``--mesh 2x2 --rank-devices`` where an MoE group spans the data
    rows: the rows run in lockstep, a group routed whole on the row that
    holds its first token (``layers.moe_apply_rows``), its outputs sent
    back.  granite-moe-3b-a800m at full width and
    ``DEV_ROWS_GRANITE_LAYERS`` layers on ``DEV_ROWS_GRANITE_TOKENS``
    (its experts keep the einsum branch: F/2 = 256), then tiny grok-1
    (experts ``DEV_MODEL_GROK_F`` wide: F-slices on the model ranks) on
    ``DEV_ROWS_GROK_TOKENS`` and in ``DEV_MB`` microbatches on
    ``DEV_ROWS_GROK_MB_TOKENS``; f32, "ring", ``DEV_ROWS_STEPS`` steps,
    no checkpoint written.  Each run's losses hold its stacked ``--mesh
    2x2`` run's within ``DEV_MODEL_REL``, the per-device run with
    PyTorch's stream-mismatch warning made an error; each leader's card
    launches its rows' single-card norms (``kernel_launches_per_step``)
    and no flash_attention, the other ranks' none; logged: the sends a
    step (the ring's hops and the MoE layer's among them), the bytes
    across cards, the step ms.  Returns the granite run's launches."""
    import dataclasses

    from repro_torch.launch import train as train_mod
    from repro_torch.launch.serve import make_config
    from repro_torch.models import layers as L
    M = 2
    granite = make_config(GRANITE, "full").with_overrides(
        attention_impl="ring", dtype="float32",
        num_layers=DEV_ROWS_GRANITE_LAYERS)
    grok = make_config(GROK, "tiny").with_overrides(
        attention_impl="ring", dtype="float32", d_ff=2 * DEV_MODEL_GROK_F)
    grok = grok.with_overrides(moe=dataclasses.replace(
        grok.moe, expert_d_ff=DEV_MODEL_GROK_F))
    out = None
    for arch, scale, config, (batch, seq), k in (
            (GRANITE, "full", granite, DEV_ROWS_GRANITE_TOKENS, 1),
            (GROK, "tiny", grok, DEV_ROWS_GROK_TOKENS, 1),
            (GROK, "tiny", grok, DEV_ROWS_GROK_MB_TOKENS, DEV_MB)):
        argv = ["--arch", arch, "--scale", scale, "--global-batch",
                str(batch), "--seq", str(seq), "--steps",
                str(DEV_ROWS_STEPS), "--mesh", "2x2", "--microbatches",
                str(k)]
        stacked = train_counted(argv, config, devices, saves=False)[0]
        want = [m["loss"] for m in stacked.log]
        want_ms = step_ms(stacked)
        del stacked
        free()
        moe_sent = {"sends": 0, "bytes": 0}
        real_send = L.send

        def moe_send(t, device, **kw):
            moe_sent["sends"] += 1
            moe_sent["bytes"] += t.numel() * t.element_size()
            return real_send(t, device, **kw)

        L.send = moe_send
        try:
            with stream_mismatch_errors():
                report, launches, counter, peaks, moved = train_counted(
                    argv + ["--rank-devices", ",".join(devices)], config,
                    devices, saves=False)
        finally:
            L.send = real_send
        cfg = report.cfg
        if arch == GRANITE and full_width(cfg)[1:] != \
                FULL_WIDTH[GRANITE][1:]:
            raise AssertionError(f"not the full {GRANITE} width: {cfg}")
        got = [m["loss"] for m in report.log]
        rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
        if len(rel) != DEV_ROWS_STEPS or not max(rel) <= DEV_MODEL_REL:
            raise AssertionError(f"{arch} --mesh 2x2 --rank-devices on "
                                 f"{batch}x{seq} tokens in {k} "
                                 f"microbatch(es): losses {got} vs stacked "
                                 f"{want}")
        per_step = train_mod.kernel_launches_per_step(cfg, k, M, seq)
        if launches != {n: v * 2 * DEV_ROWS_STEPS
                        for n, v in per_step.items()} \
                or per_step["flash_attention"]:
            raise AssertionError(f"{arch} lockstep launches {launches}, "
                                 f"want {per_step} x 2 rows x "
                                 f"{DEV_ROWS_STEPS}")
        cards = leader_launches(counter, devices, M, DEV_ROWS_STEPS,
                                {n: per_step[n] for n in DEV_KERNELS})
        groups = batch * seq // k // cfg.moe.group_size
        log(f"devices: MoE groups across data rows, --mesh 2x2 "
            f"--rank-devices {','.join(devices)} ({arch} {scale}, "
            f"{cfg.num_layers} layers, f32, \"ring\", {batch}x{seq} tokens "
            f"in {k} microbatch(es), {max(groups, 1)} group(s) of "
            f"{cfg.moe.group_size} a microbatch; {card_and_limit()}): losses "
            f"{[round(v, 7) for v in got]} against the stacked run's "
            f"{[round(v, 7) for v in want]}, worst rel err {max(rel):.3e} "
            f"(limit {DEV_MODEL_REL:g}); launches {launches}; a step on "
            f"each card: {cards}; sent between ranks a step: "
            f"{moved['sends'] / DEV_ROWS_STEPS:g} tensors, "
            f"{moved['bytes'] / DEV_ROWS_STEPS / 1e9:.4f} GB, of them "
            f"{moved['hops'] / DEV_ROWS_STEPS:g} ring hops "
            f"({moved['hop_bytes'] / DEV_ROWS_STEPS / 1e9:.4f} GB) and "
            f"{moe_sent['sends'] / DEV_ROWS_STEPS:g} the MoE layer's "
            f"({moe_sent['bytes'] / DEV_ROWS_STEPS / 1e9:.4f} GB: a group's "
            f"tokens and outputs between rows, and F-slice traffic), across "
            f"cards {moved['cross_bytes'] / DEV_ROWS_STEPS / 1e9:.4f} GB; "
            f"{step_ms(report)} (stacked: {want_ms}); peak memory "
            + per_card(distinct(devices), peaks, " GiB", ".2f"))
        if out is None:
            out = launches
        del report
        free()
    return out


def ring_devices_check(devices) -> None:
    """The ring with a device per rank alone, at smollm-360m's train shape
    (q [8, 1024, 15, 64], k/v [8, 1024, 5, 64], bf16, causal) on a ``(1,
    4)`` mesh of ``devices``: forward and backward bit for bit against the
    stacked ring on cuda:0, the per-device run under
    ``set_sync_debug_mode("error")`` (no host sync in a hop); the sends a
    call."""
    import importlib

    from repro_torch import sharding
    from repro_torch.collectives import rank_shards
    from repro_torch.launch.mesh import make_mesh
    RA = importlib.import_module("repro_torch.collectives.ring_attention")
    gen = torch.Generator(device="cuda").manual_seed(41)
    B, S, H, KVH, hd = TRAIN_BATCH, TRAIN_SEQ, 15, 5, 64
    q, k, v, do = (torch.randn(*shape, generator=gen, device="cuda")
                   .to(torch.bfloat16)
                   for shape in ((B, S, H, hd), (B, S, KVH, hd),
                                 (B, S, KVH, hd), (B, S, H, hd)))
    meshes = {"stacked": ring_mesh(), "devices": make_mesh(
        (1, len(devices)), ("data", "model"), devices=devices)}

    def run(name, *ins):
        leaves = [t.detach().requires_grad_() for t in ins[:3]]
        with sharding.set_mesh(meshes[name]):
            o = RA.ring_attention(*leaves, causal=True)
        return [o, *torch.autograd.grad(o, leaves, ins[3])]

    want = run("stacked", q, k, v, do)
    sync_all(devices)
    rank_shards.reset_transfers()
    with sync_errors():
        got = run("devices", q, k, v, do)
    moved = dict(rank_shards.transfers)
    sync_all(devices)
    for name, a, b in zip(("o", "dq", "dk", "dv"), want, got):
        if not torch.equal(a, b):
            raise AssertionError(f"per-device ring {name} differs from the "
                                 f"stacked ring's")
    log(f"check: the ring with a device per rank at {TRAIN_ARCH}'s train "
        f"shape (bf16, causal, {len(devices)} ranks on {devices}): output "
        f"and dq/dk/dv bit for bit the stacked ring's on cuda:0, under "
        f"set_sync_debug_mode(\"error\"); a forward + backward sends "
        f"{moved['sends']} tensors ({moved['bytes'] / 1e6:.1f} MB), "
        f"{moved['hops']} of them ring hops ({moved['hop_bytes'] / 1e6:.1f} "
        f"MB), {moved['cross_bytes'] / 1e6:.1f} MB across cards")


def moe_devices_check(devices, groups: int = 2) -> None:
    """The MoE block with each rank's F-slices on its card: grok-1's
    widths (``moe_tp_check``'s inputs: d 6144, 8 experts of F 32768, top
    2, ``groups`` groups of 1024 tokens) on 4 ranks (F/4 = 8192 a rank).
    In f32 with TF32 off, ``y`` and the gradients of the tokens, the
    combine weights and every slice equal the stacked tensor-parallel
    block's bit for bit (each slice's gradient on its rank's card), the
    per-device run under ``set_sync_debug_mode("error")`` and with
    PyTorch's stream-mismatch warning made an error; each card's
    peak memory in that run.  Then both timed in bf16, forward and forward
    + backward."""
    from repro_torch import sharding
    from repro_torch.collectives.rank_shards import RankShards
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    cfg = get_config(GROK)
    mc = cfg.moe
    D, E, Fd = cfg.d_model, mc.num_experts, mc.expert_d_ff
    n = len(devices)
    gen = torch.Generator(device="cuda").manual_seed(31)

    def randn(*shape, fan_in=1):
        return torch.randn(shape, generator=gen, device="cuda") \
            / math.sqrt(fan_in)

    x = randn(groups, mc.group_size, D)
    xg, disp, comb, _ = L._moe_route({"router": randn(D, E, fan_in=D)}, x,
                                     cfg)
    del x
    weights = [randn(E, D, Fd, fan_in=D), randn(E, D, Fd, fan_in=D),
               randn(E, Fd, D, fan_in=Fd)]
    dy = randn(*xg.shape)
    smesh = ring_mesh()
    dmesh = make_mesh((1, n), ("data", "model"), devices=devices)
    dims = (2, 2, 1)
    C = comb.shape[-1]

    def block(mesh, ins, ws, grad=True):
        leaves = [t.detach().requires_grad_(grad and i != 1)
                  for i, t in enumerate(ins)]
        if isinstance(ws[0], RankShards):
            ws = [w.map(lambda t: t.detach().requires_grad_(grad))
                  for w in ws]
            wrt = [t for w in ws for t in w.shards]
        else:
            ws = [w.detach().requires_grad_(grad) for w in ws]
            wrt = ws
        with sharding.set_mesh(mesh), L.training_mode():
            y = L._moe_expert_block(*leaves, *ws)
        if not grad:
            return y
        return y.detach(), torch.autograd.grad(
            y, [leaves[0], leaves[2], *wrt], dy.to(y.dtype))

    ins = [xg, disp, comb]
    ref_y, ref_g = block(smesh, ins, weights)
    slices = [RankShards.from_stacked(w, dmesh, dim=dim)
              for w, dim in zip(weights, dims)]
    del weights
    free()
    cards = distinct(devices)
    sync_all(devices)
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    with sync_errors(), stream_mismatch_errors():
        got_y, got_g = block(dmesh, ins, slices)
    sync_all(devices)
    peaks = [torch.cuda.max_memory_allocated(d) / 2**30 for d in cards]
    held = [torch.equal(got_y, ref_y)] + [
        torch.equal(a, b) for a, b in zip(got_g[:2], ref_g[:2])]
    w = Fd // n
    for k in range(3):
        for r in range(n):
            g = got_g[2 + k * n + r]
            held.append(str(g.device) == str(torch.device(devices[r]))
                        and torch.equal(g.to("cuda:0"), ref_g[2 + k].narrow(
                            dims[k], r * w, w)))
    if not all(held):
        raise AssertionError(f"per-device MoE block against the stacked "
                             f"block: {held}")
    del ref_y, ref_g, got_y, got_g
    free()
    ins16 = [t.to(torch.bfloat16) for t in ins]
    s16 = [s_.map(lambda t: t.to(torch.bfloat16)) for s_ in slices]
    del slices
    free()
    full16 = [sl.to_stacked("cuda:0") for sl in s16]
    times, _, source = measure(
        {"stacked_fwd": lambda *a: block(smesh, a, full16, grad=False),
         "devices_fwd": lambda *a: block(dmesh, a, s16, grad=False),
         "stacked_fwd_bwd": lambda *a: block(smesh, a, full16),
         "devices_fwd_bwd": lambda *a: block(dmesh, a, s16)},
        [tuple(ins16)], dev_iters=2, paced_iters=2)
    log(f"check: MoE block with each rank's F-slices on its card at "
        f"{GROK}'s widths (xg [{groups}, {mc.group_size}, {D}], {E} experts "
        f"of F {Fd}, capacity {C}) on {n} ranks on {devices} (F/{n} = {w} a "
        f"rank): y and the gradients of xg, the combine weights and every "
        f"slice bit for bit the stacked tensor-parallel block's on cuda:0 "
        f"(f32, TF32 off, under set_sync_debug_mode(\"error\")), each "
        f"slice's gradient on its rank's card; peak memory in that run "
        + per_card(cards, peaks, " GiB", ".2f")
        + f" (a rank's slices are {3 * E * D * w * 4 / 2**30:.2f} GiB of "
        f"f32); bf16 device ms ({source}): {fmt(times)}")


def model_devices_phase(devices, ring_losses: list) -> dict:
    """Phase 16's model-axis part (after phase 14, whose losses it takes):
    phase 14's run with ``--rank-devices``, its profiled step, the ring
    alone, ``--mesh 2x2 --rank-devices`` against the stacked run, grok-1's
    MoE block with each rank's F-slices on its card, FSDP on ``--mesh
    2x2 --rank-devices`` and its chaos kill, ``--microbatches`` on the
    model axis, and MoE groups that span the data rows.  Returns the
    paths' launches: each run's counts set to 0 just before it and read
    just after."""
    t0 = time.perf_counter()
    log(f"devices: model axis on {devices}"
        + ("" if len(distinct(devices)) > 1 else
           " (one card: cuda:0 is listed for every rank, so every copy "
           "between ranks stays on it)"))
    spans = {}

    def timed(name, fn, *args):
        t1 = time.perf_counter()
        out = fn(*args)
        free()
        spans[name] = time.perf_counter() - t1
        return out

    launches, report = timed("train", train_model_devices, ring_losses,
                             devices)
    timed("breakdown", model_devices_breakdown, report, devices)
    del report
    free()
    timed("ring", ring_devices_check, devices)
    timed("2x2", model_devices_2d, devices)
    timed("moe", moe_devices_check, devices)
    fsdp = timed("fsdp 2x2", fsdp_model_axis_devices, devices)
    timed("fsdp chaos", fsdp_model_axis_chaos, devices)
    microbatched = timed("microbatches", microbatch_model_axis_devices,
                         devices)
    rows = timed("moe rows", moe_rows_devices, devices)
    log(f"devices: model-axis part done in {time.perf_counter() - t0:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in spans.items()) + " s)")
    return {"train_model_devices": launches,
            "train_fsdp_model_devices": fsdp,
            "train_mb_model_devices": microbatched,
            "train_moe_rows_devices": rows}


# ---------------------------------------------------------------------------
# phase 15: the step cells at the assigned shapes, the dry run, the examples
# ---------------------------------------------------------------------------

# (name, arch, assigned shape, the batch run on one card, build_cell
# options): decode_32k whole (128 lanes: 51.5 GB of bf16 K/V), with bf16
# and with int8 weights on the same cache; long_500k whole; prefill_32k at
# 1 of its 32 sequences (its f32 logits are 19.9 GB a sequence);
# train_4k at 16 of its 256 sequences, in 8 microbatches of 2 (the
# oracle backward's f32 scores [2, 15, 4096, 4096] are 2 GB a tensor; at
# 4 a microbatch the card ran out of memory)
CELLS = (("train_4k", "smollm-360m", "train_4k", 16,
          {"microbatches": 8, "cast_params_bf16": True}),
         ("prefill_32k", "qwen2-0.5b", "prefill_32k", 1, {}),
         ("decode_32k", "qwen2-0.5b", "decode_32k", 128, {}),
         ("decode_32k_int8", "qwen2-0.5b", "decode_32k", 128,
          {"int8_weights": True}),
         ("long_500k", "zamba2-1.2b", "long_500k", 1, {}))
# steps timed after one warm-up step
CELL_TIMED_STEPS = {"decode": 3, "prefill": 1, "train": 1}
# the card-against-CPU checks (f32): 2 layers (zamba2: one group of 6 and
# a tail of 1, its shortest depth with an attention site), 8 decode lanes,
# batch 1 otherwise; prefill over 4096 of its 32768 positions (the CPU's
# plain attention at 32768 needs 60 GB of f32 scores); train at its full
# 4096 positions
CELL_CHECKS = {"decode_32k": (2, 8, None), "decode_32k_int8": (2, 8, None),
               "long_500k": (7, 1, None), "prefill_32k": (2, 1, 4096),
               "train_4k": (2, 1, None)}
DRYRUN_BUDGET_S = 120.0        # the dry run over every 1x1 cell, at most


def to_device(tree, device):
    """A copy of a tree of tensors (dicts and NamedTuples) on ``device``."""
    if hasattr(tree, "_fields"):
        return type(tree)(*(to_device(t, device) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_device(t, device) for t in tree)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def start_dryrun() -> tuple:
    """The dry run over every registered config x assigned shape on the
    1x1 mesh, on the host (it needs no card), in two processes that take
    every other config each, writing their records to a fresh
    directory."""
    from repro_torch.configs import list_configs
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    archs = list_configs()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", "1x1",
         "--arch", ",".join(archs[i::2]), "--out", str(tmp / f"dry{i}.jsonl")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(2)]
    return procs, tmp, time.perf_counter()


def stop(procs) -> None:
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def finish_dryrun(procs, tmp: Path, t0: float, cell_records: list) -> dict:
    """Waits for the dry run until ``DRYRUN_BUDGET_S`` after its start;
    past that it is stopped and only the cells' own records (made in this
    process) are reported.  Prints the one-card roofline table."""
    from repro_torch.analysis import report
    from repro_torch.configs import list_configs
    try:
        texts = [proc.communicate(timeout=max(
            1.0, DRYRUN_BUDGET_S - (time.perf_counter() - t0)))[0]
            for proc in procs]
        seconds = time.perf_counter() - t0
    except subprocess.TimeoutExpired:
        stop(procs)
        log(f"dry run: every 1x1 cell did not finish within "
            f"{DRYRUN_BUDGET_S:.0f} s; it was stopped, and only the five "
            f"cells above are reported")
        rows = cell_records
        seconds = None
    else:
        for proc, text in zip(procs, texts):
            if proc.returncode != 0:
                raise AssertionError(f"the dry run failed:\n{text[-3000:]}")
        order = {a: i for i, a in enumerate(list_configs())}
        rows = sorted((r for i in range(len(procs))
                       for r in report.load(str(tmp / f"dry{i}.jsonl"))),
                      key=lambda r: order[r["arch"]])
        log(f"dry run: every registered config x assigned shape on 1x1, in "
            f"two processes: "
            + "; ".join(t.strip().splitlines()[-1] for t in texts)
            + f" (their own clocks), {seconds:.1f} s from their start beside "
            f"the checks and examples")
    shutil.rmtree(tmp, ignore_errors=True)
    bad = [r for r in rows if r["status"] not in ("ok", "skipped")]
    if bad:
        raise AssertionError(f"dry-run cells failed: {bad}")
    log("dry run, one card (H100 constants):\n"
        + report.roofline_table(rows, "1x1"))
    return {"seconds": seconds, "records": len(rows)}


def cell_step(name, arch, shape_name, batch, kw, kept=None) -> tuple:
    """One cell through ``build_cell`` on the card: its arguments made by
    ``Cell.materialize`` (or, for int8 weights, the bf16 cell's cache
    and batch kept in ``kept``), one warm-up step, then the timed steps
    (CUDA events) with the launch counts set to 0 just before and read
    just after, each against the dry run's meta count of the same cell
    (and, for train, ``kernel_launches_per_step``); the output finite and
    of its shape; the peak device memory; the dry run's one-card bound
    for the same cell and the measured time over it."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec, get_shape
    from repro_torch.kernels import _lib
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import registry
    from repro_torch.serve.quantization import quantize_tree
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    spec = ShapeSpec(shape.name, shape.seq_len, batch, shape.kind)
    t0 = time.perf_counter()
    rec = dryrun.run_cell(arch, shape_name, "1x1", cell_kwargs=kw,
                          batch=batch)
    dry_s = time.perf_counter() - t0
    cell = build_cell(cfg, spec, make_mesh((1, 1), ("data", "model"),
                                           "cuda"), **kw)
    free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if kept is not None:                     # the bf16 cell's cache
        params = registry.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(15))
        args = (quantize_tree(params), kept[0], kept[1])
        del params
    else:
        args = cell.materialize(
            "cuda", torch.Generator(device="cuda").manual_seed(15))
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0

    def step(args):
        out = cell.step_fn(*args)
        if spec.kind == "train":
            return out, (out[0], out[1], args[2])
        if spec.kind == "decode":
            return out, (args[0], out[1], args[2])
        return out, args

    try:
        out, args = step(args)               # warm-up
        torch.cuda.synchronize()
    except RuntimeError:
        free_b, _ = torch.cuda.mem_get_info()
        log(f"cell {name}: the warm-up step failed with "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved, "
            f"{free_b / 2**30:.2f} GiB free on the card, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        raise
    n = CELL_TIMED_STEPS[spec.kind]
    _lib.reset_launches()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        out = None                           # the prefill's 19.9 GB logits
        out, args = step(args)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / n
    launches = dict(_lib.launches)
    peak = torch.cuda.max_memory_allocated()
    derived = {k: v["launches"] * n for k, v in rec["kernels"].items()}
    got = {k: v for k, v in launches.items() if v}
    if got != derived:
        raise AssertionError(f"cell {name}: launches {got} against the dry "
                             f"run's {derived} for {n} step(s)")
    if spec.kind == "train":
        want = {k: v * n for k, v in train_mod.kernel_launches_per_step(
            cfg, microbatches=kw["microbatches"]).items() if v}
        if got != want:
            raise AssertionError(f"cell {name}: launches {got} against "
                                 f"kernel_launches_per_step's {want}")
        loss = float(out[2]["loss"])
        if not math.isfinite(loss):
            raise AssertionError(f"cell {name}: loss {loss}")
        out_text = f"loss {loss:.6f}, grad norm {float(out[2]['grad_norm']):.4f}"
    else:
        logits = out[0] if spec.kind == "decode" else out
        want_shape = (batch, 1 if spec.kind == "decode" else spec.seq_len,
                      cfg.vocab_size)
        if tuple(logits.shape) != want_shape \
                or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"cell {name}: logits {tuple(logits.shape)}"
                                 f" (want {want_shape}) not all finite")
        out_text = f"logits {list(want_shape)} finite"
    busy = ""
    if spec.kind != "train":
        # the device's busy time over as many steps, profiled after the
        # counts were read (the prefill's logits dropped first: 19.9 GB)
        out = logits = None
        state = [args]

        def run():
            for _ in range(n):
                state[0] = step(state[0])[1]

        by_name, _ = profile_kernels(run)
        args = state[0]
        busy = "; " + busy_text(by_name, n, ms, "step", 4)
    rl = rec["roofline"]
    bound_ms = rl["bound_s"] * 1e3
    tokens = batch * (1 if spec.kind == "decode" else spec.seq_len)
    result = dict(ms=ms, launches=launches, peak_gib=peak / 2**30,
                  bound_ms=bound_ms, dominant=rl["dominant"],
                  over_bound=ms / bound_ms, tokens_per_s=tokens / ms * 1e3,
                  model_tflops=rl["model_flops"] / ms / 1e9)
    log(f"cell {name} ({arch} {shape_name}, batch {batch} of "
        f"{shape.global_batch}{', ' + str(kw) if kw else ''}): one step "
        f"{ms:.3f} ms (CUDA events, mean of {n} after one warm-up), "
        f"{result['tokens_per_s']:.1f} tokens/s, "
        f"{result['model_tflops']:.2f} model TFLOP/s; {out_text}; launches "
        f"a step {dict((k, v // n) for k, v in got.items())} = the dry "
        f"run's; peak device memory {peak / 2**30:.2f} GiB; the dry run's "
        f"one-card bound {bound_ms:.3f} ms ({rl['dominant']}: compute "
        f"{rl['compute_s'] * 1e3:.3f}, memory {rl['memory_s'] * 1e3:.3f}, "
        f"counted-bytes upper {rl['memory_s_counted_upper'] * 1e3:.3f} ms), "
        f"measured over bound {result['over_bound']:.2f}; arguments made "
        f"in {fill_s:.2f} s, meta step {rec['compile_s']} s "
        f"(dry run {dry_s:.1f} s){busy}")
    if spec.kind == "decode" and not kw:
        # keep the cache and batch for the int8-weights cell
        return result, rec, (args[1], args[2])
    return result, rec, None


def cell_reference_check(name, arch, shape_name, kw) -> None:
    """The cell's step in f32 at ``CELL_CHECKS``' depth, lanes or batch and
    sequence, on the card (kernels) and on the CPU (plain versions), from
    the same arguments (made on the card, copied to the CPU).  Limits:
    logits |a - b| <= 1e-3 + 1e-3 |b| (the decode checks' limits) and the
    decode's greedy tokens equal; train: the loss and grad norm within
    1e-5 relative, the first moment mu = 0.1·g (the clipped gradient)
    per leaf within 1e-4 of its largest entry (the gradient limit of
    ``train_reference_check``).  The decode caches after the step: every
    position but the one the step wrote (every lane's last) bit for bit,
    and the written rows, activations of the same forward as the logits,
    to the logits' limits, |a - b| <= 1e-3 + 1e-3 |b|; the K rows plus
    p·2^-22 of their largest entry, p the position: the rotary angle p·f
    moves by up to p·2^-23 when the two devices' f32 ``exp`` give a
    frequency f one ulp apart, and a rotated entry by that times the
    row's size.  (Chip runs 4 and 5 held the written rows to 1e-4 of
    their largest entry: the K rows at p = 32767 missed it by the rotary
    term, 4.8e-4, and the V rows, whose second layer reads an attention
    over 32768 keys summed in another order on each device, by 1.09e-4.)
    The rotary cos and sin at p on both devices are printed beside."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec, get_shape
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.layers import tree_leaves
    layers, batch, seq = CELL_CHECKS[name]
    shape = get_shape(shape_name)
    cfg = get_config(arch).with_overrides(num_layers=layers,
                                          dtype="float32")
    spec = ShapeSpec(shape.name, seq or shape.seq_len, batch, shape.kind)
    kw = {k: v for k, v in kw.items() if k != "microbatches"}
    cells = {dev: build_cell(cfg, spec, make_mesh(
        (1, 1), ("data", "model"), dev), **kw) for dev in ("cuda", "cpu")}
    args = {"cuda": cells["cuda"].materialize(
        "cuda", torch.Generator(device="cuda").manual_seed(16))}
    args["cpu"] = to_device(args["cuda"], "cpu")
    out = {dev: cells[dev].step_fn(*args[dev]) for dev in ("cuda", "cpu")}
    torch.cuda.synchronize()
    if spec.kind == "train":
        (_, st_a, m_a), (_, st_b, m_b) = out["cuda"], out["cpu"]
        text = []
        for k in ("loss", "grad_norm"):
            a, b = float(m_a[k]), float(m_b[k])
            if not math.isfinite(a) or not abs(a - b) <= 1e-5 * abs(b):
                raise AssertionError(f"cell {name} check: {k} {a} vs {b}")
            text.append(f"{k} {a:.7f} vs {b:.7f}")
        names = [p for p, _ in tree_leaves(st_b.mu)]
        errs = leaf_errors(f"cell {name} mu", names,
                           [t.cpu() for _, t in tree_leaves(st_a.mu)],
                           [t for _, t in tree_leaves(st_b.mu)], 1e-4)
        text.append(f"worst mu leaf of {len(names)} {max(errs):.3e} of its "
                    f"largest entry (limit 1e-4)")
    else:
        la = (out["cuda"][0] if spec.kind == "decode" else out["cuda"]).cpu()
        lb = out["cpu"][0] if spec.kind == "decode" else out["cpu"]
        err = (la - lb).abs()
        if not torch.isfinite(la).all() \
                or (err > 1e-3 + 1e-3 * lb.abs()).any():
            raise AssertionError(f"cell {name} check: logits differ, max abs "
                                 f"err {float(err.max()):.3e}")
        text = [f"max abs logit err {float(err.max()):.3e} (atol 1e-3, rtol "
                f"1e-3)"]
        if spec.kind == "decode":
            if not torch.equal(la.argmax(-1), lb.argmax(-1)):
                raise AssertionError(f"cell {name} check: greedy tokens "
                                     f"differ")
            text.append("greedy tokens equal")
            text += cache_check(name, spec.seq_len - 1, out, cfg.rope_theta)
    log(f"check: cell {name} in f32 at {layers} layers, batch {batch}, "
        f"{spec.seq_len} positions, card kernels vs CPU plain versions: "
        + "; ".join(text))


def cache_check(name, p: int, out: dict, theta: float) -> list:
    """The decode caches of ``cell_reference_check`` after a step that
    wrote position ``p`` of every lane (see its limits); returns the
    figures it printed."""
    from repro_torch.models.layers import rope, tree_leaves
    # the rotary cos and sin at p on both devices (x = (1, 0) per pair)
    x = torch.cat([torch.ones(1, 1, 1, 32), torch.zeros(1, 1, 1, 32)], -1)
    rot = {dev: rope(x.to(dev), torch.full((1, 1), p, device=dev),
                     theta).cpu() for dev in ("cuda", "cpu")}
    text = [f"rotary cos/sin at position {p}, card vs CPU: max abs diff "
            f"{float((rot['cuda'] - rot['cpu']).abs().max()):.3e}"]
    worst = {}
    for (path, a), (_, b) in zip(tree_leaves(out["cuda"][1]),
                                 tree_leaves(out["cpu"][1])):
        a = a.cpu()
        kv = path[-1].removeprefix("attn_")        # zamba2's attn_k, attn_v
        if kv in ("k", "v"):                       # K/V [L, B, S, KVH, hd]
            if not torch.equal(a[:, :, :p], b[:, :, :p]):
                raise AssertionError(f"cell {name} check: cache "
                                     f"{'/'.join(path)} moved off position "
                                     f"{p}")
            a, b = a[:, :, p].float(), b[:, :, p].float()
        a, b = a.float(), b.float()
        top = float(b.abs().max())
        rotary = p * 2.0 ** -22 * top if kv == "k" else 0.0
        err = (a - b).abs()
        if not torch.isfinite(a).all() \
                or (err > 1e-3 + 1e-3 * b.abs() + rotary).any():
            raise AssertionError(f"cell {name} check: cache {'/'.join(path)}"
                                 f" max abs err {float(err.max()):.3e} (atol "
                                 f"1e-3 + {rotary:.3e}, rtol 1e-3)")
        key = {"k": "k rows", "v": "v rows"}.get(kv, "states")
        worst[key] = max(worst.get(key, 0.0), float(err.max()))
    text.append("cache: every other position bit for bit; written, max abs "
                "err " + ", ".join(f"{k} {v:.3e}"
                                   for k, v in sorted(worst.items()))
                + f" (atol 1e-3, rtol 1e-3; k rows plus p·2^-22 = "
                f"{p * 2.0 ** -22:.3e} of their largest entry)")
    return text


def examples_phase() -> None:
    """The five examples on the card, in this process: ``train_lm
    --scale full --steps 4`` from a fresh directory, then ``--steps 5``
    on the same one (it must resume at the committed step 3 and run step
    4), and the other four at their defaults."""
    from repro_torch.examples import (progress_engine_tour, quickstart,
                                      serve_lm, train_lm, user_collectives)
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_train_lm_")
    try:
        t0 = time.perf_counter()
        first = train_lm.main(["--scale", "full", "--steps", "4",
                               "--ckpt-dir", ckpt])
        second = train_lm.main(["--scale", "full", "--steps", "5",
                                "--ckpt-dir", ckpt])
        if first["resumed_from"] is not None or second["resumed_from"] != 3 \
                or [m["step"] for m in second["log"]] != [4]:
            raise AssertionError(f"train_lm resumed from "
                                 f"{second['resumed_from']}, logged "
                                 f"{[m['step'] for m in second['log']]}")
        log(f"example train_lm: full smollm-360m, 4 steps, then resumed at "
            f"the committed step 3 and ran step 4 (loss "
            f"{second['log'][-1]['loss']:.4f}); {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    del first, second
    free()
    for name, fn in (("quickstart", quickstart.main),
                     ("serve_lm", serve_lm.main),
                     ("user_collectives", user_collectives.main),
                     ("progress_engine_tour", progress_engine_tour.main)):
        t0 = time.perf_counter()
        fn([])
        free()
        log(f"example {name}: done on the card in "
            f"{time.perf_counter() - t0:.1f} s")


def cells_phase() -> dict:
    """Phase 15: each of ``CELLS`` stepped on the card (its launch counts
    set to 0 just before its timed steps and read just after), with no
    other process on the host; then the dry run over every 1x1 cell in a
    host process beside the card-against-CPU checks and the five examples
    (whose printed times are then no measurement), and its table."""
    t_phase = time.perf_counter()
    runs, records, kept = {}, [], None
    for name, arch, shape_name, batch, kw in CELLS:
        # the bf16 decode cell hands its cache on to the int8 one
        result, rec, kept = cell_step(
            name, arch, shape_name, batch, kw,
            kept=kept if kw.get("int8_weights") else None)
        records.append(rec)
        runs[f"cell_{name}"] = result["launches"]
    del kept
    free()
    t_steps = time.perf_counter()
    procs, tmp, t0 = start_dryrun()
    try:
        for name, arch, shape_name, batch, kw in CELLS:
            cell_reference_check(name, arch, shape_name, kw)
            free()
        t_checks = time.perf_counter()
        examples_phase()
        t_examples = time.perf_counter()
        finish_dryrun(procs, tmp, t0, records)
    finally:
        stop(procs)
    log(f"phase 15: the cells' steps {t_steps - t_phase:.1f} s, then beside "
        f"the dry run the card-vs-CPU checks {t_checks - t_steps:.1f} s and "
        f"the examples {t_examples - t_checks:.1f} s, then waiting for the "
        f"dry run {time.perf_counter() - t_examples:.1f} s")
    return runs


def free() -> None:
    """Drop what an ended phase left behind (its engines hold reference
    cycles) and hand the cached blocks back, before the next phase."""
    gc.collect()
    torch.cuda.empty_cache()


def main(argv: list) -> int:
    # first, so that whatever fails after it leaves a trace on stdout
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository (no "
              f"src/repro_torch); nothing was run", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    if argv not in ([], ["--only", "parallel"], ["--only", "serve-sharded"],
                    ["--only", "moe"], ["--only", "families"],
                    ["--only", "context"], ["--only", "cells"],
                    ["--only", "devices"], ["--only", "stages"],
                    ["--only", "model-devices"],
                    ["--only", "families-devices"],
                    ["--only", "native-devices"]):
        print(f"chip_smoke: unknown arguments {argv} (none runs every phase; "
              f"--only parallel the single-card and data-parallel train "
              f"runs and phase 10; --only serve-sharded phase 3's "
              f"caller-driven qwen2-0.5b run and phase 11; --only moe the "
              f"attention kernels and phase 12; --only families the kernels "
              f"at the last three families' shapes and phase 13; --only "
              f"context phase 14; --only cells the kernels at the assigned "
              f"shapes and phase 15; --only devices the data-parallel, "
              f"FSDP and sharded runs it compares with and phase 16; "
              f"--only stages phase 16's pipeline and expert parts; "
              f"--only model-devices phase 14's stacked ring run and "
              f"phase 16's model-axis part; --only families-devices phase "
              f"16's non-dense families; --only native-devices phase 9's "
              f"data-parallel run, phase 10's native FSDP run and phase "
              f"16's 256 MiB allreduces and data-parallel and native "
              f"runs)",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _lib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log(f"card {torch.cuda.get_device_name(0)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]

    info = _lib.build()
    for cmd in info.commands:
        log("build: " + " ".join(cmd))
    log(f"build: {info.path.name} in {info.seconds:.1f} s"
        + ("" if info.commands else " (already built)"))
    _lib.lib()

    if argv == ["--only", "model-devices"]:
        # a partial run (phase 14's stacked ring run and phase 16's
        # model-axis part); it prints no result line
        _, report = ring_train_run()
        ring_losses = [m["loss"] for m in report.log]
        del report
        free()
        launches = model_devices_phase(rank_devices(), ring_losses)
        log(f"partial run: launches of the model-axis run {launches}; "
            f"total {time.perf_counter() - t_start:.1f} s")
        print(smi)
        return 0
    if argv == ["--only", "families-devices"]:
        # a partial run (phase 16's non-dense families); it prints no
        # result line
        launches = families_devices()
        log(f"partial run: launches of the families' per-device runs "
            f"{launches}; total {time.perf_counter() - t_start:.1f} s")
        print(smi)
        return 0
    if argv == ["--only", "native-devices"]:
        # a partial run (the runs phase 16's native part compares with,
        # then that part without the chaos kill); it prints no result line
        _, report = train_dp(None)
        dp_losses = [m["loss"] for m in report.log]
        del report
        free()
        _, report, fsdp_native = train_fsdp("native")
        del report
        free()
        devices = rank_devices()
        log(f"devices: torch.cuda.device_count() = "
            f"{torch.cuda.device_count()}; the mesh's devices {devices}")
        launches = native_devices_part(devices, dp_losses, fsdp_native,
                                       chaos=False)
        log(f"partial run: launches of the per-device runs {launches}; "
            f"total {time.perf_counter() - t_start:.1f} s")
        print(smi)
        return 0
    if argv == ["--only", "stages"]:
        # a partial run (phase 16's stage-per-card and expert-per-card
        # parts); it prints no result line
        devices = rank_devices()
        log(f"devices: torch.cuda.device_count() = "
            f"{torch.cuda.device_count()}; the mesh's devices {devices}")
        stages_experts_phase(devices)
        log(f"partial run: total {time.perf_counter() - t_start:.1f} s")
        print(smi)
        return 0
    if argv == ["--only", "devices"]:
        # a partial run (phase 9's data-parallel run, phase 10's user
        # FSDP run, phase 11's stacked sharded run at phase 16's serving
        # depth, and phase 16); it prints no result line
        _, report = train_dp(None)
        dp_losses = [m["loss"] for m in report.log]
        del report
        free()
        _, report, fsdp_losses = train_fsdp("user")
        del report
        free()
        _, report, fsdp_native = train_fsdp("native")
        del report
        free()
        with no_sync():
            _, srv, report = serve(workers=0,
                                   extra=sharded_flags(SHARDS, "user"),
                                   num_layers=DEV_SERVE_LAYERS)
        sharded = streams(report)
        del srv, report
        free()
        log(f"the runs phase 16 compares with done at "
            f"{time.perf_counter() - t_start:.1f} s")
        launches = devices_phase(dp_losses, fsdp_losses, sharded,
                                 fsdp_native)
        log(f"partial run: launches of the per-device runs {launches}; "
            f"total {time.perf_counter() - t_start:.1f} s")
        print(smi)
        return 0
    if argv == ["--only", "cells"]:
        # a partial run (the kernels at the assigned shapes and phase 15);
        # it prints no result line
        gen = torch.Generator(device="cuda").manual_seed(0)
        kernel_flash_decode(gen, ASSIGNED_DECODE_CASES)
        kernel_flash_attention(gen, PREFILL_ATTENTION_SHAPES)
        log(f"kernels at the assigned shapes done at "
            f"{time.perf_counter() - t_start:.1f} s")
        launches = cells_phase()
        log(f"partial run: launches of the cells {launches}; total "
            f"{time.perf_counter() - t_start:.1f} s")
        print(smi)
        return 0
    if argv == ["--only", "context"]:
        # a partial run (phase 14); it prints no result line
        launches, _ = context_phase()
        log(f"partial run: launches of the ring train run {launches}; total "
            f"{time.perf_counter() - t_start:.1f} s")
        print(smi)
        return 0
    if argv == ["--only", "families"]:
        # a partial run (the kernels at the new shapes and phase 13); it
        # prints no result line
        gen = torch.Generator(device="cuda").manual_seed(0)
        kernel_rmsnorm(gen, RMSNORM_SHAPES[-1:])
        kernel_rmsnorm_bwd(gen, RMSNORM_BWD_SHAPES[-1:])
        kernel_flash_decode(gen, FAMILY_DECODE_CASES)
        kernel_flash_attention(gen, FAMILY_ATTENTION_SHAPES)
        kernel_ssd_chunk(gen, (SSD_ZAMBA2_SHAPE,))
        log(f"kernels at the new shapes done at "
            f"{time.perf_counter() - t_start:.1f} s")
        launches = families_phase()
        log(f"families phase done at {time.perf_counter() - t_start:.1f} s")
        families_reference_checks()
        log(f"partial run: launches of the families' runs {launches}; total "
            f"{time.perf_counter() - t_start:.1f} s")
        print(smi)
        return 0
    if argv == ["--only", "moe"]:
        # a partial run (the attention kernels, capped too, and phase 12);
        # it prints no result line
        gen = torch.Generator(device="cuda").manual_seed(0)
        kernel_flash_decode(gen)
        kernel_flash_attention(gen)
        launches = moe_phase()
        reference_check(GRANITE, num_layers=2)
        train_reference_check(GRANITE)
        log(f"partial run: launches of the MoE runs {launches}; total "
            f"{time.perf_counter() - t_start:.1f} s")
        print(smi)
        return 0
    if argv == ["--only", "serve-sharded"]:
        # a partial run (phase 11 and the run it compares with); it prints
        # no result line
        _, srv, report = serve(workers=0)
        unsharded = streams(report)
        del srv, report
        free()
        launches, _ = serve_sharded_phase(unsharded)
        log(f"partial run: launches of the sharded serve run {launches}; "
            f"total {time.perf_counter() - t_start:.1f} s")
        print(smi)
        return 0
    if argv:
        # a partial run (phase 10 and the runs it compares with); it
        # prints no result line
        _, report = train(workers=0)
        single_losses = [m["loss"] for m in report.log]
        del report
        free()
        _, report = train_dp(single_losses)
        dp_losses = [m["loss"] for m in report.log]
        del report
        free()
        launches, _, _ = parallel_phase(single_losses, dp_losses)
        log(f"partial run: launches of the FSDP run {launches}; total "
            f"{time.perf_counter() - t_start:.1f} s")
        print(smi)
        return 0

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [kernel_rmsnorm(gen), kernel_flash_decode(gen),
            kernel_rmsnorm_bwd(gen), kernel_flash_attention(gen),
            kernel_ssd_chunk(gen)]
    log(f"kernels phase done at {time.perf_counter() - t_start:.1f} s")

    # each path is driven with the launch counts set to 0 just before it
    # and read just after (inside serve() and train())
    runs = {}
    runs["serve"], srv, report = serve(workers=0)
    unsharded = streams(report)
    del report
    time_breakdown(srv)
    del srv
    serve(workers=2, num_layers=SERVE_WORKERS_LAYERS)
    # the report holds its engine: drop both, or the weights and pool
    # outlive the path (qwen2.5-3b's would crowd its training run)
    runs["serve_mamba"], srv, report = serve(
        workers=0, arch=MAMBA, num_layers=MAMBA_SERVE_LAYERS)
    time_breakdown(srv)
    del srv, report
    free()
    runs["serve_qwen2_5_3b"], srv, report = serve(
        workers=0, arch=QWEN3B, kv_cache_dtype="int8",
        num_layers=Q3_SERVE_LAYERS)
    time_breakdown(srv)
    decode_paths_check(srv)
    int8_weights_check(srv)
    del srv, report
    log(f"serve phase done at {time.perf_counter() - t_start:.1f} s")
    free()
    runs["train"], report = train(workers=0)
    train_time_breakdown(report)
    single_losses = [m["loss"] for m in report.log]
    del report
    free()
    train(workers=2, layers=TRAIN_WORKERS_LAYERS)
    free()
    runs["train_mamba"], report = train(workers=0, arch=MAMBA,
                                        layers=MAMBA_TRAIN_LAYERS)
    train_time_breakdown(report)
    del report
    free()
    runs["train_qwen2_5_3b"] = train_qwen3b()
    free()
    log(f"train phase done at {time.perf_counter() - t_start:.1f} s")
    pending = collectives_phase()
    free()
    pending += overlap_phase()
    free()
    if pending <= 0:
        raise AssertionError("no poll found a round of a collective running")
    log(f"collectives phase done at {time.perf_counter() - t_start:.1f} s")
    runs["train_dp"], report = train_dp(single_losses)
    dp_losses = [m["loss"] for m in report.log]
    dp_time_breakdown(report)
    del report
    free()
    dp_gradient_check()
    dp_gradient_check(layers=2)
    free()
    log(f"train_dp phase done at {time.perf_counter() - t_start:.1f} s")
    runs["train_fsdp"], fsdp_losses, fsdp_native = parallel_phase(
        single_losses, dp_losses)
    log(f"parallel phase done at {time.perf_counter() - t_start:.1f} s")
    runs["serve_sharded"], sharded = serve_sharded_phase(unsharded)
    free()
    log(f"sharded serve phase done at {time.perf_counter() - t_start:.1f} s")
    runs.update(devices_phase(dp_losses, fsdp_losses, sharded, fsdp_native))
    log(f"devices phase done at {time.perf_counter() - t_start:.1f} s")
    remat = [remat_check(), remat_check(MAMBA, ("full", "dots"),
                                        layers=MAMBA_DOTS_LAYERS)]
    runs["remat"] = {k: remat[0][k] + remat[1][k] for k in remat[0]}
    free()
    log(f"remat phase done at {time.perf_counter() - t_start:.1f} s")
    runs.update(moe_phase())
    log(f"moe phase done at {time.perf_counter() - t_start:.1f} s")
    runs.update(families_phase())
    log(f"families phase done at {time.perf_counter() - t_start:.1f} s")
    ctx_runs, ring_losses = context_phase()
    runs.update(ctx_runs)
    log(f"context phase done at {time.perf_counter() - t_start:.1f} s")
    # phase 16's model-axis part compares with phase 14's run
    runs.update(model_devices_phase(rank_devices(), ring_losses))
    free()
    log(f"model-axis part done at {time.perf_counter() - t_start:.1f} s")
    runs.update(cells_phase())
    log(f"cells phase done at {time.perf_counter() - t_start:.1f} s")
    # each kernel's launches on the main paths' caller-driven runs, per
    # path and summed: launches_serve and launches_train count every
    # family, the *_mamba, *_qwen2_5_3b, *_granite, *_grok, *_zamba2,
    # *_whisper, *_pixtral and *_ring keys those runs alone (train_ring:
    # smollm-360m on the model axis), and launches_remat
    # the checkpoint-policy runs (smollm-360m's five, and mamba2's "full"
    # and "dots")
    serve_runs = ("serve_mamba", "serve_qwen2_5_3b", "serve_granite",
                  "serve_grok", "serve_zamba2", "serve_whisper")
    train_runs = ("train_mamba", "train_qwen2_5_3b", "train_granite",
                  "train_zamba2", "train_whisper", "train_pixtral",
                  "train_ring")
    for row in rows:
        n = {k: v[row["name"]] for k, v in runs.items()}
        row["launches_serve"] = n["serve"] + sum(n[k] for k in serve_runs)
        row["launches_train"] = n["train"] + sum(n[k] for k in train_runs)
        for k in serve_runs + train_runs:
            row[f"launches_{k}"] = n[k]
        row["launches_remat"] = n["remat"]
        row["launches_train_dp"] = n["train_dp"]
        row["launches_train_fsdp"] = n["train_fsdp"]
        row["launches_train_devices"] = n["train_devices"]
        row["launches_train_fsdp_devices"] = n["train_fsdp_devices"]
        row["launches_train_native_devices"] = n["train_native_devices"]
        row["launches_train_fsdp_native_devices"] = \
            n["train_fsdp_native_devices"]
        row["launches_train_model_devices"] = n["train_model_devices"]
        row["launches_train_fsdp_model_devices"] = \
            n["train_fsdp_model_devices"]
        row["launches_train_mb_model_devices"] = n["train_mb_model_devices"]
        row["launches_train_moe_rows_devices"] = n["train_moe_rows_devices"]
        row["launches_train_families_devices"] = n["train_families_devices"]
        row["launches_serve_sharded"] = n["serve_sharded"]
        row["launches_serve_devices"] = n["serve_devices"]
        for name, *_ in CELLS:
            row[f"launches_cell_{name}"] = n[f"cell_{name}"]
        row["launches"] = (row["launches_serve"] + row["launches_train"]
                           + row["launches_remat"] + n["train_dp"]
                           + n["train_fsdp"] + n["train_devices"]
                           + n["train_fsdp_devices"]
                           + n["train_native_devices"]
                           + n["train_fsdp_native_devices"]
                           + n["train_model_devices"]
                           + n["train_fsdp_model_devices"]
                           + n["train_mb_model_devices"]
                           + n["train_moe_rows_devices"]
                           + n["train_families_devices"] + n["serve_sharded"]
                           + n["serve_devices"]
                           + sum(n[f"cell_{name}"] for name, *_ in CELLS))
    log(f"launches: {runs}")
    reference_check()
    reference_check(QWEN3B, num_layers=2, kv_cache_dtype="int8")
    train_reference_check()
    mamba_decode_check()
    train_reference_check(MAMBA, seq=512)   # two chunks of 256
    reference_check(GRANITE, num_layers=2)
    train_reference_check(GRANITE)
    families_reference_checks()
    events_check()
    log(f"total {time.perf_counter() - t_start:.1f} s")

    keys = ["name", "route", "source", "replaces", "launches",
            "launches_serve", "launches_serve_mamba",
            "launches_serve_qwen2_5_3b", "launches_serve_granite",
            "launches_serve_grok", "launches_serve_zamba2",
            "launches_serve_whisper", "launches_train",
            "launches_train_mamba", "launches_train_qwen2_5_3b",
            "launches_train_granite", "launches_train_zamba2",
            "launches_train_whisper", "launches_train_pixtral",
            "launches_train_ring", "launches_remat", "launches_train_dp",
            "launches_train_fsdp", "launches_train_devices",
            "launches_train_fsdp_devices", "launches_train_native_devices",
            "launches_train_fsdp_native_devices",
            "launches_train_model_devices",
            "launches_train_fsdp_model_devices",
            "launches_train_mb_model_devices",
            "launches_train_moe_rows_devices",
            "launches_train_families_devices", "launches_serve_sharded",
            "launches_serve_devices",
            *(f"launches_cell_{name}" for name, *_ in CELLS),
            "shape", "grid", "launch_split_ms",
            "path", "max_abs_err", "ms", "ms_with_sum",
            "plain_ms", "ms_source", "bound_ms", "bound_by", "library_ms",
            "train_shape", "serve_mamba_shape", "train_mamba_shape",
            "serve_qwen2_5_3b_shape", "train_qwen2_5_3b_shape",
            "serve_granite_shape", "train_granite_shape", "serve_grok_shape",
            "train_grok_shape", "serve_zamba2_shape", "train_zamba2_shape",
            "serve_whisper_self_shape", "serve_whisper_cross_shape",
            "train_whisper_encoder_shape", "train_whisper_self_shape",
            "train_whisper_cross_shape", "train_pixtral_shape",
            "decode_32k_shape", "long_500k_shape", "prefill_32k_shape"]
    print(smi)
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
