#!/usr/bin/env python3
"""Smoke run of the PyTorch port (diffuscene_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no "ok" line):

1. the card's name and power limit (nvidia-smi), and the build of the CUDA
   kernels from csrc/fused_chain.cu, csrc/chamfer_nn.cu,
   csrc/fused_resblock.cu and csrc/set_attention.cu (one nvcc each, started
   together, sm_90a) with its time;
2. the chain kernel (B4) against its plain torch version on the card, at
   the flagship's shapes (C=512, B=64, N=12 and N=21), every chain variant,
   in bf16 and f32 (chain_tf32, split TF32), a ragged B=63, and the
   row_scene and row_skip chains at B=768 (the JAX bench's batch) in bf16
   and at B=256 (run/generate.sh's) and B=768 in f32, with their bound;
   each kernel's launch plan (tile_plan against the library's shared-memory
   sum, clusters that fit at once); each case's time as CUDA events around
   20 eager calls, beside a CUDA-graph replay of 20 calls, the profiler's
   device time and the plain version's time; then the 19 chains of one
   flagship forward (bf16, and f32 beside its split-TF32 and FP32 bounds);
3. one full-width forward of the flagship bedroom denoiser (dim 512, 4
   levels, N=12, point_dim 62, random weights from a seed): the rows engine
   on the kernel against the plain Unet1D module forward, in f32 and bf16;
4. a full 1000-step DDPM sample of 64 scenes through
   SceneDiffusion.sample(fused="rows"), bf16: shape, finiteness, and
   exactly 19,000 chain-kernel calls (apply_chain.launches); then
   torch.profiler over 20 sampling steps (device busy time, idle share, top
   kernels, B4's ms per step);
5. the chamfer nearest-neighbour kernel against its plain torch version on
   the card, distances bit for bit: the shape autoencoder's (16, 2048, 3)
   vs (16, 2025, 3), D=2 and D=5 at that size, a ragged (3, 1000) vs
   (3, 777), identical clouds, and exact ties across two slices of the
   kernel's y sweep (the lower index must win); both directions; each
   launch plan; the backward through the kernel against autograd over the
   plain version; kernel (eager, graph replay, device), plain and
   torch.cdist times;
6. the shape autoencoder's training path at full width (the
   bed_living_diningrooms_lat32 config: latent 32, B=16, 2048 points, Adam
   1e-4, clip 10): one step with the kernel against the same step with the
   plain version, then 30 train steps on 16 synthetic box-surface clouds
   from the seed (finite, falling loss, 2 chamfer-kernel launches a step,
   directed_nn.launches), then encoding 64 clouds, then torch.profiler over
   5 more steps (device busy time, idle share, the kernels that take most,
   B3's share);
7. the ResnetBlock kernel (B1) against its plain torch version on the card:
   C=512, B=64, N=12 and N=21, per-row film, per-scene film, zero film rows
   and no film, C_in 512 (identity residual) and 1024 (x and skip with the
   residual projection, and one (M, 1024) x), bf16 and f32, a ragged B=63,
   and the per-scene and skip blocks at B=256 (run/generate.sh's batch) and
   B=768 (the JAX bench's), bf16 and f32, with their bound (f32 on the
   split-TF32 route, the FP32-rate figure beside); each kernel's launch
   plan (clusters, stages, shared memory, clusters that fit at once); each
   case's time as CUDA events
   around 20 eager calls (the wrapper's host time included, as for the
   other kernels), beside CUDA events around a CUDA-graph replay of 20
   calls (the kernel back to back), profiler device time and the plain
   version's time;
8. the set-attention kernel (B2) against its plain torch version: (64, 12,
   512) and (64, 21, 512), bf16 and f32 (attention_tf32, split TF32), eps
   1e-5 and 1e-3, bf16 (768, 12, 512), and f32 (256, 12, 512)
   (run/generate.sh's batch) and (768, 12, 512), each with its bound (f32
   on the split-TF32 route, the FP32-rate figure beside); each kernel's
   launch plan (tiles, clusters of 4, shared memory, clusters that fit at
   once, the weight bytes a call reads); each case's time as eager calls,
   graph replay, profiler device time and the plain version's; shapes the
   kernels do not take (C=256, 8 heads of 16, N=25) must raise in both
   dtypes;
9. one full-width forward of the flagship through the 3-D engine
   (fused_unet1d_forward, 28 B1 and 1 B2 launches) against the plain Unet1D
   module in f32 and bf16 and against the rows engine, with each engine's
   ms per forward;
10. a full 1000-step DDPM sample of 64 scenes through
   SceneDiffusion.sample(fused=True), bf16: shape, finiteness, exactly
   28,000 B1 and 1,000 B2 launches; torch.profiler over 20 steps (B1's
   and B2's ms per step; a named kernel the profile does not show raises);
11. a 20-step DPM-Solver++ sample of 64 scenes, fused=True, bf16: finite,
   exactly 560 B1 and 20 B2 launches, wall time;
15. the flagship config's own dtype, f32 (the scene phase 3 built):
   through the rows engine, a 1000-step DDPM sample of 64 scenes (exactly
   19,000 chain launches) with a 20-step profile naming chain_tf32; through
   the 3-D engine, a 1000-step DDPM sample of 64 scenes (exactly 28,000 B1
   and 1,000 B2 launches) with a 20-step profile against its step time, a
   20-step DPM-Solver++ sample at run/generate.sh's batch of 256 (exactly
   560 and 20), and a 20-step profile of a B=256 step against its
   host-clock time; each profile names the f32 kernels (resblock_tf32,
   attention_tf32) and gives their ms per step, busy time and idle share;
   then DDPM-1000 at B=16 from one seeded generator: at every step of the
   fused=True trajectory both engines (exact GELU) within FORWARD_TOL of
   the module on that step's x_t (a breach fails and names the step), and
   the three paths run free, their descaled boxes' relative L2 and max
   difference and their class argmax agreement printed for each pair;
12. the scene model's training path at the flagship's full width (the
   diffusion_bedrooms_instancond_lat32_v config: dim 512, 4 levels, N=12,
   v-prediction, loss_separate, loss_iou on the train bounds, clip + Adam,
   B=128, f32), on a synthetic cached dataset of 640 rooms made from the
   seed and read through the copied data pipeline: one Trainer step on the
   card against the same step on the CPU (the loss, every loss term, the
   gradient norm and every parameter's gradient, same t and noise), then
   30 steps on the card (finite, falling loss, the median host-clock
   ms/step around train_step and its one metrics transfer, peak memory),
   then torch.profiler over 5 steps (busy time, idle share, top kernels);
13. the b512 recipe (bf16, ws_fast_vjp, fused Adam with bf16 moments, bf16
   gradients and EMA, B=512): one step's gradients with ws_fast_vjp against
   the same step without it, then 20 finite steps, ms/step, peak memory and
   the profile as in 12;
14. the entry points: cli/train_diffusion.py on the b512 config (its EMA)
   for 3 epochs of the synthetic dataset, writing checkpoints, then
   cli/generate_diffusion.py --fused --dpm on its checkpoint with the EMA
   weights: 64 scenes, exactly 560 B1 and 20 B2 launches, the categorical
   KL in metrics.json;
16. scene completion and re-arrangement in f32 at full width, random
   weights from the seed, on a synthetic cached dataset: (a) DDPM-1000
   completion on the flagship config at run/completion.sh's B=32 with 3
   partial boxes of eval scenes and (b) DDPM-1000 re-arrangement on the
   bedroom rearrange config (5 diffused channels, an instance + arrange
   condition) at run/rearrange.sh's B=32 on eval scenes with N(0, 0.5)
   noise on their translations and angles, both through
   SceneDiffusion.sample(fused=True): exactly 28,000 B1 and 1,000 B2
   launches each, the 3-D engine (exact GELU) within FORWARD_TOL of the
   module on the spliced x_t of every 50th step (a breach names the step),
   the partial slots and the kept channels bit-equal to the inputs, the
   spread of the cond-FiLM rows across scenes printed (non-zero for the
   rearrange model, or the phase fails), wall time and scenes/s, and a
   20-step profile of each task step; (c) the rearrange config's train
   step at its B=128 on the card against the CPU (loss and every
   gradient), then 10 steps (median ms/step, peak memory); (d)
   cli/train_diffusion.py on each config for 2 epochs, then
   cli/completion_rearrange.py --arrange_objects and --num_partial 3, each
   --fused --compute_intersec on one batch of 32: exactly 28,000 and 1,000
   launches, 32 box files, a finite metrics.json;
17. text-conditioned generation in f32 at full width on the bedroom text
   config (dim 512, 9 linear cross-attention blocks over 50 tokens of 768
   through fc_text_f to 512), random weights from the seed, the tokens from
   the port's text pipeline (textfix, the hashed table) over the eval
   scenes of a synthetic cached dataset: (a) DDPM-1000 through
   SceneDiffusion.sample(fused=True) at run/generate_text.sh's B=256,
   exactly 28,000 B1 and 1,000 B2 launches and 9 cross-attention contexts,
   the 3-D engine (exact GELU) within FORWARD_TOL of the module every 50th
   step, wall time and scenes/s, a 20-step profile (busy time, idle share,
   B1 and B2 ms per step) and the 9 cross blocks' device time in such a
   step; (b) DDPM-1000 through fused="rows" at B=64, exactly 19,000 B4
   launches and 9 contexts, the rows engine within FORWARD_TOL of the
   module every 50th step; (c) one step at B=256 on one x_t in every
   scene with the text rolled by one scene: the unrolled output rolled by
   one scene (1e-5), and more than 1e-3 from the unrolled output; (d) the
   text config's train step at B=128 on the card against the CPU (loss and
   every gradient; every cross-attention parameter and fc_text_f with a
   non-zero gradient), then 10 steps (median ms/step, peak memory); (e)
   cli/train_diffusion.py on the text config for 2 epochs, then
   cli/generate_diffusion.py --fused with --fix_order and with --scene_id:
   64 scenes each, exactly 28,000 B1 and 1,000 B2 launches, a box file and
   a sentence file a scene;
18. the evaluation path, on a synthetic cached dataset of 2560 rooms (an
   eval split of 256) and a checkpoint of the flagship model's seeded
   weights written by the port's checkpoint module: (a) run/generate.sh's
   own command, cli/generate_diffusion.py on the flagship config with
   --n_sequences 256 --batch_size 256 --clip_denoised --fused --render
   --compute_intersec (the script's 1000 scenes cut to one batch): exactly
   28,000 B1 and 1,000 B2 launches, 256 renders that the port's PNG reader
   decodes to (256, 256, 3) uint8, iou_states.txt and a finite
   metrics.json, the wall time split into sampling, rendering and metrics;
   (b) a textured-box catalog per class (data.make_synthetic_catalog), then
   generate at B=64 through DPM-Solver++-20 with it, --render
   --render_perspective --save_mesh --compute_intersec
   --judge_mesh_intersec: catalog texels in the renders, 512x512
   perspective renders, the mesh files, every manifest jid from the
   catalog, the judged intersection no larger than the boxes'; then
   cli/completion_rearrange.py --num_partial 3 --render --render_gt at
   B=32 (28,000 and 1,000 launches); (c) the eval split's boxes through
   render_to_folder as the real set, cli/compute_fid_scores.py with
   --features inception (a random InceptionV3 as .npz) and pixel, and
   cli/improved_precision_recall.py with --features vgg (a random VGG16)
   and pixel, on the card, against (a)'s renders (random weights: the
   numbers are not paper-comparable); the pixel, InceptionV3 and VGG16
   features of 8 renders on the card against the CPU within
   EVAL_FEATURE_TOL, and each extractor's images/s on the card.

The phases run in the order 1, 2, 7, 8, 3 with 9 (one set of full-width
models), 4, 10, 11, 15, 5, 6, 12, 13, 14, 16, 17, 18.  TF32 is off for every matmul and
convolution (the references are f32; the f32 B1 kernel's split TF32 is
three tf32 products per f32 product, not TF32 matmul).
Phase 1 prints each kernel's registers, stack and spills from ptxas, and
raises if a split-TF32 kernel (f32 B1, B4 or B2) spills.

    python3 chip_smoke.py --only-resblock

runs phases 1 and 7 alone, the short check of a new B1 kernel (bf16 and
f32), ``--only-f32-engine`` phases 1, 3 + 9 in f32 and 15 (the main path in
its own dtype, both engines), and

    python3 chip_smoke.py --only-chain

phases 1 and 2 alone, the short check of a new chain kernel (bf16 and f32),
``--only-attention`` phases 1 and 8 (B2, bf16 and f32), ``--only-chamfer`` phases 1
and 5 (B3), ``--only-train`` phases 1 and 12-14 (with the train JSON
line), ``--only-tasks`` phases 1 and 16 (with the tasks JSON line) and
``--only-text`` phases 1 and 17 (with the text JSON line) and
``--only-eval`` phases 1 and 18 (with the eval JSON line); none of them
prints an ok line.

The line before the last is the card's name and power limit again, the one
before it a JSON summary of the kernels, the one before that a JSON
summary of phase 18 ("eval": the card, each CLI run's wall time and
launches, the generate command's sampling, rendering and metrics seconds,
the mesh path's checks, FID/KID and precision/recall with their times, and
each extractor's card-vs-CPU agreement and images/s), the one before that
a JSON summary of phase 17 ("text": each text sample's wall time, launches,
contexts, worst engine gap, busy time, idle share and kernel ms per step,
the cross blocks' device time and share, the roll check, the text train
step, the CLIs' times and launches), the one before that a JSON
summary of phase 16 ("tasks": each task sample's wall time, launches,
worst engine gap, FiLM-row spread, busy time and idle share; the rearrange
train step; the CLIs' times and launches), and the one before that a JSON
summary of phases 12-14 ("train": each recipe's ms/step, busy time, idle
share, peak memory and agreement; the CLI pair's times and launches); the
kernels line holds the launches on each main path, worst
error, kernel, plain and library times of one forward's 19 chains and of
its 28 ResnetBlocks, of one set attention and of one chamfer forward, each
with its graph-replay time beside as "graph_ms", and each one's bound; the
chain, ResnetBlock and set-attention entries also carry their f32
kernel's 19 chains, 28 blocks and one call ("f32_ms", "f32_graph_ms",
"f32_plain_ms", "f32_bound_ms" on the split-TF32 route) and the f32 DDPM
sample's launches ("f32_launches"); the ResnetBlock and set-attention
entries carry the task samples' launches ("task_launches"), and the
chain, ResnetBlock and set-attention entries the text samples' launches
("text_launches"), and the ResnetBlock and set-attention entries the
generate command's launches of phase 18 ("eval_launches").  The
last line is
{"ok": true, "device": {...}}.  Exits non-zero without a CUDA device.
"""
import json
import math
import os
import subprocess
import sys
import time

C, B, T = 512, 64, 1000
SEED = 0
DEV = "cuda"
# published peaks of one H100 SXM (NVIDIA data sheet, dense): HBM bytes/s,
# dense bf16 tensor-core FLOP/s, FP32 FLOP/s outside the tensor cores (an
# FMA counted as 2, so FP32 instructions issue at half that rate), dense
# TF32 tensor-core FLOP/s
HBM_BPS, BF16_FLOPS, FP32_FLOPS, TF32_FLOPS = 3.35e12, 989e12, 67e12, 495e12
# split TF32 ("3xTF32"): an f32 product on the tensor cores as three tf32
# products (hi*hi + hi*lo + lo*hi)
TF32_SPLIT = 3
# stated tolerances, kernel vs plain version on the same inputs: f32 differs
# only in summation order; bf16 may also flip a rounding of an intermediate
KERNEL_TOL = {"float32": dict(atol=1e-3, rtol=1e-4), "bfloat16": dict(atol=1e-1, rtol=5e-2)}
# full forward, rows engine vs module: max abs error bound on outputs of O(1)
FORWARD_TOL = {"float32": 2e-3, "bfloat16": 2.5e-1}
# chain variants: per block (film, has_skip, has_res_proj); the flagship's
# forward runs row_scene x5 (downA, midA), scene x5 (downB, midB),
# row_skip x4 (upA) and skip x5 (upB, final)
VARIANTS = {
    "none": [("none", False, False)],
    "scene_res": [("scene", False, True)],
    "row_scene": [("row", False, False), ("scene", False, False)],
    "scene": [("scene", False, False)],
    "row_skip": [("row", False, False), ("scene", True, True)],
    "skip": [("scene", True, True)],
}
FORWARD_MIX = {"row_scene": 5, "scene": 5, "row_skip": 4, "skip": 5}
# B1 cases: name -> (film, C_in, skip form).  film: "row" per-object rows
# (the block0s), "scene" per-scene time rows, "zero" zero rows, "none" no
# film (must equal "zero" exactly); C_in 1024 as x and skip (the engine's
# up blocks) or as one (M, 1024) x (B1's own form)
RB_CASES = {"row": ("row", C, False), "scene": ("scene", C, False),
            "skip": ("scene", 2 * C, True), "cat": ("row", 2 * C, False),
            "zero": ("zero", C, False), "none": ("none", C, False)}
# one flagship forward: 9 block0s, 10 time blocks, 9 skip-concat blocks
RB_FORWARD_MIX = {"row": 9, "scene": 10, "skip": 9}
RB_LARGE_B, RB_LARGE_B_CASES = 768, ("scene", "skip")
ATTN_HEADS, ATTN_DIM_HEAD, ATTN_LARGE_B = 4, 32, 768
DPM_STEPS = 20
# run/generate.sh's batch: the f32 DPM-Solver++ sample (phase 15) and the
# second f32 step profile
GENERATE_B = 256
# B1's large batches, bf16 and f32: run/generate.sh's and the JAX bench's
RB_LARGE_BATCHES = (GENERATE_B, RB_LARGE_B)
# B4's large batches, N=12: the JAX bench's (bench.py) in bf16, and
# run/generate.sh's and the JAX bench's in f32
CHAIN_LARGE_B_CASES = ("row_scene", "row_skip")
CHAIN_LARGE_BATCHES = {"bfloat16": (RB_LARGE_B,), "float32": (GENERATE_B, RB_LARGE_B)}
# the rows engine's chain kernel as the profiler names it, by compute dtype
ROWS_KERNELS = {"bfloat16": (("B4", "chain_sm90"),), "float32": (("B4 f32", "chain_tf32"),)}
# the split-TF32 kernels keep their A fragments in registers: ptxas must
# report no spills for them
NO_SPILL_KERNELS = ("resblock_tf32", "chain_tf32", "attention_tf32")
# the 3-D engine's kernels as the profiler names them, by compute dtype
ENGINE_KERNELS = {"bfloat16": (("B1", "resblock_sm90"), ("B2", "attention_sm90")),
                  "float32": (("B1 f32", "resblock_tf32"), ("B2 f32", "attention_tf32"))}
# B2's cases beyond B=64, N=12: the bf16 kernel at the JAX bench's batch;
# the f32 kernel at run/generate.sh's and the JAX bench's (eps 1e-5, the
# f32 engine's)
ATTN_LARGE_CASES = (("bfloat16", 1e-3, ATTN_LARGE_B),
                    ("float32", 1e-5, GENERATE_B), ("float32", 1e-5, ATTN_LARGE_B))
SAMPLE_PROFILE_STEPS = 20
# phase 15's 1000-step f32 drift check: batch, the box bounds bench.py gives
# the flagship (bench.py:274-279: a bedroom's translations and half-sizes
# in metres) to descale the samples, and ROADMAP section C's bound on the
# free-running drift between two paths (printed beside it, not gated)
DRIFT_B = 16
DRIFT_BOUNDS = {"translations": ((-3.0, 0.0, -3.0), (3.0, 4.0, 3.0)),
                "sizes": ((0.04,) * 3, (2.0,) * 3)}
DRIFT_BOUND = {"rel_l2": 1e-2, "agree": 0.99}
# chamfer cases (B, N, M, D); "identical" compares a cloud with itself;
# "dup" copies 8 y points of each slice of the kernel's M sweep into the
# next slice and puts x points on them: exact ties that span two slices,
# where the lower index must win
CHAMFER_CASES = {"ae": (16, 2048, 2025, 3), "d2": (16, 2048, 2025, 2),
                 "d5": (16, 2048, 2025, 5), "ragged": (3, 1000, 777, 3),
                 "identical": (16, 2048, 2048, 3), "dup": (16, 2048, 2025, 3)}
# stated tolerances, chamfer kernel vs plain version: the kernel repeats the
# plain version's roundings, so distances should be equal; 1e-5 bounds a
# rounding slip on values of O(1).  An index may differ only where both
# candidates' plain distances are within that bound (a tie under rounding).
# Gradients: index_add_ sums with atomics in a varying order, and autograd
# over the plain version forms 2x*g - 2y*g where the backward forms
# 2(x - y)*g, so they agree to rounding of entries of O(1e-6).
CHAMFER_DIST_ATOL = 1e-5
CHAMFER_GRAD_TOL = dict(atol=1e-9, rtol=1e-4)
# AE step, kernel vs plain chamfer: the same forward arithmetic, so the loss
# should agree to rounding; the gradient norm through index_add_ atomics
AE_STEP_TOL = {"loss": 1e-6, "gradnorm": 1e-4}       # relative
AE_CONFIG = "configs/obj_autoencoder/bed_living_diningrooms_lat32.yaml"
AE_STEPS, AE_POINTS, AE_ENCODE, AE_PROFILE_STEPS = 30, 2048, 64, 5
# the scene model's training path (phases 12-14), on a synthetic cached
# dataset made from the seed inside the checkout (build/ is git-ignored):
# 640 rooms, 576 in train + val (4 batches of 128 or one of 512 an epoch)
FLAGSHIP_CONFIG = "configs/uncond/diffusion_bedrooms_instancond_lat32_v.yaml"
B512_CONFIG = "configs/uncond/diffusion_bedrooms_instancond_lat32_v_b512_tpu.yaml"
TRAIN_DATA, TRAIN_OUT, TRAIN_SCENES = "build/smoke_scenes", "build/smoke_train", 640
FLAGSHIP_STEPS, B512_STEPS, TRAIN_PROFILE_STEPS, CLI_EPOCHS, GEN_SCENES = 30, 20, 5, 3, 64
# stated tolerances, the flagship step (f32, TF32 off) on the card vs the CPU:
# the same f32 arithmetic summed in other orders through 28 ResnetBlocks and
# 9 attentions, forward and backward: the loss, each loss term and the
# gradient norm within 1e-4 relative, each parameter's gradient within 1e-3
# in relative L2
TRAIN_STEP_TOL = {"loss": 1e-4, "gradnorm": 1e-4, "grad_rel_l2": 1e-3}
# ws_fast_vjp vs autograd through the exact standardization, bf16, B=512:
# the forward differs by one-pass vs two-pass moments rounded to bf16, the
# backward's projection term uses the bf16 w (2^-9 relative), and both
# differences pass through the bf16 network: the loss within 1e-2 relative,
# the whole gradient within 5e-2 in relative L2, each parameter's within 2e-1
FAST_VJP_TOL = {"loss": 1e-2, "whole": 5e-2, "worst": 2e-1}
# phase 16, scene completion and re-arrangement (run/completion.sh's and
# run/rearrange.sh's B=32, 3 partial boxes, N(0, 0.5) noise on the inputs'
# translations and angles), each sample's engine checked every 50 steps,
# on a synthetic dataset as in phases 12-14
REARRANGE_CONFIG = "configs/rearrange/diffusion_bedrooms_instancond_lat32_v_rearrange.yaml"
TASK_B, TASK_PARTIAL, TASK_NOISE, TASK_CHECK_EVERY = 32, 3, 0.5, 50
TASK_DATA, TASK_OUT = "build/smoke_tasks_data", "build/smoke_tasks"
TASK_TRAIN_STEPS, TASK_CLI_EPOCHS = 10, 2
# phase 17, text-conditioned generation on the bedroom text config (768-wide
# hashed token embeddings of eval scenes' textfix descriptions, through
# fc_text_f to 512): DDPM-1000 through the 3-D engine at
# run/generate_text.sh's B=256 and through the rows engine at B=64, each
# checked every TASK_CHECK_EVERY steps; the train step at the config's
# B=128; the CLIs on a 2-epoch checkpoint, 64 scenes
TEXT_CONFIG = "configs/text/diffusion_bedrooms_instancond_lat32_v_bert.yaml"
TEXT_B, TEXT_ROWS_B, TEXT_TRAIN_STEPS, TEXT_CLI_EPOCHS = GENERATE_B, 64, 10, 2
TEXT_DATA, TEXT_OUT = "build/smoke_text_data", "build/smoke_text"
# a text model's cross-attention contexts a sampling call: 4 down, 1 mid, 4 up
TEXT_CONTEXTS = 9
# the scene-roll check: equal to the rolled output up to rounding, and the
# text must move the output by more than its noise
ROLL_TOL, ROLL_MIN_DIFF = 1e-5, 1e-3
# phase 18, the evaluation path: run/generate.sh's own command on the
# flagship config (DDPM-1000, --fused, f32) at its B=256, one batch (the
# script's 1000 scenes cut to one batch), with --render --compute_intersec;
# the mesh path (a synthetic textured-box catalog) at B=64 through
# DPM-Solver++-20 and completion at run/completion.sh's B=32 with
# --render --render_gt; then FID/KID and precision/recall between the
# generated renders and the eval split's, the backbones on random weights.
# 2560 rooms give an eval split of 256, as many real renders as fake ones.
EVAL_DATA, EVAL_OUT, EVAL_SCENES = "build/smoke_eval_data", "build/smoke_eval", 2560
EVAL_MESH_B, EVAL_CHECK_IMAGES = 64, 8
# the backbones' features of 8 renders on the card against the same modules
# on the CPU, f32 with TF32 off (cuDNN's and oneDNN's f32 convolutions sum
# in other orders, ~94 layers deep): relative L2 of the whole feature
# matrix; the pixel features round to 8 bits after each resize pass, so one
# level (1/255) may flip where the two devices' sums straddle a half
EVAL_FEATURE_TOL = {"pixel": 1.0 / 255 + 1e-6, "inception": 1e-4, "vgg": 1e-4}
# the short checks: phase 1 and one kernel's phase, no ok line
ONLY = ("--only-resblock", "--only-chain", "--only-attention", "--only-chamfer", "--only-train",
        "--only-f32-engine", "--only-tasks", "--only-text", "--only-eval")


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, match, iters=20):
    """Mean device time per call of ``fn`` of the kernels whose name holds
    ``match`` (torch.profiler over ``iters`` calls after a warm-up); NaN if
    the profiler saw none (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA and match in e.key)
    return us / iters / 1e3 if us else float("nan")


def graph_ms(torch, fn, iters=20, replays=5):
    """Mean time per call of ``fn`` replayed from a CUDA graph of ``iters``
    calls: the kernels back to back on the card, without the host's cost of
    each call (CUDA events around ``replays`` replays after a warm one)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def cuda_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def chain_case(fl, torch, variant, n, dtype, seed, batch=B):
    """Random chain inputs on the card: standardized-scale W1/W2 (unit
    variance per output column, as after weight standardization)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=1.0, base=0.0):
        return base + scale * torch.randn(*shape, generator=g, device=dev)

    M = batch * n
    blocks, weights, films, skips = [], [], [], []
    for film, has_skip, res in VARIANTS[variant]:
        blocks.append(fl.ChainBlock(has_skip=has_skip, film=film, has_res_proj=res))
        wd = {"w1": rnd(C, C, scale=0.7 if has_skip else 1.0), "w2": rnd(C, C),
              "b1": rnd(C, scale=0.1), "b2": rnd(C, scale=0.1),
              "gn1_scale": rnd(C, scale=0.1, base=1.0), "gn1_bias": rnd(C, scale=0.1),
              "gn2_scale": rnd(C, scale=0.1, base=1.0), "gn2_bias": rnd(C, scale=0.1)}
        if has_skip:
            wd["w1s"] = rnd(C, C, scale=0.7)
        if res:
            wd["wres"] = rnd(C, C, scale=C ** -0.5)
            wd["bres"] = rnd(C, scale=0.1)
            if has_skip:
                wd["wres_s"] = rnd(C, C, scale=C ** -0.5)
        weights.append(wd)
        if film == "scene":
            films.append(rnd(batch, 2 * C, scale=0.2).to(dtype))
        elif film == "row":
            films.append(rnd(M, 2 * C, scale=0.2).to(dtype))
        else:
            films.append(None)
        skips.append(rnd(M, C).to(dtype) if has_skip else None)
    chain = fl.build_chain(blocks, weights, compute_dtype=dtype)
    return chain, rnd(M, C).to(dtype), films, skips


def chain_work(chain, x, films, skips):
    """The least work of one chain call: every (M, C) x (C, C) product, each
    operand read once and the output written once.  Returns (flops, bytes)."""
    flops = 2 * x.shape[0] * C * C * chain.W.shape[0]
    nbytes = (chain.W.numel() * chain.W.element_size() + chain.V.numel() * 4
              + 2 * x.numel() * x.element_size()
              + sum(t.numel() * t.element_size() for t in films + skips if t is not None))
    return flops, nbytes


def chain_check(fl, torch, variant, n, dtype, seed, batch=B, timed=True):
    """One chain case: kernel vs plain version; with ``timed``, the eager
    (CUDA events), graph-replay, profiler-device and plain times.  Returns
    (ok, error, times or None, work)."""
    dname = str(dtype).split(".")[-1]
    chain, x, films, skips = chain_case(fl, torch, variant, n, dtype, seed, batch=batch)
    got = fl.apply_chain(chain, x, films, skips, n_per_scene=n)
    want = fl.apply_chain_reference(chain, x, films, skips, n_per_scene=n)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ok = (bool(torch.isfinite(got.float()).all())
          and torch.allclose(got.float(), want.float(), **KERNEL_TOL[dname]))
    times = None
    if timed:
        def call():
            return fl.apply_chain(chain, x, films, skips, n_per_scene=n)

        times = dict(ms=cuda_ms(call), graph=graph_ms(torch, call),
                     dev=device_ms(torch, call, "chain"),
                     plain=cuda_ms(lambda: fl.apply_chain_reference(chain, x, films, skips,
                                                                    n_per_scene=n),
                                   iters=20 if batch == B else 5))
    return ok, err, times, chain_work(chain, x, films, skips)


def phase_kernels(fl, torch):
    """Phase 2: B4 vs its plain version; returns (worst error, per-case
    results (err, ms, plain, flops, bytes, device ms, graph ms))."""
    results, failures, worst = {}, [], 0.0
    seed = 100
    for n in (12, 21):
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            for variant in VARIANTS:
                seed += 1
                ok, err, tm, (flops, nbytes) = chain_check(fl, torch, variant, n, dtype, seed)
                worst = max(worst, err)
                results[(n, dname, variant)] = (err, tm["ms"], tm["plain"], flops, nbytes,
                                                tm["dev"], tm["graph"])
                print(f"kernel fused_chain N={n} {dname:8s} {variant:9s} max_abs_err={err:.3e} "
                      f"tol={KERNEL_TOL[dname]} {'ok' if ok else 'FAIL'} "
                      f"kernel_ms={tm['ms']:.4f} graph_ms={tm['graph']:.4f} "
                      f"device_ms={tm['dev']:.4f} plain_ms={tm['plain']:.4f}", flush=True)
                if not ok:
                    failures.append((n, dname, variant, err))
    # a ragged last tile: 63 scenes of 12 rows
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        ok, err, _, _ = chain_check(fl, torch, "row_skip", 12, dtype, 7, batch=63, timed=False)
        worst = max(worst, err)
        print(f"kernel fused_chain N=12 B=63 {dname:8s} row_skip  max_abs_err={err:.3e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append((12, dname, "row_skip B=63", err))
    # large batches: the JAX bench's (B=768) in bf16, and run/generate.sh's
    # (B=256) and the JAX bench's in f32, with their bound
    for dname, batches in CHAIN_LARGE_BATCHES.items():
        dtype = getattr(torch, dname)
        for batch in batches:
            for variant in CHAIN_LARGE_B_CASES:
                seed = 600 + len(variant) + (batch if dname == "float32" else 0)
                ok, err, tm, (flops, nbytes) = chain_check(fl, torch, variant, 12, dtype, seed,
                                                           batch=batch)
                worst = max(worst, err)
                b_ms, b_by, fp32_ms = kernel_bound(dname, flops, nbytes)
                route = "" if fp32_ms is None else f" (3xTF32; FP32 rate {fp32_ms:.4f})"
                print(f"kernel fused_chain N=12 B={batch} {dname:8s} {variant:9s} "
                      f"max_abs_err={err:.3e} tol={KERNEL_TOL[dname]} {'ok' if ok else 'FAIL'} "
                      f"kernel_ms={tm['ms']:.4f} graph_ms={tm['graph']:.4f} "
                      f"device_ms={tm['dev']:.4f} plain_ms={tm['plain']:.4f} bound_ms={b_ms:.4f}"
                      f"{route} ({b_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB)",
                      flush=True)
                if not ok:
                    failures.append((12, dname, f"{variant} B={batch}", err))
    if failures:
        raise RuntimeError(f"chain kernel disagrees with its plain version: {failures}")
    return worst, results


def chain_forward(results):
    """The 19 chains of one flagship forward (N=12, B=64) from phase 2's
    cases, bf16 and f32: eager, graph-replay, device and plain times and the
    bound (bf16 tensor cores; f32 on the 3xTF32 route, with the FP32-rate
    bound beside).  Returns {dtype name: (the sums, bound ms, what bounds
    it)}."""
    out = {}
    for dname in ("bfloat16", "float32"):
        mix = {i: sum(results[(12, dname, v)][i] * k for v, k in FORWARD_MIX.items())
               for i in range(1, 7)}
        b_ms, b_by, fp32_ms = kernel_bound(dname, mix[3], mix[4])
        route = "" if fp32_ms is None else f" on the 3xTF32 route, {fp32_ms:.4f} ms at the FP32 rate"
        print(f"chains of one flagship forward (N=12, B={B}, {dname}, 19 chains): kernel "
              f"{mix[1]:.3f} ms (CUDA events, eager calls), graph replay {mix[6]:.3f} ms, device "
              f"{mix[5]:.3f} ms (profiler), plain {mix[2]:.3f} ms, bound {b_ms:.4f} ms{route} "
              f"({b_by}; {mix[3] / 1e9:.2f} GFLOP, {mix[4] / 1e6:.2f} MB)", flush=True)
        out[dname] = (mix, b_ms, b_by)
    return out


def chain_plan(fl, torch):
    """Each chain kernel's launch at the flagship's shapes and the large
    batches: clusters of 8 CTAs, stages, shared memory a CTA (the plan's sum
    and the library's) and the clusters that fit at once."""
    from diffuscene_tpu_torch.ops import build

    lib = fl.load_library()
    for dname, batches in CHAIN_LARGE_BATCHES.items():
        dtype = getattr(torch, dname)
        code = build.DTYPE_CODES[dtype]
        for n in (12, 21):
            for batch in (B, *batches):
                for variant in ("row_scene", "row_skip"):
                    blocks = [fl.ChainBlock(has_skip=sk, film=f, has_res_proj=r)
                              for f, sk, r in VARIANTS[variant]]
                    p = fl.tile_plan(batch, n, blocks, lib, dtype)
                    skip = any(b.has_skip for b in blocks)
                    print(f"plan fused_chain {dname} N={n} B={batch} {variant}: "
                          f"{p.scenes_per_tile} scenes a tile, {p.clusters} clusters of 8 = "
                          f"{p.ctas} CTAs, {p.stages} stages, {p.smem_bytes} bytes of shared "
                          f"memory a CTA (library {lib.fused_chain_smem_bytes(code, int(skip))}; "
                          f"the H100 allows 232448), {p.resident} clusters fit at once",
                          flush=True)
                    if p.resident is None or p.resident < 1:
                        raise RuntimeError(f"no cluster of the {dname} B4 kernel fits "
                                           f"({p.resident})")


def flagship(torch, dtype):
    from diffuscene_tpu_torch.models import SceneDiffusion, SceneModelConfig

    net_kwargs = dict(
        dim=512, dim_mults=(1, 1, 1, 1), channels=62, objectness_dim=0,
        class_dim=22, angle_dim=2, objfeat_dim=32, context_dim=0,
        instanclass_dim=128, seperate_all=True, compute_dtype=dtype,
    )
    cfg = SceneModelConfig(
        point_dim=62, class_dim=22, angle_dim=2, objectness_dim=0,
        objfeat_dim=32, sample_num_points=12, room_mask_condition=False,
        instance_condition=True, learnable_embedding=True, instance_emb_dim=128,
        model_mean_type="v", model_var_type="fixedsmall",
        schedule_type="linear", beta_start=1e-4, beta_end=0.02, time_num=T,
        loss_separate=True, loss_iou=False,
        net_kwargs=tuple(sorted(net_kwargs.items())),
    )
    return SceneDiffusion(cfg, device="cuda").init(torch.Generator().manual_seed(SEED))


def phase_forward(torch, dtype):
    """Phases 3 and 9: one full-width forward through the rows engine and
    through the 3-D engine, each against the plain module forward, and the
    two engines against each other."""
    from diffuscene_tpu_torch.models import inference as inf
    from diffuscene_tpu_torch.utils.convert import denoiser_tree

    dname = str(dtype).split(".")[-1]
    scene = flagship(torch, dtype)
    net = scene.denoiser
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    x = torch.randn(B, 12, 62, generator=g, device="cuda")
    t = torch.randint(0, T, (B,), generator=g, device="cuda")
    cond, _ = scene.make_condition(B)
    t0 = time.perf_counter()
    prep = inf.prepare_inference_params(net, denoiser_tree(net), num_timesteps=T)
    ctx = inf.precompute_conditioning(net, prep, cond)
    chains = inf.prepare_chain_params(net, prep, frozenset(ctx["film_c"]))
    rows = {"film_c2": {k: v.reshape(-1, v.shape[-1]).contiguous() for k, v in ctx["film_c"].items()}}
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0

    def rows_fwd():
        return inf.fused_unet1d_forward_rows(net, prep, chains, x, t, rows, exact_gelu=True)

    def engine_fwd():
        return inf.fused_unet1d_forward(net, prep, x, t, cond_ctx=ctx, exact_gelu=True)

    def module_fwd():
        with torch.no_grad():
            return net(x, t, cond)

    def compare(a, b):
        return (a - b).abs().max().item(), ((a - b).norm() / b.norm()).item()

    got, want = rows_fwd(), module_fwd()
    torch.cuda.synchronize()
    err, rel = compare(got, want)
    ok = bool(torch.isfinite(got).all()) and got.shape == (B, 12, 62) and err <= FORWARD_TOL[dname]
    rows_ms, module_ms = cuda_ms(rows_fwd, iters=10), cuda_ms(module_fwd, iters=10)
    print(f"forward {dname}: rows engine vs module max_abs_err={err:.3e} rel_l2={rel:.3e} "
          f"tol={FORWARD_TOL[dname]} {'ok' if ok else 'FAIL'} | B={B}: rows_ms={rows_ms:.3f} "
          f"module_ms={module_ms:.3f} prepare_s={prep_s:.3f}", flush=True)
    if not ok:
        raise RuntimeError(f"{dname} rows forward disagrees with the module forward: {err}")

    # phase 9: the 3-D engine, every ResnetBlock on B1 and mid_attn on B2
    from diffuscene_tpu_torch.ops import attention as at
    from diffuscene_tpu_torch.ops import fused_resblock as rb

    torch.cuda.synchronize()
    rb.fused_resnet_block.launches = at.fused_set_attention.launches = 0
    eng = engine_fwd()
    launches = (rb.fused_resnet_block.launches, at.fused_set_attention.launches)
    torch.cuda.synchronize()
    err_m, rel_m = compare(eng, want)
    err_r, rel_r = compare(eng, got)
    ok = (bool(torch.isfinite(eng).all()) and eng.shape == (B, 12, 62) and launches == (28, 1)
          and err_m <= FORWARD_TOL[dname] and err_r <= FORWARD_TOL[dname])
    engine_ms = cuda_ms(engine_fwd, iters=10)
    print(f"forward {dname}: 3-D engine vs module max_abs_err={err_m:.3e} rel_l2={rel_m:.3e}, "
          f"vs rows engine max_abs_err={err_r:.3e} rel_l2={rel_r:.3e} tol={FORWARD_TOL[dname]} "
          f"launches B1={launches[0]} B2={launches[1]} {'ok' if ok else 'FAIL'} | B={B}: "
          f"engine_ms={engine_ms:.3f} rows_ms={rows_ms:.3f}", flush=True)
    if not ok:
        raise RuntimeError(f"{dname} 3-D engine forward disagrees: module {err_m}, rows {err_r}, "
                           f"launches {launches}")
    return scene


def rb_case(torch, name, n, dtype, seed, batch=B):
    """Random B1 inputs on the card, as the flagship's prepared weights are
    scaled: standardized W1/W2 (unit variance per output column)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=1.0, base=0.0):
        return base + scale * torch.randn(*shape, generator=g, device=dev)

    film, c_in, skip_form = RB_CASES[name]
    M = batch * n
    kw = dict(w1=rnd(c_in, C, scale=0.7 if c_in > C else 1.0), b1=rnd(C, scale=0.1),
              gn1_scale=rnd(C, scale=0.1, base=1.0), gn1_bias=rnd(C, scale=0.1),
              w2=rnd(C, C), b2=rnd(C, scale=0.1),
              gn2_scale=rnd(C, scale=0.1, base=1.0), gn2_bias=rnd(C, scale=0.1))
    if c_in != C:
        kw.update(w_res=rnd(c_in, C, scale=c_in ** -0.5), b_res=rnd(C, scale=0.1))
    kw = {k: (v.to(dtype) if k in ("w1", "w2", "w_res") else v) for k, v in kw.items()}
    x = rnd(M, c_in).to(dtype)
    skip = None
    if skip_form:
        x, skip = x[:, :C].contiguous(), x[:, C:].contiguous()
    f = {"row": lambda: rnd(M, 2 * C, scale=0.2).to(dtype),
         "scene": lambda: rnd(batch, 2 * C, scale=0.2).to(dtype),
         "zero": lambda: torch.zeros(M, 2 * C, dtype=dtype, device=dev),
         "none": lambda: None}[film]()
    return (x, f), dict(kw, skip=skip, n_per_scene=n, compute_dtype=dtype)


def rb_work(args, kw):
    """The least work of one B1 call: every product, each operand read once
    and the output written once.  Returns (flops, bytes)."""
    x, f = args
    M = x.shape[0]
    c_in = kw["w1"].shape[0]
    k_total = c_in + C + (c_in if kw.get("w_res") is not None else 0)
    flops = 2 * M * C * k_total
    tensors = [x, f, kw["skip"], kw["w1"], kw["w2"], kw.get("w_res")]
    nbytes = sum(t.numel() * t.element_size() for t in tensors if t is not None)
    nbytes += 7 * C * 4 + M * C * x.element_size()
    return flops, nbytes


def rb_check(rb, torch, name, n, dtype, seed, batch=B, timed=True):
    """One B1 case: kernel vs plain version ("none" must also equal zero
    film rows exactly); with ``timed``, the eager (CUDA events),
    graph-replay, profiler-device and plain times.  Returns (ok, error,
    times or None, (flops, bytes))."""
    dname = str(dtype).split(".")[-1]
    args, kw = rb_case(torch, name, n, dtype, seed, batch=batch)
    got = rb.fused_resnet_block(*args, **kw)
    want = rb.fused_resnet_block_reference(*args, **kw)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ok = (bool(torch.isfinite(got.float()).all())
          and torch.allclose(got.float(), want.float(), **KERNEL_TOL[dname]))
    if name == "none":   # no film is zero film rows, exactly
        zero = torch.zeros(args[0].shape[0], 2 * C, dtype=dtype, device="cuda")
        ok = ok and torch.equal(got, rb.fused_resnet_block(args[0], zero, **kw))
    times = None
    if timed:
        def call():
            return rb.fused_resnet_block(*args, **kw)

        times = dict(ms=cuda_ms(call), graph=graph_ms(torch, call),
                     dev=device_ms(torch, call, "resblock"),
                     plain=cuda_ms(lambda: rb.fused_resnet_block_reference(*args, **kw),
                                   iters=20 if batch == B else 5))
    return ok, err, times, rb_work(args, kw)


def phase_resblock(rb, torch):
    """Phase 7: B1 vs its plain version; returns (worst error, results)."""
    results, failures, worst = {}, [], 0.0
    seed = 300
    for n in (12, 21):
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            for name in RB_CASES:
                seed += 1
                ok, err, tm, (flops, nbytes) = rb_check(rb, torch, name, n, dtype, seed)
                worst = max(worst, err)
                results[(n, dname, name)] = (err, tm["ms"], tm["plain"], flops, nbytes, tm["dev"],
                                             tm["graph"])
                b_ms, b_by, fp32_ms = kernel_bound(dname, flops, nbytes)
                route = "" if fp32_ms is None else f" (3xTF32; FP32 rate {fp32_ms:.4f})"
                print(f"kernel fused_resblock N={n} {dname:8s} {name:5s} max_abs_err={err:.3e} "
                      f"tol={KERNEL_TOL[dname]} {'ok' if ok else 'FAIL'} kernel_ms={tm['ms']:.4f} "
                      f"graph_ms={tm['graph']:.4f} device_ms={tm['dev']:.4f} "
                      f"plain_ms={tm['plain']:.4f} bound_ms={b_ms:.4f}{route} ({b_by})", flush=True)
                if not ok:
                    failures.append((n, dname, name, err))
    # a ragged last tile: 63 scenes of 12 rows
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        ok, err, _, _ = rb_check(rb, torch, "skip", 12, dtype, 7, batch=63, timed=False)
        worst = max(worst, err)
        print(f"kernel fused_resblock N=12 B=63 {dname:8s} skip  max_abs_err={err:.3e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append((12, dname, "skip B=63", err))
    # run/generate.sh's batch and the JAX bench's (B=256, 768): the
    # per-scene-film and the skip blocks
    for batch in RB_LARGE_BATCHES:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            for name in RB_LARGE_B_CASES:
                ok, err, tm, (flops, nbytes) = rb_check(rb, torch, name, 12, dtype,
                                                        500 + batch + len(name), batch=batch)
                worst = max(worst, err)
                b_ms, b_by, fp32_ms = kernel_bound(dname, flops, nbytes)
                route = "" if fp32_ms is None else f" (3xTF32; FP32 rate {fp32_ms:.4f})"
                results[(12, dname, name, batch)] = (err, tm["ms"], tm["plain"], flops, nbytes,
                                                     tm["dev"], tm["graph"])
                print(f"kernel fused_resblock N=12 B={batch} {dname:8s} {name:5s} "
                      f"max_abs_err={err:.3e} {'ok' if ok else 'FAIL'} kernel_ms={tm['ms']:.4f} "
                      f"graph_ms={tm['graph']:.4f} device_ms={tm['dev']:.4f} "
                      f"plain_ms={tm['plain']:.4f} bound_ms={b_ms:.4f}{route} ({b_by}; "
                      f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB)", flush=True)
                if not ok:
                    failures.append((12, dname, f"{name} B={batch}", err))
    if failures:
        raise RuntimeError(f"resblock kernel disagrees with its plain version: {failures}")
    return worst, results


def resblock_forward(worst, results):
    """The 28 B1 blocks of one flagship forward (N=12, B=64) from phase 7's
    cases, bf16 and f32: CUDA-event (eager and graph replay), device, plain
    and bound times (bf16 tensor cores; f32 on the 3xTF32 route, with the
    FP32-rate bound beside).  Returns (worst error, {dtype name: (the
    sums, bound ms, what bounds it)})."""
    out = {}
    for dname in ("bfloat16", "float32"):
        mix = {i: sum(results[(12, dname, v)][i] * k for v, k in RB_FORWARD_MIX.items())
               for i in (1, 2, 3, 4, 5, 6)}
        b_ms, b_by, fp32_ms = kernel_bound(dname, mix[3], mix[4])
        route = "" if fp32_ms is None else f" on the 3xTF32 route, {fp32_ms:.4f} ms at the FP32 rate"
        print(f"ResnetBlocks of one flagship forward (N=12, B={B}, {dname}, 28 blocks): "
              f"kernel {mix[1]:.3f} ms (CUDA events, eager calls), graph replay {mix[6]:.3f} ms "
              f"(CUDA events), device {mix[5]:.3f} ms (profiler), plain "
              f"{mix[2]:.3f} ms, bound {b_ms:.4f} ms{route} ({b_by}; {mix[3] / 1e9:.2f} GFLOP, "
              f"{mix[4] / 1e6:.2f} MB)", flush=True)
        out[dname] = (mix, b_ms, b_by)
    return worst, out


def resblock_plan(rb, torch):
    """Each B1 kernel's launch at the flagship's shapes: clusters of 8 CTAs,
    stages, shared memory a CTA (the plan's sum and the library's) and the
    clusters that fit on the card at once."""
    from diffuscene_tpu_torch.ops import build

    lib = rb.load_library()
    for dtype in (torch.bfloat16, torch.float32):
        code = build.DTYPE_CODES[dtype]
        dname = "bf16" if dtype == torch.bfloat16 else "f32"
        for n in (12, 21):
            for kx, ks in ((C, 0), (C, C)):
                p = rb.tile_plan(B, n, kx, ks, dtype)
                fit = lib.fused_resblock_max_active_clusters(code, kx, ks, int(ks > 0))
                print(f"plan fused_resblock {dname} N={n} B={B} C_in={kx}+{ks}: "
                      f"{p.scenes_per_tile} scenes a tile, {p.clusters} clusters of 8 = {p.ctas} "
                      f"CTAs, {p.stages} stages, {p.smem_bytes} bytes of shared memory a CTA "
                      f"(library {lib.fused_resblock_smem_bytes(code, kx, ks)}), {fit} clusters fit "
                      f"at once", flush=True)
                if fit < 1:
                    raise RuntimeError(f"no cluster of the {dname} B1 kernel fits ({fit})")


def ptxas_summary(text):
    """Per kernel of a ptxas -v report: (mangled name, the line with its
    registers, the line with its spills)."""
    out, name, spill = [], None, ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and name:
            out.append((name, line.split(":", 1)[-1].strip(), spill))
            name, spill = None, ""
    return out


def attention_plan(at, torch):
    """Each B2 kernel's launch at the flagship's shapes and the large
    batches: tiles, clusters of 4 CTAs launched (bf16: at most those
    resident at once, each walking its tiles; f32: one a tile), the clusters
    that fit at once, shared memory a CTA (the plan's sum and the
    library's), and the weight bytes the CTAs of a call read (f32: each
    CTA's split W_qkv columns and W_out block, once a tile)."""
    from diffuscene_tpu_torch.ops import build

    lib = at.load_library()
    for dtype, batches in ((torch.bfloat16, (B, ATTN_LARGE_B)),
                           (torch.float32, (B, GENERATE_B, ATTN_LARGE_B))):
        code = build.DTYPE_CODES[dtype]
        dname = "bf16" if dtype == torch.bfloat16 else "f32"
        resident = lib.set_attention_max_active_clusters(code)
        if resident <= 0:
            raise RuntimeError(f"set_attention_max_active_clusters({dname}) failed ({resident})")
        for n in (12, 21, 24):
            for batch in batches:
                p = at.tile_plan(batch, n, resident, dtype)
                print(f"plan set_attention {dname} N={n} B={batch}: {p.scenes_per_tile} scenes a "
                      f"tile, {p.tiles} tiles, {p.clusters} clusters of {at.HEADS} = {p.ctas} CTAs "
                      f"({resident} clusters fit at once; {p.tiles / min(p.clusters, resident):.2f} "
                      f"tiles a resident cluster), {p.smem_bytes} bytes of shared memory a CTA "
                      f"(library {lib.set_attention_smem_bytes(code)}), 288 threads a CTA (two "
                      f"consumer warpgroups, a producer warp), {p.weight_bytes / 1e6:.2f} MB of "
                      f"{'split ' if dname == 'f32' else ''}weights read a call", flush=True)


def phase_attention(at, torch):
    """Phase 8: B2 vs its plain version: (64, 12, 512) and (64, 21, 512) in
    bf16 and f32 at eps 1e-5 and 1e-3, bf16 (768, 12, 512), and f32
    (256, 12, 512) and (768, 12, 512); each with eager, graph-replay, device
    and plain times and its bound (f32 on the split-TF32 route, the FP32
    rate beside); shapes the kernels do not take must raise.  Returns
    (worst error, results)."""
    dev = torch.device("cuda")
    results, failures, worst = {}, [], 0.0
    hd = ATTN_HEADS * ATTN_DIM_HEAD
    g = torch.Generator(device=dev).manual_seed(SEED + 30)

    def rnd(*shape, scale=1.0, base=0.0):
        return base + scale * torch.randn(*shape, generator=g, device=dev)

    cases = [(n, dtype, eps, B) for n in (12, 21) for dtype in (torch.bfloat16, torch.float32)
             for eps in (1e-5, 1e-3)]
    cases += [(12, getattr(torch, dname), eps, batch) for dname, eps, batch in ATTN_LARGE_CASES]
    for n, dtype, eps, batch in cases:
        dname = str(dtype).split(".")[-1]
        args = (rnd(batch, n, C).to(dtype), rnd(C, scale=0.2, base=1.0),
                rnd(C, 3 * hd, scale=C ** -0.5).to(dtype),
                rnd(hd, C, scale=hd ** -0.5).to(dtype), rnd(C, scale=0.1))
        kw = dict(heads=ATTN_HEADS, dim_head=ATTN_DIM_HEAD, eps=eps, compute_dtype=dtype)
        got = at.fused_set_attention(*args, **kw)
        want = at.fused_set_attention_reference(*args, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = (bool(torch.isfinite(got.float()).all())
              and torch.allclose(got.float(), want.float(), **KERNEL_TOL[dname]))
        worst = max(worst, err)

        def call():
            return at.fused_set_attention(*args, **kw)

        ms, graph = cuda_ms(call), graph_ms(torch, call)
        dev_ms = device_ms(torch, call, "attention")
        plain = cuda_ms(lambda: at.fused_set_attention_reference(*args, **kw),
                        iters=20 if batch == B else 5)
        # the two products on the tensor cores; the per-head scores and
        # their product with v (N x N x D each) in f32
        M = batch * n
        mm_flops = 2 * M * C * 3 * hd + 2 * M * hd * C
        attn_flops = 4 * batch * ATTN_HEADS * n * n * ATTN_DIM_HEAD
        nbytes = (2 * args[0].numel() * args[0].element_size()
                  + sum(a.numel() * a.element_size() for a in args[1:]))
        route = ""
        if dtype == torch.float32:   # the products in split TF32, the FP32-rate bound beside
            fp32_ms = bound(0, nbytes, attn_flops + mm_flops)[0]
            b_ms, b_by = bound(0, nbytes, attn_flops, tf32_flops=TF32_SPLIT * mm_flops)
            route = f" (3xTF32; FP32 rate {fp32_ms:.5f})"
        else:
            b_ms, b_by = bound(mm_flops, nbytes, attn_flops)
        results[(n, dname, eps, batch)] = dict(err=err, ms=ms, graph=graph, dev=dev_ms,
                                               plain=plain, bound=b_ms, bound_by=b_by,
                                               mm_flops=mm_flops, attn_flops=attn_flops,
                                               nbytes=nbytes)
        print(f"kernel set_attention N={n} B={batch} {dname:8s} eps={eps:g} max_abs_err={err:.3e} "
              f"tol={KERNEL_TOL[dname]} {'ok' if ok else 'FAIL'} kernel_ms={ms:.4f} "
              f"graph_ms={graph:.4f} device_ms={dev_ms:.4f} plain_ms={plain:.4f} "
              f"bound_ms={b_ms:.5f}{route} ({b_by}; {nbytes / 1e6:.2f} MB)", flush=True)
        if not ok:
            failures.append((n, dname, eps, batch, err))
    # both kernels take C=512, 4 heads of 32 and N <= 24 only: anything else raises
    for dtype in (torch.bfloat16, torch.float32):
        for c, heads, dim_head, n in ((256, 4, 32, 12), (512, 8, 16, 12), (512, 4, 32, 25)):
            hd2 = heads * dim_head
            bad = (rnd(2, n, c).to(dtype), rnd(c), rnd(c, 3 * hd2).to(dtype),
                   rnd(hd2, c).to(dtype), rnd(c))
            try:
                at.fused_set_attention(*bad, heads=heads, dim_head=dim_head, compute_dtype=dtype)
            except ValueError as e:
                print(f"kernel set_attention {dtype} C={c} {heads} x {dim_head} N={n}: raises "
                      f"({e}) ok", flush=True)
            else:
                failures.append((f"{dtype} shape not refused", c, heads, dim_head, n))
    if failures:
        raise RuntimeError(f"set-attention kernel disagrees with its plain version: {failures}")
    return worst, results


def attention_phase(at, torch):
    """Phase 8 with its plans and the summary of each engine's call (bf16
    eps 1e-3, f32 eps 1e-5, B=64, N=12); returns (worst error, {dtype name:
    that call's results})."""
    attention_plan(at, torch)
    worst, results = phase_attention(at, torch)
    main = {"bfloat16": results[(12, "bfloat16", 1e-3, B)],
            "float32": results[(12, "float32", 1e-5, B)]}
    for dname, m in main.items():
        route = "bf16" if dname == "bfloat16" else "tf32 x 3"
        print(f"set attention of one flagship forward (N=12, B={B}, {dname}): kernel "
              f"{m['ms']:.4f} ms (eager calls), graph replay {m['graph']:.4f} ms, device "
              f"{m['dev']:.4f} ms, plain {m['plain']:.4f} ms, bound {m['bound']:.5f} ms "
              f"({m['mm_flops'] / 1e9:.3f} GFLOP {route} + {m['attn_flops'] / 1e9:.4f} GFLOP "
              f"f32, {m['nbytes'] / 1e6:.2f} MB)", flush=True)
    return worst, main


def bound(flops, nbytes, fp32_flops=0, tf32_flops=0):
    """Least time in ms on the card of ``flops`` on the bf16 tensor cores,
    ``fp32_flops`` outside them, ``tf32_flops`` on the TF32 tensor cores and
    ``nbytes`` of device memory traffic, and what sets it."""
    ops_s = flops / BF16_FLOPS + fp32_flops / FP32_FLOPS + tf32_flops / TF32_FLOPS
    bytes_s = nbytes / HBM_BPS
    return 1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"


def kernel_bound(dname, flops, nbytes):
    """A B1 or B4 call's bound: bf16 on the bf16 tensor cores; f32 on the
    split-TF32 route (TF32_SPLIT tf32 products each), with the FP32-rate
    figure beside.  Returns (ms, "operations" or "bytes", FP32-rate ms or
    None)."""
    if dname == "bfloat16":
        return (*bound(flops, nbytes), None)
    return (*bound(0, nbytes, tf32_flops=TF32_SPLIT * flops), bound(0, nbytes, flops)[0])


def sampling_step(torch, scene, batch, gen, fused=True, text_emb=None):
    """One DDPM step of the ``fused`` engine (True: the 3-D engine, "rows":
    the rows engine) at t = T - 1 on fresh inputs (the step a 1000-step
    sample runs T times), as a callable; a text model's step with the
    contexts of ``text_emb``."""
    from diffuscene_tpu_torch.diffusion import p_sample_step

    cfg = scene.cfg
    denoise = scene._denoise_fn(*scene.make_condition(batch, text_emb=text_emb), fused=fused)
    x_t = torch.randn(batch, 12, 62, generator=gen, device=DEV)
    noise = torch.randn(batch, 12, 62, generator=gen, device=DEV)
    t_last = torch.full((batch,), T - 1, dtype=torch.long, device=DEV)
    return lambda: p_sample_step(scene.sched, cfg.model_mean_type, cfg.model_var_type, denoise,
                                 x_t, t_last, noise, True)


def host_ms(torch, fn, n):
    """Host-clock ms per call of ``fn`` over ``n`` calls after a warm one,
    ending in a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


def phase_rows_sample(torch, scene, card):
    """Phase 4 (bf16) or the rows part of 15 (f32): a 1000-step DDPM sample
    of 64 scenes through SceneDiffusion.sample(fused="rows"), every chain on
    B4: shape, finiteness, exactly 19 chain launches a step; then a 20-step
    profile against the sample's step time, naming B4's kernel.  Returns the
    chain launches."""
    from diffuscene_tpu_torch.ops import fused_level as fl

    dname = str(scene.denoiser.compute_dtype).split(".")[-1]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    torch.cuda.synchronize()
    fl.apply_chain.launches = 0
    t0 = time.perf_counter()
    out = scene.sample(B, generator=gen, clip_denoised=True, fused="rows")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fl.apply_chain.launches
    finite = bool(torch.isfinite(out).all())
    print(f"sample: {T}-step DDPM, B={B}, {dname}, fused=rows: shape={tuple(out.shape)} "
          f"finite={finite} chain_calls={launches} wall_s={wall:.3f} "
          f"scenes_per_s={B / wall:.3f} | {card}", flush=True)
    if tuple(out.shape) != (B, 12, 62) or not finite:
        raise RuntimeError(f"the {dname} rows sample is malformed")
    if launches != 19 * T:
        raise RuntimeError(f"expected {19 * T} chain-kernel calls in the {dname} rows sample, "
                           f"counted {launches}")
    parts = scene.split_samples(out)
    print(f"sample: empty-slot share {parts['is_empty'].float().mean().item():.3f}", flush=True)
    # where one sampling step's time goes (the step the sample above ran T times)
    print(f"profile: {dname} rows step, B={B}", flush=True)
    profile_steps(torch, sampling_step(torch, scene, B, gen, fused="rows"), SAMPLE_PROFILE_STEPS,
                  1e3 * wall / T, named=ROWS_KERNELS[dname])
    return launches


def phase_engine_samples(torch, scene, card, dpm_batch=B, profile_batches=()):
    """Phases 10 and 11 (bf16) or 15 (f32): DDPM-1000 at B=64 and
    DPM-Solver++-20 at ``dpm_batch`` through the 3-D engine, every
    ResnetBlock on B1 and mid_attn on B2, with exact launch counts; a
    20-step profile at B=64 against the DDPM sample's step time, and one at
    each batch of ``profile_batches`` against that step's host time.
    Returns the DDPM-1000 launch counts."""
    from diffuscene_tpu_torch.ops import attention as at
    from diffuscene_tpu_torch.ops import fused_resblock as rb

    dname = str(scene.denoiser.compute_dtype).split(".")[-1]
    named = ENGINE_KERNELS[dname]
    counts = {}
    for name, batch, kw, steps in (("DDPM", B, {}, T),
                                   ("DPM-Solver++", dpm_batch, dict(dpm=True, dpm_steps=DPM_STEPS),
                                    DPM_STEPS)):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
        torch.cuda.synchronize()
        rb.fused_resnet_block.launches = at.fused_set_attention.launches = 0
        t0 = time.perf_counter()
        out = scene.sample(batch, generator=gen, clip_denoised=True, fused=True, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[name] = (rb.fused_resnet_block.launches, at.fused_set_attention.launches)
        finite = bool(torch.isfinite(out).all())
        print(f"sample: {steps}-step {name}, B={batch}, {dname}, fused=True: "
              f"shape={tuple(out.shape)} finite={finite} resblock_launches={counts[name][0]} "
              f"attention_launches={counts[name][1]} wall_s={wall:.3f} "
              f"scenes_per_s={batch / wall:.3f} | {card}", flush=True)
        if tuple(out.shape) != (batch, 12, 62) or not finite:
            raise RuntimeError(f"the {dname} {name} sample is malformed")
        if counts[name] != (28 * steps, steps):
            raise RuntimeError(f"expected {28 * steps} B1 and {steps} B2 launches in the {dname} "
                               f"{name} sample, counted {counts[name]}")
        if name == "DDPM":
            parts = scene.split_samples(out)
            print(f"sample: empty-slot share {parts['is_empty'].float().mean().item():.3f}",
                  flush=True)
            print(f"profile: {dname} 3-D step, B={B}", flush=True)
            profile_steps(torch, sampling_step(torch, scene, B, gen), SAMPLE_PROFILE_STEPS,
                          1e3 * wall / T, named=named)
    for batch in profile_batches:
        step = sampling_step(torch, scene, batch, torch.Generator(device="cuda").manual_seed(SEED + 4))
        step_ms = host_ms(torch, step, SAMPLE_PROFILE_STEPS)
        print(f"profile: {dname} 3-D step, B={batch} (host clock {step_ms:.3f} ms/step "
              f"unprofiled)", flush=True)
        profile_steps(torch, step, SAMPLE_PROFILE_STEPS, step_ms, named=named)
    return counts["DDPM"]


def phase_drift(torch, scene):
    """The end of phase 15: DDPM-1000 of the flagship in f32 at B=16 from
    one seeded generator.  The gate: along the fused=True trajectory, at
    each of the T steps, x_t goes through the 3-D engine (B1 and B2 f32),
    the rows engine (B4 f32) and the module; each engine's output must be
    within FORWARD_TOL f32 of the module's (the maxima stay on the card and
    are read once; a breach names the step).  The gated engine calls take
    the module's exact GELU, as phase 9's do (the sampler's engines default
    to the tanh form, about 1e-3 of its own).  The measurement: the three
    paths also run free, each on its own trajectory from the same
    generator; the relative L2 and the max abs difference of their descaled
    boxes and the share of slots whose class argmax agrees, for each pair,
    are printed beside DRIFT_BOUND and not gated (random weights may
    amplify split TF32's per-forward differences over 1000 steps without a
    fault)."""
    from diffuscene_tpu_torch.diffusion import p_sample_loop
    from diffuscene_tpu_torch.diffusion.gaussian import descale_to_origin
    from diffuscene_tpu_torch.models import inference as inf
    from diffuscene_tpu_torch.utils.convert import denoiser_tree

    cfg, tol, net = scene.cfg, FORWARD_TOL["float32"], scene.denoiser
    cond, _ = scene.make_condition(DRIFT_B)
    paths = {name: scene._denoise_fn(cond, fused=f)
             for name, f in (("3-D", True), ("rows", "rows"), ("module", False))}
    prep = inf.prepare_inference_params(net, denoiser_tree(net), num_timesteps=T)
    ctx = inf.precompute_conditioning(net, prep, cond)
    chains = inf.prepare_chain_params(net, prep, frozenset(ctx["film_c"]))
    rows_ctx = {"film_c2": {k: v.reshape(-1, v.shape[-1]).contiguous()
                            for k, v in ctx["film_c"].items()}}
    exact = (lambda x, t: inf.fused_unet1d_forward(net, prep, x, t, cond_ctx=ctx, exact_gelu=True),
             lambda x, t: inf.fused_unet1d_forward_rows(net, prep, chains, x, t, rows_ctx,
                                                        exact_gelu=True))
    errs = torch.zeros(T, 2, device="cuda")
    step = 0

    def gated(x, t):
        nonlocal step
        want = paths["module"](x, t)
        for k, engine in enumerate(exact):
            errs[step, k] = (engine(x, t) - want).abs().max()
        step += 1
        return paths["3-D"](x, t)

    def sample(fn):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
        t0 = time.perf_counter()
        out = p_sample_loop(scene.sched, cfg.model_mean_type, cfg.model_var_type, fn,
                            (DRIFT_B, cfg.sample_num_points, cfg.point_dim), generator=gen,
                            clip_denoised=True)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    free, walls = {}, {}
    free["3-D"], walls["gated"] = sample(gated)
    worst = errs.cpu()
    for k, name in enumerate(("3-D", "rows")):
        bad = (~(worst[:, k] <= tol)).nonzero()
        print(f"drift: f32 DDPM-{T} B={DRIFT_B}, {name} engine vs module along the fused=True "
              f"trajectory: worst max_abs_err {worst[:, k].max().item():.3e} at t="
              f"{T - 1 - int(worst[:, k].argmax())}, tol={tol} at every step "
              f"{'ok' if not len(bad) else 'FAIL'} ({walls['gated']:.1f} s, 4 forwards a step)",
              flush=True)
        if len(bad):
            i = int(bad[0])
            raise RuntimeError(f"the f32 {name} engine is {worst[i, k].item():.3e} from the module "
                               f"at step {i} (t={T - 1 - i}) of the fused=True trajectory")
    for name in ("rows", "module"):
        free[name], walls[name] = sample(paths[name])
    print(f"drift: free f32 DDPM-{T} B={DRIFT_B} wall s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in walls.items()), flush=True)
    spec = scene.spec
    lo, hi = ({k: torch.tensor(v[i], device="cuda") for k, v in DRIFT_BOUNDS.items()}
              for i in (0, 1))

    def boxes(x):
        x = x.clamp(-1, 1)
        return torch.cat([descale_to_origin(x[:, :, spec.trans_slice], lo["translations"],
                                            hi["translations"]),
                          descale_to_origin(x[:, :, spec.size_slice], lo["sizes"], hi["sizes"]),
                          x[:, :, spec.angle_slice]], dim=-1)

    for name, x in free.items():
        if not bool(torch.isfinite(x).all()) or tuple(x.shape) != (DRIFT_B, 12, 62):
            raise RuntimeError(f"the free f32 {name} sample is malformed")
    for a, b in (("3-D", "module"), ("rows", "module"), ("3-D", "rows")):
        ba, bb = boxes(free[a]), boxes(free[b])
        rel = ((ba - bb).norm() / bb.norm()).item()
        agree = (scene.split_samples(free[a])["class_labels"].argmax(-1)
                 == scene.split_samples(free[b])["class_labels"].argmax(-1)).float().mean().item()
        print(f"drift: free f32 DDPM-{T} B={DRIFT_B}, {a} vs {b}: descaled boxes rel_l2={rel:.3e} "
              f"max_abs={(ba - bb).abs().max().item():.3e} m, class argmax agrees on "
              f"{agree:.4f} of slots (ROADMAP bound: rel_l2 <= {DRIFT_BOUND['rel_l2']}, agree >= "
              f"{DRIFT_BOUND['agree']}; measured, not gated)", flush=True)


def chamfer_bound_ms(B, N, M, D):
    """Least time of one chamfer forward (both directions) on the card: at
    least D + 3 FP32 instructions a pair (D FMAs of the dot product, the
    expansion's add and FMA, a compare-select), issued at FP32_FLOPS / 2 a
    second; bytes (each cloud read once, dist and idx written once) are far
    below.  Returns (ms, "operations" or "bytes")."""
    ops_s = 2 * B * N * M * (D + 3) / (FP32_FLOPS / 2)
    bytes_s = (4 * B * (N + M) * D + 8 * B * (N + M)) / HBM_BPS
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def chamfer_plan(ch, torch):
    """The chamfer kernel's launch for each case (points a thread, cluster
    of CTAs splitting the y sweep, CTAs, warps an SM)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, (nb, n, m, d) in CHAMFER_CASES.items():
        for a, b in ((n, m), (m, n)) if n != m else ((n, m),):
            p = ch.launch_plan(nb, a, b)
            print(f"plan chamfer_nn {name} B={nb} N={a} M={b}: {p.points_per_thread} points a "
                  f"thread, {p.threads} threads a CTA, clusters of {p.cluster} (y slices of "
                  f"{p.slices[0][1] - p.slices[0][0]}, the last {p.slices[-1][1] - p.slices[-1][0]}),"
                  f" {p.ctas} CTAs, {p.ctas * p.threads / 32 / sms:.1f} warps an SM on {sms} SMs",
                  flush=True)


def phase_chamfer(ch, torch):
    """Chamfer kernel vs plain version on the card: distances equal bit for
    bit, indices equal or tied, and the lower index on the ties of "dup";
    returns a dict of the worst error and the AE shape's times."""
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    worst, failures, out = 0.0, [], {}
    chamfer_plan(ch, torch)
    for name, (nb, n, m, d) in CHAMFER_CASES.items():
        x = torch.rand(nb, n, d, generator=g, device=dev) - 0.5
        y = x.clone() if name == "identical" else torch.rand(nb, m, d, generator=g, device=dev) - 0.5
        ties = []
        if name == "dup":   # y points of slice k copied into slice k + 1
            slices = ch.launch_plan(nb, n, m).slices
            for k in range(len(slices) - 1):
                for c in range(8):
                    lo = slices[k][0] + 7 + c
                    y[:, slices[k + 1][0] + 11 + c] = y[:, lo]
                    x[:, len(ties)] = y[:, lo]
                    ties.append((len(ties), lo))
        for direction, (a, b) in (("x->y", (x, y)), ("y->x", (y, x))):
            dist_k, idx_k = ch.directed_nn(a, b)
            dist_t, idx_t = ch.directed_nn_reference(a, b)
            torch.cuda.synchronize()
            err = (dist_k - dist_t).abs().max().item()
            equal = torch.equal(dist_k, dist_t)
            differ = idx_k != idx_t
            n_differ = int(differ.sum().item())
            # where the indices differ, the plain distance at the kernel's
            # index must tie with the plain minimum to within the bound
            tie_gap = 0.0
            if n_differ:
                full = ch.pairwise_sqdist_kernel_order(a, b)
                at_k = torch.gather(full, 2, idx_k.long()[..., None])[..., 0]
                tie_gap = (at_k - dist_t)[differ].abs().max().item()
            # the copied points' own queries must take the copy's lower index
            forward_ties = ties if direction == "x->y" else []
            lowest = all(bool((idx_k[:, k] == lo).all()) for k, lo in forward_ties)
            ok = (err <= CHAMFER_DIST_ATOL and tie_gap <= CHAMFER_DIST_ATOL and equal and lowest
                  and bool(torch.isfinite(dist_k).all()))
            worst = max(worst, err)
            print(f"kernel chamfer_nn {name:9s} B={nb} N={a.shape[1]} M={b.shape[1]} D={d} "
                  f"{direction}: max_abs_err={err:.3e} bit_equal={equal} idx_differ={n_differ} "
                  f"tie_gap={tie_gap:.3e} cross_slice_ties={len(forward_ties)} lowest={lowest} "
                  f"tol={CHAMFER_DIST_ATOL} {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append((name, direction, err, equal, n_differ, tie_gap, lowest))

    # backward through the kernel path vs autograd over the plain version
    nb, n, m, d = CHAMFER_CASES["ae"]
    x0 = torch.rand(nb, n, d, generator=g, device=dev) - 0.5
    y0 = torch.rand(nb, m, d, generator=g, device=dev) - 0.5
    xk, yk = x0.clone().requires_grad_(), y0.clone().requires_grad_()
    d1, d2, _, _ = ch.chamfer_distance(xk, yk)
    (d1.mean() + d2.mean()).backward()
    xt, yt = x0.clone().requires_grad_(), y0.clone().requires_grad_()
    full = ch.pairwise_sqdist_kernel_order(xt, yt)
    (full.min(dim=2).values.mean() + full.min(dim=1).values.mean()).backward()
    torch.cuda.synchronize()
    gerr = max((xk.grad - xt.grad).abs().max().item(), (yk.grad - yt.grad).abs().max().item())
    gok = (torch.allclose(xk.grad, xt.grad, **CHAMFER_GRAD_TOL)
           and torch.allclose(yk.grad, yt.grad, **CHAMFER_GRAD_TOL))
    print(f"kernel chamfer_nn backward {tuple(x0.shape)}/{tuple(y0.shape)} vs autograd over "
          f"the plain version: max_abs_err={gerr:.3e} (grad scale {xt.grad.abs().max().item():.3e}) "
          f"tol={CHAMFER_GRAD_TOL} {'ok' if gok else 'FAIL'}", flush=True)
    if not gok:
        failures.append(("backward", gerr))
    if failures:
        raise RuntimeError(f"chamfer kernel disagrees with its plain version: {failures}")

    # one chamfer forward (both directions) at the AE shape
    def kernel():
        ch.directed_nn(x0, y0)
        ch.directed_nn(y0, x0)

    def plain():
        ch.directed_nn_reference(x0, y0)
        ch.directed_nn_reference(y0, x0)

    def library():
        dd = torch.cdist(x0, y0).square()
        dd.min(dim=2)
        dd.min(dim=1)

    out["ms"], out["plain_ms"], out["library_ms"] = cuda_ms(kernel), cuda_ms(plain), cuda_ms(library)
    out["graph_ms"] = graph_ms(torch, kernel)
    out["device_ms"] = device_ms(torch, kernel, "chamfer_nn_sm90")
    out["bound_ms"], out["bound_by"] = chamfer_bound_ms(nb, n, m, d)
    out["max_abs_err"] = worst
    print(f"chamfer forward, both directions, {tuple(x0.shape)}/{tuple(y0.shape)}: kernel "
          f"{out['ms']:.4f} ms (eager calls), graph replay {out['graph_ms']:.4f} ms, device "
          f"{out['device_ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, torch.cdist "
          f"{out['library_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms ({out['bound_by']})",
          flush=True)
    return out


def box_clouds(n_clouds, n_points, seed):
    """Points spread uniformly over the surfaces of random boxes (half-extents
    0.1-0.5), one box per cloud, float32 (n_clouds, n_points, 3)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = np.empty((n_clouds, n_points, 3), np.float32)
    for i in range(n_clouds):
        h = rng.uniform(0.1, 0.5, 3)
        areas = np.array([h[1] * h[2], h[0] * h[2], h[0] * h[1]]).repeat(2)
        face = rng.choice(6, n_points, p=areas / areas.sum())
        pts = rng.uniform(-1.0, 1.0, (n_points, 3))
        axis = face // 2
        pts[np.arange(n_points), axis] = np.where(face % 2 == 0, -1.0, 1.0)
        out[i] = pts * h
    return out


def phase_autoencoder(ch, torch):
    """The shape autoencoder's training path at full width on the card."""
    import copy

    from diffuscene_tpu_torch.models.autoencoder import build_autoencoder
    from diffuscene_tpu_torch.train.ae_trainer import AETrainer
    from diffuscene_tpu_torch.utils.config import load_config

    cfg = load_config(AE_CONFIG)
    batch = int(cfg["training"]["batch_size"])
    model = build_autoencoder(cfg["network"], device=DEV)
    trainer = AETrainer(model, cfg["training"], device=DEV,
                        steps_per_epoch=int(cfg["training"]["steps_per_epoch"])).init(SEED)
    clouds = trainer.put_batch(box_clouds(batch, AE_POINTS, SEED + 20))

    # one step with the kernel vs the same step with the plain version
    start = copy.deepcopy(trainer.state_dict())
    eps = torch.randn(batch, model.latent_dim, generator=torch.Generator().manual_seed(SEED + 21))
    eps = eps.to(DEV)
    before = ch.directed_nn.launches
    with_kernel = trainer.train_step(clouds, eps=eps)
    kernel_launches = ch.directed_nn.launches - before
    trainer.load_state_dict(copy.deepcopy(start))
    kernel_fn = ch.directed_nn
    ch.directed_nn = ch.directed_nn_reference        # this comparison only
    try:
        with_plain = trainer.train_step(clouds, eps=eps)
    finally:
        ch.directed_nn = kernel_fn
    plain_launches = ch.directed_nn.launches - before - kernel_launches
    trainer.load_state_dict(start)
    if kernel_launches != 2 or plain_launches != 0:
        raise RuntimeError(f"the kernel-vs-plain AE step launched the kernel {kernel_launches} "
                           f"and {plain_launches} times, expected 2 and 0")
    rel = {k: abs(with_kernel[k] - with_plain[k]) / abs(with_plain[k]) for k in AE_STEP_TOL}
    ok = all(rel[k] <= AE_STEP_TOL[k] for k in AE_STEP_TOL)
    print(f"ae step, kernel vs plain chamfer: loss {with_kernel['loss']:.7f} vs "
          f"{with_plain['loss']:.7f}, gradnorm {with_kernel['gradnorm']:.5f} vs "
          f"{with_plain['gradnorm']:.5f}, relative {rel} tol={AE_STEP_TOL} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise RuntimeError(f"the AE step disagrees between kernel and plain chamfer: {rel}")

    # the main path: 30 full-width train steps, every chamfer on the kernel
    torch.cuda.synchronize()
    ch.directed_nn.launches = 0
    losses, times = [], []
    for _ in range(AE_STEPS):
        t0 = time.perf_counter()
        m = trainer.train_step(clouds)           # ends in one host transfer
        times.append(time.perf_counter() - t0)
        losses.append(m["loss"])
    launches = ch.directed_nn.launches
    finite = all(math.isfinite(v) for v in losses)
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    step_ms = 1e3 * sum(times[5:]) / len(times[5:])
    print(f"ae train: {AE_STEPS} steps, B={batch}, {AE_POINTS} points, latent "
          f"{model.latent_dim}: loss first5 {first:.5f} last5 {last:.5f} finite={finite} "
          f"chamfer_launches={launches} ms_per_step={step_ms:.3f} (steps 6-{AE_STEPS}; "
          f"first step {1e3 * times[0]:.3f} ms) last_metrics={m}", flush=True)
    if not finite or not last < first:
        raise RuntimeError(f"AE loss not finite or not falling: {losses}")
    if launches != 2 * AE_STEPS:
        raise RuntimeError(f"expected {2 * AE_STEPS} chamfer-kernel launches, counted {launches}")

    more = trainer.put_batch(box_clouds(AE_ENCODE, AE_POINTS, SEED + 22))
    trainer.encode(more)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lat = trainer.encode(more)
    torch.cuda.synchronize()
    enc_ms = 1e3 * (time.perf_counter() - t0)
    lat_ok = tuple(lat.shape) == (AE_ENCODE, model.latent_dim) and bool(torch.isfinite(lat).all())
    print(f"ae encode: {AE_ENCODE} clouds -> {tuple(lat.shape)} finite={lat_ok} "
          f"ms={enc_ms:.3f} latent_std={lat.std().item():.5f}", flush=True)
    if not lat_ok:
        raise RuntimeError("the encoded latents are malformed")
    profile_steps(torch, lambda: trainer.train_step(clouds), AE_PROFILE_STEPS, step_ms,
                  named=(("B3", "chamfer_nn_sm90"),))
    return launches


def scene_trainer(torch, config_path, device, data_dir):
    """A config's scene model and Trainer on ``device``, weights from the
    seed, and its train split of the synthetic dataset at ``data_dir``
    through the copied data pipeline."""
    from diffuscene_tpu_torch.data.factory import (apply_text_emb_dim_default,
                                                   get_dataset_raw_and_encoded)
    from diffuscene_tpu_torch.models import SceneDiffusion, SceneModelConfig
    from diffuscene_tpu_torch.train.trainer import Trainer
    from diffuscene_tpu_torch.utils.config import load_config

    cfg = apply_text_emb_dim_default(load_config(config_path))
    data = dict(cfg["data"], dataset_directory=data_dir,
                annotation_file=os.path.join(data_dir, "splits.csv"))
    _, ds = get_dataset_raw_and_encoded(data, augmentations=data.get("augmentations"),
                                        split=cfg["training"]["splits"], seed=SEED)
    batch = int(cfg["training"]["batch_size"])
    scene = SceneDiffusion(SceneModelConfig.from_config(cfg["network"]),
                           bounds=ds.bounds.as_device_bounds(), device=device)
    trainer = Trainer(scene, cfg["training"], steps_per_epoch=max(len(ds) // batch, 1),
                      device=device).init(SEED)
    return ds, batch, trainer


def step_grads(torch, trainer, batch, t, noise):
    """The loss and every parameter's gradient of one batch."""
    loss, _ = trainer.scene.get_loss(batch, t=t, noise=noise)
    return loss.item(), torch.autograd.grad(loss, trainer.params)


def grad_rel_l2(a, b):
    """(the worst parameter's relative L2 difference and its name index,
    the whole gradient's)."""
    per = [((x.float() - y.float().to(x.device)).norm() / y.float().norm().clamp_min(1e-30)).item()
           for x, y in zip(a, b)]
    num = sum(((x.float() - y.float().to(x.device)) ** 2).sum().item() for x, y in zip(a, b))
    den = sum((y.float() ** 2).sum().item() for y in b)
    worst = max(range(len(per)), key=per.__getitem__)
    return per[worst], worst, math.sqrt(num / den)


def train_steps(torch, trainer, batches, n, label):
    """``n`` train steps on the card through the data pipeline: finite,
    host-clock ms a step (the median, around train_step and its one metrics
    transfer), peak memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(n):
        batch = trainer.put_batch(next(batches))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.train_step(batch)
        times.append(time.perf_counter() - t0)
        losses.append(m["loss"])
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = 1e3 * sorted(times)[len(times) // 2]
    finite = all(math.isfinite(v) for v in losses)
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    print(f"{label}: {n} steps: loss first5 {first:.5f} last5 {last:.5f} finite={finite} "
          f"ms_per_step={step_ms:.3f} (median; first step {1e3 * times[0]:.3f} ms) "
          f"peak_mem_gb={peak_gb:.3f} last_metrics={m}", flush=True)
    if not finite:
        raise RuntimeError(f"{label}: a loss is not finite: {losses}")
    return batch, step_ms, peak_gb, first, last


def phase_train_flagship(torch, data_dir):
    """Phase 12: the flagship's train step on the card against the same step
    on the CPU, then 30 steps on the card and a profile of 5."""
    from diffuscene_tpu_torch.data.loader import DataLoader

    ds, bsz, card = scene_trainer(torch, FLAGSHIP_CONFIG, DEV, data_dir)
    _, _, cpu = scene_trainer(torch, FLAGSHIP_CONFIG, "cpu", data_dir)
    batches = DataLoader(ds, bsz, shuffle=True, seed=SEED).infinite()
    host = next(batches)
    g = torch.Generator().manual_seed(SEED + 30)
    t = torch.randint(0, T, (bsz,), generator=g)
    noise = torch.randn(bsz, 12, 62, generator=g)
    dev_args = (card.put_batch(host), t.to(DEV), noise.to(DEV))
    cpu_args = (cpu.put_batch(host), t, noise)
    loss_c, grads_c = step_grads(torch, card, *dev_args)
    loss_p, grads_p = step_grads(torch, cpu, *cpu_args)
    worst, at, whole = grad_rel_l2(grads_c, grads_p)
    del grads_c, grads_p
    m_c = card.train_step(dev_args[0], t=dev_args[1], noise=dev_args[2])
    m_p = cpu.train_step(cpu_args[0], t=t, noise=noise)
    rel = {k: abs(m_c[k] - m_p[k]) / max(abs(m_p[k]), 1e-12) for k in m_p}
    rel_loss = max(v for k, v in rel.items() if k.startswith("loss"))
    ok = (rel_loss <= TRAIN_STEP_TOL["loss"] and rel["gradnorm"] <= TRAIN_STEP_TOL["gradnorm"]
          and worst <= TRAIN_STEP_TOL["grad_rel_l2"])
    print(f"train flagship, card vs cpu (B={bsz}, f32, TF32 off): loss {m_c['loss']:.7f} vs "
          f"{m_p['loss']:.7f} (get_loss {loss_c:.7f} vs {loss_p:.7f}), gradnorm "
          f"{m_c['gradnorm']:.6f} vs {m_p['gradnorm']:.6f}, worst relative loss-term "
          f"difference {rel_loss:.3e}, gradient relative L2: worst parameter {worst:.3e} "
          f"({card.names[at]}), whole {whole:.3e}; tol={TRAIN_STEP_TOL} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise RuntimeError(f"the flagship step disagrees between card and CPU: {rel}, "
                           f"gradients {worst} at {card.names[at]}")
    del cpu, cpu_args

    # the main path: 30 steps through the data pipeline
    batch, step_ms, peak_gb, first, last = train_steps(torch, card, batches, FLAGSHIP_STEPS,
                                                       "train flagship")
    if not last < first:
        raise RuntimeError(f"the flagship loss did not fall: first5 {first}, last5 {last}")
    prof = profile_steps(torch, lambda: card.train_step(batch), TRAIN_PROFILE_STEPS, step_ms)
    return {"config": FLAGSHIP_CONFIG, "B": bsz, "dtype": "float32", "steps": FLAGSHIP_STEPS,
            "ms_per_step": step_ms, "busy_ms": prof["busy_ms"], "idle_share": prof["idle_share"],
            "peak_mem_gb": peak_gb, "loss_first5": first, "loss_last5": last,
            "card_vs_cpu": {"loss_rel": rel_loss, "gradnorm_rel": rel["gradnorm"],
                            "grad_rel_l2_worst": worst, "grad_rel_l2": whole},
            "top_kernels": prof["top"]}


def phase_train_b512(torch, data_dir):
    """Phase 13: the b512 recipe (bf16, ws_fast_vjp, bf16 moments, gradients
    and EMA, B=512): one step's gradients with ws_fast_vjp against the same
    step without it, then 20 steps and a profile of 5."""
    from diffuscene_tpu_torch.data.loader import DataLoader
    from diffuscene_tpu_torch.models.denoiser import WSConv1x1

    ds, bsz, tr = scene_trainer(torch, B512_CONFIG, DEV, data_dir)
    batches = DataLoader(ds, bsz, shuffle=True, seed=SEED).infinite()
    g = torch.Generator().manual_seed(SEED + 31)
    args = (tr.put_batch(next(batches)), torch.randint(0, T, (bsz,), generator=g).to(DEV),
            torch.randn(bsz, 12, 62, generator=g).to(DEV))
    ws = [m for m in tr.scene.denoiser.modules() if isinstance(m, WSConv1x1)]
    if not ws or not all(m.fast_vjp for m in ws):
        raise RuntimeError("the b512 config did not switch on ws_fast_vjp in every WS layer")
    loss_f, grads_f = step_grads(torch, tr, *args)
    for m in ws:
        m.fast_vjp = False
    loss_e, grads_e = step_grads(torch, tr, *args)
    for m in ws:
        m.fast_vjp = True
    worst, at, whole = grad_rel_l2(grads_f, grads_e)
    del grads_f, grads_e
    ok = whole <= FAST_VJP_TOL["whole"] and worst <= FAST_VJP_TOL["worst"] and \
        abs(loss_f - loss_e) <= FAST_VJP_TOL["loss"] * abs(loss_e)
    print(f"train b512, ws_fast_vjp vs exact (B={bsz}, bf16): loss {loss_f:.6f} vs {loss_e:.6f}, "
          f"gradient relative L2: worst parameter {worst:.3e} ({tr.names[at]}), whole "
          f"{whole:.3e}; tol={FAST_VJP_TOL} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise RuntimeError(f"ws_fast_vjp gradients out of bound: {worst} ({tr.names[at]}), "
                           f"{whole}")
    if {s.dtype for slot in tr.opt.slots for s in slot} != {torch.bfloat16} or \
            {e.dtype for e in tr.ema} != {torch.bfloat16}:
        raise RuntimeError("the b512 recipe's moments or EMA are not bf16")

    batch, step_ms, peak_gb, first, last = train_steps(torch, tr, batches, B512_STEPS,
                                                       "train b512")
    prof = profile_steps(torch, lambda: tr.train_step(batch), TRAIN_PROFILE_STEPS, step_ms)
    return {"config": B512_CONFIG, "B": bsz, "dtype": "bfloat16", "steps": B512_STEPS,
            "ms_per_step": step_ms, "busy_ms": prof["busy_ms"], "idle_share": prof["idle_share"],
            "peak_mem_gb": peak_gb, "loss_first5": first, "loss_last5": last,
            "fast_vjp": {"grad_rel_l2_worst": worst, "grad_rel_l2": whole},
            "top_kernels": prof["top"]}


def synthetic_config(config_path, data_dir, out_dir, name):
    """A copy of a config at ``out_dir/name`` that reads the synthetic
    dataset at ``data_dir``; returns its path."""
    import re

    with open(config_path) as f:
        text = f.read()
    text = re.sub(r"^(\s*dataset_directory:).*$", lambda m: f"{m.group(1)} {data_dir}", text,
                  flags=re.M)
    text = re.sub(r"^(\s*annotation_file:).*$",
                  lambda m: f"{m.group(1)} {os.path.join(data_dir, 'splits.csv')}", text, flags=re.M)
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        f.write(text)
    return path


def phase_cli(torch, data_dir, out_dir, card):
    """Phase 14: the entry points a user runs.  train_diffusion on the b512
    config (its EMA) for 3 epochs of the synthetic dataset, writing
    checkpoints; then generate_diffusion --fused --dpm on its checkpoint with
    the EMA weights: 64 scenes, exactly 560 B1 and 20 B2 launches, and the
    categorical KL in metrics.json."""
    from diffuscene_tpu_torch.cli import generate_diffusion, train_diffusion
    from diffuscene_tpu_torch.ops import attention as at
    from diffuscene_tpu_torch.ops import fused_resblock as rb
    from diffuscene_tpu_torch.utils.checkpoint import load_checkpoint

    cfg_path = synthetic_config(B512_CONFIG, data_dir, out_dir, "b512_synthetic.yaml")
    t0 = time.perf_counter()
    train_diffusion.main([cfg_path, out_dir, "--experiment_tag", "cli", "--seed", str(SEED),
                          "--epochs", str(CLI_EPOCHS)])
    train_s = time.perf_counter() - t0
    exp = os.path.join(out_dir, "cli")
    state, epoch = load_checkpoint(exp)
    if epoch != CLI_EPOCHS - 1 or state.get("ema") is None or state["step"] < CLI_EPOCHS:
        raise RuntimeError(f"the train CLI left no final checkpoint with an EMA: epoch {epoch}")

    gen_dir = os.path.join(out_dir, "generated")
    torch.cuda.synchronize()
    rb.fused_resnet_block.launches = at.fused_set_attention.launches = 0
    t0 = time.perf_counter()
    stats = generate_diffusion.main([cfg_path, gen_dir, "--weight_file", exp, "--n_sequences",
                                     str(GEN_SCENES), "--batch_size", str(GEN_SCENES), "--fused",
                                     "--dpm", "--dpm_steps", str(DPM_STEPS),
                                     "--compute_intersec"])
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = (rb.fused_resnet_block.launches, at.fused_set_attention.launches)
    n_boxes = len([f for f in os.listdir(gen_dir) if f.endswith("_boxes.npz")])
    with open(os.path.join(gen_dir, "metrics.json")) as f:
        saved = json.load(f)
    ok = (saved == stats and launches == (28 * DPM_STEPS, DPM_STEPS) and n_boxes == GEN_SCENES
          and saved.get("n_scenes") == GEN_SCENES
          and math.isfinite(saved.get("categorical_kl", float("nan"))))
    print(f"cli: train_diffusion {CLI_EPOCHS} epochs ({state['step']} steps, B=512 bf16) "
          f"{train_s:.3f} s; generate_diffusion --fused --dpm {GEN_SCENES} scenes (EMA weights) "
          f"{gen_s:.3f} s, launches B1={launches[0]} B2={launches[1]}, {n_boxes} box files, "
          f"stats {saved} {'ok' if ok else 'FAIL'} | {card}", flush=True)
    if not ok:
        raise RuntimeError(f"the CLI pair failed: launches {launches}, stats {saved}")
    return {"train_s": train_s, "generate_s": gen_s, "launches": list(launches),
            "categorical_kl": saved["categorical_kl"]}


def phase_train(torch, card):
    """Phases 12-14 on a synthetic cached dataset made from the seed."""
    import shutil

    from diffuscene_tpu_torch.data import make_synthetic_cached_dataset

    for d in (TRAIN_DATA, TRAIN_OUT):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(TRAIN_OUT)
    make_synthetic_cached_dataset(TRAIN_DATA, n_scenes=TRAIN_SCENES, seed=SEED)
    out = {"card": card, "flagship": phase_train_flagship(torch, TRAIN_DATA)}
    torch.cuda.empty_cache()
    out["b512"] = phase_train_b512(torch, TRAIN_DATA)
    torch.cuda.empty_cache()
    out["cli"] = phase_cli(torch, TRAIN_DATA, TRAIN_OUT, card)
    return out


def task_inputs(torch, data_dir):
    """The CLI's inputs from the first TASK_B eval scenes of the synthetic
    dataset (the eval split, encoded without permutation, packed as
    cli/completion_rearrange.py packs them): the scenes (B, 12, 62) and
    their copy with N(0, 0.5) noise on the translations and angles from
    np.random.default_rng(SEED), on the card."""
    import numpy as np

    from diffuscene_tpu_torch.data.factory import get_dataset_raw_and_encoded
    from diffuscene_tpu_torch.utils.config import load_config

    data = dict(load_config(FLAGSHIP_CONFIG)["data"], dataset_directory=data_dir,
                annotation_file=os.path.join(data_dir, "splits.csv"))
    data["encoding_type"] += "_no_prm"
    _, ds = get_dataset_raw_and_encoded(data, augmentations=None, split=["test"])
    target = np.stack([np.concatenate([s["translations"], s["sizes"], s["angles"],
                                       s["class_labels"], s["objfeats_32"]], axis=-1)
                       for s in (ds[i] for i in range(TASK_B))]).astype(np.float32)
    noisy = target.copy()
    rng = np.random.default_rng(SEED)
    noisy[:, :, :3] += rng.normal(0, TASK_NOISE, noisy[:, :, :3].shape)
    noisy[:, :, 6:8] += rng.normal(0, TASK_NOISE, noisy[:, :, 6:8].shape)
    return torch.from_numpy(target).to(DEV), torch.from_numpy(noisy).to(DEV)


def task_model(torch, config_path):
    """A shipped config's scene model on the card, f32, random weights from
    the seed."""
    from diffuscene_tpu_torch.models import SceneDiffusion, SceneModelConfig
    from diffuscene_tpu_torch.utils.config import load_config

    cfg = SceneModelConfig.from_config(load_config(config_path)["network"])
    return SceneDiffusion(cfg, device=DEV).init(torch.Generator().manual_seed(SEED))


def checked_sample(torch, scene, label, card, batch=TASK_B, fused=True, step=None, **task):
    """One DDPM-1000 sample of ``batch`` scenes through
    ``scene.sample(fused=fused, **task)``: with ``fused=True`` every
    ResnetBlock on B1 and mid_attn on B2, exactly 28,000 and 1,000
    launches; with ``fused="rows"`` every chain on B4, exactly 19,000.  At
    every TASK_CHECK_EVERY-th step the engine's forward (the module's exact
    GELU, as phase 15's gate) on that step's x_t, spliced as the sampler
    spliced it, is held against the module's: within FORWARD_TOL f32, or
    the phase fails naming the step.  The check's launches and
    cross-attention contexts are not counted and its time (measured,
    synchronised) is taken out of the wall time.  ``step`` (default: the
    task's step, task_step) is the step a 20-step profile times.  Returns
    (the sample, a summary with the cross-attention contexts made)."""
    from diffuscene_tpu_torch.models import inference as inf
    from diffuscene_tpu_torch.ops import attention as at
    from diffuscene_tpu_torch.ops import fused_level as fl
    from diffuscene_tpu_torch.ops import fused_resblock as rb
    from diffuscene_tpu_torch.utils.convert import denoiser_tree

    net, tol = scene.denoiser, FORWARD_TOL["float32"]
    counters = ((fl.apply_chain,) if fused == "rows"
                else (rb.fused_resnet_block, at.fused_set_attention))
    expected = (19 * T,) if fused == "rows" else (28 * T, T)
    make_fn = scene._denoise_fn
    errs, info = [], {"step": 0, "check_s": 0.0}

    def checked(condition, condition_cross=None, fused=False):
        fn = make_fn(condition, condition_cross, fused=fused)
        module = make_fn(condition, condition_cross, fused=False)
        made = inf.cross_context.calls
        prep = inf.prepare_inference_params(net, denoiser_tree(net), num_timesteps=T)
        ctx = inf.precompute_conditioning(net, prep, condition, condition_cross)
        inf.cross_context.calls = made
        films = list(ctx["film_c"].values())
        # the cond-FiLM rows B1 reads: materialized (B, N, 2C), and how far
        # each scene's rows are from the first scene's
        info["film_rows_materialized"] = all(f.is_contiguous() and 0 not in f.stride()
                                             for f in films)
        info["film_spread"] = max((f - f[:1]).abs().max().item() for f in films)
        if fused == "rows":
            chains = inf.prepare_chain_params(net, prep, frozenset(ctx["film_c"]))
            rows = {"film_c2": {k: v.reshape(-1, v.shape[-1]).contiguous()
                                for k, v in ctx["film_c"].items()}, "cross": ctx["cross"]}

            def engine(x, t):
                return inf.fused_unet1d_forward_rows(net, prep, chains, x, t, rows,
                                                     exact_gelu=True)
        else:
            def engine(x, t):
                return inf.fused_unet1d_forward(net, prep, x, t, cond_ctx=ctx, exact_gelu=True)

        def gated(x, t):
            step = info["step"]
            info["step"] += 1
            if step % TASK_CHECK_EVERY == 0:
                counts = [c.launches for c in counters]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                errs.append((step, (engine(x, t) - module(x, t)).abs().max()))
                torch.cuda.synchronize()
                info["check_s"] += time.perf_counter() - t0
                for c, n in zip(counters, counts):
                    c.launches = n
            return fn(x, t)

        return gated

    gen = torch.Generator(device=DEV).manual_seed(SEED + 6)
    scene._denoise_fn = checked
    try:
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        inf.cross_context.calls = 0
        t0 = time.perf_counter()
        out = scene.sample(batch, generator=gen, clip_denoised=True, fused=fused, **task)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0 - info["check_s"]
        launches = tuple(c.launches for c in counters)
        contexts = inf.cross_context.calls
    finally:
        del scene._denoise_fn
    worst = torch.stack([e for _, e in errs]).cpu()
    bad = [s for (s, _), e in zip(errs, worst.tolist()) if not e <= tol]
    finite = bool(torch.isfinite(out).all())
    engine = "rows engine" if fused == "rows" else "3-D engine"
    summary = {"B": batch, "steps": T, "wall_s": wall, "scenes_per_s": batch / wall,
               "check_s": info["check_s"], "launches": list(launches),
               "cross_contexts": contexts, "checked_steps": len(errs),
               "worst_engine_vs_module": worst.max().item(),
               "film_spread": info["film_spread"],
               "film_rows_materialized": info["film_rows_materialized"]}
    print(f"{label}: {T}-step DDPM, B={batch}, f32, fused={fused!r}: shape="
          f"{tuple(out.shape)} finite={finite} launches={list(launches)} (expected "
          f"{list(expected)}) cross_contexts={contexts} wall_s={wall:.3f} scenes_per_s="
          f"{batch / wall:.3f} (the {len(errs)} checks' {info['check_s']:.3f} s taken out); "
          f"{engine} vs module every {TASK_CHECK_EVERY} steps: worst max_abs_err "
          f"{worst.max().item():.3e} tol={tol} {'ok' if not bad else 'FAIL'}; cond-FiLM rows "
          f"spread across scenes {info['film_spread']:.3e} (materialized: "
          f"{info['film_rows_materialized']}) | {card}", flush=True)
    if bad:
        i = bad[0]
        raise RuntimeError(f"{label}: the {engine} is {worst[i // TASK_CHECK_EVERY].item():.3e} "
                           f"from the module at step {i} (t={T - 1 - i})")
    if tuple(out.shape) != (batch, 12, 62) or not finite:
        raise RuntimeError(f"{label}: the sample is malformed")
    if launches != expected:
        raise RuntimeError(f"{label}: expected {list(expected)} launches, counted {launches}")
    if not info["film_rows_materialized"]:
        raise RuntimeError(f"{label}: the cond-FiLM rows are not materialized")
    print(f"profile: f32 {label} step, B={batch}", flush=True)
    prof = profile_steps(torch, step or task_step(torch, scene, **task), SAMPLE_PROFILE_STEPS,
                         1e3 * wall / T,
                         named=ROWS_KERNELS["float32"] if fused == "rows"
                         else ENGINE_KERNELS["float32"])
    summary.update(busy_ms=prof["busy_ms"], idle_share=prof["idle_share"],
                   kernels_ms=prof["named_ms"])
    return out, summary


def task_step(torch, scene, partial_boxes=None, input_boxes=None):
    """One step of a task sample at t = T - 1 (the step it runs T times),
    as a callable: completion splices the q-sampled partial boxes into the
    first slots before the reverse step; re-arrangement steps the
    (translation, angle) channels under its inputs' condition."""
    from diffuscene_tpu_torch.diffusion import p_sample_step, q_sample

    cfg, sched = scene.cfg, scene.sched
    gen = torch.Generator(device=DEV).manual_seed(SEED + 7)
    t = torch.full((TASK_B,), T - 1, dtype=torch.long, device=DEV)
    if input_boxes is not None:
        fn = scene._denoise_fn(*scene.make_condition(
            TASK_B, arrange_input=scene.arrange_input(input_boxes)), fused=True)
        shape = (TASK_B, 12, cfg.translation_dim + cfg.angle_dim)
        x, noise = (torch.randn(shape, generator=gen, device=DEV) for _ in range(2))
        return lambda: p_sample_step(sched, cfg.model_mean_type, cfg.model_var_type, fn, x, t,
                                     noise, True)
    fn = scene._denoise_fn(*scene.make_condition(TASK_B), fused=True)
    shape = (TASK_B, 12, cfg.point_dim)
    x, noise = (torch.randn(shape, generator=gen, device=DEV) for _ in range(2))
    noise_p = torch.randn(partial_boxes.shape, generator=gen, device=DEV)
    P = partial_boxes.shape[1]

    def step():
        x_t = torch.cat([q_sample(sched, partial_boxes, t, noise_p), x[:, P:]], dim=1)
        return p_sample_step(sched, cfg.model_mean_type, cfg.model_var_type, fn, x_t, t, noise,
                             True)

    return step


def phase_task_samples(torch, card, data_dir):
    """Phase 16 (a) and (b): completion on the flagship config and
    re-arrangement on the rearrange config, f32 at full width, random
    weights from the seed, through checked_sample; the spliced slots and
    channels bit-equal to the inputs, and the rearrange model's cond-FiLM
    rows different across scenes."""
    target, noisy = task_inputs(torch, data_dir)
    partial = target[:, :TASK_PARTIAL]
    out, comp = checked_sample(torch, task_model(torch, FLAGSHIP_CONFIG), "tasks: completion",
                               card, partial_boxes=partial)
    comp["partial_bit_equal"] = bool(torch.equal(out[:, :TASK_PARTIAL], partial))
    print(f"tasks: completion: the first {TASK_PARTIAL} slots equal the partial boxes bit for "
          f"bit: {comp['partial_bit_equal']}", flush=True)
    if not comp["partial_bit_equal"]:
        raise RuntimeError("completion: the first slots are not the partial boxes")
    out, arr = checked_sample(torch, task_model(torch, REARRANGE_CONFIG), "tasks: rearrange",
                              card, input_boxes=noisy)
    arr["kept_bit_equal"] = bool(torch.equal(out[:, :, 3:6], noisy[:, :, 3:6])
                                 and torch.equal(out[:, :, 8:], noisy[:, :, 8:]))
    moved = (out[:, :, :3] - noisy[:, :, :3]).abs().max().item()
    print(f"tasks: rearrange: size, class and objfeat channels equal the input bit for bit: "
          f"{arr['kept_bit_equal']}; translations moved by up to {moved:.3f}", flush=True)
    if not arr["kept_bit_equal"]:
        raise RuntimeError("rearrange: the kept channels differ from the input")
    if not arr["film_spread"] > 0:
        raise RuntimeError("rearrange: the cond-FiLM rows are the same in every scene, so the "
                           "check proves nothing about per-row FiLM")
    return {"completion": comp, "rearrange": arr}


def phase_train_rearrange(torch, data_dir):
    """Phase 16 (c): the rearrange config's train step at its B=128 on the
    card against the same step on the CPU (one batch, t and noise: the loss
    and every parameter's gradient), then TASK_TRAIN_STEPS steps on the
    card (median ms/step, peak memory)."""
    from diffuscene_tpu_torch.data.loader import DataLoader

    ds, bsz, card = scene_trainer(torch, REARRANGE_CONFIG, DEV, data_dir)
    _, _, cpu = scene_trainer(torch, REARRANGE_CONFIG, "cpu", data_dir)
    batches = DataLoader(ds, bsz, shuffle=True, seed=SEED).infinite()
    host = next(batches)
    g = torch.Generator().manual_seed(SEED + 32)
    t = torch.randint(0, T, (bsz,), generator=g)
    noise = torch.randn(bsz, 12, 5, generator=g)
    loss_c, grads_c = step_grads(torch, card, card.put_batch(host), t.to(DEV), noise.to(DEV))
    loss_p, grads_p = step_grads(torch, cpu, cpu.put_batch(host), t, noise)
    worst, at, whole = grad_rel_l2(grads_c, grads_p)
    del grads_c, grads_p, cpu
    loss_rel = abs(loss_c - loss_p) / abs(loss_p)
    ok = loss_rel <= TRAIN_STEP_TOL["loss"] and worst <= TRAIN_STEP_TOL["grad_rel_l2"]
    print(f"train rearrange, card vs cpu (B={bsz}, f32, TF32 off): loss {loss_c:.7f} vs "
          f"{loss_p:.7f} (relative {loss_rel:.3e}), gradient relative L2: worst parameter "
          f"{worst:.3e} ({card.names[at]}), whole {whole:.3e}; tol={TRAIN_STEP_TOL} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise RuntimeError(f"the rearrange step disagrees between card and CPU: loss {loss_rel}, "
                           f"gradients {worst} at {card.names[at]}")
    _, step_ms, peak_gb, first, last = train_steps(torch, card, batches, TASK_TRAIN_STEPS,
                                                   "train rearrange")
    return {"config": REARRANGE_CONFIG, "B": bsz, "dtype": "float32", "steps": TASK_TRAIN_STEPS,
            "ms_per_step": step_ms, "peak_mem_gb": peak_gb, "loss_first5": first,
            "loss_last5": last, "card_vs_cpu": {"loss_rel": loss_rel, "grad_rel_l2_worst": worst,
                                                "grad_rel_l2": whole}}


def phase_task_cli(torch, data_dir, out_dir, card):
    """Phase 16 (d): train_diffusion on the rearrange config for
    TASK_CLI_EPOCHS epochs, then completion_rearrange --arrange_objects
    --fused --compute_intersec on its checkpoint; train_diffusion on the
    flagship config for as many epochs, then completion_rearrange
    --num_partial 3 --fused --compute_intersec on that one.  Each CLI
    samples one batch of TASK_B: exactly 28,000 B1 and 1,000 B2 launches,
    TASK_B box files and a finite metrics.json."""
    from diffuscene_tpu_torch.cli import completion_rearrange, train_diffusion
    from diffuscene_tpu_torch.ops import attention as at
    from diffuscene_tpu_torch.ops import fused_resblock as rb

    out = {}
    for label, config, task_flags in (
            ("rearrange", REARRANGE_CONFIG, ["--arrange_objects"]),
            ("completion", FLAGSHIP_CONFIG, ["--num_partial", str(TASK_PARTIAL)])):
        cfg_path = synthetic_config(config, data_dir, out_dir, f"{label}.yaml")
        t0 = time.perf_counter()
        train_diffusion.main([cfg_path, out_dir, "--experiment_tag", label, "--seed", str(SEED),
                              "--epochs", str(TASK_CLI_EPOCHS), "--device", DEV])
        train_s = time.perf_counter() - t0
        task_dir = os.path.join(out_dir, f"{label}_out")
        torch.cuda.synchronize()
        rb.fused_resnet_block.launches = at.fused_set_attention.launches = 0
        t0 = time.perf_counter()
        metrics = completion_rearrange.main(
            [cfg_path, task_dir, "--weight_file", os.path.join(out_dir, label), *task_flags,
             "--n_sequences", str(TASK_B), "--batch_size", str(TASK_B), "--clip_denoised",
             "--fused", "--compute_intersec", "--seed", str(SEED), "--device", DEV])
        torch.cuda.synchronize()
        task_s = time.perf_counter() - t0
        launches = (rb.fused_resnet_block.launches, at.fused_set_attention.launches)
        n_boxes = len([f for f in os.listdir(task_dir) if f.endswith("_boxes.json")])
        with open(os.path.join(task_dir, "metrics.json")) as f:
            saved = json.load(f)
        ok = (launches == (28 * T, T) and n_boxes == TASK_B and saved == metrics
              and saved.get("n_scenes") == TASK_B
              and all(math.isfinite(v) for v in saved.values()))
        print(f"cli: train_diffusion {label} config {TASK_CLI_EPOCHS} epochs {train_s:.3f} s; "
              f"completion_rearrange {' '.join(task_flags)} --fused {TASK_B} scenes (EMA "
              f"weights) {task_s:.3f} s, launches B1={launches[0]} B2={launches[1]}, {n_boxes} "
              f"box files, metrics {saved} {'ok' if ok else 'FAIL'} | {card}", flush=True)
        if not ok:
            raise RuntimeError(f"the {label} CLI pair failed: launches {launches}, "
                               f"{n_boxes} box files, metrics {saved}")
        out[label] = {"train_s": train_s, "task_s": task_s, "launches": list(launches)}
    return out


def phase_tasks(torch, card):
    """Phase 16: scene completion and re-arrangement, f32 at full width, on
    a synthetic cached dataset made from the seed."""
    import shutil

    from diffuscene_tpu_torch.data import make_synthetic_cached_dataset

    for d in (TASK_DATA, TASK_OUT):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(TASK_OUT)
    make_synthetic_cached_dataset(TASK_DATA, n_scenes=TRAIN_SCENES, seed=SEED)
    t0 = time.perf_counter()
    out = {"card": card, "samples": phase_task_samples(torch, card, TASK_DATA)}
    torch.cuda.empty_cache()
    out["train"] = phase_train_rearrange(torch, TASK_DATA)
    torch.cuda.empty_cache()
    out["cli"] = phase_task_cli(torch, TASK_DATA, TASK_OUT, card)
    out["phase_s"] = time.perf_counter() - t0
    print(f"tasks: phase 16 took {out['phase_s']:.1f} s", flush=True)
    return out


def text_inputs(torch, data_dir, batch):
    """The token embeddings of ``batch`` eval scenes (the port's pipeline:
    the text config's encoding with generate's rewrite, textfix and no
    permutation, 768-wide hashed tokens), the scenes taken in order and
    cycled, as a (batch, 50, 768) tensor on the card."""
    import numpy as np

    from diffuscene_tpu_torch.data.factory import (apply_text_emb_dim_default,
                                                   get_dataset_raw_and_encoded)
    from diffuscene_tpu_torch.utils.config import load_config

    cfg = apply_text_emb_dim_default(load_config(TEXT_CONFIG))
    data = dict(cfg["data"], dataset_directory=data_dir,
                annotation_file=os.path.join(data_dir, "splits.csv"))
    data["encoding_type"] = data["encoding_type"].replace("text", "textfix") + "_no_prm"
    _, ds = get_dataset_raw_and_encoded(data, augmentations=None, split=["test"])
    embs = [ds[i]["desc_emb"] for i in range(len(ds))]
    emb = np.stack([embs[i % len(embs)] for i in range(batch)])
    return torch.from_numpy(emb).to(DEV)


def phase_text_samples(torch, card, data_dir):
    """Phase 17 (a)-(c): the bedroom text model, f32 at full width, random
    weights from the seed.  (a) DDPM-1000 at TEXT_B through the 3-D engine
    and (b) at TEXT_ROWS_B through the rows engine, both by checked_sample
    (exact launch counts, the engine held to the module every
    TASK_CHECK_EVERY steps, TEXT_CONTEXTS contexts a sample, a 20-step
    profile), then the cross blocks' device time in a TEXT_B step; (c) the
    text reaches its own scene: one step of the 3-D engine on one x_t
    repeated in every scene, with the text rolled by one scene, is the
    unrolled step's output rolled by one scene (ROLL_TOL) and differs from
    it (ROLL_MIN_DIFF)."""
    from diffuscene_tpu_torch.models import inference as inf
    from diffuscene_tpu_torch.utils.convert import denoiser_tree

    scene = task_model(torch, TEXT_CONFIG)
    text = text_inputs(torch, data_dir, TEXT_B)
    out = {}
    for key, batch, fused in (("ddpm_3d", TEXT_B, True), ("ddpm_rows", TEXT_ROWS_B, "rows")):
        te = text[:batch]
        gen = torch.Generator(device=DEV).manual_seed(SEED + 8)
        _, summary = checked_sample(
            torch, scene, f"text: {key}", card, batch=batch, fused=fused, text_emb=te,
            step=sampling_step(torch, scene, batch, gen, fused=fused, text_emb=te))
        if summary["cross_contexts"] != TEXT_CONTEXTS:
            raise RuntimeError(f"text: {key}: {summary['cross_contexts']} cross-attention "
                               f"contexts a sample, expected {TEXT_CONTEXTS}")
        out[key] = summary

    # the 9 cross blocks of one TEXT_B step alone: their device time
    net, dt = scene.denoiser, torch.float32
    prep = inf.prepare_inference_params(net, denoiser_tree(net), num_timesteps=T)
    cond, cross = scene.make_condition(TEXT_B, text_emb=text)
    ctx = inf.precompute_conditioning(net, prep, cond, cross)
    h = torch.randn(TEXT_B * 12, C, generator=torch.Generator(device=DEV).manual_seed(SEED + 9),
                    device=DEV)

    def cross_blocks():
        for name in ctx["cross"]:
            inf._cross_block(prep["misc"], ctx["cross"], name, h, dt, TEXT_B, 12)

    cross_ms = device_ms(torch, cross_blocks, "", SAMPLE_PROFILE_STEPS)
    busy = out["ddpm_3d"]["busy_ms"]
    out["ddpm_3d"]["cross_blocks_ms"] = cross_ms
    out["ddpm_3d"]["cross_blocks_share"] = cross_ms / busy if busy else None
    print(f"text: the {len(ctx['cross'])} cross-attention blocks of a B={TEXT_B} step: "
          f"{cross_ms:.3f} ms of device time (profiler, {SAMPLE_PROFILE_STEPS} steps), "
          f"{cross_ms / busy if busy else float('nan'):.1%} of the step's busy "
          f"{busy} ms | {card}", flush=True)

    # (c) one x_t in every scene: the outputs differ only by the text
    g = torch.Generator(device=DEV).manual_seed(SEED + 10)
    x = torch.randn(1, 12, 62, generator=g, device=DEV).expand(TEXT_B, 12, 62).contiguous()
    t = torch.full((TEXT_B,), T - 1, dtype=torch.long, device=DEV)
    step = scene._denoise_fn(*scene.make_condition(TEXT_B, text_emb=text), fused=True)
    rolled = scene._denoise_fn(*scene.make_condition(TEXT_B, text_emb=text.roll(1, 0)),
                               fused=True)
    base, moved = step(x, t), rolled(x, t)
    roll_err = (moved - base.roll(1, 0)).abs().max().item()
    diff = (moved - base).abs().max().item()
    ok = roll_err <= ROLL_TOL and diff > ROLL_MIN_DIFF
    print(f"text: scene roll, B={TEXT_B}, one x_t in every scene, the text rolled by one scene: "
          f"output vs the rolled output max_abs_err {roll_err:.3e} (tol {ROLL_TOL}), vs the "
          f"unrolled output {diff:.3e} (must exceed {ROLL_MIN_DIFF}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise RuntimeError(f"text: the text does not reach its own scene: roll error "
                           f"{roll_err}, difference {diff}")
    out["roll"] = {"max_abs_err": roll_err, "diff_from_unrolled": diff}
    return out


def phase_train_text(torch, data_dir):
    """Phase 17 (d): the text config's train step at its B=128 on the card
    against the same step on the CPU (one batch with its 768-wide token
    embeddings, t and noise: the loss and every parameter's gradient),
    every cross-attention parameter and fc_text_f with a non-zero gradient;
    then TEXT_TRAIN_STEPS steps on the card (median ms/step, peak memory)."""
    from diffuscene_tpu_torch.data.loader import DataLoader

    ds, bsz, card = scene_trainer(torch, TEXT_CONFIG, DEV, data_dir)
    _, _, cpu = scene_trainer(torch, TEXT_CONFIG, "cpu", data_dir)
    batches = DataLoader(ds, bsz, shuffle=True, seed=SEED).infinite()
    host = next(batches)
    g = torch.Generator().manual_seed(SEED + 33)
    t = torch.randint(0, T, (bsz,), generator=g)
    noise = torch.randn(bsz, 12, 62, generator=g)
    dev_batch = card.put_batch(host)
    if tuple(dev_batch["text_emb"].shape) != (bsz, 50, 768):
        raise RuntimeError(f"text train: the batch's text_emb is {dev_batch['text_emb'].shape}")
    loss_c, grads_c = step_grads(torch, card, dev_batch, t.to(DEV), noise.to(DEV))
    loss_p, grads_p = step_grads(torch, cpu, cpu.put_batch(host), t, noise)
    worst, at, whole = grad_rel_l2(grads_c, grads_p)
    text_params = [i for i, n in enumerate(card.names) if "attn_cross" in n or ".2.fn." in n
                   or "fc_text_f" in n]
    zero = [card.names[i] for i in text_params if not grads_c[i].abs().max().item() > 0]
    del grads_c, grads_p, cpu
    loss_rel = abs(loss_c - loss_p) / abs(loss_p)
    ok = (loss_rel <= TRAIN_STEP_TOL["loss"] and worst <= TRAIN_STEP_TOL["grad_rel_l2"]
          and len(text_params) == TEXT_CONTEXTS * 6 + 2 and not zero)
    print(f"train text, card vs cpu (B={bsz}, f32, TF32 off): loss {loss_c:.7f} vs "
          f"{loss_p:.7f} (relative {loss_rel:.3e}), gradient relative L2: worst parameter "
          f"{worst:.3e} ({card.names[at]}), whole {whole:.3e}; tol={TRAIN_STEP_TOL}; "
          f"{len(text_params)} text parameters, {len(zero)} with a zero gradient "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise RuntimeError(f"the text step disagrees between card and CPU: loss {loss_rel}, "
                           f"gradients {worst} at {card.names[at]}; zero gradients: {zero}")
    _, step_ms, peak_gb, first, last = train_steps(torch, card, batches, TEXT_TRAIN_STEPS,
                                                   "train text")
    return {"config": TEXT_CONFIG, "B": bsz, "dtype": "float32", "steps": TEXT_TRAIN_STEPS,
            "ms_per_step": step_ms, "peak_mem_gb": peak_gb, "loss_first5": first,
            "loss_last5": last, "text_parameters": len(text_params),
            "card_vs_cpu": {"loss_rel": loss_rel, "grad_rel_l2_worst": worst,
                            "grad_rel_l2": whole}}


def phase_text_cli(torch, data_dir, out_dir, card):
    """Phase 17 (e): train_diffusion on the text config for TEXT_CLI_EPOCHS
    epochs, then generate_diffusion --fused (DDPM-1000) on its checkpoint,
    once with --fix_order and once with --scene_id: GEN_SCENES scenes in
    one batch, exactly 28,000 B1 and 1,000 B2 launches, a box file and a
    sentence file a scene (every --scene_id sentence of one room, the
    --fix_order ones of several)."""
    from diffuscene_tpu_torch.cli import generate_diffusion, train_diffusion
    from diffuscene_tpu_torch.data.factory import get_raw_dataset
    from diffuscene_tpu_torch.ops import attention as at
    from diffuscene_tpu_torch.ops import fused_resblock as rb
    from diffuscene_tpu_torch.utils.config import load_config

    cfg_path = synthetic_config(TEXT_CONFIG, data_dir, out_dir, "text.yaml")
    t0 = time.perf_counter()
    train_diffusion.main([cfg_path, out_dir, "--experiment_tag", "text", "--seed", str(SEED),
                          "--epochs", str(TEXT_CLI_EPOCHS), "--device", DEV])
    out = {"train_s": time.perf_counter() - t0}
    scene_id = get_raw_dataset(load_config(cfg_path)["data"], split=["test"]).scene_ids[0]
    for label, flags in (("fix_order", ["--fix_order"]), ("scene_id", ["--scene_id", scene_id])):
        gen_dir = os.path.join(out_dir, f"generated_{label}")
        torch.cuda.synchronize()
        rb.fused_resnet_block.launches = at.fused_set_attention.launches = 0
        t0 = time.perf_counter()
        stats = generate_diffusion.main(
            [cfg_path, gen_dir, "--weight_file", os.path.join(out_dir, "text"), "--n_sequences",
             str(GEN_SCENES), "--batch_size", str(GEN_SCENES), "--clip_denoised", "--fused",
             "--seed", str(SEED), "--device", DEV, *flags])
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches = (rb.fused_resnet_block.launches, at.fused_set_attention.launches)
        files = os.listdir(gen_dir)
        n_boxes = len([f for f in files if f.endswith("_boxes.npz")])
        texts = []
        for f in sorted(files):
            if f.endswith(".txt") and f != "iou_states.txt":
                with open(os.path.join(gen_dir, f)) as fh:
                    texts.append(fh.read())
        # the first sentence lists the scene's objects; the relations after
        # it follow the eval set's fixed rotation, drawn at each read
        rooms = {w.split(" . ")[0] for w in texts}
        with open(os.path.join(gen_dir, "metrics.json")) as f:
            saved = json.load(f)
        ok = (launches == (28 * T, T) and n_boxes == len(texts) == GEN_SCENES
              and saved == stats and stats.get("n_scenes") == GEN_SCENES
              and all(w.startswith("The room has ") for w in texts)
              and (len(rooms) == 1) == (label == "scene_id"))
        print(f"cli: generate_diffusion --fused {' '.join(flags)} {GEN_SCENES} scenes (text, EMA "
              f"weights) {gen_s:.3f} s, launches B1={launches[0]} B2={launches[1]}, {n_boxes} "
              f"box files, {len(texts)} sentence files ({len(rooms)} distinct rooms, "
              f"{len(set(texts))} distinct sentences), stats {stats} {'ok' if ok else 'FAIL'} "
              f"| {card}", flush=True)
        if not ok:
            raise RuntimeError(f"the text CLI ({label}) failed: launches {launches}, {n_boxes} "
                               f"box files, {len(texts)} sentence files, {len(rooms)} rooms")
        out[label] = {"generate_s": gen_s, "launches": list(launches),
                      "distinct_rooms": len(rooms), "distinct_sentences": len(set(texts))}
    print(f"cli: train_diffusion text config {TEXT_CLI_EPOCHS} epochs {out['train_s']:.3f} s",
          flush=True)
    return out


def phase_text(torch, card):
    """Phase 17: text-conditioned generation, f32 at full width, on a
    synthetic cached dataset made from the seed."""
    import shutil

    from diffuscene_tpu_torch.data import make_synthetic_cached_dataset

    for d in (TEXT_DATA, TEXT_OUT):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(TEXT_OUT)
    make_synthetic_cached_dataset(TEXT_DATA, n_scenes=TRAIN_SCENES, seed=SEED)
    t0 = time.perf_counter()
    out = {"card": card, "samples": phase_text_samples(torch, card, TEXT_DATA)}
    torch.cuda.empty_cache()
    out["train"] = phase_train_text(torch, TEXT_DATA)
    torch.cuda.empty_cache()
    out["cli"] = phase_text_cli(torch, TEXT_DATA, TEXT_OUT, card)
    out["phase_s"] = time.perf_counter() - t0
    print(f"text: phase 17 took {out['phase_s']:.1f} s", flush=True)
    return out


def check_launches(label, got, want):
    """A CLI run's B1 and B2 launches must be exactly the sampler's count."""
    if tuple(got) != tuple(want):
        raise RuntimeError(f"{label}: launches B1={got[0]} B2={got[1]}, expected {want}")


def eval_cli_run(torch, cli, argv):
    """One CLI call with the B1 and B2 counts set to 0 just before it:
    (its return, (B1, B2) launches, wall seconds)."""
    from diffuscene_tpu_torch.ops import attention as at
    from diffuscene_tpu_torch.ops import fused_resblock as rb

    torch.cuda.synchronize()
    rb.fused_resnet_block.launches = at.fused_set_attention.launches = 0
    t0 = time.perf_counter()
    out = cli.main(argv)
    torch.cuda.synchronize()
    return out, (rb.fused_resnet_block.launches, at.fused_set_attention.launches), \
        time.perf_counter() - t0


def eval_pngs(folder, n, shape):
    """Exactly ``n`` PNGs {i:05d}.png in ``folder``, each decoded by the
    port's reader to ``shape`` uint8; returns the images."""
    import numpy as np

    from diffuscene_tpu_torch.eval.png import read_png

    names = sorted(f for f in os.listdir(folder) if f.endswith(".png") and len(f) == 9)
    if names != [f"{i:05d}.png" for i in range(n)]:
        raise RuntimeError(f"{folder}: {len(names)} renders, expected {n}")
    imgs = [read_png(os.path.join(folder, f)) for f in names]
    if any(im.shape != shape or im.dtype != np.uint8 for im in imgs):
        raise RuntimeError(f"{folder}: a render is not {shape} uint8")
    return np.stack(imgs)


def phase_eval_generate(torch, cfg_path, exp, out_dir, card):
    """Phase 18 (a): run/generate.sh's command, one batch of GENERATE_B:
    generate_diffusion --n_sequences 256 --batch_size 256 --clip_denoised
    --fused --render --compute_intersec on the seed's checkpoint; exactly
    28,000 B1 and 1,000 B2 launches, 256 renders the port's reader decodes
    to (256, 256, 3) uint8, iou_states.txt and a finite metrics.json, and
    the wall time split into sampling, rendering and metrics."""
    from diffuscene_tpu_torch.cli import generate_diffusion

    gen_dir = os.path.join(out_dir, "generated")
    stats, launches, wall_s = eval_cli_run(torch, generate_diffusion, [
        cfg_path, gen_dir, "--weight_file", exp, "--n_sequences", str(GENERATE_B),
        "--batch_size", str(GENERATE_B), "--clip_denoised", "--fused", "--render",
        "--compute_intersec", "--seed", str(SEED), "--device", DEV])
    check_launches("eval: generate", launches, (28 * T, T))
    eval_pngs(gen_dir, GENERATE_B, (256, 256, 3))
    with open(os.path.join(gen_dir, "metrics.json")) as f:
        saved = json.load(f)
    with open(os.path.join(gen_dir, "iou_states.txt")) as f:
        iou_lines = len(f.read().splitlines())
    with open(os.path.join(gen_dir, "timing.json")) as f:
        split = json.load(f)
    ok = (saved == stats and saved.get("n_scenes") == GENERATE_B and iou_lines == GENERATE_B
          and all(math.isfinite(v) for v in saved.values()))
    print(f"eval: generate_diffusion --n_sequences {GENERATE_B} --batch_size {GENERATE_B} "
          f"--clip_denoised --fused --render --compute_intersec: {wall_s:.3f} s (sampling "
          f"{split['sample_s']:.3f} s, rendering {split['render_s']:.3f} s, metrics "
          f"{split['metrics_s']:.3f} s), launches B1={launches[0]} B2={launches[1]}, "
          f"{GENERATE_B} renders (256, 256, 3) uint8, {iou_lines} iou_states lines, metrics "
          f"{saved} {'ok' if ok else 'FAIL'} | {card}", flush=True)
    if not ok:
        raise RuntimeError(f"the generate command's outputs are wrong: metrics {saved}")
    return gen_dir, {"wall_s": wall_s, **split, "launches": list(launches),
                     "render_share": split["render_s"] / wall_s, "metrics": saved}


def phase_eval_mesh(torch, cfg_path, exp, out_dir, card):
    """Phase 18 (b): a textured-box catalog per class of the dataset
    (data.make_synthetic_catalog), then generate_diffusion with it at
    B=EVAL_MESH_B through DPM-Solver++-20, --render --render_perspective
    --save_mesh --compute_intersec --judge_mesh_intersec: catalog texels in
    the renders, the perspective renders, the merged mesh and the objects'
    files, each manifest's jids from the catalog, and the judged
    intersection no larger than the boxes'; then completion_rearrange
    --num_partial 3 --render --render_gt at run/completion.sh's B=32."""
    import numpy as np

    from diffuscene_tpu_torch.cli import completion_rearrange, generate_diffusion
    from diffuscene_tpu_torch.cli._box_stats import mean_box_stats, scene_box_stats
    from diffuscene_tpu_torch.data import ThreedFutureDataset, make_synthetic_catalog
    from diffuscene_tpu_torch.data.factory import get_raw_dataset
    from diffuscene_tpu_torch.eval.png import read_png
    from diffuscene_tpu_torch.utils.config import load_config

    raw = get_raw_dataset(load_config(cfg_path)["data"], split=["test"])
    catalog = make_synthetic_catalog(os.path.join(out_dir, "catalog"), raw.class_labels, seed=SEED)
    objects = ThreedFutureDataset.from_pickled_dataset(catalog).objects
    jids = {o.model_jid for o in objects}
    texels = set()
    for o in objects:
        tex = read_png(o.texture_image_path).reshape(-1, 3)
        texels |= {tuple(int(c) for c in px) for px in np.unique(tex, axis=0)}

    mesh_dir = os.path.join(out_dir, "generated_mesh")
    stats, launches, wall_s = eval_cli_run(torch, generate_diffusion, [
        cfg_path, mesh_dir, catalog, "--weight_file", exp, "--n_sequences", str(EVAL_MESH_B),
        "--batch_size", str(EVAL_MESH_B), "--clip_denoised", "--fused", "--dpm",
        "--dpm_steps", str(DPM_STEPS), "--render", "--render_perspective", "--save_mesh",
        "--compute_intersec", "--judge_mesh_intersec", "--seed", str(SEED), "--device", DEV])
    check_launches("eval: generate with the catalog", launches, (28 * DPM_STEPS, DPM_STEPS))
    renders = eval_pngs(mesh_dir, EVAL_MESH_B, (256, 256, 3))
    packed = renders.reshape(-1, 3).astype(np.int64) @ np.array([65536, 256, 1])
    textured = int(np.isin(packed, [r * 65536 + g * 256 + b for r, g, b in texels]).sum())
    persp = [read_png(os.path.join(mesh_dir, f"{i:05d}_persp.png")).shape
             for i in range(EVAL_MESH_B)]
    scene_mesh = os.path.join(mesh_dir, "scene_mesh")
    merged = [f"{i:05d}.obj" for i in range(EVAL_MESH_B)]
    n_objects, bad_jids, unjudged = 0, 0, []
    for i in range(EVAL_MESH_B):
        with open(os.path.join(mesh_dir, f"{i:05d}_scene.json")) as f:
            manifest = json.load(f)
        n_objects += len(manifest)
        bad_jids += sum(m["model_jid"] not in jids for m in manifest)
        objs = [f for f in os.listdir(os.path.join(scene_mesh, f"{i:05d}")) if f.endswith(".obj")]
        if len(objs) != len(manifest):
            raise RuntimeError(f"eval: scene {i}: {len(objs)} object files, {len(manifest)} "
                               f"manifest entries")
        with np.load(os.path.join(mesh_dir, f"{i:05d}_boxes.npz")) as d:
            unjudged.append(scene_box_stats(dict(d)))
    boxes_only = mean_box_stats(unjudged)
    ok = (textured > 0 and all(p == (512, 512, 3) for p in persp) and bad_jids == 0
          and all(os.path.isfile(os.path.join(scene_mesh, m)) for m in merged)
          and stats["avg_intersec"] <= boxes_only["avg_intersec"]
          and stats["avg_pair_iou"] <= boxes_only["avg_pair_iou"])
    print(f"eval: generate_diffusion with the catalog ({len(objects)} textured boxes) "
          f"--dpm --render --render_perspective --save_mesh --judge_mesh_intersec: "
          f"{EVAL_MESH_B} scenes {wall_s:.3f} s, launches B1={launches[0]} B2={launches[1]}, "
          f"{textured} render pixels of catalog texels, {len(persp)} perspective renders "
          f"512x512, {n_objects} objects in the manifests ({bad_jids} jids outside the "
          f"catalog), judged avg_intersec {stats['avg_intersec']:.6f} <= boxes' "
          f"{boxes_only['avg_intersec']:.6f} {'ok' if ok else 'FAIL'} | {card}", flush=True)
    if not ok:
        raise RuntimeError("the mesh path's outputs are wrong")
    out = {"wall_s": wall_s, "launches": list(launches), "textured_pixels": textured,
           "objects": n_objects, "judged_avg_intersec": stats["avg_intersec"],
           "box_avg_intersec": boxes_only["avg_intersec"]}

    comp_dir = os.path.join(out_dir, "completed")
    metrics, launches, wall_s = eval_cli_run(torch, completion_rearrange, [
        cfg_path, comp_dir, "--weight_file", exp, "--num_partial", str(TASK_PARTIAL),
        "--n_sequences", str(TASK_B), "--batch_size", str(TASK_B), "--clip_denoised",
        "--fused", "--render", "--render_gt", "--compute_intersec", "--seed", str(SEED),
        "--device", DEV])
    check_launches("eval: completion", launches, (28 * T, T))
    for sub in ("", "partial", "groundtruth"):
        eval_pngs(os.path.join(comp_dir, sub), TASK_B, (256, 256, 3))
    print(f"eval: completion_rearrange --num_partial {TASK_PARTIAL} --render --render_gt "
          f"{TASK_B} scenes {wall_s:.3f} s, launches B1={launches[0]} B2={launches[1]}, "
          f"{TASK_B} renders each of the results, partial/ and groundtruth/, metrics "
          f"{metrics} ok | {card}", flush=True)
    out["completion"] = {"wall_s": wall_s, "launches": list(launches)}
    return out


def phase_eval_metrics(torch, cfg_path, gen_dir, out_dir, card):
    """Phase 18 (c): the real set is the eval split's boxes through
    render_to_folder; compute_fid_scores --features inception (a random
    InceptionV3 state dict as .npz) and --features pixel, and
    improved_precision_recall --features vgg (a random VGG16) and --features
    pixel, between it and phase (a)'s renders, on the card; the three
    extractors' features of EVAL_CHECK_IMAGES renders on the card against
    the same modules on the CPU, and each backbone's images/s on the card."""
    import numpy as np

    from diffuscene_tpu_torch.cli import compute_fid_scores, improved_precision_recall
    from diffuscene_tpu_torch.data.factory import get_raw_dataset
    from diffuscene_tpu_torch.eval.backbones import (random_inception_state_dict,
                                                     random_vgg16_state_dict)
    from diffuscene_tpu_torch.eval.fid import (InceptionFeatures, PixelFeatures, VGG16Features,
                                               load_image_folder)
    from diffuscene_tpu_torch.eval.render import render_to_folder
    from diffuscene_tpu_torch.utils.config import load_config

    t0 = time.perf_counter()
    raw = get_raw_dataset(load_config(cfg_path)["data"], split=["test"])
    real_dir = os.path.join(out_dir, "real")
    render_to_folder([raw[i] for i in range(len(raw))], real_dir)
    real_s = time.perf_counter() - t0
    weights = {}
    for name, make in (("inception", random_inception_state_dict), ("vgg", random_vgg16_state_dict)):
        weights[name] = os.path.join(out_dir, f"random_{name}.npz")
        np.savez(weights[name], **make(SEED))
    print(f"eval: {len(raw)} real renders of the eval split {real_s:.3f} s; the backbones' "
          f"weights are RANDOM (InceptionV3 and VGG16 from the seed), so FID, KID and "
          f"precision/recall below are NOT paper-comparable", flush=True)

    out = {"real_renders": len(raw), "weights": "random, not paper-comparable"}
    for label, cli, flags in (
            ("fid_inception", compute_fid_scores, ["--features", "inception",
                                                   "--inception_weights", weights["inception"]]),
            ("fid_pixel", compute_fid_scores, ["--features", "pixel"]),
            ("ipr_vgg", improved_precision_recall, ["--features", "vgg",
                                                    "--vgg_weights", weights["vgg"]]),
            ("ipr_pixel", improved_precision_recall, ["--features", "pixel"])):
        t0 = time.perf_counter()
        res = cli.main([real_dir, gen_dir, *flags, "--device", DEV])
        res_s = time.perf_counter() - t0
        nums = {k: v for k, v in res.items() if k in ("fid", "kid", "precision", "recall")}
        if not nums or not all(math.isfinite(v) for v in nums.values()):
            raise RuntimeError(f"eval: {label} gave {res}")
        print(f"eval: {cli.__name__.rsplit('.', 1)[1]} {' '.join(flags[:2])}: {nums} "
              f"{res_s:.3f} s (random weights) | {card}", flush=True)
        out[label] = {**nums, "s": res_s}

    images = load_image_folder(gen_dir)
    agree = {}
    for name, make in (("pixel", lambda d: PixelFeatures(device=d)),
                       ("inception", lambda d: InceptionFeatures(weights["inception"], device=d)),
                       ("vgg", lambda d: VGG16Features(weights["vgg"], device=d))):
        card_fn, cpu_fn = make(DEV), make("cpu")
        a = card_fn(images[:EVAL_CHECK_IMAGES])
        b = cpu_fn(images[:EVAL_CHECK_IMAGES])
        if name == "pixel":
            err = float(np.abs(a - b).max())
        else:
            err = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card_fn(images)
        ips = len(images) / (time.perf_counter() - t0)
        ok = err <= EVAL_FEATURE_TOL[name]
        print(f"eval: {name} features of {EVAL_CHECK_IMAGES} renders, card vs CPU: "
              f"{'max abs' if name == 'pixel' else 'relative L2'} {err:.3e} (tol "
              f"{EVAL_FEATURE_TOL[name]:.3e}) {'ok' if ok else 'FAIL'}; {ips:.1f} images/s on "
              f"the card over {len(images)} renders | {card}", flush=True)
        if not ok:
            raise RuntimeError(f"eval: {name} features disagree between the card and the CPU")
        agree[name] = {"err": err, "tol": EVAL_FEATURE_TOL[name], "images_per_s": ips}
    out["features"] = agree
    return out


def phase_eval(torch, card):
    """Phase 18: the evaluation path on a synthetic cached dataset made from
    the seed, and a checkpoint of the flagship model's seeded weights
    written by the port's checkpoint module."""
    import shutil

    from diffuscene_tpu_torch.data import make_synthetic_cached_dataset
    from diffuscene_tpu_torch.utils.checkpoint import save_checkpoint

    for d in (EVAL_DATA, EVAL_OUT):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(EVAL_OUT)
    t0 = time.perf_counter()
    make_synthetic_cached_dataset(EVAL_DATA, n_scenes=EVAL_SCENES, seed=SEED)
    cfg_path = synthetic_config(FLAGSHIP_CONFIG, EVAL_DATA, EVAL_OUT, "flagship_eval.yaml")
    exp = os.path.join(EVAL_OUT, "seeded")
    save_checkpoint({"step": 0, "model": task_model(torch, FLAGSHIP_CONFIG).networks.state_dict(),
                     "ema": None}, exp, 0)
    out = {"card": card, "setup_s": time.perf_counter() - t0}
    gen_dir, out["generate"] = phase_eval_generate(torch, cfg_path, exp, EVAL_OUT, card)
    out["mesh"] = phase_eval_mesh(torch, cfg_path, exp, EVAL_OUT, card)
    out["metrics"] = phase_eval_metrics(torch, cfg_path, gen_dir, EVAL_OUT, card)
    out["phase_s"] = time.perf_counter() - t0
    print(f"eval: phase 18 took {out['phase_s']:.1f} s", flush=True)
    return out


def profile_steps(torch, step, n, step_ms, named=()):
    """Where a step's time goes: torch.profiler over ``n`` steady steps;
    device busy time (the sum of the kernels' times, one stream), the idle
    share of the unprofiled step time ``step_ms`` (the profiler slows the
    host), the kernels that take the most, and the time of each hand-written
    kernel in ``named`` ((label, a part of its kernel name) pairs)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not busy_us:
        print("profile: the profiler saw no device time (not measured)", flush=True)
        return {"busy_ms": None, "idle_share": None, "top": [], "named_ms": {}}
    busy_ms = busy_us / n / 1e3
    print(f"profile: {n} steps, device busy {busy_ms:.3f} ms/step; unprofiled step {step_ms:.3f} "
          f"ms, idle share {1 - busy_ms / step_ms:.3f}; profiled wall {wall_us / n / 1e3:.3f} "
          f"ms/step", flush=True)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    for e in top:
        print(f"profile:   {e.self_device_time_total / busy_us:6.1%} "
              f"{e.self_device_time_total / n / 1e3:8.3f} ms/step {e.count // n:4d} calls/step "
              f"{e.key[:90]}", flush=True)
    named_ms = {}
    for label, match in named:
        mine = [e for e in kernels if match in e.key]
        us = sum(e.self_device_time_total for e in mine)
        if not us:
            raise RuntimeError(f"the profile shows no device time of {label} ({match})")
        named_ms[label] = us / n / 1e3
        print(f"profile: {label} ({match}) {us / n / 1e3:.3f} ms/step, "
              f"{sum(e.count for e in mine) // n} calls/step, {us / busy_us:.1%} of the device "
              f"time", flush=True)
    return {"busy_ms": busy_ms, "idle_share": 1 - busy_ms / step_ms,
            "top": [[e.key[:60], e.self_device_time_total / n / 1e3] for e in top[:5]],
            "named_ms": named_ms}


def main(argv):
    import torch

    only = argv[0] if argv else None
    if argv not in ([], *([flag] for flag in ONLY)):
        print(f"usage: chip_smoke.py [{' | '.join(ONLY)}]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from diffuscene_tpu_torch.ops import attention as at
    from diffuscene_tpu_torch.ops import build
    from diffuscene_tpu_torch.ops import chamfer as ch
    from diffuscene_tpu_torch.ops import fused_level as fl
    from diffuscene_tpu_torch.ops import fused_resblock as rb

    card = card_line()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    t0 = time.perf_counter()
    libs = build.build([fl.CSRC, ch.CSRC, rb.CSRC, at.CSRC])
    for mod in (fl, ch, rb, at):
        mod.load_library()
    print(f"build: {', '.join(p.name for p in libs)} in {time.perf_counter() - t0:.2f} s "
          f"(one nvcc each, in parallel)", flush=True)
    for lib in libs:
        ptxas = lib.with_suffix(".ptxas.txt")
        if ptxas.exists():
            for name, regs, spill in ptxas_summary(ptxas.read_text()):
                print(f"ptxas {lib.name.rsplit('_', 1)[0]} {name}: {regs} | {spill}")
                if (any(k in name for k in NO_SPILL_KERNELS)
                        and " 0 bytes spill stores, 0 bytes spill loads" not in spill):
                    raise RuntimeError(f"ptxas spills in {name}: {spill}")

    if only == "--only-resblock":   # the short check of a new B1 kernel: phase 7 alone
        resblock_plan(rb, torch)
        resblock_forward(*phase_resblock(rb, torch))
        print(card_line())
        return 0
    if only == "--only-attention":  # the short check of a new B2 kernel: phase 8 alone
        attention_phase(at, torch)
        print(card_line())
        return 0
    if only == "--only-chamfer":    # the short check of a new B3 kernel: phase 5 alone
        phase_chamfer(ch, torch)
        print(card_line())
        return 0
    if only == "--only-train":      # the scene model's training path alone: phases 12-14
        print(json.dumps({"train": phase_train(torch, card)}))
        print(card_line())
        return 0
    if only == "--only-tasks":      # scene completion and re-arrangement alone: phase 16
        print(json.dumps({"tasks": phase_tasks(torch, card)}))
        print(card_line())
        return 0
    if only == "--only-text":       # text-conditioned generation alone: phase 17
        print(json.dumps({"text": phase_text(torch, card)}))
        print(card_line())
        return 0
    if only == "--only-eval":       # the evaluation path alone: phase 18
        print(json.dumps({"eval": phase_eval(torch, card)}))
        print(card_line())
        return 0
    if only == "--only-f32-engine":  # the flagship config's own dtype: phases 3 + 9 and 15, f32
        scene32 = phase_forward(torch, torch.float32)
        phase_rows_sample(torch, scene32, card)
        phase_engine_samples(torch, scene32, card, dpm_batch=GENERATE_B,
                             profile_batches=(GENERATE_B,))
        phase_drift(torch, scene32)
        print(card_line())
        return 0
    chain_plan(fl, torch)
    worst, results = phase_kernels(fl, torch)
    chain_fwd = chain_forward(results)
    fwd, chain_bound_ms, chain_bound_by = chain_fwd["bfloat16"]
    fwd32, chain32_bound_ms, _ = chain_fwd["float32"]
    if only == "--only-chain":      # the short check of a new chain kernel: phase 2 alone
        print(card_line())
        return 0

    resblock_plan(rb, torch)
    rb_worst, rb_out = resblock_forward(*phase_resblock(rb, torch))
    rb_fwd, rb_bound_ms, rb_bound_by = rb_out["bfloat16"]
    rb32_fwd, rb32_bound_ms, _ = rb_out["float32"]
    at_worst, at_main = attention_phase(at, torch)

    scene32 = phase_forward(torch, torch.float32)
    scene = phase_forward(torch, torch.bfloat16)

    # the first slice's main path: 1000-step DDPM sample, every chain
    # through the kernel
    chain_launches = phase_rows_sample(torch, scene, card)

    # this slice's main path: the 3-D engine, every ResnetBlock on B1 and
    # mid_attn on B2
    rb_launches, at_launches = phase_engine_samples(torch, scene, card)
    del scene
    # phase 15: the flagship config's own dtype, f32, through the rows
    # engine and the 3-D engine
    chain32_launches = phase_rows_sample(torch, scene32, card)
    rb32_launches, at32_launches = phase_engine_samples(torch, scene32, card,
                                                        dpm_batch=GENERATE_B,
                                                        profile_batches=(GENERATE_B,))
    phase_drift(torch, scene32)
    del scene32
    torch.cuda.empty_cache()

    cham = phase_chamfer(ch, torch)
    # the second slice's main path: AE training steps, every chamfer on the kernel
    cham_launches = phase_autoencoder(ch, torch)
    torch.cuda.empty_cache()
    # this slice's main path: the scene model's train steps and the train
    # and generate CLIs (B1 and B2 in generate)
    train = phase_train(torch, card)
    torch.cuda.empty_cache()
    # this slice's main paths: scene completion and re-arrangement, f32,
    # through the 3-D engine (B1 and B2), and the rearrange training
    tasks = phase_tasks(torch, card)
    task_launches = {k: v["launches"] for k, v in tasks["samples"].items()}
    torch.cuda.empty_cache()
    # this slice's main path: text-conditioned generation through both
    # engines (B1 and B2, B4), the text train step and the text CLIs
    text = phase_text(torch, card)
    text_launches = {k: v["launches"] for k, v in text["samples"].items() if k != "roll"}
    torch.cuda.empty_cache()
    # this slice's main path: run/generate.sh's command with its renders and
    # box metrics (B1 and B2), the mesh path, FID/KID and precision/recall
    ev = phase_eval(torch, card)
    eval_launches = ev["generate"]["launches"]

    print(json.dumps({"train": train}))
    print(json.dumps({"tasks": tasks}))
    print(json.dumps({"text": text}))
    print(json.dumps({"eval": ev}))
    print(json.dumps({"kernels": [{
        "name": "fused_chain",
        "route": "cuda",
        "source": "diffuscene_tpu_torch/csrc/fused_chain.cu",
        "replaces": "diffuscene_tpu/ops/fused_level.py:165",
        "launches": chain_launches,
        "max_abs_err": worst,
        "ms": fwd[1],
        "graph_ms": fwd[6],
        "plain_ms": fwd[2],
        "bound_ms": chain_bound_ms,
        "bound_by": chain_bound_by,
        "library_ms": None,
        "f32_launches": chain32_launches,
        "f32_ms": fwd32[1],
        "f32_graph_ms": fwd32[6],
        "f32_plain_ms": fwd32[2],
        "f32_bound_ms": chain32_bound_ms,
        "text_launches": text_launches["ddpm_rows"][0],
    }, {
        "name": "chamfer_nn",
        "route": "cuda",
        "source": "diffuscene_tpu_torch/csrc/chamfer_nn.cu",
        "replaces": "diffuscene_tpu/ops/chamfer.py:65",
        "launches": cham_launches,
        "max_abs_err": cham["max_abs_err"],
        "ms": cham["ms"],
        "graph_ms": cham["graph_ms"],
        "plain_ms": cham["plain_ms"],
        "bound_ms": cham["bound_ms"],
        "bound_by": cham["bound_by"],
        "library_ms": cham["library_ms"],
    }, {
        "name": "fused_resblock",
        "route": "cuda",
        "source": "diffuscene_tpu_torch/csrc/fused_resblock.cu",
        "replaces": "diffuscene_tpu/ops/fused_resblock.py:89",
        "launches": rb_launches,
        "max_abs_err": rb_worst,
        "ms": rb_fwd[1],
        "graph_ms": rb_fwd[6],
        "plain_ms": rb_fwd[2],
        "bound_ms": rb_bound_ms,
        "bound_by": rb_bound_by,
        "library_ms": None,
        "f32_launches": rb32_launches,
        "f32_ms": rb32_fwd[1],
        "f32_graph_ms": rb32_fwd[6],
        "f32_plain_ms": rb32_fwd[2],
        "f32_bound_ms": rb32_bound_ms,
        "task_launches": {k: v[0] for k, v in task_launches.items()},
        "text_launches": text_launches["ddpm_3d"][0],
        "eval_launches": eval_launches[0],
    }, {
        "name": "set_attention",
        "route": "cuda",
        "source": "diffuscene_tpu_torch/csrc/set_attention.cu",
        "replaces": "diffuscene_tpu/ops/attention.py:35",
        "launches": at_launches,
        "max_abs_err": at_worst,
        "ms": at_main["bfloat16"]["ms"],
        "graph_ms": at_main["bfloat16"]["graph"],
        "plain_ms": at_main["bfloat16"]["plain"],
        "bound_ms": at_main["bfloat16"]["bound"],
        "bound_by": at_main["bfloat16"]["bound_by"],
        "library_ms": None,
        "f32_launches": at32_launches,
        "f32_ms": at_main["float32"]["ms"],
        "f32_graph_ms": at_main["float32"]["graph"],
        "f32_plain_ms": at_main["float32"]["plain"],
        "f32_bound_ms": at_main["float32"]["bound"],
        "task_launches": {k: v[1] for k, v in task_launches.items()},
        "text_launches": text_launches["ddpm_3d"][1],
        "eval_launches": eval_launches[1],
    }]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
