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
   SceneDiffusion.sample(fused="rows", graph=False; phase 24 holds its
   graph to it), bf16: shape, finiteness, and
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
   1e-4, clip 10), eagerly (graph=False: phase 25 holds the graphed step
   to it): one step with the kernel against the same step with the plain
   version, then 30 train steps on 16 synthetic box-surface clouds from
   the seed (finite, falling loss, 2 chamfer-kernel launches a step,
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
   kernels do not take (C=256 in bf16 and 384 in f32, 8 heads of 16, N=25)
   must raise in both dtypes;
9. one full-width forward of the flagship through the 3-D engine
   (fused_unet1d_forward, 28 B1 and 1 B2 launches) against the plain Unet1D
   module in f32 and bf16 and against the rows engine, with each engine's
   ms per forward;
10. the 3-D engine, bf16, B=64 (SceneDiffusion.sample(fused=True)):
   torch.profiler over 20 steps against the step's host-clock time (B1's
   and B2's ms per step; a named kernel the profile does not show raises);
   its 1000-step DDPM sample (28,000 B1, 1,000 B2) is cut for the script's
   time: phase 22 holds a bf16 DDPM sample (over CUT_STEPS steps) through
   the same engine;
11. a 20-step DPM-Solver++ sample of 64 scenes, fused=True, bf16: finite,
   exactly 560 B1 and 20 B2 launches, wall time;
15. the flagship config's own dtype, f32 (the scene phase 3 built):
   through the rows engine, a DPM-Solver++-20 sample of 64 scenes (exactly
   380 chain launches; ``--only-f32-engine`` a 1000-step DDPM sample, 19,000)
   with a 20-step profile naming chain_tf32; through
   the 3-D engine, a 1000-step DDPM sample of 64 scenes (exactly 28,000 B1
   and 1,000 B2 launches; eagerly, graph=False, phase 24 holding its graph
   to it) with a 20-step profile against its step time, a
   20-step DPM-Solver++ sample at run/generate.sh's batch of 256 (exactly
   560 and 20); each profile names the f32 kernels (resblock_tf32,
   attention_tf32) and gives their ms per step, busy time and idle share
   (``--only-f32-engine`` also profiles a B=256 step against its
   host-clock time); then DDPM-1000 at B=16 from one seeded generator: at
   every other step of the fused=True trajectory both engines (exact GELU)
   within FORWARD_TOL of the module on that step's x_t (a breach fails and
   names the step);
12. the scene model's training path at the flagship's full width (the
   diffusion_bedrooms_instancond_lat32_v config: dim 512, 4 levels, N=12,
   v-prediction, loss_separate, loss_iou on the train bounds, clip + Adam,
   B=128, f32), on a synthetic cached dataset of 640 rooms made from the
   seed and read through the copied data pipeline: one Trainer step on the
   card against the same step on the CPU on the first CARD_CPU_B (32)
   scenes of a batch (the loss, every loss term, the
   gradient norm and every parameter's gradient, same t and noise), then
   20 steps on the card (finite, falling loss, the median host-clock
   ms/step around train_step and its one metrics transfer, peak memory),
   then torch.profiler over 5 steps (busy time, idle share, top kernels);
   the trainer runs eagerly (graph=False), and phase 25 holds a graphed
   trainer to these steps;
13. the b512 recipe (bf16, ws_fast_vjp, fused Adam with bf16 moments, bf16
   gradients and EMA, B=512): one step's gradients with ws_fast_vjp against
   the same step without it, then 20 finite steps, ms/step, peak memory and
   the profile as in 12, eagerly (phase 25's twin as in 12);
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
   step on CARD_CPU_B scenes on the card against the CPU (loss and every
   gradient), then 10 steps at its B=128 (median ms/step, peak memory); (d)
   cli/train_diffusion.py on each config for 2 epochs, then
   cli/completion_rearrange.py --arrange_objects and --num_partial 3, each
   --fused --compute_intersec on one batch of 32, the configs' schedules
   cut to TASK_CLI_STEPS (100) steps: exactly 28 B1 and 1 B2 launches a
   step, 32 box files, a finite metrics.json;
17. text-conditioned generation in f32 at full width on the bedroom text
   config (dim 512, 9 linear cross-attention blocks over 50 tokens of 768
   through fc_text_f to 512), random weights from the seed, the tokens from
   the port's text pipeline (textfix, the hashed table) over the eval
   scenes of a synthetic cached dataset: (a) DDPM over CUT_STEPS (250)
   steps of the same weights through SceneDiffusion.sample(fused=True) at
   run/generate_text.sh's B=256, exactly 7,000 B1 and 250 B2 launches and
   9 cross-attention contexts, the 3-D engine (exact GELU) within
   FORWARD_TOL of the module every 50th step, wall time and scenes/s, a 20-step profile (busy time, idle share,
   B1 and B2 ms per step) and the 9 cross blocks' device time in such a
   step; (b) DDPM-1000 through fused="rows" at B=64, exactly 19,000 B4
   launches and 9 contexts, the rows engine within FORWARD_TOL of the
   module every 50th step; (c) one step at B=256 on one x_t in every
   scene with the text rolled by one scene: the unrolled output rolled by
   one scene (1e-5), and more than 1e-3 from the unrolled output; (d) the
   text config's train step on CARD_CPU_B scenes on the card against the
   CPU (loss and every gradient; every cross-attention parameter and
   fc_text_f with a non-zero gradient), then 10 steps at B=128 (median
   ms/step, peak memory); (e) cli/train_diffusion.py on the text config
   for 2 epochs, then cli/generate_diffusion.py --fused --dpm with
   --fix_order and with --scene_id: 64 scenes each, exactly 560 B1 and 20
   B2 launches, a box file and a sentence file a scene;
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
   EVAL_FEATURE_TOL, and each extractor's images/s on the card;
19. the data pipeline and room-mask conditioning: (a) a synthetic raw
   3D-FRONT / 3D-FUTURE tree of DATA_ROOMS bedrooms
   (data.make_synthetic_raw_front) through the port's CLIs in the
   README's order, each timed: pickle_threed_future_dataset,
   pickle_threed_future_pointcloud, train_objautoencoder on the card
   (exactly 2 B3 launches a step), generate_objautoencoder, preprocess_data
   --add_objfeats --room_mask_size 512; every room's boxes.npz,
   room_mask.png and render, the out-of-range room dropped, finite bounds,
   no empty 64x64 mask, the first 12 masks' levels as the CPU tests get
   them; (b) the flagship at full width as a room-mask model
   (room_mask_config: latent_dim and context_dim 64, a ResNet18 of 64
   features over 64x64 masks), its train step on CARD_CPU_B scenes on the
   card against the CPU (the loss and the denoiser's and heads' gradients; the
   extractor's gradients against the CPU's f64, in f64 and in f32), the
   extractor's share of a step's device time, then cli/train_diffusion.py
   for DATA_TRAIN_EPOCHS steps (ms/step, peak memory) and its checkpoint's
   frozen statistics bit for bit as initialized; (c) from that checkpoint,
   cli/generate_diffusion.py --fused --dpm --clip_denoised --fix_order at
   B=256 (exactly 560 B1 and 20 B2 launches, one extractor call), DDPM
   over CUT_STEPS (250) steps of the same weights at B=64 through
   fused="rows" (exactly 4,750 B4) and fused=True (7,000 B1, 250 B2), each
   engine within FORWARD_TOL of the module every 50th step, the
   extractor's features card vs CPU within DATA_FEATURE_TOL, and
   DPM-Solver++-20 from the same noise with the masks inverted giving
   other samples;
20. the single-card modules ported last, on a synthetic cached dataset of
   REST_SCENES rooms: (a) the flagship at full width (B=128, f32) trained
   through cli/train_diffusion.py --native_loader (the C++ batcher) with
   RAdam + warmup_cosine for 12 steps, --async_checkpoints and a
   --profile_dir window of REST_PROFILE_STEPS steps (its epoch-1
   checkpoint written by the background thread, the trace's bytes and
   kernel events), then SGD + lambda for 4 steps (median ms/step, peak
   memory; AdamW + step, cut here for the script's time, takes the
   async-save trainer's steps); each loader's batches/s alone; an async
   save of a card trainer's state (AdamW + step) equal to a blocking one
   while the next step updates it; (b) cli/generate_diffusion.py --fused --dpm at B=256
   from (a)'s checkpoint with --profile_dir: exactly 560 B1 and 20 B2
   launches, every one in the trace; (c) the flagship with a learned
   Fourier time embedding, DDPM over a REST_FOURIER_STEPS-step schedule at
   B=64 through the 3-D engine (exactly 28 B1 and 1 B2 a step) and the
   rows engine (19 B4 a step), each within FORWARD_TOL of the module every
   50th step, with a 20-step profile; (d) a dim_mults (1, 2) model of dim
   64 sampled through the module on the card, fused=True raising the
   card's width error (naming fused=False) and fused="rows" falling back
   to the 3-D engine and raising the same, with no launch; (e) (a)'s
   checkpoint, a shape AE and a ResNet18 extractor with random frozen
   statistics, on the card, through utils/export.py to the reference
   layout and back: every tensor bit-equal.  The chamfer kernel's count,
   set to 0 as the phase starts, must read 0 at its end;
21. the communication layer (parallel/*) and mixed precision, on random
   encoded bedrooms from the seed: (a) an NCCL group of one rank on the
   card: the flagship's data-parallel train step (Trainer(mesh=make_mesh()),
   B=128, f32) and ShardedSampler(fused=True) DPM-Solver++-20 at B=64 bit
   for bit equal to the step and SceneDiffusion.sample without a process
   group (exactly 560 B1 and 20 B2); (b) two gloo ranks on the one card,
   spawned (parallel_rank): the data-parallel (2 x 1) and tensor-parallel
   (1 x 2) flagship steps against the one-rank step, ShardedSampler through
   the 3-D engine and the rows engine, 32 scenes a rank (exactly 560 B1 and
   20 B2, and 380 B4, a rank), the gathered samples within FORWARD_TOL of
   the one-rank ones with every argmax class equal, and the data-parallel
   AE step at B=16 (2 B3 launches a rank) against the one-rank step; NCCL
   asked for two ranks on the one card must refuse them; (c) the b512
   recipe's bf16 step at B=512 with mixed_precision against its plain step
   from one state (the CPU tests' bounds), and each one's median ms/step
   over 2 x PAR_MP_STEPS steps, in turns (plain, mixed, mixed, plain), and
   peak memory, beside phase 13's; then
   cli/train_diffusion.py --mixed_precision under torchrun (one process)
   for PAR_CLI_EPOCHS epochs of the flagship config on synthetic rooms;
22. the B1 and B2 kernels at the widths and GroupNorm groupings the JAX
   engine serves, one set for both dtypes (B4 keeps C=512 in 8 groups):
   (a) B1 in f32 and in bf16 at every (C, groups) of the set (C = 256,
   512, 1024 in 4, 8, 16, 32 groups of at least 16 channels) with film
   rows, per scene and none, identity residuals over x and over [x | skip]
   and projections, inputs up to 2048 wide, B in (7, 256), N in (12, 21);
   B2 in both dtypes at C = 256, 512, 1024, N in (12, 21, 24), B in (7,
   64, 256); each against its plain version within KERNEL_TOL, with its
   launch plan, the wide kernels' ptxas report, and the times (eager,
   graph replay, device, plain, bound) of the 28 blocks of the wide
   flagship's (dim_mults [1, 1, 2, 2]) and the 4-, 8- and 16-group
   flagships' forwards and of B2 at (64, 12, C), in each dtype; (b) the
   wide model at B=64 through fused=True: in bf16 (the b512 recipe's
   network) DDPM over CUT_STEPS (250) steps, exactly 7,000 B1, 250 B2 and
   no B4 (4,250 on resblock_sm90 and 2,750 on resblock_bf16_wide, 250 on
   attention_bf16_wide), the engine within FORWARD_TOL of the module every
   50th call; in f32 (the flagship's network) DPM-Solver++-20, 560 B1, 20
   B2, no B4, held every WIDE_DPM_EVERY calls; each with a 20-step profile
   with B1 split by kernel; (c) the
   flagship and the b512 recipe's network in 4 and in 16 groups,
   DPM-Solver++-20 at B=64 through fused=True: 560 B1 and 20 B2, held
   every WIDE_DPM_EVERY calls; fused="rows" on the 16-group models running
   every chain on the wide B4 kernel (380 B4, no B1 or B2), and on the bf16
   wide model falling back to the 3-D engine (560 B1, 20 B2, no B4); (d) a
   dim 64 model in
   each dtype raising the width error naming fused=False with nothing
   launched, and cli/generate_diffusion.py --fused --dpm on the wide
   flagship config and on the wide b512 config at B=64 (exactly 560 B1 and
   20 B2 each); (e) this run's C=512 8-group figures in each dtype (the
   flagship's 28 blocks and B2, graph replay) beside PERF.md's, and each
   dtype's wide B2 at C=512 (uncounted) beside its C=512 kernel.  The
   phase prints its own time;
23. the chain kernel (B4) at B1's widths and groupings, both dtypes: (a) in
   f32 and in bf16, every chain variant (none, scene_res, row_scene,
   scene, row_skip, skip) at every (C, groups) of WIDE_CHAIN_SET (C = 256
   in 8 and 16 groups, 512 in 4, 16 and 32, 1024 in 4, 8 and 16; C=512 in 8
   groups stays on chain_tf32 / chain_sm90) on the wide kernels
   (chain_tf32_wide, chain_bf16_wide) against the plain version within
   KERNEL_TOL at N=12 and N=21 (B=64) and a ragged B=63, each case's
   launch plan against the library's, the N=12 B=64 case timed (eager,
   graph replay, device, plain, bound), the 19 chains of an equal-width
   forward at each (C, groups) summed from them; the wide kernel at C=512
   in 8 groups (uncounted) beside chain_tf32 / chain_sm90 on the same
   inputs, in turns, and those two against PERF.md's figures; the chain
   kernels' ptxas report; (b) the rows engine at full width on the dim-1024
   [1, 1, 1, 1] model (19 C=1024 chains a forward) at B=64: the b512
   recipe's network (bf16) by DDPM over CUT_STEPS (250) steps (exactly
   4,750 B4, all on chain_bf16_wide, no B1 or B2), held to the module
   every TASK_CHECK_EVERY calls, and through fused=True by DPM-Solver++-20 (560
   B1, 20 B2, no B4) beside it; the flagship's (f32) by DPM-Solver++-20
   (380 on chain_tf32_wide), held every WIDE_DPM_EVERY calls; each with a
   20-step profile (B4, or B1 and B2); the flagship networks in 4 and in
   16 groups and a dim-256 model in each dtype through fused="rows" by
   DPM-Solver++-20 (380 B4 on the wide kernel, none of B1 or B2, held every
   WIDE_DPM_EVERY calls, unprofiled); a dim 64 model in each dtype refused
   by fused="rows" naming fused=False with nothing launched.  The phase
   prints each sample's time and its own;
24. every sampler from a CUDA graph (the default of SceneDiffusion.sample
   on the card: one eager step, the step captured once and replayed),
   each held to the same sample with graph=False from one seed: bit-equal
   expected, within GRAPH_TOL with a line saying so, beyond it the phase
   fails; the f32 flagship through the 3-D engine by DDPM-1000 at B=64
   and at run/generate.sh's B=256 (exactly 28,000 B1 and 1,000 B2 in each
   run), DPM-Solver++-20 at B=256 (560, 20) and DDIM-50 at eta 0.5 at B=64
   (1,400, 50); the bf16 flagship through the rows engine by DDPM-1000 at
   B=64 (19,000 B4); completion and re-arrangement DDPM-1000 at B=32 and
   the text model through the rows engine by DDPM-1000 at B=64 (19,000 B4,
   9 contexts): in the whole run each of these three is the graphed twin of
   phase 16's and 17's gated sample (the gate draws no noise, so the gated
   loop is the eager loop), with ``--only-graph`` on random inputs beside
   an eager run of its own, and the f32 3-D and bf16 rows DDPM-1000 at
   B=64 are held to phases 15's and 4's samples, which run eagerly for it
   (not repeated); each case's wall times, the warm step's and the
   capture's seconds, peak memory, and the graphed and eager step against
   the step's device-busy time (the step replayed from a graph of 20): the
   idle share each leaves;
25. every train step from a CUDA graph (the default of Trainer and
   AETrainer on the card: a step's first call of a batch shape eagerly on
   a side stream, its second captured, replays after), each held to a
   graph=False twin from the same seed and state: the flagship at B=128
   f32 and the b512 recipe at B=512 bf16 through phases 12's and 13's
   calls (their eager runs are the twins: the given-t step, then each
   batch of the data pipeline); the flagship's calls again through
   train_step_scan in chunks of GRAPH_SCAN_K, and through a checkpoint
   written after GRAPH_RESUME_AT graphed steps and loaded into a new
   trainer; parameters, EMA, Adam moments and generator state after the
   last step bit-equal expected (GRAPH_TOL the gate, as in 24), every
   step's metrics equal; the shape AE at B=16 on phase 6's clouds, the
   graphed trainer loading phase 6's eager state before each of its first
   AE_GRAPH_STEPS steps (its backward's atomics part two trajectories;
   AE_GRAPH_TOL states the bounds of one step, and a second eager trainer
   from the same states is printed beside it), exactly 2 chamfer-kernel
   launches a step under replay; the room-mask flagship at B=128 and the
   flagship with grad_accum 2 against eager twins of their own over
   GRAPH_TRAIN_STEPS steps of random encoded scenes (random rectangles as
   masks); no prepared kernel operand made in any case.  Each case prints
   the graphed and eager ms/step, the warm step's and each capture's
   seconds and peak memory; the flagship, b512, AE and room-mask cases a
   profile of 5 graphed steps: busy time, and the idle share of the
   graphed and of the eager step.  (b) The eval steps from CUDA graphs
   (the default where the train step runs from one; the JAX package's
   jitted eval steps), each against a graph=False twin from the same seed
   and state, bit-equal expected (GRAPH_TOL the gate): the flagship at
   B=128 f32 on phase 12's batches, t and noise drawn inside the graph and
   given, a ragged last batch as a variant of its own, every step's
   metrics, the generator's state after, the parameters untouched; the
   shape AE at B=16 from phase 6's trained state (eval-mode BatchNorm, the
   posterior mean) on its clouds and a ragged batch, exactly 2
   chamfer-kernel launches an eval step under replay; each one's graphed
   and eager ms/step;
26. the synthetic eval protocol (cli/eval_protocol.py, the port's
   counterpart of tools/eval_protocol_r5.py) on the flagship config, f32,
   at a reduced scale (PROTOCOL_SCALE): 1300 synthetic rooms, the train
   CLI for 2 epochs (9 batches of 128 an epoch: a chunk of 8 replayed from
   the train_step_scan graph, then one step; the validation pass through
   the graphed eval step), generate --no_ema --clip_denoised --fused
   --render (--compute_intersec for the first) on 64 + 64 scenes by
   DDPM-1000 at B=64 (exactly 28,000 B1 and 1,000 B2 a stage), 128 GT
   renders, FID/KID and precision/recall with the InceptionV3 and VGG16
   refusals recorded and the pixel rows computed: every stage's outputs
   present, every metric finite; then the protocol again on the same
   directory, every stage skipped and the report's metrics equal.  The
   phase prints its own time.

The phases run in the order 1, 2, 7, 8, 3 with 9 (one set of full-width
models), 4, 10, 11, 15, 24, 22, 23, 5, 6, 12, 13, 14, 25, 21, 16, 17, 18,
19, 20, 26 (phase 24's task and text cases in 16 and 17).  The samples of the
other phases whose steps are not gated run from graphs too, with the same
launch counts, and so do the train steps of every phase but 6, 12 and 13
(and the distributed ones of 21, which run eagerly).
TF32 is off for every matmul and
convolution (the references are f32; the f32 B1 kernel's split TF32 is
three tf32 products per f32 product, not TF32 matmul).
Phase 1 prints each kernel's registers, stack and spills from ptxas, and
raises if a split-TF32 kernel (f32 B1, B4 or B2) or a bf16 wide kernel
(B1, B2 or B4) spills.

    python3 chip_smoke.py --only-resblock

runs phases 1 and 7 alone, the short check of a new B1 kernel (bf16 and
f32), ``--only-f32-engine`` phases 1, 3 + 9 in f32 and 15 (the main path in
its own dtype, both engines), and

    python3 chip_smoke.py --only-chain

phases 1 and 2 alone, the short check of a new chain kernel (bf16 and f32),
``--only-attention`` phases 1 and 8 (B2, bf16 and f32), ``--only-chamfer`` phases 1
and 5 (B3), ``--only-train`` phases 1 and 12-14 (with the train JSON
line), ``--only-tasks`` phases 1 and 16 (with the tasks JSON line) and
``--only-text`` phases 1 and 17 (with the text JSON line),
``--only-eval`` phases 1 and 18 (with the eval JSON line) and
``--only-data`` phases 1 and 19 (with the data JSON line) and
``--only-rest`` phases 1 and 20 (with the rest JSON line) and
``--only-parallel`` phases 1 and 21 (with the parallel JSON line) and
``--only-wide`` phases 1 and 22 (with the wide JSON line) and
``--only-wide-chain`` phases 1 and 23 (with the wide_chain JSON line) and
``--only-graph`` phases 1 and 24 (with the graph JSON line) and
``--only-train-graph`` phases 1, 6, 12, 13 (its eager twins) and 25 (with
the train_graph JSON line) and ``--only-protocol`` phases 1 and 26 (with
the protocol JSON line);
none of them prints an ok line.

The line before the last is the card's name and power limit again, the one
before it a JSON summary of the kernels, the one before that a JSON
summary of phase 26 ("protocol": each stage's seconds, the train stage's
steps, steps/s and graphed step, the launches, renders and metrics, the
second run's seconds), the one before that a JSON
summary of phase 25 ("train_graph": each case's agreement with its twin,
graphed and eager ms/step, warm and capture seconds, peak memory, busy
time and idle shares, the AE's launches, the eval steps' agreement,
launches and ms/step), the one before that a JSON
summary of phase 24 ("graph": each case's launches, bit-equality and
largest difference, wall times, warm and capture seconds, step times,
busy time, idle shares and peak memory), the one before that a JSON
summary of phase 23 ("wide_chain": each dtype's worst error, the 19
chains' times and bound at each (C, groups), the C=512 8-group chains on
both kernels, each rows and 3-D sample's wall time, launches (by kernel),
worst engine gap, busy time, idle share and kernel ms per step, the dim 64
refusals), the one before that a JSON
summary of phase 22 ("wide": each kernel case's error, the forwards' and
B2's times in each dtype, the C=512 8-group figures, each wide sample's
wall time, launches (also by kernel), worst engine gap, busy time, idle
share and kernel ms per step, the refusals, the generate CLIs' runs), the
one before that a JSON
summary of phase 21 ("parallel": the one-rank NCCL checks, each two-rank
path's agreement and launches a rank, the NCCL refusal, each b512 step's
ms/step and peak memory), the one before that a JSON
summary of phase 20 ("rest": each optimizer's run, the loaders' batches/s,
the async check, the traced generate, the Fourier samples, the dim_mults
check, the export round trips), the one before that a JSON summary of
phase 19 ("data": each pipeline CLI's seconds, the AE's
launches, the room-mask step's card-vs-CPU agreement, ms/step, busy time,
the extractor's share, peak memory, each sample's wall time, launches and
worst engine gap), the one before that a JSON summary of phase 18 ("eval": the card, each CLI run's wall time and
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
generate command's launches of phase 18 ("eval_launches"); every entry
carries its launches in phase 19 ("data_launches"), in phase 20
("rest_launches") and in phase 21 a rank ("parallel_launches"), and the
ResnetBlock and set-attention entries their phase 22 samples' launches
("wide_launches"), worst error and the wide flagship's 28 blocks' and
B2's (C=1024) times ("wide_ms", "wide_graph_ms", "wide_plain_ms",
"wide_bound_ms"), f32; the bf16 wide kernels, resblock_bf16_wide and
attention_bf16_wide, have entries of their own, their launches on the
bf16 wide flagship's DDPM over CUT_STEPS steps (by kernel) and their times in the wide
flagship's forward (the 11 C=1024 blocks, B2 at (64, 12, 1024)); so do
the wide chain kernels, chain_tf32_wide and chain_bf16_wide: their
launches on the dim-1024 model's rows samples (f32 DPM-Solver++-20, bf16
DDPM over CUT_STEPS steps) and on phase 23's other samples, their worst error, the times
and bound of the dim-1024 model's 19 chains (8 groups), the 19 chains'
graph-replay time at each (C, groups) of the set and the C=512 8-group
chains on both kernels; the chain, ResnetBlock and set-attention entries
carry phase 24's graphed samples' launches ("graph_launches"), the
chamfer entry phase 25's graphed AE steps' ("graph_launches") and graphed
AE eval steps' ("graph_eval_launches"), the ResnetBlock and set-attention
entries phase 26's generate stages' ("protocol_launches").  The
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
RB_CASES = {"row": ("row", C, 0, C, 8), "scene": ("scene", C, 0, C, 8),
            "skip": ("scene", C, C, C, 8), "cat": ("row", 2 * C, 0, C, 8),
            "zero": ("zero", C, 0, C, 8), "none": ("none", C, 0, C, 8)}
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
# the split-TF32 kernels and the bf16 wide kernels keep their A fragments
# in registers: ptxas must report no spills for them
NO_SPILL_KERNELS = ("resblock_tf32", "chain_tf32", "attention_tf32", "resblock_bf16_wide",
                    "attention_bf16_wide", "chain_bf16_wide")
# the 3-D engine's kernels as the profiler names them, by compute dtype
ENGINE_KERNELS = {"bfloat16": (("B1", "resblock_sm90"), ("B2", "attention_sm90")),
                  "float32": (("B1 f32", "resblock_tf32"), ("B2 f32", "attention_tf32"))}
# B2's cases beyond B=64, N=12: the bf16 kernel at the JAX bench's batch;
# the f32 kernel at run/generate.sh's and the JAX bench's (eps 1e-5, the
# f32 engine's)
ATTN_LARGE_CASES = (("bfloat16", 1e-3, ATTN_LARGE_B),
                    ("float32", 1e-5, GENERATE_B), ("float32", 1e-5, ATTN_LARGE_B))
SAMPLE_PROFILE_STEPS = 20
# phase 15's 1000-step f32 drift check: batch, the gated steps; the box
# bounds bench.py gives the flagship (bench.py:274-279: a bedroom's
# translations and half-sizes in metres), phase 21's IoU-loss bounds
DRIFT_B = 16
DRIFT_EVERY = 2    # the gated steps: every other one
DRIFT_BOUNDS = {"translations": ((-3.0, 0.0, -3.0), (3.0, 4.0, 3.0)),
                "sizes": ((0.04,) * 3, (2.0,) * 3)}
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
FLAGSHIP_STEPS, B512_STEPS, TRAIN_PROFILE_STEPS, CLI_EPOCHS, GEN_SCENES = 20, 20, 5, 3, 64
# stated tolerances, the flagship step (f32, TF32 off) on the card vs the CPU:
# the same f32 arithmetic summed in other orders through 28 ResnetBlocks and
# 9 attentions, forward and backward: the loss, each loss term and the
# gradient norm within 1e-4 relative, each parameter's gradient within 1e-3
# in relative L2
TRAIN_STEP_TOL = {"loss": 1e-4, "gradnorm": 1e-4, "grad_rel_l2": 1e-3}
# the card-vs-CPU train steps (phases 12, 16, 17, 19) take the first 32
# scenes of a batch of the config's size (128): the full-width CPU step is
# most of their time, cut for the script's time limit
CARD_CPU_B = 32
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
# the schedule of the two task CLIs' configs (completion_rearrange has no
# --dpm, as the JAX CLI has none): cut from the configs' 1000 for the
# script's time; the task samples of (a) and (b) keep DDPM-1000
TASK_CLI_STEPS = 100
# phase 17, text-conditioned generation on the bedroom text config (768-wide
# hashed token embeddings of eval scenes' textfix descriptions, through
# fc_text_f to 512): DDPM over CUT_STEPS steps through the 3-D engine at
# run/generate_text.sh's B=256 and DDPM-1000 through the rows engine at
# B=64 (phase 24's twin), each checked every TASK_CHECK_EVERY steps; the train step at the config's
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
# phase 19, the data pipeline and room-mask conditioning: a synthetic raw
# 3D-FRONT tree of DATA_ROOMS bedrooms (3-12 textured boxes each, rectangles
# and L shapes, one room out of range) through the port's CLIs in the
# README's order (the shape AE for DATA_AE_EPOCHS epochs), then the
# flagship at full width as a room-mask model (latent_dim and context_dim
# 64, a ResNet18 of 64 features over 64x64 masks): the train CLI for
# DATA_TRAIN_EPOCHS steps at the flagship's B=128 (the train + val rooms,
# 144, make one batch an epoch: the loader drops the rest), its step card
# vs CPU, then DPM-Solver++-20 through generate --fused at B=256 and
# DDPM over CUT_STEPS steps through both engines at B=64.  160 rooms, not
# fewer, so that a batch of 128 exists.
DATA_RAW, DATA_OUT, DATA_ROOMS = "build/smoke_data_raw", "build/smoke_data", 160
DATA_AE_EPOCHS, DATA_TRAIN_EPOCHS, DATA_ROWS_B, DATA_INVERT_B = 2, 10, 64, 64
DATA_CACHE = os.path.join(DATA_OUT, "cached")
# the 64x64 masks of the first 12 rooms (the same rooms at any DATA_ROOMS)
# through CachedThreedFront, each summed in levels (x 255): what the CPU
# tests get (tests/test_torch_raw_pipeline.py), with Pillow installed or
# blocked.  Another host's f32 rounding in a resize pass may flip a level
# where a value straddles a half, so each room may differ by
# DATA_MASK_LEVEL_TOL
DATA_MASK_LEVELS = (374659, 529344, 376416, 317399, 626734, 711472, 437512, 500983, 301722,
                    595264, 616244, 401681)
DATA_MASK_LEVEL_TOL = 2
# the room-mask extractor's features of the 256 masks, card vs CPU, f32 with
# TF32 off: relative L2 of the feature matrix (cuDNN's and oneDNN's
# convolutions sum in other orders, 17 deep)
DATA_FEATURE_TOL = 1e-5
# the extractor's parameter gradients, each against the CPU's in f64
# (relative L2): the card's in f64 within DATA_EXTRACTOR_F64_TOL (the same
# function); the card's f32 within DATA_EXTRACTOR_GRAD_TOL.  ReLU's
# subgradient at pre-activations that are rounding noise around 0 (the
# rotated masks' spline ringing over the empty floor) follows the
# summation order, so an f32 run in another order than the CPU's (whose
# f32 tracks its f64 to 1e-6) moves the gradients of the parameters below
# such ReLUs by about 1e-3 (11 to 30e-4 on an H100 in this phase)
DATA_EXTRACTOR_F64_TOL, DATA_EXTRACTOR_GRAD_TOL = 1e-10, 1e-2
# phase 20, the single-card modules ported last: the flagship at full width
# trained through cli/train_diffusion.py --native_loader on REST_SCENES
# synthetic rooms (576 in train + val: 4 batches of 128 an epoch) with each
# optimizer and schedule no shipped config selects: RAdam + warmup_cosine
# for 3 epochs (12 steps) with --async_checkpoints and a --profile_dir
# window of REST_PROFILE_STEPS steps, SGD + lambda for one epoch (AdamW +
# step trained one epoch here too until it was cut for the script's time;
# it takes the async-save trainer's steps); generate --fused --dpm at
# B=256 from its checkpoint with a trace; the flagship with a learned
# Fourier time embedding sampled by
# DDPM over a REST_FOURIER_STEPS-step schedule at B=64 through both
# engines; a dim_mults (1, 2) model of dim 64 through the module forward;
# the weights' export to the reference layout and back
REST_DATA, REST_OUT, REST_SCENES = "build/smoke_rest_data", "build/smoke_rest", 640
REST_OPTIMIZERS = (
    ("radam", {"optimizer": "RAdam", "schedule": "warmup_cosine", "warmup_epochs": 1,
               "min_lr": 1e-6}, 3),
    ("sgd", {"optimizer": "SGD", "momentum": 0.9, "schedule": "lambda", "start_epoch": 1,
             "lr_decay": 0.9}, 1),
)
REST_ASYNC_TRAINING = {"optimizer": "Adam", "weight_decay": 0.01}
REST_PROFILE_STEPS, REST_LOADER_EPOCHS = 3, 2
REST_FOURIER_STEPS, REST_FOURIER_B = 250, 64
REST_MULTS_DIM, REST_MULTS_STEPS, REST_MULTS_B = 64, 50, 16
# phase 21, the communication layer (parallel/*) and mixed precision, on
# random encoded bedroom batches made from the seed: the flagship's train
# step at its B=128 (f32) and DPM-Solver++-20 samples of PAR_SAMPLE_B scenes
# through both engines; the shape AE's step at its B=16; the b512 recipe's
# bf16 step at B=512 with and without mixed_precision, PAR_MP_STEPS timed
# steps each.  Bounds of the IoU loss: bench.py's bedroom box bounds
# (DRIFT_BOUNDS).
PAR_SAMPLE_B, PAR_MP_STEPS, PAR_TIMEOUT = 64, 10, 300
# the train CLI with --mixed_precision under torchrun: the flagship config
# on 160 synthetic rooms (one batch of 128 an epoch)
PAR_CLI_SCENES, PAR_CLI_EPOCHS = 160, 1
PAR_DIR = "build/smoke_parallel"
# stated tolerances.  One NCCL rank: all-reduce over one rank is the
# identity, so the data-parallel step and the sharded sample equal the
# non-distributed ones bit for bit.  Two ranks (each its half of the batch,
# f32, TF32 off): the loss is a mean of two halves and the matmuls run at
# another M, so the loss, its terms and the gradient norm within 1e-5
# relative; after one Adam step every parameter within 2.05 lr of the
# one-rank step, all but 1e-3 of them within 1e-2 lr (an entry whose
# gradient is rounding noise may step the other way).  Tensor parallelism
# sees the whole batch on each rank with the gathered kernels: the same
# bounds.  The gathered samples within FORWARD_TOL of the one-rank sample
# with every argmax class equal.  The AE step: two ranks of 8 clouds sum
# each BatchNorm's moments and the gradients in another order than one rank
# of 16, and f32 rounding of a reordered sum moves its loss and gradient
# norm by as much as the one-rank step on the same clouds in reverse order
# does (that witness is printed beside it): the loss within 1e-4 and the
# gradient norm within 5e-4 relative, bounds that the fault of each rank's
# own moments must exceed (it runs too).  mixed_precision vs the plain bf16
# step from one state (the CPU tests' bounds,
# tests/test_torch_mixed_precision.py): the loss within 2e-2 relative,
# every parameter within 2.05 lr, under 2% of them more than 0.5 lr apart,
# and neither equal (a step without the bf16 cast would equal the plain one).
PAR_STEP_TOL = {"loss": 1e-5, "max_lr": 2.05, "loose_lr": 1e-2, "loose_share": 1e-3}
PAR_AE_TOL = {"loss": 1e-4, "gradnorm": 5e-4}
PAR_MP_TOL = {"loss": 2e-2, "max_lr": 2.05, "loose_lr": 0.5, "loose_share": 0.02}
# phase 22, the B1 and B2 kernels at the widths and GroupNorm groupings
# the JAX engine serves, one set for both dtypes: B1 at every (C, groups)
# of the set and B2 at every C of it against their plain versions, in f32
# and bf16; the flagship with dim_mults [1, 1, 2, 2] (the wide flagship: 17
# blocks at C=512 on the cluster-of-8 kernel, 11 at C=1024 and mid_attn on
# the wide kernels) through fused=True at B=64 by DPM-Solver++-20 in bf16
# (the b512 recipe's network) and f32 (the flagship config); both in 4 and
# in 16 groups (every block on the wide kernel), DPM-Solver++-20 at B=64,
# each held every WIDE_DPM_EVERY calls; the 16-group models through the
# rows engine (B4's wide kernel), and a model outside the set (dim 64) in
# each dtype;
# generate_diffusion --fused --dpm on the wide configs; the C=512 8-group
# figures beside PERF.md's
WIDE_B1_SET = tuple((c, g) for c in (256, 512, 1024) for g in (4, 8, 16, 32) if c // g >= 16)
WIDE_B2_C = (256, 512, 1024)
WIDE_MULTS = (1, 1, 2, 2)
WIDE_GROUPINGS = (4, 16)
WIDE_DPM_EVERY = 5
WIDE_DATA, WIDE_OUT, WIDE_SCENES = "build/smoke_wide_data", "build/smoke_wide", 640
# each dtype's network config: the flagship's (f32) and the b512 recipe's
WIDE_CONFIG = {"float32": FLAGSHIP_CONFIG, "bfloat16": B512_CONFIG}
# the wide flagship's step profile, by dtype: B1 split by kernel (its C=512
# and C=1024 blocks), and B2
WIDE_KERNELS = {"float32": (("B1 C=512 (resblock_tf32)", "resblock_tf32<"),
                            ("B1 C=1024 (resblock_tf32_wide)", "resblock_tf32_wide"),
                            ("B2 C=1024 (attention_tf32_wide)", "attention_tf32_wide")),
                "bfloat16": (("B1 C=512 (resblock_sm90)", "resblock_sm90"),
                             ("B1 C=1024 (resblock_bf16_wide)", "resblock_bf16_wide"),
                             ("B2 C=1024 (attention_bf16_wide)", "attention_bf16_wide"))}
# the 4- and 16-group models' step profile, by dtype: every B1 on the wide
# kernel, B2 on the C=512 kernel
WIDE_GROUP_KERNELS = {"float32": (("B1 (resblock_tf32_wide)", "resblock_tf32_wide"),
                                  ("B2 (attention_tf32)", "attention_tf32")),
                      "bfloat16": (("B1 (resblock_bf16_wide)", "resblock_bf16_wide"),
                                   ("B2 (attention_sm90)", "attention_sm90"))}
# PERF.md section 6's figures of the C=512, 8-group kernels at B=64, N=12,
# graph replay (NVIDIA H100 80GB HBM3, 700.00 W): the flagship's 28 blocks,
# B2; f32 PR 18, bf16 PR 5-7
WIDE_EARLIER_MS = {"float32": {"b1_28": 0.855, "b2": 0.0228},
                   "bfloat16": {"b1_28": 0.365, "b2": 0.0120}}
# phase 23, the chain kernel (B4) widened to B1's set in both dtypes: every
# chain variant at WIDE_CHAIN_SET's widths and groupings (C=512 in 8 groups
# stays on chain_tf32 / chain_sm90, timed beside the wide kernel) against
# the plain version; the rows engine at full width on the widest
# equal-width model of the set, dim WIDE_CHAIN_DIM with dim_mults [1, 1, 1,
# 1] (19 C=1024 chains a forward): the b512 recipe's network (bf16)
# DDPM-1000 at B=64, held every TASK_CHECK_EVERY calls, the flagship's (f32)
# DPM-Solver++-20, both also through fused=True; the flagship networks in
# 4 and 16 groups (dim 512) and a dim-WIDE_CHAIN_SMALL_DIM model through
# fused="rows", DPM-Solver++-20, held every WIDE_DPM_EVERY calls; a dim-64
# model refused
WIDE_CHAIN_SET = ((256, 8), (256, 16), (512, 4), (512, 16), (512, 32), (1024, 4), (1024, 8),
                  (1024, 16))
WIDE_CHAIN_VARIANTS = ("none", "scene_res", "row_scene", "scene", "row_skip", "skip")
WIDE_CHAIN_DIM, WIDE_CHAIN_SMALL_DIM = 1024, 256
# the wide chain kernel as the profiler names it, by compute dtype
WIDE_CHAIN_KERNELS = {"float32": (("B4 (chain_tf32_wide)", "chain_tf32_wide"),),
                      "bfloat16": (("B4 (chain_bf16_wide)", "chain_bf16_wide"),)}
# the dim-1024 model through fused=True: every B1 and B2 on the wide kernels
WIDE_CHAIN_3D_KERNELS = {"float32": (("B1 (resblock_tf32_wide)", "resblock_tf32_wide"),
                                     ("B2 (attention_tf32_wide)", "attention_tf32_wide")),
                         "bfloat16": (("B1 (resblock_bf16_wide)", "resblock_bf16_wide"),
                                      ("B2 (attention_bf16_wide)", "attention_bf16_wide"))}
# PERF.md section 6's figures of the C=512 8-group chain kernels at B=64,
# N=12, graph replay, the 19 chains of a forward (NVIDIA H100 80GB HBM3,
# 700.00 W; its B4 row): f32 chain_tf32, bf16 chain_sm90
WIDE_CHAIN_EARLIER_MS = {"float32": 0.843, "bfloat16": 0.460}
# phase 24, the samplers from CUDA graphs: a graphed sample is expected to
# equal its eager twin bit for bit; a library kernel that chose another
# algorithm under capture may move it by these, the f32 figure the f32
# rounding of a step, bf16 the engines' FORWARD_TOL; DDIM at eta 0.5 draws
# noise every step
GRAPH_TOL = {"float32": 1e-6, "bfloat16": FORWARD_TOL["bfloat16"]}
GRAPH_DDIM_STEPS, GRAPH_DDIM_ETA = 50, 0.5
# phase 25, the train steps from CUDA graphs, each held to a graph=False twin
# from the same seed and state (the phase's docstring above): the scene
# steps run the same kernels on the same inputs, so GRAPH_TOL gates them
# (bit-equal expected); GRAPH_SCAN_K steps a train_step_scan call, the
# checkpoint after GRAPH_RESUME_AT steps, GRAPH_TRAIN_STEPS steps of the
# room-mask and grad_accum twins, AE_GRAPH_STEPS lockstep AE steps.  The
# AE's backward sums with index_add_ atomics in a varying order, so one
# step from one state differs between two runs, eager or graphed: the
# forward's values (the loss terms, the BatchNorm running moments) within
# 1e-6 relative (bit-equal expected: the forward has no atomics), the
# gradient norm and each Adam moment (mu, nu: the whole buffer) within 1e-5
# relative (L2), every parameter within 2.05 lr and all but 5e-3 of them
# within 1e-2 lr (an element whose gradient is rounding noise moves by up to
# lr either way, as PAR_STEP_TOL says of one Adam step; the AE's first steps
# have more such elements than the flagship's)
GRAPH_SCAN_K, GRAPH_RESUME_AT, GRAPH_TRAIN_STEPS, AE_GRAPH_STEPS = 4, 5, 10, 10
AE_GRAPH_TOL = {"loss": 1e-6, "buffers": 1e-6, "gradnorm": 1e-5, "moments": 1e-5,
                "max_lr": 2.05, "loose_lr": 1e-2, "loose_share": 5e-3}
TRAIN_GRAPH_OUT = "build/smoke_train_graph"
# the seed of checked_sample's generator, which the full run's phase 24
# task and text cases share to hold their graphs to the gated samples
CHECKED_SEED = SEED + 6
# the seeds of phase 4's and 15's samples (phase 24's eager twins there)
ROWS_SAMPLE_SEED, ENGINE_SAMPLE_SEED = SEED + 2, SEED + 3
# phase 25 (b), the eval steps from CUDA graphs: the ragged last batch's
# scenes (of the flagship's 128) and clouds (of the AE's 16), and the steps
# timed after the checked ones
GRAPH_EVAL_RAGGED_B, GRAPH_EVAL_RAGGED_AE, GRAPH_EVAL_TIMED = 100, 8, 10
# the gated eager samples that no graph is held to (phases 17 (a), 19 (c)
# and the bf16 samples of 22 (b) and 23 (b)) sample DDPM over a
# CUT_STEPS-step schedule of the same weights, cut from the configs' 1000
# to make room for phases 25 (b) and 26: 28 B1 and 1 B2, or 19 B4, a step,
# exactly, and the engine held to the module every TASK_CHECK_EVERY calls
CUT_STEPS = 250
# phase 26, the synthetic eval protocol (cli/eval_protocol.py) on the
# flagship config at a reduced scale: 1300 rooms (1170 in train + val: 9
# batches of 128 an epoch, so that each epoch replays one chunk of 8 from
# the train_step_scan graph and one single step), 2 epochs, 64 + 64 scenes
# by DDPM-1000 at B=64, 128 GT renders, the pixel FID/KID and IPR rows
PROTOCOL_OUT = "build/smoke_protocol"
PROTOCOL_GEN_B, PROTOCOL_BATCHES = 64, 9
PROTOCOL_SCALE = ("--rooms", "1300", "--epochs", "2", "--n_sequences", "64", "--n_extra", "64",
                  "--batch_size", str(PROTOCOL_GEN_B), "--ipr_samples", "128")
# the short checks: phase 1 and one kernel's phase, no ok line
ONLY = ("--only-resblock", "--only-chain", "--only-attention", "--only-chamfer", "--only-train",
        "--only-f32-engine", "--only-tasks", "--only-text", "--only-eval", "--only-data",
        "--only-rest", "--only-parallel", "--only-wide", "--only-wide-chain", "--only-graph",
        "--only-train-graph", "--only-protocol")


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# device_ms's sessions so far: taken, and those that left launches
# unrecorded (with the fewest recorded of the most expected)
PROFILER_TALLY = {"sessions": 0, "short": 0, "fewest": None}


def device_ms(torch, fn, match, iters=20, launches=1, tries=3):
    """Mean device time per call of ``fn`` of the kernels whose name holds
    ``match`` (torch.profiler over ``iters`` calls after a warm-up); NaN if
    the profiler saw none (not measured).  Late in a long process the
    profiler leaves some of a session's kernel launches unrecorded (on an
    H100 after phase 15, some sessions recorded none or a few of 20 B1
    launches, others all 20, each recorded one of the right length), so
    with ``launches`` (the matching kernels one call launches) a session that
    recorded fewer than launches x iters is counted in PROFILER_TALLY and
    taken again, up to ``tries`` sessions; if none recorded them all, the
    mean of the recorded launches times ``launches`` is returned, with a
    line saying so.  ``launches=None`` (calls of many kernels) sums what
    one session recorded."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries if launches else 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        mine = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and match in e.key]
        us, seen = sum(e.self_device_time_total for e in mine), sum(e.count for e in mine)
        PROFILER_TALLY["sessions"] += 1
        if not launches or seen == launches * iters:
            return us / iters / 1e3 if us else float("nan")
        PROFILER_TALLY["short"] += 1
        fewest = PROFILER_TALLY["fewest"]
        if fewest is None or seen / (launches * iters) < fewest[0] / fewest[1]:
            PROFILER_TALLY["fewest"] = (seen, launches * iters)
    if not seen:
        return float("nan")
    print(f"device_ms: the profiler recorded {seen} of the {launches * iters} launches of "
          f"{match!r} in each of {tries} sessions; the last session's mean a launch x "
          f"{launches}", flush=True)
    return us / seen * launches / 1e3


def profiler_tally(label):
    """Print PROFILER_TALLY after ``label``."""
    t = PROFILER_TALLY
    worst = "" if t["fewest"] is None else (f"; the fewest recorded {t['fewest'][0]} of "
                                           f"{t['fewest'][1]}")
    print(f"profiler: {t['sessions']} device_ms sessions by the end of {label}, {t['short']} of "
          f"them with launches unrecorded and taken again{worst}", flush=True)


def graph_ms(torch, fn, iters=20, replays=5):
    """Mean time per call of ``fn`` replayed from a CUDA graph of ``iters``
    calls: the kernels back to back on the card, without the host's cost of
    each call (CUDA events around ``replays`` replays after a warm one).
    The kernel counters count what the card runs: the capture's launches
    once a replay (build.launch_tally)."""
    from diffuscene_tpu_torch.ops import build

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with build.launch_tally() as tally:
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
    build.add_tally(tally, 1 + replays)
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


def chain_case(fl, torch, variant, n, dtype, seed, batch=B, C=C):
    """Random chain inputs on the card, C channels: standardized-scale W1/W2
    (unit variance per output column, as after weight standardization)."""
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
    flops = 2 * x.shape[0] * x.shape[1] ** 2 * chain.W.shape[0]
    nbytes = (chain.W.numel() * chain.W.element_size() + chain.V.numel() * 4
              + 2 * x.numel() * x.element_size()
              + sum(t.numel() * t.element_size() for t in films + skips if t is not None))
    return flops, nbytes


def chain_check(fl, torch, variant, n, dtype, seed, batch=B, timed=True, width=C, groups=8):
    """One chain case (``width`` channels in ``groups`` groups): kernel vs
    plain version; with ``timed``, the eager (CUDA events), graph-replay,
    profiler-device and plain times.  Returns (ok, error, times or None,
    work)."""
    dname = str(dtype).split(".")[-1]
    chain, x, films, skips = chain_case(fl, torch, variant, n, dtype, seed, batch=batch, C=width)
    got = fl.apply_chain(chain, x, films, skips, n_per_scene=n, groups=groups)
    want = fl.apply_chain_reference(chain, x, films, skips, n_per_scene=n, groups=groups)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ok = (bool(torch.isfinite(got.float()).all())
          and torch.allclose(got.float(), want.float(), **KERNEL_TOL[dname]))
    times = None
    if timed:
        def call():
            return fl.apply_chain(chain, x, films, skips, n_per_scene=n, groups=groups)

        times = dict(ms=cuda_ms(call), graph=graph_ms(torch, call),
                     dev=device_ms(torch, call, "chain"),
                     plain=cuda_ms(lambda: fl.apply_chain_reference(chain, x, films, skips,
                                                                    n_per_scene=n, groups=groups),
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
                    blocks = chain_blocks(fl, variant)
                    p = fl.tile_plan(batch, n, blocks, lib, dtype)
                    skip = any(b.has_skip for b in blocks)
                    lib_smem = lib.fused_chain_smem_bytes(code, int(skip), C, 8)
                    print(f"plan fused_chain {dname} N={n} B={batch} {variant}: "
                          f"{p.scenes_per_tile} scenes a tile, {p.clusters} clusters of 8 = "
                          f"{p.ctas} CTAs, {p.stages} stages, {p.smem_bytes} bytes of shared "
                          f"memory a CTA (library {lib_smem}; "
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


def rb_case(torch, case, n, dtype, seed, batch=B):
    """Random B1 inputs on the card for ``case`` = (film, C_x, C_skip, C,
    groups) (a residual projection where C_x + C_skip != C), as the
    flagship's prepared weights are scaled: standardized W1/W2 (unit
    variance per output column)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=1.0, base=0.0):
        return base + scale * torch.randn(*shape, generator=g, device=dev)

    film, kx, ks, c, groups = case
    c_in, M = kx + ks, batch * n
    kw = dict(w1=rnd(c_in, c, scale=0.7 if c_in > c else 1.0), b1=rnd(c, scale=0.1),
              gn1_scale=rnd(c, scale=0.1, base=1.0), gn1_bias=rnd(c, scale=0.1),
              w2=rnd(c, c), b2=rnd(c, scale=0.1),
              gn2_scale=rnd(c, scale=0.1, base=1.0), gn2_bias=rnd(c, scale=0.1))
    if c_in != c:
        kw.update(w_res=rnd(c_in, c, scale=c_in ** -0.5), b_res=rnd(c, scale=0.1))
    kw = {k: (v.to(dtype) if k in ("w1", "w2", "w_res") else v) for k, v in kw.items()}
    x = rnd(M, c_in).to(dtype)
    skip = None
    if ks:
        x, skip = x[:, :kx].contiguous(), x[:, kx:].contiguous()
    f = {"row": lambda: rnd(M, 2 * c, scale=0.2).to(dtype),
         "scene": lambda: rnd(batch, 2 * c, scale=0.2).to(dtype),
         "zero": lambda: torch.zeros(M, 2 * c, dtype=dtype, device=dev),
         "none": lambda: None}[film]()
    return (x, f), dict(kw, skip=skip, n_per_scene=n, groups=groups, compute_dtype=dtype)


def rb_work(args, kw):
    """The least work of one B1 call: every product, each operand read once
    and the output written once.  Returns (flops, bytes)."""
    x, f = args
    M = x.shape[0]
    c_in, c = kw["w1"].shape
    k_total = c_in + c + (c_in if kw.get("w_res") is not None else 0)
    flops = 2 * M * c * k_total
    tensors = [x, f, kw["skip"], kw["w1"], kw["w2"], kw.get("w_res")]
    nbytes = sum(t.numel() * t.element_size() for t in tensors if t is not None)
    nbytes += 7 * c * 4 + M * c * x.element_size()
    return flops, nbytes


def rb_check(rb, torch, case, n, dtype, seed, batch=B, timed=True):
    """One B1 case (rb_case): kernel vs plain version (no film must also
    equal zero film rows exactly); with ``timed``, the eager (CUDA events),
    graph-replay, profiler-device and plain times.  Returns (ok, error,
    times or None, (flops, bytes))."""
    dname = str(dtype).split(".")[-1]
    args, kw = rb_case(torch, case, n, dtype, seed, batch=batch)
    got = rb.fused_resnet_block(*args, **kw)
    want = rb.fused_resnet_block_reference(*args, **kw)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ok = (bool(torch.isfinite(got.float()).all())
          and torch.allclose(got.float(), want.float(), **KERNEL_TOL[dname]))
    if case[0] == "none":   # no film is zero film rows, exactly
        zero = torch.zeros(args[0].shape[0], 2 * case[3], dtype=dtype, device="cuda")
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
                ok, err, tm, (flops, nbytes) = rb_check(rb, torch, RB_CASES[name], n, dtype, seed)
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
        ok, err, _, _ = rb_check(rb, torch, RB_CASES["skip"], 12, dtype, 7, batch=63,
                                timed=False)
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
                ok, err, tm, (flops, nbytes) = rb_check(rb, torch, RB_CASES[name], 12, dtype,
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
                fit = lib.fused_resblock_max_active_clusters(code, C, 8, kx, ks, int(ks > 0))
                print(f"plan fused_resblock {dname} N={n} B={B} C_in={kx}+{ks}: "
                      f"{p.scenes_per_tile} scenes a tile, {p.clusters} clusters of 8 = {p.ctas} "
                      f"CTAs, {p.stages} stages, {p.smem_bytes} bytes of shared memory a CTA "
                      f"(library {lib.fused_resblock_smem_bytes(code, C, 8, kx, ks, int(ks > 0))}), "
                      f"{fit} clusters fit at once", flush=True)
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
        resident = lib.set_attention_max_active_clusters(code, C)
        if resident <= 0:
            raise RuntimeError(f"set_attention_max_active_clusters({dname}) failed ({resident})")
        for n in (12, 21, 24):
            for batch in batches:
                p = at.tile_plan(batch, n, resident, dtype)
                print(f"plan set_attention {dname} N={n} B={batch}: {p.scenes_per_tile} scenes a "
                      f"tile, {p.tiles} tiles, {p.clusters} clusters of {at.HEADS} = {p.ctas} CTAs "
                      f"({resident} clusters fit at once; {p.tiles / min(p.clusters, resident):.2f} "
                      f"tiles a resident cluster), {p.smem_bytes} bytes of shared memory a CTA "
                      f"(library {lib.set_attention_smem_bytes(code, C)}), 288 threads a CTA (two "
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
    # the kernels take 4 heads of 32, N <= 24 and C in (256, 512, 1024)
    # only, in either dtype: anything else raises
    for dtype in (torch.bfloat16, torch.float32):
        for c, heads, dim_head, n in ((384, 4, 32, 12), (512, 8, 16, 12), (512, 4, 32, 25)):
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


def sampling_step(torch, scene, batch, gen, fused=True, **cond):
    """One DDPM step of the ``fused`` engine (True: the 3-D engine, "rows":
    the rows engine) at the schedule's last t on fresh inputs (the step a
    sample runs as many times as the schedule has steps), as a callable; a text model's step with the
    contexts of ``text_emb``, a room-mask model's with the features of
    ``room_layout`` (``cond``)."""
    from diffuscene_tpu_torch.diffusion import p_sample_step

    cfg = scene.cfg
    denoise = scene._denoise_fn(*scene.make_condition(batch, **cond), fused=fused)
    x_t = torch.randn(batch, 12, 62, generator=gen, device=DEV)
    noise = torch.randn(batch, 12, 62, generator=gen, device=DEV)
    t_last = torch.full((batch,), scene.sched.num_timesteps - 1, dtype=torch.long, device=DEV)
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


def phase_rows_sample(torch, scene, card, dpm=False, graph=None, record=None):
    """Phase 4 (bf16) or the rows part of 15 (f32): a 1000-step DDPM sample
    (with ``dpm``, a DPM-Solver++-20 sample) of 64 scenes through
    SceneDiffusion.sample(fused="rows", graph=graph), every chain on B4:
    shape, finiteness, exactly 19 chain launches a step; then a 20-step
    profile against the sample's step time, naming B4's kernel.  Returns
    the chain launches; ``record`` (a dict) gets the sample, its wall time
    and peak memory (phase 24's eager twin in the whole run)."""
    from diffuscene_tpu_torch.ops import fused_level as fl

    dname = str(scene.denoiser.compute_dtype).split(".")[-1]
    gen = torch.Generator(device="cuda").manual_seed(ROWS_SAMPLE_SEED)
    steps, name = (DPM_STEPS, "DPM-Solver++") if dpm else (T, "DDPM")
    kw = dict(dpm=True, dpm_steps=DPM_STEPS) if dpm else {}
    torch.cuda.synchronize()
    fl.apply_chain.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = scene.sample(B, generator=gen, clip_denoised=True, fused="rows", graph=graph, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if record is not None:
        record.update(out=out, wall_s=wall, peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    launches = fl.apply_chain.launches
    finite = bool(torch.isfinite(out).all())
    print(f"sample: {steps}-step {name}, B={B}, {dname}, fused=rows: shape={tuple(out.shape)} "
          f"finite={finite} chain_calls={launches} wall_s={wall:.3f} "
          f"scenes_per_s={B / wall:.3f} | {card}", flush=True)
    if tuple(out.shape) != (B, 12, 62) or not finite:
        raise RuntimeError(f"the {dname} rows sample is malformed")
    if launches != 19 * steps:
        raise RuntimeError(f"expected {19 * steps} chain-kernel calls in the {dname} rows sample, "
                           f"counted {launches}")
    parts = scene.split_samples(out)
    print(f"sample: empty-slot share {parts['is_empty'].float().mean().item():.3f}", flush=True)
    # where one sampling step's time goes (the step the sample above ran T times)
    print(f"profile: {dname} rows step, B={B}", flush=True)
    profile_steps(torch, sampling_step(torch, scene, B, gen, fused="rows"), SAMPLE_PROFILE_STEPS,
                  1e3 * wall / steps, named=ROWS_KERNELS[dname])
    return launches


def phase_engine_samples(torch, scene, card, dpm_batch=B, profile_batches=(), ddpm=True,
                         graph=None, record=None):
    """Phases 10 and 11 (bf16) or 15 (f32): DDPM-1000 at B=64 (with
    ``ddpm``) and DPM-Solver++-20 at ``dpm_batch`` through the 3-D engine,
    every ResnetBlock on B1 and mid_attn on B2, with exact launch counts; a
    20-step profile at B=64 against the DDPM sample's step time (without
    ``ddpm``, against that step's host time), and one at each batch of
    ``profile_batches`` against that step's host time.  The samples run
    SceneDiffusion.sample(graph=graph).  Returns the launch counts of the
    DDPM-1000 sample, or without ``ddpm`` of the DPM-Solver++-20 one;
    ``record`` (a dict) gets the DDPM-1000 sample, its wall time and peak
    memory (phase 24's eager twin in the whole run)."""
    from diffuscene_tpu_torch.ops import attention as at
    from diffuscene_tpu_torch.ops import fused_resblock as rb

    dname = str(scene.denoiser.compute_dtype).split(".")[-1]
    named = ENGINE_KERNELS[dname]
    counts = {}
    samplers = (("DDPM", B, {}, T),) if ddpm else ()
    for name, batch, kw, steps in samplers + (
            ("DPM-Solver++", dpm_batch, dict(dpm=True, dpm_steps=DPM_STEPS), DPM_STEPS),):
        gen = torch.Generator(device="cuda").manual_seed(ENGINE_SAMPLE_SEED)
        torch.cuda.synchronize()
        rb.fused_resnet_block.launches = at.fused_set_attention.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = scene.sample(batch, generator=gen, clip_denoised=True, fused=True, graph=graph,
                           **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if record is not None and name == "DDPM":
            record.update(out=out, wall_s=wall, peak_gb=torch.cuda.max_memory_allocated() / 1e9)
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
    for batch in profile_batches if ddpm else (B,) + tuple(profile_batches):
        step = sampling_step(torch, scene, batch, torch.Generator(device="cuda").manual_seed(SEED + 4))
        step_ms = host_ms(torch, step, SAMPLE_PROFILE_STEPS)
        print(f"profile: {dname} 3-D step, B={batch} (host clock {step_ms:.3f} ms/step "
              f"unprofiled)", flush=True)
        profile_steps(torch, step, SAMPLE_PROFILE_STEPS, step_ms, named=named)
    return counts["DDPM" if ddpm else "DPM-Solver++"]


def phase_drift(torch, scene):
    """The end of phase 15: DDPM-1000 of the flagship in f32 at B=16 from
    one seeded generator.  The gate: along the fused=True trajectory, at
    every DRIFT_EVERY-th of the T steps (every step until the script's
    time limit called for the cut), x_t goes through the 3-D engine (B1
    and B2 f32), the rows engine (B4 f32) and the module; each engine's
    output must be within FORWARD_TOL f32 of the module's (the maxima stay
    on the card and are read once; a breach names the step).  The gated
    engine calls take the module's exact GELU, as phase 9's do (the
    sampler's engines default to the tanh form, about 1e-3 of its own).
    The free runs of the engines and the module beside it (the drift
    measurement, not gated) are left out for the script's time.  The gate
    is host code a step, so the loop runs eagerly (graph=False)."""
    from diffuscene_tpu_torch.diffusion import p_sample_loop
    from diffuscene_tpu_torch.models import inference as inf
    from diffuscene_tpu_torch.utils.convert import denoiser_tree

    cfg, tol, net = scene.cfg, FORWARD_TOL["float32"], scene.denoiser
    cond, _ = scene.make_condition(DRIFT_B)
    paths = {name: scene._denoise_fn(cond, fused=f)
             for name, f in (("3-D", True), ("module", False))}
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
        if step % DRIFT_EVERY == 0:
            want = paths["module"](x, t)
            for k, engine in enumerate(exact):
                errs[step, k] = (engine(x, t) - want).abs().max()
        step += 1
        return paths["3-D"](x, t)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    t0 = time.perf_counter()
    out = p_sample_loop(scene.sched, cfg.model_mean_type, cfg.model_var_type, gated,
                        (DRIFT_B, cfg.sample_num_points, cfg.point_dim), generator=gen,
                        clip_denoised=True, graph=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not bool(torch.isfinite(out).all()) or tuple(out.shape) != (DRIFT_B, 12, 62):
        raise RuntimeError("the gated f32 sample is malformed")
    worst = errs.cpu()
    for k, name in enumerate(("3-D", "rows")):
        bad = (~(worst[:, k] <= tol)).nonzero()
        print(f"drift: f32 DDPM-{T} B={DRIFT_B}, {name} engine vs module along the fused=True "
              f"trajectory: worst max_abs_err {worst[:, k].max().item():.3e} at t="
              f"{T - 1 - int(worst[:, k].argmax())}, tol={tol} at every {DRIFT_EVERY}nd step "
              f"{'ok' if not len(bad) else 'FAIL'} ({wall:.1f} s, 4 forwards a checked step)",
              flush=True)
        if len(bad):
            i = int(bad[0])
            raise RuntimeError(f"the f32 {name} engine is {worst[i, k].item():.3e} from the module "
                               f"at step {i} (t={T - 1 - i}) of the fused=True trajectory")


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
    out["device_ms"] = device_ms(torch, kernel, "chamfer_nn_sm90", launches=2)
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


def ae_trainer(torch, graph=None):
    """The shape AE's trainer at full width on the card, weights from the
    seed, and its config."""
    from diffuscene_tpu_torch.models.autoencoder import build_autoencoder
    from diffuscene_tpu_torch.train.ae_trainer import AETrainer
    from diffuscene_tpu_torch.utils.config import load_config

    cfg = load_config(AE_CONFIG)
    model = build_autoencoder(cfg["network"], device=DEV)
    trainer = AETrainer(model, cfg["training"], device=DEV, graph=graph,
                        steps_per_epoch=int(cfg["training"]["steps_per_epoch"])).init(SEED)
    return trainer, cfg


def ae_steps(torch, trainer, clouds, n, twin=None):
    """``n`` AE train steps on ``clouds`` -> (each step's metrics, host-clock
    seconds); with ``twin`` (a dict), the trainer's state before and after
    each of the first AE_GRAPH_STEPS steps (device copies, taken outside the
    timed region) and their metrics go into it, for phase 25."""
    import copy

    out, times = [], []
    if twin is not None:
        twin.update(clouds=clouds, before=[], after=[], metrics=[])
    for i in range(n):
        kept = twin is not None and i < AE_GRAPH_STEPS
        if kept:
            twin["before"].append(copy.deepcopy(trainer.state_dict()))
        t0 = time.perf_counter()
        m = trainer.train_step(clouds)           # ends in one host transfer
        times.append(time.perf_counter() - t0)
        out.append(m)
        if kept:
            twin["after"].append(copy.deepcopy(trainer.state_dict()))
            twin["metrics"].append(m)
    return out, times


def phase_autoencoder(ch, torch, twin=None):
    """The shape autoencoder's training path at full width on the card,
    eagerly; ``twin`` (a dict) receives phase 25's twin (ae_steps)."""
    import copy

    trainer, cfg = ae_trainer(torch, graph=False)
    model, batch = trainer.model, int(cfg["training"]["batch_size"])
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
    ms, times = ae_steps(torch, trainer, clouds, AE_STEPS, twin)
    losses, m = [v["loss"] for v in ms], ms[-1]
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
    if twin is not None:
        twin["ms_per_step"] = step_ms
    return launches


def scene_trainer(torch, config_path, device, data_dir, graph=None, ds=None, training=None):
    """A config's scene model and Trainer (``graph`` as Trainer takes it;
    ``training`` keys over the config's) on ``device``, weights from the
    seed, and its train split of the synthetic dataset at ``data_dir``
    through the copied data pipeline (``ds``, when given, is that split,
    made already)."""
    from diffuscene_tpu_torch.data.factory import (apply_text_emb_dim_default,
                                                   get_dataset_raw_and_encoded)
    from diffuscene_tpu_torch.models import SceneDiffusion, SceneModelConfig
    from diffuscene_tpu_torch.train.trainer import Trainer
    from diffuscene_tpu_torch.utils.config import load_config

    cfg = apply_text_emb_dim_default(load_config(config_path))
    data = dict(cfg["data"], dataset_directory=data_dir,
                annotation_file=os.path.join(data_dir, "splits.csv"))
    if ds is None:
        _, ds = get_dataset_raw_and_encoded(
            data, augmentations=data.get("augmentations"), split=cfg["training"]["splits"],
            seed=SEED, keep_room_layout=bool(cfg["network"].get("room_mask_condition")))
    batch = int(cfg["training"]["batch_size"])
    scene = SceneDiffusion(SceneModelConfig.from_config(cfg["network"],
                                                        cfg.get("feature_extractor")),
                           bounds=ds.bounds.as_device_bounds(), device=device)
    trainer = Trainer(scene, dict(cfg["training"], **(training or {})),
                      steps_per_epoch=max(len(ds) // batch, 1), device=device,
                      graph=graph).init(SEED)
    return ds, batch, trainer


def step_grads(torch, trainer, batch, t, noise):
    """The loss and every parameter's gradient of one batch."""
    loss, _ = trainer.scene.get_loss(batch, t=t, noise=noise)
    return loss.item(), torch.autograd.grad(loss, trainer.params)


def card_cpu_inputs(torch, host, seed, width):
    """The card-vs-CPU step's inputs: the first CARD_CPU_B scenes of the
    host batch ``host``, and their timesteps and noise (``width`` channels)
    from a CPU generator seeded ``seed``."""
    host = {k: v[:CARD_CPU_B] for k, v in host.items()}
    g = torch.Generator().manual_seed(seed)
    t = torch.randint(0, T, (CARD_CPU_B,), generator=g)
    return host, t, torch.randn(CARD_CPU_B, 12, width, generator=g)


def grad_rel_l2(a, b):
    """(the worst parameter's relative L2 difference and its name index,
    the whole gradient's)."""
    per = [((x.float() - y.float().to(x.device)).norm() / y.float().norm().clamp_min(1e-30)).item()
           for x, y in zip(a, b)]
    num = sum(((x.float() - y.float().to(x.device)) ** 2).sum().item() for x, y in zip(a, b))
    den = sum((y.float() ** 2).sum().item() for y in b)
    worst = max(range(len(per)), key=per.__getitem__)
    return per[worst], worst, math.sqrt(num / den)


def train_steps(torch, trainer, batches, n, label, twin=None):
    """``n`` train steps on the card through the data pipeline: finite,
    host-clock ms a step (the median, around train_step and its one metrics
    transfer), peak memory.  With ``twin`` (a dict), the host batches, each
    step's metrics, the state after the last step (train_state), the
    median and the peak go into it, for phase 25."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, hosts, ms = [], [], [], []
    for _ in range(n):
        hosts.append(next(batches))
        batch = trainer.put_batch(hosts[-1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.train_step(batch)
        times.append(time.perf_counter() - t0)
        losses.append(m["loss"])
        ms.append(m)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = 1e3 * sorted(times)[len(times) // 2]
    if twin is not None:
        twin.update(hosts=hosts, metrics=ms, state=train_state(torch, trainer),
                    ms_per_step=step_ms, peak_gb=peak_gb)
    finite = all(math.isfinite(v) for v in losses)
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    print(f"{label}: {n} steps: loss first5 {first:.5f} last5 {last:.5f} finite={finite} "
          f"ms_per_step={step_ms:.3f} (median; first step {1e3 * times[0]:.3f} ms) "
          f"peak_mem_gb={peak_gb:.3f} last_metrics={m}", flush=True)
    if not finite:
        raise RuntimeError(f"{label}: a loss is not finite: {losses}")
    return batch, step_ms, peak_gb, first, last


def phase_train_flagship(torch, data_dir, twin=None):
    """Phase 12: the flagship's train step on the card against the same step
    on the CPU (CARD_CPU_B scenes), then FLAGSHIP_STEPS steps at B=128 on
    the card and a profile of 5, eagerly; ``twin`` (a dict) receives phase
    25's twin: the given step's inputs and train_steps' record."""
    from diffuscene_tpu_torch.data.loader import DataLoader

    ds, bsz, card = scene_trainer(torch, FLAGSHIP_CONFIG, DEV, data_dir, graph=False)
    t0 = time.perf_counter()
    _, _, cpu = scene_trainer(torch, FLAGSHIP_CONFIG, "cpu", data_dir, ds=ds)
    batches = DataLoader(ds, bsz, shuffle=True, seed=SEED).infinite()
    host, t, noise = card_cpu_inputs(torch, next(batches), SEED + 30, 62)
    dev_args = (card.put_batch(host), t.to(DEV), noise.to(DEV))
    cpu_args = (cpu.put_batch(host), t, noise)
    loss_c, grads_c = step_grads(torch, card, *dev_args)
    loss_p, grads_p = step_grads(torch, cpu, *cpu_args)
    worst, at, whole = grad_rel_l2(grads_c, grads_p)
    del grads_c, grads_p
    m_c = card.train_step(dev_args[0], t=dev_args[1], noise=dev_args[2])
    m_p = cpu.train_step(cpu_args[0], t=t, noise=noise)
    cpu_s = time.perf_counter() - t0
    if twin is not None:
        twin.update(config=FLAGSHIP_CONFIG, data_dir=data_dir, first=(host, t, noise),
                    first_metrics=m_c)
    rel = {k: abs(m_c[k] - m_p[k]) / max(abs(m_p[k]), 1e-12) for k in m_p}
    rel_loss = max(v for k, v in rel.items() if k.startswith("loss"))
    ok = (rel_loss <= TRAIN_STEP_TOL["loss"] and rel["gradnorm"] <= TRAIN_STEP_TOL["gradnorm"]
          and worst <= TRAIN_STEP_TOL["grad_rel_l2"])
    print(f"train flagship, card vs cpu (B={CARD_CPU_B}, f32, TF32 off; the comparison "
          f"{cpu_s:.1f} s, most of it the CPU trainer's build, gradients and step): loss "
          f"{m_c['loss']:.7f} vs "
          f"{m_p['loss']:.7f} (get_loss {loss_c:.7f} vs {loss_p:.7f}), gradnorm "
          f"{m_c['gradnorm']:.6f} vs {m_p['gradnorm']:.6f}, worst relative loss-term "
          f"difference {rel_loss:.3e}, gradient relative L2: worst parameter {worst:.3e} "
          f"({card.names[at]}), whole {whole:.3e}; tol={TRAIN_STEP_TOL} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise RuntimeError(f"the flagship step disagrees between card and CPU: {rel}, "
                           f"gradients {worst} at {card.names[at]}")
    del cpu, cpu_args

    # the main path: FLAGSHIP_STEPS steps through the data pipeline
    batch, step_ms, peak_gb, first, last = train_steps(torch, card, batches, FLAGSHIP_STEPS,
                                                       "train flagship", twin)
    if not last < first:
        raise RuntimeError(f"the flagship loss did not fall: first5 {first}, last5 {last}")
    prof = profile_steps(torch, lambda: card.train_step(batch), TRAIN_PROFILE_STEPS, step_ms)
    return {"config": FLAGSHIP_CONFIG, "B": bsz, "dtype": "float32", "steps": FLAGSHIP_STEPS,
            "ms_per_step": step_ms, "busy_ms": prof["busy_ms"], "idle_share": prof["idle_share"],
            "peak_mem_gb": peak_gb, "loss_first5": first, "loss_last5": last,
            "card_vs_cpu": {"loss_rel": rel_loss, "gradnorm_rel": rel["gradnorm"],
                            "grad_rel_l2_worst": worst, "grad_rel_l2": whole},
            "top_kernels": prof["top"]}


def phase_train_b512(torch, data_dir, twin=None):
    """Phase 13: the b512 recipe (bf16, ws_fast_vjp, bf16 moments, gradients
    and EMA, B=512): one step's gradients with ws_fast_vjp against the same
    step without it, then 20 steps and a profile of 5, eagerly; ``twin`` as
    in phase 12 (no given step)."""
    from diffuscene_tpu_torch.data.loader import DataLoader
    from diffuscene_tpu_torch.models.denoiser import WSConv1x1

    ds, bsz, tr = scene_trainer(torch, B512_CONFIG, DEV, data_dir, graph=False)
    if twin is not None:
        twin.update(config=B512_CONFIG, data_dir=data_dir, first=None, first_metrics=None)
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
                                                       "train b512", twin)
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


def train_data():
    """The synthetic cached dataset of phases 12-14 and 25, made from the
    seed."""
    import shutil

    from diffuscene_tpu_torch.data import make_synthetic_cached_dataset

    for d in (TRAIN_DATA, TRAIN_OUT):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(TRAIN_OUT)
    make_synthetic_cached_dataset(TRAIN_DATA, n_scenes=TRAIN_SCENES, seed=SEED)


def phase_train(torch, card, twins=None, cli=True):
    """Phases 12-14 on the synthetic cached dataset; ``twins`` (a dict)
    receives phases 12's and 13's twins for phase 25 ("flagship", "b512");
    without ``cli``, phase 14 is left out."""
    twins = {} if twins is None else twins
    twins.update(flagship={}, b512={})
    train_data()
    out = {"card": card, "flagship": phase_train_flagship(torch, TRAIN_DATA, twins["flagship"])}
    torch.cuda.empty_cache()
    out["b512"] = phase_train_b512(torch, TRAIN_DATA, twins["b512"])
    torch.cuda.empty_cache()
    if cli:
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


def with_schedule(torch, scene, time_num):
    """``scene``'s networks (a copy of its weights) over a ``time_num``-step
    schedule of its config, on the card."""
    import dataclasses

    from diffuscene_tpu_torch.models import SceneDiffusion

    short = SceneDiffusion(dataclasses.replace(scene.cfg, time_num=time_num), device=DEV)
    short.networks.load_state_dict(scene.networks.state_dict())
    return short


def zero_counts(counters):
    """Every count of the wrappers ``counters`` to 0 (by kernel too)."""
    for c in counters:
        c.launches = 0
        if hasattr(c, "by_kernel"):
            c.by_kernel = {}


def checked_sample(torch, scene, label, card, batch=TASK_B, fused=True, step=None, steps=T,
                   calls=None, every=TASK_CHECK_EVERY, named=None, profile=True, **task):
    """One DDPM sample (over ``steps`` steps, 1000 unless cut) of ``batch``
    scenes through ``scene.sample(fused=fused, **task)``: with
    ``fused=True`` every ResnetBlock on B1 and mid_attn on B2, exactly 28
    and 1 launches a call; with ``fused="rows"`` every chain on B4, exactly
    19 a call.  At
    every TASK_CHECK_EVERY-th step the engine's forward (the module's exact
    GELU, as phase 15's gate) on that step's x_t, spliced as the sampler
    spliced it, is held against the module's: within FORWARD_TOL of the
    model's dtype, or the phase fails naming the step.  The check's launches and
    cross-attention contexts are not counted and its time (measured,
    synchronised) is taken out of the wall time.  ``step`` (default: the
    task's step, task_step) is the step a 20-step profile times, naming
    ``named`` (default: the engine's kernels); ``steps`` is the model's
    schedule length (T unless its config says otherwise), ``calls`` the
    sampler's denoiser calls (``steps`` for DDPM) and ``every`` how often a
    call is checked; ``profile=False`` leaves the profile out.  The check
    is host code a step, so the sampler runs eagerly (graph=False; phase
    24 holds the graphed loops to the eager ones).  Returns
    (the sample, a summary with the cross-attention contexts made)."""
    from diffuscene_tpu_torch.models import inference as inf
    from diffuscene_tpu_torch.ops import attention as at
    from diffuscene_tpu_torch.ops import fused_level as fl
    from diffuscene_tpu_torch.ops import fused_resblock as rb
    from diffuscene_tpu_torch.utils.convert import denoiser_tree

    net = scene.denoiser
    dname = str(net.compute_dtype).split(".")[-1]
    tol = FORWARD_TOL[dname]
    counters = ((fl.apply_chain,) if fused == "rows"
                else (rb.fused_resnet_block, at.fused_set_attention))
    calls = steps if calls is None else calls
    expected = (19 * calls,) if fused == "rows" else (28 * calls, calls)
    make_fn = scene._denoise_fn
    errs, info = [], {"step": 0, "check_s": 0.0}

    def checked(condition, condition_cross=None, fused=False):
        fn = make_fn(condition, condition_cross, fused=fused)
        module = make_fn(condition, condition_cross, fused=False)
        made = inf.cross_context.calls
        prep = inf.prepare_inference_params(net, denoiser_tree(net), num_timesteps=steps)
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
            if step % every == 0:
                counts = [(c.launches, dict(getattr(c, "by_kernel", {}))) for c in counters]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                errs.append((step, (engine(x, t) - module(x, t)).abs().max()))
                torch.cuda.synchronize()
                info["check_s"] += time.perf_counter() - t0
                for c, (n, by) in zip(counters, counts):
                    c.launches = n
                    if hasattr(c, "by_kernel"):
                        c.by_kernel = by
            return fn(x, t)

        return gated

    gen = torch.Generator(device=DEV).manual_seed(CHECKED_SEED)
    scene._denoise_fn = checked
    try:
        torch.cuda.synchronize()
        zero_counts(counters)
        inf.cross_context.calls = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = scene.sample(batch, generator=gen, clip_denoised=True, fused=fused, graph=False,
                           **task)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0 - info["check_s"]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launches = tuple(c.launches for c in counters)
        by_kernel = {k: v for c in counters for k, v in getattr(c, "by_kernel", {}).items()}
        contexts = inf.cross_context.calls
    finally:
        del scene._denoise_fn
    worst = torch.stack([e for _, e in errs]).cpu()
    bad = [s for (s, _), e in zip(errs, worst.tolist()) if not e <= tol]
    finite = bool(torch.isfinite(out).all())
    engine = "rows engine" if fused == "rows" else "3-D engine"
    summary = {"B": batch, "dtype": dname, "steps": steps, "calls": calls, "wall_s": wall,
               "scenes_per_s": batch / wall,
               "check_s": info["check_s"], "launches": list(launches), "by_kernel": by_kernel,
               "peak_gb": peak_gb,
               "cross_contexts": contexts, "checked_steps": len(errs),
               "worst_engine_vs_module": worst.max().item(),
               "film_spread": info["film_spread"],
               "film_rows_materialized": info["film_rows_materialized"]}
    sampler = f"{steps}-step DDPM" if calls == steps else f"{calls}-call sampler"
    print(f"{label}: {sampler}, B={batch}, {dname}, fused={fused!r}: shape="
          f"{tuple(out.shape)} finite={finite} launches={list(launches)} (expected "
          f"{list(expected)}) cross_contexts={contexts} wall_s={wall:.3f} scenes_per_s="
          f"{batch / wall:.3f} (the {len(errs)} checks' {info['check_s']:.3f} s taken out); "
          f"{engine} vs module every {every} calls: worst max_abs_err "
          f"{worst.max().item():.3e} tol={tol} {'ok' if not bad else 'FAIL'}; cond-FiLM rows "
          f"spread across scenes {info['film_spread']:.3e} (materialized: "
          f"{info['film_rows_materialized']}) | {card}", flush=True)
    if bad:
        i = bad[0]
        raise RuntimeError(f"{label}: the {engine} is {worst[i // every].item():.3e} "
                           f"from the module at call {i}")
    if tuple(out.shape) != (batch, 12, 62) or not finite:
        raise RuntimeError(f"{label}: the sample is malformed")
    if launches != expected:
        raise RuntimeError(f"{label}: expected {list(expected)} launches, counted {launches}")
    if not info["film_rows_materialized"]:
        raise RuntimeError(f"{label}: the cond-FiLM rows are not materialized")
    if not profile:
        return out, summary
    print(f"profile: {dname} {label} step, B={batch}", flush=True)
    if named is None:
        named = ROWS_KERNELS[dname] if fused == "rows" else ENGINE_KERNELS[dname]
    prof = profile_steps(torch, step or task_step(torch, scene, **task), SAMPLE_PROFILE_STEPS,
                         1e3 * wall / calls, named=named)
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


def phase_task_samples(torch, card, data_dir, graphs=None):
    """Phase 16 (a) and (b): completion on the flagship config and
    re-arrangement on the rearrange config, f32 at full width, random
    weights from the seed, through checked_sample; the spliced slots and
    channels bit-equal to the inputs, and the rearrange model's cond-FiLM
    rows different across scenes.  With ``graphs`` (a dict), phase 24's
    task cases too: each checked sample's graphed twin, into ``graphs``."""
    target, noisy = task_inputs(torch, data_dir)
    partial = target[:, :TASK_PARTIAL]
    scene = task_model(torch, FLAGSHIP_CONFIG)
    out, comp = checked_sample(torch, scene, "tasks: completion", card, partial_boxes=partial)
    if graphs is not None:
        graphs["complete_b32"] = graph_case(
            torch, scene, f"completion DDPM-{T}", card, TASK_B, graph_counters(),
            [28 * T, T, 0], task_step(torch, scene, partial_boxes=partial), seed=CHECKED_SEED,
            eager={"out": out, "wall_s": comp["wall_s"], "peak_gb": comp["peak_gb"]},
            fused=True, partial_boxes=partial)
    comp["partial_bit_equal"] = bool(torch.equal(out[:, :TASK_PARTIAL], partial))
    print(f"tasks: completion: the first {TASK_PARTIAL} slots equal the partial boxes bit for "
          f"bit: {comp['partial_bit_equal']}", flush=True)
    if not comp["partial_bit_equal"]:
        raise RuntimeError("completion: the first slots are not the partial boxes")
    scene = task_model(torch, REARRANGE_CONFIG)
    out, arr = checked_sample(torch, scene, "tasks: rearrange", card, input_boxes=noisy)
    if graphs is not None:
        graphs["arrange_b32"] = graph_case(
            torch, scene, f"rearrange DDPM-{T}", card, TASK_B, graph_counters(), [28 * T, T, 0],
            task_step(torch, scene, input_boxes=noisy), seed=CHECKED_SEED,
            eager={"out": out, "wall_s": arr["wall_s"], "peak_gb": arr["peak_gb"]},
            fused=True, input_boxes=noisy)
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
    """Phase 16 (c): the rearrange config's train step on the card against
    the same step on the CPU (CARD_CPU_B scenes of one batch, t and noise:
    the loss and every parameter's gradient), then TASK_TRAIN_STEPS steps at
    its B=128 on the card (median ms/step, peak memory)."""
    from diffuscene_tpu_torch.data.loader import DataLoader

    ds, bsz, card = scene_trainer(torch, REARRANGE_CONFIG, DEV, data_dir)
    _, _, cpu = scene_trainer(torch, REARRANGE_CONFIG, "cpu", data_dir)
    batches = DataLoader(ds, bsz, shuffle=True, seed=SEED).infinite()
    host, t, noise = card_cpu_inputs(torch, next(batches), SEED + 32, 5)
    loss_c, grads_c = step_grads(torch, card, card.put_batch(host), t.to(DEV), noise.to(DEV))
    loss_p, grads_p = step_grads(torch, cpu, cpu.put_batch(host), t, noise)
    worst, at, whole = grad_rel_l2(grads_c, grads_p)
    del grads_c, grads_p, cpu
    loss_rel = abs(loss_c - loss_p) / abs(loss_p)
    ok = loss_rel <= TRAIN_STEP_TOL["loss"] and worst <= TRAIN_STEP_TOL["grad_rel_l2"]
    print(f"train rearrange, card vs cpu (B={CARD_CPU_B}, f32, TF32 off): loss {loss_c:.7f} vs "
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
    --num_partial 3 --fused --compute_intersec on that one; each config's
    schedule cut to TASK_CLI_STEPS steps.  Each CLI samples one batch of
    TASK_B: exactly 28 B1 and 1 B2 launches a step, TASK_B box files and a
    finite metrics.json."""
    import re

    from diffuscene_tpu_torch.cli import completion_rearrange, train_diffusion
    from diffuscene_tpu_torch.ops import attention as at
    from diffuscene_tpu_torch.ops import fused_resblock as rb

    out = {}
    for label, config, task_flags in (
            ("rearrange", REARRANGE_CONFIG, ["--arrange_objects"]),
            ("completion", FLAGSHIP_CONFIG, ["--num_partial", str(TASK_PARTIAL)])):
        cfg_path = synthetic_config(config, data_dir, out_dir, f"{label}.yaml")
        with open(cfg_path) as f:
            text, n = re.subn(r"^(\s*time_num:) 1000$", rf"\g<1> {TASK_CLI_STEPS}", f.read(),
                              flags=re.M)
        if n != 1:
            raise RuntimeError(f"{cfg_path}: cannot set time_num")
        with open(cfg_path, "w") as f:
            f.write(text)
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
        ok = (launches == (28 * TASK_CLI_STEPS, TASK_CLI_STEPS) and n_boxes == TASK_B
              and saved == metrics
              and saved.get("n_scenes") == TASK_B
              and all(math.isfinite(v) for v in saved.values()))
        print(f"cli: train_diffusion {label} config {TASK_CLI_EPOCHS} epochs {train_s:.3f} s; "
              f"completion_rearrange {' '.join(task_flags)} --fused {TASK_B} scenes (EMA "
              f"weights, {TASK_CLI_STEPS} steps) {task_s:.3f} s, launches B1={launches[0]} B2={launches[1]}, {n_boxes} "
              f"box files, metrics {saved} {'ok' if ok else 'FAIL'} | {card}", flush=True)
        if not ok:
            raise RuntimeError(f"the {label} CLI pair failed: launches {launches}, "
                               f"{n_boxes} box files, metrics {saved}")
        out[label] = {"train_s": train_s, "task_s": task_s, "launches": list(launches)}
    return out


def phase_tasks(torch, card, graphs=None):
    """Phase 16: scene completion and re-arrangement, f32 at full width, on
    a synthetic cached dataset made from the seed (with ``graphs``, phase
    24's task cases, phase_task_samples)."""
    import shutil

    from diffuscene_tpu_torch.data import make_synthetic_cached_dataset

    for d in (TASK_DATA, TASK_OUT):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(TASK_OUT)
    make_synthetic_cached_dataset(TASK_DATA, n_scenes=TRAIN_SCENES, seed=SEED)
    t0 = time.perf_counter()
    out = {"card": card, "samples": phase_task_samples(torch, card, TASK_DATA, graphs)}
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


def phase_text_samples(torch, card, data_dir, graphs=None):
    """Phase 17 (a)-(c): the bedroom text model, f32 at full width, random
    weights from the seed.  (a) DDPM over CUT_STEPS steps at TEXT_B through
    the 3-D engine and (b) DDPM-1000 at TEXT_ROWS_B through the rows engine,
    both by checked_sample
    (exact launch counts, the engine held to the module every
    TASK_CHECK_EVERY steps, TEXT_CONTEXTS contexts a sample, a 20-step
    profile), then the cross blocks' device time in a TEXT_B step; (c) the
    text reaches its own scene: one step of the 3-D engine on one x_t
    repeated in every scene, with the text rolled by one scene, is the
    unrolled step's output rolled by one scene (ROLL_TOL) and differs from
    it (ROLL_MIN_DIFF).  With ``graphs`` (a dict), phase 24's text case
    too: the rows sample's graphed twin, into ``graphs``."""
    from diffuscene_tpu_torch.models import inference as inf
    from diffuscene_tpu_torch.utils.convert import denoiser_tree

    scene = task_model(torch, TEXT_CONFIG)
    text = text_inputs(torch, data_dir, TEXT_B)
    out = {}
    # (a) over CUT_STEPS steps; (b) over the config's T, phase 24's twin
    for key, batch, fused, steps in (("ddpm_3d", TEXT_B, True, CUT_STEPS),
                                     ("ddpm_rows", TEXT_ROWS_B, "rows", T)):
        te = text[:batch]
        model = scene if steps == T else with_schedule(torch, scene, steps)
        gen = torch.Generator(device=DEV).manual_seed(SEED + 8)
        step = sampling_step(torch, model, batch, gen, fused=fused, text_emb=te)
        sample, summary = checked_sample(torch, model, f"text: {key}", card, batch=batch,
                                         fused=fused, text_emb=te, step=step, steps=steps)
        del model
        if summary["cross_contexts"] != TEXT_CONTEXTS:
            raise RuntimeError(f"text: {key}: {summary['cross_contexts']} cross-attention "
                               f"contexts a sample, expected {TEXT_CONTEXTS}")
        out[key] = summary
        if graphs is not None and fused == "rows":
            graphs["text_rows_b64"] = graph_case(
                torch, scene, f"text rows DDPM-{T}", card, batch, graph_counters(),
                [0, 0, 19 * T], step, contexts=TEXT_CONTEXTS, seed=CHECKED_SEED,
                eager={"out": sample, "wall_s": summary["wall_s"], "peak_gb": summary["peak_gb"]},
                fused=fused, text_emb=te)

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

    cross_ms = device_ms(torch, cross_blocks, "", SAMPLE_PROFILE_STEPS, launches=None)
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
    """Phase 17 (d): the text config's train step on the card against the
    same step on the CPU (CARD_CPU_B scenes of one batch with their 768-wide
    token embeddings, t and noise: the loss and every parameter's gradient),
    every cross-attention parameter and fc_text_f with a non-zero gradient;
    then TEXT_TRAIN_STEPS steps at its B=128 on the card (median ms/step, peak memory)."""
    from diffuscene_tpu_torch.data.loader import DataLoader

    ds, bsz, card = scene_trainer(torch, TEXT_CONFIG, DEV, data_dir)
    _, _, cpu = scene_trainer(torch, TEXT_CONFIG, "cpu", data_dir)
    batches = DataLoader(ds, bsz, shuffle=True, seed=SEED).infinite()
    host, t, noise = card_cpu_inputs(torch, next(batches), SEED + 33, 62)
    dev_batch = card.put_batch(host)
    if tuple(dev_batch["text_emb"].shape) != (CARD_CPU_B, 50, 768):
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
    print(f"train text, card vs cpu (B={CARD_CPU_B}, f32, TF32 off): loss {loss_c:.7f} vs "
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
    epochs, then generate_diffusion --fused --dpm (DPM-Solver++-20; (a)
    holds a text DDPM through the same engine) on its checkpoint,
    once with --fix_order and once with --scene_id: GEN_SCENES scenes in
    one batch, exactly 560 B1 and 20 B2 launches, a box file and a
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
             "--dpm", "--seed", str(SEED), "--device", DEV, *flags])
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
        ok = (launches == (28 * DPM_STEPS, DPM_STEPS) and n_boxes == len(texts) == GEN_SCENES
              and saved == stats and stats.get("n_scenes") == GEN_SCENES
              and all(w.startswith("The room has ") for w in texts)
              and (len(rooms) == 1) == (label == "scene_id"))
        print(f"cli: generate_diffusion --fused --dpm {' '.join(flags)} {GEN_SCENES} scenes (text, EMA "
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


def phase_text(torch, card, graphs=None):
    """Phase 17: text-conditioned generation, f32 at full width, on a
    synthetic cached dataset made from the seed (with ``graphs``, phase
    24's text case, phase_text_samples)."""
    import shutil

    from diffuscene_tpu_torch.data import make_synthetic_cached_dataset

    for d in (TEXT_DATA, TEXT_OUT):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(TEXT_OUT)
    make_synthetic_cached_dataset(TEXT_DATA, n_scenes=TRAIN_SCENES, seed=SEED)
    t0 = time.perf_counter()
    out = {"card": card, "samples": phase_text_samples(torch, card, TEXT_DATA, graphs)}
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


def cli_timed(torch, timings, label, cli, argv):
    """One CLI call, its wall seconds (ending in a synchronize) into
    ``timings[label]``; returns the CLI's return."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = cli.main(argv)
    torch.cuda.synchronize()
    timings[label] = time.perf_counter() - t0
    print(f"data: {label} {timings[label]:.3f} s", flush=True)
    return out


def phase_data_pipeline(torch, ch, card):
    """Phase 19 (a): the raw-to-cache pipeline on a synthetic raw 3D-FRONT
    tree of DATA_ROOMS bedrooms, through the port's CLIs in the README's
    order, each timed: pickle_threed_future_dataset,
    pickle_threed_future_pointcloud, train_objautoencoder (DATA_AE_EPOCHS
    epochs on the card, exactly 2 B3 launches a step),
    generate_objautoencoder (the 32-d latents, then the same AE's under
    the 64-d name the preprocessing also reads), preprocess_data
    --add_objfeats --room_mask_size 512.  Every valid room has boxes.npz,
    room_mask.png and its render, the out-of-range room is dropped, the
    dataset_stats.txt bounds are finite, every 64x64 mask that
    CachedThreedFront returns is non-empty, and the first 12 rooms' masks
    sum to the CPU tests' levels (DATA_MASK_LEVELS)."""
    import importlib.util
    import shutil

    import numpy as np

    from diffuscene_tpu_torch.cli import (generate_objautoencoder, pickle_threed_future_dataset,
                                          pickle_threed_future_pointcloud, preprocess_data,
                                          train_objautoencoder)
    from diffuscene_tpu_torch.data import make_synthetic_raw_front
    from diffuscene_tpu_torch.data.threed_front import CachedThreedFront
    from diffuscene_tpu_torch.data.threed_future import ThreedFutureNormPCDataset
    from diffuscene_tpu_torch.utils.config import load_config

    for d in (DATA_RAW, DATA_OUT):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(DATA_OUT)
    t = {}
    t0 = time.perf_counter()
    raw = make_synthetic_raw_front(DATA_RAW, n_rooms=DATA_ROOMS, seed=SEED)
    t["make_synthetic_raw_front"] = time.perf_counter() - t0
    args = [raw["front"], raw["future"], raw["model_info"], "--annotation_file", raw["splits"]]
    cli_timed(torch, t, "pickle_threed_future_dataset", pickle_threed_future_dataset,
              [DATA_OUT, *args])
    pkl = os.path.join(DATA_OUT, "threed_future_model_bedroom.pkl")
    cli_timed(torch, t, "pickle_threed_future_pointcloud", pickle_threed_future_pointcloud,
              [DATA_OUT, *args, "--seed", str(SEED)])
    n_models = len(ThreedFutureNormPCDataset.from_pickled_dataset(pkl))
    ae_steps = DATA_AE_EPOCHS * max(n_models // int(load_config(AE_CONFIG)["training"]
                                                    ["batch_size"]), 1)
    torch.cuda.synchronize()
    ch.directed_nn.launches = 0
    cli_timed(torch, t, "train_objautoencoder", train_objautoencoder,
              [AE_CONFIG, DATA_OUT, "--experiment_tag", "ae", "--path_to_pickled_dataset", pkl,
               "--epochs", str(DATA_AE_EPOCHS), "--seed", str(SEED), "--device", DEV])
    ae_launches = ch.directed_nn.launches
    print(f"data: the shape AE on {n_models} catalog models: {ae_steps} steps, "
          f"{ae_launches} B3 launches (expected {2 * ae_steps})", flush=True)
    if ae_launches != 2 * ae_steps:
        raise RuntimeError(f"train_objautoencoder launched B3 {ae_launches} times in {ae_steps} "
                           f"steps, expected {2 * ae_steps}")
    for lat in ("lat32", "lat"):
        cli_timed(torch, t, f"generate_objautoencoder_{lat}", generate_objautoencoder,
                  [AE_CONFIG, os.path.join(DATA_OUT, "ae"), "--path_to_pickled_dataset", pkl,
                   "--lat_name", lat, "--device", DEV])
    cli_timed(torch, t, "preprocess_data", preprocess_data,
              [DATA_CACHE, *args, "--add_objfeats", "--room_mask_size", "512"])
    shutil.copy(raw["splits"], os.path.join(DATA_CACHE, "splits.csv"))

    dirs = sorted(d for d in os.listdir(DATA_CACHE) if os.path.isdir(os.path.join(DATA_CACHE, d)))
    files = ("boxes.npz", "room_mask.png", "rendered_scene_256.png")
    missing = [d for d in dirs if not all(os.path.isfile(os.path.join(DATA_CACHE, d, f))
                                          for f in files)]
    with open(os.path.join(DATA_CACHE, "dataset_stats.txt")) as f:
        stats = json.load(f)
    bounds = [v for k, vs in stats.items() if k.startswith("bounds_") for v in vs]
    ds = CachedThreedFront(DATA_CACHE, {"room_layout_size": "64,64"},
                           [d.split("_")[1] for d in dirs])
    masks = np.stack([ds[i]["room_layout"] for i in range(len(ds))])
    empty = int((masks.reshape(len(masks), -1).max(1) <= 0).sum())
    levels = [int(round(float(m.astype(np.float64).sum() * 255))) for m in masks[:12]]
    level_diff = max(abs(a - b) for a, b in zip(levels, DATA_MASK_LEVELS))
    pillow = importlib.util.find_spec("PIL") is not None
    ok = (len(dirs) == DATA_ROOMS and not missing and not any("bad" in d for d in dirs)
          and bounds and all(math.isfinite(v) for v in bounds) and not empty
          and masks.shape[1:] == (1, 64, 64) and level_diff <= DATA_MASK_LEVEL_TOL)
    print(f"data: {len(dirs)} room directories (expected {DATA_ROOMS}; the out-of-range room "
          f"dropped), {len(missing)} missing a file of {files}; {len(bounds)} finite bounds in "
          f"dataset_stats.txt, {len(stats['object_types'])} object types; {len(masks)} 64x64 "
          f"masks, {empty} empty; the first 12 masks' levels {levels}, worst difference from "
          f"the CPU tests' {level_diff} (tol {DATA_MASK_LEVEL_TOL}; Pillow importable here: "
          f"{pillow}) {'ok' if ok else 'FAIL'} | {card}", flush=True)
    if not ok:
        raise RuntimeError(f"the data pipeline's output is malformed: {len(dirs)} rooms, missing "
                           f"{missing[:3]}, {empty} empty masks, level difference {level_diff}")
    return {"rooms": len(dirs), "catalog_models": n_models, "ae_steps": ae_steps,
            "ae_launches": ae_launches, "object_types": len(stats["object_types"]),
            "mask_level_diff": level_diff, "pillow": pillow, "seconds": t}


def room_mask_config(out_dir):
    """The flagship config as a room-mask model (room_mask_condition true,
    latent_dim 64, the Unet's context_dim 64) over DATA_CACHE, written to
    ``out_dir``; its path."""
    import re

    path = synthetic_config(FLAGSHIP_CONFIG, DATA_CACHE, out_dir, "flagship_room_mask.yaml")
    with open(path) as f:
        text = f.read()
    for key, old, new in (("room_mask_condition", "false", "true"), ("latent_dim", "0", "64"),
                          ("context_dim", "0", "64")):
        text, n = re.subn(rf"^(\s*{key}:) {old}$", rf"\1 {new}", text, flags=re.M)
        if n != 1:
            raise RuntimeError(f"{FLAGSHIP_CONFIG}: no single '{key}: {old}' to set")
    with open(path, "w") as f:
        f.write(text)
    return path


def room_step_grads(torch, trainer, batch, t, noise):
    """The loss, every parameter's gradient and the gradient of the loss
    with respect to the room features of one batch (its room_layout through
    the extractor, then as room_feat)."""
    scene = trainer.scene
    feat = scene.feature_extractor(batch["room_layout"])
    loss, _ = scene.get_loss({**batch, "room_feat": feat}, t=t, noise=noise)
    *grads, up = torch.autograd.grad(loss, [*trainer.params, feat])
    return loss.item(), grads, up


def extractor_grad_check(torch, ext_card, ext_cpu, rl, up):
    """The extractor's parameter gradients for the upstream gradient ``up``
    (the CPU step's, with respect to the room features), each against the
    CPU's in f64 (relative L2): the card's in f64 within
    DATA_EXTRACTOR_F64_TOL (the card's kernels compute the same function),
    the card's in f32 within DATA_EXTRACTOR_GRAD_TOL; the CPU's f32 printed
    beside."""
    import copy

    def vjp(ext, x, u):
        params = list(ext.parameters())
        return [g.double().cpu() for g in torch.autograd.grad(ext(x), params, u)]

    f64 = vjp(copy.deepcopy(ext_cpu).double(), rl.cpu().double(), up.double())
    runs = {"card_f32": vjp(ext_card, rl, up.to(rl.device)),
            "card_f64": vjp(copy.deepcopy(ext_card).double(), rl.double(),
                            up.double().to(rl.device)),
            "cpu_f32": vjp(ext_cpu, rl.cpu(), up)}
    names = [n for n, _ in ext_cpu.named_parameters()]
    rel = {k: [((a - w).norm() / w.norm().clamp_min(1e-300)).item() for a, w in zip(got, f64)]
           for k, got in runs.items()}
    worst = {k: max(zip(r, names)) for k, r in rel.items()}
    tol = {"card_f32": DATA_EXTRACTOR_GRAD_TOL, "card_f64": DATA_EXTRACTOR_F64_TOL}
    ok = all(worst[k][0] <= t for k, t in tol.items())
    print(f"data train: the extractor's gradients against the cpu's f64, relative L2, worst "
          f"parameter: card f32 {worst['card_f32'][0]:.3e} ({worst['card_f32'][1]}; "
          f"{sum(r > 1e-3 for r in rel['card_f32'])} of {len(names)} above 1e-3), card f64 "
          f"{worst['card_f64'][0]:.3e} ({worst['card_f64'][1]}), cpu f32 "
          f"{worst['cpu_f32'][0]:.3e} ({worst['cpu_f32'][1]}); tol {tol} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return {"ok": ok, "bad": {k: worst[k] for k in tol if worst[k][0] > tol[k]},
            "summary": {k: {"worst": w, "param": n} for k, (w, n) in worst.items()}}


def phase_data_train(torch, cfg_path, card):
    """Phase 19 (b): the room-mask flagship's train step on the card against
    the same step on the CPU (CARD_CPU_B scenes of one batch with their
    masks, t and noise: the loss and every parameter's gradient, the extractor's and
    fc_room_f's non-zero), the extractor's share of a card step's device
    time at B=128; then cli/train_diffusion.py for DATA_TRAIN_EPOCHS steps (median
    ms/step around each train_step, peak memory) and its checkpoint's
    frozen BatchNorm statistics bit for bit as initialized."""
    from diffuscene_tpu_torch.cli import train_diffusion
    from diffuscene_tpu_torch.data.loader import DataLoader
    from diffuscene_tpu_torch.train.trainer import Trainer
    from diffuscene_tpu_torch.utils.checkpoint import load_checkpoint

    ds, bsz, dev = scene_trainer(torch, cfg_path, DEV, DATA_CACHE)
    _, _, cpu = scene_trainer(torch, cfg_path, "cpu", DATA_CACHE)
    batches = DataLoader(ds, bsz, shuffle=True, seed=SEED).infinite()
    full = next(batches)
    host, t, noise = card_cpu_inputs(torch, full, SEED + 40, 62)
    dev_batch = dev.put_batch(host)
    if tuple(dev_batch["room_layout"].shape) != (CARD_CPU_B, 1, 64, 64):
        raise RuntimeError(f"data train: the batch's room_layout is "
                           f"{dev_batch['room_layout'].shape}")
    loss_c, grads_c, _ = room_step_grads(torch, dev, dev_batch, t.to(DEV), noise.to(DEV))
    loss_p, grads_p, up = room_step_grads(torch, cpu, cpu.put_batch(host), t, noise)
    ext = [i for i, n in enumerate(dev.names) if n.startswith("feature_extractor.")]
    rest = [i for i in range(len(dev.names)) if i not in ext]
    worst, at, whole = grad_rel_l2([grads_c[i] for i in rest], [grads_p[i] for i in rest])
    at = rest[at]
    ext_card_cpu = grad_rel_l2([grads_c[i] for i in ext], [grads_p[i] for i in ext])
    room = ext + [i for i, n in enumerate(dev.names) if "fc_room_f" in n]
    zero = [dev.names[i] for i in room if not grads_c[i].abs().max().item() > 0]
    del grads_c, grads_p
    # the extractor's gradients, from the CPU step's upstream gradient, are
    # held to the CPU's f64 ones (extractor_grad_check)
    ext_tol = extractor_grad_check(torch, dev.scene.feature_extractor,
                                   cpu.scene.feature_extractor, dev_batch["room_layout"], up)
    del cpu
    loss_rel = abs(loss_c - loss_p) / abs(loss_p)
    ok = (loss_rel <= TRAIN_STEP_TOL["loss"] and worst <= TRAIN_STEP_TOL["grad_rel_l2"]
          and whole <= TRAIN_STEP_TOL["grad_rel_l2"] and not zero and ext_tol["ok"])
    print(f"data train, card vs cpu (room-mask flagship, B={CARD_CPU_B}, f32, TF32 off): loss "
          f"{loss_c:.7f} vs {loss_p:.7f} (relative {loss_rel:.3e}), gradient relative L2 of the "
          f"denoiser and heads: worst parameter {worst:.3e} ({dev.names[at]}), whole "
          f"{whole:.3e}; tol={TRAIN_STEP_TOL}; the extractor's, card vs cpu: worst "
          f"{ext_card_cpu[0]:.3e} ({dev.names[ext[ext_card_cpu[1]]]}), whole "
          f"{ext_card_cpu[2]:.3e}; {len(room)} extractor and fc_room_f parameters, {len(zero)} "
          f"with a zero gradient {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise RuntimeError(f"the room-mask step disagrees between card and CPU: loss {loss_rel}, "
                           f"gradients {worst} at {dev.names[at]}, whole {whole}; the extractor's "
                           f"{ext_tol['bad']}; zero gradients: {zero}")
    # a card step's device time at B=bsz, and the extractor's share of it
    dev_batch = dev.put_batch(full)
    dev.train_step(dev_batch)      # the step's warm call: host_ms's own first call captures it
    step_ms = host_ms(torch, lambda: dev.train_step(dev_batch), 3)
    prof = profile_steps(torch, lambda: dev.train_step(dev_batch), TRAIN_PROFILE_STEPS, step_ms)
    rl = dev_batch["room_layout"]

    def extractor_step():
        dev.scene.feature_extractor(rl).sum().backward()

    ext_ms = device_ms(torch, extractor_step, "", TRAIN_PROFILE_STEPS, launches=None)
    dev.opt.zero_grad()
    share = ext_ms / prof["busy_ms"] if prof["busy_ms"] else None
    print(f"data train: the ResNet18's forward and backward at B={bsz} on 64x64 masks "
          f"{ext_ms:.3f} ms of device time, {share if share is None else f'{share:.1%}'} of the "
          f"step's busy {prof['busy_ms']} ms | {card}", flush=True)
    del dev

    step_fn, times = Trainer.train_step, []

    def timed(self, *a, **k):
        t0 = time.perf_counter()
        out = step_fn(self, *a, **k)           # ends in its one metrics transfer
        times.append(time.perf_counter() - t0)
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    Trainer.train_step = timed
    t0 = time.perf_counter()
    try:
        train_diffusion.main([cfg_path, DATA_OUT, "--experiment_tag", "room_mask", "--seed",
                              str(SEED), "--epochs", str(DATA_TRAIN_EPOCHS), "--device", DEV])
    finally:
        Trainer.train_step = step_fn
    train_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    exp = os.path.join(DATA_OUT, "room_mask")
    state, _ = load_checkpoint(exp)
    stats = [(n, v) for which in ("model", "ema") if state.get(which) is not None
             for n, v in state[which].items() if n.endswith(("running_mean", "running_var"))]
    frozen = bool(stats) and all(
        torch.equal(v, torch.full_like(v, 1.0 if n.endswith("running_var") else 0.0))
        for n, v in stats)
    cli_ms = 1e3 * sorted(times)[len(times) // 2] if times else float("nan")
    ok = len(times) == state["step"] == DATA_TRAIN_EPOCHS and frozen
    print(f"data train: train_diffusion {DATA_TRAIN_EPOCHS} epochs = {len(times)} steps at "
          f"B={bsz} {train_s:.3f} s, ms_per_step={cli_ms:.3f} (median; first "
          f"{1e3 * times[0]:.3f} ms), peak_mem_gb={peak_gb:.3f}; {len(stats)} frozen statistics "
          f"in the checkpoint (model and EMA) bit for bit as initialized: {frozen} "
          f"{'ok' if ok else 'FAIL'} | {card}", flush=True)
    if not ok:
        raise RuntimeError(f"the room-mask train CLI: {len(times)} steps (state {state['step']}), "
                           f"frozen statistics unchanged: {frozen}")
    return exp, {"B": bsz, "card_vs_cpu": {"loss_rel": loss_rel, "grad_rel_l2_worst": worst,
                                           "grad_rel_l2": whole,
                                           "extractor_grad_rel_l2_worst": ext_card_cpu[0],
                                           "extractor_grad_rel_l2": ext_card_cpu[2]},
                 "extractor_grads_vs_f64": ext_tol["summary"],
                 "step_ms": step_ms, "busy_ms": prof["busy_ms"], "idle_share": prof["idle_share"],
                 "extractor_ms": ext_ms, "extractor_share": share, "cli_steps": len(times),
                 "cli_ms_per_step": cli_ms, "cli_train_s": train_s, "peak_mem_gb": peak_gb,
                 "frozen_stats_unchanged": frozen}


def room_inputs(torch, cfg_path, batch):
    """The room masks of ``batch`` eval scenes (the eval split as
    generate_diffusion reads it, taken in order and cycled), as a
    (batch, 1, 64, 64) tensor on the card."""
    import numpy as np

    from diffuscene_tpu_torch.data.factory import get_dataset_raw_and_encoded
    from diffuscene_tpu_torch.utils.config import load_config

    cfg = load_config(cfg_path)
    data = dict(cfg["data"], encoding_type=cfg["data"]["encoding_type"] + "_no_prm")
    _, ds = get_dataset_raw_and_encoded(data, augmentations=None,
                                        split=cfg["validation"]["splits"], keep_room_layout=True)
    masks = [ds[i % len(ds)]["room_layout"] for i in range(batch)]
    return torch.from_numpy(np.stack(masks).astype(np.float32)).to(DEV)


def phase_data_samples(torch, cfg_path, exp, card):
    """Phase 19 (c), from (b)'s checkpoint: generate_diffusion --fused --dpm
    --clip_denoised --fix_order, DPM-Solver++-20 at B=256 (exactly 560 B1
    and 20 B2 launches, the extractor once a batch); DDPM at DATA_ROWS_B
    over CUT_STEPS steps of the same weights through fused="rows" (exactly
    4,750 B4) and through fused=True (7,000 B1, 250 B2), each engine within FORWARD_TOL of the module every 50th
    step (checked_sample); the extractor's features of the 256 masks card
    vs CPU within DATA_FEATURE_TOL; DPM-Solver++-20 from the same noise
    with the masks inverted (1 - mask) gives other samples."""
    from diffuscene_tpu_torch.cli import generate_diffusion
    from diffuscene_tpu_torch.models import SceneDiffusion, SceneModelConfig
    from diffuscene_tpu_torch.models import feature_extractors as fe
    from diffuscene_tpu_torch.utils.checkpoint import load_model_weights
    from diffuscene_tpu_torch.utils.config import load_config

    out = {}
    forward, calls = fe.ResNet18.forward, []

    def counted(self, x):
        calls.append(int(x.shape[0]))
        return forward(self, x)

    gen_dir = os.path.join(DATA_OUT, "generated")
    fe.ResNet18.forward = counted
    try:
        stats, launches, wall = eval_cli_run(torch, generate_diffusion, [
            cfg_path, gen_dir, "--weight_file", exp, "--n_sequences", str(GENERATE_B),
            "--batch_size", str(GENERATE_B), "--clip_denoised", "--fused", "--dpm", "--fix_order",
            "--seed", str(SEED), "--device", DEV])
    finally:
        fe.ResNet18.forward = forward
    n_boxes = len([f for f in os.listdir(gen_dir) if f.endswith("_boxes.npz")])
    with open(os.path.join(gen_dir, "timing.json")) as f:
        timing = json.load(f)
    ok = (tuple(launches) == (28 * DPM_STEPS, DPM_STEPS) and calls == [GENERATE_B]
          and n_boxes == GENERATE_B
          and stats.get("n_scenes") == GENERATE_B
          and math.isfinite(stats.get("categorical_kl", float("nan"))))
    print(f"data: generate_diffusion --fused --dpm --clip_denoised --fix_order {GENERATE_B} scenes "
          f"(room-mask flagship, EMA weights) {wall:.3f} s (sampling {timing['sample_s']:.3f} s), "
          f"launches B1={launches[0]} B2={launches[1]}, extractor calls {calls}, {n_boxes} box "
          f"files, stats {stats} {'ok' if ok else 'FAIL'} | {card}", flush=True)
    if not ok:
        raise RuntimeError(f"the room-mask generate CLI: launches {launches}, extractor calls "
                           f"{calls}, {n_boxes} box files")
    out["generate"] = {"wall_s": wall, "sample_s": timing["sample_s"],
                       "launches": list(launches), "extractor_calls": len(calls),
                       "categorical_kl": stats["categorical_kl"]}

    cfg = load_config(cfg_path)
    scfg = SceneModelConfig.from_config(cfg["network"], cfg.get("feature_extractor"))
    scene = SceneDiffusion(scfg, device=DEV)
    scene.networks.load_state_dict(load_model_weights(exp))
    masks = room_inputs(torch, cfg_path, GENERATE_B)
    short = with_schedule(torch, scene, CUT_STEPS)
    for key, fused in (("ddpm_rows", "rows"), ("ddpm_3d", True)):
        rl = masks[:DATA_ROWS_B]
        gen = torch.Generator(device=DEV).manual_seed(SEED + 41)
        _, summary = checked_sample(
            torch, short, f"data: {key}", card, batch=DATA_ROWS_B, fused=fused, room_layout=rl,
            step=sampling_step(torch, short, DATA_ROWS_B, gen, fused=fused, room_layout=rl),
            steps=CUT_STEPS)
        out[key] = summary
    del short

    cpu = SceneDiffusion(scfg, device="cpu")
    cpu.networks.load_state_dict(scene.networks.state_dict())
    with torch.no_grad():
        feat_c = scene.feature_extractor(masks).cpu()
        feat_p = cpu.feature_extractor(masks.cpu())
    rel = ((feat_c - feat_p).norm() / feat_p.norm()).item()
    g = torch.Generator(device=DEV)
    rl = masks[:DATA_INVERT_B]
    a, b = (scene.sample(DATA_INVERT_B, generator=g.manual_seed(SEED + 42), clip_denoised=True,
                         fused=True, dpm=True, dpm_steps=DPM_STEPS, room_layout=m)
            for m in (rl, 1.0 - rl))
    moved = (a - b).abs().max().item()
    finite = bool(torch.isfinite(a).all() and torch.isfinite(b).all())
    ok = rel <= DATA_FEATURE_TOL and moved > ROLL_MIN_DIFF and finite
    print(f"data: the extractor's features of {GENERATE_B} masks, card vs cpu (f32, TF32 off): "
          f"relative L2 {rel:.3e} (tol {DATA_FEATURE_TOL}); DPM-Solver++-{DPM_STEPS} at "
          f"B={DATA_INVERT_B} from the same noise with the masks inverted: samples differ by up "
          f"to {moved:.3e} (must exceed {ROLL_MIN_DIFF}), finite={finite} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise RuntimeError(f"room-mask checks: features card vs cpu {rel}, inverted masks "
                           f"moved the samples by {moved}, finite {finite}")
    out["extractor_card_vs_cpu_rel_l2"] = rel
    out["inverted_mask_max_diff"] = moved
    return out


def phase_data(torch, ch, card):
    """Phase 19: the data pipeline from a synthetic raw tree, then the
    room-mask flagship trained and sampled on its cache."""
    t0 = time.perf_counter()
    out = {"card": card, "pipeline": phase_data_pipeline(torch, ch, card)}
    cfg_path = room_mask_config(DATA_OUT)
    exp, out["train"] = phase_data_train(torch, cfg_path, card)
    torch.cuda.empty_cache()
    out["samples"] = phase_data_samples(torch, cfg_path, exp, card)
    out["phase_s"] = time.perf_counter() - t0
    print(f"data: phase 19 took {out['phase_s']:.1f} s", flush=True)
    return out


def rest_config(name, training=None, net_kwargs=None, diffusion=None, data=REST_DATA,
                out=REST_OUT, base=FLAGSHIP_CONFIG):
    """The ``base`` config (the flagship's by default) over ``data`` with
    ``training``, ``net_kwargs`` and ``diffusion_kwargs`` keys set
    (replaced where the file has them, added under the section where it
    does not), written to ``out``; its path.  The card's machine has no
    YAML writer: the keys are scalars, set line by line."""
    import re

    path = synthetic_config(base, data, out, name)
    with open(path) as f:
        text = f.read()
    for section, indent, keys in (("training", "  ", training), ("net_kwargs", "    ", net_kwargs),
                                  ("diffusion_kwargs", "    ", diffusion)):
        for key, value in (keys or {}).items():
            value = str(value).lower() if isinstance(value, bool) else value
            text, n = re.subn(rf"^({indent}{key}:).*$", rf"\g<1> {value}", text, flags=re.M)
            if n == 0:
                text, n = re.subn(rf"^(\s*{section}:)$", rf"\g<1>\n{indent}{key}: {value}", text,
                                  flags=re.M)
            if n != 1:
                raise RuntimeError(f"{base}: cannot set {section}.{key}")
    with open(path, "w") as f:
        f.write(text)
    return path


def trace_kernels(folder):
    """The one Chrome trace in ``folder``: (its bytes, {kernel name: events})."""
    names = [f for f in os.listdir(folder) if f.endswith(".pt.trace.json")]
    if len(names) != 1:
        raise RuntimeError(f"{folder}: expected one trace, found {names}")
    path = os.path.join(folder, names[0])
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    counts = {}
    for e in events:
        if e.get("cat") == "kernel":
            counts[e["name"]] = counts.get(e["name"], 0) + 1
    return os.path.getsize(path), counts


def phase_rest_train(torch, card, numpy_ms=None):
    """Phase 20 (a): the flagship at full width (B=128, f32) trained by
    cli/train_diffusion.py --native_loader with each REST_OPTIMIZERS entry;
    the RAdam run also with --async_checkpoints and --profile_dir /
    --profile_steps: its median ms/step outside the trace window, peak
    memory, the trace's size and kernels, its epoch-1 checkpoint written by
    the background thread; the native loader's batches/s alone beside the
    numpy DataLoader's; then an async save of a card trainer's state
    against a blocking one while the next step updates it."""
    from diffuscene_tpu_torch.cli import train_diffusion
    from diffuscene_tpu_torch.data.factory import get_dataset_raw_and_encoded
    from diffuscene_tpu_torch.data.loader import DataLoader, PackedDataLoader
    from diffuscene_tpu_torch.train.trainer import Trainer
    from diffuscene_tpu_torch.utils import checkpoint as ckpt
    from diffuscene_tpu_torch.utils.config import load_config

    out = {}
    step_s = []
    orig = Trainer.train_step

    def timed(self, *a, **k):
        t0 = time.perf_counter()
        m = orig(self, *a, **k)             # ends in its one metrics transfer
        step_s.append(time.perf_counter() - t0)
        return m

    Trainer.train_step = timed
    try:
        for tag, keys, epochs in REST_OPTIMIZERS:
            cfg_path = rest_config(f"rest_{tag}.yaml", dict(keys, save_frequency=1))
            argv = [cfg_path, REST_OUT, "--experiment_tag", tag, "--seed", str(SEED), "--epochs",
                    str(epochs), "--native_loader"]
            prof = os.path.join(REST_OUT, f"trace_{tag}")
            if tag == "radam":
                argv += ["--async_checkpoints", "--profile_dir", prof,
                         "--profile_steps", str(REST_PROFILE_STEPS)]
            del step_s[:]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            train_diffusion.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            exp = os.path.join(REST_OUT, tag)
            state, epoch = ckpt.load_checkpoint(exp)
            steps = 4 * epochs
            ok = (epoch == epochs - 1 and state["step"] == steps and len(step_s) == steps
                  and state["optimizer"]["count"] == steps
                  and all(bool(torch.isfinite(v).all()) for v in state["model"].values()))
            # the steps the trace window saw (ticks start .. start + length) ran slower
            window = range(4, 4 + REST_PROFILE_STEPS) if tag == "radam" else range(0)
            kept = sorted(v for i, v in enumerate(step_s) if i not in window and i > 0)
            info = {"keys": keys, "epochs": epochs, "steps": steps, "wall_s": wall,
                    "ms_per_step": 1e3 * kept[len(kept) // 2],
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
            if tag == "radam":
                early, _ = ckpt.load_checkpoint(exp, epoch=1)
                size, kernels = trace_kernels(prof)
                top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
                info.update(async_epoch1_step=early["step"], trace_bytes=size,
                            trace_kernel_events=sum(kernels.values()),
                            trace_top=[[k[:60], v] for k, v in top])
                ok = ok and early["step"] == 8 and sum(kernels.values()) > 0
                out["exp"] = exp
            print(f"rest train {tag} ({keys}): train_diffusion --native_loader "
                  f"{' '.join(argv[9:])}: {steps} steps in {wall:.3f} s, ms/step "
                  f"{info['ms_per_step']:.3f} (median, host clock, the trace window and the "
                  f"first step left out; phase 12's numpy-loader flagship {numpy_ms}), peak "
                  f"{info['peak_mem_gb']:.3f} GB, final loss finite; "
                  + (f"async epoch-1 checkpoint at step {info['async_epoch1_step']}, trace "
                     f"{info['trace_bytes']} bytes with {info['trace_kernel_events']} kernel "
                     f"events, most {info['trace_top'][:3]} " if tag == "radam" else "")
                  + f"{'ok' if ok else 'FAIL'} | {card}", flush=True)
            if not ok:
                raise RuntimeError(f"rest train {tag}: {info}, checkpoint epoch {epoch} step "
                                   f"{state['step']}, {len(step_s)} timed steps")
            out[tag] = info
    finally:
        Trainer.train_step = orig

    # the loader alone: batches/s over REST_LOADER_EPOCHS epochs, native vs numpy
    cfg = load_config(rest_config("rest_loader.yaml"))
    raw, ds = get_dataset_raw_and_encoded(cfg["data"], augmentations=cfg["data"]["augmentations"],
                                          split=cfg["training"]["splits"], seed=SEED)
    rates, bsz = {}, int(cfg["training"]["batch_size"])
    for name, loader in (("native", PackedDataLoader(raw, ds.bounds, ds.max_length, ds.n_classes,
                                                     bsz, seed=SEED)),
                         ("numpy", DataLoader(ds, bsz, shuffle=True, seed=SEED))):
        n, t0 = 0, time.perf_counter()
        for _ in range(REST_LOADER_EPOCHS):
            n += sum(1 for _ in loader)
        rates[name] = n / (time.perf_counter() - t0)
    out["loader_batches_per_s"] = rates
    print(f"rest loader (B={bsz}, this host): native {rates['native']:.2f} batches/s, numpy "
          f"{rates['numpy']:.2f} batches/s; a RAdam step takes {out['radam']['ms_per_step']:.1f} "
          f"ms, so the native loader needs {1e3 / rates['native']:.1f} ms a batch", flush=True)

    # an async save against a blocking one, the trainer stepping on meanwhile
    _, bsz, tr = scene_trainer(torch, rest_config("rest_async.yaml", REST_ASYNC_TRAINING),
                               DEV, REST_DATA)
    batches = PackedDataLoader(raw, ds.bounds, ds.max_length, ds.n_classes, bsz,
                               seed=SEED).infinite()
    tr.train_step(tr.put_batch(next(batches)))
    state = tr.state_dict()
    a, b = os.path.join(REST_OUT, "async_a"), os.path.join(REST_OUT, "async_b")
    ckpt.save_checkpoint(state, b, 0, blocking=True)
    t0 = time.perf_counter()
    ckpt.save_checkpoint(state, a, 0, blocking=False)
    returned_ms = 1e3 * (time.perf_counter() - t0)
    tr.train_step(tr.put_batch(next(batches)))          # updates the saved tensors in place
    ckpt.wait_for_checkpoints()
    sa, _ = ckpt.load_checkpoint(a)
    sb, _ = ckpt.load_checkpoint(b)
    same = all(torch.equal(sa["model"][k], v) for k, v in sb["model"].items()) and all(
        torch.equal(x, y) for sx, sy in zip(sa["optimizer"]["slots"], sb["optimizer"]["slots"])
        for x, y in zip(sx, sy)) and sa["step"] == sb["step"] == 1
    moved = not torch.equal(sa["model"][tr.names[0]], tr.params[0].detach().cpu())
    print(f"rest async checkpoint: returned after {returned_ms:.1f} ms, the file equals a "
          f"blocking save tensor for tensor: {same}, the trainer moved on meanwhile: {moved} "
          f"{'ok' if same and moved else 'FAIL'}", flush=True)
    if not (same and moved):
        raise RuntimeError("rest: the async checkpoint differs from the blocking one")
    out["async_equal"], out["async_return_ms"] = same, returned_ms
    del tr
    return out


def phase_rest_generate(torch, exp, card):
    """Phase 20 (b): cli/generate_diffusion.py --fused --dpm at B=256 from
    (a)'s RAdam checkpoint with --profile_dir: exactly 560 B1 and 20 B2
    launches, and the trace holds every one of them."""
    from diffuscene_tpu_torch.cli import generate_diffusion

    cfg_path = rest_config("rest_generate.yaml")
    gen_dir, prof = os.path.join(REST_OUT, "generated"), os.path.join(REST_OUT, "trace_generate")
    stats, launches, wall = eval_cli_run(torch, generate_diffusion, [
        cfg_path, gen_dir, "--weight_file", exp, "--n_sequences", str(GENERATE_B),
        "--batch_size", str(GENERATE_B), "--fused", "--dpm", "--dpm_steps", str(DPM_STEPS),
        "--profile_dir", prof])
    check_launches("rest generate", launches, (28 * DPM_STEPS, DPM_STEPS))
    size, kernels = trace_kernels(prof)
    traced = tuple(sum(v for k, v in kernels.items() if match in k)
                   for _, match in ENGINE_KERNELS["float32"])
    with open(os.path.join(gen_dir, "timing.json")) as f:
        timing = json.load(f)
    ok = traced == launches and stats["n_scenes"] == GENERATE_B
    print(f"rest generate --fused --dpm --profile_dir, B={GENERATE_B}: wall {wall:.3f} s "
          f"(sampling {timing['sample_s']:.3f} s, traced), launches B1={launches[0]} "
          f"B2={launches[1]}, the trace ({size} bytes) holds B1 {traced[0]} and B2 {traced[1]} "
          f"{'ok' if ok else 'FAIL'} | {card}", flush=True)
    if not ok:
        raise RuntimeError(f"rest generate: traced {traced}, launched {launches}")
    return {"wall_s": wall, "sample_s": timing["sample_s"], "launches": list(launches),
            "traced": list(traced), "trace_bytes": size}


def rest_scene(torch, net_kwargs, time_num, config=FLAGSHIP_CONFIG):
    """The network of ``config`` (the flagship's by default) with
    ``net_kwargs`` and a ``time_num``-step schedule, on the card, weights
    from the seed."""
    from diffuscene_tpu_torch.models import SceneDiffusion, SceneModelConfig
    from diffuscene_tpu_torch.utils.config import load_config

    net = load_config(config)["network"]
    net = dict(net, net_kwargs=dict(net["net_kwargs"], **net_kwargs),
               diffusion_kwargs=dict(net["diffusion_kwargs"], time_num=time_num))
    return SceneDiffusion(SceneModelConfig.from_config(net), device=DEV).init(
        torch.Generator().manual_seed(SEED))


def phase_rest_models(torch, card):
    """Phase 20 (c) and (d): the flagship with learned_sinusoidal_cond
    sampled by DDPM over a REST_FOURIER_STEPS-step schedule at B=64 through
    the 3-D engine (exactly 28 B1 and 1 B2 a step) and the rows engine (19
    B4 a step), each within FORWARD_TOL of the module every
    TASK_CHECK_EVERY steps; then a dim_mults (1, 2) model of dim 64 samples
    through the module forward, fused=True raises the narrowing error
    naming fused=False, and fused="rows" raises the same (its chains do not
    take unequal widths, so it falls back to the 3-D engine, as in JAX),
    with no kernel launched."""
    from diffuscene_tpu_torch.ops import attention as at
    from diffuscene_tpu_torch.ops import fused_level as fl
    from diffuscene_tpu_torch.ops import fused_resblock as rb

    out = {}
    scene = rest_scene(torch, {"learned_sinusoidal_cond": True}, REST_FOURIER_STEPS)
    if tuple(scene.denoiser.sinu_pos_emb.weights.shape) != (8,):
        raise RuntimeError("rest: the Fourier model has no learned embedding")
    gen = torch.Generator(device=DEV).manual_seed(SEED + 50)
    for label, fused in (("fourier_3d", True), ("fourier_rows", "rows")):
        _, out[label] = checked_sample(
            torch, scene, f"rest {label}", card, batch=REST_FOURIER_B, fused=fused,
            step=sampling_step(torch, scene, REST_FOURIER_B, gen, fused=fused),
            steps=REST_FOURIER_STEPS)
    del scene
    small = rest_scene(torch, {"dim": REST_MULTS_DIM, "dim_mults": [1, 2]}, REST_MULTS_STEPS)
    counters = (rb.fused_resnet_block, at.fused_set_attention, fl.apply_chain)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = small.sample(REST_MULTS_B, generator=torch.Generator(device=DEV).manual_seed(SEED),
                     fused=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    errors = {}
    for fused in (True, "rows"):
        try:
            small.sample(REST_MULTS_B, generator=torch.Generator(device=DEV).manual_seed(SEED),
                         fused=fused)
        except ValueError as e:
            errors[str(fused)] = str(e)
    launched = [c.launches for c in counters]
    ok = (tuple(x.shape) == (REST_MULTS_B, 12, 62) and bool(torch.isfinite(x).all())
          and len(errors) == 2 and all("fused=False" in e for e in errors.values())
          and errors["True"] == errors["rows"] and launched == [0, 0, 0])
    print(f"rest dim_mults (1, 2), dim {REST_MULTS_DIM}: {REST_MULTS_STEPS}-step DDPM of "
          f"{REST_MULTS_B} scenes through the module on the card in {wall:.3f} s, finite; "
          f"fused=True raises {errors.get('True')!r}; fused='rows' falls back to the 3-D engine "
          f"and raises the same: {errors.get('True') == errors.get('rows')}; launches "
          f"{launched} {'ok' if ok else 'FAIL'} | {card}", flush=True)
    if not ok:
        raise RuntimeError(f"rest dim_mults: {errors}, launches {launched}")
    out["mults12"] = {"wall_s": wall, "error": errors["True"]}
    return out


def reference_layout(torch, sd, kind):
    """A reference-layout template of a port state_dict: the scene model's
    ``diffusion.model.*`` and head keys, or a ResNet18 wrapper's
    ``_feature_extractor.*`` with each frozen running_var's eps baked in;
    torch's num_batches_tracked beside each BatchNorm of the autoencoder and
    the extractor (the export passes those through)."""
    out = {}
    for k, v in sd.items():
        v = v.detach().cpu()
        if kind == "scene":
            k = ("diffusion.model." + k[len("denoiser."):] if k.startswith("denoiser.")
                 else k[len("conditioner."):])
        elif kind == "resnet18":
            k = "_feature_extractor." + k
            v = v + 1e-5 if k.endswith("running_var") else v
        out[k] = v
        if kind != "scene" and k.endswith("running_var"):
            out[k[: -len("running_var")] + "num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return out


def phase_rest_export(torch, exp, card):
    """Phase 20 (e): (a)'s RAdam checkpoint, a shape autoencoder and a
    ResNet18 extractor with random frozen statistics, each on the card,
    through utils/export.py to the reference layout and back through the
    port's loaders: every tensor bit-equal."""
    from diffuscene_tpu_torch.models import KLAutoEncoder, SceneDiffusion, SceneModelConfig
    from diffuscene_tpu_torch.models.autoencoder import init_parameters as ae_init
    from diffuscene_tpu_torch.models.feature_extractors import get_feature_extractor
    from diffuscene_tpu_torch.utils import export
    from diffuscene_tpu_torch.utils.checkpoint import load_model_weights
    from diffuscene_tpu_torch.utils.config import load_config
    from diffuscene_tpu_torch.utils.convert import (reference_to_extractor_state_dict,
                                                    reference_to_scene_state_dict)

    scene = SceneDiffusion(SceneModelConfig.from_config(load_config(FLAGSHIP_CONFIG)["network"]),
                           device=DEV)
    scene.networks.load_state_dict(load_model_weights(exp, ema=False))
    ae = KLAutoEncoder(latent_dim=32, device=DEV)
    ae_init(ae, torch.Generator().manual_seed(SEED))
    ext = get_feature_extractor("resnet18", feature_size=64, input_channels=1, device=DEV)
    g = torch.Generator().manual_seed(SEED + 60)
    with torch.no_grad():
        for m in (ae, ext):
            for k, v in m.state_dict().items():
                if k.endswith("running_var"):
                    v.copy_(0.5 + torch.rand(v.shape, generator=g))
                elif k.endswith("running_mean") or (m is ext and v.is_floating_point()):
                    v.copy_(0.1 * torch.randn(v.shape, generator=g))
    cases = (("scene", scene.networks.state_dict(), export.export_scene_model,
              reference_to_scene_state_dict),
             ("autoencoder", ae.state_dict(), export.export_autoencoder,
              lambda sd: {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}),
             ("resnet18", ext.state_dict(), export.export_feature_extractor,
              reference_to_extractor_state_dict))
    out = {}
    for name, sd, fwd_export, load in cases:
        t0 = time.perf_counter()
        ref = fwd_export(sd, reference_layout(torch, sd, name))
        back = load(ref)
        wall = time.perf_counter() - t0
        keys = [k for k in sd if not k.endswith("num_batches_tracked")]
        same = sorted(back) == sorted(keys) and all(
            torch.equal(back[k].to(DEV), sd[k]) for k in keys)
        print(f"rest export {name}: {len(keys)} tensors on the card -> reference layout "
              f"({len(ref)} keys) -> back, bit-equal: {same} ({wall:.3f} s) "
              f"{'ok' if same else 'FAIL'} | {card}", flush=True)
        if not same:
            bad = [k for k in keys if k not in back or not torch.equal(back[k].to(DEV), sd[k])]
            raise RuntimeError(f"rest export {name}: {bad[:5]} differ")
        out[name] = {"tensors": len(keys), "reference_keys": len(ref), "s": wall}
    return out


def phase_rest(torch, card, numpy_ms=None):
    """Phase 20: the single-card modules ported last, on a synthetic cached
    dataset made from the seed."""
    import shutil

    from diffuscene_tpu_torch.data import make_synthetic_cached_dataset
    from diffuscene_tpu_torch.ops import chamfer as ch

    t0 = time.perf_counter()
    ch.directed_nn.launches = 0     # no scene-model path of phase 20 runs the chamfer
    for d in (REST_DATA, REST_OUT):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(REST_OUT)
    make_synthetic_cached_dataset(REST_DATA, n_scenes=REST_SCENES, seed=SEED)
    out = {"card": card, "train": phase_rest_train(torch, card, numpy_ms)}
    exp = out["train"].pop("exp")
    torch.cuda.empty_cache()
    out["generate"] = phase_rest_generate(torch, exp, card)
    torch.cuda.empty_cache()
    out["samples"] = phase_rest_models(torch, card)
    torch.cuda.empty_cache()
    out["export"] = phase_rest_export(torch, exp, card)
    out["chamfer_launches"] = ch.directed_nn.launches
    if out["chamfer_launches"] != 0:
        raise RuntimeError(f"rest: {out['chamfer_launches']} chamfer-kernel launches, expected 0")
    out["phase_s"] = time.perf_counter() - t0
    print(f"rest: phase 20 took {out['phase_s']:.1f} s", flush=True)
    return out


def par_bounds():
    import numpy as np

    (t_lo, t_hi), (s_lo, s_hi) = DRIFT_BOUNDS["translations"], DRIFT_BOUNDS["sizes"]
    return {"translations_min": np.array(t_lo, np.float32),
            "translations_max": np.array(t_hi, np.float32),
            "sizes_min": np.array(s_lo, np.float32), "sizes_max": np.array(s_hi, np.float32)}


def par_batch(torch, n, seed):
    """``n`` random encoded bedrooms (attributes in [-1, 1], {-1, +1} class
    one-hots with the last three slots empty), the global batch's t and
    noise: the same on every rank."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 22, (n, 12))
    cls[:, -3:] = 21
    batch = {"translations": rng.uniform(-1, 1, (n, 12, 3)).astype(np.float32),
             "sizes": rng.uniform(-1, 1, (n, 12, 3)).astype(np.float32),
             "angles": rng.uniform(-1, 1, (n, 12, 2)).astype(np.float32),
             "class_labels": (np.eye(22)[cls] * 2 - 1).astype(np.float32),
             "objfeats_32": rng.normal(0, 1, (n, 12, 32)).astype(np.float32)}
    t = torch.from_numpy(rng.integers(0, T, n)).to(DEV)
    noise = torch.from_numpy(rng.normal(size=(n, 12, 62)).astype(np.float32)).to(DEV)
    return batch, t, noise


def par_trainer(torch, config_path, mesh, **kw):
    """A config's scene Trainer on the card over ``mesh``, weights from the
    seed."""
    from diffuscene_tpu_torch.models import SceneDiffusion, SceneModelConfig
    from diffuscene_tpu_torch.train.trainer import Trainer
    from diffuscene_tpu_torch.utils.config import load_config

    cfg = load_config(config_path)
    net = dict(cfg["network"], sample_num_points=12)
    scene = SceneDiffusion(SceneModelConfig.from_config(net), bounds=par_bounds(), device=DEV)
    return Trainer(scene, cfg["training"], device=DEV, mesh=mesh, **kw).init(SEED)


def par_step(torch, trainer, seed=SEED + 40):
    batch, t, noise = par_batch(torch, 128, seed)
    return trainer.train_step(trainer.put_batch(batch), t=t, noise=noise)


def par_params(trainer):
    """The trainer's full parameters on the host (a collective call under
    tensor parallelism)."""
    return {n: v.detach().float().cpu() for n, v in trainer.state_dict()["model"].items()}


def par_apart(got, want, lr, tol):
    """(the largest difference in lr, the share more than tol's loose_lr *
    lr apart) of two parameter dicts on the host."""
    import numpy as np

    d = np.concatenate([(got[k] - want[k]).abs().numpy().ravel() for k in want])
    return float(d.max() / lr), float((d > tol["loose_lr"] * lr).mean())


def par_check(label, worst, loose, tol):
    if worst > tol["max_lr"] or loose >= tol["loose_share"]:
        raise RuntimeError(f"{label}: parameters apart by up to {worst} lr, {loose} of them more "
                           f"than {tol['loose_lr']} lr (tolerance {tol})")


def par_sample(torch, scene, fused, sampler=None):
    """DPM-Solver++-20 of PAR_SAMPLE_B scenes from the seed, through
    ``sampler`` (a ShardedSampler) or SceneDiffusion.sample."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 41)
    if sampler is not None:
        return sampler.sample(PAR_SAMPLE_B, gen)
    return scene.sample(PAR_SAMPLE_B, generator=gen, clip_denoised=True, fused=fused, dpm=True,
                        dpm_steps=DPM_STEPS)


def par_ae(torch, mesh):
    """The shape AE's trainer at full width over ``mesh``, its clouds and
    noise (the global batch's)."""
    from diffuscene_tpu_torch.models.autoencoder import build_autoencoder
    from diffuscene_tpu_torch.train.ae_trainer import AETrainer
    from diffuscene_tpu_torch.utils.config import load_config

    cfg = load_config(AE_CONFIG)
    batch = int(cfg["training"]["batch_size"])
    model = build_autoencoder(cfg["network"], device=DEV)
    trainer = AETrainer(model, cfg["training"], device=DEV, mesh=mesh,
                        steps_per_epoch=int(cfg["training"]["steps_per_epoch"])).init(SEED)
    eps = torch.randn(batch, model.latent_dim, generator=torch.Generator().manual_seed(SEED + 42))
    return trainer, box_clouds(batch, AE_POINTS, SEED + 43), eps.to(DEV)


def launch_counts():
    from diffuscene_tpu_torch.ops import attention as at
    from diffuscene_tpu_torch.ops import chamfer as ch
    from diffuscene_tpu_torch.ops import fused_level as fl
    from diffuscene_tpu_torch.ops import fused_resblock as rb

    return {"B1": rb.fused_resnet_block.launches, "B2": at.fused_set_attention.launches,
            "B3": ch.directed_nn.launches, "B4": fl.apply_chain.launches}


def zero_launches():
    from diffuscene_tpu_torch.ops import attention as at
    from diffuscene_tpu_torch.ops import chamfer as ch
    from diffuscene_tpu_torch.ops import fused_level as fl
    from diffuscene_tpu_torch.ops import fused_resblock as rb

    rb.fused_resnet_block.launches = at.fused_set_attention.launches = 0
    ch.directed_nn.launches = fl.apply_chain.launches = 0


def counted(fn):
    """(fn(), the kernel launches it made)."""
    zero_launches()
    out = fn()
    return out, launch_counts()


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parallel_rank(workdir, rank, world, port, backend):
    """One rank of phase 21(b) on the one card (a process of its own):
    gloo: the data- and tensor-parallel flagship steps, the sharded samples
    through both engines and the data-parallel AE step, each path's launches
    counted from 0; nccl: only the start, which must raise."""
    import torch

    from diffuscene_tpu_torch.models.autoencoder import BatchNorm
    from diffuscene_tpu_torch.ops import attention as at
    from diffuscene_tpu_torch.ops import chamfer as ch
    from diffuscene_tpu_torch.ops import fused_level as fl
    from diffuscene_tpu_torch.ops import fused_resblock as rb
    from diffuscene_tpu_torch.parallel import ShardedSampler, initialize, make_mesh, shutdown
    from diffuscene_tpu_torch.utils.config import load_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize(backend=backend, device="cuda:0", init_method=f"tcp://127.0.0.1:{port}",
               world_size=world, rank=rank, timeout_s=PAR_TIMEOUT)
    try:
        for mod in (fl, ch, rb, at):
            mod.load_library()
        out = {}
        ref = torch.load(os.path.join(workdir, "ref_step.pt"), weights_only=False)
        lr = float(load_config(FLAGSHIP_CONFIG)["training"]["lr"])
        for label, shape, tp in (("dp", (2, 1), False), ("tp", (1, 2), True)):
            tr = par_trainer(torch, FLAGSHIP_CONFIG, make_mesh(*shape), tensor_parallel=tp)
            m, launches = counted(lambda: par_step(torch, tr))
            worst, loose = par_apart(par_params(tr), ref, lr, PAR_STEP_TOL)
            out[label] = {"metrics": m, "param_max_lr": worst, "param_loose": loose,
                          "launches": launches, "sharded": len(tr._sharded),
                          "rank_numel": sum(p.numel() for p in tr.params)}
            del tr
            torch.cuda.empty_cache()
        scene = flagship(torch, torch.float32)
        mesh = make_mesh()
        for fused in (True, "rows"):
            sampler = ShardedSampler(scene, mesh, dpm=True, dpm_steps=DPM_STEPS,
                                     fused=fused).put_params()
            x, launches = counted(lambda: par_sample(torch, scene, fused, sampler))
            out[f"sample_{fused}"] = {"x": x.cpu(), "launches": launches}
        del scene
        ae, clouds, eps = par_ae(torch, mesh)
        m, launches = counted(lambda: ae.train_step(ae.put_batch(clouds), eps=eps))
        out["ae"] = {"metrics": m, "launches": launches}
        # the fault the AE bound must catch: each rank's BatchNorm moments
        # over its own 8 clouds
        ae, clouds, eps = par_ae(torch, mesh)
        for mod in ae.model.modules():
            if isinstance(mod, BatchNorm):
                mod.sync = None
        out["ae_local_moments"] = ae.train_step(ae.put_batch(clouds), eps=eps)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        shutdown()


def spawn_ranks(workdir, backend, world=2):
    """Start ``world`` ranks of parallel_rank on the card -> [(exit code,
    stderr)], each killed at PAR_TIMEOUT."""
    port = free_port()
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys, chip_smoke as s; "
            "s.parallel_rank(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), "
            "sys.argv[5])")
    procs = [subprocess.Popen([sys.executable, "-c", code, workdir, str(r), str(world), str(port),
                               backend], cwd=here, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]
    out = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=PAR_TIMEOUT)
            out.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def par_cli(torch):
    """train_diffusion --mixed_precision under torchrun (one process, the
    card), PAR_CLI_EPOCHS epochs of the flagship config on PAR_CLI_SCENES
    synthetic rooms: an NCCL group of one rank (the CLI says so), every
    step's gradient all-reduced over it, exit 0, a final checkpoint with
    f32 weights."""
    from diffuscene_tpu_torch.data import make_synthetic_cached_dataset
    from diffuscene_tpu_torch.utils.checkpoint import load_checkpoint

    data, out = os.path.join(PAR_DIR, "data"), os.path.join(PAR_DIR, "cli")
    os.makedirs(out)
    make_synthetic_cached_dataset(data, n_scenes=PAR_CLI_SCENES, seed=SEED)
    cfg = synthetic_config(FLAGSHIP_CONFIG, os.path.abspath(data), out, "flagship.yaml")
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=1",
                          "-m", "diffuscene_tpu_torch.cli.train_diffusion", cfg, out,
                          "--experiment_tag", "mp", "--epochs", str(PAR_CLI_EPOCHS),
                          "--mixed_precision"], cwd=here, capture_output=True, text=True,
                         timeout=PAR_TIMEOUT)
    wall_s = time.perf_counter() - t0
    state, epoch = load_checkpoint(os.path.join(out, "mp")) if run.returncode == 0 else (None, None)
    grouped = "data-parallel over 1 rank(s), nccl" in run.stdout
    ok = (grouped and state is not None and epoch == PAR_CLI_EPOCHS - 1
          and {v.dtype for v in state["model"].values()} == {torch.float32})
    print(f"parallel: torchrun --nproc_per_node=1 train_diffusion --mixed_precision, "
          f"{PAR_CLI_EPOCHS} epochs of {PAR_CLI_SCENES} rooms: exit {run.returncode}, "
          f"{wall_s:.1f} s, NCCL group of one rank {grouped}, final step "
          f"{state and state['step']} {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise RuntimeError(f"the mixed-precision train CLI failed:\n{run.stderr[-3000:]}")
    return {"wall_s": wall_s, "steps": state["step"], "nccl_group": grouped}


def phase_parallel(torch, card, b512_plain=None):
    """Phase 21: parallel/* on the card: (a) an NCCL group of one rank, (b)
    two gloo ranks on the one card (and NCCL refusing them), (c) the b512
    recipe's step with mixed_precision beside its plain bf16 step."""
    import shutil

    import numpy as np

    from diffuscene_tpu_torch.parallel import Mesh, ShardedSampler, initialize, make_mesh, shutdown
    from diffuscene_tpu_torch.utils.config import load_config

    import gc
    import resource

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"parallel: at the start, host max RSS "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20:.2f} GB, card "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GB allocated, "
          f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GB reserved", flush=True)
    shutil.rmtree(PAR_DIR, ignore_errors=True)
    os.makedirs(PAR_DIR)
    out = {"card": card}

    # (a) one NCCL rank against no process group, bit for bit
    initialize(backend="nccl", device="cuda:0", init_method=f"tcp://127.0.0.1:{free_port()}",
               world_size=1, rank=0)
    try:
        mesh = make_mesh()
        if not mesh.distributed:
            raise RuntimeError("the one-rank NCCL mesh is not distributed")
        one = par_trainer(torch, FLAGSHIP_CONFIG, mesh)
        m_one, launches = counted(lambda: par_step(torch, one))
        p_one = par_params(one)
        del one
        ref = par_trainer(torch, FLAGSHIP_CONFIG, Mesh(1, 1))
        m_ref = par_step(torch, ref)
        p_ref = par_params(ref)
        n_params = sum(p.numel() for p in ref.params)
        del ref
        torch.save(p_ref, os.path.join(PAR_DIR, "ref_step.pt"))     # for the two ranks
        torch.cuda.empty_cache()
        equal = m_one == m_ref and all(torch.equal(p_one[k], p_ref[k]) for k in p_ref)
        print(f"parallel: one NCCL rank vs no group, flagship step B=128 f32: loss "
              f"{m_one['loss']:.7f} vs {m_ref['loss']:.7f}, gradnorm {m_one['gradnorm']:.6f} vs "
              f"{m_ref['gradnorm']:.6f}, parameters bit-equal {equal}, launches {launches}",
              flush=True)
        if not equal:
            raise RuntimeError("the one-rank NCCL step differs from the non-distributed step")
        scene = flagship(torch, torch.float32)
        sampler = ShardedSampler(scene, mesh, dpm=True, dpm_steps=DPM_STEPS, fused=True)
        x_one, launches = counted(lambda: par_sample(torch, scene, True, sampler))
        x_ref = {fused: par_sample(torch, scene, fused).cpu() for fused in (True, "rows")}
        del scene
        same = torch.equal(x_one.cpu(), x_ref[True])
        want = {"B1": 28 * DPM_STEPS, "B2": DPM_STEPS, "B3": 0, "B4": 0}
        print(f"parallel: one NCCL rank, ShardedSampler(fused=True) DPM-Solver++-{DPM_STEPS} "
              f"B={PAR_SAMPLE_B} vs SceneDiffusion.sample: bit-equal {same}, launches "
              f"{launches}", flush=True)
        if not same or launches != want:
            raise RuntimeError(f"the one-rank sharded sample differs ({same}) or launched "
                               f"{launches}, expected {want}")
        out["nccl_one_rank"] = {"step_equal": equal, "sample_equal": same, "launches": launches}
        ae, clouds, eps = par_ae(torch, Mesh(1, 1))
        m_ae = ae.train_step(ae.put_batch(clouds), eps=eps)
        # the witness of f32 reordering noise: the same step on the clouds
        # in reverse order (the same loss and gradients in exact arithmetic)
        ae, clouds, eps = par_ae(torch, Mesh(1, 1))
        m_ae_rev = ae.train_step(ae.put_batch(clouds[::-1].copy()), eps=eps.flip(0))
        del ae
    finally:
        shutdown()
    torch.cuda.empty_cache()

    # (b) two gloo ranks on the one card, each its half of every batch
    t1 = time.perf_counter()
    results = spawn_ranks(PAR_DIR, "gloo")
    for r, (code, err) in enumerate(results):
        if code != 0:
            raise RuntimeError(f"gloo rank {r} exited {code}:\n{err[-4000:]}")
    ranks = [torch.load(os.path.join(PAR_DIR, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    spawn_s = time.perf_counter() - t1
    two = {"spawn_s": spawn_s}
    for label in ("dp", "tp"):
        for r, res in enumerate(ranks):
            m = res[label]["metrics"]
            rel = {k: abs(m[k] - m_ref[k]) / max(abs(m_ref[k]), 1e-12) for k in m_ref}
            worst_rel = max(rel.values())
            worst, loose = res[label]["param_max_lr"], res[label]["param_loose"]
            print(f"parallel: 2 gloo ranks {label} rank {r} vs one rank, flagship step B=128: "
                  f"loss {m['loss']:.7f} vs {m_ref['loss']:.7f}, worst relative metric "
                  f"{worst_rel:.3e}, parameters up to {worst:.3f} lr, {loose:.2e} beyond "
                  f"{PAR_STEP_TOL['loose_lr']} lr, sharded kernels {res[label]['sharded']}, "
                  f"{res[label]['rank_numel']} of {n_params} parameters on the rank, launches "
                  f"{res[label]['launches']}", flush=True)
            if worst_rel > PAR_STEP_TOL["loss"]:
                raise RuntimeError(f"the {label} step's metrics differ: {rel}")
            par_check(f"the {label} step", worst, loose, PAR_STEP_TOL)
            if label == "tp" and not res[label]["rank_numel"] < n_params:
                raise RuntimeError("tensor parallelism sharded no kernel")
        two[label] = {"loss_rel": worst_rel, "param_max_lr": worst, "param_loose": loose,
                      "rank_numel": res[label]["rank_numel"], "numel": n_params}
    engines = {True: ("B1", "B2"), "rows": ("B4",)}
    for fused, names in engines.items():
        want = {"B1": 0, "B2": 0, "B3": 0, "B4": 0}
        if fused is True:
            want.update(B1=28 * DPM_STEPS, B2=DPM_STEPS)
        else:
            want.update(B4=19 * DPM_STEPS)
        x = ranks[0][f"sample_{fused}"]["x"]
        err = (x - x_ref[fused]).abs().max().item()
        agree = bool((x[..., 8:30].argmax(-1) == x_ref[fused][..., 8:30].argmax(-1)).all())
        counts = [res[f"sample_{fused}"]["launches"] for res in ranks]
        print(f"parallel: 2 gloo ranks, ShardedSampler(fused={fused!r}) DPM-Solver++-{DPM_STEPS} "
              f"B={PAR_SAMPLE_B} (32 a rank) vs one rank: max abs {err:.3e} (tol "
              f"{FORWARD_TOL['float32']}), argmax classes equal {agree}, launches a rank "
              f"{counts}", flush=True)
        if err > FORWARD_TOL["float32"] or not agree or any(c != want for c in counts) or \
                not torch.equal(x, ranks[1][f"sample_{fused}"]["x"]):
            raise RuntimeError(f"the two-rank sample (fused={fused!r}) is off: {err}, {agree}, "
                               f"launches {counts} (expected {want} a rank)")
        two[f"sample_{fused}"] = {"max_abs": err, "launches": counts[0]}
    ae_rel = lambda m: {k: abs(m[k] - m_ae[k]) / abs(m_ae[k]) for k in PAR_AE_TOL}
    rel_rev = ae_rel(m_ae_rev)
    print(f"parallel: one rank, AE step B=16 on the clouds reversed vs in order (f32 "
          f"reordering noise): relative {rel_rev}", flush=True)
    for r, res in enumerate(ranks):
        m = res["ae"]["metrics"]
        rel, rel_local = ae_rel(m), ae_rel(res["ae_local_moments"])
        print(f"parallel: 2 gloo ranks, AE step B=16 (8 a rank) rank {r} vs one rank: loss "
              f"{m['loss']:.7f} vs {m_ae['loss']:.7f}, relative {rel}, launches "
              f"{res['ae']['launches']}; with each rank's own BatchNorm moments (the fault): "
              f"relative {rel_local}", flush=True)
        if any(rel[k] > PAR_AE_TOL[k] for k in PAR_AE_TOL) or res["ae"]["launches"]["B3"] != 2:
            raise RuntimeError(f"the two-rank AE step is off: {rel}, {res['ae']['launches']}")
        if all(rel_local[k] <= PAR_AE_TOL[k] for k in PAR_AE_TOL):
            raise RuntimeError(f"the AE bound does not catch local BatchNorm moments: "
                               f"{rel_local}")
    two["ae"] = {"rel": rel, "rel_reversed_one_rank": rel_rev, "rel_local_moments": rel_local,
                 "launches": ranks[0]["ae"]["launches"]}
    nccl = spawn_ranks(PAR_DIR, "nccl")
    refused = all(code != 0 and "same device" in err for code, err in nccl)
    print(f"parallel: NCCL asked for 2 ranks on the one card: exit codes "
          f"{[c for c, _ in nccl]}, refused {refused}", flush=True)
    if not refused:
        raise RuntimeError(f"NCCL took two ranks on one card: {[e[-600:] for _, e in nccl]}")
    two["nccl_two_ranks_refused"] = refused
    out["two_ranks"] = two

    # (c) mixed precision on the b512 recipe, beside its plain bf16 step, in
    # turns (plain, mixed, mixed, plain), each from a fresh trainer
    mp = {"plain": {"ms": [], "peak_mem_gb": []}, "mixed_precision": {"ms": [], "peak_mem_gb": []}}
    b512_lr = float(load_config(B512_CONFIG)["training"]["lr"])
    batch, t, noise = par_batch(torch, 512, SEED + 44)
    for label in ("plain", "mixed_precision", "mixed_precision", "plain"):
        tr = par_trainer(torch, B512_CONFIG, Mesh(1, 1), mixed_precision=label != "plain")
        dev_batch = tr.put_batch(batch)
        first = tr.train_step(dev_batch, t=t, noise=noise)
        if "first" not in mp[label]:
            mp[label].update(first=first, params=par_params(tr))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(PAR_MP_STEPS):
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            m = tr.train_step(dev_batch)
            mp[label]["ms"].append(1e3 * (time.perf_counter() - t2))
            if not math.isfinite(m["loss"]):
                raise RuntimeError(f"the {label} b512 step's loss is not finite")
        mp[label]["peak_mem_gb"].append(torch.cuda.max_memory_allocated() / 2 ** 30)
        del tr
        torch.cuda.empty_cache()
    for side in mp.values():
        side["ms_per_step"] = sorted(side["ms"])[len(side["ms"]) // 2]
    worst, loose = par_apart(mp["mixed_precision"].pop("params"), mp["plain"].pop("params"),
                             b512_lr, PAR_MP_TOL)
    par_check("mixed_precision vs plain", worst, loose, PAR_MP_TOL)
    l_mp, l_plain = mp["mixed_precision"]["first"]["loss"], mp["plain"]["first"]["loss"]
    rel_loss = abs(l_mp - l_plain) / abs(l_plain)
    print(f"parallel: b512 recipe B=512 bf16, mixed_precision vs plain from one state: loss "
          f"{l_mp:.6f} vs {l_plain:.6f} (relative {rel_loss:.3e}), parameters up to "
          f"{worst:.3f} lr, {loose:.2e} beyond {PAR_MP_TOL['loose_lr']} lr; ms/step "
          f"{mp['mixed_precision']['ms_per_step']:.3f} vs {mp['plain']['ms_per_step']:.3f} "
          f"(medians of {2 * PAR_MP_STEPS} steps each, in turns; phase 13: {b512_plain}), peak "
          f"memory {mp['mixed_precision']['peak_mem_gb']} vs {mp['plain']['peak_mem_gb']} GB",
          flush=True)
    if rel_loss > PAR_MP_TOL["loss"]:
        raise RuntimeError(f"the mixed-precision step is off: loss {rel_loss}")
    # and it must have cast: a step on the same weights that did not round
    # them to bf16 would equal the plain step
    if rel_loss == 0.0 or worst == 0.0:
        raise RuntimeError(f"the mixed-precision step equals the plain one (loss gap "
                           f"{rel_loss}, parameters up to {worst} lr apart): no bf16 cast")
    mp.update(loss_rel=rel_loss, param_max_lr=worst, param_loose=loose,
              phase13_ms_per_step=b512_plain, cli=par_cli(torch))
    out["mixed_precision"] = mp
    out["phase_s"] = time.perf_counter() - t0
    print(f"parallel: phase 21 took {out['phase_s']:.1f} s", flush=True)
    return out


def wide_ptxas(lib_path, match):
    """The ptxas registers and spills of the kernels whose name holds ``match``."""
    ptxas = lib_path.with_suffix(".ptxas.txt")
    for name, regs, spill in ptxas_summary(ptxas.read_text() if ptxas.exists() else ""):
        if match in name:
            print(f"ptxas {name}: {regs} | {spill}", flush=True)


def wide_forward(rb, torch, mults, groups, seed, dtype):
    """The 28 B1 blocks of one forward of the flagship with ``mults`` and
    ``groups`` in ``dtype`` at B=64, N=12 (inference.block_shapes; block0s
    with per-object film rows, the rest per-scene), each block shape timed
    once and counted as often as the forward runs it: eager, graph-replay,
    device, plain and bound ms, the sums by C.  Returns (worst error,
    sums)."""
    from diffuscene_tpu_torch.models import Unet1D
    from diffuscene_tpu_torch.models.inference import block_shapes

    dname = str(dtype).split(".")[-1]
    shapes = block_shapes(Unet1D(dim=512, dim_mults=mults, resnet_block_groups=groups,
                                 device="meta"))
    counts = {}
    for i, (c, kx, ks) in enumerate(shapes):
        key = (c, kx, ks, "row" if i % 3 == 0 and i < len(shapes) - 1 else "scene")
        counts[key] = counts.get(key, 0) + 1
    sums, worst, bad = {}, 0.0, []
    for (c, kx, ks, film), k in sorted(counts.items()):
        case = (film, kx, ks, c, groups)
        seed += 1
        ok, err, tm, (flops, nbytes) = rb_check(rb, torch, case, 12, dtype, seed)
        worst = max(worst, err)
        if not ok:
            bad.append((case, err))
        b_ms = kernel_bound(dname, flops, nbytes)[0]
        kernel = rb.kernel_name(dtype, c, groups, kx, ks, kx + ks != c)
        print(f"kernel fused_resblock {dname} {kernel} C={c} groups={groups} C_in={kx}+{ks} "
              f"film={film} x{k} a forward, N=12 B={B}: max_abs_err={err:.3e} "
              f"{'ok' if ok else 'FAIL'} kernel_ms={tm['ms']:.4f} graph_ms={tm['graph']:.4f} "
              f"device_ms={tm['dev']:.4f} plain_ms={tm['plain']:.4f} bound_ms={b_ms:.4f} "
              f"({flops / 1e9:.3f} GFLOP)", flush=True)
        for part in ("all", f"C={c}"):
            s = sums.setdefault(part, dict(ms=0.0, graph=0.0, dev=0.0, plain=0.0, flops=0,
                                           bytes=0, blocks=0))
            for f in ("ms", "graph", "dev", "plain"):
                s[f] += k * tm[f]
            s["flops"] += k * flops
            s["bytes"] += k * nbytes
            s["blocks"] += k
    if bad:
        raise RuntimeError(f"wide: {dname} B1 disagrees with its plain version: {bad}")
    for part, s in sums.items():
        s["bound_ms"], s["bound_by"], s["fp32_ms"] = kernel_bound(dname, s["flops"], s["bytes"])
        route = ("on the bf16 tensor cores" if s["fp32_ms"] is None else
                 f"on the split-TF32 route ({s['fp32_ms']:.4f} at the FP32 rate)")
        print(f"ResnetBlocks of one forward, dim_mults {list(mults)}, {groups} groups, {dname}, "
              f"N=12, B={B}, {part} ({s['blocks']} blocks): kernel {s['ms']:.3f} ms (eager), "
              f"graph replay {s['graph']:.3f} ms, device {s['dev']:.3f} ms, plain "
              f"{s['plain']:.3f} ms, bound {s['bound_ms']:.4f} ms {route} ({s['bound_by']}; "
              f"{s['flops'] / 1e9:.2f} GFLOP, {s['bytes'] / 1e6:.2f} MB)", flush=True)
    return worst, sums


def wide_b1_set(rb, torch, dtype, seed):
    """Phase 22 (a), B1: every (C, groups) of the set in ``dtype`` with film
    rows, per scene and none, identity residuals (over x, and over [x |
    skip]) and projections, inputs up to 2048 wide, B in (7, 256) and N in
    (12, 21), against the plain version, with each launch plan.  Returns
    (worst error, the failures)."""
    from diffuscene_tpu_torch.ops import build

    rlib, code = rb.load_library(), build.DTYPE_CODES[dtype]
    dname = str(dtype).split(".")[-1]
    worst, bad = 0.0, []
    for C, groups in WIDE_B1_SET:
        for film, kx, ks, batch, n in (("row", C, 0, 7, 12), ("scene", C, 2048 - C, 256, 21),
                                       ("none", C // 2, C // 2, 7, 21),
                                       ("scene", 2 * C if C < 1024 else 512, 0, 256, 12)):
            seed += 1
            case, res = (film, kx, ks, C, groups), kx + ks != C
            p = rb.tile_plan(batch, n, kx, ks, dtype, C, groups, res)
            fit = rlib.fused_resblock_max_active_clusters(code, C, groups, kx, ks, int(res))
            lib_smem = rlib.fused_resblock_smem_bytes(code, C, groups, kx, ks, int(res))
            ok, err, _, _ = rb_check(rb, torch, case, n, dtype, seed, batch=batch, timed=False)
            ok = ok and fit >= 1 and lib_smem == p.smem_bytes
            worst = max(worst, err)
            print(f"kernel fused_resblock {dname} {rb.kernel_name(dtype, C, groups, kx, ks, res)} "
                  f"C={C} groups={groups} C_in={kx}+{ks} {'projection' if res else 'identity'} "
                  f"film={film} N={n} B={batch}: {p.scenes_per_tile} scenes ({p.scenes_per_tile * n} "
                  f"rows) a tile, {p.clusters} clusters of {p.ctas // p.clusters} CTAs, "
                  f"{p.smem_bytes} bytes of shared memory a CTA (library {lib_smem}), {fit} "
                  f"clusters fit at once; max_abs_err={err:.3e} tol={KERNEL_TOL[dname]} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                bad.append((dname, case, n, batch, err, fit))
    return worst, bad


def wide_b2_set(at, torch, dtype, out):
    """Phase 22 (a), B2: every C of the set in ``dtype`` (eps: the engine's,
    1e-5 f32, 1e-3 bf16), N in (12, 21, 24) and B in (7, 64, 256), against
    the plain version, with each plan; the call at (64, 12, C) timed into
    ``out``, and at C=512 the dtype's wide kernel beside its C=512 kernel
    (wide_b2_at_512).  Returns (worst error, the failures)."""
    from diffuscene_tpu_torch.ops import build

    alib, code = at.load_library(), build.DTYPE_CODES[dtype]
    dname = str(dtype).split(".")[-1]
    f32 = dtype == torch.float32
    hd = ATTN_HEADS * ATTN_DIM_HEAD
    g = torch.Generator(device=DEV).manual_seed(SEED + 70 + code)
    worst, bad = 0.0, []

    def rnd(*shape, scale=1.0, base=0.0):
        return base + scale * torch.randn(*shape, generator=g, device=DEV)

    for C in WIDE_B2_C:
        p = at.tile_plan(B, 12, dtype=dtype, C=C)
        print(f"plan set_attention {dname} {at.kernel_name(dtype, C)} C={C} N=12 B={B}: "
              f"{p.tiles} tiles, {p.clusters} clusters of {at.HEADS} = {p.ctas} CTAs, "
              f"{p.smem_bytes} bytes of shared memory a CTA (library "
              f"{alib.set_attention_smem_bytes(code, C)}), "
              f"{alib.set_attention_max_active_clusters(code, C)} clusters fit at once, "
              f"{p.weight_bytes / 1e6:.2f} MB of weights read a call", flush=True)
        for n in (12, 21, 24):
            for batch in (7, B, GENERATE_B):
                args = (rnd(batch, n, C).to(dtype), rnd(C, scale=0.2, base=1.0),
                        rnd(C, 3 * hd, scale=C ** -0.5).to(dtype),
                        rnd(hd, C, scale=hd ** -0.5).to(dtype), rnd(C, scale=0.1))
                kw = dict(eps=1e-5 if f32 else 1e-3, compute_dtype=dtype)
                got = at.fused_set_attention(*args, **kw)
                want = at.fused_set_attention_reference(*args, **kw)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                ok = (bool(torch.isfinite(got.float()).all())
                      and torch.allclose(got.float(), want.float(), **KERNEL_TOL[dname]))
                worst = max(worst, err)
                line = (f"kernel set_attention {dname} C={C} N={n} B={batch}: max_abs_err="
                        f"{err:.3e} {'ok' if ok else 'FAIL'}")
                if not ok:
                    bad.append(("B2", dname, C, n, batch, err))
                if (n, batch) == (12, B):
                    def call():
                        return at.fused_set_attention(*args, **kw)

                    M = batch * n
                    mm = 2 * M * C * 3 * hd + 2 * M * hd * C
                    attn = 4 * batch * ATTN_HEADS * n * n * ATTN_DIM_HEAD
                    nbytes = (2 * args[0].numel() * args[0].element_size()
                              + sum(a.numel() * a.element_size() for a in args[1:]))
                    b_ms, b_by = (bound(0, nbytes, attn, tf32_flops=TF32_SPLIT * mm) if f32
                                  else bound(mm, nbytes, attn))
                    tm = dict(ms=cuda_ms(call), graph=graph_ms(torch, call),
                              dev=device_ms(torch, call, "attention"),
                              plain=cuda_ms(lambda: at.fused_set_attention_reference(*args, **kw)),
                              bound_ms=b_ms, bound_by=b_by, gflop=(mm + attn) / 1e9,
                              mbytes=nbytes / 1e6)
                    out[C] = tm
                    line += (f" kernel_ms={tm['ms']:.4f} graph_ms={tm['graph']:.4f} "
                             f"device_ms={tm['dev']:.4f} plain_ms={tm['plain']:.4f} "
                             f"bound_ms={b_ms:.5f} ({b_by}; {'3xTF32; ' if f32 else ''}"
                             f"{mm / 1e9:.3f} GFLOP of products, {nbytes / 1e6:.2f} MB)")
                    if C == at.CHANNELS:
                        print(line, flush=True)
                        line, wide = wide_b2_at_512(at, torch, args, kw, want, tm)
                        out["512 wide"] = wide
                        if not wide["ok"]:
                            bad.append(("B2 wide at 512", dname, C, n, batch, wide["err"]))
                print(line, flush=True)
    return worst, bad


def wide_kernels(rb, at, torch):
    """Phase 22 (a) and (e), in f32 and in bf16: B1 at every (C, groups) of
    the set (wide_b1_set), B2 at every C of it (wide_b2_set); the wide
    kernels' ptxas report; the 28 blocks of the wide flagship's and of the
    4-, 8- and 16-group flagships' forwards timed (wide_forward); the
    C=512 8-group figures against PERF.md's.  Returns the summary."""
    from diffuscene_tpu_torch.ops import build

    wide_ptxas(build.library_path(rb.CSRC), "wide")
    wide_ptxas(build.library_path(at.CSRC), "wide")
    out, bad, seed = {}, [], 700
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        w1, b = wide_b1_set(rb, torch, dtype, seed)
        seed += 100
        bad += b
        mine = out[dname] = {"b1": {}, "b2": {}, "b1_set_worst": w1}
        for label, mults, groups in (("wide", WIDE_MULTS, 8), ("groups8", (1, 1, 1, 1), 8),
                                     ("groups4", (1, 1, 1, 1), 4), ("groups16", (1, 1, 1, 1), 16)):
            w, mine["b1"][label] = wide_forward(rb, torch, mults, groups, seed, dtype)
            seed += 100
            w1 = max(w1, w)
        w2, b = wide_b2_set(at, torch, dtype, mine["b2"])
        mine["b1_worst"], mine["b2_worst"] = w1, w2
        bad += b
    if bad:
        raise RuntimeError(f"wide: the kernels disagree with their plain versions: {bad}")
    # (e) the C=512, 8-group figures, this run against PERF.md's
    for dname, before in WIDE_EARLIER_MS.items():
        now = {"b1_28": out[dname]["b1"]["groups8"]["all"]["graph"],
               "b2": out[dname]["b2"][512]["graph"]}
        for k, ms in before.items():
            print(f"wide: C=512 8-group {dname} {k} graph replay {now[k]:.4f} ms, PERF.md {ms} ms "
                  f"({now[k] / ms:.3f}x)", flush=True)
        out[dname]["c512_g8_now_ms"] = now
        out[dname]["b2"] = {f"C={k}": v for k, v in out[dname]["b2"].items()}
    return out


def wide_b2_at_512(at, torch, args, kw, want, tm):
    """The wide B2 kernel of the dtype at C=512 (the library's
    set_attention_launch_wide; the wrapper sends C=512 to attention_sm90 or
    attention_tf32) on the inputs ``args`` of that kernel's timed case:
    held against the plain version's ``want`` within KERNEL_TOL and timed
    as eager calls, graph replay and device time beside the C=512 kernel's
    ``tm``.  Not a launch of the main path, so not counted.  Returns (its
    line, its summary)."""
    from diffuscene_tpu_torch.ops import build

    x, g_ln, w_qkv, w_out, b_out = args
    B_, n, C = x.shape
    dtype = kw["compute_dtype"]
    dname = str(dtype).split(".")[-1]
    if dtype == torch.float32:
        w_q, w_o = at.pack_attention_weights_tf32(w_qkv, w_out)
    else:
        w_q, w_o = at.pack_attention_weights(w_qkv.to(dtype), w_out.to(dtype), permuted=True)
    name = "attention_tf32_wide" if dtype == torch.float32 else "attention_bf16_wide"
    v = torch.stack([g_ln.float(), b_out.float()])
    out = torch.empty_like(x)
    lib = at.load_library()

    def call():
        rc = lib.set_attention_launch_wide(
            build.DTYPE_CODES[dtype], x.data_ptr(), v[0].data_ptr(), w_q.data_ptr(),
            w_o.data_ptr(), v[1].data_ptr(), out.data_ptr(), B_, n, C, at.HEADS, at.DIM_HEAD,
            kw["eps"], build.stream_ptr(x.device))
        if rc != 0:
            raise RuntimeError(f"set_attention_launch_wide failed with code {rc}")
        return out

    call()
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    ok = (bool(torch.isfinite(out.float()).all())
          and torch.allclose(out.float(), want.float(), **KERNEL_TOL[dname]))
    wide = dict(err=err, ok=ok, ms=cuda_ms(call), graph=graph_ms(torch, call),
                dev=device_ms(torch, call, name))
    line = (f"kernel set_attention {dname} {name} C={C} N={n} B={B_}: max_abs_err="
            f"{err:.3e} {'ok' if ok else 'FAIL'} kernel_ms={wide['ms']:.4f} graph_ms="
            f"{wide['graph']:.4f} device_ms={wide['dev']:.4f}; {at.kernel_name(dtype, C)} on the "
            f"same inputs graph_ms={tm['graph']:.4f} ({wide['graph'] / tm['graph']:.3f}x)")
    return line, wide


def wide_samples(torch, card):
    """Phase 22 (b) and (c), f32 (the flagship's network) and then bf16 (the
    b512 recipe's): the wide model sampled at B=64 through fused=True, in
    bf16 by DDPM-1000 (exactly 28,000 B1, 1,000 B2, no B4; the launches by
    kernel) held to the module every TASK_CHECK_EVERY calls, in f32 by
    DPM-Solver++-20 (560, 20, no B4) held every WIDE_DPM_EVERY calls; its
    step profiled with B1 split by kernel; in bf16 fused="rows" on it
    falling back to the 3-D
    engine (560 B1, 20 B2, no B4 in a DPM-Solver++-20); the 4- and
    16-group models' DPM-Solver++-20 at B=64 (560 B1, 20 B2), held every
    WIDE_DPM_EVERY calls; fused="rows" on the 16-group models running every
    chain on the wide B4 kernel (380 B4, no B1 or B2; phase 23 holds it to
    the module)."""
    from diffuscene_tpu_torch.ops import attention as at
    from diffuscene_tpu_torch.ops import fused_level as fl
    from diffuscene_tpu_torch.ops import fused_resblock as rb

    out = {}
    counters = (rb.fused_resnet_block, at.fused_set_attention, fl.apply_chain)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 60)
    for dname, config in WIDE_CONFIG.items():
        pre = "" if dname == "float32" else "bf16_"
        scene = rest_scene(torch, {"dim_mults": list(WIDE_MULTS)},
                           CUT_STEPS if dname == "bfloat16" else T, config=config)
        if str(scene.denoiser.compute_dtype).split(".")[-1] != dname:
            raise RuntimeError(f"wide: {config} is not a {dname} network")
        # the bf16 wide kernels' main path: DDPM over CUT_STEPS steps; f32
        # cut to DPM-Solver++-20 for the script's time, held every
        # WIDE_DPM_EVERY calls
        label = f"{pre}wide_ddpm" if dname == "bfloat16" else "wide_dpm"
        sampler = (dict(steps=CUT_STEPS) if dname == "bfloat16" else
                   dict(calls=DPM_STEPS, every=WIDE_DPM_EVERY, dpm=True, dpm_steps=DPM_STEPS))
        fl.apply_chain.launches = 0
        _, res = checked_sample(torch, scene, f"wide {label}", card, batch=B, fused=True,
                                step=sampling_step(torch, scene, B, gen),
                                named=WIDE_KERNELS[dname], **sampler)
        if fl.apply_chain.launches:
            raise RuntimeError(f"wide {label}: {fl.apply_chain.launches} B4 launches, "
                               f"expected 0")
        res["b4_launches"] = 0
        print(f"wide {label}: launches by kernel {res['by_kernel']}", flush=True)
        out[label] = res
        if dname == "bfloat16":   # fused="rows" on unequal dim_mults: the 3-D engine, as in JAX
            zero_counts(counters)
            rows = scene.sample(B, generator=gen, fused="rows", dpm=True, dpm_steps=DPM_STEPS)
            torch.cuda.synchronize()
            launched = [c.launches for c in counters]
            ok = launched == [28 * DPM_STEPS, DPM_STEPS, 0] and bool(torch.isfinite(rows).all())
            print(f"wide {dname} fused='rows' DPM-Solver++-{DPM_STEPS}: the 3-D engine, launches "
                  f"{launched} {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise RuntimeError(f"wide: fused='rows' on the bf16 wide model: {launched}")
            out[label]["rows_launches"] = launched
        del scene
        torch.cuda.empty_cache()
        for groups in WIDE_GROUPINGS:
            scene = rest_scene(torch, {"resnet_block_groups": groups}, T, config=config)
            label = f"{pre}groups{groups}_dpm"
            _, out[label] = checked_sample(
                torch, scene, f"wide {label}", card, batch=B, fused=True,
                step=sampling_step(torch, scene, B, gen), calls=DPM_STEPS, every=WIDE_DPM_EVERY,
                named=WIDE_GROUP_KERNELS[dname], dpm=True, dpm_steps=DPM_STEPS)
            if groups == 16:   # the rows engine on it: every chain on the wide B4 kernel
                zero_counts(counters)
                rows = scene.sample(B, generator=gen, fused="rows", dpm=True, dpm_steps=DPM_STEPS)
                torch.cuda.synchronize()
                launched = [c.launches for c in counters]
                ok = (launched == [0, 0, 19 * DPM_STEPS] and bool(torch.isfinite(rows).all())
                      and tuple(rows.shape) == (B, 12, 62))
                print(f"wide {dname} groups16 fused='rows' DPM-Solver++-{DPM_STEPS}: launches "
                      f"{launched} ({fl.apply_chain.by_kernel}) {'ok' if ok else 'FAIL'}",
                      flush=True)
                if not ok:
                    raise RuntimeError(f"wide: fused='rows' on 16 groups: {launched}")
                out[label]["rows_launches"] = launched
            del scene
            torch.cuda.empty_cache()
    return out


def wide_narrow_and_cli(torch, card):
    """Phase 22 (d): a model outside the set (dim 64) raises naming
    fused=False with nothing launched, in each dtype;
    generate_diffusion --fused --dpm on the wide flagship config (f32) and
    on the wide b512 config (bf16) at B=64, exactly 560 B1 and 20 B2
    launches each."""
    import re
    import shutil

    from diffuscene_tpu_torch.cli import generate_diffusion
    from diffuscene_tpu_torch.data import make_synthetic_cached_dataset
    from diffuscene_tpu_torch.ops import attention as at
    from diffuscene_tpu_torch.ops import fused_level as fl
    from diffuscene_tpu_torch.ops import fused_resblock as rb

    out = {"outside": {}, "generate": {}}
    counters = (rb.fused_resnet_block, at.fused_set_attention, fl.apply_chain)
    for dname, config in WIDE_CONFIG.items():
        scene = rest_scene(torch, {"dim": 64}, T, config=config)
        zero_counts(counters)
        err = None
        try:
            scene.sample(B, generator=torch.Generator(device=DEV).manual_seed(SEED), fused=True)
        except ValueError as e:
            err = str(e)
        launched = [c.launches for c in counters]
        ok = err is not None and "fused=False" in err and launched == [0, 0, 0]
        print(f"wide {dname} dim 64 fused=True: raises {err!r}, launches {launched} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise RuntimeError(f"wide: the {dname} dim 64 model: {err}, {launched}")
        out["outside"][dname] = err
        del scene
    torch.cuda.empty_cache()
    for d in (WIDE_DATA, WIDE_OUT):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(WIDE_OUT)
    make_synthetic_cached_dataset(WIDE_DATA, n_scenes=WIDE_SCENES, seed=SEED)
    for dname, config in WIDE_CONFIG.items():
        cfg_path = rest_config(f"wide_generate_{dname}.yaml", data=WIDE_DATA, out=WIDE_OUT,
                               base=config)
        with open(cfg_path) as f:
            text = f.read()
        text, n = re.subn(r"(\n    dim_mults:\n    - 1\n    - 1\n)    - 1\n    - 1\n",
                          r"\g<1>    - 2\n    - 2\n", text)
        if n != 1:
            raise RuntimeError(f"{cfg_path}: cannot set dim_mults")
        with open(cfg_path, "w") as f:
            f.write(text)
        gen_dir = os.path.join(WIDE_OUT, f"generated_{dname}")
        zero_counts(counters)
        stats, launches, wall = eval_cli_run(torch, generate_diffusion, [
            cfg_path, gen_dir, "--n_sequences", str(B), "--batch_size", str(B), "--fused",
            "--dpm"])
        check_launches(f"wide {dname} generate", launches, (28 * DPM_STEPS, DPM_STEPS))
        by_kernel = {**rb.fused_resnet_block.by_kernel, **at.fused_set_attention.by_kernel}
        with open(os.path.join(gen_dir, "timing.json")) as f:
            timing = json.load(f)
        print(f"wide {dname} generate --fused --dpm ({os.path.basename(config)}, dim_mults "
              f"{list(WIDE_MULTS)}), B={B}: wall {wall:.3f} s (sampling {timing['sample_s']:.3f} "
              f"s), {stats['n_scenes']} scenes, launches B1={launches[0]} B2={launches[1]} "
              f"{by_kernel} ok | {card}", flush=True)
        out["generate"][dname] = {"wall_s": wall, "sample_s": timing["sample_s"],
                                  "launches": list(launches), "by_kernel": by_kernel}
    return out


def phase_wide(rb, at, torch, card):
    """Phase 22: the B1 and B2 kernels widened, one set for both dtypes
    (see WIDE_B1_SET)."""
    t0 = time.perf_counter()
    out = {"card": card, "kernels": wide_kernels(rb, at, torch)}
    torch.cuda.empty_cache()
    out["samples"] = wide_samples(torch, card)
    out.update(wide_narrow_and_cli(torch, card))
    out["phase_s"] = time.perf_counter() - t0
    print(f"wide: phase 22 took {out['phase_s']:.1f} s", flush=True)
    return out


def chain_blocks(fl, variant):
    """The ChainBlocks of a VARIANTS chain."""
    return [fl.ChainBlock(has_skip=sk, film=f, has_res_proj=r) for f, sk, r in VARIANTS[variant]]


def forward_sums(cases, width, groups):
    """The 19 chains of one forward of an equal-width model (FORWARD_MIX)
    from phase 23's timed cases at (width, groups): summed times and work."""
    return {f: sum(cases[(width, groups, v)][f] * k for v, k in FORWARD_MIX.items())
            for f in ("ms", "graph", "dev", "plain", "flops", "bytes")}


def wide_chain_set(fl, torch, dtype, seed):
    """Phase 23 (a), one dtype: every WIDE_CHAIN_VARIANTS chain at every
    (C, groups) of WIDE_CHAIN_SET against the plain version, at N=12 and
    B=64 (timed: eager, graph replay, device, plain, bound), N=21 at B=64
    and a ragged B=63 of N=12; each launch plan against the library's.
    Returns (worst error, the timed cases, the failures)."""
    from diffuscene_tpu_torch.ops import build

    lib, code = fl.load_library(), build.DTYPE_CODES[dtype]
    dname = str(dtype).split(".")[-1]
    worst, cases, bad = 0.0, {}, []
    for width, groups in WIDE_CHAIN_SET:
        kernel = fl.kernel_name(dtype, width, groups)
        for variant in WIDE_CHAIN_VARIANTS:
            blocks = chain_blocks(fl, variant)
            skip = int(any(b.has_skip for b in blocks))
            p = fl.tile_plan(B, 12, blocks, lib, dtype, width, groups)
            lib_smem = lib.fused_chain_smem_bytes(code, skip, width, groups)
            seed += 1
            ok, err, tm, (flops, nbytes) = chain_check(fl, torch, variant, 12, dtype, seed,
                                                       width=width, groups=groups)
            for n, batch in ((21, B), (12, 63)):
                seed += 1
                more, e, _, _ = chain_check(fl, torch, variant, n, dtype, seed, batch=batch,
                                            timed=False, width=width, groups=groups)
                ok, err = ok and more, max(err, e)
            ok = ok and p.resident >= 1 and lib_smem == p.smem_bytes
            worst = max(worst, err)
            b_ms, b_by, _ = kernel_bound(dname, flops, nbytes)
            cases[(width, groups, variant)] = dict(tm, flops=flops, bytes=nbytes, err=err)
            print(f"kernel fused_chain {dname} {kernel} C={width} groups={groups} {variant:9s} "
                  f"N=12/21 B=64, N=12 B=63: max_abs_err={err:.3e} tol={KERNEL_TOL[dname]} "
                  f"{'ok' if ok else 'FAIL'}; N=12 B={B}: kernel_ms={tm['ms']:.4f} graph_ms="
                  f"{tm['graph']:.4f} device_ms={tm['dev']:.4f} plain_ms={tm['plain']:.4f} "
                  f"bound_ms={b_ms:.4f} ({b_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB); "
                  f"plan {p.scenes_per_tile} scenes a tile, {p.clusters} clusters of "
                  f"{p.ctas // p.clusters} CTAs, {p.stages} stages, {p.smem_bytes} bytes of "
                  f"shared memory a CTA (library {lib_smem}), {p.resident} clusters fit at once",
                  flush=True)
            if not ok:
                bad.append((dname, width, groups, variant, err, p.resident, lib_smem))
    return worst, cases, bad


def wide_chain_at_512(fl, torch, dtype, seed):
    """Phase 23 (a), one dtype: the wide kernel at C=512 in 8 groups, not on
    a main path (the library's fused_chain_launch_wide; uncounted), on the
    inputs of the cluster-of-8 kernel's (chain_tf32, chain_sm90) forward-mix
    chains at N=12, B=64, each held to the plain version within KERNEL_TOL,
    both kernels timed as graph replay in turns (cluster-of-8, wide, wide,
    cluster-of-8) in this call.  Returns the 19 chains' sums (both kernels,
    graph ms) and the worst error."""
    from diffuscene_tpu_torch.ops import build

    lib = fl.load_library()
    dname = str(dtype).split(".")[-1]
    narrow = fl.kernel_name(dtype, C, 8)
    sums, worst, bad = {"narrow": 0.0, "wide": 0.0}, 0.0, []
    for variant, k in FORWARD_MIX.items():
        seed += 1
        chain, x, films, skips = chain_case(fl, torch, variant, 12, dtype, seed)
        wp = fl.pack_chain_weights(chain.W, permuted=True)
        h, mid, out = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        specs = [b.spec for b in chain.blocks] + [0]

        def wide():
            rc = lib.fused_chain_launch_wide(
                build.DTYPE_CODES[dtype], x.data_ptr(), ptr(skips[0]),
                ptr(skips[1] if len(skips) > 1 else None), ptr(films[0]),
                ptr(films[1] if len(films) > 1 else None), wp.data_ptr(), chain.V.data_ptr(),
                h.data_ptr(), mid.data_ptr(), out.data_ptr(), B, 12, C, 8, 1e-6,
                len(chain.blocks), specs[0], specs[1], build.stream_ptr(x.device))
            if rc != 0:
                raise RuntimeError(f"fused_chain_launch_wide failed with code {rc}")
            return out

        def cluster8():
            return fl.apply_chain(chain, x, films, skips, n_per_scene=12)

        want = fl.apply_chain_reference(chain, x, films, skips, n_per_scene=12).float()
        got = [cluster8().float(), wide().float()]
        torch.cuda.synchronize()
        errs = [(g - want).abs().max().item() for g in got]
        ok = all(bool(torch.isfinite(g).all()) and torch.allclose(g, want, **KERNEL_TOL[dname])
                 for g in got)
        worst = max(worst, *errs)
        g8 = [graph_ms(torch, cluster8)]
        gw = [graph_ms(torch, wide), graph_ms(torch, wide)]
        g8.append(graph_ms(torch, cluster8))
        a, b = sum(g8) / 2, sum(gw) / 2
        sums["narrow"] += k * a
        sums["wide"] += k * b
        print(f"kernel fused_chain {dname} C=512 groups=8 {variant:9s} x{k} a forward, N=12 B={B}: "
              f"{narrow} graph_ms={g8[0]:.4f}/{g8[1]:.4f}, {WIDE_CHAIN_KERNELS[dname][0][1]} "
              f"(uncounted) "
              f"graph_ms={gw[0]:.4f}/{gw[1]:.4f} ({b / a:.3f}x); max_abs_err {errs[0]:.3e} / "
              f"{errs[1]:.3e} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            bad.append((dname, variant, errs))
    print(f"chains of one flagship forward (C=512, 8 groups, {dname}, 19 chains), graph replay: "
          f"{narrow} {sums['narrow']:.4f} ms (PERF.md {WIDE_CHAIN_EARLIER_MS[dname]} ms, "
          f"{sums['narrow'] / WIDE_CHAIN_EARLIER_MS[dname]:.3f}x), the wide kernel "
          f"{sums['wide']:.4f} ms ({sums['wide'] / sums['narrow']:.3f}x)", flush=True)
    return sums, worst, bad


def wide_chain_kernels(fl, torch):
    """Phase 23 (a), f32 then bf16: wide_chain_set, the 19 chains of an
    equal-width forward at each (C, groups) of the set summed from its
    cases (FORWARD_MIX), and wide_chain_at_512; the chain kernels' ptxas
    report.  Returns the summary."""
    from diffuscene_tpu_torch.ops import build

    wide_ptxas(build.library_path(fl.CSRC), "chain_")
    out, bad, seed = {}, [], 900
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        worst, cases, b = wide_chain_set(fl, torch, dtype, seed)
        seed += 1000
        bad += b
        mine = out[dname] = {"worst": worst, "forward_19": {}}
        for width, groups in WIDE_CHAIN_SET:
            s = forward_sums(cases, width, groups)
            s["bound_ms"], s["bound_by"], fp32 = kernel_bound(dname, s["flops"], s["bytes"])
            route = ("on the bf16 tensor cores" if fp32 is None else
                     f"on the split-TF32 route ({fp32:.4f} at the FP32 rate)")
            print(f"chains of one forward, dim {width} dim_mults [1, 1, 1, 1], {groups} groups, "
                  f"{dname}, N=12, B={B} (19 chains, {fl.kernel_name(dtype, width, groups)}): "
                  f"kernel "
                  f"{s['ms']:.3f} ms (eager), graph replay {s['graph']:.3f} ms, device "
                  f"{s['dev']:.3f} ms, plain {s['plain']:.3f} ms, bound {s['bound_ms']:.4f} ms "
                  f"{route} ({s['bound_by']}; {s['flops'] / 1e9:.2f} GFLOP, "
                  f"{s['bytes'] / 1e6:.2f} MB)", flush=True)
            mine["forward_19"][f"C={width} groups={groups}"] = s
        mine["c512_g8"], w, b = wide_chain_at_512(fl, torch, dtype, seed)
        mine["c512_g8_worst"] = w
        bad += b
        seed += 100
    if bad:
        raise RuntimeError(f"wide chain: the kernels disagree with their plain versions: {bad}")
    return out


def rows_sample(torch, scene, label, card, gen, **kw):
    """checked_sample through fused="rows" at B=64 with B1 and B2 counted
    too: the chain launches by kernel, exactly none of B1 and B2.  Returns
    the summary, its launches as [B1, B2, B4]."""
    from diffuscene_tpu_torch.ops import attention as at
    from diffuscene_tpu_torch.ops import fused_resblock as rb

    zero_counts((rb.fused_resnet_block, at.fused_set_attention))
    step = sampling_step(torch, scene, B, gen, fused="rows") if kw.get("profile", True) else None
    _, res = checked_sample(torch, scene, label, card, batch=B, fused="rows", step=step, **kw)
    other = [rb.fused_resnet_block.launches, at.fused_set_attention.launches]
    print(f"{label}: launches by kernel {res['by_kernel']}, B1 and B2 {other}", flush=True)
    if other != [0, 0]:
        raise RuntimeError(f"{label}: B1 and B2 launched {other} times in a rows sample")
    res["launches"] = [other[0], other[1], res["launches"][0]]
    return res


def wide_chain_samples(torch, card):
    """Phase 23 (b): the rows engine at full width.  The dim-1024 [1, 1, 1,
    1] model: the b512 recipe's network (bf16) by DDPM-1000 at B=64 through
    fused="rows" (exactly 19,000 B4 on chain_bf16_wide, no B1 or B2) held
    to the module every TASK_CHECK_EVERY calls, then through fused=True by
    DPM-Solver++-20 (560 B1, 20 B2, no B4), the flagship's (f32) by
    DPM-Solver++-20 through fused="rows" (380 B4 on chain_tf32_wide) held
    every WIDE_DPM_EVERY calls, each with a 20-step profile; the 4- and
    16-group flagship networks and a dim-256 model in each dtype through
    fused="rows" by DPM-Solver++-20 (380 B4 on the wide kernel), held every
    WIDE_DPM_EVERY calls, unprofiled; a dim-64 model refused by
    fused="rows" naming fused=False, nothing launched.  Each sample's time,
    its model's set-up included, is printed."""
    from diffuscene_tpu_torch.ops import attention as at
    from diffuscene_tpu_torch.ops import fused_level as fl
    from diffuscene_tpu_torch.ops import fused_resblock as rb

    out = {}
    counters = (rb.fused_resnet_block, at.fused_set_attention, fl.apply_chain)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 80)
    dpm = dict(calls=DPM_STEPS, every=WIDE_DPM_EVERY, dpm=True, dpm_steps=DPM_STEPS)
    for dname, config in (("bfloat16", B512_CONFIG), ("float32", FLAGSHIP_CONFIG)):
        pre = "bf16_" if dname == "bfloat16" else ""
        kernel = WIDE_CHAIN_KERNELS[dname][0][1]
        t0 = time.perf_counter()
        scene = rest_scene(torch, {"dim": WIDE_CHAIN_DIM},
                           CUT_STEPS if dname == "bfloat16" else T, config=config)
        if str(scene.denoiser.compute_dtype).split(".")[-1] != dname:
            raise RuntimeError(f"wide chain: {config} is not a {dname} network")
        # this slice's main path: bf16 DDPM over CUT_STEPS steps; f32
        # DPM-Solver++-20
        label = f"{pre}dim{WIDE_CHAIN_DIM}_rows_" + ("ddpm" if dname == "bfloat16" else "dpm")
        out[label] = rows_sample(torch, scene, f"wide chain {label}", card, gen=gen,
                                 named=WIDE_CHAIN_KERNELS[dname],
                                 **(dict(steps=CUT_STEPS) if dname == "bfloat16" else dpm))
        calls = CUT_STEPS if dname == "bfloat16" else DPM_STEPS
        if out[label]["by_kernel"] != {kernel: 19 * calls}:
            raise RuntimeError(f"wide chain {label}: launches by kernel {out[label]['by_kernel']}")
        if dname == "bfloat16":   # the same model through the 3-D engine, beside it
            label3 = f"{pre}dim{WIDE_CHAIN_DIM}_3d_dpm"
            fl.apply_chain.launches = 0
            _, out[label3] = checked_sample(
                torch, scene, f"wide chain {label3}", card, batch=B, fused=True,
                step=sampling_step(torch, scene, B, gen), named=WIDE_CHAIN_3D_KERNELS[dname],
                **dpm)
            if fl.apply_chain.launches:
                raise RuntimeError(f"wide chain {label3}: {fl.apply_chain.launches} B4 launches")
            print(f"wide chain dim {WIDE_CHAIN_DIM} {dname}, B={B}: device busy "
                  f"{out[label]['busy_ms']:.3f} ms/step through fused='rows', "
                  f"{out[label3]['busy_ms']:.3f} through fused=True", flush=True)
        print(f"wide chain dim {WIDE_CHAIN_DIM} {dname}: {time.perf_counter() - t0:.1f} s",
              flush=True)
        del scene
        torch.cuda.empty_cache()
        for key, kw in ((f"{pre}groups4_rows_dpm", {"resnet_block_groups": 4}),
                        (f"{pre}groups16_rows_dpm", {"resnet_block_groups": 16}),
                        (f"{pre}dim{WIDE_CHAIN_SMALL_DIM}_rows_dpm",
                         {"dim": WIDE_CHAIN_SMALL_DIM})):
            t0 = time.perf_counter()
            scene = rest_scene(torch, kw, T, config=config)
            out[key] = rows_sample(torch, scene, f"wide chain {key}", card, gen=gen,
                                   profile=False, **dpm)
            if out[key]["by_kernel"] != {kernel: 19 * DPM_STEPS}:
                raise RuntimeError(f"wide chain {key}: launches by kernel {out[key]['by_kernel']}")
            print(f"wide chain {key}: {time.perf_counter() - t0:.1f} s", flush=True)
            del scene
            torch.cuda.empty_cache()
        # outside the set: nothing launched
        scene = rest_scene(torch, {"dim": 64}, T, config=config)
        zero_counts(counters)
        err = None
        try:
            scene.sample(B, generator=torch.Generator(device=DEV).manual_seed(SEED), fused="rows")
        except ValueError as e:
            err = str(e)
        launched = [c.launches for c in counters]
        ok = err is not None and "fused=False" in err and launched == [0, 0, 0]
        print(f"wide chain {dname} dim 64 fused='rows': raises {err!r}, launches {launched} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise RuntimeError(f"wide chain: the {dname} dim 64 model through fused='rows': {err}, "
                               f"{launched}")
        out[f"{pre}dim64_rows_error"] = err
        del scene
    return out


def wide_chain_entry(dname, kernels, samples):
    """The kernels line's entry of the ``dname`` wide chain kernel: its
    launches on the slice's main path (the dim-1024 model's bf16 DDPM over
    CUT_STEPS steps; f32 DPM-Solver++-20) and on the other phase 23
    samples, its worst error
    over phase 23 (a), and the times and bound of the dim-1024 model's 19
    chains at B=64 (8 groups)."""
    pre = "bf16_" if dname == "bfloat16" else ""
    kernel = WIDE_CHAIN_KERNELS[dname][0][1]
    main = f"{pre}dim{WIDE_CHAIN_DIM}_rows_" + ("ddpm" if dname == "bfloat16" else "dpm")
    fwd = kernels[dname]["forward_19"][f"C={WIDE_CHAIN_DIM} groups=8"]
    return {
        "name": kernel,
        "route": "cuda",
        "source": "diffuscene_tpu_torch/csrc/fused_chain.cu",
        "replaces": "diffuscene_tpu/ops/fused_level.py:165",
        "launches": samples[main]["by_kernel"][kernel],
        "max_abs_err": kernels[dname]["worst"],
        "ms": fwd["ms"],
        "graph_ms": fwd["graph"],
        "plain_ms": fwd["plain"],
        "bound_ms": fwd["bound_ms"],
        "bound_by": fwd["bound_by"],
        "library_ms": None,
        "wide_chain_launches": {k: v["by_kernel"].get(kernel, 0) for k, v in samples.items()
                                if isinstance(v, dict) and "by_kernel" in v},
        "forward_19_graph_ms": {k: v["graph"] for k, v in kernels[dname]["forward_19"].items()},
        "c512_g8_graph_ms": kernels[dname]["c512_g8"],
    }


def phase_wide_chain(fl, torch, card):
    """Phase 23: the chain kernel (B4) widened to B1's set, both dtypes."""
    t0 = time.perf_counter()
    out = {"card": card, "kernels": wide_chain_kernels(fl, torch)}
    out["kernels_s"] = time.perf_counter() - t0
    print(f"wide chain: phase 23 (a) took {out['kernels_s']:.1f} s", flush=True)
    torch.cuda.empty_cache()
    out["samples"] = wide_chain_samples(torch, card)
    out["phase_s"] = time.perf_counter() - t0
    print(f"wide chain: phase 23 took {out['phase_s']:.1f} s", flush=True)
    return out


def graph_counters():
    """The counters phase 24 reads: B1, B2 and B4."""
    from diffuscene_tpu_torch.ops import attention as at
    from diffuscene_tpu_torch.ops import fused_level as fl
    from diffuscene_tpu_torch.ops import fused_resblock as rb

    return rb.fused_resnet_block, at.fused_set_attention, fl.apply_chain


def graph_case(torch, scene, label, card, batch, counters, want, step, calls=T, contexts=0,
               seed=SEED + 24, eager=None, **kw):
    """Phase 24, one case: ``scene.sample(batch, **kw)`` from one seeded
    generator twice, eagerly (graph=False) and by default (a CUDA graph on
    the card: one eager step, the step captured once and replayed), each
    with the launches of ``counters`` exactly ``want`` (and ``contexts``
    text contexts), its wall time and peak device memory, the graph's warm
    step, capture and replay seconds (samplers.run_steps.last; none for
    the eager run); the largest difference of the two samples: bit-equal
    expected, within GRAPH_TOL of the model's dtype passed with a line
    saying so, beyond it the phase fails.  Then the step's device-busy
    time, ``step`` (the sampler's denoiser step at the first t) replayed
    from a graph of 20 (graph_ms), against the graphed and the eager step:
    the idle share each leaves.  ``calls`` is the sampler's steps.
    ``eager`` (the sample, wall time and peak memory of an eager run of
    the same model, inputs and ``seed`` in another phase: phase 4's or
    15's, or a checked_sample run, whose checks draw no noise) stands for
    the eager run, which is then not repeated."""
    from diffuscene_tpu_torch.diffusion import samplers
    from diffuscene_tpu_torch.models import inference as inf

    dname = str(scene.denoiser.compute_dtype).split(".")[-1]
    reused = eager is not None
    runs = {"eager": {**eager, "launches": want, "graph": None}} if reused else {}
    for mode, graph in (("eager", False), ("graph", None)):
        if mode in runs:
            continue
        gen = torch.Generator(device=DEV).manual_seed(seed)
        zero_counts(counters)
        inf.cross_context.calls = 0
        samplers.run_steps.last = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = scene.sample(batch, generator=gen, clip_denoised=True, graph=graph, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = [c.launches for c in counters]
        runs[mode] = {"out": out, "wall_s": wall, "launches": launched,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "graph": samplers.run_steps.last}
        if launched != want or inf.cross_context.calls != contexts:
            raise RuntimeError(f"graph {label} ({mode}): launches {launched}, expected {want}; "
                               f"text contexts {inf.cross_context.calls}, expected {contexts}")
        if (runs[mode]["graph"] is None) != (mode == "eager"):
            raise RuntimeError(f"graph {label} ({mode}): the sampler ran "
                               f"{'eagerly' if mode == 'graph' else 'from a graph'}")
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"graph {label} ({mode}): the sample is not finite")
    eager, graphed = runs["eager"], runs["graph"]
    g = graphed["graph"]
    diff = (graphed["out"] - eager["out"]).abs().max().item()
    bit_equal = bool(torch.equal(graphed["out"], eager["out"]))
    tol = GRAPH_TOL[dname]
    step_ms = 1e3 * g["replay_s"] / g["replays"]
    eager_step_ms = 1e3 * eager["wall_s"] / calls
    busy_ms = graph_ms(torch, step)
    zero_counts(counters)
    res = {"B": batch, "dtype": dname, "calls": calls, "launches": graphed["launches"],
           "bit_equal": bit_equal, "max_abs_diff": diff, "eager_wall_s": eager["wall_s"],
           "graph_wall_s": graphed["wall_s"], "warm_s": g["warm_s"], "capture_s": g["capture_s"],
           "graph_step_ms": step_ms, "eager_step_ms": eager_step_ms, "busy_ms": busy_ms,
           "graph_idle_share": 1 - busy_ms / step_ms,
           "eager_idle_share": 1 - busy_ms / eager_step_ms,
           "eager_peak_gb": eager["peak_gb"], "graph_peak_gb": graphed["peak_gb"]}
    verdict = ("bit-equal" if bit_equal else
               f"NOT bit-equal, within {tol}" if diff <= tol else f"FAIL (tol {tol})")
    res["eager_reused"] = reused
    print(f"graph {label}, B={batch}, {dname}: graphed vs eager"
          f"{' (an earlier eager sample)' if reused else ''} max_abs_diff {diff:.3e} "
          f"{verdict}; launches {graphed['launches']} in each; wall eager {eager['wall_s']:.3f} s, "
          f"graphed {graphed['wall_s']:.3f} s (warm step {g['warm_s']:.3f} s, capture and "
          f"instantiate {g['capture_s']:.3f} s, {g['replays']} replays "
          f"{g['replay_s']:.3f} s); step eager {eager_step_ms:.3f} ms, graphed {step_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms (graph replay of the step): idle share eager "
          f"{res['eager_idle_share']:.3f}, graphed {res['graph_idle_share']:.3f}; peak memory "
          f"eager {eager['peak_gb']:.2f} GB, graphed {graphed['peak_gb']:.2f} GB | {card}",
          flush=True)
    if not diff <= tol:
        raise RuntimeError(f"graph {label}: the graphed sample is {diff:.3e} from the eager one")
    return res


def phase_graph(torch, card, tasks=True, eager=None):
    """Phase 24: every sampler of SceneDiffusion.sample from a CUDA graph,
    each held to its eager loop from the same seed (graph_case): the f32
    flagship through the 3-D engine by DDPM-1000 at B=64 and at
    run/generate.sh's B=256 (28,000 B1, 1,000 B2), by DPM-Solver++-20 at
    B=256 (560, 20) and by DDIM-50 at eta 0.5 at B=64 (1,400, 50); the
    bf16 flagship through the rows engine by DDPM-1000 at B=64 (19,000
    B4); completion (3 partial boxes) and re-arrangement DDPM-1000 at
    TASK_B (28,000, 1,000 each) on random inputs; the bedroom text model
    through the rows engine by DDPM-1000 at TEXT_ROWS_B on random token
    embeddings (19,000 B4, TEXT_CONTEXTS contexts).  Without ``tasks`` the
    task and text cases are left to phases 16 and 17, which hold a graph of
    each of their gated samples to it (the whole run).  ``eager`` maps a
    case to a sample of phase 4 or 15 that stands for its eager run
    (graph_case), the f32 3-D DDPM-1000 at B=64 and the bf16 rows one in
    the whole run.  Returns each case's summary."""
    eager = eager or {}
    seeds = {"ddpm_3d_b64": ENGINE_SAMPLE_SEED, "ddpm_rows_bf16_b64": ROWS_SAMPLE_SEED}

    def twin(key):
        return {"eager": eager[key], "seed": seeds[key]} if key in eager else {}

    t0 = time.perf_counter()
    engine = graph_counters()
    gen = torch.Generator(device=DEV).manual_seed(SEED + 25)
    out = {}
    scene = flagship(torch, torch.float32)
    for batch in (B, GENERATE_B):
        key = f"ddpm_3d_b{batch}"
        out[key] = graph_case(
            torch, scene, f"f32 3-D DDPM-{T}", card, batch, engine, [28 * T, T, 0],
            sampling_step(torch, scene, batch, gen), fused=True, **twin(key))
    out["dpm_3d_b256"] = graph_case(
        torch, scene, f"f32 3-D DPM-Solver++-{DPM_STEPS}", card, GENERATE_B, engine,
        [28 * DPM_STEPS, DPM_STEPS, 0], sampling_step(torch, scene, GENERATE_B, gen),
        calls=DPM_STEPS, fused=True, dpm=True, dpm_steps=DPM_STEPS)
    out["ddim_3d_b64"] = graph_case(
        torch, scene, f"f32 3-D DDIM-{GRAPH_DDIM_STEPS} eta {GRAPH_DDIM_ETA}", card, B, engine,
        [28 * GRAPH_DDIM_STEPS, GRAPH_DDIM_STEPS, 0], sampling_step(torch, scene, B, gen),
        calls=GRAPH_DDIM_STEPS, fused=True, ddim=True, ddim_steps=GRAPH_DDIM_STEPS,
        ddim_eta=GRAPH_DDIM_ETA)
    del scene
    scene = flagship(torch, torch.bfloat16)
    out["ddpm_rows_bf16_b64"] = graph_case(
        torch, scene, f"bf16 rows DDPM-{T}", card, B, engine, [0, 0, 19 * T],
        sampling_step(torch, scene, B, gen, fused="rows"), fused="rows",
        **twin("ddpm_rows_bf16_b64"))
    del scene
    torch.cuda.empty_cache()
    if not tasks:
        out["phase_s"] = time.perf_counter() - t0
        print(f"graph: phase 24 without its task and text cases took {out['phase_s']:.1f} s | "
              f"{card}", flush=True)
        return out
    boxes = torch.rand(TASK_B, 12, 62, generator=gen, device=DEV) * 2 - 1
    partial = boxes[:, :TASK_PARTIAL].contiguous()
    scene = task_model(torch, FLAGSHIP_CONFIG)
    out["complete_b32"] = graph_case(
        torch, scene, f"completion DDPM-{T}", card, TASK_B, engine, [28 * T, T, 0],
        task_step(torch, scene, partial_boxes=partial), fused=True, partial_boxes=partial)
    scene = task_model(torch, REARRANGE_CONFIG)
    out["arrange_b32"] = graph_case(
        torch, scene, f"rearrange DDPM-{T}", card, TASK_B, engine, [28 * T, T, 0],
        task_step(torch, scene, input_boxes=boxes), fused=True, input_boxes=boxes)
    scene = task_model(torch, TEXT_CONFIG)
    text = torch.randn(TEXT_ROWS_B, 50, 768, generator=gen, device=DEV)
    out["text_rows_b64"] = graph_case(
        torch, scene, f"text rows DDPM-{T}", card, TEXT_ROWS_B, engine, [0, 0, 19 * T],
        sampling_step(torch, scene, TEXT_ROWS_B, gen, fused="rows", text_emb=text),
        contexts=TEXT_CONTEXTS, fused="rows", text_emb=text)
    del scene
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    print(f"graph: phase 24 took {out['phase_s']:.1f} s | {card}", flush=True)
    return out


def train_state(torch, trainer):
    """A scene trainer's state on the host: its flat parameters, EMA and Adam
    moments (each in its dtype), its accumulator and generator state."""
    from diffuscene_tpu_torch.train.optim import flatten

    return {"params": flatten([p.detach() for p in trainer.params]).cpu(),
            "ema": None if trainer._ema is None else trainer._ema.cpu(),
            "moments": trainer.opt._moments.cpu(),
            "acc": None if trainer.acc is None else trainer.acc.cpu(),
            "generator": trainer.generator.get_state()}


def state_apart(torch, got, want):
    """(bit-equal, the largest absolute difference) of two train_states; the
    generator states must be equal (the graph draws in the eager step's
    order), else this raises."""
    if not torch.equal(got["generator"], want["generator"]):
        raise RuntimeError("graph train: the generator state after the graphed steps is not "
                           "the eager twin's")
    equal, worst = True, 0.0
    for k, w in want.items():
        g = got[k]
        if w is None or g is None:
            equal = equal and g is None and w is None
        elif k != "generator":
            equal = equal and torch.equal(g, w)
            worst = max(worst, (g.float() - w.float()).abs().max().item())
    return equal, worst


def graph_costs(trainer):
    """Each captured variant's warm-step and capture seconds."""
    return [{"key": str(key), "warm_s": warm, "capture_s": cap}
            for key, warm, cap in trainer.step_graphs.costs]


def costs_text(costs):
    """graph_costs as (variant, warm s, capture s) triples to print."""
    return [(c["key"], round(c["warm_s"], 3), c["capture_s"] and round(c["capture_s"], 3))
            for c in costs]


def graph_verdict(label, equal, worst, tol):
    """The agreement's verdict to print; beyond ``tol`` the phase fails."""
    verdict = ("bit-equal" if equal else f"NOT bit-equal, within {tol}" if worst <= tol
               else f"FAIL (tol {tol})")
    if not worst <= tol:
        raise RuntimeError(f"graph train {label}: the graphed state is {worst:.3e} from the "
                           f"eager twin's")
    return verdict


def graph_train_timed(torch, tr, calls):
    """Each of ``calls`` (functions of the trainer, one train step or scan
    each) timed on the host clock -> (their metrics, seconds)."""
    out, times = [], []
    for call in calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out.append(call(tr))
        times.append(time.perf_counter() - t0)
    return out, times


def graph_scene_case(torch, label, twin, mode, card, ds=None):
    """Phase 25, the flagship or b512 case: a graphed trainer (the default)
    through ``twin``'s calls, phase 12's or 13's (its given-t step, then a
    step a host batch): one train_step a batch ("steps"), train_step_scan
    over chunks of GRAPH_SCAN_K batches ("scan"), or GRAPH_RESUME_AT steps,
    a checkpoint written and loaded into a new trainer, then the rest
    ("resume"); its state after the last call held to the twin's (GRAPH_TOL
    of the model's dtype), its metrics to the twin's (equal; a scan's
    within 1e-5 relative of the mean of its steps').  "steps" also
    profiles TRAIN_PROFILE_STEPS graphed steps.  ``ds`` is the twin's
    train split, made already (or None).  Returns (the summary, ``ds``)."""
    import shutil

    from diffuscene_tpu_torch.ops import build
    from diffuscene_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    made = build.prepared.made
    ds, _, tr = scene_trainer(torch, twin["config"], DEV, twin["data_dir"], ds=ds)
    dname = str(tr.scene.denoiser.compute_dtype).split(".")[-1]
    if not tr.graph:
        raise RuntimeError(f"graph train {label}: the trainer does not run from a graph")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first = []
    if twin["first"] is not None:
        host, t, noise = twin["first"]
        first = [tr.train_step(tr.put_batch(host), t=t.to(DEV), noise=noise.to(DEV))]
    first_ok = first == ([] if twin["first"] is None else [twin["first_metrics"]])
    hosts, costs = twin["hosts"], []
    if mode == "scan":
        chunks = [hosts[i:i + GRAPH_SCAN_K] for i in range(0, len(hosts), GRAPH_SCAN_K)]
        ms, times = graph_train_timed(torch, tr, [
            lambda tr, c=c: tr.train_step_scan(tr.put_batches(c)) for c in chunks])
        want = [{k: sum(m[k] for m in twin["metrics"][i:i + GRAPH_SCAN_K]) / len(c)
                 for k in ms[0]} for i, c in zip(range(0, len(hosts), GRAPH_SCAN_K), chunks)]
        metrics_ok = first_ok and all(abs(g[k] - w[k]) <= 1e-5 * abs(w[k])
                                      for g, w in zip(ms, want) for k in w)
    else:
        split = GRAPH_RESUME_AT if mode == "resume" else len(hosts)
        calls = [lambda tr, h=h: tr.train_step(tr.put_batch(h)) for h in hosts]
        ms, times = graph_train_timed(torch, tr, calls[:split])
        if mode == "resume":
            shutil.rmtree(TRAIN_GRAPH_OUT, ignore_errors=True)
            save_checkpoint(tr.state_dict(), TRAIN_GRAPH_OUT, 0)
            costs = graph_costs(tr)
            del tr
            torch.cuda.empty_cache()
            _, _, tr = scene_trainer(torch, twin["config"], DEV, twin["data_dir"], ds=ds)
            state, _ = load_checkpoint(TRAIN_GRAPH_OUT)
            tr.load_state_dict(state)
            more, more_times = graph_train_timed(torch, tr, calls[split:])
            ms, times = ms + more, times + more_times
        metrics_ok = first_ok and ms == twin["metrics"]
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    equal, worst = state_apart(torch, train_state(torch, tr), twin["state"])
    tol = GRAPH_TOL[dname]
    verdict = graph_verdict(label, equal, worst, tol)
    costs += graph_costs(tr)
    # the steps after the first variant's warm step and capture
    step_ms = 1e3 * sorted(times[2:])[len(times[2:]) // 2] / (GRAPH_SCAN_K if mode == "scan"
                                                             else 1)
    res = {"mode": mode, "dtype": dname, "calls": len(times) + len(first),
           "bit_equal": equal, "max_abs_diff": worst, "metrics_equal": metrics_ok,
           "graph_ms_per_step": step_ms, "eager_ms_per_step": twin["ms_per_step"],
           "graph_peak_gb": peak_gb, "eager_peak_gb": twin["peak_gb"], "graphs": costs}
    print(f"graph train {label} ({mode}), {dname}: graphed vs eager twin after "
          f"{res['calls']} calls: state {verdict}, max_abs_diff {worst:.3e}; metrics "
          f"{'equal' if metrics_ok else 'DIFFER'}; ms/step graphed {step_ms:.3f} (median after "
          f"the warm step and the capture), eager {twin['ms_per_step']:.3f}; peak memory "
          f"graphed {peak_gb:.2f} GB, eager {twin['peak_gb']:.2f} GB; graphs "
          f"{costs_text(costs)} "
          f"| {card}", flush=True)
    if not metrics_ok:
        raise RuntimeError(f"graph train {label} ({mode}): metrics {ms} differ from the "
                           f"twin's {twin['metrics']}")
    if mode == "steps":
        batch = tr.put_batch(hosts[-1])
        prof = profile_steps(torch, lambda: tr.train_step(batch), TRAIN_PROFILE_STEPS, step_ms)
        busy = prof["busy_ms"]
        res.update(busy_ms=busy, graph_idle_share=prof["idle_share"],
                   eager_idle_share=None if busy is None else 1 - busy / twin["ms_per_step"],
                   top_kernels=prof["top"])
    if build.prepared.made != made:
        raise RuntimeError(f"graph train {label}: {build.prepared.made - made} prepared "
                           f"operands made")
    del tr
    torch.cuda.empty_cache()
    return res, ds


def room_graph_trainer(torch, graph):
    """The flagship at full width as a room-mask model (room_mask_condition,
    latent_dim and context_dim 64, the config's ResNet18 over 64x64 masks),
    weights from the seed, on the card, without a dataset (the IoU loss on
    DRIFT_BOUNDS, as phase 21's)."""
    from diffuscene_tpu_torch.models import SceneDiffusion, SceneModelConfig
    from diffuscene_tpu_torch.train.trainer import Trainer
    from diffuscene_tpu_torch.utils.config import load_config

    cfg = load_config(FLAGSHIP_CONFIG)
    net = dict(cfg["network"], sample_num_points=12, room_mask_condition=True, latent_dim=64)
    net["net_kwargs"] = dict(net["net_kwargs"], context_dim=64)
    scene = SceneDiffusion(SceneModelConfig.from_config(net, cfg.get("feature_extractor")),
                           bounds=par_bounds(), device=DEV)
    return Trainer(scene, cfg["training"], device=DEV, graph=graph).init(SEED)


def room_graph_batches(torch, n, batch=128):
    """``n`` random encoded bedroom batches (par_batch) with a room mask a
    scene: a filled rectangle of random corners on 64x64."""
    import numpy as np

    rng = np.random.default_rng(SEED + 50)
    out = []
    for i in range(n):
        host, _, _ = par_batch(torch, batch, SEED + 51 + i)
        masks = np.zeros((batch, 1, 64, 64), np.float32)
        for m in masks:
            y0, x0 = rng.integers(2, 20, 2)
            y1, x1 = rng.integers(44, 62, 2)
            m[0, y0:y1, x0:x1] = 1.0
        host["room_layout"] = masks
        out.append(host)
    return out


def graph_pair_case(torch, label, make, hosts, card, profile=False):
    """Phase 25, a case with a twin of its own: ``make(graph)``'s trainer
    eagerly (graph=False) and from graphs (the default) through one step a
    host batch: the states bit-equal expected (GRAPH_TOL), the metrics
    equal; each one's median ms/step and peak memory; with ``profile``, a
    profile of TRAIN_PROFILE_STEPS graphed steps."""
    from diffuscene_tpu_torch.ops import build

    made = build.prepared.made
    runs = {}
    for graph in (False, None):
        tr = make(graph)
        if tr.graph != (graph is None):
            raise RuntimeError(f"graph train {label}: graph={graph} gave graph={tr.graph}")
        dname = str(tr.scene.denoiser.compute_dtype).split(".")[-1]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, times = graph_train_timed(torch, tr, [
            lambda tr, h=h: tr.train_step(tr.put_batch(h)) for h in hosts])
        runs[graph] = {"metrics": ms, "state": train_state(torch, tr),
                       "ms": 1e3 * sorted(times[2:])[len(times[2:]) // 2],
                       "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
                       "costs": graph_costs(tr)}
        if graph is None and profile:
            batch = tr.put_batch(hosts[-1])
            runs[graph]["prof"] = profile_steps(torch, lambda: tr.train_step(batch),
                                                TRAIN_PROFILE_STEPS, runs[graph]["ms"])
        del tr
        torch.cuda.empty_cache()
    eager, graphed = runs[False], runs[None]
    equal, worst = state_apart(torch, graphed["state"], eager["state"])
    verdict = graph_verdict(label, equal, worst, GRAPH_TOL[dname])
    metrics_ok = graphed["metrics"] == eager["metrics"]
    res = {"dtype": dname, "steps": len(hosts), "bit_equal": equal, "max_abs_diff": worst,
           "metrics_equal": metrics_ok, "graph_ms_per_step": graphed["ms"],
           "eager_ms_per_step": eager["ms"], "graph_peak_gb": graphed["peak_gb"],
           "eager_peak_gb": eager["peak_gb"], "graphs": graphed["costs"]}
    print(f"graph train {label}, {dname}: graphed vs eager over {len(hosts)} steps: state "
          f"{verdict}, max_abs_diff {worst:.3e}; metrics {'equal' if metrics_ok else 'DIFFER'}; "
          f"ms/step graphed {graphed['ms']:.3f}, eager {eager['ms']:.3f} (medians after the "
          f"first two steps); peak memory graphed {graphed['peak_gb']:.2f} GB, eager "
          f"{eager['peak_gb']:.2f} GB; graphs "
          f"{costs_text(graphed['costs'])} "
          f"| {card}", flush=True)
    if not metrics_ok:
        raise RuntimeError(f"graph train {label}: metrics {graphed['metrics']} differ from "
                           f"{eager['metrics']}")
    if "prof" in graphed:
        busy = graphed["prof"]["busy_ms"]
        res.update(busy_ms=busy, graph_idle_share=graphed["prof"]["idle_share"],
                   eager_idle_share=None if busy is None else 1 - busy / eager["ms"],
                   top_kernels=graphed["prof"]["top"])
    if build.prepared.made != made:
        raise RuntimeError(f"graph train {label}: {build.prepared.made - made} prepared "
                           f"operands made")
    return res


def ae_apart(torch, tr, want, m_got, m_want, lr):
    """One AE step's departures from its twin's (AE_GRAPH_TOL's terms):
    relative metrics, BatchNorm moments and each Adam moment buffer (all
    parameters' in relative L2), and the parameters in lr (par_apart)."""
    from diffuscene_tpu_torch.train.optim import flatten

    def flat(slot):
        return flatten([t.float() for t in slot])

    got = tr.state_dict()
    names = {n for n, _ in tr.model.named_parameters()}
    rel = {k: abs(m_got[k] - m_want[k]) / abs(m_want[k]) for k in m_want}
    buffers = max(((got["model"][k].float() - v.float()).abs().max()
                   / v.float().abs().max().clamp_min(1e-30)).item()
                  for k, v in want["model"].items() if k not in names)
    moments = max(((a - b).norm() / b.norm().clamp_min(1e-30)).item()
                  for a, b in ((flat(sa), flat(sb)) for sa, sb in
                               zip(got["optimizer"]["slots"], want["optimizer"]["slots"])))
    worst, loose = par_apart({k: got["model"][k].float().cpu() for k in names},
                             {k: want["model"][k].float().cpu() for k in names}, lr, AE_GRAPH_TOL)
    return {"loss": max(rel[k] for k in ("loss", "loss.cd", "loss.kl")),
            "gradnorm": rel["gradnorm"], "buffers": buffers, "moments": moments,
            "max_lr": worst, "loose_share": loose}


def graph_ae_case(torch, twin, card):
    """Phase 25, the shape AE: a graphed trainer (the default) loads phase
    6's eager state before each of its first AE_GRAPH_STEPS steps and takes
    the step on the same clouds: each step's departures from the eager one
    within AE_GRAPH_TOL, exactly 2 chamfer-kernel launches a step, no
    prepared operand; a second eager trainer through the first steps the
    same way, printed beside them (two eager steps from one state differ as
    much); then a profile of AE_PROFILE_STEPS graphed steps."""
    from diffuscene_tpu_torch.ops import build
    from diffuscene_tpu_torch.ops import chamfer as ch

    made = build.prepared.made
    runs = {}
    for label, graph, n in (("graphed", None, AE_GRAPH_STEPS), ("eager", False, 3)):
        tr, cfg = ae_trainer(torch, graph=graph)
        if tr.graph != (graph is None):
            raise RuntimeError(f"graph train AE: graph={graph} gave graph={tr.graph}")
        lr = float(cfg["training"]["lr"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ch.directed_nn.launches = 0
        apart, times = [], []
        for k in range(n):
            tr.load_state_dict(twin["before"][k])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = tr.train_step(twin["clouds"])
            times.append(time.perf_counter() - t0)
            apart.append(ae_apart(torch, tr, twin["after"][k], m, twin["metrics"][k], lr))
        runs[label] = {"apart": apart, "launches": ch.directed_nn.launches,
                       "ms": 1e3 * sorted(times[2:])[len(times[2:]) // 2],
                       "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
                       "costs": graph_costs(tr) if graph is None else []}
        if graph is None:
            prof = profile_steps(torch, lambda: tr.train_step(twin["clouds"]), AE_PROFILE_STEPS,
                                 runs[label]["ms"], named=(("B3", "chamfer_nn_sm90"),))
        del tr
    graphed, eager = runs["graphed"], runs["eager"]
    worst = {k: max(a[k] for a in graphed["apart"]) for k in graphed["apart"][0]}
    witness = {k: max(a[k] for a in eager["apart"]) for k in eager["apart"][0]}
    bad = {k: v for k, v in worst.items() if k in AE_GRAPH_TOL and v > AE_GRAPH_TOL[k]}
    if worst["loose_share"] >= AE_GRAPH_TOL["loose_share"]:
        bad["loose_share"] = worst["loose_share"]
    busy = prof["busy_ms"]
    res = {"steps": AE_GRAPH_STEPS, "worst": worst, "eager_witness": witness,
           "launches": graphed["launches"], "graph_ms_per_step": graphed["ms"],
           "eager_ms_per_step": twin["ms_per_step"], "graph_peak_gb": graphed["peak_gb"],
           "graphs": graphed["costs"], "busy_ms": busy,
           "graph_idle_share": prof["idle_share"],
           "eager_idle_share": None if busy is None else 1 - busy / twin["ms_per_step"],
           "b3_ms": prof["named_ms"].get("B3")}
    print(f"graph train AE, B=16, {AE_POINTS} points: {AE_GRAPH_STEPS} graphed steps, each from "
          f"phase 6's eager state, against phase 6's step: worst {worst} (tol {AE_GRAPH_TOL}; "
          f"a second eager trainer the same way over 3 steps: {witness}); chamfer launches "
          f"{graphed['launches']} (expected {2 * AE_GRAPH_STEPS}); ms/step graphed "
          f"{graphed['ms']:.3f}, eager {twin['ms_per_step']:.3f} (phase 6); peak memory graphed "
          f"{graphed['peak_gb']:.2f} GB; graphs "
          f"{costs_text(graphed['costs'])} "
          f"{'ok' if not bad else 'FAIL'} | {card}", flush=True)
    if bad:
        raise RuntimeError(f"graph train AE: a graphed step departs from the eager one: {bad}")
    if graphed["launches"] != 2 * AE_GRAPH_STEPS or eager["launches"] != 2 * 3:
        raise RuntimeError(f"graph train AE: chamfer launches {graphed['launches']} graphed, "
                           f"{eager['launches']} eager")
    if build.prepared.made != made:
        raise RuntimeError(f"graph train AE: {build.prepared.made - made} prepared operands made")
    torch.cuda.empty_cache()
    return res


def graph_eval_calls(trainer, calls):
    """Each of ``calls`` ((batch, t, noise) of scene eval steps, or clouds of
    AE eval steps) through ``trainer.eval_step`` -> (their metrics, their
    host-clock seconds, the chamfer kernel's launches each made)."""
    import torch

    from diffuscene_tpu_torch.ops import chamfer as ch

    out, times, launches = [], [], []
    for call in calls:
        n = ch.directed_nn.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if isinstance(call, tuple):
            host, t, noise = call
            out.append(trainer.eval_step(trainer.put_batch(host), t, noise))
        else:
            out.append(trainer.eval_step(call))
        times.append(time.perf_counter() - t0)
        launches.append(ch.directed_nn.launches - n)
    return out, times, launches


def graph_eval_case(torch, card, flag, ds, ae_twin):
    """Phase 25 (b): the eval steps from CUDA graphs (the default where the
    train step runs from one), each against a graph=False twin from the
    same seed and state, bit for bit (GRAPH_TOL the gate, as in 24 and 25):
    the flagship at B=128 f32 (phase 12's batches: one three times, one
    with given t and noise twice, a ragged last batch of
    GRAPH_EVAL_RAGGED_B scenes twice, t and noise otherwise drawn inside the
    graph; every step's metrics, the generator's state after, the
    parameters untouched) and the shape AE at B=16 from phase 6's trained
    state (its clouds three times, a ragged batch of GRAPH_EVAL_RAGGED_AE
    clouds twice; eval-mode BatchNorm, the posterior mean), exactly 2
    chamfer-kernel launches an AE eval step under replay; then
    GRAPH_EVAL_TIMED more steps of each, graphed and eager (median
    ms/step); no prepared kernel operand made."""
    from diffuscene_tpu_torch.ops import build
    from diffuscene_tpu_torch.train.optim import flatten

    made = build.prepared.made
    hosts = flag["hosts"]
    gen = torch.Generator().manual_seed(SEED + 90)
    b = len(next(iter(hosts[1].values())))
    given = (torch.randint(0, T, (b,), generator=gen).to(DEV),
             torch.randn(b, 12, 62, generator=gen).to(DEV))
    ragged = {k: v[:GRAPH_EVAL_RAGGED_B] for k, v in hosts[2].items()}
    scene_calls = ([(hosts[0], None, None)] * 3 + [(hosts[1], *given)] * 2
                   + [(ragged, None, None)] * 2)
    timed = [(hosts[0], None, None)] * GRAPH_EVAL_TIMED
    out = {}
    runs = {}
    for label, graph in (("graphed", None), ("eager", False)):
        _, _, tr = scene_trainer(torch, FLAGSHIP_CONFIG, DEV, flag["data_dir"], graph=graph,
                                 ds=ds)
        if tr.graph != (graph is None):
            raise RuntimeError(f"graph eval flagship: graph={graph} gave graph={tr.graph}")
        params = flatten([p.detach() for p in tr.params]).clone()
        ms, _, _ = graph_eval_calls(tr, scene_calls)
        _, times, _ = graph_eval_calls(tr, timed)
        untouched = torch.equal(flatten([p.detach() for p in tr.params]), params)
        runs[label] = {"metrics": ms, "generator": tr.generator.get_state(),
                       "ms": 1e3 * sorted(times)[len(times) // 2], "untouched": untouched,
                       "costs": graph_costs(tr) if graph is None else []}
        del tr, params
        torch.cuda.empty_cache()
    g, e = runs["graphed"], runs["eager"]
    equal = g["metrics"] == e["metrics"]
    worst = max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-30)
                for x, y in zip(g["metrics"], e["metrics"]) for k in y)
    gen_equal = torch.equal(g["generator"], e["generator"])
    verdict = graph_verdict("eval flagship", equal, worst, GRAPH_TOL["float32"])
    print(f"graph eval flagship B=128 f32: {len(scene_calls)} eval steps (a batch 3 times, given "
          f"t and noise twice, a ragged batch of {GRAPH_EVAL_RAGGED_B} twice) against a "
          f"graph=False twin: metrics {verdict} (worst relative {worst:.3e}), generator state "
          f"equal {gen_equal}, parameters untouched {g['untouched']}; ms/step graphed "
          f"{g['ms']:.3f}, eager {e['ms']:.3f} (median of {GRAPH_EVAL_TIMED}); graphs "
          f"{costs_text(g['costs'])} | {card}", flush=True)
    if not (gen_equal and g["untouched"] and e["untouched"]):
        raise RuntimeError(f"graph eval flagship: generator state equal {gen_equal}, parameters "
                           f"untouched {g['untouched']}, {e['untouched']}")
    out["flagship"] = {"steps": len(scene_calls), "bit_equal": equal, "worst_rel": worst,
                       "graph_ms_per_step": g["ms"], "eager_ms_per_step": e["ms"],
                       "graphs": g["costs"]}

    clouds = ae_twin["clouds"]
    ae_calls = [clouds] * 3 + [clouds[:GRAPH_EVAL_RAGGED_AE]] * 2
    runs = {}
    for label, graph in (("graphed", None), ("eager", False)):
        tr, _ = ae_trainer(torch, graph=graph)
        tr.load_state_dict(ae_twin["after"][-1])
        ms, _, launches = graph_eval_calls(tr, ae_calls)
        _, times, timed_launches = graph_eval_calls(tr, [clouds] * GRAPH_EVAL_TIMED)
        runs[label] = {"metrics": ms, "launches": launches + timed_launches,
                       "ms": 1e3 * sorted(times)[len(times) // 2],
                       "costs": graph_costs(tr) if graph is None else []}
        del tr
    g, e = runs["graphed"], runs["eager"]
    equal = g["metrics"] == e["metrics"]
    worst = max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-30)
                for x, y in zip(g["metrics"], e["metrics"]) for k in y)
    verdict = graph_verdict("eval AE", equal, worst, GRAPH_TOL["float32"])
    n = len(ae_calls) + GRAPH_EVAL_TIMED
    print(f"graph eval AE B=16, {AE_POINTS} points, phase 6's trained state: {len(ae_calls)} "
          f"eval steps (the clouds 3 times, {GRAPH_EVAL_RAGGED_AE} of them twice) against a "
          f"graph=False twin: metrics {verdict} (worst relative {worst:.3e}); chamfer launches "
          f"a step graphed {g['launches']} (expected 2 each, {2 * n} in all), eager "
          f"{sum(e['launches'])}; ms/step graphed {g['ms']:.3f}, eager {e['ms']:.3f} (median of "
          f"{GRAPH_EVAL_TIMED}); graphs {costs_text(g['costs'])} | {card}", flush=True)
    if g["launches"] != [2] * n or sum(e["launches"]) != 2 * n:
        raise RuntimeError(f"graph eval AE: chamfer launches {g['launches']} graphed, "
                           f"{e['launches']} eager")
    if build.prepared.made != made:
        raise RuntimeError(f"graph eval: {build.prepared.made - made} prepared operands made")
    out["ae"] = {"steps": len(ae_calls), "bit_equal": equal, "worst_rel": worst,
                 "launches": sum(g["launches"]), "launches_per_step": sorted(set(g["launches"])),
                 "graph_ms_per_step": g["ms"], "eager_ms_per_step": e["ms"],
                 "graphs": g["costs"]}
    torch.cuda.empty_cache()
    return out


def phase_train_graph(torch, card, twins):
    """Phase 25: every train step from a CUDA graph, each case held to its
    graph=False twin (the docstring's phase 25): ``twins`` holds phases 6's,
    12's and 13's ("ae", "flagship", "b512").  Returns each case's
    summary."""
    t0 = time.perf_counter()
    flag = twins["flagship"]
    out, ds = {"card": card}, None
    for mode in ("steps", "scan", "resume"):
        out[f"flagship_{mode}"], ds = graph_scene_case(torch, "flagship B=128", flag, mode, card,
                                                       ds)
    out["b512"], _ = graph_scene_case(torch, "b512 B=512", twins["b512"], "steps", card)
    out["ae"] = graph_ae_case(torch, twins["ae"], card)
    out["room_mask"] = graph_pair_case(
        torch, "room-mask flagship B=128", lambda graph: room_graph_trainer(torch, graph),
        room_graph_batches(torch, GRAPH_TRAIN_STEPS), card, profile=True)
    out["grad_accum2"] = graph_pair_case(
        torch, "flagship grad_accum 2 B=128",
        lambda graph: scene_trainer(torch, FLAGSHIP_CONFIG, DEV, flag["data_dir"], graph=graph,
                                    ds=ds, training={"grad_accum": 2})[2],
        flag["hosts"][:GRAPH_TRAIN_STEPS], card)
    out["eval"] = graph_eval_case(torch, card, flag, ds, twins["ae"])
    out["phase_s"] = time.perf_counter() - t0
    print(f"graph train: phase 25 took {out['phase_s']:.1f} s | {card}", flush=True)
    return out


def protocol_finite(report):
    """Every metric of a protocol report, (name, value) pairs: generate's
    metrics and each pixel row's numbers."""
    out = [(f"generate_metrics.{k}", v) for k, v in report["generate_metrics"].items()]
    for key in ("fid_protocol_pixel", "fid_control_half_vs_half_pixel", "ipr_protocol_pixel",
                "ipr_5000x5000_pixel"):
        out += [(f"{key}.{k}", v) for k, v in report[key].items()
                if isinstance(v, (int, float)) and not isinstance(v, bool)]
    return out


def phase_protocol(torch, card):
    """Phase 26: the synthetic eval protocol (cli/eval_protocol.py) on the
    flagship config, f32, at PROTOCOL_SCALE: 1300 rooms trained for 2
    epochs through the train CLI (PROTOCOL_BATCHES batches an epoch at
    B=128: a chunk of 8 from the train_step_scan graph, then one step),
    64 + 64 scenes by DDPM-1000 at B=64 (exactly 28,000 B1 and 1,000 B2 a
    generate stage), 128 GT renders, the pixel FID/KID and IPR rows with
    the InceptionV3 and VGG16 refusals: every stage's outputs present and
    every metric finite; then the protocol again on the same directory,
    every stage skipped and the report's metrics equal.  Prints its own
    time."""
    import shutil

    from diffuscene_tpu_torch.cli import eval_protocol

    t0 = time.perf_counter()
    shutil.rmtree(PROTOCOL_OUT, ignore_errors=True)
    first = eval_protocol.main([PROTOCOL_OUT, *PROTOCOL_SCALE])
    first_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    again = eval_protocol.main([PROTOCOL_OUT, *PROTOCOL_SCALE,
                                "--out", os.path.join(PROTOCOL_OUT, "again.json")])
    again_s = time.perf_counter() - t1
    stages, train = first["stages"], first["stages"]["train"]
    n_seq, n_extra = first["protocol"]["n_sequences"], first["protocol"]["n_extra"]
    want = {"B1": 28 * T * n_seq // PROTOCOL_GEN_B, "B2": T * n_seq // PROTOCOL_GEN_B}
    launches = first["card"]["launches"]
    renders = {d: len([f for f in os.listdir(os.path.join(PROTOCOL_OUT, d))
                       if f.endswith(".png")])
               for d in ("gen_protocol", "gen_extra", "fake_5000", "gt_renders")}
    metrics = protocol_finite(first)
    bad = [k for k, v in metrics if not math.isfinite(v)]
    strip = lambda r: {k: v for k, v in r.items() if k != "stages"}
    checks = {
        "every stage ran": list(stages) == list(eval_protocol.STAGES)
        and not any(v["skipped"] for v in stages.values()),
        "train steps": train["steps"] == 2 * PROTOCOL_BATCHES == train["epochs"]
        * train["batches_per_epoch"],
        "graphed step": train["step_probe"]["graphed"] is True,
        "launches": launches == {"generate_1000": want, "generate_4000": want},
        "renders": renders == {"gen_protocol": n_seq, "gen_extra": n_extra,
                               "fake_5000": n_seq + n_extra, "gt_renders": n_seq + n_extra},
        "refusals": "blocked" in first["fid_protocol"] and "blocked" in first["ipr_protocol"],
        "finite": not bad,
        "second run skipped": all(v["skipped"] for v in again["stages"].values()),
        "second run equal": strip(again) == strip(first),
    }
    phase_s = time.perf_counter() - t0
    failed = [k for k, v in checks.items() if not v]
    gm = first["generate_metrics"]
    print(f"protocol: {first['n_scenes_dataset']} rooms, {train['epochs']} epochs "
          f"({train['steps']} steps at B={train['batch_size']}, {train['steps_per_s']:.2f} "
          f"steps/s; the step alone {train['step_probe']['ms_per_step']:.1f} ms "
          f"{'graphed' if train['step_probe']['graphed'] else 'eager'}, a "
          f"batch's assembly {train['step_probe']['loader_ms_per_batch']:.1f} ms), generate "
          f"{n_seq} + {n_extra} (launches {launches}, expected {want} each), renders {renders}; "
          f"CKL {gm['categorical_kl']:.4f}, pixel FID {first['fid_protocol_pixel']['fid']:.4f} "
          f"(control {first['fid_control_half_vs_half_pixel']['fid']:.4f}), IPR "
          f"{first['ipr_protocol_pixel']['precision']:.4f} / "
          f"{first['ipr_protocol_pixel']['recall']:.4f}; {len(metrics)} metrics, non-finite "
          f"{bad}; stage seconds "
          f"{ {k: round(v['seconds'], 1) for k, v in stages.items()} }; the second run "
          f"{again_s:.1f} s, every stage skipped {checks['second run skipped']}, metrics "
          f"equal {checks['second run equal']} {'ok' if not failed else 'FAIL'} | {card}",
          flush=True)
    print(f"protocol: phase 26 took {phase_s:.1f} s (the first run {first_s:.1f} s)", flush=True)
    if failed:
        raise RuntimeError(f"protocol: failed {failed}")
    return {"card": card, "phase_s": phase_s, "first_s": first_s, "again_s": again_s,
            "stages": {k: v["seconds"] for k, v in stages.items()}, "train": train,
            "launches": launches, "renders": renders, "generate_metrics": gm,
            "fid_pixel": first["fid_protocol_pixel"],
            "fid_control_pixel": first["fid_control_half_vs_half_pixel"],
            "ipr_pixel": first["ipr_protocol_pixel"],
            "ipr_full_pixel": first["ipr_5000x5000_pixel"]}


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

    t0 = t_run = time.perf_counter()

    def mark(label):
        print(f"time: {label} done at {time.perf_counter() - t_run:.1f} s", flush=True)

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
    if only == "--only-data":       # the data pipeline and room-mask model alone: phase 19
        print(json.dumps({"data": phase_data(torch, ch, card)}))
        print(card_line())
        return 0
    if only == "--only-rest":       # the single-card modules ported last alone: phase 20
        print(json.dumps({"rest": phase_rest(torch, card)}))
        print(card_line())
        return 0
    if only == "--only-parallel":   # parallel/* and mixed precision alone: phase 21
        print(json.dumps({"parallel": phase_parallel(torch, card)}))
        print(card_line())
        return 0
    if only == "--only-wide":       # the f32 B1 and B2 kernels widened alone: phase 22
        print(json.dumps({"wide": phase_wide(rb, at, torch, card)}))
        print(card_line())
        return 0
    if only == "--only-wide-chain":  # B4 widened alone: phase 23
        print(json.dumps({"wide_chain": phase_wide_chain(fl, torch, card)}))
        print(card_line())
        return 0
    if only == "--only-graph":      # the samplers from CUDA graphs alone: phase 24
        print(json.dumps({"graph": phase_graph(torch, card)}))
        print(card_line())
        return 0
    if only == "--only-train-graph":  # the train steps from CUDA graphs: 6, 12, 13 and 25
        twins = {"ae": {}}
        phase_autoencoder(ch, torch, twins["ae"])
        phase_train(torch, card, twins, cli=False)
        print(json.dumps({"train_graph": phase_train_graph(torch, card, twins)}))
        print(card_line())
        return 0
    if only == "--only-protocol":   # the synthetic eval protocol at a reduced scale: phase 26
        print(json.dumps({"protocol": phase_protocol(torch, card)}))
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
    mark("phases 1-2")

    resblock_plan(rb, torch)
    rb_worst, rb_out = resblock_forward(*phase_resblock(rb, torch))
    rb_fwd, rb_bound_ms, rb_bound_by = rb_out["bfloat16"]
    rb32_fwd, rb32_bound_ms, _ = rb_out["float32"]
    at_worst, at_main = attention_phase(at, torch)
    profiler_tally("phases 7-8")
    mark("phases 7-8")

    scene32 = phase_forward(torch, torch.float32)
    scene = phase_forward(torch, torch.bfloat16)
    mark("phases 3, 9")

    # the first slice's main path: 1000-step DDPM sample, every chain
    # through the kernel
    # (eagerly: phase 24 holds a graph of the same sample to it)
    rows_eager = {}
    chain_launches = phase_rows_sample(torch, scene, card, graph=False, record=rows_eager)
    mark("phase 4")

    # the 3-D engine's slice's main path: every ResnetBlock on B1 and
    # mid_attn on B2, by DPM-Solver++-20 (phase 22 holds a bf16 3-D DDPM
    # over CUT_STEPS steps, 17 of its 28 B1 launches a step on resblock_sm90)
    rb_launches, at_launches = phase_engine_samples(torch, scene, card, ddpm=False)
    del scene
    mark("phases 10-11")
    # phase 15: the flagship config's own dtype, f32, through the rows
    # engine (DPM-Solver++-20 here, for the script's time; DDPM-1000 in
    # --only-f32-engine) and the 3-D engine
    chain32_launches = phase_rows_sample(torch, scene32, card, dpm=True)
    engine_eager = {}
    rb32_launches, at32_launches = phase_engine_samples(torch, scene32, card,
                                                        dpm_batch=GENERATE_B, graph=False,
                                                        record=engine_eager)
    mark("phase 15 samples")
    phase_drift(torch, scene32)
    del scene32
    mark("phase 15 drift")
    torch.cuda.empty_cache()
    # this slice's main path: every sampler from a CUDA graph, held to its
    # eager loop (B1 and B2, B4)
    graphs = phase_graph(torch, card, tasks=False,
                         eager={"ddpm_3d_b64": engine_eager, "ddpm_rows_bf16_b64": rows_eager})
    mark("phase 24")
    torch.cuda.empty_cache()
    # this slice's main path: the B1 and B2 kernels at the other widths and
    # groupings in both dtypes, the wide models and the 4- and 16-group
    # ones sampled through fused=True, f32 and bf16
    wide = phase_wide(rb, at, torch, card)
    profiler_tally("phase 22")
    mark("phase 22")
    wide_samples, wk = wide["samples"], wide["kernels"]
    wide_b1, wide_b2 = wk["float32"]["b1"]["wide"], wk["float32"]["b2"]
    bf_b1, bf_b2 = wk["bfloat16"]["b1"]["wide"], wk["bfloat16"]["b2"]
    bf_ddpm = wide_samples["bf16_wide_ddpm"]["by_kernel"]
    torch.cuda.empty_cache()
    # this slice's main path: the chain kernel (B4) at B1's widths and
    # groupings in both dtypes, the dim-1024 equal-width model through the
    # rows engine (bf16 DDPM over CUT_STEPS steps, f32 DPM-Solver++-20)
    # beside the 3-D
    # engine, the 4- and 16-group and dim-256 models through the rows engine
    wchain = phase_wide_chain(fl, torch, card)
    profiler_tally("phase 23")
    mark("phase 23")
    wc_k, wc_s = wchain["kernels"], wchain["samples"]
    torch.cuda.empty_cache()

    cham = phase_chamfer(ch, torch)
    # the second slice's main path: AE training steps, every chamfer on the
    # kernel (eagerly: phase 25 holds the graphed steps to them)
    twins = {"ae": {}}
    cham_launches = phase_autoencoder(ch, torch, twins["ae"])
    profiler_tally("phases 5-6")
    mark("phases 5-6")
    torch.cuda.empty_cache()
    # this slice's main path: the scene model's train steps and the train
    # and generate CLIs (B1 and B2 in generate)
    train = phase_train(torch, card, twins)
    torch.cuda.empty_cache()
    mark("phases 12-14")
    # this slice's main path: every train step from a CUDA graph, held to
    # phases 6's, 12's and 13's eager steps and to twins of its own
    train_graph = phase_train_graph(torch, card, twins)
    del twins
    torch.cuda.empty_cache()
    mark("phase 25")
    # this slice's main paths: the data- and tensor-parallel trainers and
    # the sharded sampler over torch.distributed (B1 and B2, B4 in the
    # samples, B3 in the AE step), and mixed precision beside phase 13's
    # step; run before the later phases grow this process
    par = phase_parallel(torch, card, b512_plain=train["b512"]["ms_per_step"])
    mark("phase 21")
    par_two = par["two_ranks"]
    par_launches = {"nccl_one_rank": par["nccl_one_rank"]["launches"],
                    "gloo_rank": {"sample_3d": par_two["sample_True"]["launches"],
                                  "sample_rows": par_two["sample_rows"]["launches"],
                                  "ae_step": par_two["ae"]["launches"]}}
    torch.cuda.empty_cache()
    # this slice's main paths: scene completion and re-arrangement, f32,
    # through the 3-D engine (B1 and B2), and the rearrange training
    tasks = phase_tasks(torch, card, graphs)
    mark("phase 16")
    task_launches = {k: v["launches"] for k, v in tasks["samples"].items()}
    torch.cuda.empty_cache()
    # this slice's main path: text-conditioned generation through both
    # engines (B1 and B2, B4), the text train step and the text CLIs
    text = phase_text(torch, card, graphs)
    mark("phase 17")
    text_launches = {k: v["launches"] for k, v in text["samples"].items() if k != "roll"}
    torch.cuda.empty_cache()
    # this slice's main path: run/generate.sh's command with its renders and
    # box metrics (B1 and B2), the mesh path, FID/KID and precision/recall
    ev = phase_eval(torch, card)
    mark("phase 18")
    eval_launches = ev["generate"]["launches"]
    torch.cuda.empty_cache()
    # this slice's main path: the raw-data pipeline (B3 in the AE's steps),
    # then the room-mask flagship trained and sampled on its cache (B1 and
    # B2 in generate, B4 through the rows engine)
    data = phase_data(torch, ch, card)
    mark("phase 19")
    data_samples = data["samples"]
    torch.cuda.empty_cache()
    # this slice's main paths: the native loader, the optimizers, the trace
    # windows and async checkpoints in the CLIs (B1 and B2 in generate), the
    # Fourier time embedding through both engines (B1, B2 and B4), unequal
    # dim_mults, the export
    rest = phase_rest(torch, card, numpy_ms=train["flagship"]["ms_per_step"])
    profiler_tally("phase 20")
    mark("phase 20")
    rest_samples = rest["samples"]
    torch.cuda.empty_cache()
    # this slice's main path: the synthetic eval protocol through the CLIs,
    # trained (the graphed train and eval steps), generated (B1 and B2),
    # rendered and scored, then resumed with every stage skipped
    proto = phase_protocol(torch, card)
    mark("phase 26")

    print(json.dumps({"train": train}))
    print(json.dumps({"tasks": tasks}))
    print(json.dumps({"text": text}))
    print(json.dumps({"eval": ev}))
    print(json.dumps({"data": data}))
    print(json.dumps({"rest": rest}))
    print(json.dumps({"parallel": par}))
    print(json.dumps({"wide": wide}))
    print(json.dumps({"wide_chain": wchain}))
    print(json.dumps({"graph": graphs}))
    print(json.dumps({"train_graph": train_graph}))
    print(json.dumps({"protocol": proto}))
    graph_launches = {k: v["launches"] for k, v in graphs.items() if k != "phase_s"}
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
        "data_launches": data_samples["ddpm_rows"]["launches"][0],
        "rest_launches": {"fourier_rows": rest_samples["fourier_rows"]["launches"][0]},
        "parallel_launches": {"rank_sample_rows": par_launches["gloo_rank"]["sample_rows"]["B4"]},
        "graph_launches": {k: v[2] for k, v in graph_launches.items() if v[2]},
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
        "data_launches": data["pipeline"]["ae_launches"],
        "rest_launches": rest["chamfer_launches"],
        "parallel_launches": {"rank_ae_step": par_launches["gloo_rank"]["ae_step"]["B3"]},
        "graph_launches": train_graph["ae"]["launches"],
        "graph_eval_launches": train_graph["eval"]["ae"]["launches"],
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
        "data_launches": {"generate": data_samples["generate"]["launches"][0],
                          "ddpm_3d": data_samples["ddpm_3d"]["launches"][0]},
        "rest_launches": {"generate": rest["generate"]["launches"][0],
                          "fourier_3d": rest_samples["fourier_3d"]["launches"][0]},
        "parallel_launches": {"nccl_one_rank_sample": par_launches["nccl_one_rank"]["B1"],
                              "rank_sample_3d": par_launches["gloo_rank"]["sample_3d"]["B1"]},
        "wide_launches": {k: v["launches"][0] for k, v in wide_samples.items()},
        "graph_launches": {k: v[0] for k, v in graph_launches.items() if v[0]},
        "protocol_launches": {k: v["B1"] for k, v in proto["launches"].items()},
        "wide_max_abs_err": wk["float32"]["b1_worst"],
        "wide_ms": wide_b1["all"]["ms"],
        "wide_graph_ms": wide_b1["all"]["graph"],
        "wide_plain_ms": wide_b1["all"]["plain"],
        "wide_bound_ms": wide_b1["all"]["bound_ms"],
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
        "data_launches": {"generate": data_samples["generate"]["launches"][1],
                          "ddpm_3d": data_samples["ddpm_3d"]["launches"][1]},
        "rest_launches": {"generate": rest["generate"]["launches"][1],
                          "fourier_3d": rest_samples["fourier_3d"]["launches"][1]},
        "parallel_launches": {"nccl_one_rank_sample": par_launches["nccl_one_rank"]["B2"],
                              "rank_sample_3d": par_launches["gloo_rank"]["sample_3d"]["B2"]},
        "wide_launches": {k: v["launches"][1] for k, v in wide_samples.items()},
        "graph_launches": {k: v[1] for k, v in graph_launches.items() if v[1]},
        "protocol_launches": {k: v["B2"] for k, v in proto["launches"].items()},
        "wide_ms": wide_b2["C=1024"]["ms"],
        "wide_graph_ms": wide_b2["C=1024"]["graph"],
        "wide_plain_ms": wide_b2["C=1024"]["plain"],
        "wide_bound_ms": wide_b2["C=1024"]["bound_ms"],
    }, {
        "name": "resblock_bf16_wide",
        "route": "cuda",
        "source": "diffuscene_tpu_torch/csrc/fused_resblock.cu",
        "replaces": "diffuscene_tpu/ops/fused_resblock.py:89",
        "launches": bf_ddpm["resblock_bf16_wide"],
        "max_abs_err": wk["bfloat16"]["b1_worst"],
        "ms": bf_b1["C=1024"]["ms"],
        "graph_ms": bf_b1["C=1024"]["graph"],
        "plain_ms": bf_b1["C=1024"]["plain"],
        "bound_ms": bf_b1["C=1024"]["bound_ms"],
        "bound_by": bf_b1["C=1024"]["bound_by"],
        "library_ms": None,
        "wide_launches": {k: v["by_kernel"].get("resblock_bf16_wide", 0)
                          for k, v in wide_samples.items() if k.startswith("bf16_")},
        "forward_28_graph_ms": {k: wk["bfloat16"]["b1"][k]["all"]["graph"]
                                for k in ("wide", "groups4", "groups16")},
    }, {
        "name": "attention_bf16_wide",
        "route": "cuda",
        "source": "diffuscene_tpu_torch/csrc/set_attention.cu",
        "replaces": "diffuscene_tpu/ops/attention.py:35",
        "launches": bf_ddpm["attention_bf16_wide"],
        "max_abs_err": wk["bfloat16"]["b2_worst"],
        "ms": bf_b2["C=1024"]["ms"],
        "graph_ms": bf_b2["C=1024"]["graph"],
        "plain_ms": bf_b2["C=1024"]["plain"],
        "bound_ms": bf_b2["C=1024"]["bound_ms"],
        "bound_by": bf_b2["C=1024"]["bound_by"],
        "library_ms": None,
        "c256_graph_ms": bf_b2["C=256"]["graph"],
        "c512_graph_ms": bf_b2["C=512 wide"]["graph"],
    }] + [wide_chain_entry(dname, wc_k, wc_s) for dname in ("float32", "bfloat16")]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
