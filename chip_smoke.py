#!/usr/bin/env python3
"""Smoke run of the PyTorch port (diffuscene_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no "ok" line):

1. the card's name and power limit (nvidia-smi), and the build of the CUDA
   chain kernel from csrc/fused_chain.cu (nvcc, sm_90a) with its time;
2. the chain kernel against its plain torch version on the card, at the
   flagship's shapes (C=512, B=64, N=12 and N=21), every chain variant, in
   bf16 and f32, with each case's time beside the plain version's;
3. one full-width forward of the flagship bedroom denoiser (dim 512, 4
   levels, N=12, point_dim 62, random weights from a seed): the rows engine
   on the kernel against the plain Unet1D module forward, in f32 and bf16;
4. a full 1000-step DDPM sample of 64 scenes through
   SceneDiffusion.sample(fused="rows"), bf16: shape, finiteness, and 19
   chain-kernel calls per step (apply_chain.launches).

The line before the last is the card's name and power limit again, the one
before it a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}.  Exits non-zero without a CUDA device.
"""
import json
import subprocess
import sys
import time

C, B, T = 512, 64, 1000
SEED = 0
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


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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


def phase_kernels(fl, torch):
    """Kernel vs plain version; returns (worst error, per-case results)."""
    results, failures, worst = {}, [], 0.0
    seed = 100
    for n in (12, 21):
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            for variant in VARIANTS:
                seed += 1
                chain, x, films, skips = chain_case(fl, torch, variant, n, dtype, seed)
                got = fl.apply_chain(chain, x, films, skips, n_per_scene=n)
                want = fl.apply_chain_reference(chain, x, films, skips, n_per_scene=n)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                finite = bool(torch.isfinite(got.float()).all())
                ok = finite and torch.allclose(got.float(), want.float(), **KERNEL_TOL[dname])
                worst = max(worst, err)
                ms = cuda_ms(lambda: fl.apply_chain(chain, x, films, skips, n_per_scene=n))
                plain = cuda_ms(lambda: fl.apply_chain_reference(chain, x, films, skips,
                                                                 n_per_scene=n))
                results[(n, dname, variant)] = (err, ms, plain)
                print(f"kernel fused_chain N={n} {dname:8s} {variant:9s} max_abs_err={err:.3e} "
                      f"tol={KERNEL_TOL[dname]} {'ok' if ok else 'FAIL'} "
                      f"kernel_ms={ms:.4f} plain_ms={plain:.4f}", flush=True)
                if not ok:
                    failures.append((n, dname, variant, err, finite))
    # a ragged last tile: 63 scenes of 12 rows, tiles of 2 scenes
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        chain, x, films, skips = chain_case(fl, torch, "row_skip", 12, dtype, 7, batch=63)
        got = fl.apply_chain(chain, x, films, skips, n_per_scene=12)
        want = fl.apply_chain_reference(chain, x, films, skips, n_per_scene=12)
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), **KERNEL_TOL[dname])
        worst = max(worst, err)
        print(f"kernel fused_chain N=12 B=63 {dname:8s} row_skip  max_abs_err={err:.3e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append((12, dname, "row_skip B=63", err, True))
    if failures:
        raise RuntimeError(f"chain kernel disagrees with its plain version: {failures}")
    return worst, results


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
    from diffuscene_tpu_torch.models import inference as inf
    from diffuscene_tpu_torch.utils.convert import denoiser_tree

    dname = str(dtype).split(".")[-1]
    scene = flagship(torch, dtype)
    net = scene.denoiser
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    x = torch.randn(B, 12, 62, generator=g, device="cuda")
    t = torch.randint(0, T, (B,), generator=g, device="cuda")
    cond = scene.make_condition(B)
    t0 = time.perf_counter()
    prep = inf.prepare_inference_params(net, denoiser_tree(net), num_timesteps=T)
    ctx = inf.precompute_conditioning(net, prep, cond)
    chains = inf.prepare_chain_params(net, prep, frozenset(ctx["film_c"]))
    rows = {"film_c2": {k: v.reshape(-1, v.shape[-1]).contiguous() for k, v in ctx["film_c"].items()}}
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0

    def rows_fwd():
        return inf.fused_unet1d_forward_rows(net, prep, chains, x, t, rows, exact_gelu=True)

    def module_fwd():
        with torch.no_grad():
            return net(x, t, cond)

    got, want = rows_fwd(), module_fwd()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    rel = ((got - want).norm() / want.norm()).item()
    ok = bool(torch.isfinite(got).all()) and got.shape == (B, 12, 62) and err <= FORWARD_TOL[dname]
    rows_ms, module_ms = cuda_ms(rows_fwd, iters=10), cuda_ms(module_fwd, iters=10)
    print(f"forward {dname}: rows engine vs module max_abs_err={err:.3e} rel_l2={rel:.3e} "
          f"tol={FORWARD_TOL[dname]} {'ok' if ok else 'FAIL'} | B={B}: rows_ms={rows_ms:.3f} "
          f"module_ms={module_ms:.3f} prepare_s={prep_s:.3f}", flush=True)
    if not ok:
        raise RuntimeError(f"{dname} rows forward disagrees with the module forward: {err}")
    return scene, rows_ms, module_ms


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from diffuscene_tpu_torch.ops import fused_level as fl

    card = card_line()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    t0 = time.perf_counter()
    fl.load_library()
    print(f"build: fused_chain.cu -> {fl.library_path().name} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    ptxas = fl.library_path().with_suffix(".ptxas.txt")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("ptxas:", line.strip())

    worst, results = phase_kernels(fl, torch)
    fwd_kernel_ms = sum(results[(12, "bfloat16", v)][1] * k for v, k in FORWARD_MIX.items())
    fwd_plain_ms = sum(results[(12, "bfloat16", v)][2] * k for v, k in FORWARD_MIX.items())
    print(f"chains of one flagship forward (N=12, B={B}, bf16, 19 chains): "
          f"kernel {fwd_kernel_ms:.3f} ms, plain {fwd_plain_ms:.3f} ms", flush=True)

    phase_forward(torch, torch.float32)
    scene, _, _ = phase_forward(torch, torch.bfloat16)

    # the main path: 1000-step DDPM sample, every chain through the kernel
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    torch.cuda.synchronize()
    fl.apply_chain.launches = 0
    t0 = time.perf_counter()
    out = scene.sample(B, generator=gen, clip_denoised=True, fused="rows")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fl.apply_chain.launches
    finite = bool(torch.isfinite(out).all())
    print(f"sample: {T}-step DDPM, B={B}, bf16, fused=rows: shape={tuple(out.shape)} "
          f"finite={finite} chain_calls={launches} wall_s={wall:.3f} "
          f"scenes_per_s={B / wall:.3f} | {card}", flush=True)
    if tuple(out.shape) != (B, 12, 62) or not finite:
        raise RuntimeError("the sample is malformed")
    if launches != 19 * T:
        raise RuntimeError(f"expected {19 * T} chain-kernel calls, counted {launches}")
    parts = scene.split_samples(out)
    print(f"sample: empty-slot share {parts['is_empty'].float().mean().item():.3f}", flush=True)

    print(json.dumps({"kernels": [{
        "name": "fused_chain",
        "route": "cuda",
        "source": "diffuscene_tpu_torch/csrc/fused_chain.cu",
        "replaces": "diffuscene_tpu/ops/fused_level.py:165",
        "launches": launches,
        "max_abs_err": worst,
        "ms": fwd_kernel_ms,
        "plain_ms": fwd_plain_ms,
    }]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
