"""Generate scenes with a trained scene model, render and score them.

Port of ``diffuscene_tpu/cli/generate_diffusion.py`` (reference
``scripts/generate_diffusion.py:47-469``): the trainer's checkpoint (its EMA
weights unless ``--no_ema``), batched sampling through
``SceneDiffusion.sample`` (DDPM, ``--ddim`` or ``--dpm``; ``--fused`` serves
every ResnetBlock on the B1 kernel and mid_attn on the B2 kernel), empty
slots dropped and attributes descaled with the eval split's bounds.  It
writes each scene's boxes (``{idx:05d}_boxes.npz``) and ``metrics.json``
(the categorical KL of the generated class frequencies against the eval
split's, and with ``--compute_intersec`` the box-intersection and symmetry
statistics, with the running ``iou_states.txt``), under the JAX CLI's
names and keys, and ``timing.json``: the wall seconds of sampling,
rendering and export, and metrics.  ``--device`` picks the card (default)
or ``--device cpu``.

Renders and meshes go through ``cli/_scene_output.py`` as in the JAX CLI:
``--render`` (alias ``--render_top2down``) writes ``{idx:05d}.png``, a
top-down raster of the boxes, or with a catalog (the third positional or
``--path_to_pickled_3d_futute_models``) of the retrieved textured meshes
over the conditioning scene's floor plan; ``--render_perspective`` writes
``{idx:05d}_persp.png``, ``--with_rotating_camera`` the orbit frames,
``--save_mesh`` the merged scene mesh and each object's OBJ under
``scene_mesh/`` with ``{idx:05d}_scene.json``, the retrieval manifest;
``--judge_mesh_intersec`` counts a box pair as intersecting only when the
retrieved meshes' surfaces cross (``eval/mesh_intersect.py``).  All of it
is numpy on the host.

A text model (``configs/text/*``) is conditioned on eval scenes'
descriptions: the eval encoding's ``text`` becomes ``textfix`` (the
sentence templates without random draws; the eval set keeps the config's
augmentations, as the JAX CLI's does, so a scene's relation words follow the
fixed rotation drawn at each read), ``--scene_id`` pins every sequence to one
named eval scene, ``--fix_order`` walks the eval set in order, and otherwise
the scenes are drawn from ``np.random.default_rng(seed)`` (the JAX CLI's
draws).  Each batch's ``desc_emb`` is its ``text_emb``, and each scene's
sentence goes to ``{idx:05d}.txt``.  A room-mask model
(``room_mask_condition``) is conditioned the same way on the eval scenes'
(1, H, W) ``room_layout`` masks, rotated with their scenes by the eval
set's augmentations as in the JAX CLI; its extractor is the config's
``feature_extractor`` section.  The same draws pick each render's floor
plan.

    python -m diffuscene_tpu_torch.cli.generate_diffusion CONFIG OUT \\
        --weight_file out/<tag> --n_sequences 1000 --batch_size 256 \\
        --clip_denoised --fused --render --compute_intersec

``--profile_dir DIR`` writes a ``torch.profiler`` trace (host and CUDA
activity, ``utils/profiling.py:TraceWindow``) of every sampling batch from
the second on into DIR, or of the only batch when there is one, as the JAX
CLI captures from its first batch past the compile.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

def build_parser() -> argparse.ArgumentParser:
    from ._scene_output import add_scene_output_args

    parser = argparse.ArgumentParser(description="Generate scenes (PyTorch port)")
    parser.add_argument("config_file")
    parser.add_argument("output_directory")
    parser.add_argument("--no_ema", action="store_true",
                        help="sample with the raw weights even when the checkpoint has an EMA")
    parser.add_argument("--weight_file", default=None,
                        help="experiment dir with model_* checkpoints (or a reference .pt)")
    parser.add_argument("--n_sequences", type=int, default=10)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--clip_denoised", action="store_true")
    parser.add_argument("--ddim", action="store_true")
    parser.add_argument("--ddim_steps", type=int, default=50)
    parser.add_argument("--dpm", action="store_true", help="DPM-Solver++(2M) fast sampling")
    parser.add_argument("--dpm_steps", type=int, default=20)
    parser.add_argument("--fused", action="store_true",
                        help="the 3-D serving engine: ResnetBlocks on B1, mid_attn on B2")
    parser.add_argument("--compute_intersec", action="store_true")
    parser.add_argument("--judge_mesh_intersec", action="store_true",
                        help="with --compute_intersec and a catalog, count a positive box IoU "
                        "only when the retrieved meshes' surfaces cross")
    parser.add_argument("--scene_id", default=None,
                        help="condition every sequence on this eval scene (text and room-mask "
                        "models)")
    parser.add_argument("--fix_order", action="store_true",
                        help="condition the sequences on the eval scenes in order")
    parser.add_argument("--render", action="store_true", help="save top-down renders")
    parser.add_argument("--render_top2down", dest="render", action="store_true",
                        help="alias for --render")
    add_scene_output_args(parser)
    parser.add_argument("--profile_dir", default=None,
                        help="write a torch.profiler trace of the sampling batches from the "
                        "second on (of the only one when there is one) to this directory")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def main(argv=None):
    from ._scene_output import SceneOutput, resolve_scene_output_args

    args = resolve_scene_output_args(build_parser().parse_args(argv))
    if (args.compute_intersec and args.judge_mesh_intersec
            and not args.path_to_pickled_3d_futute_models):
        raise SystemExit("--judge_mesh_intersec needs a retrieved catalog "
                         "(--path_to_pickled_3d_futute_models)")

    import torch

    from ..data.factory import apply_text_emb_dim_default, get_dataset_raw_and_encoded
    from ..eval.metrics import categorical_kl
    from ..eval.postprocess import split_network_samples
    from ..eval.render import save_image
    from ._box_stats import append_iou_states, mean_box_stats, scene_box_stats
    from ..models.scene_model import SceneDiffusion, SceneModelConfig
    from ..utils.checkpoint import load_model_weights
    from ..utils.config import load_config
    from ..utils.convert import reference_to_scene_state_dict
    from ..utils.profiling import TraceWindow

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = load_config(args.config_file)
    apply_text_emb_dim_default(config)
    os.makedirs(args.output_directory, exist_ok=True)

    # eval-time encoding (generate_diffusion.py:201-208): text -> textfix,
    # no permutation
    enc = config["data"]["encoding_type"]
    if "textfix" not in enc and "text" in enc:
        enc = enc.replace("text", "textfix")
    if "no_prm" not in enc:
        enc = enc + "_no_prm"
    raw, eval_ds = get_dataset_raw_and_encoded(
        {**config["data"], "encoding_type": enc}, augmentations=None,
        split=config["validation"].get("splits", ["test"]),
        keep_room_layout=bool(config["network"].get("room_mask_condition", True)))

    net_cfg = dict(config["network"])
    net_cfg.setdefault("sample_num_points", eval_ds.max_length)
    cfg = SceneModelConfig.from_config(net_cfg, config.get("feature_extractor"))
    scene = SceneDiffusion(cfg, device=args.device).init(torch.Generator().manual_seed(args.seed))
    if args.weight_file:
        if args.weight_file.endswith((".pt", ".pth")):
            sd = reference_to_scene_state_dict(load_model_weights(args.weight_file))
        else:
            sd = load_model_weights(args.weight_file, ema=not args.no_ema)
        scene.networks.load_state_dict(sd)
        print(f"loaded weights from {args.weight_file}"
              + ("" if args.no_ema else " (the EMA weights when the checkpoint has them)"))

    scene_out = SceneOutput(args, raw, seed=args.seed)

    # the scene that conditions each sequence (generate_diffusion.py:268-301)
    given_scene_id = None
    if args.scene_id is not None:
        ids = list(raw.scene_ids)
        if args.scene_id not in ids:
            raise SystemExit(f"--scene_id {args.scene_id!r} not in the eval split "
                             f"({len(ids)} scenes)")
        given_scene_id = ids.index(args.scene_id)
        print(f"conditioning all sequences on scene {args.scene_id!r} (index {given_scene_id})")
    idx_rng = np.random.default_rng(args.seed)

    def cond_index(i: int) -> int:
        if given_scene_id is not None:
            return given_scene_id
        if args.fix_order:
            return i % len(eval_ds)
        return int(idx_rng.integers(len(eval_ds)))

    gen = torch.Generator(device=scene.device).manual_seed(args.seed)
    total_batches = -(-args.n_sequences // args.batch_size)
    trace_window = (TraceWindow(args.profile_dir, start=min(1, total_batches - 1), length=10**9)
                    if args.profile_dir else None)
    wall = {"sample_s": 0.0, "render_s": 0.0, "metrics_s": 0.0}
    all_boxes = []
    n_done = n_batches = 0
    while n_done < args.n_sequences:
        batch_indices = [cond_index(n_done + i) for i in range(args.batch_size)]
        text_emb = room_layout = None
        descriptions = []
        if cfg.text_condition or cfg.room_mask_condition:
            # one read of each conditioning scene (the eval set's rotations
            # draw at each read), as the JAX CLI reads them
            conds = [eval_ds[idx] for idx in batch_indices]

            def stacked(key):
                host = np.stack([np.asarray(c[key], np.float32) for c in conds])
                return torch.from_numpy(host).to(scene.device)

            if cfg.text_condition:
                descriptions = [c["description"] for c in conds]
                text_emb = stacked("desc_emb")
            if cfg.room_mask_condition:
                room_layout = stacked("room_layout")
        if trace_window is not None:
            trace_window.tick(n_batches)
        t0 = time.perf_counter()
        samples = scene.sample(args.batch_size, generator=gen, clip_denoised=args.clip_denoised,
                               fused=args.fused, ddim=args.ddim, ddim_steps=args.ddim_steps,
                               dpm=args.dpm, dpm_steps=args.dpm_steps, text_emb=text_emb,
                               room_layout=room_layout)
        take = min(args.batch_size, args.n_sequences - n_done)
        samples = samples[:take].float().cpu().numpy()
        t1 = time.perf_counter()
        wall["sample_s"] += t1 - t0
        n_batches += 1
        for i, boxes in enumerate(split_network_samples(scene.spec, samples)):
            boxes = eval_ds.post_process(boxes)
            all_boxes.append(boxes)
            idx = n_done + i
            np.savez(os.path.join(args.output_directory, f"{idx:05d}_boxes.npz"),
                     **{k: np.asarray(v) for k, v in boxes.items()})
            if args.render:
                # retrieved textured meshes over the conditioning scene's
                # floor plan with a catalog, the boxes otherwise
                # (generate_diffusion.py:305-315)
                save_image(scene_out.render(boxes, idx, floor_idx=batch_indices[i]),
                           os.path.join(args.output_directory, f"{idx:05d}.png"))
            scene_out.perspective_outputs(boxes, idx, args.output_directory,
                                          floor_idx=batch_indices[i])
            if descriptions:
                with open(os.path.join(args.output_directory, f"{idx:05d}.txt"), "w") as f:
                    f.write(descriptions[i])
            if args.save_mesh:
                scene_out.export(boxes, idx, args.output_directory)
        wall["render_s"] += time.perf_counter() - t1
        n_done += take
        print(f"sampled {n_done}/{args.n_sequences}")
    if trace_window is not None:
        trace_window.close()

    # metrics (generate_diffusion.py:394-429 + the categorical KL at :44)
    t0 = time.perf_counter()
    stats = {"n_scenes": len(all_boxes)}
    class_freq_gen = np.zeros(len(raw.class_labels) - 2, np.float64)
    per_scene_stats = []
    for boxes in all_boxes:
        cls = np.asarray(boxes["class_labels"])
        for c in cls.argmax(-1):
            class_freq_gen[c] += 1
        if args.compute_intersec:
            pair_fn = None
            if args.judge_mesh_intersec:
                from ..eval.mesh_intersect import make_pair_intersects

                # retrieval order is the boxes' row order, so indices line up
                pair_fn = make_pair_intersects(scene_out.retrieve(boxes))
            per_scene_stats.append(scene_box_stats(boxes, pair_intersects=pair_fn))
            append_iou_states(os.path.join(args.output_directory, "iou_states.txt"),
                              per_scene_stats)
    if class_freq_gen.sum() > 0:
        gt_freq = np.array([raw.class_frequencies[c] for c in raw.object_types], np.float64)
        stats["categorical_kl"] = categorical_kl(gt_freq / gt_freq.sum(),
                                                 class_freq_gen / class_freq_gen.sum())
    if per_scene_stats:
        stats.update(mean_box_stats(per_scene_stats))
    with open(os.path.join(args.output_directory, "metrics.json"), "w") as f:
        json.dump(stats, f, indent=2)
    wall["metrics_s"] = time.perf_counter() - t0
    with open(os.path.join(args.output_directory, "timing.json"), "w") as f:
        json.dump(wall, f, indent=2)
    print(json.dumps(stats))
    return stats

if __name__ == "__main__":
    main()
