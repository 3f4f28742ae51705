"""Scene completion and re-arrangement with a trained scene model.

Port of ``diffuscene_tpu/cli/completion_rearrange.py`` (reference
``scripts/completion_rearrange.py:32-542``):

- completion: the first ``--num_partial`` boxes of each eval scene are the
  partial input and the sampler inpaints the rest
  (``SceneDiffusion.sample(partial_boxes=...)``, the RePaint splice);
- re-arrangement (``--arrange_objects``): the eval scene's translations and
  angles get N(0, ``--noise_scale``) noise from ``np.random.default_rng``,
  and the sampler re-arranges them with the sizes, classes and objfeats as
  its condition (``SceneDiffusion.sample(input_boxes=...)``).

Both are DDPM chains; ``--fused`` serves every ResnetBlock on the B1 kernel
and mid_attn on the B2 kernel.  The sampler's noise comes from a
``torch.Generator`` on the device, seeded with ``--seed``.  Weights: the
trainer's checkpoint (its EMA unless ``--no_ema``) or a reference ``.pt``.
It writes each scene's boxes (``{idx:05d}_boxes.json``), and with
``--compute_intersec`` the running ``iou_states.txt`` and ``metrics.json``
(box intersection and symmetry statistics), as the JAX CLI does.

    python -m diffuscene_tpu_torch.cli.completion_rearrange \\
        configs/uncond/diffusion_bedrooms_instancond_lat32_v.yaml completed \\
        --weight_file out/<tag> --num_partial 3 --n_sequences 100 --batch_size 32 \\
        --clip_denoised --fused
    python -m diffuscene_tpu_torch.cli.completion_rearrange \\
        configs/rearrange/diffusion_bedrooms_instancond_lat32_v_rearrange.yaml rearranged \\
        --weight_file out/<tag> --arrange_objects --n_sequences 100 --batch_size 32 \\
        --clip_denoised --fused

The flags that need a render or the mesh catalog raise (``eval/render.py``
and ``eval/retrieval.py`` are not ported, ROADMAP A8): ``--render`` and
``--render_top2down``, ``--render_gt`` (or the config's
``validation.gen_gt``), ``--render_perspective``, ``--with_rotating_camera``,
``--save_mesh``, ``--judge_mesh_intersec`` and a catalog for retrieval.
``--device`` picks the card (default) or ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

_A8 = "not ported yet (ROADMAP A8)"
_REFUSED = {
    "render": f"renders need eval/render.py, {_A8}",
    "render_gt": f"renders need eval/render.py, {_A8}",
    "render_perspective": f"renders need eval/render.py, {_A8}",
    "with_rotating_camera": f"renders need eval/render.py, {_A8}",
    "save_mesh": f"mesh export needs eval/retrieval.py, {_A8}",
    "judge_mesh_intersec": f"mesh intersection needs eval/retrieval.py, {_A8}",
    "path_to_pickled_3d_futute_models": f"mesh retrieval needs eval/retrieval.py, {_A8}",
}


def main(argv=None):
    parser = argparse.ArgumentParser(description="Scene completion / re-arrangement "
                                     "(PyTorch port)")
    parser.add_argument("config_file")
    parser.add_argument("output_directory")
    parser.add_argument("pickled_models_pos", nargs="?", default=None,
                        metavar="path_to_pickled_3d_futute_models",
                        help="mesh catalog for retrieval: not ported (ROADMAP A8)")
    parser.add_argument("--no_ema", action="store_true",
                        help="use the raw weights even when the checkpoint has an EMA")
    parser.add_argument("--weight_file", default=None,
                        help="experiment dir with model_* checkpoints (or a reference .pt)")
    parser.add_argument("--arrange_objects", action="store_true")
    parser.add_argument("--num_partial", type=int, default=3)
    parser.add_argument("--noise_scale", type=float, default=0.5,
                        help="translation/angle noise of the re-arrangement inputs")
    parser.add_argument("--n_sequences", type=int, default=10)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--scene_id", default=None,
                        help="complete/arrange this named eval scene in every sequence; the "
                        "re-arrangement noise is then seeded by the scene's index")
    parser.add_argument("--clip_denoised", action="store_true")
    parser.add_argument("--fused", action="store_true",
                        help="the 3-D serving engine: ResnetBlocks on B1, mid_attn on B2")
    parser.add_argument("--compute_intersec", action="store_true",
                        help="box IoU / intersection / symmetry statistics per scene")
    parser.add_argument("--render", action="store_true", help="not ported (A8)")
    parser.add_argument("--render_top2down", dest="render", action="store_true",
                        help="alias for --render")
    parser.add_argument("--render_gt", action="store_true", help="not ported (A8)")
    parser.add_argument("--judge_mesh_intersec", action="store_true", help="not ported (A8)")
    parser.add_argument("--path_to_pickled_3d_futute_models", default=None,
                        help="not ported (A8)")
    parser.add_argument("--save_mesh", action="store_true", help="not ported (A8)")
    parser.add_argument("--render_perspective", action="store_true", help="not ported (A8)")
    parser.add_argument("--with_rotating_camera", action="store_true", help="not ported (A8)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    args.path_to_pickled_3d_futute_models = (args.path_to_pickled_3d_futute_models
                                             or args.pickled_models_pos)

    import torch

    from ..data.factory import get_dataset_raw_and_encoded
    from ..eval.postprocess import split_network_samples
    from ..models.scene_model import SceneDiffusion, SceneModelConfig
    from ..utils.checkpoint import load_model_weights
    from ..utils.config import load_config
    from ..utils.convert import reference_to_scene_state_dict
    from ._box_stats import append_iou_states, mean_box_stats, scene_box_stats

    config = load_config(args.config_file)
    # the reference renders the ground truth when the config sets
    # validation.gen_gt (completion_rearrange.py:499)
    args.render_gt = args.render_gt or bool(config.get("validation", {}).get("gen_gt", False))
    for flag, why in _REFUSED.items():
        if getattr(args, flag):
            raise SystemExit(f"--{flag}: {why}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.output_directory, exist_ok=True)

    # eval-time encoding: no permutation
    enc = config["data"]["encoding_type"]
    if "no_prm" not in enc:
        enc += "_no_prm"
    raw, eval_ds = get_dataset_raw_and_encoded(
        {**config["data"], "encoding_type": enc}, augmentations=None,
        split=config["validation"].get("splits", ["test"]))

    net_cfg = dict(config["network"])
    net_cfg.setdefault("sample_num_points", eval_ds.max_length)
    # completion needs no partial head: the splice sampler runs on the
    # unconditional model (diffusion_ddpm.py:447-476)
    cfg = SceneModelConfig.from_config(net_cfg)
    scene = SceneDiffusion(cfg, device=args.device).init(torch.Generator().manual_seed(args.seed))
    if args.weight_file:
        if args.weight_file.endswith((".pt", ".pth")):
            sd = reference_to_scene_state_dict(load_model_weights(args.weight_file))
        else:
            sd = load_model_weights(args.weight_file, ema=not args.no_ema)
        scene.networks.load_state_dict(sd)
        print(f"loaded weights from {args.weight_file}"
              + ("" if args.no_ema else " (the EMA weights when the checkpoint has them)"))

    # --scene_id pins every sequence to one named eval scene, whose index
    # then seeds the re-arrangement noise (completion_rearrange.py:264-268,
    # 312-322)
    given_scene_id = None
    if args.scene_id is not None:
        ids = list(raw.scene_ids)
        if args.scene_id not in ids:
            raise SystemExit(f"--scene_id {args.scene_id!r} not in the eval split "
                             f"({len(ids)} scenes)")
        given_scene_id = ids.index(args.scene_id)
        print(f"using scene {args.scene_id!r} (index {given_scene_id}) for every sequence")
    rng = np.random.default_rng(args.seed if given_scene_id is None else given_scene_id)
    gen = torch.Generator(device=scene.device).manual_seed(args.seed)
    td, sd_, bd = cfg.translation_dim, cfg.size_dim, cfg.bbox_dim

    n_done = 0
    per_scene_stats = []
    while n_done < args.n_sequences:
        if given_scene_id is not None:
            idxs = [given_scene_id] * args.batch_size
        else:
            idxs = [(n_done + i) % len(eval_ds) for i in range(args.batch_size)]
        batch = [eval_ds[i] for i in idxs]
        target = np.stack([
            np.concatenate([s["translations"], s["sizes"], s["angles"], s["class_labels"]]
                           + ([s["objfeats_32"]] if "objfeats_32" in s else []), axis=-1)
            for s in batch]).astype(np.float32)
        if args.arrange_objects:
            # noise the scene's translations and angles (completion_rearrange.py:309-324)
            noisy = target.copy()
            noisy[:, :, :td] += rng.normal(0, args.noise_scale, noisy[:, :, :td].shape)
            noisy[:, :, td + sd_: bd] += rng.normal(0, args.noise_scale,
                                                    noisy[:, :, td + sd_: bd].shape)
            out = scene.sample(len(batch), generator=gen, clip_denoised=args.clip_denoised,
                               fused=args.fused,
                               input_boxes=torch.from_numpy(noisy).to(scene.device))
        else:
            partial = torch.from_numpy(target[:, : args.num_partial]).to(scene.device)
            out = scene.sample(len(batch), generator=gen, clip_denoised=args.clip_denoised,
                               fused=args.fused, partial_boxes=partial)
        take = min(args.batch_size, args.n_sequences - n_done)
        for i, boxes in enumerate(split_network_samples(scene.spec,
                                                        out[:take].float().cpu().numpy())):
            boxes = eval_ds.post_process(boxes)
            idx = n_done + i
            with open(os.path.join(args.output_directory, f"{idx:05d}_boxes.json"), "w") as f:
                json.dump({k: np.asarray(v).tolist() for k, v in boxes.items()}, f)
            if args.compute_intersec:
                per_scene_stats.append(scene_box_stats(boxes))
                append_iou_states(os.path.join(args.output_directory, "iou_states.txt"),
                                  per_scene_stats)
        n_done += take
        print(f"{'arranged' if args.arrange_objects else 'completed'} "
              f"{n_done}/{args.n_sequences}")

    stats = {}
    if args.compute_intersec and per_scene_stats:
        stats = {"n_scenes": len(per_scene_stats), **mean_box_stats(per_scene_stats)}
        with open(os.path.join(args.output_directory, "metrics.json"), "w") as f:
            json.dump(stats, f, indent=2)
        print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
