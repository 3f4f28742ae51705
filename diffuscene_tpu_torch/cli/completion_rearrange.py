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
(box intersection and symmetry statistics), as the JAX CLI does.  Renders
and meshes go through ``cli/_scene_output.py`` as in the JAX CLI:
``--render`` (alias ``--render_top2down``) writes ``{idx:05d}.png`` and the
input scene's render into ``partial/`` (completion) or ``noisy/``
(re-arrangement), ``--render_gt`` (or the config's ``validation.gen_gt``)
the eval scene's into ``groundtruth/``; a catalog (the third positional or
``--path_to_pickled_3d_futute_models``) renders the retrieved textured
meshes, and ``--render_perspective``, ``--with_rotating_camera``,
``--save_mesh`` and ``--judge_mesh_intersec`` work as in
``cli/generate_diffusion.py``.

    python -m diffuscene_tpu_torch.cli.completion_rearrange \\
        configs/uncond/diffusion_bedrooms_instancond_lat32_v.yaml completed \\
        --weight_file out/<tag> --num_partial 3 --n_sequences 100 --batch_size 32 \\
        --clip_denoised --fused
    python -m diffuscene_tpu_torch.cli.completion_rearrange \\
        configs/rearrange/diffusion_bedrooms_instancond_lat32_v_rearrange.yaml rearranged \\
        --weight_file out/<tag> --arrange_objects --n_sequences 100 --batch_size 32 \\
        --clip_denoised --fused

``--device`` picks the card (default) or ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

def build_parser() -> argparse.ArgumentParser:
    from ._scene_output import add_scene_output_args

    parser = argparse.ArgumentParser(description="Scene completion / re-arrangement "
                                     "(PyTorch port)")
    parser.add_argument("config_file")
    parser.add_argument("output_directory")
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
    parser.add_argument("--scene_texture", action="store_true",
                        help="accepted as the reference parses it (completion_rearrange.py:171) "
                        "and unused; textures follow --no_texture")
    parser.add_argument("--clip_denoised", action="store_true")
    parser.add_argument("--fused", action="store_true",
                        help="the 3-D serving engine: ResnetBlocks on B1, mid_attn on B2")
    parser.add_argument("--render_top2down", dest="render", action="store_true",
                        help="alias for --render")
    parser.add_argument("--render", action="store_true",
                        help="render the results, and the input scenes into partial/ "
                        "(completion) or noisy/ (re-arrangement)")
    parser.add_argument("--render_gt", action="store_true",
                        help="also render the eval scenes into groundtruth/ (on when the "
                        "config sets validation.gen_gt)")
    parser.add_argument("--compute_intersec", action="store_true",
                        help="box IoU / intersection / symmetry statistics per scene")
    parser.add_argument("--judge_mesh_intersec", action="store_true",
                        help="with --compute_intersec and a catalog, count a positive box IoU "
                        "only when the retrieved meshes' surfaces cross")
    add_scene_output_args(parser)
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

    from ..data.factory import get_dataset_raw_and_encoded
    from ..eval.postprocess import split_network_samples
    from ..eval.render import save_image
    from ..models.scene_model import SceneDiffusion, SceneModelConfig
    from ..utils.checkpoint import load_model_weights
    from ..utils.config import load_config
    from ..utils.convert import reference_to_scene_state_dict
    from ._box_stats import append_iou_states, mean_box_stats, scene_box_stats

    config = load_config(args.config_file)
    # the reference renders the ground truth when the config sets
    # validation.gen_gt (completion_rearrange.py:499)
    args.render_gt = args.render_gt or bool(config.get("validation", {}).get("gen_gt", False))

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

    scene_out = SceneOutput(args, raw, seed=args.seed)

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

    def render_aux(arr, subdir, idx):
        """Render an encoded scene into a subfolder (the reference's
        render_to_folder side renders, completion_rearrange.py:332-337)."""
        aux = eval_ds.post_process(split_network_samples(scene.spec, arr[None])[0])
        out_dir = os.path.join(args.output_directory, subdir)
        os.makedirs(out_dir, exist_ok=True)
        save_image(scene_out.render(aux, idx), os.path.join(out_dir, f"{idx:05d}.png"))

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

        inputs = noisy if args.arrange_objects else target[:, : args.num_partial]
        for i, boxes in enumerate(split_network_samples(scene.spec,
                                                        out[:take].float().cpu().numpy())):
            boxes = eval_ds.post_process(boxes)
            idx = n_done + i
            with open(os.path.join(args.output_directory, f"{idx:05d}_boxes.json"), "w") as f:
                json.dump({k: np.asarray(v).tolist() for k, v in boxes.items()}, f)
            if args.render:
                save_image(scene_out.render(boxes, idx),
                           os.path.join(args.output_directory, f"{idx:05d}.png"))
                render_aux(inputs[i], "noisy" if args.arrange_objects else "partial", idx)
            scene_out.perspective_outputs(boxes, idx, args.output_directory)
            if args.render_gt:
                render_aux(target[i], "groundtruth", idx)
            if args.save_mesh:
                scene_out.export(boxes, idx, args.output_directory)
            if args.compute_intersec:
                pair_fn = None
                if args.judge_mesh_intersec:
                    from ..eval.mesh_intersect import make_pair_intersects

                    pair_fn = make_pair_intersects(scene_out.retrieve(boxes))
                per_scene_stats.append(scene_box_stats(boxes, pair_intersects=pair_fn))
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
