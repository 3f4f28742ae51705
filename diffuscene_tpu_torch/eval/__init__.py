"""Evaluation: box metrics, renders, mesh retrieval and export, and the
image metrics (FID/KID, improved precision/recall) with their feature
backbones on the card.  The JAX package's ``eval`` exports, plus the PNG
codec and the backbones."""
from .backbones import InceptionV3Pool3, VGG16Fc2, load_inception_params, load_vgg16_params
from .fid import (
    InceptionFeatures,
    PixelFeatures,
    VGG16Features,
    compute_fid_folders,
    compute_kid_folders,
    fid_from_features,
    frechet_distance,
    kid_from_features,
    load_image_folder,
)
from .ipr import (
    PrecisionRecall,
    compute_ipr_folders,
    compute_precision_recall,
    compute_realism_scores,
    knn_radii,
    realism,
)
from .metrics import (
    bbox_iou_and_overlap_ratio,
    computer_intersection,
    computer_symmetry,
    categorical_kl,
    compute_intersection,
    compute_symmetry,
    judge_if_symmetry,
    scene_bboxes_from_params,
)
from .png import read_image_rgb, read_png, write_png
from .postprocess import one_hot_from_probs, split_network_samples
from .render import (
    class_colors,
    render_meshes_topdown,
    render_scene_dict,
    render_scene_from_bbox_params,
    render_to_folder,
    render_topdown,
    save_image,
)
from .retrieval import (
    SceneMesh,
    export_scene,
    floor_plan_from_scene,
    get_textured_objects,
    get_textured_objects_based_on_objfeats,
    merge_meshes,
    write_obj,
)
