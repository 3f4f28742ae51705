from .fused_level import (
    ChainBlock,
    ChainParams,
    apply_chain,
    apply_chain_reference,
    build_chain,
    load_library,
)
from .fused_resblock import (
    fused_resnet_block,
    fused_resnet_block_reference,
    standardize_kernel,
)
from .attention import fused_set_attention, fused_set_attention_reference
from .chamfer import (
    chamfer_2d,
    chamfer_3d,
    chamfer_5d,
    chamfer_distance,
    directed_nn,
    directed_nn_reference,
    fscore,
)
from .knn import gather_neighbors, knn_indices
from .iou3d import axis_aligned_bbox_overlaps_3d
