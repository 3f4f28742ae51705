from .fused_level import (
    ChainBlock,
    ChainParams,
    apply_chain,
    apply_chain_reference,
    build_chain,
    load_library,
)
from .fused_resblock import standardize_kernel
