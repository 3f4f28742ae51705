"""The communication layer on ``torch.distributed``: process-group start-up,
the (data, model) mesh, tensor-parallel kernels and the sharded sampler
(port of ``diffuscene_tpu/parallel``)."""
from .distributed import (global_batch_from_host_local, host_local_slice, initialize, launch,
                          rank_and_world, shard_indices_for_host, shutdown)
from .mesh import Mesh, all_gather_rows, make_mesh, replicate, rows_of, shard_batch
from .sampler import ShardedSampler
from .tp import gather_full, local_block, param_shardings, shard_params
