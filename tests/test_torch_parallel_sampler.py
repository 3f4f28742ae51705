"""The port's ShardedSampler (diffuscene_tpu_torch/parallel/sampler.py)
over two gloo ranks on the CPU, spawned once for the module
(tests/_torch_parallel_child.py): 8 scenes split 4 a rank for every task
family (unconditional DDPM and DPM-Solver++, text, the completion splice,
the arrangement splice) and every ``fused`` setting (the module, the 3-D
engine and the rows engine, their plain twins on the CPU), each gathered
sample against the port's unsharded ``SceneDiffusion.sample`` of all 8
from the same seed.  The noise is drawn for the whole batch and sliced, so
only the batch size of the module's matmuls differs: the engines' samples
are equal, the module's within 1e-5 (the JAX sharded-sampler test's
bound).  Each rank's host_local_slice, shard_indices_for_host and
global_batch_from_host_local are held as the JAX two-host test holds them
(tests/_distributed_child.py).  At most three tests: xdist hands the file
out after the slowest file of the suite.
"""
import numpy as np
import pytest
import torch

import _torch_parallel_child as child
from test_torch_threads import below_the_longest_file  # noqa: F401 (autouse)
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)

ATOL = 1e-5


@pytest.fixture(scope="module")
def sampler_case(tmp_path_factory):
    inputs = child.sampler_inputs()
    ranks = child.TwoRanks("sampler", tmp_path_factory.mktemp("sampler"), {"sampler": inputs})
    want = {}
    for family in child.SAMPLER_FAMILIES:
        kind, cond, opts = child.family_call(family, inputs)
        scene = child.sampler_scene(kind)
        for label, fused in child.SAMPLER_FUSED.items():
            gen = torch.Generator().manual_seed(child.SAMPLER_SEED)
            want[(family, label)] = scene.sample(child.SCENE_B, generator=gen,
                                                 clip_denoised=True, fused=fused, **cond, **opts)
    return ranks, want, inputs


@pytest.mark.parametrize("fused", list(child.SAMPLER_FUSED))
def test_sharded_sample_equals_the_unsharded_one(sampler_case, fused):
    ranks, want, inputs = sampler_case
    out = ranks.results()
    for r in range(2):                      # the per-process helpers, as JAX's on two hosts
        helpers = out[r]["helpers"]
        assert helpers["slice"] == (4 * r, 4 * r + 4)
        assert helpers["indices"] == list(range(10))[r::2]
        assert torch.equal(helpers["gathered"], torch.arange(child.SCENE_B).float())
    for family in child.SAMPLER_FAMILIES:
        got, ref = out[0][(family, fused)], want[(family, fused)]
        assert got.shape == (child.SCENE_B, child.N_OBJ, 62), family
        assert torch.equal(got, out[1][(family, fused)]), family
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL, rtol=0, err_msg=family)
        if fused != "plain":
            assert torch.equal(got, ref), family
    partial = inputs["partial_boxes"]
    np.testing.assert_array_equal(out[0][("complete", fused)][:, :partial.shape[1]].numpy(),
                                  partial)
    boxes, arranged = inputs["input_boxes"], out[0][("arrange", fused)].numpy()
    np.testing.assert_array_equal(arranged[:, :, 3:6], boxes[:, :, 3:6])
    np.testing.assert_array_equal(arranged[:, :, 8:], boxes[:, :, 8:])
    assert not np.allclose(arranged[:, :, :3], boxes[:, :, :3])
