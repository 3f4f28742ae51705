"""``SceneDiffusion.get_loss`` (diffuscene_tpu_torch/models/scene_model.py)
and its gradients against the JAX package's loss, rebuilt from its public
pieces with the same injected timesteps and noise
(tests/test_torch_losses.py's ``jax_loss_fn``, whose docstring gives the
sizes and the tolerances used here).  A file of its own so that the test
runner's file scheduler starts these two slow cases beside the long JAX
files, not before them.
"""
import jax
import numpy as np
import pytest
import torch

from diffuscene_tpu.models import SceneDiffusion as JSceneDiffusion
from diffuscene_tpu_torch.models import SceneDiffusion
from diffuscene_tpu_torch.utils.convert import load_jax_params, scene_tree
from test_torch_losses import (B, BF16_GRAD_REL_L2, BF16_LEAF_REL_L2, BF16_LOSS_RTOL, BOUNDS,
                               F32_GRAD_TOL, F32_LOSS_RTOL, N, _configs, _flat, _scene_batch,
                               jax_loss_fn, jax_params)
from test_torch_threads import below_the_longest_file  # noqa: F401 (autouse)
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_get_loss_and_gradients_match_jax(dtype):
    """The flagship's loss (v-prediction, loss_separate, loss_iou on the
    train bounds) on the same weights, batch, t and noise: the loss, every
    loss.* term and every parameter's gradient (through scene_tree, in the
    Flax layout); tolerances above."""
    jcfg, tcfg = _configs(dtype)
    jscene = JSceneDiffusion(jcfg, bounds=BOUNDS)
    params = jax_params(jscene, seed=6)
    scene = SceneDiffusion(tcfg, bounds=BOUNDS, device="cpu")
    load_jax_params(scene, params)
    rng = np.random.default_rng(7)
    batch = _scene_batch(rng)
    t = np.array([0, 10, 500, 999], np.int32)
    noise = rng.normal(size=(B, N, 62)).astype(np.float32)

    (want, want_d), want_g = jax.jit(jax.value_and_grad(jax_loss_fn(jscene), has_aux=True))(
        params, batch, t, noise)
    loss, terms = scene.get_loss({k: torch.from_numpy(v) for k, v in batch.items()},
                                 t=torch.from_numpy(t).long(), noise=torch.from_numpy(noise))
    loss.backward()
    grads = {n: p.grad for n, p in scene.networks.named_parameters()}
    assert all(g.dtype == torch.float32 for g in grads.values())
    got_g = _flat(jax.tree.map(lambda a: a.numpy(), scene_tree(scene, grads)))
    want_g = _flat(want_g["params"])
    assert got_g.keys() == want_g.keys()

    rtol = F32_LOSS_RTOL if dtype == "float32" else BF16_LOSS_RTOL
    np.testing.assert_allclose(loss.item(), float(want), rtol=rtol)
    assert terms.keys() == want_d.keys()
    for k in want_d:
        np.testing.assert_allclose(terms[k].item(), float(want_d[k]), rtol=rtol, err_msg=k)
    if dtype == "float32":
        for k in want_g:
            np.testing.assert_allclose(got_g[k], want_g[k], err_msg=k, **F32_GRAD_TOL)
        return
    for k in want_g:
        rel = np.linalg.norm(got_g[k] - want_g[k]) / np.linalg.norm(want_g[k])
        assert rel < BF16_LEAF_REL_L2, (k, rel)
    a = np.concatenate([g.ravel() for g in got_g.values()])
    b = np.concatenate([want_g[k].ravel() for k in got_g])
    assert np.linalg.norm(a - b) / np.linalg.norm(b) < BF16_GRAD_REL_L2

