"""The room-mask scene model's slow parity cases against the JAX package,
on tests/test_torch_room_mask.py's models, inputs and tolerances (its
docstring states them): ``get_loss`` with its gradients, one Adam step
with the frozen statistics untouched, and a DDPM sample through the module
and both engines' CPU twins with JAX's noise replayed.  A file of its own
so that the test runner's file scheduler starts these cases beside the
long JAX files, not before them.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffuscene_tpu.models import SceneDiffusion as JSceneDiffusion
from diffuscene_tpu.train import Trainer as JTrainer
from diffuscene_tpu.train.optim import f32_global_norm as j_f32_global_norm
from diffuscene_tpu_torch.train.trainer import Trainer
from diffuscene_tpu_torch.utils.convert import scene_tree
from test_torch_losses import _flat, _scene_batch, jax_loss_fn
from test_torch_room_mask import (B, EXTRACTOR_TOL, GRAD_REL_L2, LOSS_RTOL, N, SAMPLE_ATOL, T,
                                  TRAINING, _masks, _models)
from test_torch_tasks import _ddpm_stream, _replay
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)


def _step_inputs():
    rng = np.random.default_rng(8)
    batch = {**_scene_batch(rng), "room_layout": _masks(9)}
    t = np.array([0, 1, 3, 4], np.int32)
    noise = rng.normal(size=(B, N, 62)).astype(np.float32)
    return batch, t, noise


@functools.lru_cache(maxsize=None)
def _jax_step():
    """One step of the JAX Trainer's optimizer (the optax mask zeroing the
    batch_stats updates, then clip + Adam) on _step_inputs: the loss, the
    gradients of the whole variable tree, the variables after the step, the
    norm the JAX train step logs (every gradient's) and the clip's norm
    (the params' only)."""
    jscene, variables, _ = _models(seed=7)
    tx = JTrainer(jscene, TRAINING).tx
    jv = jax.tree.map(jnp.asarray, variables)
    (loss, _), g = jax.jit(jax.value_and_grad(jax_loss_fn(jscene), has_aux=True))(
        jv, *_step_inputs())

    @jax.jit
    def update(jv, g):
        upd, _ = tx.update(g, tx.init(jv), jv)
        return optax.apply_updates(jv, upd), j_f32_global_norm(g), j_f32_global_norm(g["params"])

    return jax.device_get((loss, g, *update(jv, g)))


def test_room_condition_loss_and_gradients_match_jax():
    """The condition (fc_room_f's part first, broadcast over the slots, then
    the instance embedding) equal to JAX's within the extractors' tolerance
    (its room part is the extractor's features through fc_room_f); get_loss
    on a batch with its (B, 1, 64, 64) room_layout, injected t and noise:
    the loss within 1e-5 relative, each parameter's gradient (the
    extractor's and fc_room_f's among them) within 1e-4 relative L2 of
    jax.grad's."""
    jscene, variables, scene = _models(seed=7)
    batch, t, noise = _step_inputs()
    want_c, _ = jax.jit(lambda v, rl: JSceneDiffusion._conditions_from_batch(
        jscene, v, {"room_layout": rl}, jnp.zeros((B, N, 62))))(variables, batch["room_layout"])
    got_c, _ = scene.make_condition(B, room_layout=torch.from_numpy(batch["room_layout"]))
    assert got_c.shape == want_c.shape == (B, N, 64 + 16)
    assert torch.equal(got_c[:, :1, :64].expand(B, N, 64), got_c[:, :, :64])
    np.testing.assert_allclose(got_c.detach().numpy(), np.asarray(want_c), **EXTRACTOR_TOL)

    want, want_g = _jax_step()[:2]
    loss, _ = scene.get_loss({k: torch.from_numpy(v) for k, v in batch.items()},
                             t=torch.from_numpy(t).long(), noise=torch.from_numpy(noise))
    loss.backward()
    grads = {n: p.grad for n, p in scene.networks.named_parameters()}
    got_g = _flat(jax.tree.map(lambda a: a.numpy(), scene_tree(scene, grads)))
    want_g = _flat(want_g["params"])
    assert got_g.keys() == want_g.keys()
    assert any("feature_extractor" in k for k in got_g)
    np.testing.assert_allclose(loss.item(), float(want), rtol=LOSS_RTOL)
    for k in want_g:
        rel = np.linalg.norm(got_g[k] - want_g[k]) / max(np.linalg.norm(want_g[k]), 1e-30)
        assert rel <= GRAD_REL_L2, (k, rel)


def test_adam_step_keeps_the_frozen_statistics():
    """_jax_step against the port's Trainer on the same batch, t and noise:
    the loss, every parameter after the step (within 4 lr), and the frozen
    statistics bit for bit unchanged in both.  JAX's gradients of the
    statistics are not zero, so the norm its train step logs (all
    gradients) is not the clip's norm; the port logs the clip's, the
    params' only."""
    _, variables, scene = _models(seed=7)
    trainer = Trainer(scene, TRAINING, device="cpu")
    trainer.set_weights(scene.networks.state_dict())
    stats0 = {n: b.clone() for n, b in scene.networks.named_buffers()}
    batch, t, noise = _step_inputs()
    loss, g, jv, logged, clip_norm = _jax_step()
    m = trainer.train_step(trainer.put_batch(batch), t=torch.from_numpy(t).long(),
                           noise=torch.from_numpy(noise))
    np.testing.assert_allclose(m["loss"], float(loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(m["gradnorm"], float(clip_norm), rtol=1e-4)
    stats_norm = np.sqrt(sum((a.astype(np.float64) ** 2).sum()
                             for a in _flat(g["batch_stats"]).values()))
    assert stats_norm > 0
    np.testing.assert_allclose(float(logged), np.hypot(float(clip_norm), stats_norm), rtol=1e-5)
    for n, b in scene.networks.named_buffers():
        assert torch.equal(b, stats0[n]), n
    for k, a in _flat(jv["batch_stats"]).items():
        assert np.array_equal(a, _flat(variables["batch_stats"])[k]), k
    got = _flat(jax.tree.map(lambda a: a.numpy(), scene_tree(scene)))
    want = _flat(jv["params"])
    diff = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert (diff <= 4 * TRAINING["lr"] + 1e-6).all(), diff.max()
    before = _flat(variables["params"])
    moved = np.concatenate([(want[k] != before[k]).ravel() for k in want])
    assert moved.mean() > 0.5


@functools.lru_cache(maxsize=None)
def _jax_samples():
    """JAX DDPM samples of the room-mask model, T steps, B=4, through the
    module and the 3-D engine, and the noise stream each drew; the port's
    rows engine is held to the JAX 3-D engine's sample (the two engines'
    forwards agree, tests/test_torch_engine.py)."""
    jscene, variables, _ = _models(seed=15)
    rl = _masks(16)
    key = jax.random.PRNGKey(17)
    out = {}
    for fused in (False, True):
        out[fused] = np.asarray(jax.jit(lambda v, k, rl, fused=fused: jscene.sample(
            v, k, batch_size=B, room_layout=rl, clip_denoised=True, fused=fused))(
                variables, key, rl))
    out["rows"] = out[True]
    return out, rl, _ddpm_stream(key, (B, N, 62), T)


@pytest.mark.parametrize("fused", [False, True, "rows"])
def test_room_mask_sample_matches_jax(fused):
    """A T-step DDPM sample from room masks on the same weights with JAX's
    noise stream replayed, through the module (fused=False) and the CPU
    twins of the 3-D engine (fused=True) and the rows engine
    (fused="rows"): atol 1e-4 of the JAX module's or 3-D engine's sample;
    the extractor runs once a call."""
    want, rl, noises = _jax_samples()
    _, _, scene = _models(seed=15)
    calls = []
    scene.feature_extractor.register_forward_hook(lambda *a: calls.append(1))
    noises = list(noises)
    got = scene.sample(B, clip_denoised=True, fused=fused, noise_fn=_replay(noises),
                       room_layout=torch.from_numpy(rl)).numpy()
    assert not noises and len(calls) == 1
    assert got.shape == (B, N, 62) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want[fused], atol=SAMPLE_ATOL, rtol=0)

