"""Parity of the port's scene completion and re-arrangement with the JAX
package: the partial and arrange condition heads, the task samplers
(``SceneDiffusion.sample(partial_boxes=..., input_boxes=...)``; completion
in tests/test_torch_task_completion.py, on this file's models), the
trajectory loop, the variational-bound sweep, the task losses with their
gradients and the weight bridge of the new heads.

Small sizes: dim 64, 2 levels, N=12, B=4, 4-6 steps, f32, the same numpy
weights through ``load_jax_params``.  The sampler tests replay the JAX
noise stream through ``noise_fn``, completion's three-way key split
included, and assert the stream is used up.  Tolerance atol 1e-4 on the
samples (f32 math summed in another order, over 4-6 steps, as
tests/test_torch_sampling.py uses); the spliced slots and channels are
bit-equal.  The JAX side runs its 3-D engine (fused=True) as plain ops on
the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffuscene_tpu.diffusion import gaussian as jg
from diffuscene_tpu.models import SceneDiffusion as JSceneDiffusion
from diffuscene_tpu.models import SceneModelConfig as JSceneModelConfig
from diffuscene_tpu.models.scene_model import SceneNetworks
from diffuscene_tpu.utils.convert import convert_scene_model
from diffuscene_tpu_torch.models import SceneDiffusion, SceneModelConfig
from diffuscene_tpu_torch.utils.convert import (load_jax_params, reference_to_scene_state_dict,
                                                scene_tree)
from test_torch_losses import F32_GRAD_TOL, F32_LOSS_RTOL, _flat, _scene_batch, jax_params
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)


B, N, P = 4, 12, 3
SAMPLE_ATOL = 1e-4


def _cfgs(task=None, time_num=4):
    """Both packages' configs at a small size.  ``task`` None is the
    unconditional model (completion runs on it, as run/completion.sh
    does), "partial" adds the partial head, "arrange" is the rearrange
    config's shape: 5 input and output channels through init_conv and
    final_conv (seperate_all false) and a condition of instance + arrange;
    "both" is that with the partial head too."""
    inst = 32
    nk = dict(dim=64, dim_mults=(1, 1), channels=62, objectness_dim=0, class_dim=22,
              angle_dim=2, objfeat_dim=32, context_dim=0, instanclass_dim=inst,
              seperate_all=True)
    kw = dict(point_dim=62, class_dim=22, angle_dim=2, objectness_dim=0, objfeat_dim=32,
              sample_num_points=N, room_mask_condition=False, instance_condition=True,
              learnable_embedding=True, instance_emb_dim=inst, model_mean_type="v",
              model_var_type="fixedsmall", schedule_type="linear", beta_start=1e-4,
              beta_end=0.02, time_num=time_num, loss_separate=True, loss_iou=False)
    if task in ("partial", "both"):
        kw.update(room_partial_condition=True, partial_num_points=P, partial_emb_dim=16)
        nk.update(instanclass_dim=nk["instanclass_dim"] + 16)
    if task in ("arrange", "both"):
        kw.update(room_arrange_condition=True, arrange_emb_dim=48)
        nk.update(instanclass_dim=nk["instanclass_dim"] + 48, channels=5, out_dim=5,
                  seperate_all=False)
    kw["net_kwargs"] = tuple(sorted(nk.items()))
    return JSceneModelConfig(**kw), SceneModelConfig(**kw)


def _models(task=None, time_num=4, seed=11):
    jcfg, cfg = _cfgs(task, time_num)
    jscene = JSceneDiffusion(jcfg)
    params = jax_params(jscene, seed=seed)
    scene = SceneDiffusion(cfg, device="cpu")
    load_jax_params(scene, params)
    return jscene, params, scene


def _packed(rng, batch=B):
    s = _scene_batch(rng, batch)
    return np.concatenate([s["translations"], s["sizes"], s["angles"], s["class_labels"],
                           s["objfeats_32"]], axis=-1)


def _replay(noises):
    """noise_fn drawing ``noises`` in order (each shape checked)."""
    def noise_fn(shape):
        a = noises.pop(0)
        assert tuple(shape) == a.shape
        return torch.from_numpy(a.copy())
    return noise_fn


def _normal(k, shape):
    return np.asarray(jax.random.normal(k, shape, jnp.float32))


def _ddpm_stream(key, shape, steps):
    """x_T from the first split, then one split a step (p_sample_loop)."""
    k, init_key = jax.random.split(key)
    out = [_normal(init_key, shape)]
    for _ in range(steps):
        k, sub = jax.random.split(k)
        out.append(_normal(sub, shape))
    return out


def _complete_stream(key, shape, partial_shape, steps):
    """x_T, then per step split(k, 3): the partial's noise (k_noise), then
    the step noise (k_step) (p_sample_loop_complete)."""
    k, init_key = jax.random.split(key)
    out = [_normal(init_key, shape)]
    for _ in range(steps):
        k, k_noise, k_step = jax.random.split(k, 3)
        out += [_normal(k_noise, partial_shape), _normal(k_step, shape)]
    return out


@pytest.mark.parametrize("fused", [False, True])
def test_arrange_matches_jax(fused):
    """Re-arrangement at the rearrange config's shape (5 channels through
    init_conv/final_conv, the arrange head's per-scene condition): DDPM on
    the (translation, angle) sub-shape, spliced into the input; atol 1e-4,
    the size, class and objfeat channels bit-equal to the input."""
    T = 4
    jscene, params, scene = _models("arrange", T)
    boxes = _packed(np.random.default_rng(2))
    key = jax.random.PRNGKey(6)
    want = np.asarray(jax.jit(lambda p, k, ib: jscene.sample(
        p, k, batch_size=B, input_boxes=ib, clip_denoised=True, fused=fused))(
            params, key, boxes))
    noises = _ddpm_stream(key, (B, N, 5), T)
    got = scene.sample(B, clip_denoised=True, fused=fused, noise_fn=_replay(noises),
                       input_boxes=torch.from_numpy(boxes)).numpy()
    assert not noises
    assert got.shape == (B, N, 62) and np.isfinite(got).all()
    assert np.array_equal(got[:, :, 3:6], boxes[:, :, 3:6])
    assert np.array_equal(got[:, :, 8:], boxes[:, :, 8:])
    np.testing.assert_allclose(got, want, atol=SAMPLE_ATOL, rtol=0)
    # the arrange head gives every scene its own condition
    cond, _ = scene.make_condition(B, arrange_input=scene.arrange_input(torch.from_numpy(boxes)))
    assert (cond[1:] - cond[:1]).abs().max().item() > 0


def _jax_task_loss(jscene):
    """JAX get_loss with injected t and noise, from its public pieces (the
    conditions from the batch, the arrange target's channels)."""
    cfg = jscene.cfg

    def f(params, target, t, noise):
        cond, cross = jscene._conditions_from_batch(params, {}, target)
        if cfg.room_arrange_condition:
            target = jnp.concatenate([target[:, :, :3], target[:, :, 6:8]], axis=-1)
        data_t = jg.q_sample(jscene.sched, target, t, noise)
        out = jscene.net.apply(params, data_t, t, cond, cross, method=SceneNetworks.denoise)
        losses, terms = jg.p_losses(jscene.sched, jscene.spec, jscene.loss_cfg, out, target,
                                    data_t, t, noise, bounds=jscene.bounds)
        return losses.mean(), terms
    return f


def test_task_heads_condition_loss_and_gradients_match_jax():
    """A config with both task heads (the condition is instance, partial,
    arrange, in the JAX order; the target the arrange config's
    (translation, angle) channels): ``make_condition`` on a batch's task
    inputs equal to JAX's (atol 1e-6); ``get_loss`` with injected t and
    noise, every loss term and every parameter's gradient, both heads'
    included, against ``jax.grad``, within tests/test_torch_losses.py's f32
    tolerances."""
    jscene, params, scene = _models("both", 1000, seed=8)
    rng = np.random.default_rng(9)
    target = _packed(rng)
    t = np.array([0, 10, 500, 999], np.int32)
    noise = rng.normal(size=(B, N, 5)).astype(np.float32)

    want_c, _ = jscene._conditions_from_batch(params, {}, jnp.asarray(target))
    got_c, _ = scene.condition_from_target(torch.from_numpy(target))
    assert got_c.shape == want_c.shape == (B, N, 32 + 16 + 48)
    np.testing.assert_allclose(got_c.detach().numpy(), np.asarray(want_c), atol=1e-6, rtol=0)

    (want, want_d), want_g = jax.jit(jax.value_and_grad(_jax_task_loss(jscene), has_aux=True))(
        params, target, t, noise)
    loss, terms = scene.get_loss({"packed": torch.from_numpy(target)},
                                 t=torch.from_numpy(t).long(), noise=torch.from_numpy(noise))
    loss.backward()
    grads = {n: p.grad for n, p in scene.networks.named_parameters()}
    got_g = _flat(jax.tree.map(lambda a: a.numpy(), scene_tree(scene, grads)))
    want_g = _flat(want_g["params"])
    assert got_g.keys() == want_g.keys()
    assert all(any(f"fc_{h}_{i}" in k for k in got_g)
               for h in ("partial", "arrange") for i in (0, 1))
    np.testing.assert_allclose(loss.item(), float(want), rtol=F32_LOSS_RTOL)
    assert terms.keys() == want_d.keys()
    for k in want_d:
        np.testing.assert_allclose(terms[k].item(), float(want_d[k]), rtol=F32_LOSS_RTOL,
                                   err_msg=k)
    for k in want_g:
        np.testing.assert_allclose(got_g[k], want_g[k], err_msg=k, **F32_GRAD_TOL)


@pytest.mark.parametrize("freq", [1, 2])
def test_trajectory_frames_match_jax(freq):
    """The trajectory loop: x_T, the frame after t = T-1, then every
    t % freq == 0 ((1 + T) frames at freq 1, 2 + T // freq at 2), on the
    DDPM stream, against the JAX loop with the same closed-form denoiser
    (a tanh of x and t, so the check is of the loop, not of a network):
    atol 1e-5.  Then ``sample(ret_traj=True)`` on the scene model: its last
    frame is the plain DDPM sample of the same stream, bit for bit."""
    from diffuscene_tpu.diffusion import make_schedule as j_make_schedule
    from diffuscene_tpu.diffusion import samplers as JS
    from diffuscene_tpu_torch.diffusion import make_schedule
    from diffuscene_tpu_torch.diffusion import samplers as S

    T, shape = 6, (B, N, 62)
    key = jax.random.PRNGKey(3)
    js = j_make_schedule("linear", 1e-4, 0.02, T, model_mean_type="v")
    want = np.asarray(jax.jit(lambda k: JS.p_sample_loop_trajectory(
        js, "v", "fixedsmall", lambda x, t: jnp.tanh(0.7 * x + 0.1 * t[:, None, None]),
        shape, k, freq, True))(key))
    noises = _ddpm_stream(key, shape, T)
    got = S.p_sample_loop_trajectory(
        make_schedule("linear", 1e-4, 0.02, T, model_mean_type="v"), "v", "fixedsmall",
        lambda x, t: torch.tanh(0.7 * x + 0.1 * t[:, None, None]), shape, freq,
        clip_denoised=True, noise_fn=_replay(noises)).numpy()
    assert not noises
    assert got.shape == want.shape == ((1 + T) if freq == 1 else (2 + T // freq), *shape)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    _, cfg = _cfgs(None, T)
    scene = SceneDiffusion(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    traj = scene.sample(B, noise_fn=_replay(_ddpm_stream(key, shape, T)), ret_traj=True,
                        freq=freq)
    last = scene.sample(B, noise_fn=_replay(_ddpm_stream(key, shape, T)))
    assert traj.shape == got.shape and torch.equal(traj[-1], last)


def test_bound_sweep_and_prior_match_jax():
    """all_kl (calc_bpd_loop: one draw a step, no x_T) and prior_kl on the
    module forward: the four means and the per-scene prior, rtol 1e-5."""
    T = 5
    jscene, params, scene = _models(None, T)
    x0 = _packed(np.random.default_rng(4))
    key = jax.random.PRNGKey(8)
    want = jax.jit(lambda p, k, x: jscene.all_kl(p, x, k))(params, key, x0)
    k, noises = key, []
    for _ in range(T):
        k, sub = jax.random.split(k)
        noises.append(_normal(sub, x0.shape))
    got = scene.all_kl(torch.from_numpy(x0), noise_fn=_replay(noises))
    assert not noises
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name].item(), float(want[name]), rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    np.testing.assert_allclose(scene.prior_kl(torch.from_numpy(x0)).numpy(),
                               np.asarray(jscene.prior_kl(jnp.asarray(x0))), rtol=1e-5,
                               atol=1e-9)


@pytest.mark.parametrize("task", ["partial", "arrange"])
def test_bridge_carries_the_task_heads(task):
    """load_jax_params then scene_tree gives the JAX tree back bit for bit,
    the task head included; a reference state_dict (``diffusion.model.*``
    and the bare head names) maps through reference_to_scene_state_dict to
    the same weights, and the JAX package's convert_scene_model of it to
    the same tree."""
    _, params, scene = _models(task, 4)
    got = _flat(jax.tree.map(lambda a: a.numpy(), scene_tree(scene)))
    want = _flat(params["params"])
    assert got.keys() == want.keys()
    assert any(f"fc_{task}_1" in k for k in got)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    ref = {("diffusion.model." + k[len("denoiser."):] if k.startswith("denoiser.")
            else k[len("conditioner."):]): v.clone()
           for k, v in scene.networks.state_dict().items()}
    assert f"fc_{task}_condition.2.weight" in ref
    mapped = reference_to_scene_state_dict(ref)
    assert mapped.keys() == scene.networks.state_dict().keys()
    for k, v in scene.networks.state_dict().items():
        assert torch.equal(mapped[k], v), k
    jtree = _flat(convert_scene_model({k: v.numpy() for k, v in ref.items()})["params"])
    assert jtree.keys() == want.keys()
    for k in want:
        assert np.array_equal(jtree[k], want[k]), k
