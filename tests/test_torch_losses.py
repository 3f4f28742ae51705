"""Parity of the port's training loss with the JAX package: the 3-D box IoU
(diffuscene_tpu_torch/ops/iou3d.py), ``p_losses`` and the IoU regularizer
(diffusion/gaussian.py), the fast weight-standardization VJP
(models/denoiser.py), and the pieces that ``SceneDiffusion.get_loss``
(models/scene_model.py) is held to with its gradients in
tests/test_torch_loss_gradients.py, on the same inputs made from a seed
with numpy.

``jax.random`` cannot be replayed in torch, so the JAX loss is rebuilt from
its public pieces (q_sample, the denoise method, _conditions_from_batch,
p_losses) with the same injected timesteps and noise, and differentiated by
``jax.value_and_grad``.  Small sizes: dim 64, 4 levels, B=4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffuscene_tpu.diffusion import gaussian as jg
from diffuscene_tpu.diffusion import make_schedule as j_make_schedule
from diffuscene_tpu.models import SceneModelConfig as JSceneModelConfig
from diffuscene_tpu.models.denoiser import _ws_standardize_fast as j_ws_fast
from diffuscene_tpu.models.scene_model import SceneNetworks
from diffuscene_tpu.models.scene_model import pack_target as j_pack_target
from diffuscene_tpu.ops.iou3d import axis_aligned_bbox_overlaps_3d as j_iou
from diffuscene_tpu_torch.diffusion import gaussian as tg
from diffuscene_tpu_torch.diffusion import make_schedule
from diffuscene_tpu_torch.models import SceneModelConfig
from diffuscene_tpu_torch.models.denoiser import ws_standardize_fast
from diffuscene_tpu_torch.ops.iou3d import axis_aligned_bbox_overlaps_3d
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)


B, N, T = 4, 12, 1000
BOUNDS = {"translations_min": np.array([-2.7, 0.0, -2.7], np.float32),
          "translations_max": np.array([2.7, 3.6, 2.7], np.float32),
          "sizes_min": np.array([0.04, 0.03, 0.05], np.float32),
          "sizes_max": np.array([1.8, 1.7, 1.9], np.float32)}
# f32: the same arithmetic, summed in another order
F32_LOSS_RTOL = 1e-5
F32_GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
# bf16 with ws_fast_vjp: each framework rounds its own intermediates to
# bf16 (2^-9 relative a rounding) at different places through 4 levels of
# ~40 layers, so the two losses and gradients agree only to bf16 noise
# grown over the depth: loss terms within 2e-2 relative, the whole gradient
# within 3e-2 in relative L2 and each tensor's within 1e-1.  The f32 case
# above is the tight check of the same code.
BF16_LOSS_RTOL = 2e-2
BF16_GRAD_REL_L2 = 3e-2
BF16_LEAF_REL_L2 = 1e-1


def _boxes(rng, shape):
    lo = rng.uniform(-1, 1, shape + (3,))
    return np.concatenate([lo, lo + rng.uniform(0.05, 1.0, shape + (3,))], -1).astype(np.float32)


@pytest.mark.parametrize("mode", ["iou", "giou"])
@pytest.mark.parametrize("aligned", [False, True])
def test_iou3d_matches_jax(mode, aligned):
    """Pairwise and aligned IoU/GIoU with overlapping, disjoint, identical
    and flat (zero-volume, eps-clamped) boxes; atol 1e-6."""
    rng = np.random.default_rng(0)
    b1, b2 = _boxes(rng, (3, 9)), _boxes(rng, (3, 9))
    b2[:, 0] = b1[:, 0]                                    # identical pair
    b1[:, 1, 3:] = b1[:, 1, :3]                            # zero volume
    b2[:, 1, 3:] = b2[:, 1, :3]
    if not aligned:
        b2 = b2[:, :7]
    want = j_iou(jnp.asarray(b1), jnp.asarray(b2), mode=mode, is_aligned=aligned)
    got = axis_aligned_bbox_overlaps_3d(torch.from_numpy(b1), torch.from_numpy(b2), mode=mode,
                                        is_aligned=aligned)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def _scene_batch(rng, batch=B, n=N):
    """A batch of encoded scenes: attributes in [-1, 1], class one-hots as
    {-1, +1} with some slots empty (the last class channel +1)."""
    cls = rng.integers(0, 22, (batch, n))
    cls[:, -3:] = 21                                       # empty slots
    return {"translations": rng.uniform(-1, 1, (batch, n, 3)).astype(np.float32),
            "sizes": rng.uniform(-1, 1, (batch, n, 3)).astype(np.float32),
            "angles": rng.uniform(-1, 1, (batch, n, 2)).astype(np.float32),
            "class_labels": (np.eye(22)[cls] * 2 - 1).astype(np.float32),
            "objfeats_32": rng.normal(0, 1, (batch, n, 32)).astype(np.float32)}


@pytest.mark.parametrize("mean_type", ["eps", "x0", "v"])
@pytest.mark.parametrize("separate", [False, True])
@pytest.mark.parametrize("iou", [False, True])
def test_p_losses_matches_jax(mean_type, separate, iou):
    """Per-sample weighted losses and every loss.* term; rtol 1e-5."""
    js = j_make_schedule("linear", 1e-4, 0.02, T, model_mean_type=mean_type)
    ts = make_schedule("linear", 1e-4, 0.02, T, model_mean_type=mean_type)
    jcfg = jg.LossConfig(model_mean_type=mean_type, loss_separate=separate, loss_iou=iou)
    tcfg = tg.LossConfig(model_mean_type=mean_type, loss_separate=separate, loss_iou=iou)
    spec = jg.AttributeSpec()
    rng = np.random.default_rng(1)
    x0 = np.array(j_pack_target(JSceneModelConfig(), _scene_batch(rng)))
    noise = rng.normal(size=x0.shape).astype(np.float32)
    t = np.array([0, 7, 400, 999], np.int32)
    data_t = np.array(jg.q_sample(js, x0, t, noise))
    out = (x0 + rng.normal(size=x0.shape) * 0.3).astype(np.float32)
    bounds = {k: jnp.asarray(v) for k, v in BOUNDS.items()}
    want, want_d = jg.p_losses(js, spec, jcfg, out, x0, data_t, t, noise, bounds=bounds)
    tt = torch.from_numpy(t).long()
    got_xt = tg.q_sample(ts, torch.from_numpy(x0), tt, torch.from_numpy(noise))
    np.testing.assert_allclose(got_xt.numpy(), data_t, atol=1e-6, rtol=1e-6)
    got, got_d = tg.p_losses(ts, tg.AttributeSpec(), tcfg, torch.from_numpy(out),
                             torch.from_numpy(x0), got_xt, tt, torch.from_numpy(noise),
                             bounds={k: torch.from_numpy(v) for k, v in BOUNDS.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    assert got_d.keys() == want_d.keys()
    for k in want_d:
        np.testing.assert_allclose(got_d[k].item(), float(want_d[k]), rtol=1e-5, atol=1e-8,
                                   err_msg=k)
    if iou:
        assert got_d["loss.bbox_iou"].item() > 0


@pytest.mark.parametrize("separate", [False, True])
def test_p_losses_arrange_branch_matches_jax(separate):
    """room_arrange_condition: (translation, angle) channels only."""
    js = j_make_schedule("linear", 1e-4, 0.02, T, model_mean_type="v")
    ts = make_schedule("linear", 1e-4, 0.02, T, model_mean_type="v")
    kw = dict(model_mean_type="v", loss_separate=separate, loss_iou=False,
              room_arrange_condition=True)
    rng = np.random.default_rng(2)
    x0, noise, out = (rng.normal(size=(B, N, 5)).astype(np.float32) for _ in range(3))
    t = np.array([3, 50, 500, 998], np.int32)
    data_t = np.array(jg.q_sample(js, x0, t, noise))
    want, want_d = jg.p_losses(js, jg.AttributeSpec(), jg.LossConfig(**kw), out, x0, data_t, t,
                               noise)
    got, got_d = tg.p_losses(ts, tg.AttributeSpec(), tg.LossConfig(**kw), torch.from_numpy(out),
                             torch.from_numpy(x0), torch.from_numpy(data_t),
                             torch.from_numpy(t).long(), torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    assert got_d.keys() == want_d.keys()
    for k in want_d:
        np.testing.assert_allclose(got_d[k].item(), float(want_d[k]), rtol=1e-5, err_msg=k)


def test_iou_regularizer_matches_jax_gradients():
    """The regularizer alone and its gradient in x_recon (the clip, the
    validity mask and the descaled corners): rtol 1e-5."""
    js = j_make_schedule("linear", 1e-4, 0.02, T, model_mean_type="v")
    ts = make_schedule("linear", 1e-4, 0.02, T, model_mean_type="v")
    rng = np.random.default_rng(3)
    x = np.array(j_pack_target(JSceneModelConfig(), _scene_batch(rng))) * 0.9
    t = np.array([1, 100, 600, 999], np.int32)
    jb = {k: jnp.asarray(v) for k, v in BOUNDS.items()}
    spec, cfg = jg.AttributeSpec(), jg.LossConfig()

    def jf(xr):
        a, b = jg.iou_regularizer(js, spec, cfg, xr, t, jb)
        return a.sum() + b.sum()

    want = jax.grad(jf)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    a, b = tg.iou_regularizer(ts, tg.AttributeSpec(), tg.LossConfig(), xt,
                              torch.from_numpy(t).long(),
                              {k: torch.from_numpy(v) for k, v in BOUNDS.items()})
    (a.sum() + b.sum()).backward()
    np.testing.assert_allclose(float((a.sum() + b.sum()).item()), float(jf(jnp.asarray(x))),
                               rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ws_fast_vjp_matches_jax_custom_vjp(dtype):
    """The autograd Function against the JAX custom VJP on the same kernel
    and cotangent: forward (same one-pass moments, same rounding) and the
    backward from the saved compute-dtype w.  Forward: f32 1e-6, bf16
    within one bf16 rounding (2^-8 relative).  Backward (entries up to ~15,
    means over 96 rows summed in another order): 1e-5."""
    rng = np.random.default_rng(4)
    k = (rng.normal(size=(96, 80)) * 0.1 + 0.02).astype(np.float32)
    dw = rng.normal(size=(96, 80)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                          torch.bfloat16)
    eps = 1e-5 if dtype == "float32" else 1e-3
    w_j, vjp = jax.vjp(lambda a: j_ws_fast(a, eps, jdt), jnp.asarray(k))
    (dk_j,) = vjp(jnp.asarray(dw).astype(jdt))
    kt = torch.from_numpy(k).requires_grad_()
    w_t = ws_standardize_fast(kt, eps, tdt)
    assert w_t.dtype == tdt
    w_t.backward(torch.from_numpy(dw).to(tdt))
    assert kt.grad.dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(w_t.detach().numpy(), np.asarray(w_j), atol=1e-6)
        np.testing.assert_allclose(kt.grad.numpy(), np.asarray(dk_j), atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(w_t.detach().float().numpy(),
                                   np.asarray(w_j.astype(jnp.float32)), rtol=2 ** -8, atol=1e-6)
        np.testing.assert_allclose(kt.grad.numpy(), np.asarray(dk_j), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ws_fast_vjp_against_autograd(dtype):
    """The fast VJP against autograd through the exact standardization of a
    WS layer (JAX's tests/test_fast_train.py:88 bounds): the gradient in the
    kernel, relative to max(1, max |g|), below 1e-5 in f32 and 5e-3 in bf16,
    where the projection term uses the bf16 w."""
    from diffuscene_tpu_torch.models.denoiser import WSConv1x1

    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(4, 12, 64)).astype(np.float32))
    w0 = torch.from_numpy(rng.normal(size=(96, 64, 1)).astype(np.float32))
    grads = []
    for fast in (False, True):
        layer = WSConv1x1(64, 96, dtype=tdt)
        with torch.no_grad():
            layer.weight.copy_(w0)
        layer.fast_vjp = fast
        torch.sin(layer(x).float()).sum().backward()
        grads.append(layer.weight.grad.clone())
    ref = max(1.0, grads[0].abs().max().item())
    bound = 1e-5 if dtype == "float32" else 5e-3
    assert (grads[0] - grads[1]).abs().max().item() / ref < bound


def _configs(dtype):
    nk = dict(dim=64, dim_mults=(1, 1, 1, 1), channels=62, objectness_dim=0, class_dim=22,
              angle_dim=2, objfeat_dim=32, context_dim=0, instanclass_dim=32, seperate_all=True)
    learnable = True
    if dtype == "bfloat16":   # the b512 recipe's network, with the one-hot instance heads
        nk.update(compute_dtype="bfloat16", ws_fast_vjp=True, exact_gelu=False)
        learnable = False
    kw = dict(point_dim=62, class_dim=22, angle_dim=2, objectness_dim=0, objfeat_dim=32,
              sample_num_points=N, room_mask_condition=False, instance_condition=True,
              learnable_embedding=learnable, instance_emb_dim=32, model_mean_type="v",
              model_var_type="fixedsmall", time_num=T, loss_separate=True, loss_iou=True,
              net_kwargs=tuple(sorted(nk.items())))
    return JSceneModelConfig(**kw), SceneModelConfig(**kw)


# the JAX init tree's shapes by config: traced once a process, since a
# trace of the Flax init costs seconds and the tests reuse configs
_INIT_SHAPES = {}


def jax_params(jscene, seed):
    """Random numpy leaves in the shapes of the JAX init tree (traced, not
    run): kernels N(0, 1/fan_in), other leaves around their init value (1
    for norm scales, 0 else) with noise, so every tensor kind is exercised."""
    if jscene.cfg not in _INIT_SHAPES:
        _INIT_SHAPES[jscene.cfg] = jax.eval_shape(jscene.init, jax.random.PRNGKey(0))
    shapes = _INIT_SHAPES[jscene.cfg]
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        if name == "kernel":
            return (rng.normal(size=a.shape) / np.sqrt(a.shape[0])).astype(np.float32)
        base = 1.0 if name in ("scale", "g") else 0.0
        return (base + rng.normal(size=a.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_loss_fn(jscene):
    """JAX SceneDiffusion.get_loss with injected t and noise, from its
    public pieces: f(params, batch, t, noise) -> (loss, terms)."""
    def f(params, batch, t, noise):
        target = j_pack_target(jscene.cfg, batch)
        cond, cross = jscene._conditions_from_batch(params, batch, target)
        data_t = jg.q_sample(jscene.sched, target, t, noise)
        out = jscene.net.apply(params, data_t, t, cond, cross, method=SceneNetworks.denoise)
        losses, terms = jg.p_losses(jscene.sched, jscene.spec, jscene.loss_cfg, out, target,
                                    data_t, t, noise, bounds=jscene.bounds)
        return losses.mean(), terms
    return f


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


