"""Parity of the port's scene trainer (diffuscene_tpu_torch/train/trainer.py)
and its optimizer (train/optim.py) with the JAX package, plus the trainer's
own recursions (EMA, gradient accumulation, k steps per call) and its
checkpoint round trip.

The JAX side of a train step is rebuilt from the JAX package's public
pieces with the same injected t and noise (tests/test_torch_losses.py):
``jax.value_and_grad`` of the loss, the gradients cast to grads_dtype, the
JAX ``optimizer_factory`` tx, then the EMA formula of the JAX trainer.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffuscene_tpu.models import SceneDiffusion as JSceneDiffusion
from diffuscene_tpu.train.optim import f32_global_norm as j_f32_global_norm
from diffuscene_tpu.train.optim import fused_clip_adam as j_fused_clip_adam
from diffuscene_tpu.train.optim import optimizer_factory as j_optimizer_factory
from diffuscene_tpu_torch.models import SceneDiffusion, SceneModelConfig
from diffuscene_tpu_torch.train import optim as toptim
from diffuscene_tpu_torch.train.trainer import Trainer
from diffuscene_tpu_torch.utils.checkpoint import (load_checkpoint, load_model_weights,
                                                   save_checkpoint)
from diffuscene_tpu_torch.utils.config import as_dtype, load_config
from diffuscene_tpu_torch.utils.convert import load_jax_params, scene_tree
from test_torch_losses import BOUNDS, _configs, _flat, _scene_batch, jax_loss_fn, jax_params
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = {"flagship": "configs/uncond/diffusion_bedrooms_instancond_lat32_v.yaml",
           "b512": "configs/uncond/diffusion_bedrooms_instancond_lat32_v_b512_tpu.yaml"}


def _opt_case(seed):
    rng = np.random.default_rng(seed)
    params = {"a": rng.normal(size=(64, 32)).astype(np.float32),
              "b": rng.normal(size=(17,)).astype(np.float32)}
    return params, rng


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clipped", [False, True], ids=["unclipped", "clipped"])
def test_fused_clip_adam_matches_jax(moments, clipped):
    """Three steps of fused_clip_adam with a step schedule, the cap above
    every gradient norm or below it.  f32 moments: params atol 1e-6 (the
    same f32 expression).  bf16 moments: both round the f32 moments to bf16
    the same way; an f32 result one ulp apart may round to neighbouring bf16
    values, which moves a step by 2^-8 of itself, so atol 1e-6 + 2^-7 x lr."""
    lr, cap = 1e-2, (0.5 if clipped else 1e4)
    params, rng = _opt_case(0)
    sched = lambda step: lr * (0.5 ** (step // 2))
    jdt = None if moments == "float32" else jnp.bfloat16
    tx = j_fused_clip_adam(sched, max_grad_norm=cap, moment_dtype=jdt)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    tp = [torch.from_numpy(params[k].copy()) for k in ("a", "b")]
    opt = toptim.Optimizer(tp, lambda step: sched(step), cap, fused=True,
                           moment_dtype=as_dtype(moments))
    assert all(s.dtype == as_dtype(moments) for slot in opt.slots for s in slot)
    atol = 1e-6 if moments == "float32" else 1e-6 + 2 ** -7 * lr
    for _ in range(3):
        g = {k: (rng.normal(size=v.shape) * 0.3).astype(np.float32) for k, v in params.items()}
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        norm = opt.step([torch.from_numpy(g[k]) for k in ("a", "b")])
        np.testing.assert_allclose(norm.item(), float(j_f32_global_norm(g)), rtol=1e-6)
        assert (norm.item() > cap) == clipped
        for p, k in zip(tp, ("a", "b")):
            np.testing.assert_allclose(p.numpy(), np.asarray(jp[k]), atol=atol, rtol=0)
    for slot, name in zip(opt.slots, ("mu", "nu")):
        for s, k in zip(slot, ("a", "b")):
            want = np.asarray(getattr(state, name)[k].astype(jnp.float32))
            np.testing.assert_allclose(s.float().numpy(), want, rtol=2 ** -7, atol=1e-12)


def test_f32_global_norm_on_bf16_grads():
    g = [torch.full((1000,), 0.1, dtype=torch.bfloat16), torch.ones(3, dtype=torch.bfloat16)]
    want = float(j_f32_global_norm({"a": jnp.full((1000,), 0.1, jnp.bfloat16),
                                    "b": jnp.ones(3, jnp.bfloat16)}))
    got = toptim.f32_global_norm(g)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)


# Two trainer steps against the JAX recipe.  Step one's loss is the same
# function of the same weights (tolerances of test_torch_losses.py); the
# first Adam update is -lr * g / (|g| + eps), about -lr * sign(g), so an
# entry whose gradient lies below the two frameworks' summation (f32) or
# rounding (bf16) noise may move the other way: every parameter and EMA
# entry must agree within 2 steps x 2 lr, and all but a small share of them
# (FLIP_SHARE) within 1e-2 lr.
FLIP_SHARE = {"flagship": 1e-3, "b512": 5e-2}
STEP_TOL = {"flagship": dict(loss=1e-5, loss2=1e-4, gradnorm=1e-5),
            "b512": dict(loss=2e-2, loss2=2e-2, gradnorm=3e-2)}


def two_trainer_steps_against_jax(recipe):
    """Two steps of a config's training block with ema_decay 0.5 (so the
    EMA moves measurably), at dim 64, 4 levels, B=4, held against the JAX
    recipe as the comment above says."""
    training = dict(load_config(os.path.join(REPO, RECIPES[recipe]))["training"])
    training["ema_decay"] = 0.5
    jcfg, tcfg = _configs("float32")
    if recipe == "b512":
        jcfg, tcfg = _configs("bfloat16")
    jscene = JSceneDiffusion(jcfg, bounds=BOUNDS)
    params = jax_params(jscene, seed=11)
    scene = SceneDiffusion(tcfg, bounds=BOUNDS, device="cpu")
    trainer = Trainer(scene, training, steps_per_epoch=50, device="cpu")
    load_jax_params(scene, params)
    trainer.set_weights(scene.networks.state_dict())
    assert {s.dtype for slot in trainer.opt.slots for s in slot} == (
        {torch.bfloat16} if recipe == "b512" else {torch.float32})

    tx = j_optimizer_factory(training, 50)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    ema_dt = jnp.bfloat16 if recipe == "b512" else jnp.float32
    jema = jax.tree.map(lambda a: a.astype(ema_dt), jp)
    grad_fn = jax.value_and_grad(jax_loss_fn(jscene), has_aux=True)

    @jax.jit
    def jax_step(jp, opt_state, jema, batch, t, noise):
        (loss, terms), g = grad_fn(jp, batch, t, noise)
        if training.get("grads_dtype"):
            g = jax.tree.map(lambda a: a.astype(jnp.bfloat16), g)
        upd, opt_state = tx.update(g, opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        jema = jax.tree.map(lambda e, p: (0.5 * e.astype(jnp.float32) + 0.5 * p).astype(e.dtype),
                            jema, jp)
        return jp, opt_state, jema, loss, terms, j_f32_global_norm(g)

    rng = np.random.default_rng(12)
    tol = STEP_TOL[recipe]
    for step in range(2):
        batch = _scene_batch(rng)
        t = rng.integers(0, 1000, 4).astype(np.int32)
        noise = rng.normal(size=(4, 12, 62)).astype(np.float32)
        jp, opt_state, jema, loss, terms, gnorm = jax_step(jp, opt_state, jema, batch, t, noise)
        m = trainer.train_step(trainer.put_batch(batch), t=torch.from_numpy(t).long(),
                               noise=torch.from_numpy(noise))
        np.testing.assert_allclose(m["loss"], float(loss),
                                   rtol=tol["loss"] if step == 0 else tol["loss2"])
        if step == 0:
            np.testing.assert_allclose(m["gradnorm"], float(gnorm), rtol=tol["gradnorm"])
            for k in terms:
                np.testing.assert_allclose(m[k], float(terms[k]), rtol=tol["loss"], err_msg=k)
    assert trainer.step == 2 and trainer.opt.count == 2

    lr = float(training["lr"])
    for got, want in ((scene_tree(scene), jp["params"]),
                      (scene_tree(scene, trainer.ema_or_params()), jema["params"])):
        got, want = _flat(jax.tree.map(lambda a: a.float().numpy(), got)), _flat(want)
        assert got.keys() == want.keys()
        diff = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
        scale = np.concatenate([np.abs(want[k]).ravel() for k in want])
        # bf16 EMA storage: one rounding of |e| on top
        slack = 2 ** -8 * scale if recipe == "b512" else 0.0
        assert (diff <= 4 * lr + slack + 1e-6).all(), diff.max()
        assert ((diff > 1e-2 * lr + slack + 1e-6).mean()) <= FLIP_SHARE[recipe]


def _tiny(**training):
    """A small scene model (dim 32, 2 levels) on the CPU and its trainer."""
    nk = dict(dim=32, dim_mults=(1, 1), channels=62, objectness_dim=0, class_dim=22,
              angle_dim=2, objfeat_dim=32, context_dim=0, instanclass_dim=16,
              seperate_all=True)
    cfg = SceneModelConfig(point_dim=62, class_dim=22, angle_dim=2, objectness_dim=0,
                           objfeat_dim=32, sample_num_points=12, room_mask_condition=False,
                           instance_condition=True, learnable_embedding=True,
                           instance_emb_dim=16, model_mean_type="v", time_num=8,
                           loss_separate=True, loss_iou=True,
                           net_kwargs=tuple(sorted(nk.items())))
    base = {"optimizer": "Adam", "lr": 1e-3, "schedule": "step", "lr_step": 1000,
            "lr_decay": 0.5, "max_grad_norm": 10.0}
    scene = SceneDiffusion(cfg, bounds=BOUNDS, device="cpu")
    return Trainer(scene, {**base, **training}, device="cpu").init(0)


def _host_batches(n, seed):
    rng = np.random.default_rng(seed)
    return [_scene_batch(rng) for _ in range(n)]


def _params(trainer):
    return [p.detach().clone() for p in trainer.params]


def test_ema_follows_recursive_formula():
    """e_0 = p_0 and e_k = d e_{k-1} + (1 - d) p_k after each update
    (tests/test_ema_accum.py's recursion); rtol 1e-6."""
    d = 0.5
    tr = _tiny(ema_decay=d)
    expect = _params(tr)
    for e, p in zip(tr.ema, expect):
        assert torch.equal(e, p) and e.data_ptr() != p.data_ptr()   # a copy, not an alias
    for b in _host_batches(3, 1):
        tr.train_step(tr.put_batch(b))
        expect = [d * e + (1 - d) * p for e, p in zip(expect, _params(tr))]
        for e, want in zip(tr.ema, expect):
            torch.testing.assert_close(e, want, rtol=1e-6, atol=1e-7)
    assert any((e - p).abs().max() > 0 for e, p in zip(tr.ema, tr.params))
    ema = tr.ema_or_params()
    assert set(ema) == set(tr.names) and ema[tr.names[0]] is tr.ema[0]
    assert _tiny().ema is None and _tiny().ema_or_params()[tr.names[0]].data_ptr() != 0


def test_grad_accum_updates_every_k_steps_with_the_mean_gradient():
    """grad_accum 2: the first micro-step leaves the parameters; the second
    applies one Adam update with the running mean of the two micro-batch
    gradients (formed in f32), as a fresh optimizer given that mean does;
    the EMA decays once per real update.  atol 1e-6."""
    d = 0.5
    tr = _tiny(grad_accum=2, ema_decay=d)
    p0 = _params(tr)
    b1, b2 = (tr.put_batch(b) for b in _host_batches(2, 2))
    t1, t2 = torch.tensor([1, 2, 3, 7]), torch.tensor([0, 5, 6, 4])
    n1, n2 = torch.randn(2, 4, 12, 62, generator=torch.Generator().manual_seed(3))

    def grads(batch, t, noise):
        loss, _ = tr.scene.get_loss(batch, t=t, noise=noise)
        return torch.autograd.grad(loss, tr.params)

    g1, g2 = grads(b1, t1, n1), grads(b2, t2, n2)
    tr.train_step(b1, t=t1, noise=n1)
    for p, q in zip(tr.params, p0):
        assert torch.equal(p, q)
    for e, q in zip(tr.ema, p0):
        assert torch.equal(e, q)
    assert tr.opt.count == 0 and tr.mini_step == 1
    tr.train_step(b2, t=t2, noise=n2)
    assert tr.opt.count == 1 and tr.mini_step == 0 and tr.step == 2

    ref = [q.clone() for q in p0]
    opt = toptim.optimizer_factory(ref, tr.training_cfg)
    opt.step([a + (b - a) / 2 for a, b in zip(g1, g2)])
    for p, want in zip(tr.params, ref):
        torch.testing.assert_close(p, want, rtol=0, atol=1e-6)
    for e, q, p in zip(tr.ema, p0, tr.params):
        torch.testing.assert_close(e, d * q + (1 - d) * p, rtol=1e-6, atol=1e-7)


def test_grad_accum_keeps_f32_accumulator_with_bf16_grads():
    """The JAX package accumulates bf16 gradients in bf16; the port's
    accumulator stays f32."""
    tr = _tiny(grad_accum=3, grads_dtype="bfloat16", fused_adam=True)
    tr.train_step(tr.put_batch(_host_batches(1, 4)[0]))
    assert tr.acc.dtype == torch.float32 and tr.acc.abs().max() > 0


def test_train_step_scan_matches_sequential():
    """train_step_scan over k=3 stacked batches equals three train_step
    calls with the same t and noise: parameters bit for bit, metrics the
    per-step mean (rtol 1e-6)."""
    host = _host_batches(3, 5)
    g = torch.Generator().manual_seed(6)
    t = torch.randint(0, 8, (3, 4), generator=g)
    noise = torch.randn(3, 4, 12, 62, generator=g)
    seq, scan = _tiny(ema_decay=0.9), _tiny(ema_decay=0.9)
    ms = [seq.train_step(seq.put_batch(b), t=t[i], noise=noise[i]) for i, b in enumerate(host)]
    m = scan.train_step_scan(scan.put_batches(host), t=t, noise=noise)
    assert scan.step == seq.step == 3
    for a, b in zip(scan.params + scan.ema, seq.params + seq.ema):
        assert torch.equal(a, b)
    assert m.keys() == ms[0].keys()
    for k in m:
        np.testing.assert_allclose(m[k], np.mean([x[k] for x in ms]), rtol=1e-6, err_msg=k)


def test_checkpoint_round_trip_and_resume(tmp_path):
    """The whole state (step, parameters, bf16 EMA, bf16 Adam moments,
    accumulator, generator) survives save/load: a restored trainer takes
    the same next step as the original, with the generator's own draws.
    load_model_weights gives the EMA unless asked for the raw weights."""
    cfg = dict(ema_decay=0.9, ema_dtype="bfloat16", fused_adam=True,
               adam_moment_dtype="bfloat16", grad_accum=2)
    a = _tiny(**cfg)
    batches = [a.put_batch(b) for b in _host_batches(4, 7)]
    for b in batches[:3]:
        a.train_step(b)
    save_checkpoint(a.state_dict(), str(tmp_path), epoch=4)
    state, epoch = load_checkpoint(str(tmp_path))
    assert epoch == 4 and state["step"] == 3 and state["mini_step"] == 1
    assert all(v.dtype == torch.bfloat16 for v in state["ema"].values())
    assert all(s.dtype == torch.bfloat16 for slot in state["optimizer"]["slots"] for s in slot)

    b = _tiny(**cfg)
    b.init(99)
    b.load_state_dict(state)
    ma, mb = a.train_step(batches[3]), b.train_step(batches[3])
    assert ma == mb and a.opt.count == b.opt.count == 2
    for x, y in zip(a.params + a.ema + a.opt.slots[0], b.params + b.ema + b.opt.slots[0]):
        assert torch.equal(x, y)
    ema = load_model_weights(str(tmp_path))
    raw = load_model_weights(str(tmp_path), ema=False)
    name = a.names[0]
    assert ema[name].dtype == torch.bfloat16 and raw[name].dtype == torch.float32
    assert torch.equal(raw[name], state["model"][name])


def test_reference_state_dict_loads_like_jax_convert_scene_model():
    """A reference DiffusionSceneLayout_DDPM state_dict (``diffusion.model.*``
    and the one-hot instance heads ``fc_instance_condition.*``) maps onto the
    port's networks as the JAX package's convert_scene_model maps it onto
    the Flax tree: the same numbers, tensor for tensor."""
    from diffuscene_tpu.utils.convert import convert_scene_model
    from diffuscene_tpu_torch.utils.convert import reference_to_scene_state_dict

    _, tcfg = _configs("bfloat16")     # the one-hot instance heads
    src = SceneDiffusion(tcfg, device="cpu").init(torch.Generator().manual_seed(8))
    ref = {("diffusion.model." + k[len("denoiser."):] if k.startswith("denoiser.")
            else k[len("conditioner."):]): v for k, v in src.networks.state_dict().items()}
    assert "fc_instance_condition.0.weight" in ref
    dst = SceneDiffusion(tcfg, device="cpu")
    dst.networks.load_state_dict(reference_to_scene_state_dict(ref))
    want = _flat(convert_scene_model({k: v.numpy() for k, v in ref.items()})["params"])
    got = _flat(jax.tree.map(lambda a: a.numpy(), scene_tree(dst)))
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    with pytest.raises(KeyError):     # the frozen text encoders are not ported
        reference_to_scene_state_dict({"bertmodel.embeddings.word_embeddings.weight":
                                       torch.zeros(1)})
