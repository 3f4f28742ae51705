"""The port's SGD, AdamW and RAdam, its "lambda" and "warmup_cosine"
schedules and ``freeze_mask`` (diffuscene_tpu_torch/train/optim.py) against
the JAX package's optax chains (diffuscene_tpu/train/optim.py) on the same
gradients.

Each case runs 20 steps of the clip + optimizer chain on a small parameter
set, with gradients from a seed, a clip that bites on some steps, and
schedules that change within the 20 steps (2 steps an epoch).  Tolerance:
the parameters after every step within 1e-6 of optax's, relative to their
L2 norm (f32 on both sides; the JAX schedules are f32, so the learning
rates agree to 2e-6 relative).

RAdam's rectification term ro = ro_inf - 2 t b2^t / (1 - b2^t) crosses
its threshold 5 at the 6th step.  optax forms it in f32, where the two
terms cancel: ro comes out 0.04 low there (5.955 for 5.994), r 1% low.
The port forms its per-step scalars in Python floats (ROADMAP §C), so its
RAdam is held within 1e-6 of optax's chain run in float64
(``jax.enable_x64``), the same formulas without the cancellation, and its
distance from optax in f32 is bounded by that 1% of a step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffuscene_tpu.train.optim import freeze_mask as jfreeze_mask
from diffuscene_tpu.train.optim import lr_schedule_factory as jlr_schedule_factory
from diffuscene_tpu.train.optim import optimizer_factory as joptimizer_factory
from diffuscene_tpu_torch.train import optim as toptim
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)


STEPS = 20
SPE = 2           # steps an epoch
SHAPES = {"a": (7, 5), "b": (5,), "feature_extractor": (3, 4)}
SCHEDULES = {
    "step": {"schedule": "step", "lr_step": 3, "lr_decay": 0.5},
    "lambda": {"schedule": "lambda", "start_epoch": 4, "lr_decay": 0.8},
    "warmup_cosine": {"schedule": "warmup_cosine", "warmup_epochs": 3, "epochs": 10,
                      "min_lr": 1e-4},
}
OPTIMIZERS = {
    "sgd": {"optimizer": "SGD", "momentum": 0.8},
    "adam": {"optimizer": "Adam"},
    "adamw": {"optimizer": "Adam", "weight_decay": 0.05},
    "radam": {"optimizer": "RAdam"},
}


def _run(cfg, frozen=(), x64=False):
    rng = np.random.default_rng(0)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.normal(size=s) * rng.uniform(0.1, 0.6)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(STEPS)]
    # JAX: the optax chain, with the freeze mask before it as its docstring shows
    with jax.enable_x64(x64):
        ref_dtype = np.float64 if x64 else np.float32
        tx = joptimizer_factory(cfg, steps_per_epoch=SPE)
        if frozen:
            tx = optax.chain(jfreeze_mask(params, frozen), tx)
        jp = {k: jnp.asarray(v, ref_dtype) for k, v in params.items()}
        state = tx.init(jp)
    # port: the flat-buffer Optimizer
    names = list(SHAPES)
    tp = [torch.from_numpy(params[k].copy()) for k in names]
    opt = toptim.optimizer_factory(tp, cfg, steps_per_epoch=SPE)
    if frozen:      # the mask is the Optimizer's own option: no config selects it
        opt = toptim.Optimizer(tp, opt.lr_fn, opt.max_grad_norm, name=opt.name,
                               weight_decay=opt.weight_decay, momentum=opt.momentum,
                               frozen=toptim.freeze_mask(names, frozen))
    errs = []     # per step: |port - optax| / |optax| and / |optax - init|
    p0 = np.concatenate([params[k].ravel() for k in names]).astype(np.float64)
    for g in grads:
        with jax.enable_x64(x64):
            upd, state = tx.update({k: jnp.asarray(v, ref_dtype) for k, v in g.items()}, state, jp)
            jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(g[k]) for k in names])
        want = np.concatenate([np.asarray(jp[k], np.float64).ravel() for k in names])
        got = np.concatenate([t.numpy().ravel() for t in tp])
        d = np.linalg.norm(got - want)
        errs.append((d / np.linalg.norm(want), d / max(np.linalg.norm(want - p0), 1e-30)))
    return params, tp, names, np.array(errs)


@pytest.mark.parametrize("sched", list(SCHEDULES))
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_and_schedule_match_optax(name, sched):
    cfg = {"lr": 1e-2, "max_grad_norm": 1.5, **OPTIMIZERS[name], **SCHEDULES[sched]}
    errs = _run(cfg, x64=name == "radam")[-1]
    assert errs[:, 0].max() <= 1e-6, errs[:, 0]
    js, ts = jlr_schedule_factory(cfg), toptim.lr_schedule_factory(cfg)
    for epoch in range(12):
        np.testing.assert_allclose(ts(epoch), float(js(epoch)), rtol=2e-6)


@pytest.mark.parametrize("sched", list(SCHEDULES))
def test_radam_against_optax_f32(sched):
    """Against optax's own f32 chain, the port's RAdam parts only by the
    f32 rectification term's error: within 1% of the parameters' total
    movement."""
    cfg = {"lr": 1e-2, "max_grad_norm": 1.5, **OPTIMIZERS["radam"], **SCHEDULES[sched]}
    errs = _run(cfg)[-1]
    assert errs[:5, 0].max() <= 1e-6            # before the threshold: no r
    assert errs[5:, 1].max() <= 1e-2, errs[:, 1]


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_freeze_mask_matches_optax_masked(name):
    """Frozen parameters take no gradient step (AdamW still decays them, as
    the optax chain does), and the clip's norm leaves their gradients out."""
    cfg = {"lr": 1e-2, "max_grad_norm": 1.5, **OPTIMIZERS[name], **SCHEDULES["step"]}
    params, tp, names, errs = _run(cfg, frozen=("feature_extractor",))
    assert errs[:, 0].max() <= 1e-6, errs[:, 0]
    i = names.index("feature_extractor")
    decay = (1.0 - np.array([1e-2 * 0.5 ** ((s // SPE) // 3) * 0.05 for s in range(STEPS)])).prod()
    np.testing.assert_allclose(tp[i].numpy(), params["feature_extractor"] * (
        decay if name == "adamw" else 1.0), rtol=1e-6)
    assert toptim.freeze_mask(["denoiser.x", "feature_extractor.conv1.weight"],
                              ("feature_extractor",)) == [False, True]
