"""The port's mixed-precision train step (Trainer(mixed_precision=True),
diffuscene_tpu_torch/train/trainer.py) against the JAX package's
Trainer(mixed_precision=True) step, with the same weights, batch,
timesteps and noise (the JAX loss reads them from the batch), at the JAX
test's widths (dim 32, 2 levels, N=12) and B=8: the f32 master parameters
cast to bf16 once a step outside the gradient, the gradients of the bf16
copies back to f32.

- bf16 config: the JAX test's bounds (tests/test_mixed_precision.py): the
  loss within 2e-2 relative, and after one Adam step every parameter
  within 2.05 lr of JAX's, under 2% of them more than 0.5 lr apart (the
  first update is about lr * sign(g), and where the two frameworks' bf16
  roundings leave g at noise it may flip).  The port's mixed-precision
  step is held to the port's plain bf16 step by the same bounds, as the
  JAX test holds JAX's.
- f32 config: both compute in f32 on the bf16-rounded weights (flax
  promotes a bf16 parameter to the module's f32 dtype) but standardize the
  WS kernels in bf16 (the JAX WSDense on a bf16 kernel), and round the
  gradients to bf16.  XLA's CPU fusion keeps some intermediates of that
  standardization in f32 where the port rounds each op to bf16, so the
  standardized kernels agree to a bf16 rounding, not bit for bit: the loss
  within 4e-4 relative (2.4e-4 measured; the port's f32 standardization,
  what flax's promotion alone would give, is 6.8e-4 off, so the bound
  holds the bf16 standardization), the parameters within the bf16
  config's bounds.
- The parameters, Adam moments and EMA stay f32; ``--mixed_precision``
  trains through the CLI.

Three tests: xdist hands the file out after the slowest file of the suite.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffuscene_tpu.models import SceneDiffusion as JSceneDiffusion
from diffuscene_tpu.models import SceneModelConfig as JSceneModelConfig
from diffuscene_tpu.parallel import make_mesh as j_make_mesh
from diffuscene_tpu.train import Trainer as JTrainer
from diffuscene_tpu.train.trainer import TrainState
from diffuscene_tpu_torch.models import SceneDiffusion, SceneModelConfig
from diffuscene_tpu_torch.train.trainer import Trainer
from diffuscene_tpu_torch.utils.convert import load_jax_params, scene_tree
from test_torch_losses import _flat, _scene_batch, jax_loss_fn, jax_params
from test_torch_threads import below_the_longest_file  # noqa: F401 (autouse)
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)

B, N_OBJ, T = 8, 12, 50
LR = 2e-4
TCFG = {"optimizer": "Adam", "lr": LR, "max_grad_norm": 10.0}
BOUNDS = {"bfloat16": dict(loss=2e-2, max_lr=2.05, loose_lr=0.5, loose_share=0.02),
          "float32": dict(loss=4e-4, max_lr=2.05, loose_lr=0.5, loose_share=0.02)}


def _kwargs(dtype):
    nk = dict(dim=32, dim_mults=(1, 1), channels=62, objectness_dim=0, class_dim=22,
              angle_dim=2, objfeat_dim=32, context_dim=0, instanclass_dim=16,
              seperate_all=True)
    if dtype == "bfloat16":
        nk["compute_dtype"] = "bfloat16"
    return dict(point_dim=62, class_dim=22, angle_dim=2, objectness_dim=0, objfeat_dim=32,
                sample_num_points=N_OBJ, room_mask_condition=False, instance_condition=True,
                learnable_embedding=True, instance_emb_dim=16, model_mean_type="v",
                time_num=T, loss_separate=True, loss_iou=False,
                net_kwargs=tuple(sorted(nk.items())))


def _jax_kwargs(dtype):
    kw = _kwargs(dtype)
    nk = dict(kw["net_kwargs"])
    if "compute_dtype" in nk:
        nk["compute_dtype"] = jnp.bfloat16
    return dict(kw, net_kwargs=tuple(sorted(nk.items())))


def _apart(got, want, bound):
    """Every entry within max_lr * LR; the share more than loose_lr * LR
    apart below loose_share."""
    assert got.keys() == want.keys()
    d = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert d.max() <= bound["max_lr"] * LR, d.max()
    assert (d > bound["loose_lr"] * LR).mean() < bound["loose_share"], \
        (d > bound["loose_lr"] * LR).mean()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mixed_precision_step_matches_jax(dtype):
    bound = BOUNDS[dtype]
    jscene = JSceneDiffusion(JSceneModelConfig(**_jax_kwargs(dtype)))
    params = jax_params(jscene, seed=8)
    rng = np.random.default_rng(9)
    batch = _scene_batch(rng, batch=B)
    t = rng.integers(0, T, B).astype(np.int32)
    noise = rng.normal(size=(B, N_OBJ, 62)).astype(np.float32)

    loss_fn = jax_loss_fn(jscene)
    jscene.get_loss = lambda p, b, key: loss_fn(p, b, b["t"], b["noise"])
    jtrainer = JTrainer(jscene, TCFG, mesh=j_make_mesh(n_data=1), mixed_precision=True)
    jp = jax.tree.map(jnp.asarray, params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=jp, opt_state=jtrainer.tx.init(jp),
                       ema_params=jax.tree.map(jnp.copy, jp))
    state, jm = jtrainer.train_step(state, {**batch, "t": t, "noise": noise},
                                    jax.random.PRNGKey(0))
    want = _flat(jax.device_get(state.params)["params"])

    got = {}
    for mp in (True, False):
        scene = SceneDiffusion(SceneModelConfig(**_kwargs(dtype)), device="cpu")
        load_jax_params(scene, params)
        # with an EMA, whose dtype is checked below (the JAX step runs without
        # one: an EMA does not enter a first step's parameters)
        trainer = Trainer(scene, {**TCFG, "ema_decay": 0.5}, device="cpu", mixed_precision=mp)
        trainer.set_weights(scene.networks.state_dict())
        m = trainer.train_step(trainer.put_batch(batch), t=torch.from_numpy(t).long(),
                               noise=torch.from_numpy(noise))
        flat = _flat(jax.tree.map(lambda a: a.float().numpy(), scene_tree(scene)))
        got[mp] = (m, flat)
        if mp:
            dtypes = ({p.dtype for p in trainer.params} | {e.dtype for e in trainer.ema}
                      | {s.dtype for slot in trainer.opt.slots for s in slot})
            assert dtypes == {torch.float32}
    m, flat = got[True]
    assert np.isfinite(m["loss"])
    np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=bound["loss"])
    _apart(flat, want, bound)
    # the port's mixed-precision step against its plain step (the JAX test's check)
    plain_m, plain = got[False]
    assert abs(m["loss"] - plain_m["loss"]) <= 2e-2 * max(1.0, abs(plain_m["loss"]))
    _apart(flat, plain, BOUNDS["bfloat16"])


def test_mixed_precision_trains_through_the_cli(tmp_path):
    """train_diffusion --mixed_precision on a synthetic dataset, one epoch
    on the CPU: a finite loss in stats.txt and f32 weights in the
    checkpoint."""
    from diffuscene_tpu_torch.cli.train_diffusion import main as train_main
    from diffuscene_tpu_torch.utils.checkpoint import load_checkpoint
    from test_torch_scene_data import _cli_config

    cfg = _cli_config(tmp_path, ema_decay=0.9)
    out = str(tmp_path / "out")
    train_main([cfg, out, "--experiment_tag", "mp", "--epochs", "1", "--mixed_precision",
                "--log_every", "1", "--device", "cpu"])
    exp = os.path.join(out, "mp")
    state, epoch = load_checkpoint(exp)
    assert epoch == 0 and state["step"] == 2
    assert {v.dtype for v in state["model"].values()} == {torch.float32}
    with open(os.path.join(exp, "params.json")) as f:
        assert json.load(f)["mixed_precision"] == "True"      # the arguments as strings
    with open(os.path.join(exp, "stats.txt")) as f:
        text = f.read()
    assert "loss" in text and "nan" not in text
