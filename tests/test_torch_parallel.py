"""The port's communication layer (diffuscene_tpu_torch/parallel) and its
data- and tensor-parallel scene Trainer, against the JAX package.

Single process: ``initialize`` is a no-op, the per-process helpers keep
everything, and ``param_shardings`` picks the JAX package's parameters.
Two gloo ranks on the CPU, spawned once for the module
(tests/_torch_parallel_child.py, which imports the port only): two
data-parallel steps, 2 ranks x 4 scenes, against the JAX ``Trainer`` step
on all 8 scenes with the same weights, timesteps and noise (the JAX loss
reads them from the batch), and the tensor-parallel steps (1 data x 2
model) against the data-parallel ones.  The JAX references run in this
process while the ranks run.

The files of the two-rank checks hold at most three tests, so xdist hands
them out after the slowest file of the suite and their spawns cost its end
nothing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_child as child
from diffuscene_tpu.models import SceneDiffusion as JSceneDiffusion
from diffuscene_tpu.models import SceneModelConfig as JSceneModelConfig
from diffuscene_tpu.parallel import make_mesh as j_make_mesh
from diffuscene_tpu.parallel import param_shardings as j_param_shardings
from diffuscene_tpu.train import Trainer as JTrainer
from diffuscene_tpu.train.trainer import TrainState
from diffuscene_tpu_torch.models import SceneDiffusion, SceneModelConfig
from diffuscene_tpu_torch.parallel import (Mesh, host_local_slice, initialize, make_mesh,
                                           param_shardings, shard_indices_for_host)
from diffuscene_tpu_torch.train.trainer import Trainer
from diffuscene_tpu_torch.utils.convert import load_jax_params, scene_tree
from test_torch_losses import _flat, _scene_batch, jax_loss_fn, jax_params
from test_torch_threads import below_the_longest_file  # noqa: F401 (autouse)
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)

STEPS = 2
# f32, the same arithmetic summed in another order (a mean of two halves):
# losses and gradient norms within 1e-5 relative;
# the first Adam updates are about lr * sign(g), so a parameter or EMA
# entry moves within 1e-5 relative + 1e-2 lr of the JAX one unless its
# gradient lies at the summation noise, where it may step the other way:
# every entry within 2 steps x 2 lr, all but FLIP_SHARE within the bound.
F32_RTOL = 1e-5
FLIP_SHARE = 1e-3
TP_RTOL = 1e-5      # tensor- vs data-parallel loss, the JAX test's bound


def _kwargs(kind):
    return child.scene_kwargs(kind)


@pytest.fixture(scope="module")
def scene_case(tmp_path_factory):
    """Start the two ranks, then run the JAX Trainer on the whole batch."""
    jscene = JSceneDiffusion(JSceneModelConfig(**_kwargs("train")), bounds=child.BOUNDS)
    params = jax_params(jscene, seed=3)
    scene = SceneDiffusion(SceneModelConfig(**_kwargs("train")), bounds=child.BOUNDS,
                           device="cpu")
    load_jax_params(scene, params)
    rng = np.random.default_rng(4)
    batches = [_scene_batch(rng, batch=child.SCENE_B) for _ in range(STEPS)]
    ts = [rng.integers(0, 8, child.SCENE_B).astype(np.int32) for _ in range(STEPS)]
    noises = [rng.normal(size=(child.SCENE_B, child.N_OBJ, 62)).astype(np.float32)
              for _ in range(STEPS)]
    state = {k: v.clone() for k, v in scene.networks.state_dict().items()}
    ranks = child.TwoRanks("scene", tmp_path_factory.mktemp("scene"),
                           {"state": state, "batches": batches, "t": ts, "noise": noises})

    # the JAX Trainer step, its loss on the batch's t and noise
    loss_fn = jax_loss_fn(jscene)
    jscene.get_loss = lambda p, batch, key: loss_fn(p, batch, batch["t"], batch["noise"])
    jmesh = j_make_mesh(n_data=1)
    jtrainer = JTrainer(jscene, child.TRAIN_CFG, steps_per_epoch=50, mesh=jmesh)
    jp = jax.tree.map(jnp.asarray, params)
    # placed as the step's outputs are, so that the second step reuses the
    # first one's compilation
    jstate = jax.device_put(
        TrainState(step=jnp.zeros((), jnp.int32), params=jp, opt_state=jtrainer.tx.init(jp),
                   ema_params=jax.tree.map(jnp.copy, jp)),
        jax.sharding.NamedSharding(jmesh, jax.sharding.PartitionSpec()))
    jmetrics = []
    for b, t, noise in zip(batches, ts, noises):
        jstate, m = jtrainer.train_step(jstate, {**b, "t": t, "noise": noise},
                                        jax.random.PRNGKey(0))
        jmetrics.append(jax.device_get(m))
    want = {"metrics": jmetrics, "params": _flat(jstate.params["params"]),
            "ema": _flat(jstate.ema_params["params"])}

    # the single-process port step whose t and noise the trainer draws
    tr = Trainer(SceneDiffusion(SceneModelConfig(**_kwargs("train")), bounds=child.BOUNDS,
                                device="cpu"), child.TRAIN_CFG, steps_per_epoch=50, device="cpu")
    tr.set_weights(state)
    tr.generator.manual_seed(5)
    drawn = tr.train_step(tr.put_batch(batches[0]))
    return ranks, want, drawn, scene


def _port_flat(scene, values):
    return _flat(jax.tree.map(lambda a: a.float().numpy(), scene_tree(scene, values)))


def _close_params(got, want, lr):
    assert got.keys() == want.keys()
    diff = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    scale = np.concatenate([np.abs(want[k]).ravel() for k in want])
    loose = diff > F32_RTOL * scale + 1e-2 * lr
    assert (diff <= 4 * lr).all(), diff.max()
    assert loose.mean() <= FLIP_SHARE, (loose.mean(), diff.max())


def test_single_process_helpers():
    """One process, nothing set: (0, 1), everything kept, a 1x1 mesh whose
    collectives are the identity; NCCL on the CPU raises."""
    assert initialize(device="cpu") == (0, 1)
    assert initialize() == (0, 1)                  # twice, and the card by default
    s = host_local_slice(32)
    assert (s.start, s.stop) == (0, 32)
    idx = np.arange(10)
    np.testing.assert_array_equal(shard_indices_for_host(idx), idx)
    mesh = make_mesh()
    assert (mesh.n_data, mesh.n_model, mesh.distributed) == (1, 1, False)
    with pytest.raises(ValueError):
        make_mesh(n_data=2)
    with pytest.raises(ValueError, match="NCCL"):
        initialize(backend="nccl", device="cpu", init_method="tcp://127.0.0.1:1",
                   world_size=2, rank=0)
    assert not torch.distributed.is_initialized()


def test_param_shardings_pick_the_jax_names():
    """For the same model and min_size (the JAX test's 64 x 64, and the
    default), the port shards the parameters whose Flax leaves the JAX
    param_shardings column-shards over a (4 data x 2 model) mesh: the train
    model and the text model (its fc_text_f and cross-attention blocks)."""
    jmesh = j_make_mesh(n_data=4, n_model=2)
    for kind, min_size in (("train", 64 * 64), ("train", 1 << 14), ("text", 32 * 32)):
        jscene = JSceneDiffusion(JSceneModelConfig(**_kwargs(kind)), bounds=child.BOUNDS)
        shapes = jax.eval_shape(jscene.init, jax.random.PRNGKey(0))
        scene = SceneDiffusion(SceneModelConfig(**_kwargs(kind)), bounds=child.BOUNDS,
                               device="cpu")
        jsh = jax.tree_util.tree_flatten_with_path(
            j_param_shardings(shapes, jmesh, min_size=min_size))[0]
        want = {jax.tree_util.keystr(p) for p, s in jsh
                if s.spec == jax.sharding.PartitionSpec(None, "model")}
        sh = param_shardings(scene.networks, Mesh(n_data=4, n_model=2), min_size=min_size)
        marks = {n: torch.full_like(p, float(sh[n] is not None))
                 for n, p in scene.networks.named_parameters()}
        got = {k for k, v in _port_flat(scene, marks).items() if v.all()}
        assert {k.replace("['params']", "", 1) for k in want} == got, (kind, min_size)
        assert len(got) > 10 if min_size < 1 << 14 else got


def test_two_ranks_scene_steps_match_jax(scene_case):
    """(a) Two data-parallel steps on 2 ranks x 4 scenes equal the JAX
    Trainer's steps on all 8: every step's loss, loss terms and gradient
    norm, then the parameters and the EMA (tolerances above), the same on
    both ranks.  (b) Tensor parallelism (1 data x 2 model, the kernels of
    the default size column-sharded) equals data parallelism: losses within
    1e-5 relative, the gathered parameters, EMA and Adam moments within 1e-6
    of each other, each rank holding less than the whole.  (c) The data-
    parallel step that draws its own t and noise equals the single-process
    step from the same seed."""
    ranks, want, drawn, scene = scene_case
    out = ranks.results()
    lr = child.TRAIN_CFG["lr"]
    for r in range(2):
        dp = out[r]["dp"]
        for got, jm in zip(dp["metrics"], want["metrics"]):
            for k in ("loss", "gradnorm", *(k for k in jm if k.startswith("loss."))):
                np.testing.assert_allclose(got[k], float(jm[k]), rtol=F32_RTOL, err_msg=k)
        _close_params(_port_flat(scene, dp["model"]), want["params"], lr)
        _close_params(_port_flat(scene, dp["ema"]), want["ema"], lr)

        tp = out[r]["tp"]
        assert tp["n_sharded"] > 10 and tp["local_numel"] < dp["local_numel"]
        for a, b in zip(tp["metrics"], dp["metrics"]):
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=TP_RTOL)
            np.testing.assert_allclose(a["gradnorm"], b["gradnorm"], rtol=TP_RTOL)
        for key in ("model", "ema"):
            for n, v in dp[key].items():
                np.testing.assert_allclose(tp[key][n].numpy(), v.numpy(), atol=1e-6, err_msg=n)
        for slot_tp, slot_dp in zip(tp["slots"], dp["slots"]):
            for a, b in zip(slot_tp, slot_dp):
                assert a.shape == b.shape
                np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
        np.testing.assert_allclose(out[r]["drawn"]["loss"], drawn["loss"], rtol=F32_RTOL)
        np.testing.assert_allclose(out[r]["drawn"]["gradnorm"], drawn["gradnorm"], rtol=F32_RTOL)
    for key in ("model", "ema"):
        for n, v in out[0]["dp"][key].items():
            assert torch.equal(v, out[1]["dp"][key][n]), n
