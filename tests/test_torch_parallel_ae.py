"""The port's data-parallel shape-autoencoder step (AETrainer(mesh=)) over
two gloo ranks on the CPU, spawned once for the module
(tests/_torch_parallel_child.py), against the JAX step on the whole batch:
2 ranks x 4 clouds against 8 clouds, the same weights (with non-trivial
running moments), points and posterior noise.  Under the JAX package the
batch is sharded over the mesh, so train-mode BatchNorm normalises with
the moments of all 8 clouds; the port sums each channel's values and
squares over the ranks.  The JAX step is rebuilt from its public pieces
with the noise injected (tests/test_torch_autoencoder.py), at that file's
tolerances.  At most three tests: xdist hands the file out after the
slowest file of the suite.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_parallel_child as child
from diffuscene_tpu.models.autoencoder import KLAutoEncoder as JKLAutoEncoder
from diffuscene_tpu.models.autoencoder import diagonal_gaussian_kl as jkl
from diffuscene_tpu.models.autoencoder import kl_autoencoder_loss as jloss
from diffuscene_tpu.train.optim import optimizer_factory as joptimizer_factory
from diffuscene_tpu_torch.models.autoencoder import KLAutoEncoder
from diffuscene_tpu_torch.utils.convert import flax_to_torch_autoencoder, load_jax_autoencoder
from test_torch_autoencoder import (ENC_ATOL, GRAD_REL, OUT_TOL, PARAM_ATOL, PRE_BN_BIAS, _flat,
                                    _np_tree)
from test_torch_threads import below_the_longest_file  # noqa: F401 (autouse)
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)

B, N_PTS, LAT = child.AE_B, child.AE_POINTS, child.AE_LAT
# the graph layers take a max over each point's neighbours in feature
# space; at 8 clouds a few near-equal neighbours swap between the two
# frameworks' summation orders (the single-process port step shows the same
# entries against JAX), which routes those entries' gradient elsewhere
FLIP_SHARE = 1e-3


@pytest.fixture(scope="module")
def ae_case(tmp_path_factory):
    rng = np.random.default_rng(0)
    pc = rng.uniform(-0.5, 0.5, (B, N_PTS, 3)).astype(np.float32)
    eps = rng.standard_normal((B, LAT)).astype(np.float32)
    jmodel = JKLAutoEncoder(latent_dim=LAT, kl_weight=0.001)
    variables = _np_tree(jax.jit(jmodel.init)({"params": jax.random.PRNGKey(0),
                                               "sample": jax.random.PRNGKey(1)}, jnp.asarray(pc)))
    for path, a in _flat(variables["batch_stats"]):
        a += (0.1 if path[-1] == "mean" else 0.5) * rng.uniform(size=a.shape).astype(np.float32)
    for path, a in _flat(variables["params"]):
        if path[-1] in ("bias", "scale"):
            a += 0.05 * rng.standard_normal(a.shape).astype(np.float32)
    model = KLAutoEncoder(latent_dim=LAT, kl_weight=0.001, device="cpu")
    load_jax_autoencoder(model, variables)
    ranks = child.TwoRanks("ae", tmp_path_factory.mktemp("ae"),
                           {"ae_state": model.state_dict(), "pc": pc, "eps": eps})

    tx = joptimizer_factory(child.AE_TRAIN_CFG, steps_per_epoch=500)

    @jax.jit
    def step(params, bs, opt_state, pc, eps):
        def loss_fn(p):
            (mean, logvar), upd = jmodel.apply({"params": p, "batch_stats": bs}, pc, train=True,
                                               mutable=["batch_stats"],
                                               method=JKLAutoEncoder.posterior)
            lat = mean + jnp.exp(0.5 * logvar) * eps
            recon, upd = jmodel.apply({"params": p, "batch_stats": upd["batch_stats"]}, lat,
                                      train=True, mutable=["batch_stats"],
                                      method=JKLAutoEncoder.decode)
            loss, parts = jloss(jkl(mean, logvar), recon, pc, 0.001)
            return loss, (parts, upd["batch_stats"])

        (loss, (parts, new_bs)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), new_bs, loss, parts,
                optax.global_norm(grads), grads)

    params = variables["params"]
    new_p, new_bs, loss, parts, gnorm, grads = jax.tree.map(np.asarray, step(
        params, variables["batch_stats"], tx.init(params), jnp.asarray(pc), jnp.asarray(eps)))
    want = {"metrics": {"loss": loss, "loss.cd": parts["loss.cd"], "loss.kl": parts["loss.kl"],
                        "gradnorm": gnorm},
            "state": flax_to_torch_autoencoder({"params": new_p, "batch_stats": new_bs}),
            "grads": flax_to_torch_autoencoder({"params": grads, "batch_stats": new_bs})}
    return ranks, want, {n for n, _ in model.named_parameters()}


def test_two_ranks_ae_step_matches_jax(ae_case):
    """The global batch's loss terms and gradient norm on both ranks; the
    mean of the ranks' gradients against JAX's (within 1e-2 of each
    layer's largest entry, all but FLIP_SHARE of a layer's entries), and
    the updated parameters within 1e-5 where the gradient is above that
    noise and agrees, 2 lr elsewhere, equal on both ranks."""
    ranks, want, names = ae_case
    out = ranks.results()
    for r in range(2):
        m = out[r]["metrics"]
        for k in ("loss", "loss.cd", "loss.kl"):
            np.testing.assert_allclose(m[k], want["metrics"][k], **OUT_TOL, err_msg=k)
        np.testing.assert_allclose(m["gradnorm"], want["metrics"]["gradnorm"], rtol=1e-4)
    lr = child.AE_TRAIN_CFG["lr"]
    for k in names:
        assert torch.equal(out[0]["state"][k], out[1]["state"][k]), k
        layer = k.rsplit(".", 1)[0]
        scale = max(np.abs(want["grads"][f"{layer}.{leaf}"].numpy()).max()
                    for leaf in ("weight", "bias"))
        g_want = want["grads"][k].numpy()
        g_got = ((out[0]["local_grads"][k] + out[1]["local_grads"][k]) / 2).numpy()
        if k in PRE_BN_BIAS:
            assert np.abs(g_got).max() < GRAD_REL * scale, k
            noise = np.ones_like(g_want, dtype=bool)
        else:
            flipped = np.abs(g_got - g_want) > GRAD_REL * scale
            assert flipped.mean() <= FLIP_SHARE, (k, flipped.mean())
            noise = (np.abs(g_want) <= GRAD_REL * scale) | flipped
        diff = np.abs(out[0]["state"][k].numpy() - want["state"][k].numpy())
        assert diff.max() <= 2 * lr * (1 + 1e-3), k
        assert (diff[~noise] <= PARAM_ATOL).all(), (k, diff[~noise].max())


def test_two_ranks_batchnorm_moments_are_the_global_batch(ae_case):
    """Every BatchNorm's running mean and variance after the step are those
    of the whole batch (JAX's, atol 1e-4), the same on both ranks, and
    each norm counted one batch."""
    ranks, want, names = ae_case
    out = ranks.results()
    running = [k for k in want["state"] if k not in names]
    assert len(running) > 20
    for k in running:
        got = out[0]["state"][k]
        assert torch.equal(got, out[1]["state"][k]), k
        if k.endswith("num_batches_tracked"):
            assert int(got) == 1, k
            continue
        np.testing.assert_allclose(got.numpy(), want["state"][k].numpy(), atol=ENC_ATOL,
                                   rtol=1e-5, err_msg=k)
