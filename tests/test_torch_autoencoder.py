"""Parity of the port's shape autoencoder, optimizer and train step
(diffuscene_tpu_torch/models/autoencoder.py, train/) with the JAX package's.

The same numpy inputs and weights, made from a seed, go to both; JAX's
chamfer runs its Pallas kernel in interpret mode, the port's its plain twin.
Shapes are the real widths (encoder 64-128-1024-512, latent 32, folds 512
wide over the 45x45 grid) at B=4 and 128 points.  Not B=2: in train mode
every fold-1 BatchNorm channel then sees only two codewords, and the
one-pass variance E[x^2] - E[x]^2 of flax (which the port keeps) cancels
in the channels where the two are close, so the two frameworks' summation
orders part by ~1e-3 in the decoder's output and by percents in the
gradients.  Tolerances, all f32:

- encoder outputs (mean, logvar) and BatchNorm statistics: atol 1e-4 on
  values of O(1): the port sums its matmuls and moments in another order;
- decoder outputs and losses: atol 1e-4 / rtol 1e-5;
- gradients of one train step: within 1e-2 of the largest entry of the
  layer's weight and bias gradients (the fold-1 norms, fed four codewords,
  still amplify the variance's rounding: up to 3e-3 in the fold's
  layers, under 1e-3 elsewhere); the biases of the convs that feed a
  BatchNorm have a true gradient of 0 (the norm removes any shift), and
  both frameworks give rounding noise under that bound;
- params after the step: atol 1e-5 where the gradient is above that
  noise; Adam's first step maps every gradient to about +-lr whatever
  its size, so where it is noise the two may step apart, by 2 lr at most.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from diffuscene_tpu.models.autoencoder import KLAutoEncoder as JKLAutoEncoder
from diffuscene_tpu.models.autoencoder import diagonal_gaussian_kl as jkl
from diffuscene_tpu.models.autoencoder import kl_autoencoder_loss as jloss
from diffuscene_tpu.train.optim import lr_schedule_factory as jlr_schedule
from diffuscene_tpu.train.optim import optimizer_factory as joptimizer_factory
from diffuscene_tpu.utils.convert import convert_autoencoder
from diffuscene_tpu_torch.models import autoencoder as tae
from diffuscene_tpu_torch.models.autoencoder import KLAutoEncoder
from diffuscene_tpu_torch.train import AETrainer
from diffuscene_tpu_torch.train import optim as toptim
from diffuscene_tpu_torch.utils.convert import flax_to_torch_autoencoder, load_jax_autoencoder
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)


B, N_PTS, LAT = 4, 128, 32
TRAIN_CFG = {"optimizer": "Adam", "lr": 1e-4, "schedule": "step", "lr_step": 400,
             "lr_decay": 0.1, "max_grad_norm": 10.0, "weight_decay": 0.0}
ENC_ATOL = 1e-4
OUT_TOL = dict(atol=1e-4, rtol=1e-5)
PARAM_ATOL = 1e-5
GRAD_REL = 1e-2           # of the layer's largest gradient entry
# convs whose output feeds a BatchNorm: zero true gradient on the bias
PRE_BN_BIAS = ("encoder.conv1.bias", "encoder.conv2.bias", "encoder.conv3.bias",
               "encoder.conv4.bias", "encoder.graph_layer1.conv.bias",
               "encoder.graph_layer2.conv.bias", "decoder.fold1.layers.0.bias",
               "decoder.fold1.layers.3.bias", "decoder.fold2.layers.0.bias",
               "decoder.fold2.layers.3.bias")


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(scope="module")
def case():
    """JAX model, variables with non-trivial running moments, inputs, eps."""
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
    return jmodel, variables, pc, eps


def _port(variables):
    model = KLAutoEncoder(latent_dim=LAT, kl_weight=0.001, device="cpu")
    load_jax_autoencoder(model, variables)
    return model


def test_batchnorm_matches_flax_not_torch():
    """Few rows (B=2, 8 points) make n/(n-1) visible: the running variance
    follows flax's biased one, not torch.nn.BatchNorm1d's unbiased one."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 5)).astype(np.float32)
    bn = fnn.BatchNorm(momentum=0.9)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x), use_running_average=False)
    want, upd = bn.apply(v, jnp.asarray(x), use_running_average=False, mutable=["batch_stats"])
    port = tae.BatchNorm(5)
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(port, f"running_{name}").numpy(),
                                   np.asarray(upd["batch_stats"][name]), atol=1e-6, rtol=0)
    ref = torch.nn.BatchNorm1d(5)
    ref(torch.from_numpy(x).reshape(-1, 5))
    n = 16
    unbiased = (ref.running_var - 0.9) / 0.1
    np.testing.assert_allclose(unbiased.numpy(), ((port.running_var - 0.9) / 0.1 * n / (n - 1)).numpy(),
                               rtol=1e-4)
    port.eval()
    want_eval = bn.apply({**v, **upd}, jnp.asarray(x), use_running_average=True)
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(), np.asarray(want_eval),
                               atol=1e-5, rtol=0)


def test_bridge_round_trip_is_bit_exact():
    """reference-layout state_dict -> JAX convert_autoencoder ->
    flax_to_torch_autoencoder gives the same state_dict back."""
    model = KLAutoEncoder(latent_dim=LAT, device="cpu")
    rng = np.random.default_rng(2)
    sd = {k: (torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
              if v.is_floating_point() else v) for k, v in model.state_dict().items()}
    model.load_state_dict(sd)
    back = flax_to_torch_autoencoder(convert_autoencoder(model.state_dict()))
    assert back.keys() == sd.keys()
    for k in sd:
        assert back[k].shape == sd[k].shape and back[k].dtype == sd[k].dtype, k
        assert torch.equal(back[k], sd[k]), k
    # the reference's BatchNorm1d layout: weight, bias, running moments, counter
    assert sd["encoder.conv1.weight"].shape == (64, 12, 1)
    assert sd["decoder.fold2.layers.0.weight"].shape == (512, 515, 1)
    assert sd["mean_fc.weight"].shape == (LAT, 512) and sd["fc.weight"].shape == (512, LAT)
    assert sd["decoder.fold1.layers.4.num_batches_tracked"].dtype == torch.long


@pytest.fixture(scope="module")
def jax_eval(case):
    jmodel, variables, pc, eps = case

    @jax.jit
    def run(v, pc, eps):
        mean, logvar = jmodel.apply(v, pc, train=False, method=JKLAutoEncoder.posterior)
        lat = mean + jnp.exp(0.5 * logvar) * eps
        recon = jmodel.apply(v, lat, train=False, method=JKLAutoEncoder.decode)
        kl = jkl(mean, logvar)
        loss, parts = jloss(kl, recon, pc, 0.001)
        return mean, logvar, recon, loss, parts

    return jax.tree.map(np.asarray, run(variables, jnp.asarray(pc), jnp.asarray(eps)))


def test_eval_mode_posterior_decode_and_loss(case, jax_eval):
    _, variables, pc, eps = case
    mean, logvar, recon, loss, parts = jax_eval
    model = _port(variables).eval()
    with torch.no_grad():
        tm, tl = model.posterior(torch.from_numpy(pc))
        kl, lat, trec = model(torch.from_numpy(pc), eps=torch.from_numpy(eps))
        tloss, tparts = tae.kl_autoencoder_loss(kl, trec, torch.from_numpy(pc), 0.001)
    np.testing.assert_allclose(tm.numpy(), mean, atol=ENC_ATOL, rtol=0)
    np.testing.assert_allclose(tl.numpy(), logvar, atol=ENC_ATOL, rtol=0)
    assert trec.shape == (B, 2025, 3)
    np.testing.assert_allclose(trec.numpy(), recon, **OUT_TOL)
    np.testing.assert_allclose(tloss.item(), loss, **OUT_TOL)
    for k in ("loss.cd", "loss.kl"):
        np.testing.assert_allclose(tparts[k].item(), parts[k], **OUT_TOL)
    # deterministic encode returns the mean
    with torch.no_grad():
        _, lat_det = model.encode(torch.from_numpy(pc), deterministic=True)
    assert torch.equal(lat_det, tm)


def test_train_mode_forward_and_batch_stats(case):
    jmodel, variables, pc, eps = case

    @jax.jit
    def run(v, pc):
        out, upd = jmodel.apply(v, pc, train=True, mutable=["batch_stats"],
                                method=JKLAutoEncoder.posterior)
        return out, upd["batch_stats"]

    (mean, logvar), stats = jax.tree.map(np.asarray, run(variables, jnp.asarray(pc)))
    model = _port(variables).train()
    with torch.no_grad():
        tm, tl = model.posterior(torch.from_numpy(pc))
    np.testing.assert_allclose(tm.numpy(), mean, atol=ENC_ATOL, rtol=0)
    np.testing.assert_allclose(tl.numpy(), logvar, atol=ENC_ATOL, rtol=0)
    got = convert_autoencoder(model.state_dict())["batch_stats"]["encoder"]
    for path, want in _flat(stats["encoder"]):
        node = got
        for p in path:
            node = node[p]
        np.testing.assert_allclose(node, want, atol=ENC_ATOL, rtol=1e-5, err_msg=str(path))


def test_kl_clips_logvar_and_takes_the_mean():
    rng = np.random.default_rng(3)
    mean = rng.normal(size=(3, 8)).astype(np.float32)
    logvar = (rng.normal(size=(3, 8)) * 30).astype(np.float32)        # beyond the clip
    want = np.asarray(jkl(jnp.asarray(mean), jnp.asarray(logvar)))
    got = tae.diagonal_gaussian_kl(torch.from_numpy(mean), torch.from_numpy(logvar)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert tae.diagonal_gaussian_kl(torch.zeros(2, 4), torch.zeros(2, 4)).abs().max() == 0


def test_one_train_step_matches_jax(case):
    """loss, gradnorm, updated params and batch_stats after one full step."""
    jmodel, variables, pc, eps = case
    tx = joptimizer_factory(TRAIN_CFG, steps_per_epoch=500)

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

    model = _port(variables)
    trainer = AETrainer(model, TRAIN_CFG, steps_per_epoch=500, device="cpu")
    m = trainer.train_step(torch.from_numpy(pc), eps=torch.from_numpy(eps))
    assert set(m) == {"loss", "loss.cd", "loss.kl", "gradnorm"}
    np.testing.assert_allclose(m["loss"], loss, **OUT_TOL)
    np.testing.assert_allclose(m["loss.cd"], parts["loss.cd"], **OUT_TOL)
    np.testing.assert_allclose(m["loss.kl"], parts["loss.kl"], **OUT_TOL)
    np.testing.assert_allclose(m["gradnorm"], gnorm, rtol=1e-4)
    assert trainer.step == 1

    want = flax_to_torch_autoencoder({"params": new_p, "batch_stats": new_bs})
    want_grad = flax_to_torch_autoencoder({"params": grads, "batch_stats": new_bs})
    got = model.state_dict()
    params_t = dict(model.named_parameters())
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            # the encoder's norms run once a step, the decoder's too
            assert int(got[k]) == 1, k
            continue
        if k not in params_t:                          # running moments
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=ENC_ATOL, rtol=1e-5,
                                       err_msg=k)
            continue
        g_want = want_grad[k].numpy()
        g_got = params_t[k].grad.numpy()
        # a layer's gradients share one scale: a bias's gradient sums the
        # same upstream terms that its weight's weighs by the inputs
        layer = k.rsplit(".", 1)[0]
        scale = max(np.abs(want_grad[f"{layer}.{leaf}"].numpy()).max() for leaf in ("weight", "bias"))
        if k in PRE_BN_BIAS:
            assert np.abs(g_want).max() < GRAD_REL * scale, k
            assert np.abs(g_got).max() < GRAD_REL * scale, k
            noise = np.ones_like(g_want, dtype=bool)
        else:
            np.testing.assert_allclose(g_got, g_want, atol=GRAD_REL * scale, rtol=0, err_msg=k)
            noise = np.abs(g_want) <= GRAD_REL * scale
        diff = np.abs(got[k].detach().numpy() - w.numpy())
        assert diff.max() <= 2 * TRAIN_CFG["lr"] * (1 + 1e-3), k
        assert (diff[~noise] <= PARAM_ATOL).all(), (k, diff[~noise].max())


@pytest.mark.parametrize("cfg", [
    {"schedule": "step", "lr": 1e-4, "lr_step": 3, "lr_decay": 0.1},
    {"schedule": "step", "lr": 2e-4, "lr_step": 1, "lr_decay": 0.9},
    {"schedule": "step", "lr": 1e-3, "lr_step": 5, "lr_decay": 0.5},
])
def test_lr_schedules_match_jax(cfg):
    """JAX may evaluate the schedule in f32, the port in Python floats:
    rtol 1e-5."""
    want, got = jlr_schedule(cfg), toptim.lr_schedule_factory(cfg)
    for epoch in range(14):
        np.testing.assert_allclose(got(epoch), float(want(epoch)), rtol=1e-5)


def _opt_case(seed):
    rng = np.random.default_rng(seed)
    params = {"a": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * s).astype(np.float32) for k, v in params.items()}
             for s in (0.5, 20.0, 1.0, 0.1, 3.0, 1.0, 0.2, 50.0)]
    return params, grads


@pytest.mark.parametrize("max_grad_norm", [5.0, 0.05, 1e3],
                         ids=["adam", "adam_always_clipped", "adam_never_clipped"])
def test_optimizers_match_optax(max_grad_norm):
    """Eight steps of clip + Adam + step schedule; with the cap at 5 the
    norms fall above and below it.  Params atol 1e-6, rtol 1e-6."""
    cfg = dict(optimizer="Adam", lr=1e-2, schedule="step", lr_step=2, lr_decay=0.5,
               max_grad_norm=max_grad_norm)
    params, grads = _opt_case(4)
    tx = joptimizer_factory(cfg, steps_per_epoch=2)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    tp = [torch.from_numpy(params[k].copy()) for k in ("a", "b")]
    opt = toptim.optimizer_factory(tp, cfg, steps_per_epoch=2)
    for g in grads:
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, k in zip(tp, ("a", "b")):
            p.grad = torch.from_numpy(g[k])
        norm = opt.step()
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(g)), rtol=1e-6)
        for p, k in zip(tp, ("a", "b")):
            np.testing.assert_allclose(p.numpy(), np.asarray(jp[k]), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("scale", [0.5, 2.0])
def test_clip_follows_optax_above_and_below_the_cap(scale):
    rng = np.random.default_rng(5)
    g = rng.normal(size=(7,)).astype(np.float32)
    cap = float(np.linalg.norm(g)) / scale           # the norm is below (0.5) or above (2) it
    want, _ = optax.clip_by_global_norm(cap).update(jnp.asarray(g), None)
    (got,), norm = toptim.clip_by_global_norm([torch.from_numpy(g)], cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    np.testing.assert_allclose(norm.item(), float(np.linalg.norm(g)), rtol=1e-6)
    if scale < 1:
        np.testing.assert_array_equal(got.numpy(), g)   # no +1e-6: untouched below the cap


def test_unported_optimizer_options_raise():
    """fused_adam / adam_moment_dtype take Adam without weight decay only:
    elsewhere the port raises where the JAX package drops them silently."""
    p = [torch.zeros(3, requires_grad=True)]
    for extra in ({"fused_adam": True}, {"adam_moment_dtype": "bfloat16"}):
        for bad in ({"optimizer": "SGD"}, {"weight_decay": 0.01}):
            with pytest.raises(ValueError, match="fused_adam"):
                toptim.optimizer_factory(p, dict(TRAIN_CFG, **extra, **bad))
    with pytest.raises(NotImplementedError):
        toptim.optimizer_factory(p, dict(TRAIN_CFG, optimizer="Lion"))


@pytest.mark.parametrize("extra", [
    {"optimizer": "SGD"}, {"optimizer": "RAdam"}, {"weight_decay": 0.01},
    {"schedule": "lambda"}, {"schedule": "warmup_cosine"},
], ids=["sgd", "radam", "adamw", "lambda", "warmup_cosine"])
def test_unported_optimizers_and_schedules_raise(extra):
    """The optimizers and schedules no shipped config selects are ported
    (tests/test_torch_optim_extras.py holds them against optax): each builds
    and steps; only a name the JAX package does not know raises.  The name
    is the one the test had when these options raised."""
    p = torch.ones(3, requires_grad=True)
    opt = toptim.optimizer_factory([p], dict(TRAIN_CFG, **extra))
    assert opt.name == extra.get("optimizer", "Adam")
    opt.step([torch.ones(3)])
    assert opt.count == 1 and bool(torch.isfinite(p).all())
    key = "optimizer" if "optimizer" in extra else "schedule"
    with pytest.raises(NotImplementedError, match="Lion"):
        toptim.optimizer_factory([p], dict(TRAIN_CFG, **{key: "Lion"}))