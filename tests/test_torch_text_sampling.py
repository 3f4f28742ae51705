"""The text-conditioned model's slow parity cases against the JAX package,
on tests/test_torch_text_model.py's models, inputs and tolerances (its
docstring states them): the cross blocks of both serving engines
(models/inference.py), ``get_loss`` with its gradients, a DDPM sample
through each engine and the variational-bound sweep (``all_kl``).  A file
of its own so that the test runner's file scheduler starts these cases
beside the long JAX files, not before them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffuscene_tpu.diffusion import gaussian as jg
from diffuscene_tpu.models import inference as jinf
from diffuscene_tpu.models.scene_model import SceneNetworks
from diffuscene_tpu.models.scene_model import pack_target as j_pack_target
from diffuscene_tpu_torch.models import Unet1D
from diffuscene_tpu_torch.models import inference as tinf
from diffuscene_tpu_torch.utils.convert import denoiser_tree, flax_to_torch_denoiser, scene_tree
from test_torch_losses import F32_GRAD_TOL, F32_LOSS_RTOL, _flat, _scene_batch
from test_torch_tasks import _ddpm_stream, _normal, _replay
from test_torch_text_model import B, KW, N, T, _inputs, _models, _text_emb, _unet_params
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)


@pytest.mark.parametrize("engine", ["3-D", "rows"])
def test_engines_with_text_match_jax_engines(engine):
    """The 3-D engine (plain twins of B1 and B2) against the JAX 3-D engine,
    and the rows engine (plain twin of B4) against the JAX rows engine with
    XLA chains, both with exact GELU and the 9 precomputed contexts: atol
    5e-4; the port makes 9 contexts a preparation and none a forward."""
    jnet, params = _unet_params(seed=4)
    net = Unet1D(**KW)
    net.load_state_dict(flax_to_torch_denoiser(params))
    x, t, cond, cc = _inputs(5)
    jprep = jinf.prepare_inference_params(jnet, params, num_timesteps=T)
    jctx = jinf.precompute_conditioning(jnet, jprep, jnp.asarray(cond), jnp.asarray(cc))
    prep = tinf.prepare_inference_params(net, denoiser_tree(net), num_timesteps=T)
    calls = tinf.cross_context.calls
    ctx = tinf.precompute_conditioning(net, prep, torch.from_numpy(cond), torch.from_numpy(cc))
    assert tinf.cross_context.calls - calls == 9 and len(ctx["cross"]) == 9
    for name, mat in jctx["cross"].items():
        np.testing.assert_allclose(ctx["cross"][name].numpy(), np.asarray(mat), atol=1e-5,
                                   rtol=0, err_msg=name)
    xt, tt = torch.from_numpy(x), torch.from_numpy(t).long()
    calls = tinf.cross_context.calls
    if engine == "3-D":
        want = np.asarray(jax.jit(lambda x, t: jinf.fused_unet1d_forward(
            jnet, jprep, x, t, cond_ctx=jctx, exact_gelu=True))(x, t))
        got = tinf.fused_unet1d_forward(net, prep, xt, tt, cond_ctx=ctx, exact_gelu=True)
    else:
        jchains = jinf.prepare_chain_params(jnet, jprep, frozenset(jctx["film_c"]))
        jrows = {"film_c2": {k: v.reshape(-1, v.shape[-1]) for k, v in jctx["film_c"].items()},
                 "cross": jctx["cross"]}
        want = np.asarray(jax.jit(lambda x, t: jinf.fused_unet1d_forward_rows(
            jnet, jprep, jchains, x, t, jrows, exact_gelu=True, chain_backend="xla"))(x, t))
        chains = tinf.prepare_chain_params(net, prep, frozenset(ctx["film_c"]))
        rows = {"film_c2": {k: v.reshape(-1, v.shape[-1]) for k, v in ctx["film_c"].items()},
                "cross": ctx["cross"]}
        got = tinf.fused_unet1d_forward_rows(net, prep, chains, xt, tt, rows, exact_gelu=True)
    assert tinf.cross_context.calls == calls
    assert got.shape == (B, N, 62)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=0)


def _jax_loss(jscene):
    def f(params, batch, t, noise):
        target = j_pack_target(jscene.cfg, batch)
        cond, cross = jscene._conditions_from_batch(params, batch, target)
        data_t = jg.q_sample(jscene.sched, target, t, noise)
        out = jscene.net.apply(params, data_t, t, cond, cross, method=SceneNetworks.denoise)
        losses, terms = jg.p_losses(jscene.sched, jscene.spec, jscene.loss_cfg, out, target,
                                    data_t, t, noise, bounds=jscene.bounds)
        return losses.mean(), terms
    return f


def test_text_loss_and_gradients_match_jax():
    """get_loss on a batch with its text_emb (10 tokens of 768), injected t
    and noise: the loss, every term and every parameter's gradient against
    jax.grad, fc_text_f's and the cross blocks' among them (each non-zero),
    within tests/test_torch_losses.py's f32 tolerances."""
    jscene, params, scene = _models(time_num=1000, seed=6)
    rng = np.random.default_rng(7)
    batch = {**_scene_batch(rng), "text_emb": _text_emb(8)}
    t = np.array([0, 10, 500, 999], np.int32)
    noise = rng.normal(size=(B, N, 62)).astype(np.float32)
    (want, want_d), want_g = jax.jit(jax.value_and_grad(_jax_loss(jscene), has_aux=True))(
        params, batch, t, noise)
    loss, terms = scene.get_loss({k: torch.from_numpy(v) for k, v in batch.items()},
                                 t=torch.from_numpy(t).long(), noise=torch.from_numpy(noise))
    loss.backward()
    grads = {n: p.grad for n, p in scene.networks.named_parameters()}
    got_g = _flat(jax.tree.map(lambda a: a.numpy(), scene_tree(scene, grads)))
    want_g = _flat(want_g["params"])
    assert got_g.keys() == want_g.keys()
    text = [k for k in got_g if "attncross" in k or "fc_text_f" in k]
    assert len(text) == 9 * 6 + 2 and all(np.abs(got_g[k]).max() > 0 for k in text)
    np.testing.assert_allclose(loss.item(), float(want), rtol=F32_LOSS_RTOL)
    assert terms.keys() == want_d.keys()
    for k in want_d:
        np.testing.assert_allclose(terms[k].item(), float(want_d[k]), rtol=F32_LOSS_RTOL,
                                   err_msg=k)
    for k in want_g:
        np.testing.assert_allclose(got_g[k], want_g[k], err_msg=k, **F32_GRAD_TOL)


@pytest.mark.parametrize("fused,jfused", [(False, False), (True, True), ("rows", "rows_xla")])
def test_text_sample_matches_jax(fused, jfused):
    """A 5-step DDPM sample conditioned on text_emb (B, 10, 768), the JAX
    noise stream replayed: the module forward, the 3-D engine and the rows
    engine (the JAX rows engine with XLA chains), atol 1e-4; the 9 contexts
    are made once a sample, not once a step."""
    steps = 5
    jscene, params, scene = _models(time_num=steps, seed=12)
    te = _text_emb(13)
    key = jax.random.PRNGKey(14)
    want = np.asarray(jax.jit(lambda p, k, e: jscene.sample(
        p, k, batch_size=B, text_emb=e, clip_denoised=True, fused=jfused))(params, key, te))
    noises = _ddpm_stream(key, (B, N, 62), steps)
    calls = tinf.cross_context.calls
    got = scene.sample(B, clip_denoised=True, fused=fused, noise_fn=_replay(noises),
                       text_emb=torch.from_numpy(te)).numpy()
    assert tinf.cross_context.calls - calls == (0 if fused is False else 9)
    assert not noises
    assert got.shape == (B, N, 62) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_text_bound_sweep_matches_jax():
    """all_kl with a batch reads its text_emb through condition_from_target,
    as the JAX all_kl reads it through _conditions_from_batch: the four
    means against the JAX sweep with its noise replayed, rtol 1e-5; another
    description gives another bound."""
    steps = 5
    jscene, params, scene = _models(time_num=steps, seed=12)
    rng = np.random.default_rng(16)
    x0 = rng.normal(size=(B, N, 62)).astype(np.float32)
    te = _text_emb(17)
    key = jax.random.PRNGKey(18)
    want = jax.jit(lambda p, x, k, e: jscene.all_kl(p, x, k, sample_params={"text_emb": e}))(
        params, x0, key, te)

    def stream():
        k, out = key, []
        for _ in range(steps):
            k, sub = jax.random.split(k)
            out.append(_normal(sub, x0.shape))
        return out

    noises = stream()
    got = scene.all_kl(torch.from_numpy(x0), batch={"text_emb": torch.from_numpy(te)},
                       noise_fn=_replay(noises))
    assert not noises
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name].item(), float(want[name]), rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    other = scene.all_kl(torch.from_numpy(x0),
                         batch={"text_emb": torch.from_numpy(_text_emb(19))},
                         noise_fn=_replay(stream()))
    assert abs(other["total_bpd_b"].item() - got["total_bpd_b"].item()) > 1e-6

