"""Parity of the port's text-conditioned model with the JAX package: the
linear cross-attention block (models/denoiser.py:LinearAttentionCross),
``Unet1D(text_condition=True)``,
the text projection ``fc_text_f`` and the CLIP branch of the condition
heads and the weight bridge of the text parameters; the cross blocks of
both serving engines (models/inference.py), ``get_loss`` with its
gradients, a DDPM sample and the variational-bound sweep (``all_kl``)
conditioned on text are held to the JAX package in
tests/test_torch_text_sampling.py, with this file's models and tolerances.

Small sizes: dim 64, 4 levels, N=12, B=4, text_dim 24, L=10 tokens of 768,
f32 unless stated; weights and inputs from numpy seeds.  Tolerances: the
module forward atol 2e-4 (tests/test_torch_denoiser.py), the engines'
plain twins atol 5e-4 (tests/test_torch_engine.py), bf16 atol 1.5e-1 (the
bf16 engine tolerance), the loss and gradients those of
tests/test_torch_losses.py, the sample atol 1e-4 with the JAX noise stream
replayed (tests/test_torch_tasks.py), the bound sweep rtol 1e-5
(tests/test_torch_tasks.py).  The JAX init trees are traced once a
configuration (``_shapes``) and filled from each test's own seed.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffuscene_tpu.models import SceneDiffusion as JSceneDiffusion
from diffuscene_tpu.models import SceneModelConfig as JSceneModelConfig
from diffuscene_tpu.models import Unet1D as JUnet1D
from diffuscene_tpu.models.denoiser import LinearAttentionCross as JLinearAttentionCross
from diffuscene_tpu.models.scene_model import SceneNetworks
from diffuscene_tpu.models.scene_model import SceneModelConfig as JCfg
from diffuscene_tpu.utils.config import load_config as j_load_config
from diffuscene_tpu.utils.convert import convert_denoiser, convert_scene_model
from diffuscene_tpu_torch.models import SceneDiffusion, SceneModelConfig, Unet1D
from diffuscene_tpu_torch.models.denoiser import LinearAttentionCross
from diffuscene_tpu_torch.utils.config import load_config
from diffuscene_tpu_torch.utils.convert import (flax_to_torch_denoiser, load_jax_params,
                                                reference_to_scene_state_dict, scene_tree)

from test_torch_losses import _flat
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N, L, TEXT_DIM, T = 4, 12, 10, 24, 6
KW = dict(dim=64, dim_mults=(1, 1, 1, 1), channels=62, objectness_dim=0, class_dim=22,
          angle_dim=2, objfeat_dim=32, context_dim=0, instanclass_dim=32,
          text_condition=True, text_dim=TEXT_DIM)


def _randomize(shapes, seed):
    """Numpy leaves in the shapes of a Flax init tree: kernels N(0, 1/fan_in),
    other leaves around their init value (1 for norm scales, 0 else)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        if name == "kernel":
            return (rng.normal(size=a.shape) / np.sqrt(a.shape[0])).astype(np.float32)
        base = 1.0 if name in ("scale", "g") else 0.0
        return (base + rng.normal(size=a.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def _unet_shapes():
    return jax.eval_shape(JUnet1D(**KW).init, jax.random.PRNGKey(0), jnp.zeros((2, N, 62)),
                          jnp.zeros((2,), jnp.int32), jnp.zeros((2, N, 32)),
                          jnp.zeros((2, L, TEXT_DIM)))["params"]


def _unet_params(seed):
    return JUnet1D(**KW), _randomize(_unet_shapes(), seed)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, 62)).astype(np.float32)
    t = np.array([0, 1, 3, 5], np.int32)
    cond = rng.normal(size=(B, N, 32)).astype(np.float32)
    cc = rng.normal(size=(B, L, TEXT_DIM)).astype(np.float32)
    return x, t, cond, cc


def test_cross_block_matches_jax():
    """One block, x (B, N, 64) against L=10 tokens of 24: q softmaxed per
    head, k over the tokens, the block-diagonal context, to_out and its
    LayerNorm: atol 1e-5."""
    jmod = JLinearAttentionCross()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, N, 64)).astype(np.float32)
    cc = rng.normal(size=(B, L, TEXT_DIM)).astype(np.float32)
    p = _randomize(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x, cc)["params"], 1)
    want = np.asarray(jmod.apply({"params": p}, x, cc))
    mod = LinearAttentionCross(64, TEXT_DIM)
    out, norm = mod.to_out
    with torch.no_grad():
        mod.to_q.weight.copy_(torch.from_numpy(p["to_q"]["kernel"].T[:, :, None]))
        mod.to_kv.weight.copy_(torch.from_numpy(p["to_kv"]["kernel"].T[:, :, None]))
        out.weight.copy_(torch.from_numpy(p["to_out"]["kernel"].T[:, :, None]))
        out.bias.copy_(torch.from_numpy(p["to_out"]["bias"]))
        norm.g.copy_(torch.from_numpy(p["out_norm"]["g"]).reshape(1, -1, 1))
        got = mod(torch.from_numpy(x), torch.from_numpy(cc)).numpy()
    assert got.shape == (B, N, 64)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype,atol", [("f32", 2e-4), ("bf16", 1.5e-1)])
def test_text_unet_forward_matches_flax(dtype, atol):
    """The 9 cross blocks in their slots (down/up between block1 and
    block2, mid before mid_attn), through the bridge: f32 atol 2e-4, bf16
    1.5e-1."""
    jnet, params = _unet_params(seed=2)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    net = Unet1D(**KW, compute_dtype=tdt)
    net.load_state_dict(flax_to_torch_denoiser(params), strict=True)
    x, _, cond, cc = _inputs(3)
    t = np.array([0, 3, 250, 999], np.int32)
    want = np.asarray(jax.jit(jnet.clone(compute_dtype=jdt).apply)({"params": params}, x, t,
                                                                   cond, cc))
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(cond),
                  torch.from_numpy(cc)).numpy()
    assert got.shape == (B, N, 62)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _cfgs(time_num=T, **text):
    """Both packages' text configs at the small size; ``text`` overrides the
    embedding flags (GloVe or CLIP) and the Unet's text_dim."""
    nk = {**KW, "seperate_all": True, "text_dim": text.pop("text_dim", TEXT_DIM)}
    kw = dict(point_dim=62, class_dim=22, angle_dim=2, objectness_dim=0, objfeat_dim=32,
              sample_num_points=N, room_mask_condition=False, instance_condition=True,
              learnable_embedding=True, instance_emb_dim=32, model_mean_type="v",
              model_var_type="fixedsmall", schedule_type="linear", beta_start=1e-4,
              beta_end=0.02, time_num=time_num, loss_separate=True, loss_iou=False,
              text_condition=True, text_embed_dim=TEXT_DIM, **text,
              net_kwargs=tuple(sorted(nk.items())))
    return JSceneModelConfig(**kw), SceneModelConfig(**kw)


@functools.lru_cache(maxsize=None)
def _shapes(text):
    """The JAX init tree of the text config with the flags ``text`` (a
    sorted tuple of items), traced once (test_torch_losses.jax_params)."""
    return jax.eval_shape(JSceneDiffusion(_cfgs(**dict(text))[0]).init, jax.random.PRNGKey(0))


def _models(time_num=T, seed=11, **text):
    jcfg, cfg = _cfgs(time_num, **dict(text))
    jscene = JSceneDiffusion(jcfg)
    params = _randomize(_shapes(tuple(sorted(text.items()))), seed)
    scene = SceneDiffusion(cfg, device="cpu")
    load_jax_params(scene, params)
    return jscene, params, scene


def _text_emb(seed, width=768):
    return np.random.default_rng(seed).normal(size=(B, L, width)).astype(np.float32)


def test_bridge_carries_the_text_parameters():
    """load_jax_params then scene_tree gives the JAX tree back bit for bit,
    fc_text_f and the 9 cross blocks included (mid_attncross as the
    reference's mid_attn_cross); convert_denoiser reads the port's
    denoiser state_dict as the JAX tree, and a reference state_dict maps
    through reference_to_scene_state_dict and convert_scene_model to the
    same weights."""
    _, params, scene = _models()
    got = _flat(jax.tree.map(lambda a: a.numpy(), scene_tree(scene)))
    want = _flat(params["params"])
    assert got.keys() == want.keys()
    assert sum("attncross" in k and k.endswith("['to_q']['kernel']") for k in got) == 9
    assert any("mid_attncross_norm" in k for k in got)
    assert any("fc_text_f']['bias" in k for k in got)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    den = {k[len("denoiser."):]: v for k, v in scene.networks.state_dict().items()
           if k.startswith("denoiser.")}
    assert "mid_attn_cross.fn.fn.to_kv.weight" in den and "downs.0.2.fn.norm.g" in den
    jden = _flat(convert_denoiser(den))
    assert jden.keys() == _flat(params["params"]["denoiser"]).keys()
    ref = {("diffusion.model." + k[len("denoiser."):] if k.startswith("denoiser.")
            else k[len("conditioner."):]): v.clone()
           for k, v in scene.networks.state_dict().items()}
    assert "fc_text_f.bias" in ref
    mapped = reference_to_scene_state_dict(ref)
    for k, v in scene.networks.state_dict().items():
        assert torch.equal(mapped[k], v), k
    jtree = _flat(convert_scene_model({k: v.numpy() for k, v in ref.items()})["params"])
    assert jtree.keys() == want.keys()
    for k in want:
        assert np.array_equal(jtree[k], want[k]), k


@pytest.mark.parametrize("config", sorted(os.listdir(os.path.join(REPO, "configs/text"))))
def test_text_config_builds_with_the_jax_tree(config):
    """Each configs/text model at full width: the port's SceneDiffusion has
    one parameter for each leaf of the JAX init tree, of its shape (768
    tokens through fc_text_f to 512, the 9 cross blocks)."""
    path = os.path.join(REPO, "configs/text", config)
    net = load_config(path)["network"]
    scene = SceneDiffusion(SceneModelConfig.from_config(net), device="cpu")
    jscene = JSceneDiffusion(JCfg.from_config(j_load_config(path)["network"]))
    got, want = ({jax.tree_util.keystr(p): tuple(v.shape)
                  for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
                 for tree in (scene_tree(scene),
                              jax.eval_shape(jscene.init, jax.random.PRNGKey(0))["params"]))
    assert got == want
    assert got["['conditioner']['fc_text_f']['kernel']"] == (768, 512)
    assert sum("attncross']['to_kv" in k for k in got) == 9


def test_text_model_without_text_emb_raises():
    """A text model names the missing text_emb (ValueError) in sample,
    all_kl and condition_from_target, with no batch or a batch without it."""
    _, _, scene = _models()
    x0 = torch.zeros(B, N, 62)
    with pytest.raises(ValueError, match="text_emb"):
        scene.sample(B, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="text_emb"):
        scene.all_kl(x0, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="text_emb"):
        scene.all_kl(x0, generator=torch.Generator().manual_seed(0), batch={})
    for batch in (None, {"packed": x0}):
        with pytest.raises(ValueError, match="text_emb"):
            scene.condition_from_target(x0, batch)


@pytest.mark.parametrize("branch", ["glove", "clip"])
def test_glove_and_clip_conditions_match_jax(branch):
    """make_condition's text part: GloVe's 50-wide tokens through fc_text_f
    (with its bias), CLIP's (B, 512) sentence vector as one token (no
    projection); the instance part beside it; atol 1e-6."""
    if branch == "glove":
        jscene, params, scene = _models(text_glove_embedding=True)
        te = _text_emb(15, 50)
    else:
        jscene, params, scene = _models(text_clip_embedding=True, text_dim=512)
        te = np.random.default_rng(15).normal(size=(B, 512)).astype(np.float32)
        assert scene.conditioner.fc_text_f is None
    want_c, want_x = jscene.net.apply(params, B, N, method=SceneNetworks.make_condition,
                                      text_emb=jnp.asarray(te))
    got_c, got_x = scene.make_condition(B, text_emb=torch.from_numpy(te))
    want_shape = (B, L, TEXT_DIM) if branch == "glove" else (B, 1, 512)
    assert got_x.shape == want_x.shape == want_shape
    np.testing.assert_allclose(got_x.detach().numpy(), np.asarray(want_x), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_c.detach().numpy(), np.asarray(want_c), atol=1e-6, rtol=0)
