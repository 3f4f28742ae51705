"""The port's image metrics (diffuscene_tpu_torch/eval/fid.py, ipr.py and
backbones.py) against the JAX package's on the CPU.

Stated tolerances:

- Fréchet distance and KID are host numpy/scipy f64 copies: rtol 1e-10.
- Pixel features against Pillow's (the JAX package's): Pillow's resize
  weights are fixed point, so a feature may differ by one level, 1/255, on
  at most 1% of the features (0.02-0.1% on these images).
- InceptionV3 (both pooling variants, ``transform_input``) and VGG16 against
  ``diffuscene_tpu.eval.backbones`` on 2 images with random weights, and the
  feature extractors against ``JaxInceptionFeatures`` / ``JaxVGG16Features``:
  the same f32 convolutions summed in other orders, relative L2 of the
  features within 1e-5 and every feature within rtol 1e-4 (atol 1e-6).
- Precision/recall counts are equal.  The k-NN radii, distances and realism
  scores are f64 through matrix products whose summation order differs
  between the two BLAS calls: rtol 1e-12.
"""
import os

import numpy as np
import pytest
import torch

from diffuscene_tpu.eval import backbones as jb
from diffuscene_tpu.eval import fid as jfid
from diffuscene_tpu.eval import ipr as jipr
from diffuscene_tpu_torch.eval import backbones as pb
from diffuscene_tpu_torch.eval import fid as pfid
from diffuscene_tpu_torch.eval import ipr as pipr
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)


FEATURE_REL_L2, FEATURE_RTOL, FEATURE_ATOL = 1e-5, 1e-4, 1e-6


def _close_features(a, b):
    assert a.shape == b.shape and np.isfinite(a).all()
    assert np.linalg.norm(a - b) <= FEATURE_REL_L2 * np.linalg.norm(b)
    np.testing.assert_allclose(a, b, rtol=FEATURE_RTOL, atol=FEATURE_ATOL)


@pytest.mark.parametrize("n,d", [(60, 8), (40, 64)])
def test_frechet_and_kid_equal_jax(n, d):
    """frechet_distance, fid_from_features (a full-rank and a singular
    covariance) and kid_from_features (blocks smaller and larger than the
    sets) on the same features: rtol 1e-10."""
    rng = np.random.default_rng(d)
    a = rng.normal(0, 1, (n, d))
    b = rng.normal(0.3, 1.2, (n + 5, d))
    mu, sig = a.mean(0), np.cov(a, rowvar=False)
    mu2, sig2 = b.mean(0), np.cov(b, rowvar=False)
    np.testing.assert_allclose(pfid.frechet_distance(mu, sig, mu2, sig2),
                               jfid.frechet_distance(mu, sig, mu2, sig2), rtol=1e-10)
    np.testing.assert_allclose(pfid.fid_from_features(a, b), jfid.fid_from_features(a, b),
                               rtol=1e-10)
    for subset in (16, 1000):
        np.testing.assert_allclose(
            pfid.kid_from_features(a, b, subset_size=subset, n_subsets=10, seed=3),
            jfid.kid_from_features(a, b, subset_size=subset, n_subsets=10, seed=3), rtol=1e-10)


def _test_images(seed, n=6, size=256):
    """Noise, smooth colour ramps and flat blocks (renders are mostly
    flat regions with edges)."""
    rng = np.random.default_rng(seed)
    noise = rng.integers(0, 256, (n // 3, size, size, 3))
    smooth = np.clip(np.cumsum(rng.normal(0, 6, (n // 3, size, size, 3)), axis=2) + 128, 0, 255)
    cell = -(-size // 8)
    blocks = np.kron(rng.integers(0, 256, (n - 2 * (n // 3), 8, 8, 3)),
                     np.ones((1, cell, cell, 1)))[:, :size, :size]
    return np.concatenate([noise, smooth, blocks]).astype(np.uint8)


@pytest.mark.parametrize("size", [256, 100])
def test_pixel_features_against_pillow(size):
    """PixelFeatures on the CPU against the JAX package's Pillow path:
    within one level (1/255), on at most 1% of the features."""
    imgs = _test_images(size, size=size)
    ours = pfid.PixelFeatures(device="cpu", batch_size=4)(imgs)
    theirs = jfid.PixelFeatures()(imgs)
    assert ours.shape == theirs.shape == (len(imgs), 32 * 32)
    diff = np.abs(ours - theirs)
    assert diff.max() <= 1 / 255 + 1e-6
    assert (diff > 1e-6).mean() <= 0.01


def _npz(tmp_path, name, sd):
    path = str(tmp_path / f"{name}.npz")
    np.savez(path, **sd)
    return path


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    root = tmp_path_factory.mktemp("weights")
    return {"inception": _npz(root, "inception", jb.random_inception_state_dict(0)),
            "vgg": _npz(root, "vgg", jb.random_vgg16_state_dict(0))}


def test_weight_bridge_and_loaders(weights, tmp_path):
    """The port's loaders give the JAX package's folded (HWIO, BatchNorm
    eps 1e-3) parameters exactly, from .npz and from a torch .pth; the
    port's random state dicts are the JAX package's; the modules built from
    the JAX package's own parameter dict hold the same buffers; a weight of
    the wrong shape raises."""
    ours, theirs = pb.load_inception_params(weights["inception"]), jb.load_inception_params(
        weights["inception"])
    assert ours.keys() == theirs.keys()
    for k in ours:
        for part in ("w", "b"):
            np.testing.assert_array_equal(ours[k][part], theirs[k][part])
    sd = pb.random_inception_state_dict(1)
    for k, v in jb.random_inception_state_dict(1).items():
        np.testing.assert_array_equal(sd[k], v)
    vgg = pb.load_vgg16_params(weights["vgg"])
    for k, v in jb.load_vgg16_params(weights["vgg"]).items():
        np.testing.assert_array_equal(vgg[k]["w"], v["w"])
    pth = str(tmp_path / "inception.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
    npz = _npz(tmp_path, "inception1", sd)
    a, b = pb.load_inception_params(pth), pb.load_inception_params(npz)
    for k in a:
        np.testing.assert_array_equal(a[k]["w"], b[k]["w"])
    from_jax = pb.InceptionV3Pool3(jb.load_inception_params(weights["inception"]))
    from_port = pb.InceptionV3Pool3(pb.load_inception_params(weights["inception"]))
    for (ka, va), (kb, vb) in zip(from_jax.state_dict().items(), from_port.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert from_port.Mixed_7c__branch_pool_w.shape == (192, 2048, 1, 1)
    vgg["classifier.0"] = {"w": vgg["classifier.0"]["w"].T, "b": vgg["classifier.0"]["b"]}
    with pytest.raises(ValueError, match="classifier.0"):
        pb.VGG16Fc2(vgg)


@pytest.mark.parametrize("fid_pools,transform_input", [(True, False), (False, False),
                                                       (False, True)])
def test_inception_equals_jax(weights, fid_pools, transform_input):
    """InceptionV3Pool3 (NCHW, torch) against inception_v3_pool3 (NHWC,
    JAX) on 2 images of 107x107 in [-1, 1]; the two pooling variants differ."""
    x = np.random.default_rng(5).uniform(-1, 1, (2, 107, 107, 3)).astype(np.float32)
    theirs = np.asarray(jb.inception_v3_pool3(jb.load_inception_params(weights["inception"]), x,
                                              fid_pools=fid_pools,
                                              transform_input=transform_input))
    model = pb.InceptionV3Pool3(pb.load_inception_params(weights["inception"]),
                                fid_pools=fid_pools, transform_input=transform_input)
    with torch.no_grad():
        ours = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert ours.shape == (2, 2048)
    _close_features(ours, theirs)
    if not fid_pools and not transform_input:
        model.fid_pools = True
        with torch.no_grad():
            other = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
        assert np.abs(other - ours).max() > 1e-4


def test_vgg16_equals_jax(weights):
    """VGG16Fc2 against vgg16_fc2 on 2 ImageNet-normalized 224x224 images
    (the NCHW flatten before the classifier)."""
    x = np.random.default_rng(6).normal(0, 1, (2, 224, 224, 3)).astype(np.float32)
    theirs = np.asarray(jb.vgg16_fc2(jb.load_vgg16_params(weights["vgg"]), x))
    with torch.no_grad():
        ours = pb.VGG16Fc2(pb.load_vgg16_params(weights["vgg"]))(
            torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert ours.shape == (2, 4096)
    _close_features(ours, theirs)


@pytest.fixture(scope="module")
def jax_extractors(weights):
    """The JAX package's extractors, each jit-compiled once for this module
    (batch 2)."""
    return {"inception": jfid.JaxInceptionFeatures(weights["inception"], batch_size=2),
            "vgg": jfid.JaxVGG16Features(weights["vgg"], batch_size=2)}


@pytest.mark.parametrize("size", [256, 64])
def test_feature_extractors_equal_jax(weights, jax_extractors, size):
    """InceptionFeatures (resize to 299, an enlargement) and VGG16Features
    (resize to 224: a reduction from 256, which antialiases as
    jax.image.resize does) against the JAX package's extractors on 2
    renders-like images."""
    imgs = _test_images(size, n=3, size=size)[1:]
    _close_features(pfid.InceptionFeatures(weights["inception"], device="cpu")(imgs),
                    jax_extractors["inception"](imgs))
    _close_features(pfid.VGG16Features(weights["vgg"], device="cpu", batch_size=1)(imgs),
                    jax_extractors["vgg"](imgs))


def test_missing_weights_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="refusing"):
        pfid.InceptionFeatures(str(tmp_path / "absent.pth"), device="cpu")
    with pytest.raises(FileNotFoundError):
        pfid.VGG16Features(None, device="cpu")


@pytest.mark.parametrize("d", [16, 512])
def test_ipr_equals_jax(d, tmp_path):
    """Pairwise distances, k-NN radii (k=3 and 5), precision/recall (with
    subsampling), realism and batched realism scores, the precalculated
    manifold round trip and compute_ipr_folders over pixel features."""
    rng = np.random.default_rng(d)
    real = rng.normal(0, 1, (300, d)).astype(np.float32)
    fake = rng.normal(0.2, 1.1, (260, d)).astype(np.float32)
    np.testing.assert_allclose(pipr.pairwise_distances(real[:50], fake, chunk=16, device="cpu"),
                               jipr.pairwise_distances(real[:50], fake, chunk=16), rtol=1e-12)
    for k in (3, 5):
        np.testing.assert_allclose(pipr.knn_radii(real, k, device="cpu"),
                                   jipr.knn_radii(real, k), rtol=1e-12)
        for n in (None, 200):
            assert (pipr.compute_precision_recall(real, fake, k=k, num_samples=n, seed=1,
                                                  device="cpu")
                    == jipr.compute_precision_recall(real, fake, k=k, num_samples=n, seed=1))
    radii = jipr.knn_radii(real, 3)
    np.testing.assert_allclose(pipr.realism(real, radii, fake[0], device="cpu"),
                               jipr.realism(real, radii, fake[0]), rtol=1e-12)
    np.testing.assert_allclose(pipr.compute_realism_scores(real, fake, device="cpu"),
                               jipr.compute_realism_scores(real, fake), rtol=1e-12)
    pipr.save_manifold(str(tmp_path / "m"), real, k=3, device="cpu")
    feats, r, k = pipr.load_manifold(str(tmp_path / "m.npz"))
    assert k == 3 and np.array_equal(feats, real)
    np.testing.assert_allclose(r, radii, rtol=1e-12)
    ra, rb = np.random.default_rng(0), np.random.default_rng(0)
    np.testing.assert_array_equal(pipr.subsample_features(real, 100, ra),
                                  jipr.subsample_features(real, 100, rb))


def test_folder_metrics_equal_jax(tmp_path):
    """compute_fid_folders, compute_kid_folders and compute_ipr_folders over
    two folders of PNGs (written by Pillow, read by the port's reader) with
    8x8 pixel features: FID within 1e-3 relative and KID within 1e-5 (both move
    with the pixel features' one-level differences; KID is near 0 here),
    precision and recall equal."""
    from PIL import Image

    for name, seed in (("real", 0), ("fake", 1)):
        os.makedirs(tmp_path / name)
        for i, img in enumerate(_test_images(seed, n=9)):
            Image.fromarray(img).save(tmp_path / name / f"{i:05d}.png")
    real, fake = str(tmp_path / "real"), str(tmp_path / "fake")
    np.testing.assert_array_equal(pfid.load_image_folder(real), jfid.load_image_folder(real))
    ours, theirs = pfid.PixelFeatures(size=8, device="cpu"), jfid.PixelFeatures(size=8)
    np.testing.assert_allclose(pfid.compute_fid_folders(real, fake, ours),
                               jfid.compute_fid_folders(real, fake, theirs), rtol=1e-3)
    np.testing.assert_allclose(pfid.compute_kid_folders(real, fake, ours, subset_size=5),
                               jfid.compute_kid_folders(real, fake, theirs, subset_size=5),
                               atol=1e-5)
    assert (pipr.compute_ipr_folders(real, fake, ours, k=2, num_samples=8, device="cpu")
            == jipr.compute_ipr_folders(real, fake, theirs, k=2, num_samples=8))
