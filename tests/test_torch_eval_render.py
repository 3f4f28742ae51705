"""The port's PNG codec and renders (diffuscene_tpu_torch/eval/png.py and
eval/render.py) against Pillow and the JAX package's renders on the CPU.

The renders are numpy copies, so the same inputs, made from a seed, must
give equal pixels: the box rasterizer, the textured top-down and
perspective mesh rasterizers and the orbit frames.  Colours are passed
explicitly (``colors``/``palette``/``kd``), since the JAX package's fallback
colour of an unnamed label is seeded by Python's salted ``hash`` and the
port's by ``zlib.crc32``.  The codec is held against Pillow both ways: the
port's files read by Pillow, Pillow's read by the port, and every row
filter.
"""
import io
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from diffuscene_tpu.data.raw import load_obj_mesh as j_load_obj_mesh
from diffuscene_tpu.eval import render as jr
from diffuscene_tpu.eval.retrieval import SceneMesh as JSceneMesh
from diffuscene_tpu_torch.data import make_synthetic_catalog
from diffuscene_tpu_torch.data.raw import load_obj_mesh
from diffuscene_tpu_torch.eval import png
from diffuscene_tpu_torch.eval import render as pr
from diffuscene_tpu_torch.eval.retrieval import SceneMesh

MODES = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}


def _images(seed, h=19, w=23):
    """Noise and a smooth ramp (Pillow's encoder picks other filters for
    each) for every channel count."""
    rng = np.random.default_rng(seed)
    for c in MODES:
        noise = rng.integers(0, 256, (h, w, c)).astype(np.uint8)
        smooth = (np.cumsum(rng.integers(0, 9, (h, w, c)), axis=1) % 256).astype(np.uint8)
        yield c, noise
        yield c, smooth


def _filtered_png(img, filters):
    """A PNG of ``img`` (H, W, C) whose row y is filtered with
    ``filters[y % len(filters)]``: the encoder side of all five filters."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    out = []
    prior = np.zeros(w * c, np.int64)
    for y in range(h):
        f, cur = filters[y % len(filters)], rows[y]
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int64), prior[:-c]])
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prior
        elif f == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, ul))
        out.append(bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prior = cur

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("seed", [0, 1])
def test_png_codec_against_pillow_both_ways(seed):
    """The port's PNGs decode in Pillow to the same pixels, Pillow's PNGs
    decode in the port to the same pixels, for L, LA, RGB and RGBA."""
    for c, img in _images(seed):
        ours = Image.open(io.BytesIO(png.encode_png(img)))
        assert ours.mode == MODES[c]
        np.testing.assert_array_equal(np.asarray(ours).reshape(img.shape), img)
        buf = io.BytesIO()
        Image.fromarray(img[..., 0] if c == 1 else img, MODES[c]).save(buf, format="PNG")
        np.testing.assert_array_equal(png.decode_png(buf.getvalue()), img)


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)])
def test_png_reader_every_row_filter(filters):
    """Files whose rows use each filter (and all five in turn) decode in the
    port and in Pillow to the original pixels."""
    for c, img in _images(len(filters)):
        data = _filtered_png(img, filters)
        np.testing.assert_array_equal(png.decode_png(data), img)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))).reshape(img.shape),
                                      img)


def test_png_palette_and_rgb_conversion(tmp_path):
    """An 8-bit palette PNG decodes to Pillow's RGB; ``read_image_rgb`` is
    Pillow's ``convert("RGB")`` for every mode, and hands a JPEG to Pillow;
    a damaged PNG raises ValueError."""
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 256, (20, 30, 3)).astype(np.uint8)
    pal = Image.fromarray(rgb).quantize(200)
    pal.save(tmp_path / "p.png")
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "p.png")),
                                  np.asarray(pal.convert("RGB")))
    for c, img in _images(3):
        path = str(tmp_path / f"m{c}.png")
        png.write_png(path, img)
        with Image.open(path) as im:
            np.testing.assert_array_equal(png.read_image_rgb(path), np.asarray(im.convert("RGB")))
    Image.fromarray(rgb).save(tmp_path / "j.jpg", quality=95)
    with Image.open(tmp_path / "j.jpg") as im:
        np.testing.assert_array_equal(png.read_image_rgb(str(tmp_path / "j.jpg")),
                                      np.asarray(im.convert("RGB")))
    data = png.encode_png(rgb)
    with pytest.raises(ValueError):
        png.decode_png(data[:-20])
    with pytest.raises(ValueError):
        png.decode_png(data[:40] + bytes([data[40] ^ 1]) + data[41:])


def _boxes(seed, n=9, n_classes=23):
    rng = np.random.default_rng(seed)
    cls = np.eye(n_classes, dtype=np.float32)[rng.integers(0, n_classes, n)]
    return (rng.uniform(-2.5, 2.5, (n, 3)), rng.uniform(0.1, 1.2, (n, 3)),
            rng.uniform(-np.pi, np.pi, (n, 1)), cls)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_box_render_equals_jax(seed):
    """render_topdown with and without a floor mask, radian and cos/sin
    angles, and render_scene_dict on a (1, N, ...) dict: equal pixels."""
    t, s, a, c = _boxes(seed)
    mask = (np.random.default_rng(seed).random((64, 64, 1)) < 0.7).astype(np.float32)
    for kw in ({}, {"floor_mask": mask}, {"image_size": 128, "room_extent": 2.5}):
        np.testing.assert_array_equal(pr.render_topdown(t, s, a, c, **kw),
                                      jr.render_topdown(t, s, a, c, **kw))
    cs = np.concatenate([np.cos(a), np.sin(a)], axis=-1)
    np.testing.assert_array_equal(pr.render_topdown(t, s, cs, c), jr.render_topdown(t, s, cs, c))
    d = {"translations": t[None], "sizes": s[None], "angles": a[None], "class_labels": c[None]}
    np.testing.assert_array_equal(pr.render_scene_dict(d), jr.render_scene_dict(d))
    np.testing.assert_array_equal(pr.class_colors(23), jr.class_colors(23))


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    """Textured boxes from the port's synthetic catalog: each label's
    (vertices, faces, UVs, texture) as both packages load them."""
    root = str(tmp_path_factory.mktemp("catalog"))
    make_synthetic_catalog(root, ["bed", "chair", "lamp"], per_label=2, seed=0)
    return sorted(os.path.join(root, d, "raw_model.obj") for d in os.listdir(root)
                  if os.path.isdir(os.path.join(root, d)))


def _scene(paths, seed, cls, load):
    """Each catalog mesh moved to a random place, as a SceneMesh of ``cls``;
    the first one without its UVs (a flat, kd-coloured mesh)."""
    rng = np.random.default_rng(seed)
    out = []
    for i, p in enumerate(paths):
        m = load(p)
        v = m["vertices"] + rng.uniform(-2, 2, 3) * [1, 0, 1] + [0, rng.uniform(0, 1), 0]
        out.append(cls(vertices=v, faces=m["faces"], label=f"obj{i}",
                       texture_path=m["texture_path"],
                       face_uvs=None if i == 0 else m["face_uvs"],
                       kd=np.array([0.9, 0.2, 0.1], np.float32) if i == 0 else None))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_textured_mesh_renders_equal_jax(catalog, seed):
    """render_meshes_topdown (textured, flat, explicit colours, a palette,
    another background) and render_meshes_perspective (default camera,
    another camera, a non-square window): equal pixels."""
    ours = _scene(catalog, seed, SceneMesh, load_obj_mesh)
    theirs = _scene(catalog, seed, JSceneMesh, j_load_obj_mesh)
    colors = np.random.default_rng(seed).integers(0, 256, (len(ours), 3)).astype(np.uint8)
    palette = {f"obj{i}": colors[i] for i in range(len(ours))}
    for kw in ({}, {"colors": colors}, {"palette": dict(palette), "use_textures": False},
               {"image_size": 96, "room_extent": 2.0, "background": (10, 20, 30)}):
        a = pr.render_meshes_topdown(ours, **kw)
        b = jr.render_meshes_topdown(theirs, **kw)
        np.testing.assert_array_equal(a, b)
    assert (pr.render_meshes_topdown(ours) != 255).any()
    for kw in ({"window_size": (96, 80)},
               {"window_size": (64, 64), "camera_position": (3.0, 4.0, 2.0),
                "up_vector": (0.0, 1.0, 0.0), "colors": colors}):
        np.testing.assert_array_equal(pr.render_meshes_perspective(ours, **kw),
                                      jr.render_meshes_perspective(theirs, **kw))


def test_orbit_frames_equal_jax(catalog, tmp_path):
    """orbit_camera_positions, and render_orbit_frames' PNGs (read back by
    Pillow) equal to the JAX package's."""
    ours = _scene(catalog, 3, SceneMesh, load_obj_mesh)
    theirs = _scene(catalog, 3, JSceneMesh, j_load_obj_mesh)
    np.testing.assert_array_equal(
        pr.orbit_camera_positions((1.0, 2.0, -5.0), (0.0, 0.0, 0.0), 7),
        jr.orbit_camera_positions((1.0, 2.0, -5.0), (0.0, 0.0, 0.0), 7))
    kw = dict(n_frames=3, window_size=(48, 40), camera_position=(0.5, 3.0, -4.0))
    a = pr.render_orbit_frames(ours, str(tmp_path / "port"), **kw)
    b = jr.render_orbit_frames(theirs, str(tmp_path / "jax"), **kw)
    assert [os.path.basename(p) for p in a] == [os.path.basename(p) for p in b] == \
        ["00000.png", "00001.png", "00002.png"]
    for pa, pb in zip(a, b):
        np.testing.assert_array_equal(np.asarray(Image.open(pa)), np.asarray(Image.open(pb)))


def test_render_to_folder_and_save_image(tmp_path):
    """render_to_folder writes the JAX package's PNGs (the same pixels) with
    the port's writer; save_image round-trips through Pillow."""
    scenes = []
    for seed in range(3):
        t, s, a, c = _boxes(seed)
        scenes.append({"translations": t, "sizes": s, "angles": a, "class_labels": c})
    a = pr.render_to_folder(scenes, str(tmp_path / "port"), prefix="r")
    b = jr.render_to_folder(scenes, str(tmp_path / "jax"), prefix="r")
    assert [os.path.basename(p) for p in a] == ["r00000.png", "r00001.png", "r00002.png"]
    for pa, pb in zip(a, b):
        np.testing.assert_array_equal(png.read_png(pa), np.asarray(Image.open(pb)))
    img = np.random.default_rng(0).integers(0, 256, (17, 13, 3)).astype(np.uint8)
    pr.save_image(img, str(tmp_path / "s.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "s.png")), img)


def test_unreadable_texture_is_none_and_label_colour_is_stable(tmp_path):
    """A missing or damaged texture reads as None (the mesh renders flat), as
    in the JAX package; a label's fallback colour comes from zlib.crc32, so
    another PYTHONHASHSEED gives the same colour."""
    (tmp_path / "bad.png").write_bytes(b"\x89PNG\r\n\x1a\nnot really")
    assert pr._read_image(str(tmp_path / "bad.png")) is None
    assert pr._read_image(str(tmp_path / "missing.png")) is None
    code = ("from diffuscene_tpu_torch.eval.render import _label_color; "
            "print(_label_color('wardrobe', {}).tolist(), hash('wardrobe'))")
    env = dict(os.environ, PYTHONHASHSEED="1")
    colour, salted = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                                    text=True, check=True).stdout.strip().rsplit(" ", 1)
    assert int(salted) != hash("wardrobe")            # another salt than this process's
    assert colour == str(pr._label_color("wardrobe", {}).tolist())
