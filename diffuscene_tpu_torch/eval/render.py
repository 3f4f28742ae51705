"""Scene rendering on the host: the oriented-box rasterizer, the textured
z-buffered top-down mesh rasterizer, the perspective and orbit renders.

Copy of ``diffuscene_tpu/eval/render.py`` (reference
``scripts/utils.py:220-239``, ``render_scene_from_bbox_params:460-556``),
numpy only, with two departures:

- images are written and textures read through the port's PNG codec
  (``eval/png.py``); the card's machine has no Pillow, which is tried only
  for a texture the codec does not decode, and an unreadable texture gives
  ``None`` as in the JAX package;
- the fallback colour of a label with no palette entry is seeded from
  ``zlib.crc32`` of the label, where the JAX package uses Python's
  ``hash``, which is salted per process (PYTHONHASHSEED), so its fallback
  colours change from run to run.

- ``render_topdown``: orthographic oriented-box footprints over the floor
  mask, 256x256 like the reference's FID inputs;
- ``render_meshes_topdown``: orthographic z-buffered mesh rasterizer with
  barycentric UV texture sampling and MTL diffuse maps;
- ``render_meshes_perspective`` / ``orbit_camera_positions`` /
  ``render_orbit_frames``: pinhole camera with perspective-correct UVs and
  headlight shading (the reference's ``--camera_position``,
  ``--up_vector`` and ``--with_rotating_camera``).
"""
from __future__ import annotations

import colorsys
import os
import zlib
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np

from .png import read_image_rgb, write_png


def class_colors(n: int) -> np.ndarray:
    """Deterministic class palette, (n, 3) uint8 (hls wheel, like the
    reference's seaborn color_palette('hls', n))."""
    cols = [colorsys.hls_to_rgb(i / max(n, 1), 0.6, 0.65) for i in range(n)]
    return (np.asarray(cols) * 255).astype(np.uint8)


def _rot_y(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s], [s, c]], np.float64)


def render_topdown(
    translations: np.ndarray,  # (N, 3) world units
    sizes: np.ndarray,  # (N, 3) half-extents
    angles: np.ndarray,  # (N, 1) radians (or (N, 2) cos/sin)
    class_labels: np.ndarray,  # (N, C) probabilities/one-hot
    image_size: int = 256,
    room_extent: float = 3.1,
    floor_mask: Optional[np.ndarray] = None,
    palette: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Rasterize a scene top-down (x -> u, z -> v).  Returns (S, S, 3) uint8.

    Objects are painted back-to-front by height (y + y-size), so taller
    objects overdraw — a reasonable approximation of the reference's
    orthographic camera looking straight down.
    """
    n = len(translations)
    img = np.zeros((image_size, image_size, 3), np.uint8)
    if floor_mask is not None:
        m = floor_mask
        if m.ndim == 3:
            m = m[..., 0] if m.shape[-1] in (1, 3) else m[0]
        mask_img = np.kron(m > 0.5, np.ones(
            (image_size // m.shape[0] or 1, image_size // m.shape[1] or 1)))
        mask_img = mask_img[:image_size, :image_size]
        img[mask_img > 0] = (230, 230, 230)
    else:
        img[:] = (230, 230, 230)

    if n == 0:
        return img

    pal = palette if palette is not None else class_colors(class_labels.shape[-1])
    angles = np.asarray(angles)
    if angles.shape[-1] == 2:  # cos/sin encoding
        theta = np.arctan2(angles[:, 1], angles[:, 0])
    else:
        theta = angles[:, 0]

    scale = image_size / (2 * room_extent)
    order = np.argsort(np.asarray(translations)[:, 1] + np.asarray(sizes)[:, 1])
    yy, xx = np.mgrid[0:image_size, 0:image_size]
    # pixel centers in world coords
    wx = (xx + 0.5) / scale - room_extent
    wz = (yy + 0.5) / scale - room_extent

    for i in order:
        cx, _, cz = np.asarray(translations[i], np.float64)
        sx, _, sz = np.asarray(sizes[i], np.float64)
        R = _rot_y(theta[i])
        # transform pixel grid into the box frame
        dx = wx - cx
        dz = wz - cz
        lx = R[0, 0] * dx + R[1, 0] * dz
        lz = R[0, 1] * dx + R[1, 1] * dz
        inside = (np.abs(lx) <= sx) & (np.abs(lz) <= sz)
        img[inside] = pal[int(np.argmax(class_labels[i]))]
    return img


def _label_color(label: str, palette: Dict[str, np.ndarray]) -> np.ndarray:
    if label not in palette:
        # deterministic fallback color from the label text
        h = (zlib.crc32(label.encode()) % 997) / 997.0
        palette[label] = (np.asarray(colorsys.hls_to_rgb(h, 0.6, 0.65)) * 255
                          ).astype(np.uint8)
    return palette[label]


def _read_image(path: str) -> Optional[np.ndarray]:
    try:
        return read_image_rgb(path).astype(np.float32)
    except (OSError, ValueError, ImportError, SyntaxError):   # as the JAX package: None
        return None


# decoded textures persist across render calls (a generate run renders
# hundreds of scenes that reuse the same catalog texture files); LRU-bounded
# and keyed by (path, mtime) so edited files are picked up
_TEXTURE_CACHE: "OrderedDict[tuple, Optional[np.ndarray]]" = OrderedDict()
_TEXTURE_CACHE_MAX = 64


def _load_texture(path: str,
                  cache: Optional[Dict[str, Optional[np.ndarray]]] = None):
    """(H, W, 3) float32 RGB image, memoized; None if unreadable.

    With ``cache`` (a per-call dict) entries are keyed by path; otherwise a
    bounded module-level cache keyed by (path, mtime) is used.
    """
    if path is None:
        return None
    if cache is not None:
        if path not in cache:
            cache[path] = _read_image(path)
        return cache[path]
    try:
        key = (path, os.path.getmtime(path))
    except OSError:
        return None
    if key in _TEXTURE_CACHE:
        _TEXTURE_CACHE.move_to_end(key)
        return _TEXTURE_CACHE[key]
    img = _read_image(path)
    _TEXTURE_CACHE[key] = img
    while len(_TEXTURE_CACHE) > _TEXTURE_CACHE_MAX:
        _TEXTURE_CACHE.popitem(last=False)
    return img


def render_meshes_topdown(
    meshes,  # Sequence[SceneMesh] (eval/retrieval.py) in world units
    image_size: int = 256,
    room_extent: float = 3.1,
    colors: Optional[np.ndarray] = None,  # (len(meshes), 3) uint8 overrides
    palette: Optional[Dict[str, np.ndarray]] = None,  # label -> RGB
    background: tuple = (255, 255, 255),
    use_textures: bool = True,
    tex_cache: Optional[Dict[str, Optional[np.ndarray]]] = None,
) -> np.ndarray:
    """Rasterize retrieved scene meshes top-down orthographically.

    The reference renders the retrieved 3D-FUTURE meshes with an orthographic
    top-down camera (scripts/generate_diffusion.py:251-264, scripts/
    utils.py:220-239); this is the dependency-free numpy equivalent: x -> u,
    z -> v projection, per-pixel z-buffer on world y (height), flat lambert
    shading from the face normal.  When a mesh carries ``face_uvs`` + a
    readable ``texture_path`` (and ``use_textures``), the diffuse texture is
    sampled per pixel by barycentric UV interpolation (nearest texel, OBJ
    bottom-left origin, wrap) — the reference's textured-mesh rendering
    (scene_synthesis/utils.py:10-77, scripts/utils.py:220-239).  Faces with
    NaN UVs, and multi-material faces whose own material has no readable
    map, fall back to a flat color (colors override > their MTL Kd > label
    palette); multi-material meshes (``face_materials``/``materials``)
    sample each ``usemtl`` group's own diffuse map.  Decoded textures are
    memoized across calls (pass ``tex_cache`` to scope the memo to a call).
    Returns (S, S, 3) uint8.
    """
    img = np.empty((image_size, image_size, 3), np.float32)
    img[:] = background
    zbuf = np.full((image_size, image_size), -np.inf, np.float32)
    scale = image_size / (2.0 * room_extent)
    palette = palette if palette is not None else {}

    for mi, mesh in enumerate(meshes):
        verts = np.asarray(mesh.vertices, np.float64)
        faces = np.asarray(mesh.faces, np.int64)
        if len(faces) == 0 or len(verts) == 0:
            continue
        if colors is not None:
            base = np.asarray(colors[mi], np.float32)
        elif getattr(mesh, "kd", None) is not None:
            base = np.asarray(mesh.kd, np.float32) * 255.0
        else:
            base = _label_color(getattr(mesh, "label", "object"), palette
                                ).astype(np.float32)
        # material slots: slot 0 = mesh-level primary; per-usemtl slots
        # follow, indexed by face_materials + 1
        face_uvs = (np.asarray(mesh.face_uvs, np.float64)
                    if getattr(mesh, "face_uvs", None) is not None else None)
        slot_tex = [_load_texture(getattr(mesh, "texture_path", None),
                                  tex_cache) if use_textures else None]
        slot_base = [base]
        face_slot = None
        mats = getattr(mesh, "materials", None)
        face_mats = getattr(mesh, "face_materials", None)
        if mats is not None and face_mats is not None:
            for m in mats:
                slot_tex.append(_load_texture(m.get("map_kd"), tex_cache)
                                if use_textures else None)
                slot_base.append(np.asarray(m["kd"], np.float32) * 255.0
                                 if m.get("kd") is not None and colors is None
                                 else base)
            face_slot = np.asarray(face_mats, np.int64) + 1
        if face_uvs is None or not any(t is not None for t in slot_tex):
            face_uvs = None  # nothing to sample
        # pixel coords: consistent with render_topdown's pixel-center mapping
        u = (verts[:, 0] + room_extent) * scale - 0.5
        v = (verts[:, 2] + room_extent) * scale - 0.5
        y = verts[:, 1]
        tri_u, tri_v, tri_y = u[faces], v[faces], y[faces]  # (F, 3)

        # flat lambert shading from the (unnormalized) face normal's y part
        e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
        e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
        nrm = np.cross(e1, e2)
        nlen = np.linalg.norm(nrm, axis=1)
        ny = np.abs(nrm[:, 1]) / np.maximum(nlen, 1e-12)
        shade = 0.35 + 0.65 * ny  # (F,)

        lo_u = np.maximum(np.floor(tri_u.min(1)).astype(int), 0)
        hi_u = np.minimum(np.ceil(tri_u.max(1)).astype(int), image_size - 1)
        lo_v = np.maximum(np.floor(tri_v.min(1)).astype(int), 0)
        hi_v = np.minimum(np.ceil(tri_v.max(1)).astype(int), image_size - 1)
        # twice the signed area; degenerate or fully-clipped triangles skipped
        area = ((tri_u[:, 1] - tri_u[:, 0]) * (tri_v[:, 2] - tri_v[:, 0])
                - (tri_u[:, 2] - tri_u[:, 0]) * (tri_v[:, 1] - tri_v[:, 0]))
        ok = (np.abs(area) > 1e-12) & (hi_u >= lo_u) & (hi_v >= lo_v)

        for fi in np.nonzero(ok)[0]:
            uu = np.arange(lo_u[fi], hi_u[fi] + 1)
            vv = np.arange(lo_v[fi], hi_v[fi] + 1)
            pu = uu[None, :].astype(np.float64)  # columns
            pv = vv[:, None].astype(np.float64)  # rows
            u0, u1, u2 = tri_u[fi]
            v0, v1, v2 = tri_v[fi]
            inv = 1.0 / area[fi]
            w0 = ((u1 - pu) * (v2 - pv) - (u2 - pu) * (v1 - pv)) * inv
            w1 = ((u2 - pu) * (v0 - pv) - (u0 - pu) * (v2 - pv)) * inv
            w2 = 1.0 - w0 - w1
            inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
            if not inside.any():
                continue
            py = w0 * tri_y[fi, 0] + w1 * tri_y[fi, 1] + w2 * tri_y[fi, 2]
            sub = zbuf[lo_v[fi]:hi_v[fi] + 1, lo_u[fi]:hi_u[fi] + 1]
            win = inside & (py > sub)
            if not win.any():
                continue
            sub[win] = py[win]
            si = int(face_slot[fi]) if face_slot is not None else 0
            si = si if 0 <= si < len(slot_tex) else 0
            tex = slot_tex[si]
            fuv = face_uvs[fi] if face_uvs is not None else None
            if tex is not None and fuv is not None and np.isfinite(fuv).all():
                # barycentric UV interpolation at the winning pixels, then
                # nearest-texel lookup (vt origin is bottom-left; wrap)
                tu = (w0 * fuv[0, 0] + w1 * fuv[1, 0] + w2 * fuv[2, 0])[win]
                tv = (w0 * fuv[0, 1] + w1 * fuv[1, 1] + w2 * fuv[2, 1])[win]
                tu = tu - np.floor(tu)
                tv = tv - np.floor(tv)
                th, tw = tex.shape[:2]
                px = np.minimum((tu * tw).astype(np.int64), tw - 1)
                pyi = np.minimum(((1.0 - tv) * th).astype(np.int64), th - 1)
                color = tex[pyi, px]
            else:
                color = slot_base[si]
            img[lo_v[fi]:hi_v[fi] + 1, lo_u[fi]:hi_u[fi] + 1][win] = (
                color * shade[fi])
    return np.clip(img, 0, 255).astype(np.uint8)


def render_scene_dict(boxes: Dict[str, np.ndarray], image_size: int = 256,
                      room_extent: float = 3.1,
                      floor_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Render a post-processed per-scene attribute dict (see
    eval/postprocess.py).  Accepts (N, ...) or (1, N, ...) leading shapes."""
    sq = lambda a: np.asarray(a)[0] if np.asarray(a).ndim == 3 else np.asarray(a)
    return render_topdown(
        sq(boxes["translations"]), sq(boxes["sizes"]), sq(boxes["angles"]),
        sq(boxes["class_labels"]), image_size=image_size,
        room_extent=room_extent, floor_mask=floor_mask,
    )


def save_image(img: np.ndarray, path: str):
    write_png(path, np.asarray(img, np.uint8))


def render_scene_from_bbox_params(boxes: Dict[str, np.ndarray], path: str,
                                  image_size: int = 256, room_extent: float = 3.1,
                                  floor_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Render one scene's bbox params to a PNG and return the image.

    Named for parity with the reference `render_scene_from_bbox_params`
    (scripts/utils.py:460-556); this rasterizes oriented footprints instead
    of retrieved textured meshes (see module docstring).
    """
    img = render_scene_dict(boxes, image_size=image_size,
                            room_extent=room_extent, floor_mask=floor_mask)
    save_image(img, path)
    return img


def render_to_folder(boxes_list, output_directory: str, prefix: str = "",
                     image_size: int = 256, room_extent: float = 3.1):
    """Render a list of per-scene bbox dicts into a folder of PNGs.

    Equivalent of the reference `render_to_folder` (scripts/utils.py:361-457)
    minus the mesh/texture machinery.  Returns the written paths.
    """
    os.makedirs(output_directory, exist_ok=True)
    paths = []
    for i, boxes in enumerate(boxes_list):
        p = os.path.join(output_directory, f"{prefix}{i:05d}.png")
        render_scene_from_bbox_params(boxes, p, image_size=image_size,
                                      room_extent=room_extent)
        paths.append(p)
    return paths

# --------------------------------------------------------------------------
# Perspective / orbit rendering (the reference's qualitative-viz camera
# surface: scripts/generate_diffusion.py:82-127 --up_vector/--camera_position/
# --camera_target/--window_size/--with_rotating_camera/--save_frames/
# --n_frames, rendered there with simple_3dviz; here a numpy perspective
# rasterizer with the same texture/material handling as the top-down path).


def _look_at(camera_position, camera_target, up_vector):
    """Row-major world->camera rotation + eye, OpenGL-style (camera looks
    down -z).  Returns (R (3,3), eye (3,))."""
    eye = np.asarray(camera_position, np.float64)
    fwd = np.asarray(camera_target, np.float64) - eye
    n = np.linalg.norm(fwd)
    fwd = fwd / (n if n > 1e-12 else 1.0)
    up = np.asarray(up_vector, np.float64)
    right = np.cross(fwd, up)
    n = np.linalg.norm(right)
    if n < 1e-12:  # up parallel to view direction: pick any perpendicular
        up = np.array([0.0, 0.0, 1.0]) if abs(fwd[1]) > 0.9 else np.array([0.0, 1.0, 0.0])
        right = np.cross(fwd, up)
        n = np.linalg.norm(right)
    right = right / n
    true_up = np.cross(right, fwd)
    R = np.stack([right, true_up, -fwd])  # rows: camera x, y, z axes
    return R, eye


def render_meshes_perspective(
    meshes,  # Sequence[SceneMesh] in world units
    camera_position=(-0.10923499, 1.9325259, -7.19009),
    camera_target=(0.0, 0.0, 0.0),
    up_vector=(0.0, 1.0, 0.0),
    window_size=(512, 512),
    fov_degrees: float = 45.0,
    near: float = 0.1,
    colors: Optional[np.ndarray] = None,
    palette: Optional[Dict[str, np.ndarray]] = None,
    background: tuple = (255, 255, 255),
    use_textures: bool = True,
    tex_cache: Optional[Dict[str, Optional[np.ndarray]]] = None,
) -> np.ndarray:
    """Rasterize scene meshes with a perspective pinhole camera.

    Camera defaults mirror the reference CLI defaults
    (generate_diffusion.py:88-110).  Per-pixel z-buffer on camera depth,
    perspective-correct barycentric texture sampling, headlight lambert
    shading (light at the camera, like the reference's ``scene.light =
    camera_position``).  Faces with any vertex nearer than ``near`` are
    skipped (no polygon clipping — cameras sit outside the furniture).
    Returns (H, W, 3) uint8.
    """
    W, H = int(window_size[0]), int(window_size[1])
    img = np.empty((H, W, 3), np.float32)
    img[:] = background
    zbuf = np.full((H, W), np.inf, np.float32)  # camera depth, closer wins
    palette = palette if palette is not None else {}
    R, eye = _look_at(camera_position, camera_target, up_vector)
    f = (H / 2.0) / np.tan(np.radians(fov_degrees) / 2.0)
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0

    for mi, mesh in enumerate(meshes):
        verts = np.asarray(mesh.vertices, np.float64)
        faces = np.asarray(mesh.faces, np.int64)
        if len(faces) == 0 or len(verts) == 0:
            continue
        if colors is not None:
            base = np.asarray(colors[mi], np.float32)
        elif getattr(mesh, "kd", None) is not None:
            base = np.asarray(mesh.kd, np.float32) * 255.0
        else:
            base = _label_color(getattr(mesh, "label", "object"), palette
                                ).astype(np.float32)
        face_uvs = (np.asarray(mesh.face_uvs, np.float64)
                    if getattr(mesh, "face_uvs", None) is not None else None)
        slot_tex = [_load_texture(getattr(mesh, "texture_path", None),
                                  tex_cache) if use_textures else None]
        slot_base = [base]
        face_slot = None
        mats = getattr(mesh, "materials", None)
        face_mats = getattr(mesh, "face_materials", None)
        if mats is not None and face_mats is not None:
            for m in mats:
                slot_tex.append(_load_texture(m.get("map_kd"), tex_cache)
                                if use_textures else None)
                slot_base.append(np.asarray(m["kd"], np.float32) * 255.0
                                 if m.get("kd") is not None and colors is None
                                 else base)
            face_slot = np.asarray(face_mats, np.int64) + 1
        if face_uvs is None or not any(t is not None for t in slot_tex):
            face_uvs = None

        vc = (verts - eye) @ R.T  # camera space; depth = -vc[:, 2]
        depth = -vc[:, 2]
        u = f * vc[:, 0] / np.maximum(depth, 1e-9) + cx
        v = -f * vc[:, 1] / np.maximum(depth, 1e-9) + cy
        tri_u, tri_v, tri_d = u[faces], v[faces], depth[faces]

        # headlight shading: |cos| between face normal and the eye ray
        e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
        e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
        nrm = np.cross(e1, e2)
        nlen = np.linalg.norm(nrm, axis=1)
        to_eye = eye[None, :] - verts[faces[:, 0]]
        elen = np.linalg.norm(to_eye, axis=1)
        cosang = np.abs(np.einsum("fi,fi->f", nrm, to_eye)) / np.maximum(
            nlen * elen, 1e-12)
        shade = 0.35 + 0.65 * cosang  # (F,)

        lo_u = np.maximum(np.floor(tri_u.min(1)).astype(int), 0)
        hi_u = np.minimum(np.ceil(tri_u.max(1)).astype(int), W - 1)
        lo_v = np.maximum(np.floor(tri_v.min(1)).astype(int), 0)
        hi_v = np.minimum(np.ceil(tri_v.max(1)).astype(int), H - 1)
        area = ((tri_u[:, 1] - tri_u[:, 0]) * (tri_v[:, 2] - tri_v[:, 0])
                - (tri_u[:, 2] - tri_u[:, 0]) * (tri_v[:, 1] - tri_v[:, 0]))
        ok = ((np.abs(area) > 1e-12) & (hi_u >= lo_u) & (hi_v >= lo_v)
              & (tri_d > near).all(1))

        inv_d = 1.0 / np.maximum(tri_d, 1e-9)  # (F, 3) for persp-correct interp
        for fi in np.nonzero(ok)[0]:
            uu = np.arange(lo_u[fi], hi_u[fi] + 1)
            vv = np.arange(lo_v[fi], hi_v[fi] + 1)
            pu = uu[None, :].astype(np.float64)
            pv = vv[:, None].astype(np.float64)
            u0, u1, u2 = tri_u[fi]
            v0, v1, v2 = tri_v[fi]
            inv = 1.0 / area[fi]
            w0 = ((u1 - pu) * (v2 - pv) - (u2 - pu) * (v1 - pv)) * inv
            w1 = ((u2 - pu) * (v0 - pv) - (u0 - pu) * (v2 - pv)) * inv
            w2 = 1.0 - w0 - w1
            inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
            if not inside.any():
                continue
            # perspective-correct depth: interpolate 1/d linearly in screen
            pinv = w0 * inv_d[fi, 0] + w1 * inv_d[fi, 1] + w2 * inv_d[fi, 2]
            pd = 1.0 / np.maximum(pinv, 1e-12)
            sub = zbuf[lo_v[fi]:hi_v[fi] + 1, lo_u[fi]:hi_u[fi] + 1]
            win = inside & (pd < sub)
            if not win.any():
                continue
            sub[win] = pd[win]
            si = int(face_slot[fi]) if face_slot is not None else 0
            si = si if 0 <= si < len(slot_tex) else 0
            tex = slot_tex[si]
            fuv = face_uvs[fi] if face_uvs is not None else None
            if tex is not None and fuv is not None and np.isfinite(fuv).all():
                # perspective-correct UV: interpolate uv/d and renormalize
                c0 = (w0 * inv_d[fi, 0])[win]
                c1 = (w1 * inv_d[fi, 1])[win]
                c2 = (w2 * inv_d[fi, 2])[win]
                norm = np.maximum(c0 + c1 + c2, 1e-12)
                tu = (c0 * fuv[0, 0] + c1 * fuv[1, 0] + c2 * fuv[2, 0]) / norm
                tv = (c0 * fuv[0, 1] + c1 * fuv[1, 1] + c2 * fuv[2, 1]) / norm
                tu = tu - np.floor(tu)
                tv = tv - np.floor(tv)
                th, tw = tex.shape[:2]
                px = np.minimum((tu * tw).astype(np.int64), tw - 1)
                pyi = np.minimum(((1.0 - tv) * th).astype(np.int64), th - 1)
                color = tex[pyi, px]
            else:
                color = slot_base[si]
            img[lo_v[fi]:hi_v[fi] + 1, lo_u[fi]:hi_u[fi] + 1][win] = (
                color * shade[fi])
    return np.clip(img, 0, 255).astype(np.uint8)


def orbit_camera_positions(camera_position, camera_target, n_frames: int,
                           up_vector=(0.0, 1.0, 0.0)) -> np.ndarray:
    """(n_frames, 3) camera positions circling ``camera_target`` about the
    up axis, starting at ``camera_position`` — the reference's rotating
    camera (generate_diffusion.py:104-127 CameraTrajectory Circle, 360
    frames by default)."""
    eye = np.asarray(camera_position, np.float64)
    target = np.asarray(camera_target, np.float64)
    up = np.asarray(up_vector, np.float64)
    up = up / np.maximum(np.linalg.norm(up), 1e-12)
    rel = eye - target
    out = []
    for k in range(int(n_frames)):
        a = 2.0 * np.pi * k / max(int(n_frames), 1)
        c, s = np.cos(a), np.sin(a)
        # Rodrigues rotation of rel about `up`
        r = (rel * c + np.cross(up, rel) * s + up * np.dot(up, rel) * (1 - c))
        out.append(target + r)
    return np.stack(out)


def render_orbit_frames(meshes, out_dir: str, prefix: str = "",
                        camera_position=(-0.10923499, 1.9325259, -7.19009),
                        camera_target=(0.0, 0.0, 0.0),
                        up_vector=(0.0, 1.0, 0.0),
                        window_size=(512, 512), n_frames: int = 360,
                        **kwargs) -> list:
    """Write ``n_frames`` orbit frames of one scene to ``out_dir``
    (reference --with_rotating_camera + --save_frames + --n_frames,
    generate_diffusion.py:104-127).  Returns the written paths."""
    os.makedirs(out_dir, exist_ok=True)
    tex_cache: Dict[str, Optional[np.ndarray]] = {}
    paths = []
    for k, pos in enumerate(orbit_camera_positions(
            camera_position, camera_target, n_frames, up_vector)):
        img = render_meshes_perspective(
            meshes, camera_position=pos, camera_target=camera_target,
            up_vector=up_vector, window_size=window_size,
            tex_cache=tex_cache, **kwargs)
        p = os.path.join(out_dir, f"{prefix}{k:05d}.png")
        save_image(img, p)
        paths.append(p)
    return paths
