"""Exact mesh-mesh surface intersection (Möller triangle-triangle test).

Copy of ``diffuscene_tpu/eval/mesh_intersect.py``, numpy on the host: the
replacement for the reference's pyvista boolean
surface-intersection backend behind ``computer_intersection``'s
``judge_mesh_intersec`` branch (reference `scripts/utils.py:686-691`):
two retrieved furniture meshes "intersect" when their triangle surfaces
cross, which is exactly when at least one triangle pair intersects.  (Like
pyvista's ``s1.intersection(s2)``, a mesh floating strictly *inside* another
does not register — there is no surface crossing.)

The pair test is Möller's interval method ("A Fast Triangle-Triangle
Intersection Test", JGT 1997), vectorized over candidate pairs with numpy and
pre-filtered by per-triangle AABB overlap, so catalog meshes with thousands
of faces stay cheap.  Touching (shared point/edge/face, zero penetration)
counts as intersecting: the projected intervals are treated as closed.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np

__all__ = ["tri_tri_intersect", "mesh_pair_intersects", "make_pair_intersects"]

_EPS = 1e-12


def _interval_on_line(proj, dv):
    """Per-pair intersection interval of one triangle with the other's plane.

    ``proj`` (P, 3): triangle vertices projected onto the intersection line;
    ``dv`` (P, 3): signed distances of those vertices to the other plane
    (not all of one strict sign — callers pre-filter).  Returns (lo, hi)
    arrays (P,).  Vertex k is the one isolated on its side of the plane; the
    two edges (k,i), (k,j) cross the plane at the interval endpoints.
    """
    d0, d1, d2 = dv[:, 0], dv[:, 1], dv[:, 2]
    # Möller's case split: find the isolated vertex (strictly opposite sign,
    # or the only nonzero one when the others sit in the plane)
    k = np.where(
        d0 * d1 > 0, 2,
        np.where(
            d0 * d2 > 0, 1,
            np.where(
                (d1 * d2 > 0) | (d0 != 0), 0,
                np.where(d1 != 0, 1, 2))))
    rows = np.arange(len(dv))
    i = (k + 1) % 3
    j = (k + 2) % 3
    dk, di, dj = dv[rows, k], dv[rows, i], dv[rows, j]
    pk, pi, pj = proj[rows, k], proj[rows, i], proj[rows, j]
    # edge (i,k) and (j,k) plane crossings; denominators are nonzero by the
    # case split (di/dj never share dk's strict sign); guard anyway for the
    # fully-degenerate dv==0 rows a coplanar caller may pass
    den_i = np.where(np.abs(di - dk) < _EPS, 1.0, di - dk)
    den_j = np.where(np.abs(dj - dk) < _EPS, 1.0, dj - dk)
    t1 = pi + (pk - pi) * (di / den_i)
    t2 = pj + (pk - pj) * (dj / den_j)
    return np.minimum(t1, t2), np.maximum(t1, t2)


def _orient2d(a, b, c):
    """Twice the signed area of 2-D triangle (a, b, c); shapes broadcast."""
    return ((b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1])
            - (b[..., 1] - a[..., 1]) * (c[..., 0] - a[..., 0]))


def _segments_cross_2d(p1, p2, q1, q2):
    """Closed-segment intersection test, (P, 2) arrays -> (P,) bool."""
    d1 = _orient2d(q1, q2, p1)
    d2 = _orient2d(q1, q2, p2)
    d3 = _orient2d(p1, p2, q1)
    d4 = _orient2d(p1, p2, q2)
    proper = (d1 * d2 < 0) & (d3 * d4 < 0)

    def on_seg(a, b, c, d):
        # collinear c on segment (a, b)
        return (np.abs(d) < _EPS) \
            & (np.minimum(a[..., 0], b[..., 0]) - _EPS <= c[..., 0]) \
            & (c[..., 0] <= np.maximum(a[..., 0], b[..., 0]) + _EPS) \
            & (np.minimum(a[..., 1], b[..., 1]) - _EPS <= c[..., 1]) \
            & (c[..., 1] <= np.maximum(a[..., 1], b[..., 1]) + _EPS)

    touch = (on_seg(q1, q2, p1, d1) | on_seg(q1, q2, p2, d2)
             | on_seg(p1, p2, q1, d3) | on_seg(p1, p2, q2, d4))
    return proper | touch


def _point_in_tri_2d(p, tri):
    """(P, 2) points inside/on (P, 3, 2) triangles (orientation-agnostic)."""
    s0 = _orient2d(tri[:, 0], tri[:, 1], p)
    s1 = _orient2d(tri[:, 1], tri[:, 2], p)
    s2 = _orient2d(tri[:, 2], tri[:, 0], p)
    return ((s0 >= -_EPS) & (s1 >= -_EPS) & (s2 >= -_EPS)) \
        | ((s0 <= _EPS) & (s1 <= _EPS) & (s2 <= _EPS))


def _coplanar_intersect(t1, t2, n1):
    """2-D overlap test for coplanar triangle pairs (Möller §4).

    ``t1``/``t2`` (P, 3, 3), ``n1`` (P, 3) the shared plane normal.  Project
    onto the dominant-axis plane, then: any edge pair crosses, or one
    triangle's vertex lies inside the other.
    """
    drop = np.abs(n1).argmax(-1)  # (P,)
    keep = np.stack([(drop + 1) % 3, (drop + 2) % 3], axis=-1)  # (P, 2)
    rows = np.arange(len(t1))[:, None, None]
    a = t1[rows, np.arange(3)[None, :, None], keep[:, None, :]]  # (P, 3, 2)
    b = t2[rows, np.arange(3)[None, :, None], keep[:, None, :]]
    hit = np.zeros(len(t1), bool)
    for i in range(3):
        for j in range(3):
            hit |= _segments_cross_2d(a[:, i], a[:, (i + 1) % 3],
                                      b[:, j], b[:, (j + 1) % 3])
    hit |= _point_in_tri_2d(a[:, 0], b)
    hit |= _point_in_tri_2d(b[:, 0], a)
    return hit


def tri_tri_intersect(tri_a: np.ndarray, tri_b: np.ndarray,
                      eps: float = 1e-9) -> np.ndarray:
    """Vectorized Möller triangle-triangle intersection.

    ``tri_a``/``tri_b`` are (P, 3, 3) float arrays (P pairs of triangles,
    3 vertices each, xyz).  Returns (P,) bool — True where the closed
    triangles intersect (touching counts).  Degenerate (zero-area) triangles
    are handled by the coplanar branch when applicable, else report False.
    """
    a = np.asarray(tri_a, np.float64)
    b = np.asarray(tri_b, np.float64)
    if a.ndim == 2:
        a, b = a[None], b[None]
    P = len(a)
    out = np.zeros(P, bool)

    n1 = np.cross(a[:, 1] - a[:, 0], a[:, 2] - a[:, 0])  # plane of A
    d1 = -np.einsum("pi,pi->p", n1, a[:, 0])
    dv_b = np.einsum("pi,pji->pj", n1, b) + d1[:, None]  # (P, 3)
    dv_b = np.where(np.abs(dv_b) < eps, 0.0, dv_b)

    n2 = np.cross(b[:, 1] - b[:, 0], b[:, 2] - b[:, 0])
    d2 = -np.einsum("pi,pi->p", n2, b[:, 0])
    dv_a = np.einsum("pi,pji->pj", n2, a) + d2[:, None]
    dv_a = np.where(np.abs(dv_a) < eps, 0.0, dv_a)

    # all of B strictly one side of A's plane (or vice versa) -> no hit
    sep = ((dv_b > 0).all(-1) | (dv_b < 0).all(-1)
           | (dv_a > 0).all(-1) | (dv_a < 0).all(-1))
    coplanar = (dv_a == 0).all(-1) & (dv_b == 0).all(-1)
    general = ~sep & ~coplanar
    if general.any():
        ga, gb = a[general], b[general]
        gdv_a, gdv_b = dv_a[general], dv_b[general]
        line = np.cross(n1[general], n2[general])
        axis = np.abs(line).argmax(-1)
        rows = np.arange(len(ga))
        pa = ga[rows[:, None], np.arange(3)[None, :], axis[:, None]]  # (G, 3)
        pb = gb[rows[:, None], np.arange(3)[None, :], axis[:, None]]
        lo_a, hi_a = _interval_on_line(pa, gdv_a)
        lo_b, hi_b = _interval_on_line(pb, gdv_b)
        out[general] = (lo_a <= hi_b + eps) & (lo_b <= hi_a + eps)
    if coplanar.any():
        # use whichever normal is non-degenerate for the projection
        n = n1[coplanar]
        alt = n2[coplanar]
        use_alt = (np.abs(n).sum(-1) < eps)[:, None]
        n = np.where(use_alt, alt, n)
        out[coplanar] = _coplanar_intersect(a[coplanar], b[coplanar], n)
    return out


def _tri_array(mesh) -> np.ndarray:
    """(F, 3, 3) triangle array from a SceneMesh / (vertices, faces) pair /
    dict with 'vertices' and 'faces'."""
    if hasattr(mesh, "vertices"):
        v, f = mesh.vertices, mesh.faces
    elif isinstance(mesh, dict):
        v, f = mesh["vertices"], mesh["faces"]
    else:
        v, f = mesh
    v = np.asarray(v, np.float64)
    f = np.asarray(f, np.int64).reshape(-1, 3)
    return v[f]


def mesh_pair_intersects(mesh_a, mesh_b, eps: float = 1e-9,
                         chunk: int = 262144) -> bool:
    """True when the surfaces of two triangle meshes cross.

    Accepts SceneMesh objects, (vertices, faces) tuples, or dicts.  A
    per-triangle AABB broadcast filter keeps the Möller test to plausibly
    overlapping pairs; candidate pairs are evaluated in ``chunk``-sized
    blocks to bound memory.  Mirrors the reference's
    ``pv.wrap(m1).intersection(pv.wrap(m2))`` non-empty check
    (scripts/utils.py:686-691).
    """
    ta = _tri_array(mesh_a)
    tb = _tri_array(mesh_b)
    if len(ta) == 0 or len(tb) == 0:
        return False
    lo_a, hi_a = ta.min(1), ta.max(1)  # (Fa, 3)
    lo_b, hi_b = tb.min(1), tb.max(1)
    # whole-mesh reject first
    if (lo_a.min(0) > hi_b.max(0) + eps).any() or (lo_b.min(0) > hi_a.max(0) + eps).any():
        return False
    overlap = ((lo_a[:, None] <= hi_b[None] + eps)
               & (lo_b[None] <= hi_a[:, None] + eps)).all(-1)  # (Fa, Fb)
    ia, ib = np.nonzero(overlap)
    for s in range(0, len(ia), chunk):
        sel_a = ta[ia[s:s + chunk]]
        sel_b = tb[ib[s:s + chunk]]
        if tri_tri_intersect(sel_a, sel_b, eps=eps).any():
            return True
    return False


def make_pair_intersects(meshes: Sequence) -> Callable[[int, int], bool]:
    """``pair_intersects(i, j)`` callable over a retrieved mesh list, for
    ``eval.metrics.compute_intersection`` — the exact-mesh backend of the
    reference's ``judge_mesh_intersec=True`` branch (scripts/utils.py:686-691).
    Results are memoized per unordered pair."""
    cache: dict[Tuple[int, int], bool] = {}

    def pair_intersects(i: int, j: int) -> bool:
        key = (min(i, j), max(i, j))
        if key not in cache:
            cache[key] = mesh_pair_intersects(meshes[key[0]], meshes[key[1]])
        return cache[key]

    return pair_intersects
