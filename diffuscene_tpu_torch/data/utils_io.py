"""Point-cloud PLY I/O (dependency-free; replaces plyfile).

Copy of ``diffuscene_tpu/data/utils_io.py`` (reference
``scene_synthesis/datasets/utils_io.py:1-21``), so the port does not import
the JAX package: ASCII or binary little-endian PLY with float32 x/y/z
vertex properties.
"""
from __future__ import annotations

import numpy as np


def export_pointcloud(vertices: np.ndarray, out_file: str, as_text: bool = True):
    assert vertices.shape[1] == 3
    vertices = np.ascontiguousarray(vertices.astype(np.float32))
    n = len(vertices)
    fmt = "ascii 1.0" if as_text else "binary_little_endian 1.0"
    header = (
        f"ply\nformat {fmt}\nelement vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\nend_header\n"
    )
    if as_text:
        with open(out_file, "w") as f:
            f.write(header)
            np.savetxt(f, vertices, fmt="%.9g")
    else:
        with open(out_file, "wb") as f:
            f.write(header.encode("ascii"))
            f.write(vertices.astype("<f4").tobytes())


def load_pointcloud(in_file: str) -> np.ndarray:
    with open(in_file, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        n = next(int(l.split()[-1]) for l in header if l.startswith("element vertex"))
        binary = any("binary_little_endian" in l for l in header)
        n_props = sum(1 for l in header if l.startswith("property"))
        if binary:
            data = np.frombuffer(f.read(n * n_props * 4), dtype="<f4").reshape(n, n_props)
        else:
            data = np.loadtxt(f, dtype=np.float32, max_rows=n).reshape(n, n_props)
    return data[:, :3].astype(np.float32)
