"""Minimal triangle-mesh container and binary PLY export.

The port's own copy of what it uses of coslam_tpu/mesh/io.py.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


class TriMesh:
    """Vertices [N,3] f32, faces [M,3] int, optional vertex colors [N,3/4]."""

    def __init__(self, vertices: np.ndarray, faces: np.ndarray,
                 vertex_colors: Optional[np.ndarray] = None):
        self.vertices = np.asarray(vertices, np.float32)
        self.faces = np.asarray(faces, np.int64)
        self.vertex_colors = vertex_colors

    def export(self, path: str) -> None:
        save_ply(path, self.vertices, self.faces, self.vertex_colors)


def save_ply(path: str, vertices: np.ndarray, faces: np.ndarray,
             vertex_colors: Optional[np.ndarray] = None) -> None:
    """Binary little-endian PLY writer."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    n_v, n_f = len(vertices), len(faces)
    has_color = vertex_colors is not None

    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n_v}",
              "property float x", "property float y", "property float z"]
    if has_color:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += [f"element face {n_f}",
               "property list uchar int vertex_indices", "end_header"]

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if has_color:
            col = np.asarray(vertex_colors)
            if col.dtype != np.uint8:
                col = np.clip(col[:, :3] * 255, 0, 255).astype(np.uint8)
            vdt = np.dtype([("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
            vbuf = np.empty(n_v, vdt)
            vbuf["xyz"] = vertices.astype(np.float32)
            vbuf["rgb"] = col[:, :3]
        else:
            vdt = np.dtype([("xyz", np.float32, 3)])
            vbuf = np.empty(n_v, vdt)
            vbuf["xyz"] = vertices.astype(np.float32)
        f.write(vbuf.tobytes())
        fdt = np.dtype([("n", np.uint8), ("idx", np.int32, 3)])
        fbuf = np.empty(n_f, fdt)
        fbuf["n"] = 3
        fbuf["idx"] = faces.astype(np.int32)
        f.write(fbuf.tobytes())
