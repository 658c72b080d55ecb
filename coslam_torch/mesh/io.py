"""Minimal triangle-mesh container, PLY export and import.

The port's own copy of coslam_tpu/mesh/io.py: the same numpy arithmetic,
so normals, surface samples (for the same generator) and files are the
same bits.
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

    @property
    def vertex_normals(self) -> np.ndarray:
        """Area-weighted vertex normals."""
        v = self.vertices
        f = self.faces
        fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        vn = np.zeros_like(v)
        for i in range(3):
            np.add.at(vn, f[:, i], fn)
        norm = np.linalg.norm(vn, axis=1, keepdims=True)
        return vn / np.maximum(norm, 1e-12)

    def export(self, path: str) -> None:
        save_ply(path, self.vertices, self.faces, self.vertex_colors)

    def remove_unreferenced_vertices(self) -> "TriMesh":
        """Drop vertices not used by any face (in place; returns self)."""
        used, inverse = np.unique(self.faces.reshape(-1), return_inverse=True)
        self.vertices = self.vertices[used]
        if self.vertex_colors is not None:
            self.vertex_colors = np.asarray(self.vertex_colors)[used]
        self.faces = inverse.reshape(-1, 3).astype(np.int64)
        return self

    def sample_surface(self, n: int, rng=None) -> np.ndarray:
        """Uniform-area random surface samples [n, 3]."""
        rng = rng or np.random.default_rng(0)
        v, f = self.vertices, self.faces
        a = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        area = 0.5 * np.linalg.norm(a, axis=1)
        p = area / max(area.sum(), 1e-12)
        tri = rng.choice(len(f), size=n, p=p)
        r1, r2 = rng.random(n), rng.random(n)
        s = np.sqrt(r1)
        w0, w1, w2 = 1 - s, s * (1 - r2), s * r2
        return (w0[:, None] * v[f[tri, 0]] + w1[:, None] * v[f[tri, 1]]
                + w2[:, None] * v[f[tri, 2]])


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


def load_ply(path: str) -> TriMesh:
    """Binary/ascii PLY reader (vertices/faces/optional uchar colors)."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.find(b"end_header\n") + len(b"end_header\n")
    header = data[:head_end].decode().splitlines()
    body = data[head_end:]

    fmt = next(l.split()[1] for l in header if l.startswith("format"))
    n_v = n_f = 0
    v_props = []
    cur = None
    for line in header:
        t = line.split()
        if t[0] == "element":
            cur = t[1]
            if t[1] == "vertex":
                n_v = int(t[2])
            elif t[1] == "face":
                n_f = int(t[2])
        elif t[0] == "property" and cur == "vertex" and t[1] != "list":
            v_props.append((t[2], t[1]))

    tmap = {"float": np.float32, "float32": np.float32, "double": np.float64,
            "uchar": np.uint8, "uint8": np.uint8, "int": np.int32,
            "uint": np.uint32}

    if fmt == "ascii":
        lines = body.decode().split("\n")
        vals = np.array([l.split() for l in lines[:n_v]], np.float64)
        names = [p[0] for p in v_props]
        verts = vals[:, [names.index(c) for c in "xyz"]].astype(np.float32)
        colors = None
        if "red" in names:
            colors = vals[:, [names.index(c)
                              for c in ("red", "green", "blue")]] / 255.0
        faces = np.array([l.split()[1:4] for l in lines[n_v:n_v + n_f]],
                         np.int64)
        return TriMesh(verts, faces, colors)

    vdt = np.dtype([(name, tmap[t]) for name, t in v_props])
    vraw = np.frombuffer(body[:n_v * vdt.itemsize], vdt)
    verts = np.stack([vraw["x"], vraw["y"], vraw["z"]], -1).astype(np.float32)
    colors = None
    if "red" in vdt.names:
        colors = np.stack([vraw["red"], vraw["green"], vraw["blue"]],
                          -1).astype(np.float32) / 255.0
    off = n_v * vdt.itemsize
    fdt = np.dtype([("n", np.uint8), ("idx", np.int32, 3)])
    fraw = np.frombuffer(body[off:off + n_f * fdt.itemsize], fdt)
    return TriMesh(verts, fraw["idx"].astype(np.int64), colors)
