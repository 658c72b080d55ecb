"""Mesh extraction: SDF grid query through the port + native marching cubes.

Counterpart of coslam_tpu/mesh/extract.py: the voxel grid of the
marching-cubes bound is queried in fixed-size chunks through the port's
model (the grid's encode kernel on the card), and the volume goes to the
port's copy of the native marching cubes (mesh/mcubes.py).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch

from .io import TriMesh
from .mcubes import marching_cubes

CHUNK = 1024 * 64


def get_voxels(x_max, x_min, y_max, y_min, z_max, z_min,
               voxel_size: float):
    """Grid axis coordinates at voxel_size (coslam_tpu.mesh.extract
    .get_voxels)."""
    n = [round((hi - lo) / voxel_size + 0.0005) + 1
         for hi, lo in ((x_max, x_min), (y_max, y_min), (z_max, z_min))]
    return tuple(np.linspace(lo, hi, k, dtype=np.float32)
                 for (lo, hi), k in zip(((x_min, x_max), (y_min, y_max),
                                         (z_min, z_max)), n))


@torch.no_grad()
def _chunked_query(fn, pts_norm: np.ndarray, device) -> np.ndarray:
    outs = []
    for i in range(0, pts_norm.shape[0], CHUNK):
        block = torch.from_numpy(pts_norm[i:i + CHUNK]).to(device)
        outs.append(fn(block).cpu().numpy())
    return np.concatenate(outs, axis=0)


def extract_mesh(model, params, config: Dict, bounding_box: np.ndarray,
                 marching_cube_bound: Optional[np.ndarray] = None,
                 color_func=None, voxel_size: float = 0.05,
                 isolevel: float = 0.0,
                 mesh_savepath: str = "", span=None) -> TriMesh:
    """Extract a (vertex-colored, when color_func is given) mesh from the
    scene SDF. ``span(name)``, a context of each phase (say a recorder's
    ``Spans.span``): ``mesh.query`` (the SDF's chunked queries up to the
    volume's readback), ``mesh.mcubes`` (marching cubes and the
    vertices' scaling, on the host), ``mesh.color`` and
    ``mesh.export``."""
    span = span or (lambda name: contextlib.nullcontext())
    if marching_cube_bound is None:
        marching_cube_bound = bounding_box
    bb = np.asarray(bounding_box, np.float32)
    mcb = np.asarray(marching_cube_bound, np.float32)
    tx, ty, tz = get_voxels(mcb[0, 1], mcb[0, 0], mcb[1, 1], mcb[1, 0],
                            mcb[2, 1], mcb[2, 0],
                            voxel_size)
    grid = np.stack(np.meshgrid(tx, ty, tz, indexing="ij"), axis=-1)
    flat_norm = ((grid.reshape(-1, 3) - bb[:, 0])
                 / (bb[:, 1] - bb[:, 0])).astype(np.float32)
    with span("mesh.query"):
        sdf = _chunked_query(lambda p: model.query_sdf(params, p), flat_norm,
                             model.device)
    volume = sdf.reshape(len(tx), len(ty), len(tz))

    with span("mesh.mcubes"):
        vertices, triangles = marching_cubes(volume, isolevel,
                                             truncation=3.0)
        vertices = vertices / np.array(
            [[len(tx) - 1, len(ty) - 1, len(tz) - 1]], np.float32)
        scale = np.array([tx[-1] - tx[0], ty[-1] - ty[0], tz[-1] - tz[0]],
                         np.float32)
        offset = np.array([tx[0], ty[0], tz[0]], np.float32)
        vertices = vertices * scale[None] + offset[None]
        vertices = (vertices / config["data"]["sc_factor"]
                    - config["data"]["translation"])

    vertex_colors = None
    with span("mesh.color"):
        if color_func is not None and not config["mesh"]["render_color"]:
            vert_norm = ((vertices - bb[:, 0]) / (bb[:, 1] - bb[:, 0])
                         ).astype(np.float32)
            vertex_colors = _chunked_query(lambda p: color_func(params, p),
                                           vert_norm, model.device)
        elif color_func is not None:
            # mesh.render_color: color_func(params, vertices [n, 3],
            # normals [n, 3]) renders along the area-weighted vertex
            # normals in metric coordinates (the model's
            # render_surface_color).
            normals = TriMesh(vertices, triangles).vertex_normals.astype(
                np.float32)
            both = np.concatenate([vertices.astype(np.float32), normals], 1)
            vertex_colors = _chunked_query(
                lambda vn: color_func(params, vn[:, :3], vn[:, 3:]), both,
                model.device)
    mesh = TriMesh(vertices, triangles, vertex_colors)
    if mesh_savepath:
        with span("mesh.export"):
            mesh.export(mesh_savepath)
    return mesh
