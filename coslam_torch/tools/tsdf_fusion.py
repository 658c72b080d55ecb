"""TSDF fusion: RGB-D frames + poses -> fused ground-truth mesh.

Counterpart of coslam_tpu/tools/tsdf_fusion.py (the reference
virtual-camera tool's fusion step,
evaluation/create_virtual_cameras_replica.py:35-75, which feeds every
RGB-D frame into an open3d ScalableTSDFVolume): a dense [Nx, Ny, Nz]
TSDF, weight and color volume on the device, updated once a frame in
plain torch, then the port's native marching cubes (mesh/mcubes.py) with
truncation-validity semantics: cells never observed hold exactly +trunc,
which marching_cubes treats as invalid.

The update runs over x-slabs of about ``SLAB_CELLS`` cells, so its
temporaries stay a slab's size whatever the volume's (room0's bound at
0.02 m is about 1.4e8 cells); the result does not depend on the slab.
A voxel's pixel is the rounded projection (round half to even, as
jnp.round); where a projection lies within f32 rounding of a pixel's .5
edge, this eager update and the JAX package's fused one may read
neighbouring pixels.

Usage:
  python -m coslam_torch.tools.tsdf_fusion --config configs/Replica/room0.yaml \
      --out fused.ply --voxel_size 0.02 [--every 5] [--ckpt run/checkpoint.npz]
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Tuple

import numpy as np
import torch

# Cells an update slab holds at most (its ~10 f32 temporaries then take
# about 0.7 GB).
SLAB_CELLS = 2 ** 24


def _update_slab(tsdf, weight, rgb_acc, depth_img, rgb_img, R, t, X, Y, Z,
                 intr, trunc: float, depth_trunc: float) -> None:
    """One frame's integration into one x-slab, in place.

    tsdf/weight: [nx, Ny, Nz] running sums of the slab; rgb_acc: [nx, Ny,
    Nz, 3] or None; X [nx, 1, 1], Y [1, Ny, 1], Z [1, 1, Nz]: voxel
    centres; R [3, 3], t [3]: world->camera (OpenCV, +z forward); intr:
    (fx, fy, cx, cy) as a [4] tensor."""
    H, W = depth_img.shape
    cam = [R[i, 0] * X + R[i, 1] * Y + R[i, 2] * Z + t[i] for i in range(3)]
    z = cam[2]
    zc = torch.clamp_min(z, 1e-9)
    u = intr[0] * cam[0] / zc + intr[2]
    v = intr[1] * cam[1] / zc + intr[3]
    # Clamped before the integer cast (out-of-range casts are undefined);
    # in range this is jnp.clip(jnp.round(u).astype(int32), 0, W - 1).
    ui = torch.round(u).clamp(0, W - 1).to(torch.int64)
    vi = torch.round(v).clamp(0, H - 1).to(torch.int64)
    d = depth_img[vi, ui]
    valid = ((z > 1e-6) & (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
             & (d > 0) & (d < depth_trunc))
    sdf = d - z
    # Every observation in front of (or within trunc behind) the surface,
    # clamped to the open interval so fused cells stay valid under the
    # marching-cubes truncation rule.
    integrate = valid & (sdf > -trunc)
    obs = torch.clamp(sdf, -0.999 * trunc, 0.999 * trunc)
    tsdf += torch.where(integrate, obs, 0.0)
    weight += integrate.to(torch.float32)
    if rgb_acc is not None:
        near = (integrate & (sdf.abs() < trunc)).to(torch.float32)
        rgb_acc += near[..., None] * rgb_img[vi, ui]


def fuse_frames(depths, c2ws, fx, fy, cx, cy, bounds, voxel_size: float,
                trunc: float, rgbs=None, depth_trunc: float = 100.0,
                verbose: bool = False, device="cuda"):
    """Fuse RGB-D frames into a dense TSDF volume on ``device``.

    depths: iterable of [H, W] float depth maps (meters); c2ws: matching
    [4, 4] camera-to-world poses, OpenGL convention (-z forward, as every
    loader of data/datasets.py); bounds: [3, 2] metric volume bounds;
    rgbs: optional matching [H, W, 3] float RGB in [0, 1].

    Returns (tsdf [Nx, Ny, Nz], color [Nx, Ny, Nz, 3] | None, (tx, ty,
    tz)) as numpy arrays. Unobserved cells hold exactly +trunc (invalid
    for mesh/mcubes.marching_cubes(..., truncation=trunc))."""
    from ..mesh.extract import get_voxels

    device = torch.device(device)
    b = np.asarray(bounds, np.float32)
    tx, ty, tz = get_voxels(b[0, 1], b[0, 0], b[1, 1], b[1, 0],
                            b[2, 1], b[2, 0], voxel_size=voxel_size)
    shape = (len(tx), len(ty), len(tz))
    X, Y, Z = (torch.from_numpy(a).to(device) for a in (tx, ty, tz))
    X, Y, Z = X[:, None, None], Y[None, :, None], Z[None, None, :]
    intr = torch.tensor([fx, fy, cx, cy], dtype=torch.float32,
                        device=device)
    with_rgb = rgbs is not None
    tsdf = torch.zeros(shape, device=device)
    weight = torch.zeros(shape, device=device)
    rgb_acc = torch.zeros(shape + (3,), device=device) if with_rgb else None
    slab = max(1, SLAB_CELLS // (shape[1] * shape[2]))

    n = len(depths) if hasattr(depths, "__len__") else None
    for i, (depth, c2w) in enumerate(zip(depths, c2ws)):
        c2w_cv = np.asarray(c2w, np.float64).copy()
        c2w_cv[:3, 1] *= -1  # OpenGL -> OpenCV
        c2w_cv[:3, 2] *= -1
        w2c = torch.from_numpy(np.linalg.inv(c2w_cv).astype(np.float32)).to(
            device)
        depth_img = torch.from_numpy(np.asarray(depth, np.float32)).to(device)
        rgb_img = (torch.from_numpy(np.asarray(rgbs[i], np.float32)).to(
            device) if with_rgb else None)
        for x0 in range(0, shape[0], slab):
            xs = slice(x0, x0 + slab)
            _update_slab(tsdf[xs], weight[xs],
                         None if rgb_acc is None else rgb_acc[xs],
                         depth_img, rgb_img, w2c[:3, :3], w2c[:3, 3], X[xs],
                         Y, Z, intr, float(trunc), float(depth_trunc))
        if verbose and i % 50 == 0:
            print(f"fused frame {i}{f'/{n}' if n else ''}")

    w = weight.cpu().numpy()
    vol = tsdf.cpu().numpy()
    with np.errstate(invalid="ignore"):
        vol = np.where(w > 0, vol / np.maximum(w, 1e-12), np.float32(trunc))
    color = None
    if with_rgb:
        color = rgb_acc.cpu().numpy() / np.maximum(w[..., None], 1e-12)
        color = np.where(w[..., None] > 0, color, 0.0).astype(np.float32)
    return vol.astype(np.float32), color, (tx, ty, tz)


def tsdf_mesh(vol: np.ndarray, axes: Tuple[np.ndarray, ...],
              trunc: float, color_vol: Optional[np.ndarray] = None):
    """Marching-cubes the fused volume back to a metric TriMesh."""
    from ..mesh.io import TriMesh
    from ..mesh.mcubes import marching_cubes

    tx, ty, tz = axes
    verts, faces = marching_cubes(vol, 0.0, truncation=float(trunc))
    scale = np.array([tx[-1] - tx[0], ty[-1] - ty[0], tz[-1] - tz[0]],
                     np.float32)
    div = np.array([len(tx) - 1, len(ty) - 1, len(tz) - 1], np.float32)
    verts_m = verts / div[None] * scale[None] + np.array(
        [tx[0], ty[0], tz[0]], np.float32)[None]
    colors = None
    if color_vol is not None and len(verts):
        idx = np.clip(np.round(verts).astype(int), 0, div.astype(int))
        colors = color_vol[idx[:, 0], idx[:, 1], idx[:, 2]]
    return TriMesh(verts_m, faces, colors)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="fuse a dataset's RGB-D stream into a GT mesh")
    p.add_argument("--config", required=True)
    p.add_argument("--out", required=True, help="output .ply path")
    p.add_argument("--voxel_size", type=float, default=0.02)
    p.add_argument("--trunc", type=float, default=None,
                   help="SDF truncation in meters (default 4*voxel_size)")
    p.add_argument("--every", type=int, default=1,
                   help="fuse every Nth frame")
    p.add_argument("--n_frames", type=int, default=None)
    p.add_argument("--ckpt", default=None,
                   help="fuse at a checkpoint's ESTIMATED poses instead "
                        "of dataset GT poses")
    p.add_argument("--no_color", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device holding the volume")
    args = p.parse_args(argv)

    from ..config import load_config
    from ..data.datasets import get_dataset

    cfg = load_config(args.config)
    ds = get_dataset(cfg)
    trunc = args.trunc if args.trunc is not None else 4 * args.voxel_size
    bounds = np.asarray(cfg["mapping"]["bound"], np.float32)

    est = None
    if args.ckpt:
        with np.load(args.ckpt, allow_pickle=False) as data:
            est = np.asarray(data["pose"])

    n = len(ds) if args.n_frames is None else min(args.n_frames, len(ds))
    ids = list(range(0, n, max(args.every, 1)))
    depths, rgbs, poses = [], [], []
    for i in ids:
        fr = ds[i]
        depths.append(np.asarray(fr["depth"], np.float32))
        rgbs.append(None if args.no_color
                    else np.asarray(fr["rgb"], np.float32))
        poses.append(est[i] if est is not None
                     else np.asarray(fr["c2w"], np.float64))

    t0 = time.perf_counter()
    vol, color, axes = fuse_frames(
        depths, poses, ds.fx, ds.fy, ds.cx, ds.cy, bounds, args.voxel_size,
        trunc, rgbs=None if args.no_color else rgbs,
        depth_trunc=cfg["cam"]["depth_trunc"], verbose=True,
        device=args.device)
    fuse_s = time.perf_counter() - t0
    mesh = tsdf_mesh(vol, axes, trunc, color)
    mesh.export(args.out)
    print(f"fused {len(ids)} frames ({1e3 * fuse_s / len(ids):.1f} ms a "
          f"frame) -> {args.out} ({len(mesh.vertices)} verts, "
          f"{len(mesh.faces)} faces)")
    return mesh


if __name__ == "__main__":
    main()
