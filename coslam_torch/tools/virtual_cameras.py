"""Virtual-camera creation for the Co-SLAM culling protocol.

The port's own copy of coslam_tpu/tools/virtual_cameras.py. The
reference tool (evaluation/create_virtual_cameras_replica.py) TSDF-fuses
a GT mesh and has a human pick extra viewpoints covering regions the
trajectory missed; each view is saved as `{i}.txt` (c2w). Headless
equivalent: sample candidate viewpoints in the scene's free interior,
keep those that observe surface regions NOT covered by the trajectory
(maximizing newly-seen area), and write the same
`virtual_cameras/{i}.txt` layout that eval/cull.py reads.

Unlike the JAX package, the directory also gets a ``MANIFEST`` (not a
``.txt``, so the cull never reads it as a pose): the source of the
trajectory the coverage came from and the count selected, written even
when no camera is selected. ``read_manifest`` tells a set made this way
from a stale one (no manifest), which ``eval/benchmark.py`` regenerates.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional

import numpy as np

from ..eval.recon import viewmatrix
from ..mesh.io import TriMesh
from ..mesh.raster import render_depth

MANIFEST = "MANIFEST"


def _coverage(mesh: TriMesh, surf_pts: np.ndarray, poses, fx, fy, cx, cy,
              H, W, eps=0.03) -> np.ndarray:
    """Boolean mask of surf_pts observed by any pose (frustum+occlusion)."""
    seen = np.zeros(len(surf_pts), bool)
    for c2w in poses:
        cv = np.asarray(c2w, np.float64).copy()
        cv[:3, 1] *= -1
        cv[:3, 2] *= -1
        w2c = np.linalg.inv(cv)
        depth = render_depth(mesh.vertices, mesh.faces,
                             w2c.astype(np.float32), fx, fy, cx, cy, H, W)
        cam = surf_pts @ w2c[:3, :3].T + w2c[:3, 3]
        pz = cam[:, 2] + 1e-8
        px = fx * cam[:, 0] / pz + cx
        py = fy * cam[:, 1] / pz + cy
        inside = (0 <= px) & (px <= W - 1) & (0 <= py) & (py <= H - 1) & (pz > 0)
        u = np.clip(px, 0, W - 1).astype(int)
        v = np.clip(py, 0, H - 1).astype(int)
        seen |= inside & (pz < depth[v, u] + eps)
    return seen


def create_virtual_cameras(gt_mesh: TriMesh, traj_poses: List[np.ndarray],
                           out_dir: str, fx, fy, cx, cy, H, W,
                           n_candidates: int = 200, n_select: int = 20,
                           seed: int = 0,
                           source: str = "gt-traj") -> List[np.ndarray]:
    """Greedy max-new-coverage viewpoint selection; writes {i}.txt files
    and the MANIFEST (``source``: where ``traj_poses`` came from)."""
    rng = np.random.default_rng(seed)
    surf = gt_mesh.sample_surface(20000, rng)
    seen = _coverage(gt_mesh, surf, traj_poses, fx, fy, cx, cy, H, W)

    lo, hi = gt_mesh.vertices.min(0), gt_mesh.vertices.max(0)
    center, half = 0.5 * (lo + hi), 0.35 * (hi - lo)

    candidates = []
    for _ in range(n_candidates):
        origin = center + rng.uniform(-1, 1, 3) * half
        target = surf[rng.integers(len(surf))]
        c2w = np.eye(4)
        # viewmatrix yields +z-forward; flip to OpenGL for the protocol.
        m = viewmatrix(target - origin, [0, 0, -1], origin)
        c2w[:3, :] = m
        c2w[:3, 1] *= -1
        c2w[:3, 2] *= -1
        candidates.append(c2w)

    # Each candidate's coverage mask once (one depth render per
    # candidate); the greedy loop is then boolean algebra.
    cov = np.stack([_coverage(gt_mesh, surf, [c2w], fx, fy, cx, cy, H, W)
                    for c2w in candidates]) if candidates else \
        np.zeros((0, len(surf)), bool)

    chosen = []
    unseen = ~seen
    for _ in range(n_select):
        gains = (cov & unseen).sum(axis=1)
        i = int(gains.argmax()) if len(gains) else 0
        if len(gains) == 0 or gains[i] == 0:
            break
        chosen.append(candidates[i])
        unseen &= ~cov[i]

    os.makedirs(out_dir, exist_ok=True)
    for i, c2w in enumerate(chosen):
        np.savetxt(os.path.join(out_dir, f"{i}.txt"), c2w)
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        f.write(f"SOURCE: {source}\nSELECTED: {len(chosen)}\n"
                f"CANDIDATES: {n_candidates}\nSEED: {seed}\n")
    return chosen


def read_manifest(out_dir: str) -> Optional[Dict[str, str]]:
    """The MANIFEST of a virtual-camera directory as a dict, or None when
    there is none."""
    path = os.path.join(out_dir, MANIFEST)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return dict(line.split(": ", 1) for line in f.read().splitlines()
                    if ": " in line)


def clear_cameras(out_dir: str) -> int:
    """Remove the {i}.txt files and the MANIFEST of out_dir; returns how
    many cameras were removed."""
    stale = glob.glob(os.path.join(out_dir, "*.txt"))
    for path in stale:
        os.remove(path)
    if os.path.exists(os.path.join(out_dir, MANIFEST)):
        os.remove(os.path.join(out_dir, MANIFEST))
    return len(stale)


def main(argv=None):
    """CLI: virtual cameras for a dataset from its GT mesh and its
    trajectory (every ``--every``-th frame's pose)."""
    import argparse

    p = argparse.ArgumentParser(
        description="virtual-camera creation for the Co-SLAM culling "
                    "protocol (headless greedy-coverage selection)")
    p.add_argument("--config", required=True)
    p.add_argument("--gt_mesh", required=True, help="the GT mesh .ply")
    p.add_argument("--out_dir", default=None,
                   help="default: <datadir>/virtual_cameras")
    p.add_argument("--every", type=int, default=5,
                   help="use every Nth frame's pose")
    p.add_argument("--n_candidates", type=int, default=200)
    p.add_argument("--n_select", type=int, default=20)
    args = p.parse_args(argv)

    from ..config import load_config
    from ..data.datasets import get_dataset
    from ..mesh.io import load_ply

    cfg = load_config(args.config)
    ds = get_dataset(cfg)
    poses = [np.asarray(ds.poses[ds.frame_ids[i]], np.float64)
             for i in range(0, len(ds), max(args.every, 1))]
    out_dir = args.out_dir or os.path.join(
        cfg["data"]["datadir"], "virtual_cameras")
    chosen = create_virtual_cameras(
        load_ply(args.gt_mesh), poses, out_dir, ds.fx, ds.fy, ds.cx, ds.cy,
        ds.H, ds.W, n_candidates=args.n_candidates, n_select=args.n_select)
    print(f"wrote {len(chosen)} virtual cameras to {out_dir}")
    return chosen


if __name__ == "__main__":
    main()
