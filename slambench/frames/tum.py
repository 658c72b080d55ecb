"""TUM RGB-D's layout: ``rgb/<t>.png`` + ``depth/<t>.png`` of the orbit
(``synth.write_tum_format``: 16-bit depth at ``cam.png_depth_scale``,
the sensor's depth noise, per-stream timestamp jitter) and ``rgb.txt``,
``depth.txt`` and ``groundtruth.txt`` listing the orbit over the
sequence's frames: frame i is orbit frame i mod period, its timestamps
those of the orbit frame moved on by whole orbits, so they rise through
the sequence as the loader's association expects.

A real recording's color comes through the lens: with
``cam.distortion`` the rendered (pinhole) color is distorted by those
coefficients (OpenCV's model), so that the loader's ``cv2.undistort``
gives the pinhole image back, in line with the depth and the poses. Where
the lens maps a pixel from outside the frame, the undistorted color is
black, as a real recording's is."""

from __future__ import annotations

import glob
import os
from typing import Dict

import numpy as np

# The sensor's frame rate (TUM's Kinect: 30 Hz).
FPS = 30.0


def write(out: str, scene, cfg: Dict, seq: Dict, poses: np.ndarray,
          device) -> None:
    from coslam_torch.data import synth

    cam = cfg["cam"]
    synth.write_tum_format(out, scene, poses, cam["H"], cam["W"],
                           cam["fx"], cam["fy"], cam["cx"], cam["cy"],
                           png_depth_scale=cam["png_depth_scale"], fps=FPS,
                           device=device)
    if cam.get("distortion") is not None:
        distort_color(out, cam)
    period, n = len(poses), int(seq["frames"])
    for name in ("rgb.txt", "depth.txt", "groundtruth.txt"):
        path = os.path.join(out, name)
        with open(path) as f:
            lines = f.read().splitlines()
        head = [ln for ln in lines if ln.startswith("#")]
        rows = [ln.split(" ", 1) for ln in lines if not ln.startswith("#")]
        with open(path, "w") as f:
            for ln in head:
                f.write(ln + "\n")
            for i in range(n):
                t, rest = rows[i % period]
                f.write(f"{float(t) + (i // period) * period / FPS:.6f} "
                        f"{rest}\n")


def lens(cam: Dict, x: np.ndarray, y: np.ndarray):
    """OpenCV's lens model (k1, k2, p1, p2, k3) at normalized pinhole
    coordinates: where the lens puts them."""
    k1, k2, p1, p2, k3 = (float(v) for v in cam["distortion"])
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    return (x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x),
            y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y)


def lens_map(cam: Dict, iters: int = 50) -> np.ndarray:
    """[H, W, 2] float32: for each pixel of the distorted image, the pixel
    of the pinhole image it sees: the lens model inverted by fixed-point
    iteration from the distorted coordinates (as OpenCV's
    ``undistortPoints`` does, run to convergence)."""
    H, W = int(cam["H"]), int(cam["W"])
    u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                       np.arange(H, dtype=np.float64))
    xd, yd = (u - cam["cx"]) / cam["fx"], (v - cam["cy"]) / cam["fy"]
    x, y = xd.copy(), yd.copy()
    for _ in range(iters):
        lx, ly = lens(cam, x, y)
        x, y = x + (xd - lx), y + (yd - ly)
    return np.stack([x * cam["fx"] + cam["cx"], y * cam["fy"] + cam["cy"]],
                    -1).astype(np.float32)


def distort_color(out: str, cam: Dict) -> None:
    """Distort every ``rgb/*.png`` under ``out`` in place."""
    import cv2

    m = lens_map(cam)
    for path in sorted(glob.glob(os.path.join(out, "rgb", "*.png"))):
        img = cv2.imread(path)
        cv2.imwrite(path, cv2.remap(img, m[..., 0], m[..., 1],
                                    cv2.INTER_LINEAR,
                                    borderMode=cv2.BORDER_REPLICATE))
