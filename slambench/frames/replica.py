"""Replica's layout: ``results/frame%06d.jpg`` + ``results/depth%06d.png``
of the orbit, symbolic links to them for the sequence's later frames, and
a ``traj.txt`` of the whole sequence."""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


def write(out: str, scene, cfg: Dict, seq: Dict, poses: np.ndarray,
          device) -> None:
    from coslam_torch.data import synth

    cam = cfg["cam"]
    synth.write_replica_format(out, scene, poses, cam["H"], cam["W"],
                               cam["fx"], cam["fy"], cam["cx"], cam["cy"],
                               png_depth_scale=cam["png_depth_scale"],
                               device=device)
    res = os.path.join(out, "results")
    period, n = len(poses), int(seq["frames"])
    for i in range(period, n):
        for kind, ext in (("frame", "jpg"), ("depth", "png")):
            os.symlink(f"{kind}{i % period:06d}.{ext}",
                       os.path.join(res, f"{kind}{i:06d}.{ext}"))
    with open(os.path.join(out, "traj.txt"), "w") as f:
        for i in range(n):
            cv = np.array(poses[i % period], np.float64)
            cv[:3, 1] *= -1
            cv[:3, 2] *= -1
            f.write(" ".join(f"{v:.10f}" for v in cv.reshape(-1)) + "\n")
