"""The frames a cell reads.

One closed orbit of the program's analytic room (its last pose leads
smoothly into its first: every wander term turns a whole number of times
an orbit) is rendered once into a cache directory inside the checkout,
in the layout of the configuration's dataset, and listed as often as the
sequence needs: Replica's ``results/`` by symbolic links to the orbit's
files and a ``traj.txt`` of the whole sequence. The program's own loader
reads them.

The cache is keyed by everything the frames depend on (the camera, the
orbit, the layout and the sources of the renderer and of this file) and
filled in a directory of its own that is renamed into place when it is
whole, so a run that is cut leaves nothing that a later run would read.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Dict

import numpy as np

# Bumped when what this file writes changes.
_LAYOUT_VERSION = 1


def orbit(n: int, radius: float = 1.15) -> np.ndarray:
    """[n, 4, 4] OpenGL poses of one closed orbit: the eye circles the
    room at ``radius`` and bobs once a turn, looking at a point that
    circles and bobs once a turn too (the program's scan trajectory with
    whole-number wander frequencies)."""
    poses = []
    for i in range(n):
        th = 2.0 * np.pi * i / n
        eye = np.array([radius * np.cos(th), 0.25 + 0.25 * np.sin(th + 0.3),
                        radius * np.sin(th)])
        target = np.array([0.45 * np.cos(th + 2.0),
                           -0.75 + 0.55 * np.sin(th),
                           0.45 * np.sin(th + 2.0)])
        z = eye - target
        z /= np.linalg.norm(z)
        x = np.cross(np.array([0.0, 1.0, 0.0]), z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, eye
        poses.append(c2w)
    return np.stack(poses).astype(np.float32)


def _source_hash() -> str:
    from coslam_torch.data import synth

    h = hashlib.sha1()
    for path in (synth.__file__, __file__):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:12]


def cache_key(cfg: Dict, seq: Dict) -> str:
    what = {"dataset": cfg["dataset"], "cam": cfg["cam"], "seq": seq,
            "version": _LAYOUT_VERSION, "sources": _source_hash()}
    return hashlib.sha1(json.dumps(what, sort_keys=True).encode()
                        ).hexdigest()[:16]


def ensure_frames(root: str, name: str, cfg: Dict, seq: Dict,
                  device="cuda") -> str:
    """The directory of the sequence ``seq`` ({"period", "frames",
    "scene"}) for configuration ``name``, rendered on ``device`` if it is
    not in the cache yet."""
    base = os.path.join(root, ".slambench_cache", "frames")
    final = os.path.join(base, f"{name}-{cache_key(cfg, seq)}")
    if os.path.isdir(final):
        return final
    work = final + ".partial"
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    poses = orbit(int(seq["period"]))
    if cfg["dataset"] == "replica":
        _write_replica(work, cfg, seq, poses, device)
    else:
        raise ValueError(f"no writer for dataset {cfg['dataset']!r}")
    os.replace(work, final)
    return final


def _scene(seq: Dict):
    from coslam_torch.data import synth

    return synth.SCENES[seq.get("scene", "room")]()


def _write_replica(out: str, cfg: Dict, seq: Dict, poses: np.ndarray,
                   device) -> None:
    from coslam_torch.data import synth

    cam = cfg["cam"]
    synth.write_replica_format(out, _scene(seq), poses, cam["H"], cam["W"],
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
