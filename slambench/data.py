"""The frames a cell reads.

One closed orbit of the program's analytic room (its last pose leads
smoothly into its first: every wander term turns a whole number of times
an orbit) is rendered once into a cache directory inside the checkout,
in the layout of the configuration's dataset, and listed as often as the
sequence needs. The layout is written by ``slambench/frames/<dataset>.py``
(``write(out, scene, cfg, seq, poses, device)``), found by the
configuration's ``dataset``: a new dataset brings its writer as a file of
its own. The program's own loader reads the frames.

The cache is keyed by everything the frames depend on (the camera, the
orbit, the layout and the sources of the renderer, of this file and of
the dataset's writer) and
filled in a directory of its own that is renamed into place when it is
whole, so a run that is cut leaves nothing that a later run would read.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import shutil
from typing import Dict

import numpy as np

# Bumped when what this file writes changes.
_LAYOUT_VERSION = 1

_FRAMES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "frames")


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


def _source_hash(writer: str) -> str:
    from coslam_torch.data import synth

    h = hashlib.sha1()
    for path in (synth.__file__, __file__, writer):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:12]


def cache_key(cfg: Dict, seq: Dict, writer: str) -> str:
    what = {"dataset": cfg["dataset"], "cam": cfg["cam"], "seq": seq,
            "version": _LAYOUT_VERSION, "sources": _source_hash(writer)}
    return hashlib.sha1(json.dumps(what, sort_keys=True).encode()
                        ).hexdigest()[:16]


def ensure_frames(root: str, name: str, cfg: Dict, seq: Dict,
                  device="cuda") -> str:
    """The directory of the sequence ``seq`` ({"period", "frames",
    "scene"}) for configuration ``name``, rendered on ``device`` if it is
    not in the cache yet. A dataset without a writer fails on reading
    the writer's file, naming it."""
    from coslam_torch.data import synth

    path = os.path.join(_FRAMES, f"{cfg['dataset']}.py")
    base = os.path.join(root, ".slambench_cache", "frames")
    final = os.path.join(base, f"{name}-{cache_key(cfg, seq, path)}")
    if os.path.isdir(final):
        return final
    spec = importlib.util.spec_from_file_location(
        "slambench_frames_" + cfg["dataset"], path)
    writer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(writer)
    work = final + ".partial"
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    writer.write(work, synth.SCENES[seq.get("scene", "room")](), cfg, seq,
                 orbit(int(seq["period"])), device)
    os.replace(work, final)
    return final
