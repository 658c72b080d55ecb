"""The frame writers (``slambench/frames/<dataset>.py``), found by the
configuration's ``dataset``: room0's tiny sequence byte for byte as the
Replica writer wrote it before it moved into its own file, the TUM
layout listed over the sequence with rising timestamps and read back by
the program's loader, its color distorted by the lens so that the
loader's undistort gives back the pinhole render, and a dataset without a
writer refused with the file looked for."""

import hashlib
import os

import numpy as np
import pytest

from slambench import data, harness
from slambench.tests import tiny
from slambench.tests.test_importance import FIXTURE, tiny_cfg

# tree_sha1 of the tiny room0 sequence (tiny.SEQUENCE at tiny's camera)
# as data.py's own Replica writer wrote it, before it moved into
# frames/replica.py.
REPLICA_SHA1 = "1ce92ab1bb6329333d789b406d3e1a5e6510a082"


def tree_sha1(top: str) -> str:
    """sha1 over every file under ``top`` in name order: its relative
    path and bytes, or for a symbolic link the path it points to."""
    h = hashlib.sha1()
    for dirpath, dirnames, files in os.walk(top):
        dirnames.sort()
        for f in sorted(files):
            p = os.path.join(dirpath, f)
            rel = os.path.relpath(p, top).encode()
            if os.path.islink(p):
                h.update(b"L" + rel + b"\0" + os.readlink(p).encode() + b"\0")
            else:
                with open(p, "rb") as fh:
                    h.update(b"F" + rel + b"\0" + fh.read())
    return h.hexdigest()


def test_replica_sequence_as_before_the_move(tmp_path):
    spec = harness.cell_files(harness.ROOT, "replica_room0", "seq")
    cfg = harness.build_config(spec["config"], 3, "", "",
                               tiny.overrides("replica_room0"))
    seq = dict(spec["config"]["sequence"], **tiny.SEQUENCE)
    out = data.ensure_frames(str(tmp_path), "replica_room0", cfg, seq, "cpu")
    assert tree_sha1(out) == REPLICA_SHA1


def _rows(path):
    with open(path) as f:
        return [ln.split(" ", 1) for ln in f.read().splitlines()
                if not ln.startswith("#")]


def test_tum_layout_lists_the_orbit_over_the_sequence(tmp_path):
    from coslam_torch.data.datasets import get_dataset

    period, n = 20, 70
    seq = {"scene": "room", "period": period, "frames": n}
    out = data.ensure_frames(str(tmp_path), "tum_fr1_desk", tiny_cfg(), seq,
                             "cpu")
    assert len(os.listdir(os.path.join(out, "rgb"))) == period
    for name in ("rgb.txt", "depth.txt", "groundtruth.txt"):
        rows = _rows(os.path.join(out, name))
        assert len(rows) == n
        stamps = [float(t) for t, _ in rows]
        assert all(b > a for a, b in zip(stamps, stamps[1:])), name
        assert all(rows[i][1] == rows[i % period][1] for i in range(n))
    cfg = harness.build_config(harness.load_json(FIXTURE), 3, out,
                               str(tmp_path / "run"), tiny.overrides(
                                   "tum_fr1_desk"))
    dataset = get_dataset(cfg)
    assert dataset.num_frames == n
    poses = np.stack([np.asarray(p, np.float64) for p in dataset.poses])
    orbit = np.tile(data.orbit(period), (n // period + 1, 1, 1))[:n]
    assert np.abs(poses - orbit).max() < 1e-5


def test_unknown_dataset_names_the_missing_file(tmp_path):
    cfg = {"dataset": "nosuch", "cam": {}}
    with pytest.raises(FileNotFoundError, match=r"frames[/\\]nosuch\.py"):
        data.ensure_frames(str(tmp_path), "x", cfg, {"period": 2,
                                                     "frames": 2}, "cpu")
    assert not os.path.exists(tmp_path / ".slambench_cache")


def _rgb(path):
    import cv2

    return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB) / 255.0


def test_tum_color_lines_up_with_the_render_once_undistorted(tmp_path):
    """fr1_desk's camera at a quarter of its size: the loader's color
    (undistorted from the written frames) against the pinhole render of
    the same poses, and against what the loader made of the pinhole
    render itself, as a writer without the lens would have left it."""
    from coslam_torch.data import synth
    from coslam_torch.data.datasets import get_dataset

    s = 0.25
    cam = dict(harness.load_json(FIXTURE)["config"]["cam"], H=120, W=160,
               fx=517.3 * s, fy=516.5 * s, cx=318.6 * s, cy=255.3 * s,
               crop_size=[120, 160], crop_edge=2)
    cfg = harness.build_config(harness.load_json(FIXTURE), 3, "", "",
                               {"cam": cam})
    seq = {"scene": "room", "period": 2, "frames": 2}
    lensed = data.ensure_frames(str(tmp_path), "t", cfg, seq, "cpu")
    pinhole = str(tmp_path / "pinhole")
    synth.write_tum_format(pinhole, synth.SCENES["room"](), data.orbit(2),
                           cam["H"], cam["W"], cam["fx"], cam["fy"],
                           cam["cx"], cam["cy"],
                           png_depth_scale=cam["png_depth_scale"],
                           device="cpu")
    read = [get_dataset(harness.build_config(
        harness.load_json(FIXTURE), 3, d, str(tmp_path / "run"),
        {"cam": cam})) for d in (lensed, pinhole)]
    e = cam["crop_edge"]
    for i, name in enumerate(sorted(os.listdir(os.path.join(pinhole,
                                                            "rgb")))):
        want = _rgb(os.path.join(pinhole, "rgb", name))[e:-e, e:-e]
        got, unlensed = (np.asarray(r[i]["rgb"]).reshape(want.shape)
                         for r in read)
        seen = got.sum(-1) > 0      # pixels the lens brings into the frame
        assert seen.mean() > 0.99
        gap = np.abs(got - want).mean(-1)[seen].mean()
        assert gap < 0.006
        assert gap < 0.5 * np.abs(unlensed - want).mean(-1)[seen].mean()
