"""The pipelined tracker/mapper runtime (coslam_torch/runtime/pipeline.py)
and what it brings with it: the frame-tail report (runtime/latency.py),
the dataset algebra (data/datasets.py), the motion model's gap_ratio and
the information-weighted tracking rays (tracking.sample_info_frac), each
against the JAX package; the pipelined loop on the CPU on the 12-frame
40x52 scene of tests/test_pipeline_active.py, held to that file's
assertions; the checkpoint's pose tables against a concurrent writer;
an exception in either thread raised by run(); and the CLI's
--pipelined and --active.

Tolerances. attribute_tails, the dataset algebra and the tracking
rays: none (the same numpy arithmetic on the same inputs, so equal bit
for bit). predict_current_pose: 1e-6 (the same float64 numpy and scipy
calls; 1e-6 leaves room for a BLAS that sums in another order), and at
gap_ratio 1 bit for bit the value of the formula without it. The runs:
the JAX tests' bounds (ATE < 0.08 m).
"""

import copy
import os
import threading
import time

import numpy as np
import pytest
import torch

from coslam_tpu.data.datasets import get_dataset as j_get_dataset
from coslam_tpu.data.synth import make_trajectory
from coslam_tpu.runtime import latency as JL
from coslam_tpu.runtime import tracking as JT
from coslam_tpu.runtime.slam import CoSLAM as JCoSLAM
from coslam_torch.data import synth as TS
from coslam_torch.data.datasets import get_dataset as t_get_dataset
from coslam_torch.ops.rays import get_camera_rays
from coslam_torch.runtime import latency as TLat
from coslam_torch.runtime import tracking as TT
from coslam_torch.runtime.pipeline import PipelinedCoSLAM
from coslam_torch.runtime.slam import CoSLAM

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def small_seq(tmp_path_factory):
    """tests/test_pipeline_active.py's scene: 12 frames 40x52 of the
    analytic room on a short orbit, in Replica layout (the port's writer:
    the JAX writer's bits), first_iters 60, no periodic mesh."""
    d = tmp_path_factory.mktemp("torch_pipe")
    datadir = str(d / "scene")
    cfg = TS.make_synthetic_config(datadir, str(d / "out"), H=40, W=52,
                                   n_frames=12)
    cfg["mapping"]["first_iters"] = 60
    cfg["mesh"]["vis"] = 0
    cam = cfg["cam"]
    TS.write_replica_format(datadir, TS.AnalyticScene(),
                            make_trajectory(12, orbit_fraction=0.02),
                            cam["H"], cam["W"], cam["fx"], cam["fy"],
                            cam["cx"], cam["cy"])
    return cfg


def _walls(dts):
    return np.concatenate([[0.0], np.cumsum(dts)])


def _tail_cases():
    """The three cases of tests/test_latency.py."""
    dts = [0.01] * 10 + [0.05] + [0.01] * 5 + [0.05] + [0.01] * 4
    w = _walls(dts)
    yield w, [(w[10] + 0.001, w[10] + 0.04, "ba"),
              (w[16] + 0.001, w[16] + 0.03, "checkpoint")]
    w = _walls([0.01] * 10 + [0.05] + [0.01] * 9)
    yield w, [(w[9] + 0.002, w[9] + 0.008, "ba")]
    yield _walls([0.01] * 10 + [0.05]), []
    yield [0.0, 1.0], []
    yield [], []


@pytest.mark.parametrize("case", range(5))
def test_attribute_tails_matches_jax(case):
    walls, events = list(_tail_cases())[case]
    got = TLat.attribute_tails(walls, events)
    assert got == JL.attribute_tails(walls, events)


def test_dataset_algebra_matches_jax(small_seq):
    """slice, remove, slice_except and + over both packages' loaders of
    the same files: the same lengths, frame ids and poses, and the
    attributes passed through (tests/test_pipeline_active.py:154)."""
    jd, td = j_get_dataset(small_seq), t_get_dataset(small_seq)
    assert len(td) == len(jd) == 12

    def views(ds):
        v = ds.slice(range(2, 6))
        v2 = v.remove([0])
        return [v, v2, v + v2, ds.slice_except([0, 1]), v2.slice([2, 0]),
                ds.slice([]), v2 + ds.slice([7]) + v]

    for jv, tv in zip(views(jd), views(td), strict=True):
        assert len(tv) == len(jv)
        assert tv.num_frames == jv.num_frames
        for i in range(len(tv)):
            assert tv[i]["frame_id"] == jv[i]["frame_id"]
            np.testing.assert_array_equal(tv[i]["c2w"], jv[i]["c2w"])
        np.testing.assert_array_equal(np.asarray(tv.poses),
                                      np.asarray(jv.poses))
    v = td.slice(range(2, 6))
    both = v + v.remove([0])
    assert len(v) == 4 and v[0]["frame_id"] == 2
    assert len(both) == 7 and both[4]["frame_id"] == 3
    assert both[-1]["frame_id"] == 5
    assert v.H == td.H and both.W == td.W


def test_synthetic_frames_have_the_algebra():
    cfg = TS.make_synthetic_config("", "/tmp/unused", H=8, W=12, n_frames=4)
    data = TS.SyntheticFrames(cfg, 4)
    v = data.slice([3, 1]) + data.slice_except([0, 1, 2])
    assert [v[i]["frame_id"] for i in range(len(v))] == [3, 1, 3]
    assert v.H == 8


@pytest.mark.parametrize("gap_ratio", [0.5, 1.0, 3.0])
def test_predict_current_pose_matches_jax(gap_ratio):
    poses = make_trajectory(6, orbit_fraction=0.3)
    prev, prev_prev = poses[3], poses[1]
    got = TT.predict_current_pose(prev, prev_prev, True, gap_ratio=gap_ratio)
    want = JT.predict_current_pose(prev, prev_prev, True, gap_ratio=gap_ratio)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if gap_ratio == 1.0:
        delta = prev @ np.linalg.inv(prev_prev.astype(np.float64))
        np.testing.assert_array_equal(got,
                                      (delta @ prev).astype(np.float32))
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        TT.predict_current_pose(prev, None, True, gap_ratio), prev)
    np.testing.assert_array_equal(
        TT.predict_current_pose(prev, prev_prev, False, gap_ratio), prev)


def _edge_batch(H=24, W=32):
    """tests/test_tracking_info.py's blank scene with one edge."""
    rgb = np.full((H, W, 3), 0.5, np.float32)
    rgb[:, W // 2:, :] = 0.9
    depth = np.full((H, W), 2.0, np.float32)
    depth[:, W // 2:] = 1.0
    depth[3:5, 4:9] = 0.0                       # a hole: gray term only
    direction = np.dstack([np.zeros((H, W, 2), np.float32),
                           -np.ones((H, W, 1), np.float32)])
    return {"frame_id": 3, "rgb": rgb, "depth": depth,
            "direction": direction}


class _Fake:
    """Just enough of each package's CoSLAM for its tracking draw."""

    def __init__(self, cls, cfg, seed):
        self.config, self._seed, self.device = cfg, seed, torch.device("cpu")
        for name in ("_info_weights", "_sample_tracking_rays", "_draw_rays"):
            if hasattr(cls, name):
                setattr(self, name, getattr(cls, name).__get__(self))


def _scene_batch():
    cfg = TS.make_synthetic_config("", "/tmp/unused", H=40, W=52,
                                   n_frames=2)
    cam = cfg["cam"]
    args = (40, 52, cam["fx"], cam["fy"], cam["cx"], cam["cy"])
    pose = make_trajectory(4)[1]
    rgb, depth = TS.render_frame(TS.AnalyticScene(), pose, *args)
    return {"frame_id": 7, "rgb": rgb, "depth": depth,
            "direction": get_camera_rays(*args)}


@pytest.mark.parametrize("frac", [0.0, 0.5, 0.8])
@pytest.mark.parametrize("which", ["edge", "scene"])
def test_info_weighted_tracking_rays_match_jax(frac, which):
    """tracking.sample_info_frac: the port's tracking rays (the draw of
    np.random.default_rng((seed, frame id)).choice(..., p=p)) equal the
    JAX package's _sample_tracking_rays, and its weights the JAX
    _info_weights, exactly; frac 0 is the uniform draw."""
    cfg = TS.make_synthetic_config("", "/tmp/unused", H=24, W=32)
    cfg["tracking"].update(sample=128, ignore_edge_H=2, ignore_edge_W=3,
                           sample_info_frac=frac)
    batch = _edge_batch() if which == "edge" else _scene_batch()
    seed = 5
    got = _Fake(CoSLAM, cfg, seed)._sample_tracking_rays(dict(batch))
    want = _Fake(JCoSLAM, cfg, seed)._sample_tracking_rays(dict(batch))
    assert isinstance(got, torch.Tensor) and got.shape == (128, 7)
    np.testing.assert_array_equal(got.numpy(), want)
    if frac > 0:
        np.testing.assert_array_equal(
            _Fake(CoSLAM, cfg, seed)._info_weights(batch, 2, 3, frac),
            _Fake(JCoSLAM, cfg, seed)._info_weights(batch, 2, 3, frac))


def test_loop_takes_sample_info_frac_and_refuses_dp(small_seq,
                                                     monkeypatch):
    """The loop builds with tracking.sample_info_frac and with
    parallel.dp = 2 on CPU devices (every step split over both); what it
    refuses is a dp past the visible devices: dp = 3 with two CUDA
    devices visible raises ValueError before any device is touched, as
    the JAX package's _setup_meshes does."""
    cfg = copy.deepcopy(small_seq)
    cfg["tracking"]["sample_info_frac"] = 0.5
    CoSLAM(cfg, t_get_dataset(cfg), device="cpu")
    cfg["parallel"] = {"dp": 2}
    slam = CoSLAM(cfg, t_get_dataset(cfg), device="cpu")
    assert slam.map_devices == [torch.device("cpu")] * 2
    assert slam._ba.devices == slam.map_devices
    cfg["parallel"] = {"dp": 3}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match=r"parallel.dp=3 but only 2"):
        CoSLAM(cfg, t_get_dataset(cfg), device="cuda")


# -- the pipelined loop on the CPU -------------------------------------------


class _Owned(PipelinedCoSLAM):
    """Records every assignment of self.params with its thread."""

    writes = []

    @property
    def params(self):
        return self._params_box

    @params.setter
    def params(self, value):
        self.writes.append((threading.current_thread().name, id(value)))
        self._params_box = value


@pytest.fixture(scope="module")
def pipelined(small_seq):
    """One pipelined run at the scene's cadence (BA and a keyframe every 5
    frames), the periodic mesh and ATE every 5 frames (mesh.vis 5) and a
    checkpoint every 5 mapped frames, save_mesh's threads recorded."""
    cfg = copy.deepcopy(small_seq)
    cfg["data"]["exp_name"] = "torch_pipe"
    cfg["mesh"].update(vis=5, voxel_eval=0.12)
    _Owned.writes = []
    slam = _Owned(cfg, t_get_dataset(cfg), device="cpu")
    slam.mesh_threads = []
    save_mesh = slam.save_mesh

    def recorded(i, *args, **kwargs):
        slam.mesh_threads.append((i, threading.current_thread().name))
        return save_mesh(i, *args, **kwargs)

    slam.save_mesh = recorded
    res = slam.run(verbose=False, eval_ate=True, ckpt_every=5)
    return cfg, slam, res


def test_pipelined_slam(pipelined):
    """tests/test_pipeline_active.py's assertions: ATE < 0.08 m, at least
    two keyframes, the mapper at frame 10 or past it, the tracker at 11,
    every frame's pose written, a time for each of the 11 tracked frames
    and the end; the tracker never assigned self.params; a BA at each
    map_every frame (mapper_lag has one entry a BA call)."""
    cfg, slam, res = pipelined
    ate = res["absolute_translational_error.rmse"]
    assert np.isfinite(ate) and ate < 0.08
    assert list(slam.kf_db.frame_ids[:slam.kf_db.count]) == [0, 5, 10]
    assert slam.mapping_idx >= 10 and slam.tracking_idx == 11
    for i in range(12):
        assert np.any(slam.est_c2w[i]), i
    assert len(slam.frame_walls) == 12
    assert len(slam.mapper_lag) == len(slam.timings["mapping"]) == 2
    threads = {name for name, _ in _Owned.writes}
    assert "tracker" not in threads and "mapper" not in threads, threads
    assert id(slam.params) == _Owned.writes[-1][1]
    assert slam.thread_streams == {}             # no streams on the CPU
    assert {tag for *_, tag in slam.frame_events} >= {"ba", "keyframe",
                                                      "checkpoint",
                                                      "mesh_eval"}
    rep = TLat.attribute_tails(slam.frame_walls, slam.frame_events)
    assert rep["n_frames"] == 11


def test_pipelined_periodic_mesh_and_checkpoints(pipelined):
    """The mapper's periodic mesh and ATE at frames 5 and 10 from the mesh
    worker (tests/test_pipeline_active.py's test_pipelined_periodic_mesh),
    its checkpoints after mapping frames 5 and 10 (cursor + 1), the final
    checkpoint, mesh and ATE files; each checkpoint holds both
    generators' states."""
    cfg, slam, _ = pipelined
    out = os.path.join(cfg["data"]["output"], cfg["data"]["exp_name"])
    for f in ("checkpoint5.npz", "checkpoint10.npz", "checkpoint11.npz",
              "mesh_track5.ply", "mesh_track10.ply", "mesh_track11.ply",
              "output.txt", "output_relative.txt"):
        assert os.path.exists(os.path.join(out, f)), f
    assert slam.mesh_threads == [(5, "mesh-eval"), (10, "mesh-eval"),
                                 (11, "MainThread")]
    with open(os.path.join(out, "output.txt")) as f:
        assert len(f.read().splitlines()) == 3
    with np.load(os.path.join(out, "checkpoint5.npz")) as z:
        assert int(z["extra_frame_cursor"]) == 6
        assert "extra_torch_track_generator" in z.files
        assert not np.array_equal(z["extra_torch_track_generator"],
                                  z["extra_torch_generator"])


def test_pipelined_resume(pipelined):
    """load_checkpoint + run(start_frame=cursor) from the run's
    checkpoint5.npz: the restored poses of the frames before it that are
    not keyframes kept (BA moves the keyframes'), frames 6-11 tracked
    again, BA at frame 10 by the mapper, ATE < 0.08 m."""
    cfg0, _, _ = pipelined
    cfg = copy.deepcopy(cfg0)
    cfg["data"]["exp_name"] = "torch_pipe_resumed"
    cfg["mesh"]["vis"] = 0
    slam = PipelinedCoSLAM(cfg, t_get_dataset(cfg), device="cpu")
    out = os.path.join(cfg0["data"]["output"], cfg0["data"]["exp_name"])
    cursor = slam.load_checkpoint(os.path.join(out, "checkpoint5.npz"))
    assert cursor == 6
    restored = slam.est_c2w[1:5].copy()
    res = slam.run(verbose=False, mesh=False, start_frame=cursor)
    assert slam.tracking_idx == 11 and slam.mapping_idx >= 10
    assert len(slam.timings["mapping"]) == 1
    assert list(slam.kf_db.frame_ids[:slam.kf_db.count]) == [0, 5, 10]
    np.testing.assert_array_equal(slam.est_c2w[1:5], restored)
    assert res["absolute_translational_error.rmse"] < 0.08


def test_checkpoint_concurrent_rel_pose_writes(small_seq):
    """save_checkpoint copies est_c2w_rel under the pose lock while a
    thread inserts into it under the same lock, as the pipelined tracker
    does (tests/test_pipeline_active.py:284)."""
    cfg = copy.deepcopy(small_seq)
    cfg["data"]["exp_name"] = "torch_ckpt_race"
    slam = CoSLAM(cfg, t_get_dataset(cfg), device="cpu")
    for i in range(5000):
        slam.est_c2w_rel[i] = np.eye(4, dtype=np.float32)
    stop = threading.Event()

    def writer():
        i = 5000
        while not stop.is_set():
            with slam._pose_lock:
                slam.est_c2w_rel[i] = np.eye(4, dtype=np.float32)
            i += 1
            if i % 64 == 0:
                time.sleep(1e-4)    # lets the saves through, keeps it small

    t = threading.Thread(target=writer, name="tracker")
    t.start()
    out = os.path.join(cfg["data"]["output"], cfg["data"]["exp_name"])
    try:
        for k in range(10):
            slam.save_checkpoint(os.path.join(out, "race.npz"),
                                 frame_cursor=k, async_write=(k % 2 == 0))
            slam.convert_relative_pose()
        slam._ckpt_writer.wait()
    finally:
        stop.set()
        t.join()
    assert slam.load_checkpoint(os.path.join(out, "race.npz")) == 9
    assert len(slam.est_c2w_rel) >= 5000


class _Boom(RuntimeError):
    pass


@pytest.mark.parametrize("where", ["mapper", "tracker"])
def test_thread_exception_raised_by_run(small_seq, where):
    """An exception in either thread stops both and comes out of run()."""
    cfg = copy.deepcopy(small_seq)
    cfg["data"]["exp_name"] = f"torch_pipe_boom_{where}"
    cfg["mapping"]["first_iters"] = 2
    slam = PipelinedCoSLAM(cfg, t_get_dataset(cfg), device="cpu")
    seen = []
    if where == "mapper":
        def fail(batch, i):
            raise _Boom(f"BA at {i}")
        slam.global_BA = fail
    else:
        track = slam.tracking_render

        def fail(batch, i, **kwargs):
            seen.append(threading.current_thread().name)
            if i == 3:
                raise _Boom("tracking frame 3")
            return track(batch, i, **kwargs)
        slam.tracking_render = fail
    with pytest.raises(_Boom):
        slam.run(verbose=False, mesh=False)
    assert slam._stop
    if where == "mapper":
        assert slam.mapping_idx < 5 and slam.tracking_idx <= 7
    else:
        assert set(seen) == {"tracker"} and slam.tracking_idx == 2
        assert slam.mapping_idx < 10


# -- the CLI -------------------------------------------------------------------


def _yaml_config(tmp_path, cfg):
    import yaml

    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.mark.parametrize("flags,cls_name", [
    ([], "CoSLAM"), (["--pipelined"], "PipelinedCoSLAM"),
    (["--active"], "ActiveCoSLAM"), (["isActive"], "ActiveCoSLAM")])
def test_cli_picks_the_runtime(small_seq, tmp_path, monkeypatch, flags,
                               cls_name):
    """--pipelined runs PipelinedCoSLAM with --ckpt_every; --active (or
    active.isActive in the config) ActiveCoSLAM, --ckpt_every ignored;
    run() is recorded here, not run."""
    from coslam_torch import cli
    from coslam_torch.active.slam import ActiveCoSLAM

    cfg = copy.deepcopy(small_seq)
    cfg["data"]["output"] = str(tmp_path / "out")
    if flags == ["isActive"]:
        cfg["active"] = {"isActive": True}
        flags = []
    calls = []
    for cls in (CoSLAM, PipelinedCoSLAM, ActiveCoSLAM):
        monkeypatch.setattr(
            cls, "run", lambda self, **kw: calls.append(
                (type(self).__name__, kw)))
    cli.main(["--config", _yaml_config(tmp_path, cfg), "--device", "cpu",
              "--max_frames", "4", "--ckpt_every", "2", *flags])
    assert [c[0] for c in calls] == [cls_name]
    kw = calls[0][1]
    assert kw["n_frames"] == 4
    if cls_name == "ActiveCoSLAM":
        assert "ckpt_every" not in kw
    else:
        assert kw["ckpt_every"] == 2 and kw["start_frame"] == 0


def test_cli_active_and_pipelined_exclude_each_other(small_seq, tmp_path):
    from coslam_torch import cli

    cfg = copy.deepcopy(small_seq)
    cfg["active"] = {"isActive": True}
    with pytest.raises(SystemExit):
        cli.main(["--config", _yaml_config(tmp_path, cfg), "--device",
                  "cpu", "--pipelined"])
