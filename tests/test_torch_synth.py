"""The port's synthetic scenes, trajectories, sensor model, writers, device
tracer, protocol configs and in-memory route, against the JAX package's.

Sizes: 24x32 to 44x58 pixels, 4-6 frames (the walkthrough also at 200
poses, where its doorway phases start). Tolerances:
- scene methods on numpy arrays: bit for bit (the same numpy arithmetic);
  on torch tensors 1e-6 (sdf bit for bit: the port takes float64 square
  roots where torch's vectorized CPU sqrt is not correctly rounded;
  albedo and shade carry sin/atan2 last-bit differences);
- trajectories, interpolate_pose, the blur renderer, the noise values,
  the configs and the writers' directories (dataset_content_hash): equal;
- the noise's hole mask: at most 0.1 % of pixels apart (the bicubic
  resize is written in numpy; the JAX package calls cv2's);
- the device tracer on a CPU tensor against render_frame: depth and rgb
  1e-4 (measured: depth equal, rgb within 3e-7); a batch of frames
  traced together gives one call each's depth bit for bit and its rgb
  within 1e-6 (vectorized sin on tensors of another length);
- the memory route against the disk route through the port's loaders:
  depth, poses, frame ids and the camera model equal; color equal for
  PNG; for the JPEG colors of Replica and ScanNet, the disk route equals
  cv2's JPEG (quality 97) round trip of the memory route's uint8 frame
  bit for bit, so that loss is the only difference. Its size, measured on
  these frames: at most 0.27 of the [0, 1] range on a channel, mean
  0.016-0.025 (bound: 0.3 and 0.03); on a 120x160 frame of the room and
  the apartment at most 0.16 / 0.21, mean 0.0052 / 0.0061, and at
  480x640 mean 0.0024 / 0.0026 (chroma subsampling of the textures).
  With tools/disk_colors' decoded colors in place of its own, the memory
  route serves the disk route's frames bit for bit.
"""


import cv2
import numpy as np
import pytest
import torch

from coslam_tpu.data import synth as JS
from coslam_torch.data import synth as TS
from coslam_torch.data.datasets import get_dataset

H, W = 24, 32
CAM = (H, W, 0.8 * W, 0.8 * W, (W - 1) / 2.0, (H - 1) / 2.0)
JAX_SCENES = {"room": JS.AnalyticScene, "apartment": JS.AnalyticApartment,
              "thin": JS.AnalyticThinScene, "plain": JS.AnalyticPlainScene,
              "room2": JS.AnalyticRoom2, "corridor": JS.AnalyticCorridor}


@pytest.mark.parametrize("name", sorted(JAX_SCENES))
def test_scene_methods_match_jax(name):
    js, ts = JAX_SCENES[name](), TS.SCENES[name]()
    np.testing.assert_array_equal(ts.bound, js.bound)
    lo, hi = js.bound[:, 0], js.bound[:, 1]
    p = (lo + (hi - lo) * np.random.default_rng(0).uniform(
        size=(3000, 3))).astype(np.float32)
    for method in ("sdf", "albedo", "shade"):
        want = getattr(js, method)(p)
        got = getattr(ts, method)(p)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=method)
        on_torch = getattr(ts, method)(torch.from_numpy(p))
        assert on_torch.dtype == torch.float32
        np.testing.assert_allclose(on_torch.numpy(), want, rtol=0, atol=1e-6,
                                   err_msg=method)
    np.testing.assert_array_equal(
        ts.sdf(torch.from_numpy(p)).numpy(), js.sdf(p))


def test_trajectories_blur_and_interpolation_match_jax():
    np.testing.assert_array_equal(TS.make_scan_trajectory(6),
                                  JS.make_scan_trajectory(6))
    for seed in (0, 3):
        np.testing.assert_array_equal(TS.make_corridor_trajectory(6, seed),
                                      JS.make_corridor_trajectory(6, seed))
        np.testing.assert_array_equal(TS.make_handheld_trajectory(6, seed),
                                      JS.make_handheld_trajectory(6, seed))
        for n in (6, 200):
            np.testing.assert_array_equal(
                TS.make_walkthrough_trajectory(n, seed),
                JS.make_walkthrough_trajectory(n, seed))
    poses = JS.make_handheld_trajectory(5, 1)
    for u in (0.0, 0.3, 1.0, 1.4):
        np.testing.assert_array_equal(TS.interpolate_pose(poses[1], poses[2], u),
                                      JS.interpolate_pose(poses[1], poses[2], u))
    np.testing.assert_array_equal(TS.exposure_drift_walk(5, 0.05, 2),
                                  JS.exposure_drift_walk(5, 0.05, 2))
    scene = TS.AnalyticScene()
    render = lambda c2w: TS.render_frame(scene, c2w, *CAM)  # noqa: E731
    got = TS.make_blur_renderer(render, poses, 0.6, taps=4)
    want = JS.make_blur_renderer(render, poses, 0.6, taps=4)
    for i in (0, 2, 4):
        for a, b in zip(got(i), want(i)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hw", [(24, 32), (44, 58), (120, 160)])
def test_kinect_noise_matches_jax(hw):
    """The same draws give the same noise; the holes (gradient dropout and
    the bicubic speckle field) differ on at most 0.1 % of pixels; the
    numpy bicubic resize is cv2's INTER_CUBIC to 1e-5."""
    c2w = JS.make_scan_trajectory(3)[2]
    h, w = hw
    depth = JS.render_frame(JS.AnalyticScene(), c2w, h, w, 0.8 * w, 0.8 * w,
                            (w - 1) / 2, (h - 1) / 2)[1]
    for kw in ({}, {"hole_grad": np.inf, "speckle_frac": 0.0}):
        a = TS.add_kinect_noise(depth, np.random.default_rng(7), **kw)
        b = JS.add_kinect_noise(depth, np.random.default_rng(7), **kw)
        both = (a > 0) & (b > 0)
        np.testing.assert_array_equal(a[both], b[both])
        assert ((a == 0) != (b == 0)).mean() <= 1e-3
    field = np.random.default_rng(1).normal(
        size=(max(h // 24, 2), max(w // 24, 2))).astype(np.float32)
    np.testing.assert_allclose(
        TS.resize_cubic(field, (w, h)),
        cv2.resize(field, (w, h), interpolation=cv2.INTER_CUBIC), atol=1e-5)


def _write(mod, protocol, datadir, scene, poses, **kw):
    cfg_scale = {"replica": 6553.5, "tum": 5000.0, "scannet": 1000.0,
                 "rgbd": 1000.0}[protocol]
    if protocol == "replica":
        mod.write_replica_format(datadir, scene, poses, *CAM, **kw)
    elif protocol == "tum":
        mod.write_tum_format(datadir, scene, poses, *CAM,
                             png_depth_scale=cfg_scale, **kw)
    elif protocol == "scannet":
        mod.write_scannet_format(datadir, scene, poses, *CAM,
                                 png_depth_scale=cfg_scale, **kw)
    else:
        mod.write_rgbd_format(datadir, scene, poses, *CAM,
                              png_depth_scale=cfg_scale, **kw)


# (protocol, scene, writer keywords): every writer, and its perturbations.
WRITER_CASES = [
    ("replica", "room2", {}),
    ("replica", "room", {"exposure_drift": 0.05, "exposure_seed": 1}),
    ("tum", "room", {"seed": 2}),
    ("tum", "plain", {"motion_blur": 0.5, "blur_taps": 3}),
    ("scannet", "apartment", {"seed": 1}),
    ("rgbd", "thin", {"invalid": (2,)}),
]


def _poses(protocol, scene, seed=0, n=4):
    if protocol == "tum":
        return JS.make_handheld_trajectory(n, seed=seed)
    if protocol == "scannet":
        return JS.make_walkthrough_trajectory(n, seed=seed)
    return JS.make_scan_trajectory(n)


@pytest.mark.parametrize("protocol,scene,kw", WRITER_CASES,
                         ids=[f"{c[0]}-{c[1]}-{i}"
                              for i, c in enumerate(WRITER_CASES)])
def test_writers_match_jax(tmp_path, protocol, scene, kw):
    poses = _poses(protocol, scene, kw.get("seed", 0))
    _write(TS, protocol, str(tmp_path / "torch"), TS.SCENES[scene](), poses,
           device="cpu", **kw)
    _write(JS, protocol, str(tmp_path / "jax"), JAX_SCENES[scene](), poses,
           **kw)
    assert TS.dataset_content_hash(str(tmp_path / "torch")) == \
        JS.dataset_content_hash(str(tmp_path / "jax"))
    # The disk route's hash over every file, not every 7th.
    assert TS.dataset_content_hash(str(tmp_path / "torch"), 1) == \
        JS.dataset_content_hash(str(tmp_path / "jax"), 1)


def _config(protocol, datadir):
    if protocol == "tum":
        return TS.make_tum_synthetic_config(datadir, "o", H=H, W=W,
                                            n_frames=4)
    if protocol == "scannet":
        cfg = TS.make_scannet_synthetic_config(datadir, "o", H=H, W=W,
                                               n_frames=4)
        cfg["cam"]["crop_edge"] = 3
        return cfg
    if protocol == "rgbd":
        return TS.make_rgbd_synthetic_config(datadir, "o", H=H, W=W,
                                             n_frames=4)
    return TS.make_synthetic_config(datadir, "o", H=H, W=W, n_frames=4)


def _jpeg(rgb8):
    ok, buf = cv2.imencode(".jpg", cv2.cvtColor(rgb8, cv2.COLOR_RGB2BGR),
                           [cv2.IMWRITE_JPEG_QUALITY, 97])
    assert ok
    return cv2.cvtColor(cv2.imdecode(buf, cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB) / 255.0


@pytest.mark.parametrize("protocol,scene,kw", WRITER_CASES,
                         ids=[f"{c[0]}-{c[1]}-{i}"
                              for i, c in enumerate(WRITER_CASES)])
def test_memory_route_equals_disk_route(tmp_path, protocol, scene, kw):
    """SyntheticFrames(protocol=...) against the writer's files read by
    the port's loader, frame by frame."""
    seed = kw.get("seed", kw.get("exposure_seed", 0))
    poses = _poses(protocol, scene, seed)
    datadir = str(tmp_path / "scene")
    _write(TS, protocol, datadir, TS.SCENES[scene](), poses, device="cpu",
           **kw)
    cfg = _config(protocol, datadir)
    disk = get_dataset(cfg)
    mem = TS.SyntheticFrames(
        cfg, len(poses), protocol=protocol, scene=TS.SCENES[scene](),
        poses=poses, seed=seed, exposure_drift=kw.get("exposure_drift", 0.0),
        motion_blur=kw.get("motion_blur", 0.0),
        blur_taps=kw.get("blur_taps", 5), invalid=kw.get("invalid", ()),
        device="cpu")
    assert (mem.num_frames, mem.num_rays_to_save, mem.H, mem.W) == (
        disk.num_frames, disk.num_rays_to_save, disk.H, disk.W)
    assert (mem.fx, mem.fy, mem.cx, mem.cy) == (disk.fx, disk.fy, disk.cx,
                                                disk.cy)
    assert len(mem.poses) == len(disk.poses)
    for a, b in zip(mem.poses, disk.poses):
        np.testing.assert_array_equal(a, b)
    if protocol == "rgbd":
        assert mem.num_frames == len(poses) - 1
    jpeg = protocol in ("replica", "scannet")
    errs = []
    for i in range(disk.num_frames):
        a, b = mem[i], disk[i]
        assert a["frame_id"] == b["frame_id"]
        for key in ("c2w", "depth", "direction"):
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert a["rgb"].dtype == b["rgb"].dtype == np.float32
        if not jpeg:
            np.testing.assert_array_equal(a["rgb"], b["rgb"])
            continue
        ci = mem._pairs[mem.frame_ids[i]][0]
        rt = _jpeg(mem.frames[ci][0]).astype(np.float32)
        e = mem.crop
        if e:
            rt = rt[e:-e, e:-e]
        np.testing.assert_array_equal(b["rgb"], rt)
        errs.append(np.abs(a["rgb"] - b["rgb"]))
    if jpeg:
        err = np.stack(errs)
        assert 0 < err.max() <= 0.3 and err.mean() < 0.03, (err.max(),
                                                           err.mean())


@pytest.mark.parametrize("name", sorted(JAX_SCENES))
def test_device_tracer_matches_render_frame(name):
    """The tracer on tensors (here CPU tensors: the caller's device) against
    the numpy tracer, 44x58."""
    h, w = 44, 58
    cam = (h, w, 0.8 * w, 0.8 * w, (w - 1) / 2, (h - 1) / 2)
    scene = TS.SCENES[name]()
    poses = _poses("scannet" if name == "apartment" else "replica", name,
                   n=6)
    if name == "corridor":
        poses = TS.make_corridor_trajectory(6)
    tracer = TS.DeviceRenderer(scene, *cam, device="cpu")
    for (rgb, depth), c2w in zip(tracer.render_many(poses[::3]), poses[::3]):
        np.testing.assert_allclose(rgb, tracer(c2w)[0], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(depth, tracer(c2w)[1])
    for c2w in poses[::3]:
        rgb, depth = tracer(c2w)
        want_rgb, want_depth = TS.render_frame(scene, c2w, *cam)
        assert rgb.dtype == depth.dtype == np.float32
        np.testing.assert_allclose(depth, want_depth, rtol=0, atol=1e-4)
        np.testing.assert_allclose(rgb, want_rgb, rtol=0, atol=1e-4)


def test_make_renderer_takes_the_device_tracer_only_on_cuda():
    """The CPU gets the numpy tracer; a CUDA device with a big job gets the
    device tracer, which raises when there is no card (no fallback); a
    small job on CUDA keeps the host tracer, as the JAX package's rule."""
    scene = TS.AnalyticScene()
    c2w = TS.make_scan_trajectory(1)[0]
    cpu = TS.make_renderer(scene, *CAM, n_frames=None, device="cpu")
    assert not isinstance(cpu, TS.DeviceRenderer)
    for a, b in zip(cpu(c2w), TS.render_frame(scene, c2w, *CAM)):
        np.testing.assert_array_equal(a, b)
    small = TS.make_renderer(scene, *CAM, n_frames=10, device="cuda")
    assert not isinstance(small, TS.DeviceRenderer)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            TS.make_renderer(scene, *CAM, n_frames=None, device="cuda")


@pytest.mark.parametrize("tuned", [True, False])
def test_config_makers_match_jax(tuned):
    for name in ("tum", "scannet", "rgbd"):
        a = getattr(TS, f"make_{name}_synthetic_config")(
            "d", "o", H=48, W=64, n_frames=9, exp_name="x", tuned=tuned)
        b = getattr(JS, f"make_{name}_synthetic_config")(
            "d", "o", H=48, W=64, n_frames=9, exp_name="x", tuned=tuned)
        assert a == b, name
    assert TS.make_synthetic_config("d", "o", 48, 64, 9) == \
        JS.make_synthetic_config("d", "o", 48, 64, 9)


@pytest.mark.parametrize("protocol,scene", [("replica", "room"),
                                            ("scannet", "apartment")])
def test_disk_colors_make_the_memory_route_the_disk_routes(tmp_path,
                                                           protocol, scene):
    """tools/disk_colors: with the disk route's decoded JPEG colors in
    place of its own (replace_colors), the memory route serves the disk
    route's frames bit for bit."""
    from coslam_torch.tools import disk_colors

    npz = str(tmp_path / "c.npz")
    disk_colors.main(["--protocol", protocol, "--scene", scene, "--frames",
                      "4", "--hw", f"{H}x{W}", "--seed", "1", "--out", npz])
    from coslam_torch.tools.quality_bench import recipe_config

    datadir = str(tmp_path / "scene")
    cfg = recipe_config(protocol, datadir, "o", H, W, 4)
    poses = _poses(protocol, scene, seed=1)
    _write(TS, protocol, datadir, TS.SCENES[scene](), poses, device="cpu",
           **({"seed": 1} if protocol == "scannet" else {}))
    disk = get_dataset(cfg)
    mem = TS.SyntheticFrames(cfg, 4, protocol=protocol,
                             scene=TS.SCENES[scene](), poses=poses, seed=1,
                             device="cpu")
    with np.load(npz) as f:
        mem.replace_colors(f["rgb"])
    for i in range(disk.num_frames):
        for key in ("rgb", "depth", "c2w"):
            np.testing.assert_array_equal(mem[i][key], disk[i][key])
    with pytest.raises(ValueError):
        mem.replace_colors(np.zeros((4, H, W, 3), np.float32))
