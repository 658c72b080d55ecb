"""The port's tools against the JAX package's: viz, vis_cameras,
render_view, tsdf_fusion, export, process_realsense, virtual_cameras'
fusion route, and the loop's live view (mesh.visualisation).

Tolerances. colormap_image, frustum_corners, estimate_scene_bounds and
the live view's PNGs run the same numpy (and cv2) code on the same
inputs: equal. render_image: the same volume render in f32 on both sides
(JAX's hash encode against the port's plain version, each sample's
features within 1e-6, summed along the ray), so rgb within 1e-4 and depth
within 1e-4 m. fuse_frames: JAX fuses each voxel's camera transform into
FMAs where the port's eager update rounds each product, so a voxel whose
projection lies within f32 rounding of a pixel's .5 edge may read the
neighbouring pixel, and one within rounding of a mask's edge may flip its
weight. Off such ties (no projection within 1e-3 px of a .5 edge) the
same cells are observed and the TSDF agrees within 1e-6 m; over all
voxels at most TIE_SHARE differ. export: the program's output against
the JAX query_color_sdf within 1e-5 (one f32 forward).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from coslam_tpu.data.datasets import get_dataset as j_get_dataset
from coslam_tpu.data.synth import (AnalyticScene, make_synthetic_config,
                                   make_trajectory, render_frame,
                                   write_replica_format)
from coslam_tpu.eval.recon import accuracy, completion
from coslam_tpu.mesh.io import TriMesh as JTriMesh
from coslam_tpu.mesh.mcubes import marching_cubes as j_marching_cubes
from coslam_tpu.models.scene_rep import JointEncoding as JModel
from coslam_tpu.ops.rays import get_camera_rays
from coslam_tpu.runtime.checkpoint import save_ckpt as j_save_ckpt
from coslam_tpu.runtime.mapping import make_first_frame_step as j_first_step
from coslam_tpu.runtime.optim import make_map_optimizer as j_map_optimizer
from coslam_tpu.tools import render_view as j_render_view
from coslam_tpu.tools import tsdf_fusion as j_tsdf
from coslam_tpu.tools import vis_cameras as j_vis_cameras
from coslam_tpu.tools import viz as j_viz
from coslam_torch import convert
from coslam_torch.data.datasets import get_dataset as t_get_dataset
from coslam_torch.tools import export as t_export
from coslam_torch.tools import render_view as t_render_view
from coslam_torch.tools import tsdf_fusion as t_tsdf
from coslam_torch.tools import vis_cameras as t_vis_cameras
from coslam_torch.tools import viz as t_viz

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The share of voxels whose fused value may differ between the JAX update
# and the port's (a projection or a mask's edge within f32 rounding).
TIE_SHARE = 1e-3


def _write_scene(d, n_frames=6, H=24, W=32, first_iters=None):
    """A replica-layout scene of the analytic room on disk and its config
    (also written as YAML) -> (cfg, cfg_path)."""
    cfg = make_synthetic_config(str(d / "scene"), str(d / "out"), H=H, W=W,
                                n_frames=n_frames)
    if first_iters is not None:
        cfg["mapping"]["first_iters"] = first_iters
    cam = cfg["cam"]
    write_replica_format(cfg["data"]["datadir"], AnalyticScene(),
                         make_trajectory(n_frames), cam["H"], cam["W"],
                         cam["fx"], cam["fy"], cam["cx"], cam["cy"])
    path = str(d / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return cfg, path


# -- viz and vis_cameras ------------------------------------------------------


def test_colormap_image_matches_jax():
    """Equal to the JAX function: turbo from the port's own table (the
    card's machine has no matplotlib), another colormap from matplotlib."""
    rng = np.random.default_rng(0)
    img = rng.uniform(0.2, 4.0, (12, 17)).astype(np.float32)
    mask = rng.uniform(size=img.shape) > 0.3
    for kw in ({}, {"mask_hw": mask, "invalid_color": (1.0, 1.0, 1.0)},
               {"vmin": 1.0, "vmax": 2.0, "flip": False},
               {"colormap": "viridis"}):
        got = t_viz.colormap_image(img, **kw)
        assert got.dtype == np.float32 and got.shape == (12, 17, 3)
        np.testing.assert_array_equal(got, j_viz.colormap_image(img, **kw))


def test_frustum_corners_match_jax():
    for c2w in make_trajectory(5, orbit_fraction=0.3):
        np.testing.assert_array_equal(
            t_vis_cameras.frustum_corners(c2w, 0.2),
            j_vis_cameras.frustum_corners(c2w, 0.2))


def test_estimate_scene_bounds_and_plot_cameras(tmp_path):
    """estimate_scene_bounds over the port's loader equals the JAX
    function over the JAX loader; plot_cameras writes a PNG."""
    cfg, cfg_path = _write_scene(tmp_path, n_frames=6, H=40, W=52)
    ds = t_get_dataset(cfg)
    for got, want in zip(t_viz.estimate_scene_bounds(ds, every=2),
                         j_viz.estimate_scene_bounds(j_get_dataset(cfg),
                                                     every=2)):
        np.testing.assert_array_equal(got, want)
    assert np.array_equal(t_viz.main(["--config", cfg_path])[0],
                          t_viz.estimate_scene_bounds(ds)[0])
    out = str(tmp_path / "cams.png")
    poses = [ds[i]["c2w"] for i in range(len(ds))]
    t_vis_cameras.plot_cameras(poses, bounds=np.array(cfg["mapping"]["bound"]),
                               gt_poses=poses, save_path=out)
    assert os.path.getsize(out) > 1000


# -- render_view --------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A JAX map trained on frame 0 of a replica-layout scene at its GT
    pose (tests/test_render_view.py's fixture), saved as the JAX package's
    checkpoint with frame 0 tracked and frames 1-3 not."""
    d = tmp_path_factory.mktemp("trv")
    cfg, cfg_path = _write_scene(d, n_frames=4, first_iters=150)
    cfg["training"]["perturb"] = 0.0
    cam = cfg["cam"]
    bb = np.array(cfg["mapping"]["bound"], np.float32)
    model = JModel(cfg, bb)
    params = model.init_params(jax.random.PRNGKey(0))
    tx = j_map_optimizer(cfg)
    pose0 = make_trajectory(4)[0]
    rgb, depth = render_frame(AnalyticScene(), pose0, cam["H"], cam["W"],
                              cam["fx"], cam["fy"], cam["cx"], cam["cy"])
    dirs = get_camera_rays(cam["H"], cam["W"], cam["fx"], cam["fy"],
                           cam["cx"], cam["cy"])
    frame = np.concatenate([dirs.reshape(-1, 3), rgb.reshape(-1, 3),
                            depth.reshape(-1, 1)], 1).astype(np.float32)
    step = j_first_step(model, cfg, tx, cam["H"], cam["W"])
    params, _, _, _ = step(params, tx.init(params), jnp.asarray(pose0),
                           jnp.asarray(frame), jax.random.PRNGKey(1))
    est = np.zeros((4, 4, 4), np.float32)
    est[0] = pose0
    ckpt = str(d / "ck.npz")
    j_save_ckpt(ckpt, params, est, {})
    return cfg, cfg_path, ckpt, model, params, pose0, depth


@pytest.mark.parametrize("use_depth", [False, True])
def test_render_image_matches_jax(jax_ckpt, use_depth):
    """The port's render_image on the JAX checkpoint's parameters (read
    by the port's loader) against the JAX render_image: rgb and depth
    within 1e-4 (f32), in chunks that do not divide the image."""
    cfg, _, ckpt, jmodel, jparams, pose0, depth = jax_ckpt
    cam = cfg["cam"]
    args = (pose0, cam["H"], cam["W"], cam["fx"], cam["fy"], cam["cx"],
            cam["cy"])
    td = depth if use_depth else None
    j_rgb, j_depth = j_render_view.render_image(jmodel, jparams, *args,
                                                target_d=td, chunk=200)
    model = t_render_view.make_model(cfg, "cpu")
    params, est = t_render_view.load_params(model, ckpt, "cpu")
    np.testing.assert_array_equal(est[0], pose0)
    rgb, d = t_render_view.render_image(model, params, *args, target_d=td,
                                        chunk=200, device="cpu")
    assert rgb.shape == (cam["H"], cam["W"], 3) and d.shape == depth.shape
    np.testing.assert_allclose(rgb, np.asarray(j_rgb), atol=1e-4)
    np.testing.assert_allclose(d, np.asarray(j_depth), atol=1e-4)


def test_render_view_cli(jax_ckpt, tmp_path, capsys):
    """--pose (no dataset needed), --frame --compare (one JSON line with
    PSNR and depth-L1 against the frame on disk) and the refusal of an
    untracked frame."""
    cfg, cfg_path, ckpt, _, _, pose0, _ = jax_ckpt
    pose_path = str(tmp_path / "pose.txt")
    np.savetxt(pose_path, pose0)
    res = t_render_view.main(["--config", cfg_path, "--ckpt", ckpt,
                              "--pose", pose_path, "--out",
                              str(tmp_path / "r.png"), "--chunk", "256",
                              "--device", "cpu"])
    assert os.path.exists(res["png"]) and os.path.exists(res["depth_png"])
    assert res["rgb"].shape == (cfg["cam"]["H"], cfg["cam"]["W"], 3)
    capsys.readouterr()
    res = t_render_view.main(["--config", cfg_path, "--ckpt", ckpt,
                              "--frame", "0", "--compare", "--use_depth",
                              "--out", str(tmp_path / "f.png"),
                              "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["frame"] == 0 and np.isfinite(line["psnr"])
    assert np.isfinite(line["depth_l1"]) and res["psnr"] > 15.0
    with pytest.raises(SystemExit):
        t_render_view.main(["--config", cfg_path, "--ckpt", ckpt,
                            "--frame", "2", "--device", "cpu"])


# -- tsdf_fusion --------------------------------------------------------------

H, W, FX = 60, 80, 56.0
CX, CY = (W - 1) / 2, (H - 1) / 2
VOX = 0.06
TRUNC = 4 * VOX
BOUNDS = np.array([[-2.2, 2.2]] * 3, np.float32)


@pytest.fixture(scope="module")
def fused_pair():
    """tests/test_tsdf_fusion.py's 24-frame orbit fused by both packages
    (the port in x-slabs of a few planes, so the slab loop runs)."""
    scene = AnalyticScene()
    poses = make_trajectory(24)
    frames = [render_frame(scene, p, H, W, FX, FX, CX, CY) for p in poses]
    depths, rgbs = [d for _, d in frames], [r for r, _ in frames]
    want = j_tsdf.fuse_frames(depths, poses, FX, FX, CX, CY, BOUNDS, VOX,
                              TRUNC, rgbs=rgbs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_tsdf, "SLAB_CELLS", 5 * 74 * 74)
        got = t_tsdf.fuse_frames(depths, poses, FX, FX, CX, CY, BOUNDS, VOX,
                                 TRUNC, rgbs=rgbs, device="cpu")
    return scene, poses, frames, got, want


def _near_ties(poses, axes, eps=1e-3):
    """Voxels whose projection into some frame, in front of the camera
    and inside the image, lies within eps px of a pixel's .5 edge (in
    float64)."""
    tx, ty, tz = (a.astype(np.float64) for a in axes)
    pts = np.stack(np.meshgrid(tx, ty, tz, indexing="ij"), -1)
    near = np.zeros(pts.shape[:3], bool)
    for c2w in poses:
        cv = np.asarray(c2w, np.float64).copy()
        cv[:3, 1] *= -1
        cv[:3, 2] *= -1
        w2c = np.linalg.inv(cv)
        cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
        z = np.maximum(cam[..., 2], 1e-9)
        u = FX * cam[..., 0] / z + CX
        v = FX * cam[..., 1] / z + CY
        seen = ((cam[..., 2] > 0) & (u >= -1) & (u <= W) & (v >= -1)
                & (v <= H))
        for p in (u, v):
            near |= seen & (np.abs(p - np.floor(p) - 0.5) < eps)
    return near


def test_fuse_frames_matches_jax(fused_pair):
    """The volumes against the JAX package's: off rounding ties the same
    cells observed (weight > 0) and the TSDF and colors within 1e-6; over
    all voxels, ties included, at most TIE_SHARE differ (none on this
    orbit: the largest difference is 4.8e-7 m); unobserved cells at
    exactly +trunc."""
    _, poses, _, got, want = fused_pair
    vol, color, axes = got
    j_vol, j_color, j_axes = want
    for a, b in zip(axes, j_axes):
        np.testing.assert_array_equal(a, b)
    assert vol.shape == j_vol.shape and color.shape == j_color.shape
    assert np.isfinite(vol).all()
    off = ~_near_ties(poses, axes)
    obs, j_obs = vol != np.float32(TRUNC), j_vol != np.float32(TRUNC)
    np.testing.assert_array_equal(obs[off], j_obs[off])
    assert (obs & off).sum() > 1000
    np.testing.assert_allclose(vol[off], j_vol[off], atol=1e-6)
    np.testing.assert_allclose(color[off], j_color[off], atol=1e-6)
    differ = (obs != j_obs) | (np.abs(vol - j_vol) > 1e-6)
    assert differ.mean() <= TIE_SHARE, differ.mean()
    assert (vol == np.float32(TRUNC)).sum() > 0
    np.testing.assert_array_equal(vol[~obs], np.float32(TRUNC))


def _gt_mesh(scene, n=96):
    ax = np.linspace(-2.2, 2.2, n).astype(np.float32)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    sdf = scene.sdf(np.stack([X, Y, Z], -1)).astype(np.float32)
    v, f = j_marching_cubes(sdf, 0.0, truncation=3.0)
    return JTriMesh(v * (4.4 / (n - 1)) - 2.2, f)


def test_fused_mesh_acc_comp(fused_pair):
    """tests/test_tsdf_fusion.py's bounds on the port's mesh: accuracy <
    VOX, observed-region completion < 2 VOX, vertex colors in [0, 1]."""
    scene, _, _, (vol, color, axes), _ = fused_pair
    mesh = t_tsdf.tsdf_mesh(vol, axes, TRUNC, color)
    assert len(mesh.vertices) > 500
    rng = np.random.default_rng(0)
    rec_pc = mesh.sample_surface(50000, rng)
    gt_pc = _gt_mesh(scene).sample_surface(50000, rng)
    acc = accuracy(gt_pc, rec_pc)
    assert acc < VOX, acc
    lo = np.array([a[0] for a in axes])
    idx = np.clip(np.round((gt_pc - lo) / VOX).astype(int), 0,
                  np.array(vol.shape) - 1)
    seen = np.abs(vol[idx[:, 0], idx[:, 1], idx[:, 2]]) < 0.99 * TRUNC
    assert seen.sum() > 5000
    assert completion(gt_pc[seen], rec_pc) < 2 * VOX
    assert mesh.vertex_colors is not None
    assert 0.0 <= mesh.vertex_colors.min() <= mesh.vertex_colors.max() <= 1.0


def test_tsdf_and_virtual_cameras_cli(tmp_path):
    """tsdf_fusion's CLI writes a mesh; virtual_cameras without --gt_mesh
    fuses the dataset's raw RGB-D first, saves it (--save_fused) and
    writes its cameras and MANIFEST."""
    from coslam_torch.mesh.io import load_ply
    from coslam_torch.tools import virtual_cameras as t_vc

    cfg, cfg_path = _write_scene(tmp_path, n_frames=6, H=40, W=52)
    out = str(tmp_path / "fused.ply")
    mesh = t_tsdf.main(["--config", cfg_path, "--out", out,
                        "--voxel_size", "0.1", "--device", "cpu"])
    assert len(mesh.vertices) > 100 and os.path.exists(out)
    vc_dir = str(tmp_path / "vc")
    fused = str(tmp_path / "vc_fused.ply")
    chosen = t_vc.main(["--config", cfg_path, "--out_dir", vc_dir,
                        "--save_fused", fused, "--voxel_size", "0.1",
                        "--every", "2", "--n_candidates", "12",
                        "--n_select", "3", "--device", "cpu"])
    assert len(load_ply(fused).vertices) > 100
    assert 1 <= len(chosen) <= 3
    assert t_vc.read_manifest(vc_dir)["SELECTED"] == str(len(chosen))
    for i in range(len(chosen)):
        assert np.loadtxt(os.path.join(vc_dir, f"{i}.txt")).shape == (4, 4)


# -- export -------------------------------------------------------------------


def test_export_cli_matches_jax(tmp_path, capsys):
    """The export CLI at fr1_desk's config, --batch 256 --device cpu: the
    line ends finite=True, and the loaded program's output equals the JAX
    query_color_sdf on the same parameters (converted) within 1e-5."""
    from coslam_torch.config import load_config

    out = str(tmp_path / "m.pt2")
    cfg_path = os.path.join(REPO, "configs/Tum/fr1_desk.yaml")
    got = t_export.main(["--config", cfg_path, "--batch", "256",
                         "--device", "cpu", "--out", out])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("exported ") and line.endswith("finite=True")
    assert "roundtrip output (256, 4)" in line
    cfg = load_config(cfg_path)
    tmodel = t_render_view.make_model(cfg, "cpu")
    tparams = tmodel.init_params(torch.Generator().manual_seed(0))
    jmodel = JModel(cfg, np.array(cfg["mapping"]["bound"], np.float32))
    jparams = jax.tree_util.tree_map(jnp.asarray,
                                     convert.params_to_numpy(tparams))
    x = torch.linspace(0.1, 0.9, 256 * 3).reshape(256, 3).numpy()
    want = np.asarray(jmodel.query_color_sdf(jparams, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    loaded = torch.export.load(out).module()
    np.testing.assert_array_equal(loaded(torch.from_numpy(x)).numpy(),
                                  got.numpy())


def test_custom_op_traces_and_matches_plain(tmp_path):
    """kernel A's operator, torch.ops.coslam_torch.grid_encode_fwd, goes
    through torch.export as one node of the program (its fake gives the
    [N, L F] shape), and the saved and loaded program computes the plain
    version's values (the operator's CPU route)."""
    from coslam_torch.ops import hash_packed as HP

    spec = HP.make_packed_spec(32, 12)
    table = HP.init_packed(spec, torch.Generator().manual_seed(0))
    x = torch.rand((64, 3), generator=torch.Generator().manual_seed(1))

    class Enc(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.register_buffer("table", table)

        def forward(self, x):
            return torch.ops.coslam_torch.grid_encode_fwd(
                self.table, x, HP.spec_ints(spec))

    program = torch.export.export(Enc(), (x,), strict=False)
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert "coslam_torch.grid_encode_fwd.default" in targets, targets
    path = str(tmp_path / "enc.pt2")
    torch.export.save(program, path)
    out = torch.export.load(path).module()(x)
    assert out.shape == (64, spec.out_dim)
    np.testing.assert_array_equal(out.numpy(),
                                  HP.grid_encode_fwd_ref(spec, table,
                                                         x).numpy())


# -- process_realsense --------------------------------------------------------


def test_process_realsense_gated_and_cli(tmp_path):
    from coslam_torch.tools.process_realsense import process_bag

    try:
        import pyrealsense2  # noqa: F401
        has_rs = True
    except ImportError:
        has_rs = False
    if not has_rs:
        with pytest.raises(ImportError, match="pyrealsense2 is required"):
            process_bag(str(tmp_path / "cap.bag"), str(tmp_path / "out"))
    proc = subprocess.run(
        [sys.executable, "-m", "coslam_torch.tools.process_realsense"],
        capture_output=True, text=True, cwd=REPO)
    assert proc.returncode == 2
    assert "--bag" in proc.stderr and "--out" in proc.stderr


# -- the loop's live view -----------------------------------------------------


def test_visualisation_writes_the_jax_png_trail(tmp_path):
    """mesh.visualisation on a 3-frame run: vis/rgbd_00000.png ...
    rgbd_00002.png, each with the pixels the JAX visualise_frame writes
    for the same frame."""
    import cv2

    from coslam_tpu.runtime.slam import CoSLAM as JCoSLAM
    from coslam_torch.runtime.slam import CoSLAM

    cfg, _ = _write_scene(tmp_path, n_frames=3, H=24, W=32, first_iters=10)
    cfg["mesh"].update(visualisation=True, vis=0)
    cfg["tracking"].update(iter=2, sample=64)
    cfg["mapping"].update(iters=2, sample=64)
    ds = t_get_dataset(cfg)
    slam = CoSLAM(cfg, ds, device="cpu")
    slam.run(verbose=False, eval_ate=False, mesh=False)
    out = os.path.join(cfg["data"]["output"], cfg["data"]["exp_name"])

    class _Cfg:
        config = cfg

    ref = str(tmp_path / "ref")
    for i in range(3):
        path = os.path.join(out, "vis", f"rgbd_{i:05d}.png")
        want = JCoSLAM.visualise_frame(_Cfg(), ds[i], i, ref)
        np.testing.assert_array_equal(cv2.imread(path), cv2.imread(want))
    assert sorted(os.listdir(os.path.join(out, "vis"))) == [
        f"rgbd_{i:05d}.png" for i in range(3)]
