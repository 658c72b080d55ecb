"""The port's evaluation tooling against the JAX package's: the native
depth rasterizer, PLY import and surface sampling, the 3D and 2D
reconstruction metrics, the Co-SLAM mesh culling and the virtual cameras
(with the port's MANIFEST and its regeneration rule).

Sizes: analytic-room meshes from 36-48 grid points a side, 24x32 and
44x58 cameras, 3-4 eval views of 500x500. Tolerance 0 against the JAX
package (the same C++ rasterizer, the same numpy and scipy calls with the
same seeded draws): equal numbers and equal files. The C++ rasterizer
against its plain numpy version: depth 1e-4 m where both hit, and at most
0.5 % of pixels covered by one only (triangle edges: float32 against
float64 coverage tests).
"""

import os

import numpy as np
import pytest

from coslam_tpu.eval import cull as JC
from coslam_tpu.eval import recon as JR
from coslam_tpu.mesh import io as JIO
from coslam_tpu.mesh import raster as JRA
from coslam_tpu.tools import virtual_cameras as JV
from coslam_torch.data import synth as TS
from coslam_torch.eval import benchmark as TB
from coslam_torch.eval import cull as TC
from coslam_torch.eval import recon as TR
from coslam_torch.mesh import io as TIO
from coslam_torch.mesh import mcubes as TM
from coslam_torch.mesh import raster as TRA
from coslam_torch.tools import virtual_cameras as TV

H, W = 24, 32
CAM = dict(fx=0.8 * W, fy=0.8 * W, cx=(W - 1) / 2.0, cy=(H - 1) / 2.0, H=H,
           W=W)


def scene_mesh(n: int, shift=0.0) -> TIO.TriMesh:
    """The analytic room's mesh from an n^3 grid over its bound."""
    ax = np.linspace(-2.2, 2.2, n).astype(np.float32)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    sdf = TS.AnalyticScene().sdf(np.stack([X, Y, Z], -1) - shift)
    v, f = TM.marching_cubes(sdf.astype(np.float32), 0.0, truncation=3.0)
    return TIO.TriMesh(v * (4.4 / (n - 1)) - 2.2, f)


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    d = tmp_path_factory.mktemp("meshes")
    gt, rec = str(d / "gt.ply"), str(d / "rec.ply")
    scene_mesh(48).export(gt)
    scene_mesh(40, shift=0.01).export(rec)
    return gt, rec


def test_render_depth_matches_jax_and_plain(meshes):
    mesh = TIO.load_ply(meshes[0])
    for c2w in TS.make_scan_trajectory(9)[::4]:
        w2c = TRA.opengl_to_opencv_w2c(c2w)
        np.testing.assert_array_equal(w2c, JRA.opengl_to_opencv_w2c(c2w))
        args = (mesh.vertices, mesh.faces, w2c, 35.0, 35.0, 28.5, 21.5, 44,
                58)
        got = TRA.render_depth(*args)
        np.testing.assert_array_equal(got, JRA.render_depth(*args))
        plain = TRA._render_depth_numpy(*args)
        both = (got > 0) & (plain > 0)
        assert both.mean() > 0.9
        np.testing.assert_allclose(got[both], plain[both], rtol=0, atol=1e-4)
        assert ((got > 0) != (plain > 0)).mean() <= 5e-3


def test_render_depth_raises_without_the_native_library(tmp_path,
                                                        monkeypatch):
    """No numpy fallback: a failed build of the native library raises."""
    monkeypatch.setattr(TM, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(TM, "GXX_FLAGS", ("-no-such-flag",))
    TM.library.cache_clear()
    TRA._raster_fn.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            TRA.render_depth(np.zeros((3, 3), np.float32),
                             np.array([[0, 1, 2]]), np.eye(4, dtype=np.float32),
                             10.0, 10.0, 4.0, 4.0, 8, 8)
    finally:
        TM.library.cache_clear()
        TRA._raster_fn.cache_clear()


def test_ply_io_normals_and_sampling_match_jax(tmp_path, meshes):
    a, b = TIO.load_ply(meshes[0]), JIO.load_ply(meshes[0])
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)
    np.testing.assert_array_equal(a.vertex_normals, b.vertex_normals)
    np.testing.assert_array_equal(
        a.sample_surface(500, np.random.default_rng(3)),
        b.sample_surface(500, np.random.default_rng(3)))
    np.testing.assert_array_equal(a.sample_surface(50), b.sample_surface(50))
    # Colors and unreferenced vertices.
    cols = np.random.default_rng(0).uniform(size=(len(a.vertices), 3))
    sub = TIO.TriMesh(a.vertices, a.faces[::3], cols)
    jsub = JIO.TriMesh(b.vertices, b.faces[::3], cols)
    sub.remove_unreferenced_vertices()
    jsub.remove_unreferenced_vertices()
    np.testing.assert_array_equal(sub.vertices, jsub.vertices)
    np.testing.assert_array_equal(sub.faces, jsub.faces)
    sub.export(str(tmp_path / "c.ply"))
    jsub.export(str(tmp_path / "j.ply"))
    with open(tmp_path / "c.ply", "rb") as f1, open(tmp_path / "j.ply",
                                                    "rb") as f2:
        assert f1.read() == f2.read()
    got, want = TIO.load_ply(str(tmp_path / "c.ply")), JIO.load_ply(
        str(tmp_path / "c.ply"))
    np.testing.assert_array_equal(got.vertex_colors, want.vertex_colors)
    # An ascii file.
    ascii_ply = tmp_path / "a.ply"
    ascii_ply.write_text(
        "ply\nformat ascii 1.0\nelement vertex 3\nproperty float x\n"
        "property float y\nproperty float z\nproperty uchar red\n"
        "property uchar green\nproperty uchar blue\nelement face 1\n"
        "property list uchar int vertex_indices\nend_header\n"
        "0 0 0 255 0 0\n1 0 0 0 255 0\n0 1 0 0 0 255\n3 0 1 2\n")
    got, want = TIO.load_ply(str(ascii_ply)), JIO.load_ply(str(ascii_ply))
    for key in ("vertices", "faces", "vertex_colors"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))


def test_metrics_match_jax(tmp_path, meshes):
    gt, rec = meshes
    for align in (False, True):
        assert TR.calc_3d_metric(rec, gt, align=align, n_samples=20000) == \
            JR.calc_3d_metric(rec, gt, align=align, n_samples=20000)
    unseen = str(tmp_path / "unseen.npy")
    np.save(unseen, TIO.load_ply(gt).vertices[::50])
    for pcd in (None, unseen):
        got = TR.calc_2d_metric(rec, gt, unseen_gt_pcd_file=pcd, align=False,
                                n_imgs=3, seed=1)
        want = JR.calc_2d_metric(rec, gt, unseen_gt_pcd_file=pcd, align=False,
                                 n_imgs=3, seed=1)
        assert got == want and got["n_views"] == 3
    mesh = TIO.load_ply(gt)
    a = TR.sample_eval_poses(mesh, None, 5, 500, 500, 300, 300, 249.5, 249.5,
                             seed=4)
    b = JR.sample_eval_poses(mesh, None, 5, 500, 500, 300, 300, 249.5, 249.5,
                             seed=4)
    np.testing.assert_array_equal(np.stack(a), np.stack(b))


def _cfg(datadir):
    cfg = TS.make_synthetic_config(datadir, "o", H=H, W=W, n_frames=6)
    return cfg


def test_cull_one_mesh_matches_jax(tmp_path, meshes):
    gt, rec = meshes
    poses = list(TS.make_scan_trajectory(12)[::2])
    vdir = tmp_path / "vcams"
    vdir.mkdir()
    for i, c2w in enumerate(TS.make_scan_trajectory(40)[30:32]):
        np.savetxt(vdir / f"{i}.txt", c2w)
    bounds = np.array(_cfg("")["mapping"]["marching_cubes_bound"])
    for kw in ({"remove_occlusion": False},
               {"remove_occlusion": True, "virtual_cameras": True,
                "virt_cam_path": str(vdir), "save_unseen": True,
                "scene_bounds": np.stack([bounds[:, 0], bounds[:, 1]])}):
        outs = []
        for mod, name in ((TC, "t"), (JC, "j")):
            d = tmp_path / f"{name}{len(kw)}"
            d.mkdir()
            mod.cull_one_mesh(_cfg(""), poses, rec, str(d / "mesh_culled.ply"),
                              **kw)
            outs.append({f: (d / f).read_bytes()
                         for f in sorted(os.listdir(d))})
        assert outs[0] == outs[1] and len(outs[0]) == (
            3 if kw.get("save_unseen") else 1)


def test_create_virtual_cameras_matches_jax(tmp_path, meshes):
    """The same cameras and {i}.txt files as the JAX package's; the port
    adds its MANIFEST."""
    mesh = TIO.load_ply(meshes[0])
    traj = [TS.make_scan_trajectory(3)[0]]
    kw = dict(fx=35.0, fy=35.0, cx=28.5, cy=21.5, H=44, W=58,
              n_candidates=12, n_select=4, seed=2)
    got = TV.create_virtual_cameras(mesh, traj, str(tmp_path / "t"), **kw)
    want = JV.create_virtual_cameras(JIO.load_ply(meshes[0]), traj,
                                     str(tmp_path / "j"), **kw)
    assert len(got) == len(want) >= 1
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    files = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == sorted(files + ["MANIFEST"])
    for f in files:
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes()
    assert TV.read_manifest(str(tmp_path / "t")) == {
        "SOURCE": "gt-traj", "SELECTED": str(len(got)), "CANDIDATES": "12",
        "SEED": "2"}


def test_virtual_cameras_manifest_with_zero_selected(tmp_path, meshes):
    """A set of zero cameras still gets its MANIFEST, and the cull then
    reads no camera from the directory."""
    out = str(tmp_path / "v")
    chosen = TV.create_virtual_cameras(TIO.load_ply(meshes[0]), [], out,
                                       **CAM, n_candidates=0, n_select=4)
    assert chosen == []
    assert TV.read_manifest(out)["SELECTED"] == "0"
    assert TC.load_virt_cam_poses(out) == []


def test_benchmark_regenerates_cameras_without_a_manifest(tmp_path, meshes,
                                                          capsys):
    """ensure_virtual_cameras: a directory without a MANIFEST (a stale
    set) or with another source is cleared and made anew from the GT
    trajectory, and the count is logged; a gt-traj set is kept."""
    gt = meshes[0]
    cfg = _cfg(str(tmp_path))
    vdir = tmp_path / "virtual_cameras"
    vdir.mkdir()
    for i in range(5):
        np.savetxt(vdir / f"{i}.txt", np.eye(4))
    traj = list(TS.make_scan_trajectory(4))
    count = TB.ensure_virtual_cameras(cfg, gt, traj)
    log = capsys.readouterr().out
    assert "no manifest" in log and "5 stale removed" in log
    assert f"made {count}" in log
    assert len(TC.load_virt_cam_poses(str(vdir))) == count
    assert TV.read_manifest(str(vdir))["SOURCE"] == "gt-traj"
    made = sorted(os.listdir(vdir))

    assert TB.ensure_virtual_cameras(cfg, gt, traj) == count
    assert f"virtual cameras: {count} from" in capsys.readouterr().out
    assert sorted(os.listdir(vdir)) == made

    (vdir / "MANIFEST").write_text("SOURCE: est-traj\nSELECTED: 9\n")
    assert TB.ensure_virtual_cameras(cfg, gt, traj) == count
    assert "source est-traj" in capsys.readouterr().out
