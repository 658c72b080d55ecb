"""The port stands alone: a fresh import of every coslam_torch module and
of chip_smoke.py loads nothing of the JAX package and no jax (the
checkpoint module, which reads the JAX package's files, unpickles
nothing of them either); chip_smoke.py imports, and the quality harness
and the in-memory route of every protocol run, with cv2, PIL and yaml
blocked (the smoke's TUM slice alone writes and reads PNG files, through
cv2); and the
port's own copies of the JAX package's framework-neutral modules
(config, rays, the synthetic scene, the dataset loaders, ATE, marching
cubes) compute what the originals do.

Tolerance: none. The copies run the same numpy arithmetic in the same
order (and the same C++ for marching cubes, built with the same flags),
so frames, poses, configs, ATE statistics and meshes are equal bit for
bit.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from coslam_tpu.config import load_config as j_load_config
from coslam_tpu.data import synth as JS
from coslam_tpu.data.datasets import get_dataset as j_get_dataset
from coslam_tpu.eval import ate as JA
from coslam_tpu.mesh.mcubes import marching_cubes as j_marching_cubes
from coslam_tpu.ops import rays as JR
from coslam_torch import config as TC
from coslam_torch.data import synth as TS
from coslam_torch.data.datasets import get_dataset as t_get_dataset
from coslam_torch.eval import ate as TA
from coslam_torch.mesh import mcubes as TM
from coslam_torch.ops import rays as TR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_nothing_of_the_jax_package():
    """Every module of coslam_torch (but ``__main__``, which runs the CLI
    when imported and imports only ``cli``) and chip_smoke, imported in a
    fresh process: no coslam_tpu* and no jax* module in sys.modules."""
    code = """
import importlib, pkgutil, sys
import coslam_torch
names = [m.name for m in pkgutil.walk_packages(coslam_torch.__path__,
                                               "coslam_torch.")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("coslam_tpu", "jax", "jaxlib"))
assert not bad, bad
assert "coslam_torch.tools.bench._bench_run_merge" in names, names
assert "coslam_torch.runtime.checkpoint" in names, names
for new in ("mesh.raster", "eval.recon", "eval.cull", "eval.benchmark",
            "eval.cli", "tools.virtual_cameras", "tools.quality_bench",
            "tools.run_quality_suite", "ops.triplane", "ops.encodings",
            "ops.tensovm", "ops.pose", "models.scene_rep", "models.decoder",
            "mesh.extract", "ops.frame_align", "ops.pose_array",
            "data.prefetch", "runtime.pipeline", "runtime.latency",
            "active", "active.decoder", "active.scene_rep", "active.slam"):
    assert "coslam_torch." + new in names, new
# The tri-plane and the encodings, 6D poses and lattices this port added.
from coslam_torch.ops import encodings, pose, tensovm, triplane
for mod, attrs in ((triplane, ("triplane_encode_fwd", "triplane_encode_bwd",
                               "triplane_encode_bwd_serial", "TriPlaneEncode",
                               "triplane_lattice_encode", "init_triplane")),
                   (tensovm, ("tensovm_lattice_encode",
                              "make_tensovm_lattice",
                              "make_triplane_lattice_tv")),
                   (encodings, ("freq_encode", "sh_encode")),
                   (pose, ("rotation_6d_to_matrix", "se3_inverse"))):
    assert all(hasattr(mod, a) for a in attrs), mod.__name__
# The pipelined runtime, the frame-tail report, ActiveCoSLAM and the
# dataset algebra.
from coslam_torch import active
from coslam_torch.data import datasets
from coslam_torch.runtime import latency, pipeline
for mod, attrs in ((pipeline, ("PipelinedCoSLAM",)),
                   (latency, ("attribute_tails",)),
                   (active, ("ActiveCoSLAM", "ActiveJointEncoding")),
                   (datasets, ("DatasetView", "ConcatDataset",
                               "DatasetAlgebra"))):
    assert all(hasattr(mod, a) for a in attrs), mod.__name__
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("coslam_tpu", "jax", "jaxlib"))
assert not bad, bad
print(len(names))
"""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert int(proc.stdout.split()[-1]) > 30


def test_checkpoint_module_unpickles_nothing():
    """runtime/checkpoint.py reads the JAX package's checkpoints without
    jax and without unpickling their treedefs: it imports neither jax nor
    pickle, and opens the files with allow_pickle=False."""
    import ast

    path = os.path.join(REPO, "coslam_torch", "runtime", "checkpoint.py")
    with open(path) as f:
        src = f.read()
    imported = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            imported |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            imported.add(node.module.split(".")[0])
    assert not imported & {"jax", "jaxlib", "pickle", "coslam_tpu"}, imported
    assert "allow_pickle=False" in src and "allow_pickle=True" not in src


def test_synthetic_frames_and_trajectory_match_jax():
    """The scan trajectory, the rays and rendered frames of the analytic
    scene, and the base config are the JAX package's, bit for bit."""
    poses = TS.make_scan_trajectory(7)
    np.testing.assert_array_equal(poses, JS.make_scan_trajectory(7))
    cfg = TS.make_synthetic_config("d", "o", H=24, W=32, n_frames=7)
    assert cfg == JS.make_synthetic_config("d", "o", H=24, W=32, n_frames=7)
    cam = cfg["cam"]
    args = (24, 32, cam["fx"], cam["fy"], cam["cx"], cam["cy"])
    np.testing.assert_array_equal(TR.get_camera_rays(*args),
                                  JR.get_camera_rays(*args))
    np.testing.assert_array_equal(
        TR.get_camera_rays(*args, convention="OpenCV"),
        JR.get_camera_rays(*args, convention="OpenCV"))
    for c2w in poses[::3]:
        got = TS.render_frame(TS.AnalyticScene(), c2w, *args)
        want = JS.render_frame(JS.AnalyticScene(), c2w, *args)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["room0.yaml", "room0_vm.yaml"])
def test_load_config_matches_jax(name):
    path = os.path.join(REPO, "configs", "Replica", name)
    assert TC.load_config(path) == j_load_config(path)


def test_dataset_loader_matches_jax(tmp_path):
    """A Replica-layout scene on disk read by both packages' loaders: the
    same frames (rgb, depth, pose, rays) and camera model."""
    cfg = TS.make_synthetic_config(str(tmp_path), str(tmp_path / "out"),
                                   H=24, W=32, n_frames=3)
    cam = cfg["cam"]
    JS.write_replica_format(str(tmp_path), JS.AnalyticScene(),
                            JS.make_scan_trajectory(3), cam["H"], cam["W"],
                            cam["fx"], cam["fy"], cam["cx"], cam["cy"])
    ours, theirs = t_get_dataset(cfg), j_get_dataset(cfg)
    assert (ours.num_frames, ours.num_rays_to_save, ours.H, ours.W) == (
        theirs.num_frames, theirs.num_rays_to_save, theirs.H, theirs.W)
    for i in range(ours.num_frames):
        a, b = ours[i], theirs[i]
        assert a["frame_id"] == b["frame_id"]
        for key in ("c2w", "rgb", "depth", "direction"):
            assert a[key].dtype == np.asarray(b[key]).dtype, key
            np.testing.assert_array_equal(a[key], b[key])


def test_evaluate_ate_matches_jax():
    """convert_poses and evaluate_ate on a noisy numpy trajectory with a
    non-finite ground-truth pose: the same statistics."""
    rng = np.random.default_rng(0)
    gt = TS.make_scan_trajectory(12).astype(np.float64)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0, 0.02, (12, 3))
    gt[4, 0, 0] = np.nan
    out = []
    for mod in (TA, JA):
        g, mask = mod.convert_poses(dict(enumerate(gt)), 12, 1.0)
        e, _ = mod.convert_poses(dict(enumerate(est)), 12, 1.0, gt=False)
        e = e[mask]
        out.append(mod.evaluate_ate(dict(enumerate(g)), dict(enumerate(e))))
    assert out[0] == out[1]
    assert out[0]["compared_pose_pairs"] == 11


def test_marching_cubes_matches_jax():
    """A sphere's SDF volume (some voxels past the truncation): the port's
    native marching cubes gives the JAX package's vertices and faces."""
    g = np.linspace(-1.0, 1.0, 28, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    vol = (np.sqrt(x ** 2 + y ** 2 + z ** 2) - 0.6) * 10
    verts, faces = TM.marching_cubes(vol, 0.0, truncation=3.0)
    want_v, want_f = j_marching_cubes(vol, 0.0, truncation=3.0)
    assert len(faces) > 100
    np.testing.assert_array_equal(verts, want_v)
    np.testing.assert_array_equal(faces, want_f)
    assert TM.library.cache_info().currsize == 1
    assert os.path.dirname(TM.library()._name) == str(TM.BUILD_DIR)


def test_marching_cubes_build_raises_when_gxx_fails(tmp_path, monkeypatch):
    """A failed g++ build raises (no quiet numpy fallback)."""
    monkeypatch.setattr(TM, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(TM, "GXX_FLAGS", ("-no-such-flag",))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        TM.build()
    assert not list(tmp_path.iterdir())


def test_marching_cubes_library_is_keyed_by_the_cpu(tmp_path, monkeypatch):
    """A library built with -march=native on one CPU is not loaded on
    another: the host's CPU model and flags key its name."""
    monkeypatch.setattr(TM, "BUILD_DIR", tmp_path)
    here = TM.build()
    assert TM.build() == here
    monkeypatch.setattr(TM, "_cpu_model", lambda: "x86_64 another cpu avx")
    there = TM.build()
    assert there != here and there.exists()


def test_memory_route_quality_bench_and_smoke_need_no_image_codec():
    """With cv2, PIL and yaml blocked in sys.modules (an import of any of
    them raises), chip_smoke, quality_bench, the suite runner, the
    benchmark and the in-memory route of every protocol import and run:
    each protocol's frames are built and read at 24x32."""
    code = """
import sys
for name in ("cv2", "PIL", "yaml"):
    sys.modules[name] = None
import numpy as np
import chip_smoke
from coslam_torch.data import synth as S
from coslam_torch.eval import benchmark, cull, recon
from coslam_torch.tools import quality_bench, run_quality_suite
from coslam_torch.tools import virtual_cameras
makers = {"replica": S.make_synthetic_config,
          "tum": S.make_tum_synthetic_config,
          "scannet": S.make_scannet_synthetic_config,
          "rgbd": S.make_rgbd_synthetic_config}
for protocol, make in makers.items():
    cfg = make("d", "o", H=24, W=32, n_frames=3)
    poses = (S.make_walkthrough_trajectory(3) if protocol == "scannet"
             else S.make_scan_trajectory(3))
    frames = S.SyntheticFrames(cfg, 3, protocol=protocol, poses=poses,
                               scene=S.AnalyticApartment()
                               if protocol == "scannet" else None,
                               device="cpu")
    for i in range(len(frames)):
        b = frames[i]
        assert b["rgb"].shape == b["depth"].shape + (3,)
        assert np.isfinite(b["depth"]).all()
bad = sorted(k for k in sys.modules if sys.modules[k] is not None
             and k.split(".")[0] in ("cv2", "PIL", "yaml"))
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split()[-1] == "ok"
