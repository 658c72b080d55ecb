"""The port's main path against the JAX package: the tracking step, one
BA iteration, and the sequential loop on a small synthetic scene, for the
packed hash grid, TensoVM and the XOR-hash grid (grid.grad_impl pallas,
whose JAX table gradient runs the Pallas K4 in interpret mode); plus the
port's independence from jax and the room0 settings of chip_smoke.py.

Tolerances. Tracking (perturb 0, so both sides are deterministic): each
Adam step moves a pose component by about lr = 1e-3 whatever the
gradient's size, so losses agree to rtol 1e-4 and poses to atol 1e-5 as
long as no gradient component is within f32 noise of zero (none is,
with these inputs). One BA iteration: the loss to rtol 1e-4, gradients
as in test_torch_model.py, and the parameters after the Adam step to
atol 1e-6 (the first Adam step is lr * g / (|g| + eps) per entry, which
follows f32 noise only where |g| is within a thousand eps of zero).
"""

import copy
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coslam_tpu.data.synth import (AnalyticScene, make_synthetic_config,
                                   make_trajectory, render_frame,
                                   write_replica_format)
from coslam_tpu.models.scene_rep import JointEncoding as JModel
from coslam_tpu.ops import losses as JL
from coslam_tpu.ops import pose as JP
from coslam_tpu.ops.rays import get_camera_rays
from coslam_tpu.runtime.mapping import make_ba_step
from coslam_tpu.runtime.optim import make_map_optimizer as j_map_optimizer
from coslam_tpu.runtime.tracking import make_tracking_step as j_tracking
from coslam_torch import convert
from coslam_torch.models.scene_rep import JointEncoding as TModel
from coslam_torch.models.scene_rep import is_factorized
from coslam_torch.ops import pose as TP
from coslam_torch.runtime.mapping import BundleAdjust, build_poses
from coslam_torch.runtime.optim import (grid_leaves, make_map_optimizer,
                                        make_pose_optimizer, map_param_list)
from coslam_torch.runtime.tracking import make_tracking_step

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scene(cfg, pose):
    cam = cfg["cam"]
    rgb, depth = render_frame(AnalyticScene(), pose, cam["H"], cam["W"],
                              cam["fx"], cam["fy"], cam["cx"], cam["cy"])
    dirs = get_camera_rays(cam["H"], cam["W"], cam["fx"], cam["fy"],
                           cam["cx"], cam["cy"])
    return np.concatenate([dirs.reshape(-1, 3), rgb.reshape(-1, 3),
                           depth.reshape(-1, 1)], 1).astype(np.float32)


def _models(cfg):
    bb = np.array(cfg["mapping"]["bound"], np.float32)
    jm, tm = JModel(cfg, bb), TModel(cfg, bb)
    jparams = jm.init_params(jax.random.PRNGKey(0))
    return jm, tm, jparams, jax.tree_util.tree_map(np.asarray, jparams)


def _vm(cfg):
    """The TensoVM twin of a synthetic config (room0_vm's grid: a 3-level
    pyramid of 2 features)."""
    cfg["grid"].update(enc="TensoVM", triplane_levels=3)
    return cfg


def _hybrid(cfg):
    """The TriPlaneHybrid twin of a synthetic config (room0_hybrid's grid:
    3 dense levels and a 4-level plane pyramid of 2 features)."""
    cfg["grid"]["enc"] = "TriPlaneHybrid"
    return cfg


def _xor(cfg):
    """The XOR-hash twin of a synthetic config (room0_xor's grid:
    grad_impl pallas, the deterministic table gradient)."""
    cfg["grid"]["grad_impl"] = "pallas"
    return cfg


def _check_tracking_step(cfg, mesh=None, devices=None):
    """The tracking step against the JAX step; with ``mesh`` (JAX's 'dp'
    mesh) and ``devices`` (the port's), both split their rays."""
    cfg["training"]["perturb"] = 0
    cfg["tracking"]["sample"] = 128
    jm, tm, jparams, np_params = _models(cfg)
    pose0 = make_trajectory(4)[0]
    frame = _scene(cfg, pose0)
    rays = frame[np.random.default_rng(0).choice(len(frame), 128,
                                                 replace=False)]
    init = pose0.copy()
    init[:3, 3] += np.array([0.01, -0.008, 0.012], np.float32)

    n_iter = 3
    ref = {}
    for it in (1, n_iter):
        c = copy.deepcopy(cfg)
        c["tracking"]["iter"] = it
        c2w, loss, psnr = j_tracking(jm, c, mesh=mesh)(
            jparams, jnp.asarray(init), jnp.asarray(rays),
            jax.random.PRNGKey(0))
        ref[it] = (np.asarray(c2w), float(loss), float(psnr))

    cfg["tracking"]["iter"] = n_iter
    c2w, losses, psnrs, align = make_tracking_step(tm, cfg, devices)(
        convert.params_from_numpy(np_params, spec=tm.grid_spec),
        torch.from_numpy(init), torch.from_numpy(rays))
    assert align is None  # no exposure parameters without frame_align
    np.testing.assert_allclose(float(losses[0]), ref[1][1], rtol=1e-4)
    np.testing.assert_allclose(float(losses[-1]), ref[n_iter][1], rtol=1e-4)
    np.testing.assert_allclose(float(psnrs[-1]), ref[n_iter][2], rtol=1e-4)
    np.testing.assert_allclose(c2w.numpy(), ref[n_iter][0], atol=1e-5)
    # With tracking.best the pose is the best one EVALUATED, which after
    # one iteration is the initial pose itself.
    np.testing.assert_allclose(ref[1][0], init, atol=1e-6)


def test_tracking_step_matches_jax():
    _check_tracking_step(make_synthetic_config("", "/tmp/unused", H=40, W=52))


def test_tracking_step_matches_jax_tensovm():
    _check_tracking_step(_vm(make_synthetic_config("", "/tmp/unused", H=40,
                                                   W=52)))


def test_tracking_step_matches_jax_hybrid():
    _check_tracking_step(_hybrid(make_synthetic_config("", "/tmp/unused",
                                                       H=40, W=52)))


def test_tracking_step_matches_jax_xor():
    _check_tracking_step(_xor(make_synthetic_config("", "/tmp/unused", H=40,
                                                    W=52)))


def _check_ba_iteration(cfg, mesh=None, devices=None):
    """One BA iteration on the rays, pose table and smoothness sample the
    JAX step draws (its key splits replayed here): loss, map and pose
    gradients, and the map and poses after the Adam steps. With ``mesh``
    and ``devices`` the JAX step and the port's BA split their rays."""
    cfg["training"]["perturb"] = 0
    cfg["mapping"].update(sample=64, iters=1, pose_accum_step=1,
                          min_pixels_cur=20)
    m, w = cfg["mapping"], cfg["training"]
    jm, tm, jparams, np_params = _models(cfg)
    max_kf, R, kf_count = 4, 32, 3
    poses = make_trajectory(max_kf, orbit_fraction=0.05)
    frames = [_scene(cfg, p) for p in poses]
    rng = np.random.default_rng(1)
    kf_rays = np.stack([f[rng.choice(len(f), R, replace=False)]
                        for f in frames]).astype(np.float32)
    kf_poses = poses.copy()
    kf_poses[kf_count:] = np.eye(4)
    cur_pose, cur_rays = poses[-1], frames[-1]
    key = jax.random.PRNGKey(4)

    map_tx = j_map_optimizer(cfg)
    out = make_ba_step(jm, cfg, map_tx, max_kf, R, R, mesh=mesh)(
        jparams, map_tx.init(jparams), jnp.asarray(kf_rays),
        jnp.int32(kf_count), jnp.asarray(kf_poses), jnp.asarray(cur_pose),
        jnp.asarray(cur_rays), key)
    j_params_after, j_kf_after, j_cur_after, j_loss = (
        out[0], np.asarray(out[2]), np.asarray(out[3]), float(out[4]))

    # The draws of the JAX step's only iteration (mapping.py body/loss_fn).
    k1, k2, k3 = jax.random.split(jax.random.split(key, 1)[0], 3)
    idx = np.asarray(jax.random.randint(k1, (m["sample"],), 0, kf_count * R))
    cur_idx = np.asarray(jax.random.randint(k2, (m["sample"],), 0,
                                            cur_rays.shape[0]))
    quota = max(m["sample"] // kf_count, m["min_pixels_cur"])
    smooth_key = jax.random.split(k3)[1]
    # The lattice's points for the hash grid, its axes for the factorized
    # grids.
    draw = jm.smoothness_axes if is_factorized(cfg) else jm.smoothness_points
    smooth_sample = np.asarray(draw(smooth_key, w["smooth_pts"],
                                    w["smooth_vox"], w["smooth_margin"]))
    ray_data = np.concatenate([kf_rays.reshape(-1, 7)[idx],
                               cur_rays[cur_idx[:quota]]])
    ray_ids = np.concatenate([idx // R, np.full(quota, max_kf)])

    # JAX gradients of the same loss (mapping.py loss_fn with those draws).
    poses0 = np.concatenate([kf_poses, cur_pose[None]]).astype(np.float32)
    pp = {"rot": JP.matrix_to_axis_angle(jnp.asarray(poses0[:, :3, :3])),
          "trans": jnp.asarray(poses0[:, :3, 3])}

    def j_loss_fn(pp, mp):
        mats = JP.at_to_transform_matrix(pp["rot"], pp["trans"])
        mats = mats.at[0].set(jnp.asarray(kf_poses[0]))
        rows = mats[jnp.asarray(ray_ids)]
        rd = jnp.einsum("nij,nj->ni", rows[:, :3, :3],
                        jnp.asarray(ray_data[:, :3]))
        ret = jm.forward(mp, k3, rows[:, :3, 3], rd,
                         jnp.asarray(ray_data[:, 3:6]),
                         jnp.asarray(ray_data[:, 6:7]))
        smooth = jm.smoothness(mp, smooth_key, w["smooth_pts"],
                               w["smooth_vox"], w["smooth_margin"])
        return JL.total_loss(ret, w, smooth_loss=smooth,
                             smooth_weight=w["smooth_weight"])

    j_val, (j_gpose, j_gmap) = jax.jit(jax.value_and_grad(j_loss_fn, (0, 1)))(
        pp, jparams)
    np.testing.assert_allclose(float(j_val), j_loss, rtol=1e-5)

    # The port: the same iteration through BundleAdjust.loss + Adam.
    params = convert.params_from_numpy(np_params, spec=tm.grid_spec)
    map_opt = make_map_optimizer(cfg, params)
    ba = BundleAdjust(tm, cfg, map_opt, max_kf, devices)
    p0 = torch.from_numpy(poses0)
    rot = TP.matrix_to_axis_angle(p0[:, :3, :3]).requires_grad_(True)
    trans = p0[:, :3, 3].clone().requires_grad_(True)
    loss = ba.loss(params, build_poses(rot, trans, p0,
                                       ba.frozen_mask("cpu"),
                                       TP.at_to_transform_matrix),
                   torch.from_numpy(ray_data), torch.from_numpy(ray_ids),
                   torch.from_numpy(smooth_sample), None)
    loss.backward()
    np.testing.assert_allclose(float(loss), j_loss, rtol=1e-4)
    for name, got, ref in (("rot", rot.grad, j_gpose["rot"]),
                           ("trans", trans.grad, j_gpose["trans"])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3,
                                   atol=1e-6 * np.abs(ref).max(),
                                   err_msg=name)
    leaves = map_param_list(params)
    n_grid = len(grid_leaves(params["grid"]))
    jg = [*jax.tree_util.tree_leaves(j_gmap["grid"]),
          *j_gmap["decoder"]["sdf_net"], *j_gmap["decoder"]["color_net"]]
    for p, ref in zip(leaves, jg):
        ref = np.asarray(ref)
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=1e-3,
                                   atol=1e-6 * np.abs(ref).max())

    map_opt.step()
    pose_opt = make_pose_optimizer(rot, trans, m["lr_rot"], m["lr_trans"])
    pose_opt.step()
    ja = [*jax.tree_util.tree_leaves(j_params_after["grid"]),
          *j_params_after["decoder"]["sdf_net"],
          *j_params_after["decoder"]["color_net"]]
    for i, (p, ref, g) in enumerate(zip(leaves, ja, jg)):
        # Where |g| is within a thousand eps (1e-15 on the grid, 1e-8 on the
        # decoder) of zero the step lr * g / (|g| + eps) follows g's f32
        # sum-order noise; there it is only bounded by lr.
        tiny = np.abs(np.asarray(g)) < 1e3 * (1e-15 if i < n_grid else 1e-8)
        got, ref = p.detach().numpy(), np.asarray(ref)
        np.testing.assert_allclose(got[~tiny], ref[~tiny], atol=1e-6)
        assert np.all(np.abs(got - ref)[tiny] <= m["lr_embed"] * 1.01)
    with torch.no_grad():
        final = build_poses(rot, trans, p0, ba.frozen_mask("cpu"),
                            TP.at_to_transform_matrix)
    np.testing.assert_allclose(final[:max_kf].numpy(), j_kf_after, atol=1e-5)
    np.testing.assert_allclose(final[max_kf].numpy(), j_cur_after, atol=1e-5)
    np.testing.assert_array_equal(final[0].numpy(), kf_poses[0])


def test_ba_iteration_matches_jax():
    _check_ba_iteration(make_synthetic_config("", "/tmp/unused", H=24, W=32))


def test_ba_iteration_matches_jax_tensovm():
    """The TensoVM twin: dplanes and dlines through the encode backward
    plus the analytic TV's gradient, on the axes of the JAX draw."""
    _check_ba_iteration(_vm(make_synthetic_config("", "/tmp/unused", H=24,
                                                  W=32)))


def test_ba_iteration_matches_jax_hybrid():
    """The TriPlaneHybrid twin: the dense table's gradient through kernel
    B's plain version and the planes' through U's, each plus the lattice
    term's (the dense part encoded at the lattice's points, the planes by
    the separable lattice encode), on the axes of the JAX draw."""
    _check_ba_iteration(_hybrid(make_synthetic_config("", "/tmp/unused",
                                                      H=24, W=32)))


def test_ba_iteration_matches_jax_xor():
    """The XOR twin: dtable through kernel H's plain version against the
    JAX gradient through K4 in interpret mode, lattice term included."""
    _check_ba_iteration(_xor(make_synthetic_config("", "/tmp/unused", H=24,
                                                   W=32)))


def _check_slam_loop(tmp_path, vm: bool = False, xor: bool = False,
                     hybrid: bool = False, dp: int = 1):
    """CoSLAM.run on the 12-frame 40x52 scene of
    tests/test_integration.py:test_full_slam_loop, with 128-ray batches
    (CPU time), read from disk by the port's loader: ATE < 5 cm and 3
    keyframes; the first mesh and the mesh.vis meshes are written beside
    the final one."""
    from coslam_torch.data.datasets import get_dataset
    from coslam_torch.runtime.slam import CoSLAM

    datadir = str(tmp_path / "scene")
    cfg = make_synthetic_config(datadir, str(tmp_path / "out"), H=40, W=52,
                                n_frames=12)
    if vm:
        _vm(cfg)
    if xor:
        _xor(cfg)
    if hybrid:
        _hybrid(cfg)
    cfg["mapping"].update(first_iters=100, sample=128)
    cfg["tracking"]["sample"] = 128
    cfg["mapping"]["first_mesh"] = True
    cfg["mesh"]["vis"] = 10
    cfg["parallel"] = {"dp": dp}
    poses = make_trajectory(12, orbit_fraction=0.02)
    cam = cfg["cam"]
    write_replica_format(datadir, AnalyticScene(), poses, cam["H"], cam["W"],
                         cam["fx"], cam["fy"], cam["cx"], cam["cy"])
    slam = CoSLAM(cfg, get_dataset(cfg), device="cpu")
    res = slam.run(verbose=False)
    ate = res["absolute_translational_error.rmse"]
    assert np.isfinite(ate) and ate < 0.05
    assert slam.kf_db.count == 3
    assert list(slam.kf_db.frame_ids) == [0, 5, 10]
    assert len(slam.final_mesh.vertices) > 100
    out = os.path.join(cfg["data"]["output"], cfg["data"]["exp_name"])
    assert os.path.exists(os.path.join(out, "output.txt"))
    for i in (0, 10, 11):
        assert os.path.exists(os.path.join(out, f"mesh_track{i}.ply")), i
    return slam


def test_slam_loop_on_small_scene(tmp_path):
    _check_slam_loop(tmp_path, vm=False)


def test_slam_loop_on_small_scene_tensovm(tmp_path):
    slam = _check_slam_loop(tmp_path, vm=True)
    assert set(slam.params["grid"]) == {"planes", "lines"}


def test_slam_loop_on_small_scene_hybrid(tmp_path):
    """The CPU twin of the room0_hybrid slice."""
    slam = _check_slam_loop(tmp_path, hybrid=True)
    assert set(slam.params["grid"]) == {"dense", "planes"}
    dspec, pspec = slam.model.grid_spec
    assert not any(dspec.hashed) and dspec.n_levels == 3
    assert slam.params["grid"]["planes"].shape == (pspec.total_entries, 2)


def test_slam_loop_on_small_scene_xor(tmp_path):
    from coslam_torch.ops.encodings import HashGridSpec

    slam = _check_slam_loop(tmp_path, xor=True)
    spec = slam.model.grid_spec
    assert isinstance(spec, HashGridSpec)
    assert slam.params["grid"].shape == (spec.total_entries, 2)
    # Dense coarse levels and hashed fine ones, as at room0's width.
    assert not spec.hashed[0] and spec.hashed[-1]


def test_port_runs_without_jax():
    """Importing coslam_torch and running one CPU tracking step, with the
    packed hash grid, the XOR-hash grid, TriPlaneHybrid, TriPlane and
    TensoVM, the XOR grid's lattice encode and TensoVM's smoothness TV
    with their gradients, leaves jax and the JAX package out of
    sys.modules."""
    code = """
import sys
import numpy as np, torch
from coslam_torch.data.synth import make_synthetic_config
from coslam_torch.models.scene_rep import JointEncoding
from coslam_torch.runtime.optim import make_map_optimizer, map_param_list
from coslam_torch.runtime.slam import CoSLAM
from coslam_torch.runtime.tracking import make_tracking_step
import coslam_torch.cli, coslam_torch.convert, coslam_torch.mesh.extract
import coslam_torch.data.synth, coslam_torch.tools.profile_slice
import coslam_torch.ops.hash_pallas, coslam_torch.ops.serial_scatter
for enc, impl in (("HashGrid", "auto"), ("HashGrid", "pallas"),
                  ("TriPlaneHybrid", "auto"), ("TriPlane", "auto"),
                  ("TensoVM", "auto")):
    cfg = make_synthetic_config("", "/tmp/unused", H=24, W=32)
    cfg["grid"].update(enc=enc, triplane_levels=3, grad_impl=impl)
    cfg["tracking"].update(iter=1, sample=16)
    m = JointEncoding(cfg, np.array(cfg["mapping"]["bound"], np.float32))
    p = m.init_params(torch.Generator().manual_seed(0))
    rays = torch.rand(16, 7)
    c2w, losses, _, _ = make_tracking_step(m, cfg)(p, torch.eye(4), rays,
                                                   torch.Generator())
    assert torch.isfinite(losses).all()
    if impl == "auto":
        continue
    make_map_optimizer(cfg, p)
    tv = m.smoothness(p, m.smoothness_sample(torch.Generator(), 8, 0.1,
                                             0.05), 8)
    tv.backward()
    assert torch.isfinite(p["grid"].grad).all()
make_map_optimizer(cfg, p)
tv = m.smoothness(p, m.smoothness_sample(torch.Generator(), 8, 0.1, 0.05), 8)
tv.backward()
assert all(torch.isfinite(t.grad).all() for t in map_param_list(p)[:2])
assert "jax" not in sys.modules, "jax was imported"
assert "coslam_tpu" not in sys.modules, "coslam_tpu was imported"
print("ok")
"""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("ok")


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


# The config keys of the smoke's slices, beside the grid's own.
_SLICE_KEYS = {
    "pos": ["enc", "n_bins"],
    "decoder": ["geo_feat_dim", "hidden_dim", "num_layers",
                "num_layers_color", "hidden_dim_color"],
    "training": ["n_samples_d", "n_range_d", "range_d", "n_importance",
                 "perturb", "trunc", "rgb_weight", "depth_weight",
                 "sdf_weight", "fs_weight", "smooth_weight", "smooth_pts",
                 "smooth_vox", "smooth_margin", "rot_rep", "rgb_missing"],
    "tracking": ["iter", "sample", "lr_rot", "lr_trans", "ignore_edge_W",
                 "ignore_edge_H", "best", "robust_delta", "const_speed",
                 "wait_iters"],
    "mapping": ["sample", "iters", "first_iters", "min_pixels_cur",
                "keyframe_every", "map_every", "n_pixels", "optim_cur",
                "pose_accum_step", "map_accum_step", "map_wait_step",
                "lr_embed", "lr_decoder", "lr_rot", "lr_trans",
                "filter_depth", "cur_frame_iters"],
    "mesh": ["voxel_final"],
}


def _bound(cfg):
    return np.array(cfg["mapping"]["bound"], np.float32)


def _check_smoke_settings(smoke, yaml_name, grid_keys):
    """smoke carries the YAML config's values at the keys of the slice,
    and both resolve to the same grid spec."""
    from coslam_tpu.config import load_config

    ref = load_config(os.path.join(REPO, "configs/Replica", yaml_name))
    for section, names in dict(_SLICE_KEYS, grid=grid_keys).items():
        for k in names:
            assert smoke[section][k] == ref[section][k], (section, k)
    assert (TModel(smoke, _bound(smoke)).grid_spec
            == TModel(ref, _bound(ref)).grid_spec)


def test_chip_smoke_uses_room0_settings():
    """The synthetic config chip_smoke.py runs (coslam_torch.data.synth
    .room0_config) carries room0's model and recipe
    (configs/Replica/room0.yaml + replica.yaml) at the keys of the slice;
    both resolve to resolution 400 (8 m / 0.02 m in room0)."""
    from coslam_torch.data import synth

    assert _chip_smoke().room0_config is synth.room0_config
    _check_smoke_settings(synth.room0_config("/tmp/unused"), "room0.yaml",
                          ["enc", "hash_size", "oneGrid"])


def test_chip_smoke_uses_room0_vm_settings():
    """The TensoVM slice's config (room0_vm_config) carries
    configs/Replica/room0_vm.yaml's model and recipe: TensoVM, 3 levels,
    16 + 11 samples per ray, and room0's everything else."""
    from coslam_torch.data import synth

    assert _chip_smoke().room0_vm_config is synth.room0_vm_config
    smoke = synth.room0_vm_config("/tmp/unused")
    _check_smoke_settings(smoke, "room0_vm.yaml",
                          ["enc", "triplane_levels", "oneGrid"])
    assert TModel(smoke, _bound(smoke)).grid_spec.resolutions[::3] == (
        32, 100, 311)


def test_chip_smoke_uses_room0_xor_settings():
    """The XOR slice's config (room0_xor_config) is room0's at every key
    of the slice, with grid.grad_impl pallas: the XOR hash at room0's
    full width, 16 levels x 2, hash_size 16, 834,097 rows (5 dense levels,
    11 hashed at 2^16), 32 + 11 samples, 1024 tracking and 2048 BA rays;
    the same with scatter for the smoke's kernel-F run."""
    from coslam_tpu.models.scene_rep import JointEncoding as JEnc
    from coslam_torch.data import synth
    from coslam_torch.ops.encodings import HashGridSpec

    assert _chip_smoke().room0_xor_config is synth.room0_xor_config
    smoke = synth.room0_xor_config("/tmp/unused")
    ref = synth.room0_config("/tmp/unused")
    assert smoke["grid"].pop("grad_impl") == "pallas"
    ref["data"]["exp_name"] = smoke["data"]["exp_name"]
    assert smoke == ref
    _check_smoke_settings(ref, "room0.yaml", ["enc", "hash_size", "oneGrid"])
    smoke["grid"]["grad_impl"] = "pallas"
    spec = TModel(smoke, _bound(smoke)).grid_spec
    assert isinstance(spec, HashGridSpec) and spec.total_entries == 834_097
    assert vars(spec) == vars(JEnc(smoke, _bound(smoke)).grid_spec)
    assert (spec.n_levels, spec.n_features, spec.log2_hashmap_size) == (16, 2,
                                                                        16)
    assert spec.hashed == (False,) * 5 + (True,) * 11
    tr = smoke["training"]
    assert (tr["n_samples_d"], tr["n_range_d"]) == (32, 11)
    assert (smoke["tracking"]["sample"], smoke["mapping"]["sample"]) == (1024,
                                                                         2048)
    scatter = synth.room0_xor_config("/tmp/unused", grad_impl="scatter")
    assert TModel(scatter, _bound(scatter)).grid_spec == spec


def test_chip_smoke_uses_room0_hybrid_settings():
    """The hybrid slice's config (room0_hybrid_config) carries
    configs/Replica/room0_hybrid.yaml's model and recipe: TriPlaneHybrid,
    3 dense levels 16/26/44 and planes 32/68/146/311 at resolution 400,
    and room0's everything else."""
    from coslam_torch.data import synth

    assert _chip_smoke().room0_hybrid_config is synth.room0_hybrid_config
    smoke = synth.room0_hybrid_config("/tmp/unused")
    _check_smoke_settings(smoke, "room0_hybrid.yaml",
                          ["enc", "hash_size", "oneGrid"])
    dspec, pspec = TModel(smoke, _bound(smoke)).grid_spec
    assert dspec.resolutions == (16, 26, 44)
    assert dspec.total_entries == 115_721
    assert pspec.resolutions[::3] == (32, 68, 146, 311)
    assert pspec.total_entries == 374_409
    assert TModel(smoke, _bound(smoke)).input_ch == 14


def test_room0_vm_yaml_builds_the_tensovm_model():
    """configs/Replica/room0_vm.yaml builds the port's TensoVM model: an
    encoding 6 wide over 325,902 plane rows and 1,338 line rows."""
    from coslam_tpu.config import load_config

    cfg = load_config(os.path.join(REPO, "configs/Replica/room0_vm.yaml"))
    m = TModel(cfg, _bound(cfg))
    assert m.input_ch == 6 and m.grid_spec.total_entries == 325_902
    grid = m.init_params(torch.Generator().manual_seed(0))["grid"]
    assert grid["planes"].shape == (325_902, 2)
    assert grid["lines"].shape == (1_338, 2)
    assert float(grid["planes"].abs().max()) <= 1e-4
    assert bool((grid["lines"] == 1).all())


def _recorded_cases(tmp_path, monkeypatch, make_cfg, module, names,
                    n_tables):
    """Run CoSLAM on the CPU with one iteration per phase and a coarse
    mesh (iteration counts and grid size do not change the shapes),
    recording the points of every forward and the (points, flags...) of
    every backward of the plain versions `names` of `module`, whose
    arguments are (spec, n_tables tables, x[, g, flags...])."""
    from coslam_torch.data.synth import SyntheticFrames
    from coslam_torch.runtime.slam import CoSLAM

    frames = 11
    cfg = make_cfg(str(tmp_path), H=72, W=88, n_frames=frames)
    cfg["grid"].update(hash_size=12, voxel_sdf=64)
    cfg["mapping"].update(first_iters=1, iters=1)
    cfg["tracking"]["iter"] = 1
    cfg["mesh"]["voxel_final"] = 0.1
    fwd, bwd = [], set()
    fwd_ref, bwd_ref = (getattr(module, n) for n in names)

    def rec_fwd(spec, *args):
        fwd.append(args[-1].shape[0])
        return fwd_ref(spec, *args)

    def rec_bwd(spec, *args):
        bwd.add((args[n_tables].shape[0], *args[n_tables + 2:]))
        return bwd_ref(spec, *args)

    monkeypatch.setattr(module, names[0], rec_fwd)
    monkeypatch.setattr(module, names[1], rec_bwd)
    slam = CoSLAM(cfg, SyntheticFrames(cfg, frames), device="cpu")
    slam.run(verbose=False, eval_ate=False)
    return _chip_smoke().main_path_cases(cfg, frames), fwd, bwd


def test_chip_smoke_checks_the_shapes_of_the_slice(tmp_path, monkeypatch):
    """chip_smoke.main_path_cases lists the (points, need_dtable, need_dx)
    of every encode call CoSLAM.run makes at room0's rays and samples."""
    from coslam_torch.data.synth import room0_config
    from coslam_torch.ops import hash_packed as HP

    cases, fwd, bwd = _recorded_cases(
        tmp_path, monkeypatch, room0_config, HP,
        ("grid_encode_fwd_ref", "grid_encode_bwd_ref"), n_tables=1)
    assert bwd == {(n, dt, dx) for _, n, dt, dx in cases if dt or dx}
    assert {n for _, n, _, _ in cases} <= set(fwd)
    labels = [c[0] for c in cases]
    assert labels == ["first frame", "tracking", "BA 1 kf", "BA 2 kf",
                      "lattice", "mesh chunk"]
    # room0: 43 samples per ray; BA quota 2048 then 1024 rays; 31^3 lattice.
    assert [c[1] for c in cases] == [2048 * 43, 1024 * 43, 4096 * 43,
                                     3072 * 43, 31 ** 3, 65536]


def test_chip_smoke_checks_the_shapes_of_the_vm_slice(tmp_path, monkeypatch):
    """The same for the TensoVM slice: (points, need_dplanes, need_dlines,
    need_dx) of every call, the tables asked for together; no lattice
    row, because the analytic TV encodes no points."""
    from coslam_torch.data.synth import room0_vm_config
    from coslam_torch.ops import tensovm as VM

    cases, fwd, bwd = _recorded_cases(
        tmp_path, monkeypatch, room0_vm_config, VM,
        ("tensovm_encode_fwd_ref", "tensovm_encode_bwd_ref"), n_tables=2)
    assert bwd == {(n, dt, dt, dx) for _, n, dt, dx in cases if dt or dx}
    assert {n for _, n, _, _ in cases} <= set(fwd)
    assert [c[0] for c in cases] == ["first frame", "tracking", "BA 1 kf",
                                     "BA 2 kf", "mesh chunk"]
    # room0_vm: 27 samples per ray; the points of the table in PERF.md.
    assert [c[1] for c in cases] == [55_296, 27_648, 110_592, 82_944,
                                     65_536]


def test_chip_smoke_checks_the_shapes_of_the_hybrid_slice(tmp_path,
                                                           monkeypatch):
    """The same for the hybrid slice's planes (kernels T and U): (points,
    need_dtable, need_dx) of every call, room0's cases without the
    lattice (the planes' lattice is the plain separable encode; the dense
    part takes the lattice through A and B)."""
    from coslam_torch.data.synth import room0_hybrid_config
    from coslam_torch.ops import triplane as TPL

    cases, fwd, bwd = _recorded_cases(
        tmp_path, monkeypatch, room0_hybrid_config, TPL,
        ("triplane_encode_fwd_ref", "triplane_encode_bwd_ref"), n_tables=1)
    assert [c[0] for c in cases] == ["first frame", "tracking", "BA 1 kf",
                                     "BA 2 kf", "lattice", "mesh chunk"]
    planes = [c for c in cases if c[0] != "lattice"]
    assert bwd == {(n, dt, dx) for _, n, dt, dx in planes if dt or dx}
    assert {n for _, n, _, _ in planes} <= set(fwd)
    assert 30 ** 3 not in set(fwd) and 31 ** 3 not in set(fwd)
    assert [c[1] for c in planes] == [2048 * 43, 1024 * 43, 4096 * 43,
                                      3072 * 43, 65536]


def test_chip_smoke_checks_the_shapes_of_the_xor_slice(tmp_path,
                                                        monkeypatch):
    """The same for the XOR slice: (points, need_streams, need_dx) of
    every call of kernels E and G through XorGridEncode, at room0's rays
    and samples (the same cases as room0's)."""
    from coslam_torch.data.synth import room0_xor_config
    from coslam_torch.ops import hash_pallas as XP

    cases, fwd, bwd = _recorded_cases(
        tmp_path, monkeypatch, room0_xor_config, XP,
        ("xor_grid_encode_fwd", "xor_grid_encode_bwd"), n_tables=1)
    assert bwd == {(n, dt, dx) for _, n, dt, dx in cases if dt or dx}
    assert {n for _, n, _, _ in cases} <= set(fwd)
    assert [c[0] for c in cases] == ["first frame", "tracking", "BA 1 kf",
                                     "BA 2 kf", "lattice", "mesh chunk"]
    assert [c[1] for c in cases] == [2048 * 43, 1024 * 43, 4096 * 43,
                                     3072 * 43, 31 ** 3, 65536]


def _check_profile_small(tmp_path, *flags):
    from coslam_torch.tools import profile_slice

    res = profile_slice.main(["--device", "cpu", "--small", *flags,
                              "--out", str(tmp_path)])
    assert os.path.exists(tmp_path / "profile_slice.json")
    assert len(res["tracking_step_ms"]) == 1 and len(res["ba_call_ms"]) == 3
    walls = [res["first_frame_s"], res["mesh_s"], *res["tracking_step_ms"],
             *res["ba_call_ms"], *res["mesh_phases_s"].values()]
    assert all(np.isfinite(w) and w > 0 for w in walls)
    assert set(res["mesh_phases_s"]) == {"queries", "marching_cubes", "export"}
    for name in ("tracking_step", "ba_call"):
        assert res[name]["launches"] == 0 and res[name]["wall_us_profiled"] > 0
    assert res["mesh_vertices"] > 0
    return res


def test_profile_slice_small_deterministic_on_cpu(tmp_path):
    """--deterministic runs the slice under PyTorch's deterministic switch
    and turns it off again on return."""
    res = _check_profile_small(tmp_path, "--deterministic")
    assert res["deterministic"] is True
    assert not torch.are_deterministic_algorithms_enabled()


def test_profile_slice_small_on_cpu(tmp_path):
    """coslam_torch.tools.profile_slice at its --small size on the CPU:
    every phase reports a finite wall, and the CPU path launches no
    kernel."""
    res = _check_profile_small(tmp_path)
    assert res["encode_launches"] == {"grid_encode_fwd": 0,
                                      "grid_encode_bwd": 0,
                                      "grid_encode_bwd_serial": 0}


def test_profile_slice_small_vm_on_cpu(tmp_path):
    """The same with --vm: the TensoVM slice, and its kernels' counts."""
    res = _check_profile_small(tmp_path, "--vm")
    assert res["encode_launches"] == {"tensovm_encode_fwd": 0,
                                      "tensovm_encode_bwd": 0,
                                      "tensovm_encode_bwd_serial": 0}


def test_profile_slice_small_xor_on_cpu(tmp_path):
    """The same with --xor: the XOR slice, its kernels' counts."""
    res = _check_profile_small(tmp_path, "--xor")
    assert res["encode_launches"] == {"xor_grid_encode_fwd": 0,
                                      "xor_grid_encode_bwd": 0,
                                      "row_accum_segmented": 0}


def test_profile_slice_small_hybrid_on_cpu(tmp_path):
    """The same with --hybrid: the TriPlaneHybrid slice, the counts of its
    kernels (A and B on the dense levels, T and U on the planes)."""
    res = _check_profile_small(tmp_path, "--hybrid")
    assert res["encode_launches"] == {
        "grid_encode_fwd": 0, "grid_encode_bwd": 0,
        "grid_encode_bwd_serial": 0, "triplane_encode_fwd": 0,
        "triplane_encode_bwd": 0, "triplane_encode_bwd_serial": 0}


def test_record_ba_points_gives_the_first_ba_calls_rays(tmp_path):
    """kernel_times.record_ba_points (the smoke's ray-ordered case for
    kernels B and H) returns the points that the first BA call's first
    iteration encodes: as many as the smoke's BA 1-keyframe case, 43
    samples a ray, the samples of one ray adjacent and on one line."""
    from coslam_torch.data.synth import SyntheticFrames, room0_config
    from coslam_torch.tools.kernel_times import record_ba_points

    frames = 6
    cfg = room0_config(str(tmp_path), H=72, W=88, n_frames=frames)
    cfg["grid"].update(hash_size=12, voxel_sdf=64)
    cfg["mapping"].update(first_iters=1, iters=1)
    cfg["tracking"]["iter"] = 1
    pts = record_ba_points(cfg, SyntheticFrames(cfg, frames), "cpu")
    (n,) = [c[1] for c in _chip_smoke().main_path_cases(cfg, frames)
            if c[0] == "BA 1 kf"]
    assert pts.shape == (n, 3) and n == 4096 * 43
    rays = pts.reshape(-1, 43, 3).double()
    axis = rays[:, -1] - rays[:, 0]
    axis = axis / axis.norm(dim=-1, keepdim=True)
    off = rays - rays[:, :1]
    # Distance of every sample from the line through its ray's first and
    # last sample: f32 rounding of normalized coordinates only.
    dist = (off - (off * axis[:, None]).sum(-1, keepdim=True) * axis[:, None])
    assert float(dist.norm(dim=-1).max()) < 1e-5
    assert torch.isfinite(pts).all()


def test_record_ba_points_of_the_vm_slice(tmp_path):
    """The same for the TensoVM slice (the smoke's ray-ordered case for
    kernel D): room0_vm's BA 1-keyframe count, 27 samples a ray, the
    samples of one ray on one line."""
    from coslam_torch.data.synth import SyntheticFrames, room0_vm_config
    from coslam_torch.tools.kernel_times import record_ba_points

    frames = 6
    cfg = room0_vm_config(str(tmp_path), H=72, W=88, n_frames=frames)
    cfg["grid"].update(voxel_sdf=48)
    cfg["mapping"].update(first_iters=1, iters=1)
    cfg["tracking"]["iter"] = 1
    pts = record_ba_points(cfg, SyntheticFrames(cfg, frames), "cpu")
    (n,) = [c[1] for c in _chip_smoke().main_path_cases(cfg, frames)
            if c[0] == "BA 1 kf"]
    assert pts.shape == (n, 3) and n == 4096 * 27
    rays = pts.reshape(-1, 27, 3).double()
    step = rays[:, 1:] - rays[:, :-1]
    cos = (step[:, 1:] * step[:, :-1]).sum(-1) / (
        step[:, 1:].norm(dim=-1) * step[:, :-1].norm(dim=-1) + 1e-30)
    assert float(cos.min()) > 1 - 1e-4 and torch.isfinite(pts).all()


def _distinct_sectors(rows, row_bytes=8):
    """Brute force: per column of rows [K, ...], the count of distinct
    32-byte sectors, summed."""
    sec = (rows * row_bytes // 32).reshape(rows.shape[0], -1).T.tolist()
    return sum(len(set(col)) for col in sec)


def test_l2_sector_counts_of_e_and_d():
    """kernel_times.e_l2_sectors / d_l2_sectors (the L2 figure of kernels
    E and D): the distinct sectors per (point, level) or (point, section)
    against a brute-force count, plus the streams, and N copies of one
    point count N times its sectors."""
    from coslam_torch.ops import encodings as E
    from coslam_torch.ops import tensovm as VM
    from coslam_torch.tools import kernel_times as K

    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -0.05, 1.05, (300, 3)).astype(np.float32))
    spec = E.make_hashgrid_spec(96, 12, n_levels=6)
    rows, _ = E._hash_corners_and_weights(spec, x)                # [L, 8, N]
    streams = (12 * 300 + 4 * 300 * spec.out_dim) // 32
    assert K.e_l2_sectors(spec, x) == _distinct_sectors(
        rows.permute(1, 0, 2)) + streams
    one = x[:1].repeat(300, 1)
    assert K.e_l2_sectors(spec, one) == 300 * _distinct_sectors(
        E._hash_corners_and_weights(spec, x[:1])[0].permute(1, 0, 2)) + streams

    vspec = VM.make_tensovm_spec(96, 2, base_resolution=16)
    geo = VM._Geometry(vspec, torch.zeros((vspec.total_entries, 2)),
                       torch.zeros((VM.line_total_rows(vspec), 2)), x)
    reads = (_distinct_sectors(torch.stack([geo.e00, geo.e00 + 1, geo.e10,
                                            geo.e10 + 1]))
             + _distinct_sectors(torch.stack([geo.l_row, geo.l_row + 1])))
    atomics = sum(1 if e % 2 == 0 else 2
                  for e in torch.cat([geo.e00.reshape(-1),
                                      geo.e10.reshape(-1)]).tolist())
    io = 12 * 300 + 4 * 300 * vspec.out_dim
    assert K.d_l2_sectors(vspec, x, False, False) == reads + io // 32
    assert K.d_l2_sectors(vspec, x, True, True) == (
        reads + atomics + (io + 12 * 300) // 32)


def test_l2_sector_count_of_a():
    """kernel_times.a_l2_sectors (kernel A's L2 figure, the yardstick
    beside E's): per (point, level) the distinct sectors of the 4 xy
    corners' row pairs, against a brute-force count, plus the streams."""
    from coslam_torch.ops import hash_packed as HP
    from coslam_torch.tools import kernel_times as K

    x = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (200, 3)).astype(np.float32))
    spec = HP.make_packed_spec(96, 12, n_levels=6)
    e = HP._corner_entries(spec, HP._cells_and_weights(spec, x)[0])
    rows = torch.cat([e, e + 1], 1).permute(1, 0, 2)              # [8, L, N]
    assert K.a_l2_sectors(spec, x) == _distinct_sectors(rows) + (
        12 * 200 + 4 * 200 * spec.out_dim) // 32


def test_l2_sector_count_of_c():
    """kernel_times.c_l2_sectors (kernel C's L2 figure): per (point,
    section) the distinct sectors of its 4 plane rows and its 2 line rows,
    against a brute-force count, plus x read and the output written; N
    copies of one point count N times its sectors."""
    from coslam_torch.ops import tensovm as VM
    from coslam_torch.tools import kernel_times as K

    x = torch.from_numpy(np.random.default_rng(2).uniform(
        -0.05, 1.05, (250, 3)).astype(np.float32))
    spec = VM.make_tensovm_spec(96, 3, base_resolution=16)

    def brute(x):
        geo = VM._Geometry(spec, torch.zeros((spec.total_entries, 2)),
                           torch.zeros((VM.line_total_rows(spec), 2)), x)
        return (_distinct_sectors(torch.stack([geo.e00, geo.e00 + 1, geo.e10,
                                               geo.e10 + 1]))
                + _distinct_sectors(torch.stack([geo.l_row, geo.l_row + 1])))

    io = (12 * 250 + 4 * 250 * spec.out_dim) // 32
    assert K.c_l2_sectors(spec, x) == brute(x) + io
    one = x[:1].repeat(250, 1)
    assert K.c_l2_sectors(spec, one) == 250 * brute(x[:1]) + io


def test_wrapper_checks_and_level_tables():
    """The encode wrappers' card-path helpers: each module's _check_cuda
    (A/B, C/D, E/G) refuses tensors that are not on a CUDA card through
    _kernels.check_tensors, and the level tables the kernels read are made
    once per (spec, device) and hold the spec's layout."""
    from coslam_torch.ops import _kernels
    from coslam_torch.ops import encodings as E
    from coslam_torch.ops import hash_packed as HP
    from coslam_torch.ops import hash_pallas as XP
    from coslam_torch.ops import tensovm as VM

    cpu = torch.device("cpu")
    x = torch.zeros((5, 3))
    spec = HP.make_packed_spec(96, 12, n_levels=6)
    xspec = E.make_hashgrid_spec(96, 12, n_levels=6)
    vspec = VM.make_tensovm_spec(96, 3, base_resolution=16)
    planes = torch.zeros((vspec.total_entries, 2))
    lines = torch.zeros((VM.line_total_rows(vspec), 2))
    for call in (
            lambda: HP._check_cuda(spec, torch.zeros((spec.total_entries, 2)),
                                   x),
            lambda: XP._check_cuda(xspec,
                                   torch.zeros((xspec.total_entries, 2)), x),
            lambda: VM._check_cuda(vspec, planes, lines, x),
            lambda: _kernels.check_tensors("t", torch.device("cuda", 0),
                                           x=x)):
        with pytest.raises(ValueError, match="is on cpu"):
            call()
    levels = _kernels.level_table(spec, cpu)
    assert _kernels.level_table(spec, cpu) is levels
    assert levels.tolist() == [list(spec.resolutions), list(spec.offsets),
                               [int(h) for h in spec.hashed]]
    vlevels = VM._level_table(vspec, cpu)
    assert VM._level_table(vspec, cpu) is vlevels
    sec0 = range(0, vspec.n_levels, 3)
    assert vlevels.tolist() == [[vspec.resolutions[s] for s in sec0],
                                [vspec.offsets[s] for s in sec0],
                                [VM._line_offsets(vspec)[s] for s in sec0]]
