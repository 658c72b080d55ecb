"""The port's twins of tests/test_integration.py (mapping, tracking, the
full loop, checkpoints, crash-resume, the current-frame step) on the
small analytic scene, and the port against the JAX package for what
crosses between them: the current-frame step, a JAX checkpoint loaded
into the port (and one BA iteration from it), the checkpoint's leaf
order, and the serial-order streams of kernels B and D.

Sizes as tests/test_integration.py: make_synthetic_config at 40 x 52,
8-12 frames, first_iters 100 (ray batches cut to keep the file's CPU
time small). Tolerances: a resumed run equals the straight run bit for
bit (atol 0: the CPU path adds in a fixed order, and the checkpoint
carries the whole state); the current-frame step (one iteration, a
fresh Adam) as tests/test_torch_slice.py's BA iteration: the loss to rtol
1e-4, the parameters after the Adam step to atol 1e-6 where the gradient
is not within a thousand eps of zero, and within lr elsewhere. The BA
iteration from a JAX checkpoint: the loss to rtol 1e-4 as there, the
gradients norm-wise to 1e-3 (from a trained map they cancel, so single
small entries carry the two models' f32 noise above the slice's
elementwise 1e-6 of the largest entry), and the Adam step from the
loaded moments and counts, on JAX's gradient, to atol 1e-6.
"""

import copy
import os
import re

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
from coslam_torch import convert
from coslam_torch.data.datasets import get_dataset
from coslam_torch.models.scene_rep import JointEncoding as TModel
from coslam_torch.models.scene_rep import is_factorized
from coslam_torch.ops import hash_packed as HP
from coslam_torch.ops import pose as TP
from coslam_torch.ops import serial_scatter as SS
from coslam_torch.ops import tensovm as VM
from coslam_torch.ops import triplane as TPL
from coslam_torch.runtime import checkpoint as CK
from coslam_torch.runtime.mapping import (BundleAdjust, build_poses,
                                          make_current_frame_step,
                                          make_first_frame_step)
from coslam_torch.runtime.optim import (grid_leaves, make_cur_map_optimizer,
                                        make_map_optimizer, map_param_list)
from coslam_torch.runtime.slam import CoSLAM
from coslam_torch.runtime.tracking import make_tracking_step

torch.set_num_threads(1)


def _vm(cfg):
    cfg["grid"].update(enc="TensoVM", triplane_levels=3)
    return cfg


# Grids beside the hash grid, as config updates: TensoVM, TriPlaneHybrid
# (dict grid {"dense", "planes"}) and the hash grid with a color grid
# (oneGrid false).
GRID_CFGS = {"tensovm": {"enc": "TensoVM", "triplane_levels": 3},
             "hybrid": {"enc": "TriPlaneHybrid", "triplane_levels": 3},
             "two_grids": {"oneGrid": False}}


def _grid_cfg(cfg, grid):
    cfg["grid"].update(GRID_CFGS.get(grid, {}))
    return cfg


def _frame(cfg, pose):
    cam = cfg["cam"]
    rgb, depth = render_frame(AnalyticScene(), pose, cam["H"], cam["W"],
                              cam["fx"], cam["fy"], cam["cx"], cam["cy"])
    dirs = get_camera_rays(cam["H"], cam["W"], cam["fx"], cam["fy"],
                           cam["cx"], cam["cy"])
    return rgb, depth, dirs


def _scene_config(root, n_frames, out="out", vm=False):
    """A written n_frames scene (the trajectory of test_full_slam_loop)
    and its config, with 128-ray batches."""
    datadir = os.path.join(root, f"scene{n_frames}")
    cfg = make_synthetic_config(datadir, os.path.join(root, out), H=40, W=52,
                                n_frames=n_frames)
    if vm:
        _vm(cfg)
    cfg["mapping"].update(first_iters=100, sample=128)
    cfg["tracking"]["sample"] = 128
    cfg["mesh"]["vis"] = 0
    if not os.path.exists(datadir):
        cam = cfg["cam"]
        write_replica_format(datadir, AnalyticScene(),
                             make_trajectory(n_frames, orbit_fraction=0.02),
                             cam["H"], cam["W"], cam["fx"], cam["fy"],
                             cam["cx"], cam["cy"])
    return cfg


def _out(cfg):
    return os.path.join(cfg["data"]["output"], cfg["data"]["exp_name"])


# -- the twins of tests/test_integration.py ----------------------------------

@pytest.fixture(scope="module")
def trained_scene():
    """The port's map trained on one ground-truth frame (first_iters 200
    at 256 rays)."""
    cfg = make_synthetic_config("", "/tmp/unused", H=40, W=52)
    cfg["mapping"].update(first_iters=200, sample=256)
    pose0 = make_trajectory(4)[0]
    bb = np.array(cfg["mapping"]["bound"], np.float32)
    model = TModel(cfg, bb)
    params = model.init_params(torch.Generator().manual_seed(0))
    opt = make_map_optimizer(cfg, params)
    rgb, depth, dirs = _frame(cfg, pose0)
    frame = np.concatenate([dirs.reshape(-1, 3), rgb.reshape(-1, 3),
                            depth.reshape(-1, 1)], 1).astype(np.float32)
    _, psnr = make_first_frame_step(model, cfg, opt)(
        params, torch.from_numpy(pose0), torch.from_numpy(frame),
        torch.Generator().manual_seed(1))
    return cfg, pose0, model, params, (rgb, depth, dirs), float(psnr)


def test_mapping_converges(trained_scene):
    cfg, pose0, model, params, (rgb, depth, dirs), psnr = trained_scene
    assert psnr > 28.0
    idx = np.random.default_rng(0).choice(dirs.reshape(-1, 3).shape[0], 256,
                                          replace=False)
    rays_d = dirs.reshape(-1, 3)[idx] @ pose0[:3, :3].T
    zz = depth.reshape(-1)[idx]
    with torch.no_grad():
        ret = model.render_rays(
            params, torch.from_numpy(np.broadcast_to(
                pose0[:3, 3], rays_d.shape).astype(np.float32)),
            torch.from_numpy(rays_d.astype(np.float32)),
            target_d=torch.from_numpy(zz[:, None].astype(np.float32)))
    assert np.median(np.abs(ret["depth"].numpy() - zz)) < 0.02


def test_tracking_recovers_pose(trained_scene):
    cfg, pose0, model, params, (rgb, depth, dirs), _ = trained_scene
    cfg = copy.deepcopy(cfg)
    cfg["tracking"].update(iter=30, best=True, lr_rot=0.002, lr_trans=0.002,
                           sample=256)
    pert = pose0.copy()
    pert[:3, 3] += np.array([0.01, -0.008, 0.012], np.float32)
    iH = iW = 4
    dd = dirs[iH:-iH, iW:-iW].reshape(-1, 3)
    rr = rgb[iH:-iH, iW:-iW].reshape(-1, 3)
    zz = depth[iH:-iH, iW:-iW].reshape(-1, 1)
    idx = np.random.default_rng(3).choice(dd.shape[0],
                                          cfg["tracking"]["sample"],
                                          replace=False)
    rays = np.concatenate([dd[idx], rr[idx], zz[idx]], 1).astype(np.float32)
    c2w, _, _, _ = make_tracking_step(model, cfg)(
        params, torch.from_numpy(pert), torch.from_numpy(rays),
        torch.Generator().manual_seed(0))
    init_terr = np.abs(pert[:3, 3] - pose0[:3, 3]).mean()
    final_terr = np.abs(c2w.numpy()[:3, 3] - pose0[:3, 3]).mean()
    assert final_terr < 0.5 * init_terr


@pytest.fixture(scope="module")
def straight_runs(tmp_path_factory):
    """grid -> (config, CoSLAM) of a straight 12-frame run that wrote
    checkpoint6.npz (ckpt_every 6), for the hash grid and TensoVM."""
    root = str(tmp_path_factory.mktemp("runs"))
    runs = {}

    def get(grid):
        if grid not in runs:
            cfg = _scene_config(root, 12, out=f"out_{grid}",
                                vm=grid == "tensovm")
            slam = CoSLAM(cfg, get_dataset(cfg), device="cpu")
            slam.run(verbose=False, mesh=False, ckpt_every=6)
            runs[grid] = (cfg, slam)
        return runs[grid]

    return get


def test_full_slam_loop(straight_runs):
    """The 12-frame sequence through the whole loop: ATE < 5 cm, keyframes
    0, 5 and 10, the periodic and final checkpoints, both ATE files."""
    cfg, slam = straight_runs("hash")
    res = slam.evaluate_ate(12)
    assert np.isfinite(res["absolute_translational_error.rmse"])
    assert res["absolute_translational_error.rmse"] < 0.05
    assert slam.kf_db.count == 3 and list(slam.kf_db.frame_ids) == [0, 5, 10]
    files = os.listdir(_out(cfg))
    assert {"checkpoint6.npz", "checkpoint11.npz", "output.txt",
            "output_relative.txt"} <= set(files), files
    assert not any(f.endswith(".tmp") for f in files)
    # Keyframes keep their own pose; the rest compose a stored delta.
    rel = slam.convert_relative_pose()
    assert sorted(rel) == list(range(12))
    np.testing.assert_array_equal(rel[5], slam.est_c2w[5])
    assert sorted(slam.est_c2w_rel) == [0, 1, 2, 3, 4, 6, 7, 8, 9, 11]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _params_equal(a, b):
    for x, y in zip(CK.param_leaves(a), CK.param_leaves(b), strict=True):
        np.testing.assert_array_equal(_np(x), _np(y))


def test_checkpoint_roundtrip(tmp_path, trained_scene):
    _, pose0, _, params, _, _ = trained_scene
    est = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    rel = {1: np.asarray(pose0, np.float32)}
    extra = {"frame_cursor": np.int64(4),
             "opt_state": [np.int32(3), np.arange(3, dtype=np.float32)]}
    p = str(tmp_path / "ck.npz")
    CK.save_ckpt(p, params, est, rel, extra)
    params2, est2, rel2, extra2 = CK.load_ckpt(p, params)
    np.testing.assert_array_equal(est, est2)
    np.testing.assert_array_equal(rel[1], rel2[1])
    _params_equal(params, params2)
    assert int(extra2["frame_cursor"]) == 4
    assert int(extra2["opt_state"][0]) == 3
    np.testing.assert_array_equal(extra2["opt_state"][1], np.arange(3))
    with np.load(p) as f:
        assert "treedef" not in f and not any(k.startswith("extree_")
                                              for k in f)
    with pytest.raises(NotImplementedError):
        CK.save_ckpt(str(tmp_path / "ck.orbax"), params, est, rel)


@pytest.mark.parametrize("grid", ["hybrid", "two_grids"])
def test_checkpoint_and_convert_roundtrip(grid, tmp_path):
    """A TriPlaneHybrid model (dict grid {"dense", "planes"}) and a
    two-grid one (grid_color): the JAX package's params -> the port's
    tensors -> numpy unchanged, and a port checkpoint with the map
    optimizer's state (adam_state_to_jax) read back into a fresh model
    and optimizer unchanged."""
    cfg = _grid_cfg(make_synthetic_config("", "/tmp/unused", H=24, W=32),
                    grid)
    bb = np.array(cfg["mapping"]["bound"], np.float32)
    jm, tm = JModel(cfg, bb), TModel(cfg, bb)
    np_params = jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    params = convert.params_from_numpy(np_params, spec=tm.grid_spec)
    if grid == "hybrid":
        assert set(params["grid"]) == {"dense", "planes"}
        dspec, pspec = tm.grid_spec
        assert params["grid"]["dense"].shape == (dspec.total_entries, 2)
        assert params["grid"]["planes"].shape == (pspec.total_entries, 2)
    else:
        assert "grid_color" in params
    for a, b in zip(jax.tree_util.tree_leaves(convert.params_to_numpy(params)),
                    jax.tree_util.tree_leaves(np_params), strict=True):
        np.testing.assert_array_equal(a, b)

    opt = make_map_optimizer(cfg, params)
    for p in map_param_list(params):
        p.grad = torch.ones_like(p)
    opt.step()
    est = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    path = str(tmp_path / "ck.npz")
    CK.save_ckpt(path, params, est, {},
                 {"opt_state": convert.adam_state_to_jax(opt, params)})
    fresh = tm.init_params(torch.Generator().manual_seed(1))
    loaded, _, _, extra = CK.load_ckpt(path, fresh)
    _params_equal(params, loaded)
    loaded = convert.params_from_numpy(loaded)
    opt2 = make_map_optimizer(cfg, loaded)
    convert.adam_state_from_jax(opt2, loaded, extra["opt_state"])
    for a, b in zip(convert.adam_state_to_jax(opt, params),
                    convert.adam_state_to_jax(opt2, loaded), strict=True):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_mesh_render_color_matches_jax(trained_scene):
    """mesh.render_color: the vertex colors rendered along the mesh's
    vertex normals (the model's render_surface_color) equal the JAX
    JointEncoding.render_surface_color of the same map at the same
    vertices and normals (rtol 1e-4, atol 1e-5: the query's f32 sums in
    another order)."""
    from coslam_torch.mesh.extract import extract_mesh
    from coslam_torch.mesh.io import TriMesh

    cfg, _, model, params, _, _ = trained_scene
    cfg = copy.deepcopy(cfg)
    cfg["mesh"]["render_color"] = True
    bb = np.array(cfg["mapping"]["bound"], np.float32)
    mesh = extract_mesh(model, params, cfg, bb,
                        color_func=model.render_surface_color,
                        voxel_size=0.2)
    assert len(mesh.vertices) > 100
    colors = np.asarray(mesh.vertex_colors)
    assert colors.shape == (len(mesh.vertices), 3)
    normals = TriMesh(mesh.vertices, mesh.faces).vertex_normals
    jparams = jax.tree_util.tree_map(jnp.asarray,
                                     convert.params_to_numpy(params))
    ref = JModel(cfg, bb).render_surface_color(
        jparams, jnp.asarray(mesh.vertices, jnp.float32),
        jnp.asarray(normals, jnp.float32))
    np.testing.assert_allclose(colors, np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_async_checkpoint_snapshot(tmp_path, trained_scene):
    """The writer's file holds the state as of submit, though the caller
    updates the parameters and the pose table in place after it; the
    write is atomic (no .tmp left)."""
    _, pose0, _, params, _, _ = trained_scene
    params = {"grid": params["grid"].detach().clone(),
              "decoder": {k: [w.detach().clone() for w in v]
                          for k, v in params["decoder"].items()}}
    before = {"grid": params["grid"].clone(),
              "decoder": {k: [w.clone() for w in v]
                          for k, v in params["decoder"].items()}}
    est = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    p = str(tmp_path / "ck_async.npz")
    w = CK.AsyncCheckpointWriter()
    w.submit(p, params, est, {1: np.asarray(pose0, np.float32)},
             {"frame_cursor": np.int64(6)})
    for leaf in CK.param_leaves(params):    # an Adam step's in-place update
        leaf.fill_(-1.0)
    est[:] = -1.0
    w.wait()
    assert os.path.exists(p) and not os.path.exists(p + ".tmp")
    params2, est2, rel2, extra2 = CK.load_ckpt(p, params)
    _params_equal(before, params2)
    np.testing.assert_array_equal(est2, np.tile(np.eye(4, dtype=np.float32),
                                                (5, 1, 1)))
    np.testing.assert_array_equal(rel2[1], pose0)
    assert int(extra2["frame_cursor"]) == 6


@pytest.mark.parametrize("grid", ["hash", "tensovm"])
def test_resume_reproduces_straight_run(grid, tmp_path, straight_runs):
    """A run resumed from the straight run's checkpoint6.npz ends with
    the straight run's poses and parameters bit for bit."""
    cfg, slam_a = straight_runs(grid)
    cfg_b = copy.deepcopy(cfg)
    cfg_b["data"]["output"] = str(tmp_path / "outB")
    slam_b = CoSLAM(cfg_b, get_dataset(cfg_b), device="cpu")
    start = slam_b.load_checkpoint(os.path.join(_out(cfg), "checkpoint6.npz"))
    assert start == 6 and slam_b.kf_db.count == 2
    slam_b.run(verbose=False, mesh=False, start_frame=start)
    np.testing.assert_allclose(slam_b.est_c2w, slam_a.est_c2w, rtol=0, atol=0)
    _params_equal(slam_b.params, slam_a.params)
    assert slam_b.est_c2w_rel.keys() == slam_a.est_c2w_rel.keys()
    # A finished run's final checkpoint resumes to its end at once.
    slam_c = CoSLAM(cfg_b, get_dataset(cfg_b), device="cpu")
    assert slam_c.load_checkpoint(
        os.path.join(_out(cfg_b), "checkpoint11.npz")) == 12


def test_current_frame_mapping_path(tmp_path):
    """mapping.cur_frame_iters > 0: the grid-only refinement runs before
    every BA call and the trajectory stays within 5 cm."""
    cfg = _scene_config(str(tmp_path), 8)
    cfg["mapping"]["cur_frame_iters"] = 2
    slam = CoSLAM(cfg, get_dataset(cfg), device="cpu")
    assert slam._cur_step is not None
    calls = []
    step = slam._cur_step
    slam._cur_step = lambda *a: calls.append(1) or step(*a)
    res = slam.run(verbose=False, mesh=False)
    assert len(calls) == len(slam.timings["mapping"]) == 1
    assert np.isfinite(res["absolute_translational_error.rmse"])
    assert res["absolute_translational_error.rmse"] < 0.05
    state = slam.cur_map_opt.state[slam.params["grid"]]
    assert int(state["step"]) == 2


def test_cli_checkpoints_and_resumes_from_the_newest(tmp_path, capsys):
    """python -m coslam_torch --ckpt_every writes periodic checkpoints and
    the final one; --ckpt auto resumes from the highest-numbered
    checkpoint*.npz of the run's output directory (here the finished
    run's final one, whose cursor is its length), and exits with a
    message when there is none."""
    import yaml

    from coslam_torch import cli

    cfg = _scene_config(str(tmp_path), 8)
    cfg["mapping"].update(first_iters=10, sample=64, iters=2)
    cfg["tracking"].update(sample=64, iter=2)
    path = str(tmp_path / "run.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    with pytest.raises(SystemExit, match="no checkpoint"):
        cli.main(["--config", path, "--device", "cpu", "--ckpt", "auto"])
    cli.main(["--config", path, "--device", "cpu", "--max_frames", "7",
              "--ckpt_every", "3"])
    files = os.listdir(_out(cfg))
    assert {"checkpoint3.npz", "checkpoint6.npz"} <= set(files), files
    with open(os.path.join(_out(cfg), "checkpoint20.npz.tmp"), "wb"):
        pass
    capsys.readouterr()
    cli.main(["--config", path, "--device", "cpu", "--max_frames", "7",
              "--ckpt", "auto"])
    assert "resuming from frame 7 of" in capsys.readouterr().out
    assert cli.newest_checkpoint(_out(cfg)).endswith("checkpoint6.npz")


# -- against the JAX package -------------------------------------------------

def _jax_paths(tree):
    return [(jax.tree_util.keystr(p), leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("grid", ["hash", "tensovm", "hybrid",
                                  "two_grids"])
def test_leaf_order_matches_jax(grid):
    """The port's leaf_i order is jax.tree_util.tree_flatten's of the JAX
    params, and its optimizer-state layout is the flatten order of a live
    optax map-optimizer state: each moment lands on its own parameter
    (the color grid's too, under its own label)."""
    from coslam_tpu.runtime.optim import make_map_optimizer as j_map_opt

    cfg = _grid_cfg(make_synthetic_config("", "/tmp/unused", H=24, W=32),
                    grid)
    bb = np.array(cfg["mapping"]["bound"], np.float32)
    jm, tm = JModel(cfg, bb), TModel(cfg, bb)
    jparams = jm.init_params(jax.random.PRNGKey(0))
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), spec=tm.grid_spec)
    for a, b in zip(jax.tree_util.tree_leaves(jparams),
                    CK.param_leaves(params), strict=True):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())

    # A live optax state whose every leaf differs: distinct counts per
    # label, mu and nu filled from distinct streams.
    tx = j_map_opt(cfg)
    state = tx.init(jparams)
    leaves, treedef = jax.tree_util.tree_flatten(state)
    rng = np.random.default_rng(0)
    vals = [np.int32(7 + i) if np.ndim(x) == 0 else
            rng.standard_normal(np.shape(x)).astype(np.float32)
            for i, x in enumerate(leaves)]
    state = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(v)
                                                   for v in vals])
    opt = make_map_optimizer(cfg, params)
    convert.adam_state_from_jax(opt, params, vals)

    def port_leaf(keys):
        """The port's tensor at a JAX key path ['decoder']['sdf_net'][0]."""
        p = params
        for k in re.findall(r"\[([^\]]+)\]", keys):
            p = p[int(k)] if k.isdigit() else p[k.strip("'")]
        return p

    n = 0
    for path, leaf in _jax_paths(state):
        label = next((k for k in ("grid", "grid_color")
                      if f"inner_states['{k}']" in path), "decoder")
        first = convert.label_leaves(params, label)[0]
        if path.endswith(".count"):
            assert int(opt.state[first]["step"]) == int(leaf), path
            n += 1
            continue
        moment = ".mu" if ".mu" in path else ".nu"
        key = "exp_avg" if moment == ".mu" else "exp_avg_sq"
        p = port_leaf(path[path.index(moment) + 3:])
        np.testing.assert_array_equal(opt.state[p][key].numpy(),
                                      np.asarray(leaf), err_msg=path)
        n += 1
    assert n == len(leaves)
    back = convert.adam_state_to_jax(opt, params)
    assert len(back) == len(vals)
    for a, b in zip(back, vals):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_stream_plain_versions_match_plain_backward():
    """row_accum_ref of kernel B's, U's and D's serial-order streams equals
    the plain backward's table gradients bit for bit on the CPU."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-0.05, 1.05, (700, 3)).astype(np.float32))
    spec = HP.make_packed_spec(64, 12, n_levels=8)
    table = torch.from_numpy(rng.standard_normal(
        (spec.total_entries, 2)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(
        (700, spec.out_dim)).astype(np.float32))
    dtable, _ = HP.grid_encode_bwd_ref(spec, table, x, g, True, False)
    idx, vals = HP.grid_encode_bwd_streams_ref(spec, table, x, g)
    assert idx.shape == (2 * 8 * 4 * 700,) and vals.shape == (idx.shape[0], 2)
    assert torch.equal(SS.row_accum_ref(idx, vals, spec.total_entries)[:-1],
                       dtable)

    ts = TPL.make_triplane_spec(64, 3)
    planes = torch.from_numpy(rng.standard_normal(
        (ts.total_entries, 2)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(
        (700, ts.out_dim)).astype(np.float32))
    dtable, _ = TPL.triplane_encode_bwd_ref(ts, planes, x, g, True, False)
    idx, vals = TPL.triplane_encode_bwd_streams_ref(ts, planes, x, g)
    assert idx.shape == (4 * ts.n_levels * 700,)
    assert torch.equal(SS.row_accum_ref(idx, vals, ts.total_entries)[:-1],
                       dtable)

    vs = VM.make_tensovm_spec(64, 3)
    planes = torch.from_numpy(rng.standard_normal(
        (vs.total_entries, 2)).astype(np.float32))
    lines = torch.from_numpy((1 + 0.1 * rng.standard_normal(
        (VM.line_total_rows(vs), 2))).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(
        (700, vs.out_dim)).astype(np.float32))
    dp, dl, _ = VM.tensovm_encode_bwd_ref(vs, planes, lines, x, g, True, True,
                                          False)
    idx, vals = VM.tensovm_encode_bwd_streams_ref(vs, planes, lines, x, g)
    assert idx.shape == (6 * vs.n_levels * 700,)
    out = SS.row_accum_ref(idx, vals, vs.total_entries + lines.shape[0])
    assert torch.equal(out[:vs.total_entries], dp)
    assert torch.equal(out[vs.total_entries:-1], dl)


def _after_adam_close(got, ref, g, eps, lr):
    """The parameters after an Adam step: atol 1e-6 where |g| is above a
    thousand eps, within lr where the step follows g's f32 noise."""
    tiny = np.abs(g) < 1e3 * eps
    np.testing.assert_allclose(got[~tiny], ref[~tiny], atol=1e-6)
    assert np.all(np.abs(got - ref)[tiny] <= lr * 1.01)


@pytest.mark.parametrize("grid", ["hash", "tensovm"])
def test_current_frame_step_matches_jax(grid):
    """One call of the current-frame step (one iteration) against JAX's
    make_current_frame_step, the pixel indices and the perturbation of
    the JAX step's key handed to the port: loss and grid after Adam."""
    from coslam_tpu.runtime.mapping import make_current_frame_step as j_step
    from coslam_tpu.runtime.optim import _adam_l2

    cfg = make_synthetic_config("", "/tmp/unused", H=24, W=32)
    if grid == "tensovm":
        _vm(cfg)
    cfg["mapping"].update(cur_frame_iters=1, sample=64)
    cfg["training"]["perturb"] = 1
    bb = np.array(cfg["mapping"]["bound"], np.float32)
    jm, tm = JModel(cfg, bb), TModel(cfg, bb)
    jparams = jm.init_params(jax.random.PRNGKey(0))
    pose = make_trajectory(4)[1]
    rgb, depth, dirs = _frame(cfg, pose)
    frame = np.concatenate([dirs.reshape(-1, 3), rgb.reshape(-1, 3),
                            depth.reshape(-1, 1)], 1).astype(np.float32)
    key = jax.random.PRNGKey(5)
    tx = _adam_l2(cfg["mapping"]["lr_embed"], 0.9, 0.99, 1e-15)
    j_grid, _, j_loss = j_step(jm, cfg, tx)(
        jparams["grid"], jparams["decoder"], tx.init(jparams["grid"]),
        jnp.asarray(pose), jnp.asarray(frame), key)

    # The draws of the JAX step's only iteration (mapping.py body, and
    # render_rays' split of the forward's key).
    k1, k2 = jax.random.split(jax.random.split(key, 1)[0])
    idx = jax.random.randint(k1, (64,), 0, frame.shape[0])
    t = jax.random.uniform(jax.random.split(k2)[0], (64, tm.n_z_samples))

    def j_loss_fn(gp):
        rays = jnp.asarray(frame)[idx]
        rd = rays[:, :3] @ jnp.asarray(pose[:3, :3]).T
        ret = jm.forward({"grid": gp, "decoder": jparams["decoder"]}, k2,
                         jnp.broadcast_to(jnp.asarray(pose[:3, 3]), rd.shape),
                         rd, rays[:, 3:6], rays[:, 6:7])
        return JL.total_loss(ret, cfg["training"])

    j_val, j_g = jax.value_and_grad(j_loss_fn)(jparams["grid"])
    np.testing.assert_allclose(float(j_val), float(j_loss), rtol=1e-5)

    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), spec=tm.grid_spec)
    make_map_optimizer(cfg, params)              # marks them trainable
    opt = make_cur_map_optimizer(cfg, params)
    loss = make_current_frame_step(tm, cfg, opt)(
        params, torch.from_numpy(pose), torch.from_numpy(frame), None,
        draws=[(torch.from_numpy(np.asarray(idx, np.int64)),
                torch.from_numpy(np.array(t)))])
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4)
    for p, ref, g in zip(grid_leaves(params["grid"]),
                         jax.tree_util.tree_leaves(j_grid),
                         jax.tree_util.tree_leaves(j_g)):
        _after_adam_close(p.detach().numpy(), np.asarray(ref), np.asarray(g),
                          1e-15, cfg["mapping"]["lr_embed"])
    for w in map_param_list(params)[len(grid_leaves(params["grid"])):]:
        assert w.grad is None                    # the decoder stays fixed


def test_jax_checkpoint_loads_into_port(tmp_path):
    """A JAX CoSLAM run writes checkpoint6.npz mid-run; the port loads
    its map, Adam moments and counts, keyframe rays (unpacked from the
    128-lane layout), poses and cursor unchanged, and one BA iteration
    from the loaded state, with the JAX step's draws, matches the JAX BA
    iteration from the same checkpoint."""
    from coslam_tpu.runtime.keyframe import unpack_rays as j_unpack
    from coslam_tpu.runtime.mapping import make_ba_step
    from coslam_tpu.runtime.slam import CoSLAM as JCoSLAM

    cfg = _scene_config(str(tmp_path), 8)
    cfg["training"]["perturb"] = 0
    jslam = JCoSLAM(cfg)
    jslam.run(verbose=False, eval_ate=False, ckpt_every=6)
    ckpt = os.path.join(_out(cfg), "checkpoint6.npz")
    jslam = JCoSLAM(cfg)
    assert jslam.load_checkpoint(ckpt) == 6

    slam = CoSLAM(cfg, get_dataset(cfg), device="cpu")
    assert slam.load_checkpoint(ckpt) == 6
    for a, b in zip(jax.tree_util.tree_leaves(jslam.params),
                    CK.param_leaves(slam.params), strict=True):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())
    np.testing.assert_array_equal(slam.est_c2w, jslam.est_c2w)
    assert slam.est_c2w_rel.keys() == jslam.est_c2w_rel.keys()
    j_rays = np.asarray(j_unpack(jslam.kf_db.rays))
    np.testing.assert_array_equal(slam.kf_db.rays.numpy(), j_rays)
    assert slam.kf_db.num_rays_to_save == jslam.kf_db.num_rays_to_save
    assert slam.kf_db.count == jslam.kf_db.count == 2
    assert list(slam.kf_db.frame_ids) == list(jslam.kf_db.frame_ids)
    np.testing.assert_array_equal(slam.kf_poses.numpy(),
                                  np.asarray(jslam.kf_poses))
    for a, b in zip(jax.tree_util.tree_leaves(jslam.map_opt_state),
                    convert.adam_state_to_jax(slam.map_opt, slam.params),
                    strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert int(jax.tree_util.tree_leaves(jslam.map_opt_state)[0]) > 100

    # One BA iteration from the loaded state on both sides.
    c = copy.deepcopy(cfg)
    c["mapping"].update(iters=1, pose_accum_step=1)
    m, w = c["mapping"], c["training"]
    K, R, kf_count = slam.kf_db.num_kf, slam.kf_db.num_rays_to_save, 2
    batch = slam.dataset[6]
    cur_rays = slam._frame_block(batch).numpy()
    cur_pose, kf_poses = slam.est_c2w[5], slam.kf_poses.numpy()
    key = jax.random.PRNGKey(4)
    out = make_ba_step(jslam.model, c, jslam.map_tx, K, R, R)(
        jslam.params, jslam.map_opt_state, jnp.asarray(j_rays),
        jnp.int32(kf_count), jnp.asarray(kf_poses), jnp.asarray(cur_pose),
        jnp.asarray(cur_rays), key)
    j_after, j_loss = out[0], float(out[4])

    k1, k2, k3 = jax.random.split(jax.random.split(key, 1)[0], 3)
    idx = np.asarray(jax.random.randint(k1, (m["sample"],), 0, kf_count * R))
    cur_idx = np.asarray(jax.random.randint(k2, (m["sample"],), 0,
                                            cur_rays.shape[0]))
    quota = max(m["sample"] // kf_count, m["min_pixels_cur"])
    smooth_key = jax.random.split(k3)[1]
    draw = (jslam.model.smoothness_axes if is_factorized(c)
            else jslam.model.smoothness_points)
    smooth = np.asarray(draw(smooth_key, w["smooth_pts"], w["smooth_vox"],
                             w["smooth_margin"]))
    ray_data = np.concatenate([j_rays.reshape(-1, 7)[idx],
                               cur_rays[cur_idx[:quota]]])
    ray_ids = np.concatenate([idx // R, np.full(quota, K)])
    poses0 = np.concatenate([kf_poses, cur_pose[None]]).astype(np.float32)

    def j_loss_fn(mp):
        mats = JP.at_to_transform_matrix(
            JP.matrix_to_axis_angle(jnp.asarray(poses0[:, :3, :3])),
            jnp.asarray(poses0[:, :3, 3])).at[0].set(jnp.asarray(poses0[0]))
        rows = mats[jnp.asarray(ray_ids)]
        rd = jnp.einsum("nij,nj->ni", rows[:, :3, :3],
                        jnp.asarray(ray_data[:, :3]))
        ret = jslam.model.forward(mp, k3, rows[:, :3, 3], rd,
                                  jnp.asarray(ray_data[:, 3:6]),
                                  jnp.asarray(ray_data[:, 6:7]))
        sm = jslam.model.smoothness(mp, smooth_key, w["smooth_pts"],
                                    w["smooth_vox"], w["smooth_margin"])
        return JL.total_loss(ret, w, smooth_loss=sm,
                             smooth_weight=w["smooth_weight"])

    j_val, j_g = jax.jit(jax.value_and_grad(j_loss_fn))(jslam.params)
    np.testing.assert_allclose(float(j_val), j_loss, rtol=1e-5)

    ba = BundleAdjust(slam.model, c, slam.map_opt, K)
    p0 = torch.from_numpy(poses0)
    rot = TP.matrix_to_axis_angle(p0[:, :3, :3]).requires_grad_(True)
    trans = p0[:, :3, 3].clone().requires_grad_(True)
    slam.map_opt.zero_grad(set_to_none=True)
    loss = ba.loss(slam.params,
                   build_poses(rot, trans, p0, ba.frozen_mask("cpu"),
                               TP.at_to_transform_matrix),
                   torch.from_numpy(ray_data), torch.from_numpy(ray_ids),
                   torch.from_numpy(smooth), None)
    loss.backward()
    np.testing.assert_allclose(float(loss), j_loss, rtol=1e-4)
    leaves = CK.param_leaves(slam.params)
    j_grads = [np.asarray(g) for g in jax.tree_util.tree_leaves(j_g)]
    for p, g in zip(leaves, j_grads, strict=True):
        # Norm-wise: from a trained map the gradients cancel, so single
        # small entries carry the two models' f32 noise well above 1e-6
        # of the largest entry.
        assert (np.linalg.norm(p.grad.numpy() - g)
                <= 1e-3 * np.linalg.norm(g)), g.shape
    # The step itself from the loaded moments and counts, on JAX's
    # gradient: a count taken for another step or a moment on another
    # tensor moves it by far more than 1e-6.
    for p, g in zip(leaves, j_grads):
        p.grad = torch.from_numpy(g.copy())
    slam.map_opt.step()
    for p, ref in zip(leaves, jax.tree_util.tree_leaves(j_after),
                      strict=True):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref),
                                   rtol=0, atol=1e-6)
