"""training.frame_align, point-cloud tracking and the pose table in the
port against the JAX package: init_frame_align and apply_frame_align,
one tracking step optimizing the pose and the frame's exposure, one BA
iteration with the [max_kf + 1, 4] exposure table (gauge row frozen), the
loop's exposure state and its checkpoint (the port's file and the JAX
package's), make_tracking_pc_step on the same rays, and pose_array.

Tolerances: the tracking steps as tests/test_torch_slice.py's (perturb
0; losses rtol 1e-4, poses and exposure parameters atol 1e-5: each Adam
step moves an entry by about lr whatever the gradient's size); the BA
iteration as test_torch_importance.check_ba_iteration states; the
checkpoints bit for bit; pose_array 1e-6 (a few f32 operations).
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coslam_tpu.data.synth import make_synthetic_config, make_trajectory
from coslam_tpu.ops import frame_align as JFA
from coslam_tpu.ops import pose_array as JPA
from coslam_tpu.runtime.tracking import make_tracking_pc_step as j_pc_step
from coslam_tpu.runtime.tracking import make_tracking_step as j_tracking
from coslam_torch import convert
from coslam_torch.ops import frame_align as TFA
from coslam_torch.ops import pose_array as TPA
from coslam_torch.runtime.slam import CoSLAM
from coslam_torch.runtime.tracking import (make_tracking_pc_step,
                                           make_tracking_step)

from test_torch_importance import check_ba_iteration
from test_torch_integration import _out, _scene_config
from test_torch_slice import _models, _scene

torch.set_num_threads(1)


def test_frame_align_matches_jax():
    """init_frame_align (gains 1, offset 0) and apply_frame_align at one
    frame and at a per-pixel index, as the JAX functions."""
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(TFA.init_frame_align(5).numpy(),
                                  np.asarray(JFA.init_frame_align(5)))
    params = rng.uniform(0.8, 1.2, (5, 4)).astype(np.float32)
    rgb = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    ids = rng.integers(0, 5, 64)
    for fid in (3, ids):
        ref = np.asarray(JFA.apply_frame_align(jnp.asarray(params), fid,
                                               jnp.asarray(rgb)))
        got = TFA.apply_frame_align(torch.from_numpy(params),
                                    torch.as_tensor(fid), torch.from_numpy(rgb))
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-7)


def _track_setup(**cfg_updates):
    cfg = make_synthetic_config("", "/tmp/unused", H=40, W=52)
    cfg["training"]["perturb"] = 0
    for sec, kv in cfg_updates.items():
        cfg[sec].update(kv)
    jm, tm, jparams, np_params = _models(cfg)
    pose0 = make_trajectory(4)[0]
    frame = _scene(cfg, pose0)
    rays = frame[np.random.default_rng(0).choice(len(frame), 128,
                                                 replace=False)]
    init = pose0.copy()
    init[:3, 3] += np.array([0.01, -0.008, 0.012], np.float32)
    return (cfg, jm, tm, jparams,
            convert.params_from_numpy(np_params, spec=tm.grid_spec), rays,
            init)


def test_tracking_step_with_frame_align_matches_jax():
    """Three tracking iterations optimizing the pose and the frame's 4
    exposure parameters (lr 0.01, the fallback of tracking.lr_align and
    mapping.lr_align): the last loss, the pose and the exposure."""
    cfg, jm, tm, jparams, params, rays, init = _track_setup(
        training={"frame_align": True}, tracking={"iter": 3, "best": False})
    a0 = np.float32([1.05, 0.95, 1.0, 0.02])
    c2w, loss, psnr, align = j_tracking(jm, cfg)(
        jparams, jnp.asarray(init), jnp.asarray(rays), jax.random.PRNGKey(0),
        align=jnp.asarray(a0))
    out = make_tracking_step(tm, cfg)(params, torch.from_numpy(init),
                                      torch.from_numpy(rays),
                                      align=torch.from_numpy(a0))
    assert len(out) == 4
    np.testing.assert_allclose(float(out[1][-1]), float(loss), rtol=1e-4)
    np.testing.assert_allclose(float(out[2][-1]), float(psnr), rtol=1e-4)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(c2w), atol=1e-5)
    np.testing.assert_allclose(out[3].numpy(), np.asarray(align), atol=1e-5)
    assert np.abs(out[3].numpy() - a0).min() > 1e-3   # it moved


def test_ba_iteration_with_frame_align_matches_jax():
    """One BA iteration with the exposure table against the JAX step:
    the align gradient, its Adam step at mapping.lr_align 1e-3 and the
    gauge row 0 unchanged, beside the map and the poses."""
    check_ba_iteration(make_synthetic_config("", "/tmp/unused", H=24, W=32),
                       align=True)


def test_tracking_pc_step_matches_jax():
    """make_tracking_pc_step (3 iterations) on the same rays, a few with
    no depth and a few beyond the step's fixed 5 m bound: the last loss
    and the pose, with tracking.best and without."""
    for best in (False, True):
        cfg, jm, tm, jparams, params, rays, init = _track_setup(
            tracking={"iter_point": 3, "best": best})
        rays = rays.copy()
        rays[:5, 6] = 0.0
        rays[5:9, 6] = 6.0
        c2w, loss = j_pc_step(jm, cfg)(jparams, jnp.asarray(init),
                                       jnp.asarray(rays),
                                       jax.random.PRNGKey(0))
        got, got_loss = make_tracking_pc_step(tm, cfg)(
            params, torch.from_numpy(init), torch.from_numpy(rays))
        np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-4)
        np.testing.assert_allclose(got.numpy(), np.asarray(c2w), atol=1e-5)


def test_pose_array_matches_jax():
    """init_pose_array, set_pose and get_transform (one slot and a batch)
    against the JAX functions."""
    poses = make_trajectory(4, orbit_fraction=0.3)
    ja, ta = JPA.init_pose_array(4), TPA.init_pose_array(4)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    for i, p in enumerate(poses):
        ja = JPA.set_pose(ja, i, jnp.asarray(p))
        ta = TPA.set_pose(ta, i, torch.from_numpy(p))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-6)
    for fid in (2, np.array([0, 3, 1])):
        ref = np.asarray(JPA.get_transform(ja, fid))
        got = TPA.get_transform(ta, torch.as_tensor(fid))
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    np.testing.assert_allclose(TPA.get_transform(ta, 1).numpy(), poses[1],
                               atol=1e-5)


def _align_config(root):
    cfg = _scene_config(root, 12)
    cfg["training"]["frame_align"] = True
    cfg["mapping"].update(first_iters=40, iters=4)
    cfg["tracking"]["iter"] = 5
    return cfg


def test_loop_frame_align_and_checkpoint_round_trip(tmp_path):
    """The loop with frame_align: every keyframe takes the current frame's
    exposure, the gauge row stays at its initial value, BA and tracking
    move the others; the final checkpoint carries kf_aligns and
    cur_align, and a fresh CoSLAM loads them bit for bit (and one without
    frame_align ignores them)."""
    from coslam_torch.data.datasets import get_dataset

    cfg = _align_config(str(tmp_path))
    slam = CoSLAM(cfg, get_dataset(cfg), device="cpu")
    slam.run(verbose=False, eval_ate=False, mesh=False)
    init = torch.tensor([1.0, 1.0, 1.0, 0.0])
    assert slam.kf_db.count == 3
    assert torch.equal(slam.kf_aligns[0], init)
    assert (slam.kf_aligns[1:3] - init).abs().amin(-1).gt(0).all()
    assert not torch.equal(slam.cur_align, init)
    assert torch.equal(slam.kf_aligns[3:], init.expand(
        slam.kf_aligns.shape[0] - 3, 4))

    path = os.path.join(_out(cfg), "checkpoint11.npz")
    fresh = CoSLAM(cfg, get_dataset(cfg), device="cpu")
    assert fresh.load_checkpoint(path) == 12
    assert torch.equal(fresh.kf_aligns, slam.kf_aligns)
    assert torch.equal(fresh.cur_align, slam.cur_align)
    plain = copy.deepcopy(cfg)
    plain["training"]["frame_align"] = False
    other = CoSLAM(plain, get_dataset(plain), device="cpu")
    assert other.load_checkpoint(path) == 12
    assert other.kf_aligns is None and other.cur_align is None


def test_jax_checkpoint_with_aligns_loads_into_port(tmp_path):
    """A checkpoint the JAX CoSLAM writes with frame_align (its kf_aligns
    and cur_align set to known values) loads into the port: the exposure
    parameters, poses and map bit for bit."""
    from coslam_tpu.runtime.slam import CoSLAM as JCoSLAM
    from coslam_torch.data.datasets import get_dataset
    from coslam_torch.runtime import checkpoint as CK

    cfg = _align_config(str(tmp_path))
    jslam = JCoSLAM(cfg)
    rng = np.random.default_rng(3)
    kf = rng.uniform(0.9, 1.1, np.asarray(jslam.kf_aligns).shape)
    jslam.kf_aligns = jnp.asarray(kf, jnp.float32)
    jslam._cur_align = jnp.asarray([1.02, 0.97, 1.01, -0.01], jnp.float32)
    jslam.est_c2w[:3] = make_trajectory(3)
    path = str(tmp_path / "jax_checkpoint.npz")
    jslam.save_checkpoint(path, frame_cursor=3)

    slam = CoSLAM(cfg, get_dataset(cfg), device="cpu")
    assert slam.load_checkpoint(path) == 3
    np.testing.assert_array_equal(slam.kf_aligns.numpy(),
                                  np.asarray(jslam.kf_aligns))
    np.testing.assert_array_equal(slam.cur_align.numpy(),
                                  np.asarray(jslam._cur_align))
    np.testing.assert_array_equal(slam.est_c2w, jslam.est_c2w)
    for a, b in zip(jax.tree_util.tree_leaves(jslam.params),
                    CK.param_leaves(slam.params), strict=True):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())


@pytest.mark.parametrize("key,value", [("sample_info_frac", 0.5)])
def test_loop_refuses_what_is_not_ported(tmp_path, monkeypatch, key,
                                         value):
    """tracking.iter_point, frame_align, the bf16 decoder and (since the
    pipelined and active slice) tracking.sample_info_frac run, and since
    the last slice parallel.dp > 1 with them (on CPU devices, every step
    split); what the loop still refuses is more devices than are visible
    (ValueError, as the JAX package)."""
    from coslam_torch.data.datasets import get_dataset

    cfg = _align_config(str(tmp_path))
    cfg["tracking"]["iter_point"] = 2
    cfg["decoder"]["dtype"] = "bfloat16"
    cfg["tracking"][key] = value
    CoSLAM(cfg, get_dataset(cfg), device="cpu")
    cfg["parallel"] = {"dp": 2}
    slam = CoSLAM(cfg, get_dataset(cfg), device="cpu")
    assert slam.track_devices == [torch.device("cpu")] * 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="parallel.dp=2 but only 1"):
        CoSLAM(cfg, get_dataset(cfg), device="cuda")
