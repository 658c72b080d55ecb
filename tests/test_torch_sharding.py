"""Ray data parallelism in the port (coslam_torch/parallel/sharding.py):
the block order of JAX's P('dp'), the device list and its refusals, the
dp = 2 tracking step and BA iteration against the JAX package's sharded
steps (make_mesh(2) on the conftest's 8 host devices), every dp step
against the port's own one-device step on the same draws, the loop and
the pipelined runtime at dp > 1 on CPU devices, a dp = 2 run resumed bit
for bit, and the CLI's --devices.

Tolerances. Against the JAX package: those of tests/test_torch_slice.py's
step tests (losses rtol 1e-4, poses atol 1e-5; BA's gradients rtol 1e-3
and its parameters atol 1e-6 off near-zero gradients). Against the port's
dp = 1 step on identical draws: the f32 sum-order bound, rtol 1e-5 on the
loss and each gradient (atol 1e-6 of its largest entry): the shards'
sums add in another order, nothing else differs; after Adam steps,
whose first step is lr * g / (|g| + eps), parameters within 2 lr where a
gradient sits at sum-order noise from zero, poses within 1e-5.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from coslam_tpu.data.synth import (AnalyticScene, make_synthetic_config,
                                   make_trajectory, write_replica_format)
from coslam_tpu.parallel.sharding import make_mesh
from coslam_torch import convert
from coslam_torch.data.datasets import get_dataset as t_get_dataset
from coslam_torch.models.scene_rep import JointEncoding as TModel
from coslam_torch.parallel import sharding as S
from coslam_torch.runtime.mapping import (BundleAdjust,
                                          make_current_frame_step,
                                          make_first_frame_step)
from coslam_torch.runtime.optim import (make_cur_map_optimizer,
                                        make_map_optimizer, map_param_list)
from coslam_torch.runtime.pipeline import PipelinedCoSLAM
from coslam_torch.runtime.slam import CoSLAM
from coslam_torch.runtime.tracking import (make_tracking_pc_step,
                                           make_tracking_step)

import test_torch_slice as slice_tests

torch.set_num_threads(1)

CPU2 = [torch.device("cpu")] * 2


def test_split_rays_gives_jax_block_order():
    """split_rays' blocks are the shards jax.device_put lays out under
    P('dp') on make_mesh(2) and make_mesh(4), in device order."""
    x = np.arange(48 * 7, dtype=np.float32).reshape(48, 7)
    for n in (2, 4):
        mesh = make_mesh(n)
        placed = jax.device_put(x, NamedSharding(mesh, PartitionSpec("dp")))
        order = {d: i for i, d in enumerate(mesh.devices.ravel())}
        shards = sorted(placed.addressable_shards,
                        key=lambda s: order[s.device])
        blocks = S.split_rays(torch.from_numpy(x), [torch.device("cpu")] * n)
        assert len(blocks) == n
        for b, s in zip(blocks, shards):
            np.testing.assert_array_equal(b.numpy(), np.asarray(s.data))
    # An uneven split (BA's exact current-frame quota): contiguous, the
    # first blocks one row longer, nothing padded.
    blocks = S.split_rays(torch.arange(85), CPU2)
    assert [len(b) for b in blocks] == [43, 42]
    assert torch.equal(torch.cat(blocks), torch.arange(85))
    assert S.split_rays(None, CPU2) == [None, None]


def test_make_devices(monkeypatch):
    assert S.make_devices(1, "cuda") == [torch.device("cuda")]
    assert S.make_devices(3, "cpu") == [torch.device("cpu")] * 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert S.make_devices(2, "cuda") == [torch.device("cuda", 0),
                                         torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="parallel.dp=3 but only 2 devices "
                                         "visible"):
        S.make_devices(3, "cuda")


# -- against the JAX package's sharded steps ----------------------------------


def test_dp2_tracking_step_matches_jax_sharded():
    slice_tests._check_tracking_step(
        make_synthetic_config("", "/tmp/unused", H=40, W=52),
        mesh=make_mesh(2), devices=CPU2)


def test_dp2_ba_iteration_matches_jax_sharded():
    slice_tests._check_ba_iteration(
        make_synthetic_config("", "/tmp/unused", H=24, W=32),
        mesh=make_mesh(2), devices=CPU2)


# -- against the port's own one-device steps ----------------------------------


def _setup(H=24, W=32):
    cfg = make_synthetic_config("", "/tmp/unused", H=H, W=W)
    bb = np.array(cfg["mapping"]["bound"], np.float32)
    model = TModel(cfg, bb)
    params = model.init_params(torch.Generator().manual_seed(0))
    frame = slice_tests._scene(cfg, make_trajectory(4)[0])
    return cfg, model, params, torch.from_numpy(frame)


def _clone_params(params):
    return convert.params_from_numpy(convert.params_to_numpy(params))


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-6 * max(np.abs(want).max(), 1e-30))


def _uneven_batch(frame, n=96):
    """n rays whose first half has no valid depth (no depth term, empty
    free-space and SDF masks) and whose second half does: per-shard means
    averaged over two shards would weigh the halves alike, the whole
    batch's means do not."""
    rng = np.random.default_rng(2)
    rays = frame[torch.from_numpy(rng.choice(len(frame), n, replace=False))]
    rays = rays.clone()
    rays[: n // 2, 6] = 0.0
    return rays


@pytest.mark.parametrize("perturb", [0, 1])
def test_dp2_forward_and_gradients_match_dp1(perturb):
    """The sharded forward's losses and the gradients of the map and of
    the pose against model.forward on the same rays and draws, the two
    shards holding very different mask counts."""
    cfg, model, params, frame = _setup()
    cfg["training"]["perturb"] = perturb
    rays = _uneven_batch(frame)
    g = torch.Generator().manual_seed(5)
    t, u = model.ray_draws(g, rays.shape[0], "cpu")
    out = []
    for devices in (None, CPU2):
        p = _clone_params(params)
        for leaf in map_param_list(p):
            leaf.requires_grad_(True)
        rot = torch.tensor([0.01, -0.02, 0.015], requires_grad=True)
        c2w = torch.linalg.matrix_exp(torch.stack([
            torch.stack([torch.zeros(()), -rot[2], rot[1]]),
            torch.stack([rot[2], torch.zeros(()), -rot[0]]),
            torch.stack([-rot[1], rot[0], torch.zeros(())])]))
        rays_d = rays[:, :3] @ c2w.T
        rays_o = torch.zeros_like(rays_d)
        ret = S.dp_forward(model, p, S.shard_devices(devices), rays_o,
                           rays_d, rays[:, 3:6], rays[:, 6:7], t=t, u=u)
        loss = sum(ret[k] for k in ("rgb_loss", "depth_loss", "sdf_loss",
                                    "fs_loss"))
        loss.backward()
        out.append((ret, loss, [q.grad for q in map_param_list(p)],
                    rot.grad))
    (r1, l1, g1, p1), (r2, l2, g2, p2) = out
    for k in ("rgb_loss", "depth_loss", "sdf_loss", "fs_loss", "psnr"):
        _close(r2[k].detach(), r1[k].detach())
    _close(r2["depth"].detach(), r1["depth"].detach())
    _close(l2.detach(), l1.detach())
    for a, b in zip(g2, g1):
        _close(a, b)
    _close(p2, p1)
    # Per-shard means averaged over the shards are another loss.
    halves = [model.forward(params, rays_o[s].detach(), rays_d[s].detach(),
                            rays[s, 3:6], rays[s, 6:7],
                            t=None if t is None else t[s],
                            u=None if u is None else u[s])
              for s in (slice(0, 48), slice(48, 96))]
    wrong = 0.5 * (halves[0]["depth_loss"] + halves[1]["depth_loss"])
    assert abs(float(wrong) - float(r1["depth_loss"])) > 0.1 * float(
        r1["depth_loss"])


def test_dp_tracking_steps_match_dp1():
    """The tracking step (perturbed: the draws are made once, for the
    whole batch) and the point-cloud tracking step at dp = 2 and 3 (an
    uneven split) against dp = 1: poses and losses within the sum-order
    bound."""
    cfg, model, params, frame = _setup()
    cfg["tracking"].update(iter=4, sample=96, iter_point=3)
    rays = _uneven_batch(frame)
    init = torch.from_numpy(make_trajectory(4)[0].copy())
    init[:3, 3] += torch.tensor([0.01, -0.008, 0.012])
    for devices in (CPU2, [torch.device("cpu")] * 3):
        got, want = (make_tracking_step(model, cfg, d)(
            params, init, rays, torch.Generator().manual_seed(3))
            for d in (devices, None))
        _close(got[0], want[0])
        _close(got[1], want[1])
        got, want = (make_tracking_pc_step(model, cfg, d)(params, init, rays)
                     for d in (devices, None))
        _close(got[0], want[0])
        _close(got[1], want[1])


def _adam_close(p_got, p_want, lr):
    """Parameters after Adam steps from the same start: within 2 lr (a
    step's bound, reached where a gradient sits at sum-order noise from
    zero), and within 1e-6 for 99% of the entries."""
    for a, b in zip(map_param_list(p_got), map_param_list(p_want)):
        d = (a.detach() - b.detach()).abs()
        assert float(d.max()) <= 2 * lr, float(d.max())
        assert float((d > 1e-6).float().mean()) <= 0.01


def test_dp_mapping_steps_match_dp1():
    """First-frame mapping, the current-frame step and BA at dp = 2
    against dp = 1 from the same parameters and generator state: the last
    losses within the sum-order bound (the iterations before it run on
    parameters that differ by Adam's noise), the parameters after the
    steps within _adam_close, BA's poses within 1e-5."""
    from coslam_torch.runtime.keyframe import KeyFrameDatabase

    cfg, model, params, frame = _setup()
    cfg["mapping"].update(sample=96, first_iters=3, cur_frame_iters=2,
                          iters=3, pose_accum_step=1, min_pixels_cur=30)
    poses = make_trajectory(4, orbit_fraction=0.05)
    frames = [torch.from_numpy(slice_tests._scene(cfg, p)) for p in poses]
    res = {}
    for name, devices in (("dp1", None), ("dp2", CPU2)):
        p = _clone_params(params)
        g = torch.Generator().manual_seed(7)
        opt = make_map_optimizer(cfg, p)
        first = make_first_frame_step(model, cfg, opt, devices)(
            p, torch.from_numpy(poses[0]), frames[0], g)[0]
        cur = make_current_frame_step(
            model, cfg, make_cur_map_optimizer(cfg, p), devices)(
            p, torch.from_numpy(poses[1]), frames[1], g)
        kf = KeyFrameDatabase(cfg, 4, 64, "cpu")
        for i in range(3):
            kf.add_keyframe(frames[i], i, g)
        kf_poses = torch.from_numpy(np.stack([*poses[:3], np.eye(4)]).astype(
            np.float32))
        ba = BundleAdjust(model, cfg, opt, 4, devices)
        kf_out, cur_out, ba_loss, _, _ = ba(
            p, kf, kf_poses, torch.from_numpy(poses[3]), frames[3], g)
        res[name] = (p, first, cur, ba_loss, kf_out, cur_out)
    (p1, f1, c1, b1, k1, o1), (p2, f2, c2, b2, k2, o2) = res["dp1"], res["dp2"]
    for a, b in ((f2, f1), (c2, c1), (b2, b1)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-4)
    _adam_close(p2, p1, cfg["mapping"]["lr_embed"])
    np.testing.assert_allclose(k2.numpy(), k1.numpy(), atol=1e-5)
    np.testing.assert_allclose(o2.numpy(), o1.numpy(), atol=1e-5)


# -- the runtimes and the CLI -------------------------------------------------


def test_divisibility_is_checked(tmp_path):
    """tracking.sample and mapping.sample must divide by parallel.dp,
    with the JAX package's message."""
    cfg = make_synthetic_config(str(tmp_path / "s"), str(tmp_path / "o"),
                                H=24, W=32, n_frames=2)
    cfg["parallel"] = {"dp": 2}
    for name in ("tracking", "mapping"):
        bad = copy.deepcopy(cfg)
        bad[name]["sample"] = 129
        with pytest.raises(ValueError,
                           match=f"{name}.sample=129 not divisible by "
                                 "parallel.dp=2"):
            CoSLAM(bad, object(), device="cpu")


def test_slam_loop_at_dp2(tmp_path):
    """CoSLAM at parallel.dp = 2 on CPU devices runs the small scene of
    test_torch_slice.py:test_slam_loop_on_small_scene to its bounds (ATE <
    5 cm, 3 keyframes, the meshes)."""
    slam = slice_tests._check_slam_loop(tmp_path, dp=2)
    assert slam.map_devices == CPU2 and slam.track_devices == CPU2


def test_dp2_resume_is_bit_for_bit(tmp_path):
    """A dp = 2 run resumed from its periodic checkpoint equals the
    straight dp = 2 run bit for bit (poses and map): the shards' sums add
    in the same order on every run."""
    from coslam_torch.runtime.checkpoint import param_leaves

    datadir = str(tmp_path / "scene")
    cfg = make_synthetic_config(datadir, str(tmp_path / "out"), H=24, W=32,
                                n_frames=8)
    cfg["mapping"].update(first_iters=30, sample=64, iters=3)
    cfg["tracking"].update(sample=64, iter=3)
    cfg["parallel"] = {"dp": 2}
    cam = cfg["cam"]
    write_replica_format(datadir, AnalyticScene(),
                         make_trajectory(8, orbit_fraction=0.02), cam["H"],
                         cam["W"], cam["fx"], cam["fy"], cam["cx"],
                         cam["cy"])
    straight = CoSLAM(cfg, t_get_dataset(cfg), device="cpu")
    straight.run(verbose=False, eval_ate=False, mesh=False, ckpt_every=5)
    cfg_b = copy.deepcopy(cfg)
    cfg_b["data"]["exp_name"] += "_resumed"
    resumed = CoSLAM(cfg_b, t_get_dataset(cfg_b), device="cpu")
    path = os.path.join(cfg["data"]["output"], cfg["data"]["exp_name"],
                        "checkpoint5.npz")
    assert resumed.load_checkpoint(path) == 5
    resumed.run(verbose=False, eval_ate=False, mesh=False, start_frame=5)
    np.testing.assert_array_equal(resumed.est_c2w, straight.est_c2w)
    for a, b in zip(param_leaves(straight.params),
                    param_leaves(resumed.params), strict=True):
        assert torch.equal(a, b)


def test_pipelined_sharded_mapper(tmp_path):
    """tests/test_pipeline_active.py:test_pipelined_sharded_mapper on CPU
    devices: at parallel.dp = 3 the tracker keeps one device and the
    mapper owns two, over which its first-frame and BA rays split; the
    run completes with the tracker at frame 11 and ATE < 8 cm."""
    datadir = str(tmp_path / "scene")
    cfg = make_synthetic_config(datadir, str(tmp_path / "out"), H=40, W=52,
                                n_frames=12)
    cfg["mapping"]["first_iters"] = 60
    cfg["mesh"]["vis"] = 0
    cam = cfg["cam"]
    write_replica_format(datadir, AnalyticScene(),
                         make_trajectory(12, orbit_fraction=0.02), cam["H"],
                         cam["W"], cam["fx"], cam["fy"], cam["cx"],
                         cam["cy"])
    cfg["parallel"] = {"dp": 3}
    slam = PipelinedCoSLAM(cfg, t_get_dataset(cfg), device="cpu")
    assert slam.track_devices == [torch.device("cpu")]
    assert slam.map_devices == CPU2 and slam._ba.devices == CPU2
    res = slam.run(verbose=False, eval_ate=True)
    ate = res["absolute_translational_error.rmse"]
    assert np.isfinite(ate) and ate < 0.08
    assert slam.tracking_idx == 11
    bad = copy.deepcopy(cfg)
    bad["mapping"]["sample"] = 2049
    with pytest.raises(ValueError, match=r"mapping.sample=2049 not "
                                         r"divisible by the mapper mesh"):
        PipelinedCoSLAM(bad, t_get_dataset(cfg), device="cpu")


def test_cli_devices_sets_dp(tmp_path, monkeypatch):
    import yaml

    from coslam_torch import cli

    cfg = make_synthetic_config(str(tmp_path / "s"), str(tmp_path / "o"),
                                H=24, W=32, n_frames=2)
    path = str(tmp_path / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    seen = []

    def fake_init(self, config, dataset=None, device="cuda"):
        seen.append((config.get("parallel"), device))

    monkeypatch.setattr(CoSLAM, "__init__", fake_init)
    monkeypatch.setattr(CoSLAM, "run", lambda self, **kw: None)
    monkeypatch.setattr("coslam_torch.data.datasets.get_dataset",
                        lambda cfg: None)
    cli.main(["--config", path, "--device", "cpu", "--devices", "2"])
    assert seen == [({"dp": 2}, "cpu")]
    assert os.path.exists(os.path.join(cfg["data"]["output"],
                                       cfg["data"]["exp_name"],
                                       "config.json"))
