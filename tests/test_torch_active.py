"""ActiveCoSLAM in the port (coslam_torch/active/) against the JAX
package (coslam_tpu/active/): the beta-head decoder ColorSDFNetV3, the
model's render and losses (ActiveJointEncoding) in both detach_nll forms
with the importance fine pass, the gradient isolation of detach_nll, the
holdout information gain and the info-gain ranking, the parameters'
conversion and checkpoint order, ActiveCoSLAM on the CPU on the 12-frame
40x52 scene of tests/test_pipeline_active.py, quality_bench --active's
configuration, and the settings of chip_smoke.py's new phases.

The random draws come from JAX and go to the port as numpy, as in
tests/test_torch_importance.py (t and u of ``k_pert, k_imp =
split(key)``).

Tolerances. The decoder's outputs 1e-5 abs (f32 products of two-layer
MLPs summed in another order). Losses rtol 1e-4 and gradients as
tests/test_torch_model.py (rtol 1e-3, atol 1e-6 of the largest entry):
f32 sum-order bounds, as tests/test_torch_importance.py holds the fine
pass. The information gain (pre, post) at perturb 0: rtol 1e-5 (sums of
a few thousand f32 values in another order). The converted parameters
and the checkpoint's leaves: exact. The run: the JAX tests' assertions.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coslam_tpu.active.scene_rep import ActiveJointEncoding as JModel
from coslam_tpu.active.slam import ActiveCoSLAM as JActive
from coslam_tpu.data.datasets import get_dataset as j_get_dataset
from coslam_tpu.data.synth import make_trajectory
from coslam_tpu.ops import losses as JL
from coslam_torch import convert
from coslam_torch.active.scene_rep import ActiveJointEncoding as TModel
from coslam_torch.active.slam import ActiveCoSLAM, info_gain
from coslam_torch.data import synth as TS
from coslam_torch.data.datasets import get_dataset as t_get_dataset
from coslam_torch.ops import losses as TL
from coslam_torch.runtime import checkpoint as CK
from coslam_torch.runtime.optim import decoder_leaves

from test_torch_importance import _draws
from test_torch_model import _grad_tol, _rays
from test_torch_slice import _chip_smoke

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACTIVE = {"isActive": True, "check_info_gain_every": 5, "init_image": 5,
          "choose_k": 1, "w": 0.01, "downsample_rate": 4, "beta_min": 0.01}


def _setup(detach=True, n_importance=24, perturb=1):
    cfg = TS.make_synthetic_config("", "/tmp/unused", H=40, W=52)
    cfg["training"].update(perturb=perturb, n_importance=n_importance)
    cfg["active"] = dict(ACTIVE, detach_nll=detach)
    bb = np.array(cfg["mapping"]["bound"], np.float32)
    jm, tm = JModel(cfg, bb), TModel(cfg, bb)
    jparams = jm.init_params(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return cfg, jm, tm, jparams, convert.params_from_numpy(
        np_params, spec=tm.grid_spec)


@pytest.mark.parametrize("detach", [True, False])
def test_decoder_matches_jax(detach):
    """ColorSDFNetV3 on random features: [rgb, sdf, beta] and the
    gradients of a weighted sum of them to every decoder tensor."""
    cfg, jm, tm, jparams, params = _setup(detach)
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((64, tm.input_ch)).astype(np.float32)
    pos = rng.uniform(0, 1, (64, tm.input_ch_pos)).astype(np.float32)
    w = rng.standard_normal((64, 5)).astype(np.float32)

    def j_fn(p):
        out = jm.decoder(p, jnp.asarray(emb), jnp.asarray(pos))
        return jnp.sum(out * w), out

    (_, j_out), j_grads = jax.value_and_grad(j_fn, has_aux=True)(
        jparams["decoder"])
    dec = params["decoder"]
    leaves = decoder_leaves(dec)
    for p in leaves:
        p.requires_grad_(True)
    out = tm.decoder(dec, torch.from_numpy(emb), torch.from_numpy(pos))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               rtol=0, atol=1e-5)
    assert (out[:, 4] >= 0.01).all()
    for p, ref in zip(leaves, jax.tree_util.tree_leaves(j_grads),
                      strict=True):
        ref = np.asarray(ref)
        np.testing.assert_allclose(p.grad.numpy(), ref, **_grad_tol(ref))


@pytest.mark.parametrize("detach", [True, False])
def test_forward_losses_and_gradients_match_jax(detach):
    """ActiveJointEncoding.forward with the fine pass (n_importance 24)
    and injected draws: every loss term, uncert_map, and every
    parameter's gradient of the total loss."""
    cfg, jm, tm, jparams, params = _setup(detach)
    rays_o, rays_d, rgb, depth = _rays(cfg)
    key = jax.random.PRNGKey(3)
    w = cfg["training"]

    def j_loss(p):
        ret = jm.forward(p, key, *map(jnp.asarray, (rays_o, rays_d, rgb,
                                                     depth)))
        return JL.total_loss(ret, w), ret

    (j_total, j_ret), j_grads = jax.jit(
        jax.value_and_grad(j_loss, has_aux=True))(jparams)
    t, u = _draws(key, rays_o.shape[0], tm, 1)
    leaves = CK.param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    ret = tm.forward(params, *map(torch.from_numpy, (rays_o, rays_d, rgb,
                                                     depth)), t=t, u=u)
    total = TL.total_loss(ret, w)
    total.backward()
    for k in ("rgb_loss", "depth_loss", "sdf_loss", "fs_loss", "psnr"):
        np.testing.assert_allclose(float(ret[k]), float(j_ret[k]), rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(float(total), float(j_total), rtol=1e-4)
    np.testing.assert_allclose(ret["uncert_map"].detach().numpy(),
                               np.asarray(j_ret["uncert_map"]), rtol=1e-4,
                               atol=1e-6)
    for p, ref in zip(leaves, jax.tree_util.tree_leaves(j_grads),
                      strict=True):
        ref = np.asarray(ref)
        np.testing.assert_allclose(p.grad.numpy(), ref, **_grad_tol(ref))


def test_detach_nll_gradient_isolation():
    """tests/test_pipeline_active.py:172 on the port: with detach_nll the
    beta head still gets a gradient of rgb_loss, the grid's gradient
    differs from the reference NLL's and is parallel (cos > 0.99) to that
    of the plain MSE of the rendered rgb."""
    cfg, _, tm_d, _, params = _setup(True, n_importance=0, perturb=0)
    cfg_r = copy.deepcopy(cfg)
    cfg_r["active"]["detach_nll"] = False
    tm_r = TModel(cfg_r, np.array(cfg["mapping"]["bound"], np.float32))
    g = torch.Generator().manual_seed(1)
    n = 64
    rays_d = torch.randn((n, 3), generator=g)
    rays_d = rays_d / rays_d.norm(dim=-1, keepdim=True)
    rays_o = torch.zeros((n, 3))
    rgb = torch.rand((n, 3), generator=g)
    td = 0.5 + torch.rand((n, 1), generator=g)

    def grads(model, loss_of):
        leaves = CK.param_leaves(params)
        for p in leaves:
            p.grad = None
            p.requires_grad_(True)
        loss_of(model.forward(params, rays_o, rays_d, rgb, td)).backward()
        return {"grid": params["grid"].grad.clone(),
                "beta": [p.grad.clone() for p in params["decoder"][
                    "uncertainty_linear"].values()]}

    g_detach = grads(tm_d, lambda r: r["rgb_loss"])
    g_ref = grads(tm_r, lambda r: r["rgb_loss"])
    g_mse = grads(tm_d, lambda r: ((r["rgb"] - rgb) ** 2).mean())
    assert any(float(x.abs().max()) > 0 for x in g_detach["beta"])
    assert float((g_detach["grid"] - g_ref["grid"]).abs().sum()) > 0
    va, vb = g_detach["grid"].ravel(), g_mse["grid"].ravel()
    assert float(va @ vb / (va.norm() * vb.norm() + 1e-12)) > 0.99


def _holdout_rays(cfg, n=600, seed=0):
    cam = cfg["cam"]
    pose = make_trajectory(4)[2]
    args = (cam["H"], cam["W"], cam["fx"], cam["fy"], cam["cx"], cam["cy"])
    rgb, depth = TS.render_frame(TS.AnalyticScene(), pose, *args)
    from coslam_torch.ops.rays import get_camera_rays

    flat = np.concatenate([get_camera_rays(*args).reshape(-1, 3),
                           rgb.reshape(-1, 3), depth.reshape(-1, 1)], 1)
    idx = np.random.default_rng(seed).choice(flat.shape[0], n, replace=False)
    return flat[idx].astype(np.float32), pose.astype(np.float32)


class _JFake:
    """Just enough of the JAX ActiveCoSLAM for _build_info_gain."""

    def __init__(self, model, cfg):
        self.model, self.config = model, cfg
        self.dataset = type("D", (), {"H": cfg["cam"]["H"],
                                      "W": cfg["cam"]["W"]})


@pytest.mark.parametrize("n_importance", [0, 24])
def test_info_gain_matches_jax(n_importance):
    """The holdout information gain (pre, post) of one frame at perturb
    0 against the JAX package's jitted info_gain."""
    cfg, jm, tm, jparams, params = _setup(True, n_importance, perturb=0)
    rays, pose = _holdout_rays(cfg)
    j_gain, _ = JActive._build_info_gain(_JFake(jm, cfg))
    want = np.array([float(v) for v in j_gain(
        jparams, jax.random.PRNGKey(0), jnp.asarray(rays),
        jnp.asarray(pose))])
    got = np.array([float(v) for v in info_gain(
        tm, params, torch.from_numpy(rays), torch.from_numpy(pose))])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert want[0] > want[1] > 0


@pytest.fixture(scope="module")
def small_seq(tmp_path_factory):
    """tests/test_pipeline_active.py's scene (the port's Replica writer)."""
    d = tmp_path_factory.mktemp("torch_active")
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


def test_select_info_gain_indices_matches_jax(small_seq):
    """The ranking of a 5-frame holdout window (choose_k 2, perturb 0, the
    JAX run's parameters converted) with the JAX draw of the holdout
    pixels injected: the same view-local indices as the JAX
    ActiveCoSLAM's select_info_gain_indices."""
    cfg = copy.deepcopy(small_seq)
    cfg["training"]["perturb"] = 0
    cfg["active"] = dict(ACTIVE, choose_k=2)
    jslam = JActive(copy.deepcopy(cfg), j_get_dataset(cfg))
    jslam._rng = np.random.default_rng(11)
    window_j = jslam.dataset.slice(range(4, 9))
    want = jslam.select_info_gain_indices(window_j)
    n = (cfg["cam"]["H"] // 4) * (cfg["cam"]["W"] // 4)
    idx = np.random.default_rng(11).choice(cfg["cam"]["H"] * cfg["cam"]["W"],
                                           size=n, replace=False)
    slam = ActiveCoSLAM(copy.deepcopy(cfg), t_get_dataset(cfg), device="cpu")
    with torch.no_grad():
        for p, a in zip(CK.param_leaves(slam.params),
                        jax.tree_util.tree_leaves(jslam.params),
                        strict=True):
            p.copy_(torch.from_numpy(np.asarray(a)))
    got = slam.select_info_gain_indices(slam.dataset.slice(range(4, 9)),
                                        idx=idx)
    assert got == want and len(got) == 2
    # The port's own draw: keyed by (seed, the window's first frame, 2).
    np.testing.assert_array_equal(
        slam.holdout_pixels(4), np.random.default_rng((0, 4, 2)).choice(
            cfg["cam"]["H"] * cfg["cam"]["W"], size=n, replace=False))


def test_params_convert_and_checkpoint_order_match_jax(tmp_path):
    """The JAX active parameter tree crosses to the port and back
    exactly; the port's checkpoint leaves (param_leaves, the optimizer
    labels' order) are JAX's tree leaves, the heads' b before w; a saved
    checkpoint loads back."""
    cfg, jm, tm, jparams, params = _setup()
    j_leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(jparams)]
    t_leaves = CK.param_leaves(params)
    assert len(t_leaves) == len(j_leaves)
    for a, b in zip(t_leaves, j_leaves):
        np.testing.assert_array_equal(a.numpy(), b)
    back = convert.params_to_numpy(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), j_leaves, strict=True):
        np.testing.assert_array_equal(a, b)
    assert set(back["decoder"]) == set(jparams["decoder"])
    path = str(tmp_path / "ckpt.npz")
    CK.save_ckpt(path, params, np.zeros((2, 4, 4), np.float32), {})
    loaded, *_ = CK.load_ckpt(path, params)
    for a, b in zip(CK.param_leaves(loaded), j_leaves, strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def active_run(small_seq):
    """tests/test_pipeline_active.py's kf-overflow run: init_image 3,
    choose_k 2 (the train set grows past the keyframe buffer's cadence)."""
    cfg = copy.deepcopy(small_seq)
    cfg["data"]["exp_name"] = "torch_active"
    cfg["active"] = dict(ACTIVE, init_image=3, choose_k=2)
    slam = ActiveCoSLAM(cfg, t_get_dataset(cfg), device="cpu")
    return cfg, slam, slam.run(verbose=False, eval_ate=True)


def test_active_coslam(active_run):
    """tests/test_pipeline_active.py's test_active_coslam and
    test_active_train_set_growth_and_kf_overflow on one run: a finite ATE
    below 0.08 m over the processed frames, at least 3 keyframes, the
    final mesh under the sequence's last frame, test() with beta > 0 and
    a finite rgb_loss; the train set grown past init_image, the keyframe
    buffer capped with valid unique ids and frame 0 in slot 0."""
    cfg, slam, res = active_run
    ate = res["absolute_translational_error.rmse"]
    assert np.isfinite(ate) and ate < 0.08
    assert slam.kf_db.count >= 3
    out = os.path.join(cfg["data"]["output"], cfg["data"]["exp_name"])
    assert os.path.exists(os.path.join(out, "mesh_track11.ply"))
    # test() predicts from the two frames before (the JAX test's frame 5
    # at init_image 5): here the last frame with both tracked.
    f = max(f for f in range(2, 12)
            if np.any(slam.est_c2w[f - 1]) and np.any(slam.est_c2w[f - 2]))
    ret = slam.test(slam.dataset[f], f)
    assert (ret["uncert_map"] > 0).all()
    assert np.isfinite(ret["rgb_loss"])
    assert slam.train_set_size > 3
    assert slam.kf_db.count <= slam.kf_db.num_kf
    ids = slam.kf_db.frame_ids[:slam.kf_db.count]
    assert all(0 <= f < len(slam.dataset) for f in ids)
    assert len(set(ids)) == len(ids)
    assert slam.kf_db.frame_ids[0] == 0
    processed = [f for f in range(12) if np.any(slam.est_c2w[f])]
    assert res["compared_pose_pairs"] == len(processed) < 12


def test_quality_bench_active_reaches_active_coslam(monkeypatch, tmp_path):
    """quality_bench --active: the JAX harness's active block in the
    config and ActiveCoSLAM built from it (run_benchmark replaced here by
    a recorder that builds the class and runs nothing); --pipelined with
    --active is refused."""
    from coslam_torch.eval import benchmark
    from coslam_torch.tools import quality_bench

    seen = {}

    def recorder(cfg, dataset=None, device="cuda", slam_cls=None, **kw):
        seen["slam"] = slam_cls(cfg, dataset, device=device)
        return {}

    monkeypatch.setattr(benchmark, "run_benchmark", recorder)
    argv = ["--frames_in", "memory", "--frames", "4", "--hw", "24x32",
            "--device", "cpu", "--workdir", str(tmp_path), "--active"]
    res = quality_bench.main(argv)
    slam = seen["slam"]
    assert isinstance(slam, ActiveCoSLAM)
    assert slam.config["active"] == {
        "isActive": True, "check_info_gain_every": 5, "init_image": 10,
        "choose_k": 2, "w": 0.01, "downsample_rate": 2, "beta_min": 0.01,
        "detach_nll": True}
    assert res["active"] is True and res["pipelined"] is False
    with pytest.raises(SystemExit):
        quality_bench.main(argv + ["--pipelined"])


def test_chip_smoke_uses_active_and_pipelined_settings():
    """The smoke's pipelined phase runs room0_config as the room0 slice
    does; its active phase tum_config (the TUM slice's model and recipe)
    with configs/Active/active_tum.yaml's active section at every key but
    the four cut to 15 frames (init_image and check_info_gain_every 10 ->
    5, choose_k 10 -> 2, downsample_rate 2 -> 4)."""
    from coslam_torch.config import load_config

    smoke = _chip_smoke()
    pipe = smoke.pipelined_config("/tmp/unused")
    ref = TS.room0_config("/tmp/unused", smoke.H, smoke.W, smoke.N_FRAMES)
    assert pipe["data"].pop("exp_name") != ref["data"].pop("exp_name")
    assert pipe == ref
    act = smoke.active_config("/tmp/unused")
    ref = TS.tum_config("/tmp/unused", smoke.H, smoke.W, smoke.N_FRAMES)
    got_active = act.pop("active")
    for c in (act, ref):
        c["data"].pop("exp_name")
        c["data"].pop("datadir")
    assert act == ref
    yaml_active = load_config(os.path.join(
        REPO, "configs/Active/active_tum.yaml"))["active"]
    cuts = {"init_image": (5, 10), "check_info_gain_every": (5, 10),
            "choose_k": (2, 10), "downsample_rate": (4, 2)}
    assert set(got_active) == set(yaml_active)
    for k, v in got_active.items():
        if k in cuts:
            assert (v, yaml_active[k]) == cuts[k], k
        else:
            assert v == yaml_active[k], k
