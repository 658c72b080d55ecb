"""The port's JointEncoding against the JAX package's, with the same
parameters (converted through coslam_torch.convert) and the same random
draws (the stratified perturbation and the smoothness lattice are drawn
by JAX and handed to the port as numpy).

Tolerances: the forward losses are reductions over rays x samples of
float32 terms computed in another order (rtol 1e-4); parameter gradients
are scatter sums into the table and small matrix products (rtol 1e-3,
atol 1e-6 of the largest gradient entry, both f32 sum-order bounds over
thousands of contributions).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coslam_tpu.data.synth import (AnalyticScene, make_synthetic_config,
                                   make_trajectory, render_frame)
from coslam_tpu.models.scene_rep import JointEncoding as JModel
from coslam_tpu.ops import losses as JL
from coslam_tpu.ops.rays import get_camera_rays
from coslam_torch import convert
from coslam_torch.models.scene_rep import JointEncoding as TModel
from coslam_torch.ops import losses as TL

torch.set_num_threads(1)


# Grid variants beside the default HashGrid (packed): (grid.enc,
# grid.grad_impl). Dense is 4 dense levels, packed or XOR; Tiled routes as
# HashGrid.
GRIDS = {"dense_packed": ("Dense", "auto"), "dense_pallas": ("Dense", "pallas"),
         "tiled": ("TiledGrid", "auto")}


def _setup(perturb=0, grid=None):
    cfg = make_synthetic_config("", "/tmp/unused", H=40, W=52)
    cfg["training"]["perturb"] = perturb
    if grid is not None:
        cfg["grid"]["enc"], cfg["grid"]["grad_impl"] = GRIDS[grid]
    bb = np.array(cfg["mapping"]["bound"], np.float32)
    jm, tm = JModel(cfg, bb), TModel(cfg, bb)
    jparams = jm.init_params(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return cfg, jm, tm, jparams, np_params


def _rays(cfg, n=96, seed=0):
    cam = cfg["cam"]
    pose = make_trajectory(4)[0]
    rgb, depth = render_frame(AnalyticScene(), pose, cam["H"], cam["W"],
                              cam["fx"], cam["fy"], cam["cx"], cam["cy"])
    dirs = get_camera_rays(cam["H"], cam["W"], cam["fx"], cam["fy"],
                           cam["cx"], cam["cy"]).reshape(-1, 3)
    idx = np.random.default_rng(seed).choice(dirs.shape[0], n, replace=False)
    d = depth.reshape(-1)[idx, None].copy()
    d[:6] = 0.0  # invalid depth: rgb_missing weighting and masks
    rays_d = (dirs[idx] @ pose[:3, :3].T).astype(np.float32)
    rays_o = np.broadcast_to(pose[:3, 3], rays_d.shape).astype(np.float32)
    return rays_o, rays_d, rgb.reshape(-1, 3)[idx], d.astype(np.float32)


def _grad_tol(ref):
    return dict(rtol=1e-3, atol=1e-6 * float(np.abs(ref).max()) + 1e-12)


@pytest.mark.parametrize("variant", ["plain", "perturbed", "huber_masked",
                                     *GRIDS])
def test_forward_losses_and_gradients_match_jax(variant):
    """Losses and gradients of one forward; the GRIDS variants (which the
    port's check_supported refused before, though its encoder built them)
    with the table converted and its shape checked against the spec."""
    cfg, jm, tm, jparams, np_params = _setup(
        perturb=1 if variant == "perturbed" else 0,
        grid=variant if variant in GRIDS else None)
    rays_o, rays_d, rgb, depth = _rays(cfg)
    n = rays_o.shape[0]
    key = jax.random.PRNGKey(3)
    t = None
    if variant == "perturbed":
        # The draw JAX's render_rays takes from its key.
        t = np.asarray(jax.random.uniform(jax.random.split(key)[0],
                                          (n, tm.n_z_samples)))
    kernel = 0.1 if variant == "huber_masked" else None
    mask = None
    if variant == "huber_masked":
        mask = (np.arange(n) % 5 != 0).astype(np.float32)
    w = cfg["training"]

    def j_loss(p):
        ret = jm.forward(p, key, *map(jnp.asarray, (rays_o, rays_d, rgb,
                                                     depth)),
                         ray_mask=None if mask is None else jnp.asarray(mask),
                         rgb_kernel=kernel)
        return JL.total_loss(ret, w), ret

    (j_total, j_ret), j_grads = jax.jit(
        jax.value_and_grad(j_loss, has_aux=True))(jparams)

    params = convert.params_from_numpy(np_params, spec=tm.grid_spec)
    leaves = [params["grid"], *params["decoder"]["sdf_net"],
              *params["decoder"]["color_net"]]
    for p in leaves:
        p.requires_grad_(True)
    ret = tm.forward(params, *map(torch.from_numpy, (rays_o, rays_d, rgb,
                                                     depth)),
                     ray_mask=None if mask is None else torch.from_numpy(mask),
                     t=None if t is None else torch.from_numpy(t),
                     rgb_kernel=kernel)
    total = TL.total_loss(ret, w)
    total.backward()

    for k in ("rgb_loss", "depth_loss", "sdf_loss", "fs_loss", "psnr"):
        np.testing.assert_allclose(float(ret[k]), float(j_ret[k]), rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(float(total), float(j_total), rtol=1e-4)
    np.testing.assert_allclose(ret["rgb"].detach().numpy(), j_ret["rgb"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ret["depth"].detach().numpy(), j_ret["depth"],
                               rtol=1e-4, atol=1e-4)
    jg = [j_grads["grid"], *j_grads["decoder"]["sdf_net"],
          *j_grads["decoder"]["color_net"]]
    for p, ref in zip(leaves, jg):
        ref = np.asarray(ref)
        np.testing.assert_allclose(p.grad.numpy(), ref, **_grad_tol(ref))


@pytest.mark.parametrize("enc", ["Dense", "HashGrid", "TiledGrid"])
def test_unknown_grad_impl_is_refused(enc):
    """Every grid name the encoder routes is built, and an unknown
    grid.grad_impl under it still raises at construction."""
    cfg = make_synthetic_config("", "/tmp/unused", H=40, W=52)
    bb = np.array(cfg["mapping"]["bound"], np.float32)
    cfg["grid"]["enc"] = enc
    assert TModel(cfg, bb).grid_spec.n_levels == (4 if enc == "Dense" else 16)
    cfg["grid"]["grad_impl"] = "segment_sum"
    with pytest.raises(NotImplementedError, match="grid.grad_impl"):
        TModel(cfg, bb)


def test_smoothness_on_jax_lattice_matches_jax():
    cfg, jm, tm, jparams, np_params = _setup()
    w = cfg["training"]
    args = (w["smooth_pts"], w["smooth_vox"], w["smooth_margin"])
    key = jax.random.PRNGKey(5)
    pts = np.asarray(jm.smoothness_points(key, *args))
    j_val, j_grad = jax.value_and_grad(
        lambda p: jm.smoothness(p, key, *args))(jparams)

    params = convert.params_from_numpy(np_params)
    params["grid"].requires_grad_(True)
    val = tm.smoothness(params, torch.from_numpy(pts), w["smooth_pts"])
    val.backward()
    np.testing.assert_allclose(float(val), float(j_val), rtol=1e-4)
    ref = np.asarray(j_grad["grid"])
    np.testing.assert_allclose(params["grid"].grad.numpy(), ref,
                               **_grad_tol(ref))

    # The port's own lattice draw: the same jittered lattice structure.
    own = tm.smoothness_points(torch.Generator().manual_seed(0), *args)
    g = w["smooth_pts"] - 1
    assert own.shape == (g ** 3, 3) and pts.shape == own.shape
    assert float(own.min()) > 0.0 and float(own.max()) < 1.0
    step = np.diff(own.numpy().reshape(g, g, g, 3)[:, 0, 0, 0])
    np.testing.assert_allclose(step, step[0], rtol=1e-4)


def test_queries_match_jax():
    cfg, jm, tm, jparams, np_params = _setup()
    params = convert.params_from_numpy(np_params)
    x = np.random.default_rng(7).uniform(0, 1, (6, 5, 3)).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(
            tm.query_sdf(params, torch.from_numpy(x)).numpy(),
            jm.query_sdf(jparams, jnp.asarray(x)), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(
            tm.query_color(params, torch.from_numpy(x)).numpy(),
            jm.query_color(jparams, jnp.asarray(x)), rtol=1e-4, atol=1e-5)
    assert tm.resolution_sdf == jm.resolution_sdf
    assert tm.grid_spec.total_entries == np_params["grid"].shape[0]
