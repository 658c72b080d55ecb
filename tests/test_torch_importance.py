"""The TUM reference recipe in the port against the JAX package: the
importance sampler, the fine pass (render_rays and forward with
training.n_importance > 0), one tracking step and one BA iteration at the
TUM keys, the bf16 decoder, configs/Tum/fr1_desk.yaml's model, and the
TUM settings and shapes of chip_smoke.py.

The random draws come from JAX and go to the port as numpy: the
stratified draw t and the importance draw u of a forward are
uniform(k_pert) and uniform(k_imp) of ``k_pert, k_imp = split(key)``, as
the JAX render_rays draws them.

Tolerances. sample_pdf: 1e-5 abs, plus, where a sample falls in a bin
whose CDF step is tiny, what the cumsum's f32 order can move it (JAX's
CPU cumsum adds in another order than torch's): M ulps of 1 over the
step, times the bin's width (M = 83 weights a ray); the fine pass's
samples to the same bound, and the rays whose samples agree to 1e-5
hold every rendered map to 1e-5. The fine pass's losses rtol 1e-4,
gradients as tests/test_torch_model.py (rtol
1e-3, atol 1e-6 of the largest entry): f32 sum-order bounds. The
tracking step: tests/test_torch_slice.py's (loss rtol 1e-4, pose atol
1e-5). The BA iteration: the loss rtol 1e-4, gradients as above, poses
atol 1e-5, and each parameter after the first Adam step within the
step's range over its gradient's tolerance interval (_adam_tol: at
TUM's weights many table entries have gradients within f32 noise of 0,
where the step is +-lr either way). The bf16
decoder: both sides round the same inputs and weights to bf16 and
multiply them exactly in f32, so the outputs differ only where an f32
sum in another order rounds a hidden activation to the next bf16 value;
they agree to 2 bf16 ulps (2 x 2^-8) of the output's largest magnitude.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coslam_tpu.data.synth import make_synthetic_config
from coslam_tpu.models import decoder as JD
from coslam_tpu.models.scene_rep import JointEncoding as JModel
from coslam_tpu.ops import losses as JL
from coslam_tpu.ops import render as JR
from coslam_torch import convert
from coslam_torch.data import synth
from coslam_torch.models import decoder as TD
from coslam_torch.models.scene_rep import JointEncoding as TModel
from coslam_torch.ops import losses as TL
from coslam_torch.ops import render as TR
from coslam_torch.runtime import checkpoint as CK

from test_torch_model import _grad_tol, _rays
from test_torch_slice import (_check_profile_small, _check_tracking_step,
                              _chip_smoke, _recorded_cases)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("start,stop,num", [
    (-0.25, 0.25, 21), (0.0, 5.0, 64), (-0.1, 0.1, 11), (0.0, 8.0, 32),
    (0.5 / 128, 1 - 0.5 / 128, 128), (-0.05, 0.05, 21), (2.0, 2.0, 1)])
def test_linspace_matches_jax_bits(start, stop, num):
    """render.linspace equals jnp.linspace of constants under jit bit for
    bit (the TUM samples' strata, the importance strata, room0's and the
    surface-color strata): torch.linspace does not, and TUM's sample at
    depth - trunc then falls on the other side of the SDF mask."""
    ref = np.asarray(jax.jit(lambda: jnp.linspace(start, stop, num,
                                                  dtype=jnp.float32))())
    np.testing.assert_array_equal(TR.linspace(start, stop, num).numpy(),
                                  ref)


@pytest.mark.parametrize("det", [False, True])
def test_sample_pdf_matches_jax(det):
    """CDF inversion at the fine pass's shapes (bins: the midpoints of 85
    sorted z; weights: the 83 interior weights), random u (the JAX
    function's own draw from the key) and the deterministic strata; a ray
    of all-zero weights and one whose weight sits on one bin included."""
    rng = np.random.default_rng(0)
    bs, n_imp = 64, 128
    z = np.sort(rng.uniform(0.1, 5.0, (bs, 85)), -1).astype(np.float32)
    bins = (0.5 * (z[:, 1:] + z[:, :-1])).astype(np.float32)
    weights = rng.uniform(0, 1, (bs, 83)).astype(np.float32) ** 4
    weights[0] = 0.0
    weights[1] = 0.0
    weights[1, 40] = 1.0
    key = jax.random.PRNGKey(7)
    ref = np.asarray(JR.sample_pdf(key, jnp.asarray(bins),
                                   jnp.asarray(weights), n_imp, det=det))
    u = (TR.importance_u(bs, n_imp) if det else torch.from_numpy(
        np.asarray(jax.random.uniform(key, (bs, n_imp)))))
    got = TR.sample_pdf(torch.from_numpy(bins), torch.from_numpy(weights), u)
    assert got.shape == (bs, n_imp)
    diff = np.abs(got.numpy() - ref)
    assert np.all(diff <= _pdf_tol(bins, weights, u.numpy()))
    assert np.mean(diff <= 1e-5) > 0.99


def _pdf_tol(bins, weights, u):
    """sample_pdf's tolerance per sample: 1e-5, plus, in a bin of tiny
    CDF step, what the cumsum's f32 order can move it: the two CDFs may
    differ by M ulps of 1 (M weights a ray), which moves the sample by
    (bin width) x M 2^-24 / (CDF step)."""
    w = weights.astype(np.float64) + 1e-5
    cdf = np.concatenate([np.zeros((w.shape[0], 1)),
                          np.cumsum(w / w.sum(-1, keepdims=True), -1)], -1)
    hi = np.minimum(np.stack([np.searchsorted(c, x, side="right")
                              for c, x in zip(cdf, u.astype(np.float64))]),
                    cdf.shape[1] - 1)
    lo = np.maximum(hi - 1, 0)
    step = np.maximum(np.take_along_axis(cdf, hi, -1)
                      - np.take_along_axis(cdf, lo, -1), 1e-5)
    width = (np.take_along_axis(bins, hi, -1)
             - np.take_along_axis(bins, lo, -1))
    return 1e-5 + width * weights.shape[1] * 2.0 ** -24 / step


def _fine_setup(perturb):
    cfg = make_synthetic_config("", "/tmp/unused", H=40, W=52)
    cfg["training"].update(perturb=perturb, n_importance=24)
    bb = np.array(cfg["mapping"]["bound"], np.float32)
    jm, tm = JModel(cfg, bb), TModel(cfg, bb)
    jparams = jm.init_params(jax.random.PRNGKey(0))
    return cfg, jm, tm, jparams, jax.tree_util.tree_map(np.asarray, jparams)


def _draws(key, n, tm, perturb):
    """(t, u) of JAX's render_rays for key, as tensors (None, None
    unperturbed)."""
    if not perturb:
        return None, None
    k_pert, k_imp = jax.random.split(key)
    return (torch.from_numpy(np.array(jax.random.uniform(
                k_pert, (n, tm.n_z_samples)))),
            torch.from_numpy(np.array(jax.random.uniform(
                k_imp, (n, tm.n_importance)))))


@pytest.mark.parametrize("perturb", [0, 1])
def test_render_rays_fine_pass_matches_jax(perturb):
    """render_rays with n_importance 24: the merged z and raw, the fine
    and the coarse maps and z_std."""
    cfg, jm, tm, jparams, np_params = _fine_setup(perturb)
    rays_o, rays_d, _, depth = _rays(cfg)
    key = jax.random.PRNGKey(5)
    ref = jax.jit(jm.render_rays)(jparams, key, jnp.asarray(rays_o),
                                  jnp.asarray(rays_d), jnp.asarray(depth))
    t, u = _draws(key, rays_o.shape[0], tm, perturb)
    params = convert.params_from_numpy(np_params, spec=tm.grid_spec)
    got = tm.render_rays(params, torch.from_numpy(rays_o),
                         torch.from_numpy(rays_d), torch.from_numpy(depth),
                         t=t, u=u)
    n = rays_o.shape[0]
    assert got["z_vals"].shape == (n, tm.n_z_samples + 24)
    for k in ("rgb0", "depth0"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5, err_msg=k)
    # The fine samples: per ray, sample_pdf's tolerance on the coarse
    # pass's weights (the port's, recomputed here), which bounds the
    # sorted z too; the rays whose samples agree to 1e-5 hold every
    # output to 1e-5.
    tr = cfg["training"]
    z = TR.stratified_z_vals(n, torch.from_numpy(depth), cfg["cam"]["near"],
                             cfg["cam"]["far"], tr["range_d"],
                             tr["n_range_d"], tr["n_samples_d"], t=t)
    raw = tm.run_network(params, torch.from_numpy(rays_o)[:, None]
                         + torch.from_numpy(rays_d)[:, None] * z[..., None])
    weights = TR.raw2outputs(raw, z, tr["trunc"])[3]
    bins = (0.5 * (z[:, 1:] + z[:, :-1])).numpy()
    uu = (u if u is not None else TR.importance_u(n, 24)).numpy()
    tol = _pdf_tol(bins, weights[:, 1:-1].detach().numpy(), uu).max(-1)
    dz = np.abs(got["z_vals"].numpy() - np.asarray(ref["z_vals"])).max(-1)
    assert np.all(dz <= tol)
    same = dz <= 1e-5
    assert same.mean() > 0.95
    for k in ("raw", "rgb", "depth", "z_std", "acc_map", "depth_var"):
        np.testing.assert_allclose(got[k].detach().numpy()[same],
                                   np.asarray(ref[k])[same], atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("perturb", [0, 1])
def test_forward_fine_pass_losses_and_gradients_match_jax(perturb):
    """forward with n_importance 24 (the coarse rgb and depth terms added
    to rgb_loss and depth_loss): every loss term and every parameter's
    gradient."""
    cfg, jm, tm, jparams, np_params = _fine_setup(perturb)
    rays_o, rays_d, rgb, depth = _rays(cfg)
    key = jax.random.PRNGKey(3)
    w = cfg["training"]

    def j_loss(p):
        ret = jm.forward(p, key, *map(jnp.asarray, (rays_o, rays_d, rgb,
                                                     depth)))
        return JL.total_loss(ret, w), ret

    (j_total, j_ret), j_grads = jax.jit(
        jax.value_and_grad(j_loss, has_aux=True))(jparams)

    t, u = _draws(key, rays_o.shape[0], tm, perturb)
    params = convert.params_from_numpy(np_params, spec=tm.grid_spec)
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
    for p, ref in zip(leaves, jax.tree_util.tree_leaves(j_grads),
                      strict=True):
        ref = np.asarray(ref)
        np.testing.assert_allclose(p.grad.numpy(), ref, **_grad_tol(ref))


def _tum_small():
    """tum_config's model and recipe keys on a small grid (hash_size 13,
    resolution 64) and a 15^3 TV lattice, for the CPU."""
    cfg = synth.tum_config("/tmp/unused", H=40, W=52)
    cfg["grid"].update(hash_size=13, voxel_sdf=64)
    cfg["training"]["smooth_pts"] = 16
    return cfg


def test_tracking_step_matches_jax_tum():
    """Three tracking iterations at the TUM keys (85 + 128 samples a ray,
    lr 0.01, Huber 0.1) against the JAX step."""
    _check_tracking_step(_tum_small())


def _adam_tol(g_ref, w, lr, eps, wd=0.0):
    """The first Adam step moves an entry by -lr s(g), s(g) = g / (|g| +
    eps), with g the gradient plus wd x w (coupled weight decay). s is
    monotone, so with the gradient known to d = 1e-3 |g| + 1e-6 max|g|
    (the gradients' tolerance) the step lies within lr (s(g + d) - s(g -
    d)) of the reference's, up to 2 lr where that interval crosses 0;
    1e-6 more for the f32 update itself."""
    g = np.asarray(g_ref, np.float64) + wd * np.asarray(w, np.float64)
    d = 1e-3 * np.abs(g_ref) + 1e-6 * np.abs(g_ref).max()
    s = lambda x: x / (np.abs(x) + eps)  # noqa: E731
    return lr * (s(g + d) - s(g - d)) + 1e-6


def check_ba_iteration(cfg, align: bool = False):
    """One BA iteration on the rays, pose table and smoothness sample the
    JAX step draws (its key splits replayed, as
    tests/test_torch_slice.py's BA twin does), perturb 0: the loss, the
    map's and the poses' gradients (rtol 1e-3, atol 1e-6 of the largest
    entry), the map after its Adam step (each entry within _adam_tol of
    the JAX step's), the poses to 1e-5. With ``align``
    (training.frame_align), the [max_kf + 1, 4] exposure table too: its
    gradient (0 on the gauge row 0), its Adam step at mapping.lr_align
    1e-3 (within _adam_tol), and the gauge row unchanged bit for bit."""
    from coslam_tpu.ops import pose as JP
    from coslam_tpu.runtime.mapping import make_ba_step
    from coslam_tpu.runtime.optim import make_map_optimizer as j_map_opt
    from coslam_torch.ops import pose as TP
    from coslam_torch.runtime.mapping import BundleAdjust, build_poses
    from coslam_torch.runtime.optim import (grid_leaves, make_map_optimizer,
                                            make_pose_optimizer,
                                            map_param_list)
    from test_torch_slice import _models, _scene, is_factorized
    from coslam_tpu.data.synth import make_trajectory

    cfg["training"].update(perturb=0, frame_align=align)
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
    kf_al = np.tile(np.float32([1.0, 1.0, 1.0, 0.0]), (max_kf, 1))
    kf_al[:kf_count] += rng.uniform(-0.05, 0.05, (kf_count, 4))
    cur_al = np.float32([1.03, 0.98, 1.01, -0.02])
    key = jax.random.PRNGKey(4)

    map_tx = j_map_opt(cfg)
    extra = ((jnp.asarray(kf_al), jnp.asarray(cur_al)) if align else ())
    out = make_ba_step(jm, cfg, map_tx, max_kf, R, R)(
        jparams, map_tx.init(jparams), jnp.asarray(kf_rays),
        jnp.int32(kf_count), jnp.asarray(kf_poses), jnp.asarray(cur_pose),
        jnp.asarray(cur_rays), key, *extra)
    j_after, j_kf, j_cur, j_loss = (out[0], np.asarray(out[2]),
                                    np.asarray(out[3]), float(out[4]))

    k1, k2, k3 = jax.random.split(jax.random.split(key, 1)[0], 3)
    idx = np.asarray(jax.random.randint(k1, (m["sample"],), 0, kf_count * R))
    cur_idx = np.asarray(jax.random.randint(k2, (m["sample"],), 0,
                                            cur_rays.shape[0]))
    quota = max(m["sample"] // kf_count, m["min_pixels_cur"])
    smooth_key = jax.random.split(k3)[1]
    draw = jm.smoothness_axes if is_factorized(cfg) else jm.smoothness_points
    smooth = np.asarray(draw(smooth_key, w["smooth_pts"], w["smooth_vox"],
                             w["smooth_margin"]))
    ray_data = np.concatenate([kf_rays.reshape(-1, 7)[idx],
                               cur_rays[cur_idx[:quota]]])
    ray_ids = np.concatenate([idx // R, np.full(quota, max_kf)])
    poses0 = np.concatenate([kf_poses, cur_pose[None]]).astype(np.float32)
    al0 = np.concatenate([kf_al, cur_al[None]]).astype(np.float32)
    pp = {"rot": JP.matrix_to_axis_angle(jnp.asarray(poses0[:, :3, :3])),
          "trans": jnp.asarray(poses0[:, :3, 3])}
    if align:
        pp["align"] = jnp.asarray(al0)

    def j_loss_fn(pp, mp):
        mats = JP.at_to_transform_matrix(pp["rot"], pp["trans"])
        mats = mats.at[0].set(jnp.asarray(kf_poses[0]))
        rows = mats[jnp.asarray(ray_ids)]
        rd = jnp.einsum("nij,nj->ni", rows[:, :3, :3],
                        jnp.asarray(ray_data[:, :3]))
        al = (pp["align"].at[0].set(jnp.asarray(kf_al[0]))[
            jnp.asarray(ray_ids)] if align else None)
        ret = jm.forward(mp, k3, rows[:, :3, 3], rd,
                         jnp.asarray(ray_data[:, 3:6]),
                         jnp.asarray(ray_data[:, 6:7]), align=al)
        sm = jm.smoothness(mp, smooth_key, w["smooth_pts"], w["smooth_vox"],
                           w["smooth_margin"])
        return JL.total_loss(ret, w, smooth_loss=sm,
                             smooth_weight=w["smooth_weight"])

    j_val, (j_gpose, j_gmap) = jax.jit(jax.value_and_grad(j_loss_fn, (0, 1)))(
        pp, jparams)
    np.testing.assert_allclose(float(j_val), j_loss, rtol=1e-5)

    params = convert.params_from_numpy(np_params, spec=tm.grid_spec)
    map_opt = make_map_optimizer(cfg, params)
    ba = BundleAdjust(tm, cfg, map_opt, max_kf)
    p0 = torch.from_numpy(poses0)
    rot = TP.matrix_to_axis_angle(p0[:, :3, :3]).requires_grad_(True)
    trans = p0[:, :3, 3].clone().requires_grad_(True)
    a0 = torch.from_numpy(al0)
    al = a0.clone().requires_grad_(True)
    gauge = torch.arange(max_kf + 1)[:, None] == 0
    loss = ba.loss(params, build_poses(rot, trans, p0, ba.frozen_mask("cpu"),
                                       TP.at_to_transform_matrix),
                   torch.from_numpy(ray_data), torch.from_numpy(ray_ids),
                   torch.from_numpy(smooth), None, None,
                   torch.where(gauge, a0, al) if align else None)
    loss.backward()
    np.testing.assert_allclose(float(loss), j_loss, rtol=1e-4)
    names = [("rot", rot), ("trans", trans)] + ([("align", al)] if align
                                                else [])
    for name, v in names:
        ref = np.asarray(j_gpose[name])
        np.testing.assert_allclose(v.grad.numpy(), ref, **_grad_tol(ref),
                                   err_msg=name)
    leaves = map_param_list(params)
    n_grid = len(grid_leaves(params["grid"]))
    jg = [*jax.tree_util.tree_leaves(j_gmap["grid"]),
          *j_gmap["decoder"]["sdf_net"], *j_gmap["decoder"]["color_net"]]
    w0 = [p.detach().numpy().copy() for p in leaves]
    for p, ref in zip(leaves, jg, strict=True):
        ref = np.asarray(ref)
        np.testing.assert_allclose(p.grad.numpy(), ref, **_grad_tol(ref))

    map_opt.step()
    pose_opt = make_pose_optimizer(rot, trans, m["lr_rot"], m["lr_trans"],
                                   al if align else None, 1e-3)
    pose_opt.step()
    ja = [*jax.tree_util.tree_leaves(j_after["grid"]),
          *j_after["decoder"]["sdf_net"], *j_after["decoder"]["color_net"]]
    for i, (p, ref, g) in enumerate(zip(leaves, ja, jg)):
        grid = i < n_grid
        tol = _adam_tol(g, w0[i], m["lr_embed" if grid else "lr_decoder"],
                        1e-15 if grid else 1e-8, 0.0 if grid else 1e-6)
        assert np.all(np.abs(p.detach().numpy() - np.asarray(ref)) <= tol), i
    with torch.no_grad():
        final = build_poses(rot, trans, p0, ba.frozen_mask("cpu"),
                            TP.at_to_transform_matrix)
    np.testing.assert_allclose(final[:max_kf].numpy(), j_kf, atol=1e-5)
    np.testing.assert_allclose(final[max_kf].numpy(), j_cur, atol=1e-5)
    np.testing.assert_array_equal(final[0].numpy(), kf_poses[0])
    if align:
        j_al = np.concatenate([np.asarray(out[5]), np.asarray(out[6])[None]])
        got = torch.where(gauge, a0, al).detach().numpy()
        tol = _adam_tol(j_gpose["align"], al0, 1e-3, 1e-8)
        assert np.all(np.abs(got - j_al) <= tol)
        np.testing.assert_array_equal(got[0], kf_al[0])
        np.testing.assert_array_equal(j_al[0], kf_al[0])
        assert np.abs(got[1:kf_count] - al0[1:kf_count]).min() > 5e-4


def test_ba_iteration_matches_jax_tum():
    """One BA iteration at the TUM keys: loss, map and pose gradients,
    the map and the poses after the Adam steps."""
    check_ba_iteration(_tum_small())


def _decoder_inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    bb = np.array(cfg["mapping"]["bound"], np.float32)
    jm = JModel(cfg, bb)
    dec = jm.decoder
    jp = dec.init(jax.random.PRNGKey(seed))
    n = 4096
    embed = rng.standard_normal((n, jm.input_ch)).astype(np.float32) * 0.1
    pos = rng.uniform(0, 1, (n, jm.input_ch_pos)).astype(np.float32)
    return jm, jp, embed, pos


def test_bf16_decoder_matches_jax():
    """decoder.dtype bfloat16: the port's decoder (sdf and rgb logits) on
    the JAX decoder's parameters against the JAX decoder, within 2 bf16
    ulps of the output's scale; the parameters stay f32 and the output is
    f32; and the f32 decoder differs from it by more than that bound."""
    cfg = make_synthetic_config("", "/tmp/unused", H=40, W=52)
    cfg["decoder"]["dtype"] = "bfloat16"
    jm, jp, embed, pos = _decoder_inputs(cfg)
    ref = np.asarray(jm.decoder(jp, jnp.asarray(embed), jnp.asarray(pos)))
    tm = TModel(cfg, np.array(cfg["mapping"]["bound"], np.float32))
    assert tm.decoder.bf16
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    got = tm.decoder(tp, torch.from_numpy(embed), torch.from_numpy(pos))
    assert got.dtype == torch.float32
    assert all(w.dtype == torch.float32 for w in tp["sdf_net"])
    tol = 2 * 2.0 ** -8 * np.abs(ref).max(0)
    assert np.all(np.abs(got.numpy() - ref) <= tol)
    f32 = TD.ColorSDFDecoder({**cfg, "decoder": {**cfg["decoder"],
                                                  "dtype": "float32"}},
                             tm.input_ch, tm.input_ch_pos)
    plain = f32(tp, torch.from_numpy(embed), torch.from_numpy(pos)).numpy()
    assert np.abs(plain - ref).max() > np.abs(got.numpy() - ref).max()


def test_bf16_decoder_mlp_matches_jax_mlp():
    """mlp_apply with bf16 against the JAX mlp_apply at bfloat16, its
    gradients to the weights included (both round the cotangent to bf16
    at the same points); the tolerance as above, for the gradients of
    their own scale."""
    rng = np.random.default_rng(1)
    dims = [31, 32, 16]
    ws = JD.init_mlp(jax.random.PRNGKey(2), dims)
    x = rng.standard_normal((2048, dims[0])).astype(np.float32)
    g = rng.standard_normal((2048, dims[-1])).astype(np.float32)

    def j_fn(ws):
        out = JD.mlp_apply(ws, jnp.asarray(x), jnp.bfloat16)
        return jnp.sum(out * g), out

    (_, j_out), j_grads = jax.value_and_grad(j_fn, has_aux=True)(ws)
    tws = [torch.from_numpy(np.array(w)).requires_grad_(True) for w in ws]
    out = TD.mlp_apply(tws, torch.from_numpy(x), bf16=True)
    (out * torch.from_numpy(g)).sum().backward()
    j_out = np.asarray(j_out)
    assert np.all(np.abs(out.detach().numpy() - j_out)
                  <= 2 * 2.0 ** -8 * np.abs(j_out).max())
    for w, ref in zip(tws, j_grads, strict=True):
        ref = np.asarray(ref)
        assert np.all(np.abs(w.grad.numpy() - ref)
                      <= 2 * 2.0 ** -8 * np.abs(ref).max())


def test_fr1_desk_yaml_builds_the_port_model():
    """configs/Tum/fr1_desk.yaml (n_importance 128) builds the port's model
    with no NotImplementedError: the hash grid at resolution 325, 822,884
    rows, 85 + 128 samples per ray; its batch sizes split over two devices
    (parallel.dp 2, which the loop runs since the last slice), where an
    odd tracking.sample would raise the JAX package's ValueError."""
    from coslam_torch.config import load_config
    from coslam_torch.parallel.sharding import check_divisible

    cfg = load_config(os.path.join(REPO, "configs/Tum/fr1_desk.yaml"))
    m = TModel(cfg, np.array(cfg["mapping"]["bound"], np.float32))
    assert m.resolution_sdf == 325 and m.grid_spec.total_entries == 822_884
    assert (m.n_z_samples, m.n_importance) == (85, 128)
    assert m.init_params(torch.Generator().manual_seed(0))["grid"].shape == (
        822_884, 2)
    check_divisible(cfg, 2)
    with pytest.raises(ValueError, match="tracking.sample=1023 not "
                                         "divisible by parallel.dp=2"):
        check_divisible({**cfg, "tracking": {**cfg["tracking"],
                                             "sample": 1023}}, 2)


# tum.yaml's keys that the smoke's TUM slice keeps, beside the grid's.
_TUM_KEYS = {
    "pos": ["enc", "n_bins"],
    "decoder": ["geo_feat_dim", "hidden_dim", "num_layers",
                "num_layers_color", "hidden_dim_color"],
    "training": ["n_samples_d", "n_range_d", "range_d", "n_importance",
                 "perturb", "trunc", "rgb_weight", "depth_weight",
                 "sdf_weight", "fs_weight", "smooth_weight", "smooth_pts",
                 "smooth_vox", "smooth_margin", "rot_rep", "rgb_missing"],
    "tracking": ["iter", "sample", "pc_samples", "lr_rot", "lr_trans",
                 "ignore_edge_W", "ignore_edge_H", "iter_point", "best",
                 "robust_delta", "const_speed", "wait_iters"],
    "mapping": ["sample", "iters", "first_iters", "first_mesh",
                "min_pixels_cur", "keyframe_every", "map_every", "n_pixels",
                "optim_cur", "pose_accum_step", "map_accum_step",
                "map_wait_step", "lr_embed", "lr_decoder", "lr_rot",
                "lr_trans", "filter_depth", "cur_frame_iters"],
    "mesh": ["voxel_eval", "voxel_final", "render_color"],
    "data": ["num_workers"],
    "grid": ["enc", "hash_size", "oneGrid"],
}


def test_chip_smoke_uses_tum_settings():
    """The TUM slice's config (synth.tum_config) carries
    configs/Tum/fr1_desk.yaml's model and tum.yaml's recipe at every key of
    the slice, with one depth cut (mesh.vis 5, from 50); both resolve to
    the same grid spec (resolution 325, 822,884 rows); it reads TUM-layout
    files."""
    from coslam_torch.config import load_config

    assert _chip_smoke().tum_config is synth.tum_config
    smoke = synth.tum_config("/tmp/unused")
    ref = load_config(os.path.join(REPO, "configs/Tum/fr1_desk.yaml"))
    for section, names in _TUM_KEYS.items():
        for k in names:
            assert smoke[section][k] == ref[section][k], (section, k)
    assert (smoke["mesh"]["vis"], ref["mesh"]["vis"]) == (5, 50)
    assert smoke["dataset"] == "tum"
    bound = lambda c: np.array(c["mapping"]["bound"], np.float32)  # noqa
    spec = TModel(smoke, bound(smoke)).grid_spec
    assert spec == TModel(ref, bound(ref)).grid_spec
    assert spec.total_entries == 822_884


def test_chip_smoke_checks_the_shapes_of_the_tum_slice(tmp_path,
                                                       monkeypatch):
    """chip_smoke.main_path_cases at the TUM recipe lists every encode
    call CoSLAM.run makes: each step's coarse case (85 samples a ray) and
    its fine pass's (128 new points a ray), the lattice and the mesh
    chunk; recorded on a run with 256 BA and 128 tracking rays and a 15^3
    lattice (CPU time), then the cases at the slice's own sizes."""
    from coslam_torch.ops import hash_packed as HP

    def make_cfg(output, H, W, n_frames):
        cfg = synth.tum_config(output, H, W, n_frames)
        cfg["mapping"].update(first_mesh=False, sample=256)
        cfg["tracking"]["sample"] = 128
        cfg["training"]["smooth_pts"] = 16
        cfg["mesh"]["vis"] = 0
        return cfg

    cases, fwd, bwd = _recorded_cases(
        tmp_path, monkeypatch, make_cfg, HP,
        ("grid_encode_fwd_ref", "grid_encode_bwd_ref"), n_tables=1)
    assert bwd == {(n, dt, dx) for _, n, dt, dx in cases if dt or dx}
    assert {n for _, n, _, _ in cases} <= set(fwd)
    labels = ["first frame", "first frame fine", "tracking", "tracking fine",
              "BA 1 kf", "BA 1 kf fine", "BA 2 kf", "BA 2 kf fine",
              "lattice", "mesh chunk"]
    assert [c[0] for c in cases] == labels
    assert [c[1] for c in cases] == [
        256 * 85, 256 * 128, 128 * 85, 128 * 128, 512 * 85, 512 * 128,
        384 * 85, 384 * 128, 15 ** 3, 65536]
    full = _chip_smoke().main_path_cases(synth.tum_config("/tmp/unused"), 15)
    assert [c[0] for c in full] == labels
    assert [c[1] for c in full] == [
        2048 * 85, 2048 * 128, 1024 * 85, 1024 * 128, 4096 * 85, 4096 * 128,
        3072 * 85, 3072 * 128, 63 ** 3, 65536]


def test_profile_slice_small_tum_on_cpu(tmp_path):
    """coslam_torch.tools.profile_slice --tum at its --small size on the
    CPU: the TUM recipe's phases report finite walls, and the CPU path
    launches no kernel."""
    res = _check_profile_small(tmp_path, "--tum")
    assert res["encode_launches"] == {"grid_encode_fwd": 0,
                                      "grid_encode_bwd": 0,
                                      "grid_encode_bwd_serial": 0}
