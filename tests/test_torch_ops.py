"""The port's pure tensor ops against the JAX package: pose maps, the
volume-rendering primitives, the losses, OneBlob and the decoder with
converted weights. Inputs come from numpy seeds and go to both sides.

Tolerances: float32 throughout; elementwise maps agree to rtol 1e-5 (one
or two roundings apart), reductions over a few hundred elements to
rtol 1e-5 / atol 1e-6; pose gradients as stated in their test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coslam_tpu.data.synth import make_synthetic_config
from coslam_tpu.models import decoder as JD
from coslam_tpu.ops import encodings as JE
from coslam_tpu.ops import losses as JL
from coslam_tpu.ops import pose as JP
from coslam_tpu.ops import render as JR
from coslam_torch import convert
from coslam_torch.models import decoder as TD
from coslam_torch.ops import encodings as TE
from coslam_torch.ops import losses as TL
from coslam_torch.ops import pose as TP
from coslam_torch.ops import render as TR

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(port, ref, **tol):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    np.testing.assert_allclose(port, np.asarray(ref), **(tol or TOL))


# -- pose ---------------------------------------------------------------------

def _rotvecs():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(16, 3))
    w *= rng.uniform(0, 3, (16, 1)) / np.linalg.norm(w, axis=1, keepdims=True)
    w[:4] *= 1e-7          # inside the small-angle branch
    w[4] = 0.0
    return w.astype(np.float32)


def test_axis_angle_maps_match_jax():
    w = _rotvecs()
    R = TP.axis_angle_to_matrix(_t(w))
    _close(R, JP.axis_angle_to_matrix(jnp.asarray(w)))
    _close(TP.matrix_to_axis_angle(R),
           JP.matrix_to_axis_angle(jnp.asarray(R.numpy())), atol=1e-5)
    # Round trip (angles below pi).
    _close(TP.matrix_to_axis_angle(R), w, atol=2e-5)
    T = TP.at_to_transform_matrix(_t(w), _t(w[::-1].copy()))
    _close(T, JP.at_to_transform_matrix(jnp.asarray(w),
                                        jnp.asarray(w[::-1].copy())))


def test_quaternion_maps_match_jax():
    R = TP.axis_angle_to_matrix(_t(_rotvecs())).numpy()
    q = TP.matrix_to_quaternion(_t(R))
    _close(q, JP.matrix_to_quaternion(jnp.asarray(R)), atol=1e-6)
    _close(TP.quaternion_to_matrix(q), R, atol=1e-6)
    _close(TP.quaternion_to_axis_angle(q),
           JP.quaternion_to_axis_angle(jnp.asarray(q.numpy())), atol=1e-6)
    _close(TP.qt_to_transform_matrix(q, _t(R[:, 0])),
           JP.qt_to_transform_matrix(jnp.asarray(q.numpy()),
                                     jnp.asarray(R[:, 0])), atol=1e-6)


@pytest.mark.parametrize("scale", [0.0, 1e-6, 1e-3])
def test_pose_gradients_near_zero_match_jax(scale):
    """The Taylor branches keep the gradient of the exponential map finite
    at and near the identity, on both sides; the log map's gradient is
    compared off the identity (there JAX's norm has no gradient). Near
    theta = 0 the log map amplifies the f32 rounding of R (~1e-7) by
    ~1/theta, hence rtol 1e-3 at theta ~1e-3."""
    rng = np.random.default_rng(1)
    w = (rng.normal(size=(3,)) * scale).astype(np.float32)
    M = rng.normal(size=(3, 3)).astype(np.float32)
    wt = _t(w).requires_grad_(True)
    (TP.axis_angle_to_matrix(wt) * _t(M)).sum().backward()
    assert torch.isfinite(wt.grad).all()
    # Above the Taylor branch (theta^2 >= 1e-8) both sides evaluate
    # (1 - cos theta) / theta^2 in f32, whose cancellation leaves ~eps/theta
    # (~1e-4 at theta 1e-3) in the gradient.
    _close(wt.grad, jax.grad(lambda v: jnp.sum(JP.axis_angle_to_matrix(v) * M))(
        jnp.asarray(w)), rtol=1e-5, atol=1e-4 if scale > 1e-4 else 1e-6)
    if scale == 0.0:
        return
    R = JP.axis_angle_to_matrix(jnp.asarray(w))
    Rt = _t(np.asarray(R)).requires_grad_(True)
    (TP.matrix_to_axis_angle(Rt) ** 2).sum().backward()
    _close(Rt.grad, jax.grad(lambda r: jnp.sum(JP.matrix_to_axis_angle(r) ** 2))(
        R), rtol=1e-3, atol=1e-4)


# -- render -------------------------------------------------------------------

def _raw_z(seed=0, n=24, s=12):
    rng = np.random.default_rng(seed)
    z = np.sort(rng.uniform(0.1, 4.0, (n, s)), axis=1).astype(np.float32)
    raw = rng.normal(size=(n, s, 4)).astype(np.float32)
    # SDF samples: a surface crossing at a random depth, plus rays with no
    # crossing and with two crossings.
    surf = rng.uniform(0.5, 3.5, (n, 1))
    raw[..., 3] = (surf - z) * 5.0
    raw[0, :, 3] = np.abs(raw[0, :, 3]) + 0.1
    raw[1, :, 3] = np.cos(z[1] * 4.0)
    return raw, z


def test_sdf2weights_and_raw2outputs_match_jax():
    raw, z = _raw_z()
    _close(TR.sdf2weights(_t(raw[..., 3]), _t(z), 0.1),
           JR.sdf2weights(jnp.asarray(raw[..., 3]), jnp.asarray(z), 0.1))
    for white in (False, True):
        for a, b in zip(TR.raw2outputs(_t(raw), _t(z), 0.1, 1.0, white),
                        JR.raw2outputs(jnp.asarray(raw), jnp.asarray(z), 0.1,
                                       1.0, white)):
            _close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("guided", [True, False])
def test_stratified_z_vals_with_injected_draw(guided):
    rng = np.random.default_rng(2)
    n = 20
    depth = rng.uniform(0.5, 3.0, (n, 1)).astype(np.float32)
    depth[:4] = 0.0  # invalid depth: near..far fallback
    n_total = 32 + 11 if guided else 32
    t = rng.uniform(size=(n, n_total)).astype(np.float32)
    target = depth if guided else None
    args = (0.0, 5.0, 0.1, 11, 32)
    plain = TR.stratified_z_vals(n, None if target is None else _t(target),
                                 *args)
    ref = JR.stratified_z_vals(None, n, None if target is None else
                               jnp.asarray(target), *args, perturb=False)
    _close(plain, ref, atol=1e-6)
    # The perturbed draw is the JAX formula with the same t.
    mids = 0.5 * (ref[..., 1:] + ref[..., :-1])
    upper = jnp.concatenate([mids, ref[..., -1:]], -1)
    lower = jnp.concatenate([ref[..., :1], mids], -1)
    pert = TR.stratified_z_vals(n, None if target is None else _t(target),
                                *args, t=_t(t))
    _close(pert, lower + (upper - lower) * t, atol=1e-6)


# -- losses -------------------------------------------------------------------

def test_losses_match_jax():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(64, 3)).astype(np.float32)
    b = rng.normal(size=(64, 3)).astype(np.float32)
    m = (rng.uniform(size=(64, 1)) > 0.3).astype(np.float32)
    for mask in (None, m):
        tm = None if mask is None else _t(mask)
        jm = None if mask is None else jnp.asarray(mask)
        for kind in ("l2", "l1"):
            _close(TL.compute_loss(_t(a), _t(b), kind, tm),
                   JL.compute_loss(jnp.asarray(a), jnp.asarray(b), kind, jm))
        _close(TL.huber_loss(_t(a), _t(b), 0.1, tm),
               JL.huber_loss(jnp.asarray(a), jnp.asarray(b), 0.1, jm))
        _close(TL.masked_mean(_t(a), tm), JL.masked_mean(jnp.asarray(a), jm))
    _close(TL.mse2psnr(torch.tensor(0.01)), JL.mse2psnr(0.01))

    raw, z = _raw_z(seed=4)
    depth = rng.uniform(0.5, 3.0, (24, 1)).astype(np.float32)
    depth[:3] = 0.0
    ray_mask = (rng.uniform(size=(24,)) > 0.2).astype(np.float32)
    for rm in (None, ray_mask):
        trm = None if rm is None else _t(rm)
        jrm = None if rm is None else jnp.asarray(rm)
        for x, y in zip(TL.get_masks(_t(z), _t(depth), 0.1, trm),
                        JL.get_masks(jnp.asarray(z), jnp.asarray(depth), 0.1,
                                     jrm)):
            _close(x, y)
        for x, y in zip(
                TL.get_sdf_loss(_t(z), _t(depth), _t(raw[..., 3]), 0.1,
                                ray_mask=trm),
                JL.get_sdf_loss(jnp.asarray(z), jnp.asarray(depth),
                                jnp.asarray(raw[..., 3]), 0.1,
                                ray_mask=jrm)):
            _close(x, y, rtol=1e-5, atol=1e-6)

    emb = rng.normal(size=(7, 7, 7, 5)).astype(np.float32)
    _close(TL.smoothness_tv(_t(emb), 8), JL.smoothness_tv(jnp.asarray(emb), 8))
    ret = {k: float(v) for k, v in zip(
        ("rgb_loss", "depth_loss", "sdf_loss", "fs_loss"),
        rng.uniform(size=4))}
    w = {"rgb_weight": 5.0, "depth_weight": 0.1, "sdf_weight": 1000,
         "fs_weight": 10}
    _close(TL.total_loss(ret, w, smooth_loss=2.0, smooth_weight=1e-3),
           JL.total_loss(ret, w, smooth_loss=2.0, smooth_weight=1e-3))


# -- encodings and decoder ----------------------------------------------------

def test_oneblob_matches_jax():
    x = np.random.default_rng(5).uniform(-0.1, 1.1, (50, 3)).astype(np.float32)
    _close(TE.oneblob_encode(_t(x), 16), JE.oneblob_encode(jnp.asarray(x), 16))


def test_decoder_with_converted_weights_matches_jax():
    cfg = make_synthetic_config("", "/tmp/unused")
    jdec = JD.ColorSDFDecoder(cfg, input_ch=32, input_ch_pos=48)
    tdec = TD.ColorSDFDecoder(cfg, input_ch=32, input_ch_pos=48)
    assert tdec.sdf_dims == jdec.sdf_dims
    assert tdec.color_dims == jdec.color_dims
    jparams = jdec.init(jax.random.PRNGKey(0))
    np_params = {"grid": np.zeros((1, 2), np.float32),
                 "decoder": jax.tree_util.tree_map(np.asarray, jparams)}
    tparams = convert.params_from_numpy(np_params)["decoder"]
    rng = np.random.default_rng(6)
    emb = rng.normal(size=(40, 32)).astype(np.float32)
    pos = rng.uniform(size=(40, 48)).astype(np.float32)
    _close(tdec(tparams, _t(emb), _t(pos)),
           jdec(jparams, jnp.asarray(emb), jnp.asarray(pos)), rtol=1e-5,
           atol=1e-5)
    back = convert.params_to_numpy({"grid": torch.zeros(1, 2),
                                    "decoder": tparams})
    for a, b in zip(jax.tree_util.tree_leaves(back["decoder"]),
                    jax.tree_util.tree_leaves(np_params["decoder"])):
        np.testing.assert_array_equal(a, b)


def test_two_grid_decoder_matches_jax():
    """oneGrid false: the color net reads [embed_pos, embed_color,
    geo_feat]."""
    cfg = make_synthetic_config("", "/tmp/unused")
    jdec = JD.ColorSDFDecoder(cfg, input_ch=32, input_ch_pos=48,
                              input_ch_color=24, one_grid=False)
    tdec = TD.ColorSDFDecoder(cfg, 32, 48, 24, one_grid=False)
    assert tdec.color_dims == jdec.color_dims
    jparams = jdec.init(jax.random.PRNGKey(1))
    tparams = {k: [_t(w) for w in v] for k, v in jparams.items()}
    rng = np.random.default_rng(7)
    emb, pos, col = (rng.normal(size=(40, c)).astype(np.float32)
                     for c in (32, 48, 24))
    _close(tdec(tparams, _t(emb), _t(pos), _t(col)),
           jdec(jparams, *map(jnp.asarray, (emb, pos, col))), rtol=1e-5,
           atol=1e-5)


@pytest.mark.parametrize("name", ["Frequency", "SphericalHarmonics",
                                  "Identity"])
def test_coordinate_encodings_match_jax(name):
    """The coordinate encodings through make_encoder, on points in
    [-0.1, 1.1] (SH on directions, normalized inside): same functions of
    the same f32 inputs (1e-5; the frequency encoding's angles reach
    2^11 pi, where a sine's last bit is ~1e-7 of its argument's)."""
    x = np.random.default_rng(8).uniform(-0.1, 1.1, (64, 3)).astype(
        np.float32)
    _, japply, jdim, _ = JE.make_encoder(name)
    _, tapply, tdim, _ = TE.make_encoder(name)
    assert tdim == jdim
    got = tapply(None, _t(x))
    assert got.shape == (64, tdim)
    _close(got, japply(None, jnp.asarray(x)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_sh_degrees_match_jax(degree):
    d = np.random.default_rng(9).standard_normal((32, 3)).astype(np.float32)
    _close(TE.sh_encode(_t(d), degree), JE.sh_encode(jnp.asarray(d), degree))


def test_rotation_6d_and_se3_inverse_match_jax():
    """The 6D rotation maps, the 6D + translation transform and the
    closed-form SE(3) inverse (which inverts: T^-1 T = I)."""
    R = TP.axis_angle_to_matrix(_t(_rotvecs()))
    d6 = TP.matrix_to_rotation_6d(R)
    _close(d6, JP.matrix_to_rotation_6d(jnp.asarray(R.numpy())))
    noisy = d6.numpy() + np.random.default_rng(10).normal(
        0, 0.1, d6.shape).astype(np.float32)
    _close(TP.rotation_6d_to_matrix(_t(noisy)),
           JP.rotation_6d_to_matrix(jnp.asarray(noisy)), atol=1e-6)
    _close(TP.rotation_6d_to_matrix(d6), R.numpy(), atol=1e-6)
    t = _t(_rotvecs()[::-1].copy())
    T = TP.six_t_to_transform_matrix(_t(noisy), t)
    _close(T, JP.six_t_to_transform_matrix(jnp.asarray(noisy),
                                           jnp.asarray(t.numpy())),
           atol=1e-6)
    inv = TP.se3_inverse(T)
    _close(inv, JP.se3_inverse(jnp.asarray(T.numpy())), atol=1e-6)
    _close(inv @ T, np.broadcast_to(np.eye(4, dtype=np.float32), T.shape),
           atol=1e-5)
