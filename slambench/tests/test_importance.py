"""The reference's importance fine pass (the TUM recipe's 64 + 21 + 128
samples a ray, at a tiny size): its render, loss and table gradient
against the program's ``render_rays`` on seeded weights, rays and draws;
a tiny TUM-layout cell run through the harness end to end, correct; and
the same cell with the program's fine pass cut to half its importance
samples, not correct; and room0's reference, which has no fine pass, bit
for bit as before the fine pass was added.

The tiny cell is the TUM recipe of ``slambench/configs/tum_fr1_desk.json``
(the configuration a TUM cell would bring), cut by ``tiny``'s overrides, in a checkout of its own made under the test's temporary
directory, held to the limits room0 is held to."""

import hashlib
import os
import shutil

import pytest
import torch

from slambench import harness, reference as R
from slambench.tests import tiny

CONFIG = "tum_fr1_desk"
FIXTURE = os.path.join(harness.ROOT, "slambench", "configs",
                       CONFIG + ".json")
# Relative gaps of the render and the loss, and the table gradient's
# widest entry gap over its largest entry, of the reference from the
# program on the CPU in float32: the encodes sum the same corners in
# another order (a few ulp), which the fine pass's samples carry on.
RENDER_TOL = 1e-5
GRAD_TOL = 1e-4


def tiny_cfg(**training):
    cfg = harness.build_config(harness.load_json(FIXTURE), 3, "", "",
                               tiny.overrides(CONFIG))
    cfg["training"].update(training)
    return cfg


def _map(cfg):
    """The program's initial map from a seed, moved off its start so that
    the weights have a surface."""
    from coslam_torch.models.scene_rep import JointEncoding

    gen = torch.Generator().manual_seed(5)
    params = JointEncoding(cfg, cfg["mapping"]["bound"], "cpu").init_params(
        gen)
    params["grid"] = params["grid"] + 0.05 * torch.randn(
        params["grid"].shape, generator=gen)
    return params


def _inputs(n=48):
    """Rays (origins, directions, target rgb, target depth) from a seed."""
    gen = torch.Generator().manual_seed(11)
    rays_o = 0.3 * (torch.rand((n, 3), generator=gen) - 0.5)
    rays_d = torch.nn.functional.normalize(
        torch.randn((n, 3), generator=gen), dim=-1)
    target_d = 0.5 + 2.5 * torch.rand((n, 1), generator=gen)
    target_d[::7] = 0.0                      # rays without depth
    target_rgb = torch.rand((n, 3), generator=gen)
    return rays_o, rays_d, target_rgb, target_d


def _program_side(cfg, params, rays, draws, robust):
    from coslam_torch.models.scene_rep import JointEncoding

    model = JointEncoding(cfg, cfg["mapping"]["bound"], "cpu")
    table = params["grid"].clone().requires_grad_(True)
    p = {"grid": table, "decoder": params["decoder"]}
    ret = model.forward(p, *rays, t=draws[0], u=draws[1], rgb_kernel=robust)
    w = cfg["training"]
    loss = (w["rgb_weight"] * ret["rgb_loss"]
            + w["depth_weight"] * ret["depth_loss"]
            + w["sdf_weight"] * ret["sdf_loss"]
            + w["fs_weight"] * ret["fs_loss"])
    loss.backward()
    return (ret["rgb"].detach(), ret["depth"].detach(), float(loss.detach()),
            table.grad)


def _reference_side(cfg, params, rays, draws, robust):
    model = R.Model(cfg, "cpu")
    rays_o, rays_d, target_rgb, target_d = rays
    table = params["grid"].clone().requires_grad_(True)
    p = {"grid": table, "decoder": params["decoder"]}
    with torch.no_grad():
        rend = model.render(p, rays_o, rays_d, target_d, draws[0], draws[1])
    loss = model.loss(p, rays_o, rays_d, target_rgb, target_d, draws[0],
                      robust, draws[1])
    loss.backward()
    return rend["rgb"], rend["depth"], float(loss.detach()), table.grad


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("perturb,robust", [(1, 0.1), (0, None)],
                         ids=["drawn-huber", "strata-centres"])
def test_reference_fine_pass_against_the_program(perturb, robust):
    from coslam_torch.models.scene_rep import JointEncoding

    cfg = tiny_cfg(perturb=perturb)
    assert cfg["training"]["n_importance"] > 0
    params, rays = _map(cfg), _inputs()
    draws = JointEncoding(cfg, cfg["mapping"]["bound"], "cpu").ray_draws(
        torch.Generator().manual_seed(9), rays[0].shape[0], "cpu")
    assert (draws[1] is None) == (perturb == 0)
    rgb_p, depth_p, loss_p, grad_p = _program_side(cfg, params, rays, draws,
                                                   robust)
    rgb_r, depth_r, loss_r, grad_r = _reference_side(cfg, params, rays,
                                                     draws, robust)
    assert _rel(rgb_r, rgb_p) <= RENDER_TOL
    assert _rel(depth_r, depth_p) <= RENDER_TOL
    assert abs(loss_r - loss_p) <= RENDER_TOL * abs(loss_p)
    assert grad_p.abs().max() > 0
    assert _rel(grad_r, grad_p) <= GRAD_TOL


def test_reference_draws_follow_the_program_order():
    """t, then u, from one generator: the same values as ray_draws."""
    from coslam_torch.models.scene_rep import JointEncoding

    cfg = tiny_cfg()
    prog = JointEncoding(cfg, cfg["mapping"]["bound"], "cpu").ray_draws(
        torch.Generator().manual_seed(2), 9, "cpu")
    ref = R.Model(cfg, "cpu").draws(torch.Generator().manual_seed(2), 9)
    assert torch.equal(prog[0], ref[0]) and torch.equal(prog[1], ref[1])


@pytest.fixture(scope="module")
def tum_root(tmp_path_factory):
    """A checkout of the harness's files with the TUM configuration in
    place (its frames cached there once for the module's runs)."""
    root = tmp_path_factory.mktemp("tum_checkout")
    here = os.path.join(harness.ROOT, "slambench")
    for sub, src in (("configs", FIXTURE),
                     ("limits", os.path.join(here, "limits",
                                             "replica_room0.json")),
                     ("traffic", os.path.join(here, "traffic", "seq.json"))):
        os.makedirs(root / "slambench" / sub)
        name = "seq.json" if sub == "traffic" else CONFIG + ".json"
        shutil.copy(src, root / "slambench" / sub / name)
    return str(root)


def test_tiny_tum_cell_is_correct(tum_root):
    r = tiny.run(CONFIG, root=tum_root, seconds=4.0)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


def _half_importance(slam):
    """The program's fine pass with the second half of its importance
    draws left out."""
    from coslam_torch.ops import render as PR

    model = slam.model
    fine = model._fine_pass

    def broken(params, rays_o, rays_d, z_vals, raw, weights, u):
        if u is None:
            u = PR.importance_u(rays_o.shape[0], model.n_importance,
                                rays_o.device)
        return fine(params, rays_o, rays_d, z_vals, raw, weights,
                    u[:, : u.shape[1] // 2])

    model._fine_pass = broken


def test_half_importance_comes_out_not_correct(tum_root):
    r = tiny.run(CONFIG, root=tum_root, seconds=4.0, hook=_half_importance)
    assert not r["correct"]
    c = r["checks"]["track_loss0"]
    assert not c["value"] <= c["limit"], r["checks"]


# room0's reference (coarse pass alone) on _map's map and _inputs' rays,
# as reference.py gave them before it took the fine pass: the loss
# (float.hex), the table gradient's and the render's bytes (sha1).
COARSE_LOSS = "0x1.fae4220000000p+0"
COARSE_GRAD_SHA1 = "48dd2975aaecc933cd4632dccd8f0c539bbabc8e"
COARSE_RENDER_SHA1 = "60b87457a74a143ea69c269f9348a8aa6a394e2d"


def _coarse_outputs():
    """(loss, table gradient, render) of the reference for room0's tiny
    configuration on _map's map and _inputs' rays."""
    spec = harness.cell_files(harness.ROOT, "replica_room0", "seq")
    cfg = harness.build_config(spec["config"], 3, "", "",
                               tiny.overrides("replica_room0"))
    params, (rays_o, rays_d, target_rgb, target_d) = _map(cfg), _inputs()
    ref = R.Model(cfg, "cpu")
    t, u = ref.draws(torch.Generator().manual_seed(9), rays_o.shape[0])
    assert u is None
    table = params["grid"].clone().requires_grad_(True)
    p = {"grid": table, "decoder": params["decoder"]}
    loss = ref.loss(p, rays_o, rays_d, target_rgb, target_d, t, 0.1)
    loss.backward()
    with torch.no_grad():
        rend = ref.render(p, rays_o, rays_d, target_d, t)
    return loss.detach(), table.grad, rend


def _sha1(*tensors):
    h = hashlib.sha1()
    for x in tensors:
        h.update(x.detach().numpy().tobytes())
    return h.hexdigest()


def test_coarse_only_reference_bit_for_bit_as_before():
    loss, grad, rend = _coarse_outputs()
    assert sorted(rend) == ["depth", "raw", "rgb", "z"]
    assert float(loss).hex() == COARSE_LOSS
    assert _sha1(grad) == COARSE_GRAD_SHA1
    assert _sha1(*(rend[k] for k in sorted(rend))) == COARSE_RENDER_SHA1
