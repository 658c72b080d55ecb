"""The comparison that decides ``correct``: what the window's steps
produced, against the plain reference following the same steps from the
program's own state.

The numbers, each held to its limit in ``slambench/limits/<config>.json``:

- ``track_loss0``: the first iteration's loss of each sampled tracking
  step (the same pose, rays and draws on both sides: kernel A, the MLPs,
  the render and the losses), the widest relative gap;
- ``track_pose``: each sampled tracking step's chosen pose, the widest
  gap of an entry of its [3, 4] rows (10 Adam steps: the encode's dx
  through kernel B);
- ``ba_loss0``: the sampled BA call's first iteration's loss, relative;
- ``ba_change``: the BA call's change of the map, the table and the MLPs'
  weights apart: the gap of the two sides' norms of the change over the
  reference's norm of it, the wider of the two;
- ``ff_loss0``: the first frame's mapping (set-up: the start of the
  state the window's steps are followed from), its first iteration's
  loss, relative gap;
- ``query``: rgb logits and SDF of the final map (kernel A and the MLPs)
  at points drawn from the seed, as many as a BA iteration's coarse
  samples, the widest gap over the largest reference value, for each of
  the two;
- ``dtable``: the table's gradient of a seeded weighting of the final
  map's hash-grid features at those points (kernel B's table mode), the
  widest entry gap over the largest reference entry.

A sampled step that never ran, or a number that is not finite, fails.
With ``control`` the reference in the precision below the
configuration's (``reference.Model(low=True)``) takes the program's
place, beside the program's readings. ``details`` are printed, not
compared: the BA's poses after the call (their gap, ``ba_pose``, reads
alike in the program and the control: Adam's steps on the poses follow
the gradients' signs) and the first frame's change of the map after its
mapping.first_iters iterations (``ff_change``, as ``ba_change``: over
hundreds of Adam steps with eps 1e-15 the two sides' rounding grows as
far as the control's).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from . import reference as R


def model_spec(cfg: Dict) -> R.GridSpec:
    return R.Model(cfg, "cpu").spec


def correct(numbers: Dict, limits: Dict) -> bool:
    return all(name in numbers and math.isfinite(numbers[name])
               and numbers[name] <= lim for name, lim in limits.items())


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _pose_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a[..., :3, :4].double() - b[..., :3, :4].double()).abs()
                 .max())


def _groups(params: Dict):
    """The map as two vectors: the table, and the MLPs' weights."""
    dec = params["decoder"]["sdf_net"] + params["decoder"]["color_net"]
    return [params["grid"].reshape(-1),
            torch.cat([w.reshape(-1) for w in dec])]


def _change_gap(before: Dict, side: Dict, ref: Dict) -> float:
    """The gap of the two sides' norms of the map's change (the table,
    the MLPs' weights), over the reference's norm of it, the wider."""
    b = _groups(before)
    ds = [float((a - c).norm()) for a, c in zip(_groups(side), b)]
    dr = [float((a - c).norm()) for a, c in zip(_groups(ref), b)]
    return max(abs(x - y) / max(y, 1e-30) for x, y in zip(ds, dr))


def _follow(model: R.Model, program: Dict) -> Dict:
    """The reference's outputs of the recorded steps and of the final
    map's queries."""
    out = {"tracks": [], "ba": None, "first": None}
    for rec in program["tracks"]:
        pose, losses = R.track(model, rec["params"], rec["c2w_init"],
                               rec["rays"], rec["gen_state"])
        out["tracks"].append({"c2w": pose, "losses": losses})
    rec = program["ba"]
    if rec is not None:
        after, kf, cur, losses, _ = R.bundle_adjust(
            model, rec["params"], rec["opt_state"], rec["kf_rays"],
            rec["kf_count"], rec["kf_poses"], rec["cur_pose"],
            rec["cur_rays"], rec["gen_state"])
        out["ba"] = {"params_after": after, "kf_poses_after": kf,
                     "cur_after": cur, "losses": losses}
    rec = program["first"]
    if rec is not None:
        after, losses = R.first_frame(model, rec["params"], rec["c2w"],
                                      rec["frame_rays"], rec["gen_state"])
        out["first"] = {"params_after": after, "loss0": losses[0]}
    x, g = program["points"]
    out["query"] = R.query(model, program["final"], x)
    out["dtable"] = R.table_grad(model, program["final"]["grid"], x, g)
    return out


def _program_side(program: Dict) -> Dict:
    """The program's outputs in the shape of :func:`_follow`'s."""
    port, params = program["model"], program["params"]
    x, g = program["points"]
    dec = {k: [w.detach() for w in v] for k, v in params["decoder"].items()}
    with torch.no_grad(), R.precision(False):
        query = port.query_color_sdf({"grid": params["grid"].detach(),
                                      "decoder": dec}, x)
    table = params["grid"].detach().clone().requires_grad_(True)
    (port.query_sdf({"grid": table, "decoder": dec}, x, embed=True)
     * g).sum().backward()
    tracks = [{"c2w": r["c2w"], "losses": [float(v) for v in r["losses"]]}
              for r in program["tracks"]]
    ba = None
    rec = program["ba"]
    if rec is not None:
        ba = {"params_after": rec["params_after"],
              "kf_poses_after": rec["kf_poses_after"],
              "cur_after": rec["cur_after"],
              "losses": [float(v) for v in rec["losses"]]}
    first = program["first"]
    if first is not None:
        first = {"params_after": first["params_after"],
                 "loss0": first["loss0"]}
    return {"tracks": tracks, "ba": ba, "first": first, "query": query,
            "dtable": table.grad}


def numbers(program: Dict, side: Dict, ref: Dict):
    """(the gaps of ``side``'s outputs from the reference's ``ref``, the
    details)."""
    nan = float("nan")
    out, details = {}, {}
    if len(side["tracks"]) != len(program["track_frames"]):
        out["track_loss0"] = out["track_pose"] = nan
    else:
        out["track_loss0"] = max(_rel(s["losses"][0], r["losses"][0])
                                 for s, r in zip(side["tracks"],
                                                 ref["tracks"]))
        out["track_pose"] = max(_pose_gap(s["c2w"], r["c2w"])
                                for s, r in zip(side["tracks"],
                                                ref["tracks"]))
    if side["ba"] is None or ref["ba"] is None:
        out["ba_loss0"] = out["ba_change"] = nan
    else:
        s, r, rec = side["ba"], ref["ba"], program["ba"]
        out["ba_loss0"] = _rel(s["losses"][0], r["losses"][0])
        out["ba_change"] = _change_gap(rec["params"], s["params_after"],
                                       r["params_after"])
        count = rec["kf_count"]
        details["ba_pose"] = max(
            _pose_gap(s["kf_poses_after"][:count], r["kf_poses_after"][:count]),
            _pose_gap(s["cur_after"], r["cur_after"]))
    if side["first"] is None or ref["first"] is None:
        out["ff_loss0"] = nan
    else:
        s, r = side["first"], ref["first"]
        out["ff_loss0"] = _rel(s["loss0"], r["loss0"])
        details["ff_change"] = _change_gap(program["first"]["params"],
                                           s["params_after"],
                                           r["params_after"])
    q_s, q_r = side["query"], ref["query"]
    out["query"] = max(
        float((q_s[:, c] - q_r[:, c]).abs().max()
              / q_r[:, c].abs().max().clamp_min(1e-30))
        for c in (slice(0, 3), slice(3, 4)))
    out["dtable"] = float((side["dtable"] - ref["dtable"]).abs().max()
                          / ref["dtable"].abs().max().clamp_min(1e-30))
    return {k: float(v) for k, v in out.items()}, details


def compare(cfg: Dict, program: Dict, seed: int, device,
            control: bool = False) -> Dict:
    """{"program": numbers, "details": ...[, "control": numbers]}."""
    device = torch.device(device)
    spec = model_spec(cfg)
    n = int(cfg["mapping"]["sample"]) * (cfg["training"]["n_samples_d"]
                                          + cfg["training"]["n_range_d"])
    gen = torch.Generator(device=device).manual_seed(int(seed) + 11)
    x = torch.rand((n, 3), generator=gen, device=device)
    g = torch.randn((n, spec.n_levels * spec.n_features), generator=gen,
                    device=device)
    program = dict(program, points=(x, g), final=program["params"])
    ref = _follow(R.Model(cfg, device), program)
    side = _program_side(program)
    prog, details = numbers(program, side, ref)
    out = {"program": prog, "details": details}
    if control:
        low = _follow(R.Model(cfg, device, low=True), program)
        out["control"], out["control_details"] = numbers(program, low, ref)
    return out
