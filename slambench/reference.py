"""The plain reference of the cells' model: Co-SLAM's HashGrid + OneBlob
joint encoding, its volume rendering and losses, the tracking step and
one bundle adjustment call, in plain PyTorch.

A frozen copy of the plain paths of the measured program, trimmed to what
the cells run (the packed hash grid, OneBlob, the bias-free ReLU MLPs,
the depth-guided stratified samples, the importance fine pass, the SDF
losses, the axis-angle pose and torch's Adam). It imports nothing of
the program. The hash encode is one ``index_select`` per corner pair,
differentiated by autograd: the table gradient is ``index_select``'s
backward (an ``index_add_``) and dx flows through the trilinear weights.

Random draws follow the program's draw order on a ``torch.Generator``
restored from the state the program's generator had when the step began,
so both sides see the same rays, perturbations and lattices.

``Model(..., low=True)`` is the control: the reference computed in the
precision just below the configuration's. The configuration runs float32
with TF32 off: the control runs the matrix products in TF32 and the hash
encode (float32 outside any matrix product) on bfloat16 table values, its
table gradient passing through bfloat16 too.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

_P1 = 2654435761
_P2 = 805459861


# ---------------------------------------------------------------------------
# Precision
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def precision(tf32: bool):
    """Matrix products in TF32 or in full float32."""
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
    torch.backends.cudnn.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was


# ---------------------------------------------------------------------------
# The packed hash grid
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GridSpec:
    n_levels: int
    n_features: int
    log2_hashmap_size: int
    resolutions: Tuple[int, ...]
    hashed: Tuple[bool, ...]
    offsets: Tuple[int, ...]
    total_entries: int


def grid_spec(desired_resolution: int, log2_hashmap_size: int,
              n_levels: int = 16, n_features: int = 2,
              base_resolution: int = 16) -> GridSpec:
    """Levels from base_resolution to desired_resolution at a constant
    growth; a level is stored densely ((res+1)^3 rows, z minor) when that
    fits 2^S rows, else hashed (2^S + res + 1 rows)."""
    growth = math.exp2(math.log2(desired_resolution / base_resolution)
                       / (n_levels - 1))
    max_hash = 2 ** log2_hashmap_size
    res_l, hashed, offsets, off = [], [], [], 0
    for lvl in range(n_levels):
        res = max(int(math.floor(base_resolution * growth ** lvl)), 1)
        use_hash = (res + 1) ** 3 > max_hash
        res_l.append(res)
        hashed.append(use_hash)
        offsets.append(off)
        off += (max_hash + res + 1) if use_hash else (res + 1) ** 3
    return GridSpec(n_levels, n_features, log2_hashmap_size, tuple(res_l),
                    tuple(hashed), tuple(offsets), off)


def corner_rows(spec: GridSpec, x: torch.Tensor):
    """x [N, 3] in [0, 1] -> (rows [L, 4, N] of the four xy corners' z
    rows, whose z + 1 corners are the next rows; weights w [L, 3, N])."""
    dev = x.device
    res = torch.tensor(spec.resolutions, dtype=x.dtype, device=dev)
    resi = torch.tensor(spec.resolutions, device=dev)[:, None, None]
    pos = res[:, None, None] * x.clamp(0.0, 1.0).T[None]
    cell = torch.minimum(pos.detach().floor().long().clamp_min(0), resi - 1)
    w = pos - cell.to(x.dtype)
    cx, cy, cz = cell.unbind(1)
    rl = resi[:, :, 0]
    xs = (cx, torch.minimum(cx + 1, rl))
    ys = (cy, torch.minimum(cy + 1, rl))
    rows = []
    mask = 2 ** spec.log2_hashmap_size - 1
    for lvl in range(spec.n_levels):
        if spec.hashed[lvl]:
            c4 = [((xs[c >> 1][lvl] * _P1) ^ (ys[c & 1][lvl] * _P2)) & mask
                  for c in range(4)]
        else:
            r1 = spec.resolutions[lvl] + 1
            c4 = [(xs[c >> 1][lvl] * r1 + ys[c & 1][lvl]) * r1
                  for c in range(4)]
        rows.append(torch.stack(c4) + cz[lvl] + spec.offsets[lvl])
    return torch.stack(rows), w


def encode(spec: GridSpec, table: torch.Tensor, x: torch.Tensor,
           bf16: bool = False) -> torch.Tensor:
    """Trilinear hash-grid features [N, L*F], column l*F + f. ``bf16``:
    the table's values rounded to bfloat16 (and its gradient with them)."""
    if bf16:
        table = table.to(torch.bfloat16).to(torch.float32)
    e, w = corner_rows(spec, x)
    p0 = table.index_select(0, e.reshape(-1)).view(*e.shape, -1)
    p1 = table.index_select(0, (e + 1).reshape(-1)).view(*e.shape, -1)
    wx, wy, wz = w[:, 0], w[:, 1], w[:, 2]                # [L, N]
    wxy = torch.stack([(1 - wx) * (1 - wy), (1 - wx) * wy,
                       wx * (1 - wy), wx * wy], 1)        # [L, 4, N]
    wz = wz[:, None, :, None]
    feat = ((p0 * (1 - wz) + p1 * wz) * wxy[..., None]).sum(1)  # [L, N, F]
    return feat.permute(1, 0, 2).reshape(x.shape[0], -1)


def oneblob(x: torch.Tensor, n_bins: int) -> torch.Tensor:
    edges = torch.arange(n_bins + 1, dtype=x.dtype, device=x.device) / n_bins
    u = (edges - x[..., None]) * n_bins
    uc = u.clamp(-1.0, 1.0)
    cdf = 0.5 + (15.0 / 16.0) * (uc - (2.0 / 3.0) * uc ** 3
                                 + (1.0 / 5.0) * uc ** 5)
    cdf = torch.where(u < -1.0, torch.zeros_like(cdf),
                      torch.where(u > 1.0, torch.ones_like(cdf), cdf))
    return (cdf[..., 1:] - cdf[..., :-1]).reshape(x.shape[0], -1)


def mlp(ws: List[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    for w in ws[:-1]:
        x = torch.relu(x @ w)
    return x @ ws[-1]


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Samples [N, n] by inverting the CDF of ``weights`` [N, M] (each
    raised by 1e-5) over the bin edges ``bins`` [N, M + 1] at ``u``
    [N, n]; a bin whose CDF step is under ``eps`` is read as one of 1."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]), pdf.cumsum(-1)], -1)
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = (inds - 1).clamp(min=0)
    above = inds.clamp(max=cdf.shape[-1] - 1)
    c0, c1 = cdf.gather(-1, below), cdf.gather(-1, above)
    b0, b1 = bins.gather(-1, below), bins.gather(-1, above)
    denom = torch.where(c1 - c0 < eps, torch.ones_like(c0), c1 - c0)
    return b0 + (u - c0) / denom * (b1 - b0)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


class Model:
    """The joint encoding of a configuration: query, render, losses."""

    def __init__(self, cfg: Dict, device, low: bool = False):
        self.cfg = cfg
        self.low = bool(low)
        self.device = torch.device(device)
        bb = np.asarray(cfg["mapping"]["bound"], np.float32)
        self.bound = torch.from_numpy(bb).to(self.device)
        dim_max = float((bb[:, 1] - bb[:, 0]).max())
        vs = cfg["grid"]["voxel_sdf"]
        res = int(vs) if vs > 10 else int(dim_max / vs)
        self.spec = grid_spec(res, int(cfg["grid"]["hash_size"]))
        self.n_bins = int(cfg["pos"]["n_bins"])
        tr = cfg["training"]
        self.n_z = tr["n_samples_d"] + tr["n_range_d"]
        self.n_imp = int(tr["n_importance"])
        self._lin = {}

    def normalize(self, p: torch.Tensor) -> torch.Tensor:
        lo, hi = self.bound[:, 0], self.bound[:, 1]
        return (p - lo) / (hi - lo)

    def query(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        """Normalized x [N, 3] -> [rgb logits, sdf] [N, 4]."""
        emb = self.embed(params["grid"], x)
        pos = oneblob(x, self.n_bins)
        h = mlp(params["decoder"]["sdf_net"], torch.cat([emb, pos], -1))
        rgb = mlp(params["decoder"]["color_net"],
                  torch.cat([pos, h[:, 1:]], -1))
        return torch.cat([rgb, h[:, :1]], -1)

    def embed(self, table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return encode(self.spec, table, x, self.low)

    def run_network(self, params, pts):
        raw = self.query(params, self.normalize(pts.reshape(-1, 3)))
        return raw.reshape(*pts.shape[:-1], 4)

    # -- sampling --------------------------------------------------------

    def linspace(self, a: float, b: float, n: int) -> torch.Tensor:
        """XLA's f32 linspace of constants: start (1 - i r) + i (stop r),
        the last value stop."""
        key = (a, b, n)
        if key not in self._lin:
            f = np.float32
            i = np.arange(n - 1, dtype=f)
            r = f(1.0) / f(n - 1)
            v = np.append(f(a) * (f(1.0) - i * r) + i * (f(b) * r), f(b))
            self._lin[key] = torch.from_numpy(v.astype(f)).to(self.device)
        return self._lin[key]

    def coarse_z(self, target_d: torch.Tensor, t: Optional[torch.Tensor]):
        tr, cam = self.cfg["training"], self.cfg["cam"]
        n = target_d.shape[0]
        z_s = self.linspace(-tr["range_d"], tr["range_d"],
                            tr["n_range_d"])[None] + target_d
        invalid = (target_d[:, 0] <= 0.0)[:, None]
        z_s = torch.where(invalid, self.linspace(cam["near"], cam["far"],
                                                 tr["n_range_d"])[None], z_s)
        z_u = self.linspace(cam["near"], cam["far"],
                            tr["n_samples_d"])[None].expand(n, -1)
        z = torch.cat([z_u, z_s], -1).sort(-1).values
        if t is not None:
            mids = 0.5 * (z[..., 1:] + z[..., :-1])
            upper = torch.cat([mids, z[..., -1:]], -1)
            lower = torch.cat([z[..., :1], mids], -1)
            z = lower + (upper - lower) * t
        return z

    def draws(self, gen: torch.Generator, n_rays: int):
        """(t [n_rays, n_z], u [n_rays, n_imp] or None without a fine
        pass), drawn in that order; (None, None) when perturb is 0."""
        if self.cfg["training"]["perturb"] <= 0:
            return None, None
        t = torch.rand((n_rays, self.n_z), generator=gen, device=self.device)
        u = (torch.rand((n_rays, self.n_imp), generator=gen,
                        device=self.device) if self.n_imp > 0 else None)
        return t, u

    # -- rendering -------------------------------------------------------

    def raw2outputs(self, raw, z):
        tr = self.cfg["training"]
        trunc = tr["trunc"]
        sc = self.cfg["data"]["sc_factor"]
        rgb = torch.sigmoid(raw[..., :3])
        sdf = raw[..., 3]
        w = torch.sigmoid(sdf / trunc) * torch.sigmoid(-sdf / trunc)
        crossing = ((sdf[:, 1:] * sdf[:, :-1]) < 0.0).to(z.dtype)
        z_min = torch.gather(z, 1, crossing.argmax(dim=1)[:, None])
        w = w * (z < z_min + sc * trunc).to(z.dtype)
        w = w / (w.sum(-1, keepdim=True) + 1e-8)
        return (w[..., None] * rgb).sum(-2), (w * z).sum(-1), w

    def render(self, params, rays_o, rays_d, target_d, t, u=None):
        """The coarse pass; with n_importance > 0 also the fine pass,
        whose maps replace the coarse ones (kept as rgb0, depth0) and
        whose z and raw are the coarse and the new samples merged."""
        z = self.coarse_z(target_d, t)
        pts = rays_o[..., None, :] + rays_d[..., None, :] * z[..., :, None]
        raw = self.run_network(params, pts)
        rgb, depth, w = self.raw2outputs(raw, z)
        out = {}
        if self.n_imp > 0:
            out.update(rgb0=rgb, depth0=depth)
            z, raw = self.fine(params, rays_o, rays_d, z, raw, w, u)
            rgb, depth, _ = self.raw2outputs(raw, z)
        out.update(rgb=rgb, depth=depth, z=z, raw=raw)
        return out

    def fine(self, params, rays_o, rays_d, z, raw, w, u):
        """n_imp samples drawn from the coarse weights by CDF inversion
        (``u``, or the strata's centres when it is None), the network
        queried at those, then z and raw merged with the coarse pass's in
        a stable order (a new sample equal to a coarse z comes second)."""
        if u is None:
            u = self.linspace(0.5 / self.n_imp, 1.0 - 0.5 / self.n_imp,
                              self.n_imp)[None].expand(z.shape[0], -1)
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        z_new = sample_pdf(mids, w[..., 1:-1], u).detach()
        pts = (rays_o[..., None, :]
               + rays_d[..., None, :] * z_new[..., :, None])
        raw_new = self.run_network(params, pts)
        z_cat = torch.cat([z, z_new], -1)
        raw_cat = torch.cat([raw, raw_new], -2)
        order = torch.argsort(z_cat, dim=-1, stable=True)
        return (torch.gather(z_cat, -1, order),
                torch.gather(raw_cat, -2, order[..., None].expand(
                    -1, -1, raw_cat.shape[-1])))

    def loss(self, params, rays_o, rays_d, target_rgb, target_d, t,
             robust: Optional[float], u=None) -> torch.Tensor:
        """total_loss of the render (rgb, depth, sdf and free-space terms,
        without the smoothness term; with a fine pass the coarse pass's
        rgb and depth terms are added to the fine pass's)."""
        tr = self.cfg["training"]
        rend = self.render(params, rays_o, rays_d, target_d, t, u)
        td = target_d[..., 0]
        valid = ((td > 0.0) & (td < self.cfg["cam"]["depth_trunc"])).to(
            td.dtype)
        rgb_w = torch.where(valid > 0, 1.0, tr["rgb_missing"])[:, None]
        target = target_rgb * rgb_w

        def rgb_err(pred):
            if robust is None:
                return ((pred * rgb_w - target) ** 2).sum()
            a = (pred * rgb_w - target).abs()
            q = a.clamp_max(robust)
            return (q * (2.0 * a - q)).sum()

        n_rgb = float(target_rgb.numel())
        n_depth = valid.sum().clamp_min(1.0)
        rgb_loss = rgb_err(rend["rgb"]) / n_rgb
        depth_loss = (((rend["depth"] - td) ** 2) * valid).sum() / n_depth
        if "rgb0" in rend:
            rgb_loss = rgb_loss + rgb_err(rend["rgb0"]) / n_rgb
            depth_loss = depth_loss + ((((rend["depth0"] - td) ** 2) * valid
                                        ).sum() / n_depth)
        trunc = tr["trunc"] * self.cfg["data"]["sc_factor"]
        z, sdf = rend["z"], rend["raw"][..., -1]
        front = (z < (target_d - trunc)).to(z.dtype)
        back = (z > (target_d + trunc)).to(z.dtype)
        band = (1.0 - front) * (1.0 - back) * (target_d > 0.0).to(z.dtype)
        num_fs, num_sdf = front.sum(), band.sum()
        num = (num_fs + num_sdf).clamp_min(1.0)
        n_z = float(z.numel())
        fs_loss = ((sdf * front - front) ** 2).sum() / n_z * (1 - num_fs / num)
        sdf_loss = (((z + sdf * trunc) * band - target_d * band) ** 2
                    ).sum() / n_z * (1 - num_sdf / num)
        return (tr["rgb_weight"] * rgb_loss + tr["depth_weight"] * depth_loss
                + tr["sdf_weight"] * sdf_loss + tr["fs_weight"] * fs_loss)

    # -- smoothness ------------------------------------------------------

    def smoothness_points(self, gen: torch.Generator) -> torch.Tensor:
        tr = self.cfg["training"]
        sp, vox, margin = tr["smooth_pts"], tr["smooth_vox"], tr["smooth_margin"]
        lo, hi = self.bound[:, 0], self.bound[:, 1]
        offset_max = hi - lo - (sp - 1) * vox - 2 * margin
        u = torch.rand(6, generator=gen, device=gen.device).to(self.device)
        offset, jitter = u[:3] * offset_max + margin, u[3:]
        g = sp - 1
        ax = torch.arange(g, dtype=torch.float32, device=self.device)
        coords = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1)
        pts = (coords + jitter) * vox + lo + offset
        return ((pts - lo) / (hi - lo)).reshape(-1, 3)

    def smoothness(self, table: torch.Tensor, pts: torch.Tensor):
        sp = self.cfg["training"]["smooth_pts"]
        g = sp - 1
        e = self.embed(table, pts).reshape(g, g, g, -1)
        tv = (((e[1:] - e[:-1]) ** 2).sum() + ((e[:, 1:] - e[:, :-1]) ** 2).sum()
              + ((e[:, :, 1:] - e[:, :, :-1]) ** 2).sum())
        return tv / sp ** 3


# ---------------------------------------------------------------------------
# Pose
# ---------------------------------------------------------------------------


def axis_angle_to_matrix(w: torch.Tensor) -> torch.Tensor:
    eps = 1e-8
    theta_sq = (w * w).sum(-1)
    theta = torch.sqrt(theta_sq.clamp_min(eps * eps))
    small = theta_sq < eps
    wx, wy, wz = w.unbind(-1)
    zeros = torch.zeros_like(wx)
    K = torch.stack([torch.stack([zeros, -wz, wy], -1),
                     torch.stack([wz, zeros, -wx], -1),
                     torch.stack([-wy, wx, zeros], -1)], -2)
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / theta_sq.clamp_min(eps * eps))
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    KK = w[..., :, None] * w[..., None, :] - theta_sq[..., None, None] * eye
    return eye + a[..., None, None] * K + b[..., None, None] * KK


def matrix_to_axis_angle(R: torch.Tensor) -> torch.Tensor:
    m = [[R[..., i, j] for j in range(3)] for i in range(3)]
    sq = torch.stack([1.0 + m[0][0] + m[1][1] + m[2][2],
                      1.0 + m[0][0] - m[1][1] - m[2][2],
                      1.0 - m[0][0] + m[1][1] - m[2][2],
                      1.0 - m[0][0] - m[1][1] + m[2][2]], -1)
    comps = [[sq[..., 0], m[2][1] - m[1][2], m[0][2] - m[2][0],
              m[1][0] - m[0][1]],
             [m[2][1] - m[1][2], sq[..., 1], m[0][1] + m[1][0],
              m[0][2] + m[2][0]],
             [m[0][2] - m[2][0], m[0][1] + m[1][0], sq[..., 2],
              m[1][2] + m[2][1]],
             [m[1][0] - m[0][1], m[0][2] + m[2][0], m[1][2] + m[2][1],
              sq[..., 3]]]
    cands = torch.stack([torch.stack(c, -1) / (2.0 * torch.sqrt(
        sq[..., k].clamp_min(1e-12)))[..., None] for k, c in enumerate(comps)],
        -2)
    best = sq.argmax(-1)
    q = torch.gather(cands, -2, best[..., None, None].expand(
        *best.shape, 1, 4))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    w = q[..., 0].clamp(-1.0, 1.0)
    xyz = q[..., 1:]
    norm = torch.linalg.norm(xyz, dim=-1)
    theta = 2.0 * torch.atan2(norm, w)
    scale = torch.where(norm < 1e-8, 2.0 + theta * theta / 12.0,
                        theta / norm.clamp_min(1e-12))
    return xyz * scale[..., None]


def se3(rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    R = axis_angle_to_matrix(rot)
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype,
                         device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([torch.cat([R, trans[..., :, None]], -1), bottom], -2)


def _generator(state: torch.Tensor, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.set_state(state)
    return g


# ---------------------------------------------------------------------------
# The steps
# ---------------------------------------------------------------------------


def track(model: Model, params: Dict, c2w_init: torch.Tensor,
          rays: torch.Tensor, gen_state: torch.Tensor):
    """The tracking step from the map ``params`` (frozen), the start pose
    and the rays [S, 7] -> (pose [4, 4], the loss of every iteration)."""
    tcfg = model.cfg["tracking"]
    robust = float(tcfg.get("robust_delta", 0.0) or 0.0) or None
    gen = _generator(gen_state, model.device)
    params = {"grid": params["grid"].detach(),
              "decoder": {k: [w.detach() for w in v]
                          for k, v in params["decoder"].items()}}
    with precision(model.low):
        rot = matrix_to_axis_angle(c2w_init[:3, :3])[None].clone()
        trans = c2w_init[:3, 3][None].clone()
        rot.requires_grad_(True)
        trans.requires_grad_(True)
        opt = torch.optim.Adam([{"params": [rot], "lr": tcfg["lr_rot"]},
                                {"params": [trans], "lr": tcfg["lr_trans"]}],
                               betas=(0.9, 0.999), eps=1e-8)
        dirs, trgb, td = rays[:, :3], rays[:, 3:6], rays[:, 6:7]
        best_loss = math.inf
        best = last = (rot.detach().clone(), trans.detach().clone())
        stall, done = 0, False
        losses = []
        for _ in range(int(tcfg["iter"])):
            t, u = model.draws(gen, rays.shape[0])
            c2w = se3(rot, trans)[0]
            rays_d = dirs @ c2w[:3, :3].T
            loss = model.loss(params, c2w[:3, 3].expand_as(rays_d), rays_d,
                              trgb, td, t, robust, u)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            lv = float(loss.detach())
            state = (rot.detach().clone(), trans.detach().clone())
            if not done:
                if lv < best_loss:
                    best_loss, best, stall = lv, state, 0
                else:
                    stall += 1
                last = state
            if not done:
                opt.step()
            done = done or stall > int(tcfg["wait_iters"])
            losses.append(lv)
        chosen = best if tcfg["best"] else last
        return se3(*chosen)[0].detach(), losses


def bundle_adjust(model: Model, params: Dict, opt_state: Dict,
                  kf_rays: torch.Tensor, kf_count: int, kf_poses: torch.Tensor,
                  cur_pose: torch.Tensor, cur_rays: torch.Tensor,
                  gen_state: torch.Tensor):
    """One BA call from the program's state when it began: the map
    ``params`` and its Adam state ``opt_state`` ({"grid": (exp_avg,
    exp_avg_sq, step), "decoder": [(...), ...]} in the program's order:
    sdf_net then color_net), the keyframe reservoir kf_rays [num_kf, R, 7]
    (its first kf_count slots filled), the keyframe poses, the current
    frame's pose and rays [H*W, 7]. Returns (params after, keyframe poses
    after, current pose after, the loss of every iteration, the first
    iteration's gradient norm of every leaf)."""
    mcfg, tr = model.cfg["mapping"], model.cfg["training"]
    dev = model.device
    gen = _generator(gen_state, dev)
    num_kf, R = kf_rays.shape[0], kf_rays.shape[1]
    table, dec, n_sdf, map_opt = _map_optimizer(mcfg, params, opt_state)
    poses0 = torch.cat([kf_poses, cur_pose[None]])
    pose_enable = kf_count >= 2
    with precision(model.low):
        rot = matrix_to_axis_angle(poses0[:, :3, :3]).detach().clone()
        trans = poses0[:, :3, 3].clone()
        if pose_enable:
            rot.requires_grad_(True)
            trans.requires_grad_(True)
            pose_opt = torch.optim.Adam(
                [{"params": [rot], "lr": mcfg["lr_rot"]},
                 {"params": [trans], "lr": mcfg["lr_trans"]}],
                betas=(0.9, 0.999), eps=1e-8)
        frozen = torch.zeros(num_kf + 1, dtype=torch.bool, device=dev)
        frozen[0] = True
        frozen[num_kf] = not mcfg["optim_cur"]
        sample = int(mcfg["sample"])
        quota = min(max(sample // max(kf_count, 1),
                        int(mcfg["min_pixels_cur"])), sample)
        cur_ids = torch.full((quota,), num_kf, dtype=torch.int64, device=dev)
        flat = kf_rays.reshape(-1, 7)
        losses, grad_norms = [], None
        map_opt.zero_grad(set_to_none=True)
        for i in range(int(mcfg["iters"])):
            idx = torch.randint(0, kf_count * R, (sample,), generator=gen,
                                device=gen.device).to(dev)
            kf_ray, kf_ids = flat[idx], idx // R
            cur_idx = torch.randint(0, cur_rays.shape[0], (quota,),
                                    generator=gen, device=dev)
            ray_data = torch.cat([kf_ray, cur_rays[cur_idx]])
            ray_ids = torch.cat([kf_ids, cur_ids])
            smooth_pts = (model.smoothness_points(gen)
                          if float(tr["smooth_weight"]) > 0 else None)
            t, u = model.draws(gen, ray_data.shape[0])
            poses = torch.where(frozen[:, None, None], poses0, se3(rot, trans))
            rows = poses[ray_ids]
            rays_d = (rows[:, :3, :3] @ ray_data[:, :3, None])[..., 0]
            p = {"grid": table, "decoder": {"sdf_net": dec[:n_sdf],
                                            "color_net": dec[n_sdf:]}}
            loss = model.loss(p, rows[:, :3, 3], rays_d, ray_data[:, 3:6],
                              ray_data[:, 6:7], t, None, u)
            if smooth_pts is not None:
                loss = loss + float(tr["smooth_weight"]) * model.smoothness(
                    table, smooth_pts)
            loss.backward()
            if grad_norms is None:
                grad_norms = [float(q.grad.norm()) for q in [table] + dec]
            losses.append(float(loss.detach()))
            if ((i + 1) % int(mcfg["map_accum_step"]) == 0
                    and (i + 1) > int(mcfg["map_wait_step"])):
                map_opt.step()
                map_opt.zero_grad(set_to_none=True)
            if pose_enable and (i + 1) % int(mcfg["pose_accum_step"]) == 0:
                pose_opt.step()
                pose_opt.zero_grad(set_to_none=True)
        with torch.no_grad():
            final = torch.where(frozen[:, None, None], poses0, se3(rot, trans))
    cur_after = final[num_kf] if mcfg["optim_cur"] else cur_pose
    return (_params(table, dec, n_sdf), final[:num_kf], cur_after, losses,
            grad_norms)


def _map_optimizer(mcfg: Dict, params: Dict, opt_state: Optional[Dict]):
    """Trainable copies of the map (table, the MLPs' weights: sdf_net then
    color_net) and the map's Adam over them, with ``opt_state`` (see
    :func:`bundle_adjust`) or fresh."""
    table = params["grid"].detach().clone().requires_grad_(True)
    dec = [w.detach().clone().requires_grad_(True)
           for w in params["decoder"]["sdf_net"]
           + params["decoder"]["color_net"]]
    map_opt = torch.optim.Adam(
        [{"params": [table], "lr": mcfg["lr_embed"], "eps": 1e-15},
         {"params": dec, "lr": mcfg["lr_decoder"], "eps": 1e-8,
          "weight_decay": 1e-6}], betas=(0.9, 0.99))
    if opt_state is not None:
        for p, (m, v, step) in zip([table] + dec, [opt_state["grid"]]
                                   + opt_state["decoder"]):
            map_opt.state[p] = {"step": step.clone(), "exp_avg": m.clone(),
                                "exp_avg_sq": v.clone()}
    return table, dec, len(params["decoder"]["sdf_net"]), map_opt


def _params(table, dec, n_sdf) -> Dict:
    return {"grid": table.detach(),
            "decoder": {"sdf_net": [w.detach() for w in dec[:n_sdf]],
                        "color_net": [w.detach() for w in dec[n_sdf:]]}}


def first_frame(model: Model, params: Dict, c2w: torch.Tensor,
                frame_rays: torch.Tensor, gen_state: torch.Tensor):
    """The first frame's mapping from the map's initial ``params``, a
    fresh map optimizer and the frame's rays [H*W, 7] at its pose:
    mapping.first_iters steps of mapping.sample rays drawn with
    replacement -> (params after, the loss of every iteration)."""
    mcfg = model.cfg["mapping"]
    gen = _generator(gen_state, model.device)
    table, dec, n_sdf, map_opt = _map_optimizer(mcfg, params, None)
    sample = int(mcfg["sample"])
    Rm, tv = c2w[:3, :3], c2w[:3, 3]
    losses = []
    with precision(model.low):
        map_opt.zero_grad(set_to_none=True)
        for _ in range(int(mcfg["first_iters"])):
            idx = torch.randint(0, frame_rays.shape[0], (sample,),
                                generator=gen, device=model.device)
            rays = frame_rays[idx]
            rays_d = rays[:, :3] @ Rm.T
            t, u = model.draws(gen, sample)
            p = {"grid": table, "decoder": {"sdf_net": dec[:n_sdf],
                                            "color_net": dec[n_sdf:]}}
            loss = model.loss(p, tv.expand_as(rays_d), rays_d, rays[:, 3:6],
                              rays[:, 6:7], t, None, u)
            loss.backward()
            map_opt.step()
            map_opt.zero_grad(set_to_none=True)
            losses.append(float(loss.detach()))
    return _params(table, dec, n_sdf), losses


def query(model: Model, params: Dict, x: torch.Tensor) -> torch.Tensor:
    """[rgb logits, sdf] of the map at normalized x [N, 3]."""
    with torch.no_grad(), precision(model.low):
        return model.query(params, x)


def table_grad(model: Model, table: torch.Tensor, x: torch.Tensor,
               g: torch.Tensor) -> torch.Tensor:
    """The table's gradient of sum(g * the hash-grid features at x)."""
    table = table.detach().clone().requires_grad_(True)
    (model.embed(table, x) * g).sum().backward()
    return table.grad
