"""Joint scene representation: a parametric grid + a coordinate encoding
-> SDF / color.

Counterpart of coslam_tpu/models/scene_rep.py:JointEncoding for every
grid the JAX model accepts: the hash grid (HashGrid, Dense: 4 dense
levels, or Tiled; the packed layout or, with ``grid.grad_impl`` pallas,
scatter or onehot, the XOR hash of ops/hash_pallas.py), TensoVM,
TriPlaneHybrid and TriPlane, with any coordinate encoding (OneBlob,
Frequency, SphericalHarmonics, Identity), and with ``grid.oneGrid:
false``, a second grid of the same kind at ``grid.voxel_color`` for the
color. As in the JAX package the class holds only static configuration;
the learnable state is an explicit parameter dict ``{"grid": ...,
"decoder": {"sdf_net": [...], "color_net": [...]}[, "grid_color": ...]}``
of tensors, where a grid is a table [T, F] or a dict of tables
(TensoVM's ``{"planes", "lines"}``, TriPlaneHybrid's ``{"dense",
"planes"}``), and every method is a function of (params, inputs). Random
draws come in as arguments (the stratified perturbation ``t``, the
importance draw ``u`` of the fine pass, the smoothness sample) or from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..ops import encodings as enc
from ..ops import hash_packed as HP
from ..ops import losses as L
from ..ops import render as R
from ..ops import tensovm as VM
from ..ops import triplane as TP
from ..runtime.spans import in_forward
from .decoder import ColorSDFDecoder


def is_factorized(config: Dict) -> bool:
    """Whether the grid is TensoVM, TriPlaneHybrid or TriPlane: its
    smoothness term reads the lattice's axes, not its points, and its
    pyramid takes grid.triplane_levels and grid.triplane_features."""
    name = str(config["grid"]["enc"]).lower()
    return "vm" in name or "plane" in name


def check_supported(config: Dict) -> None:
    """Raise for the configuration options the port does not run yet."""
    enc_name = str(config["grid"]["enc"]).lower()
    # Every name enc.make_encoder routes to a hash grid (Dense: 4 dense
    # levels), in the packed or the XOR layout.
    is_grid = any(k in enc_name for k in ("dense", "hash", "tiled"))
    unsupported = {
        "grid.grad_impl other than auto, packed, pallas, scatter or onehot":
            is_grid and config["grid"].get("grad_impl", "auto") not in (
                "auto", "packed", *enc.XOR_GRAD_IMPLS),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"not ported yet: {', '.join(bad)}")


class JointEncoding:
    def __init__(self, config: Dict, bound_box, device="cpu"):
        """config: full Co-SLAM config; bound_box: [3, 2] metric bounds."""
        check_supported(config)
        self.config = config
        self.device = torch.device(device)
        bb = np.asarray(bound_box, dtype=np.float32)
        self.bounding_box = torch.from_numpy(bb).to(self.device)
        self._bounds_np, self._bounds = bb, {}
        dim_max = float((bb[:, 1] - bb[:, 0]).max())
        vs = config["grid"]["voxel_sdf"]
        self.resolution_sdf = int(vs) if vs > 10 else int(dim_max / vs)
        vc = config["grid"]["voxel_color"]
        self.resolution_color = int(vc) if vc > 10 else int(dim_max / vc)

        (self._pos_init, self._pos_apply, self.input_ch_pos, _
         ) = enc.make_encoder(config["pos"]["enc"],
                              n_bins=config["pos"]["n_bins"])
        grid_kw = {}
        if is_factorized(config):
            # Pyramid depth and features per level (no reference
            # counterpart; the JAX package's defaults).
            grid_kw = dict(
                n_levels=int(config["grid"].get("triplane_levels", 4)),
                level_dim=int(config["grid"].get("triplane_features", 2)))
        grad_impl = config["grid"].get("grad_impl", "auto")
        (self._grid_init, self._grid_apply, self.input_ch, self.grid_spec
         ) = enc.make_encoder(config["grid"]["enc"],
                              log2_hashmap_size=config["grid"]["hash_size"],
                              desired_resolution=self.resolution_sdf,
                              grad_impl=grad_impl, **grid_kw)
        self._grid_tv = self._make_lattice_tv(config)
        self.one_grid = bool(config["grid"]["oneGrid"])
        self.input_ch_color = 0
        if not self.one_grid:
            # The color grid: the same encoding at grid.voxel_color, with
            # the encoder's default pyramid (as the JAX model builds it).
            (self._cgrid_init, self._cgrid_apply, self.input_ch_color,
             self.color_grid_spec) = enc.make_encoder(
                config["grid"]["enc"],
                log2_hashmap_size=config["grid"]["hash_size"],
                desired_resolution=self.resolution_color,
                grad_impl=grad_impl)
        self._build_decoder(config)

    def _build_decoder(self, config: Dict) -> None:
        """Hook for variants (ActiveJointEncoding builds the beta-head
        decoder, coslam_torch/active/scene_rep.py)."""
        self.decoder = ColorSDFDecoder(config, self.input_ch,
                                       self.input_ch_pos, self.input_ch_color,
                                       self.one_grid)

    def _make_lattice_tv(self, config: Dict):
        """The smoothness term of a factorized grid as fn(grid params,
        axes [3, g], sample_points) -> scalar, or None for the hash grids
        (whose lattice points are encoded). TensoVM and TriPlane: the
        analytic separable TV (TriPlane's with unit lines); TriPlaneHybrid:
        smoothness_tv of its lattice's feature volume, the dense part
        encoded at the lattice's points through kernels A and B (constant
        points: the backward computes no dx), the planes by
        triplane_lattice_encode (coslam_tpu's JointEncoding
        ._make_lattice_fn)."""
        name = str(config["grid"]["enc"]).lower()
        if "vm" in name:
            return VM.make_tensovm_lattice_tv(self.grid_spec)
        if "hybrid" in name:
            dspec, pspec = self.grid_spec

            def hybrid_tv(p, axes, sample_points):
                g = axes.shape[1]
                pts = torch.stack(torch.meshgrid(*axes, indexing="ij"),
                                  -1).reshape(-1, 3)
                dense = HP.encode(dspec, p["dense"], pts).reshape(g, g, g, -1)
                planes = TP.triplane_lattice_encode(pspec, p["planes"], axes)
                return L.smoothness_tv(torch.cat([dense, planes], -1),
                                       sample_points)

            return hybrid_tv
        if "plane" in name:
            return VM.make_triplane_lattice_tv(self.grid_spec)
        return None

    def init_params(self, generator: torch.Generator) -> Dict:
        """Fresh parameters on the model's device, drawn from generator
        (the grid, the decoder, then the color grid)."""
        params = {"grid": self._grid_init(generator, self.device),
                  "decoder": self.decoder.init(generator, self.device)}
        if not self.one_grid:
            params["grid_color"] = self._cgrid_init(generator, self.device)
        return params

    @property
    def n_z_samples(self) -> int:
        """Samples per ray with depth guidance (the shape of ``t``)."""
        tr = self.config["training"]
        return tr["n_samples_d"] + tr["n_range_d"]

    @property
    def n_importance(self) -> int:
        """Importance samples per ray of the fine pass (the shape of
        ``u``; 0: no fine pass)."""
        return int(self.config["training"]["n_importance"])

    def ray_draws(self, generator: Optional[torch.Generator], n_rays: int,
                  device) -> tuple:
        """A batch's random draws from generator, in a fixed order: the
        stratified perturbation t [n_rays, n_z_samples], then the fine
        pass's importance draw u [n_rays, n_importance] (None without a
        fine pass). (None, None) when training.perturb is 0: unperturbed
        strata and the deterministic importance samples."""
        if self.config["training"]["perturb"] <= 0:
            return None, None
        t = torch.rand((n_rays, self.n_z_samples), generator=generator,
                       device=device)
        u = (torch.rand((n_rays, self.n_importance), generator=generator,
                        device=device) if self.n_importance > 0 else None)
        return t, u

    # -- coordinate helpers --------------------------------------------------

    def bounds_on(self, device) -> torch.Tensor:
        """The bounding box [3, 2] on ``device`` (a ray shard's or the
        pipelined tracker's card; uploaded from host memory once a device,
        so any thread's stream may read it)."""
        device = torch.device(device)
        if device == self.bounding_box.device:
            return self.bounding_box
        bb = self._bounds.get(device)
        if bb is None:
            bb = self._bounds[device] = torch.from_numpy(
                self._bounds_np).to(device)
        return bb

    def normalize_coords(self, x: torch.Tensor) -> torch.Tensor:
        bb = self.bounds_on(x.device)
        lo, hi = bb[:, 0], bb[:, 1]
        return (x - lo) / (hi - lo)

    # -- queries (x normalized to [0, 1]) -----------------------------------

    def query_color_sdf(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        """[N, 3] -> raw [N, 4] = [rgb logits, sdf]."""
        embed = self._grid_apply(params["grid"], x)
        embed_color = (None if self.one_grid
                       else self._cgrid_apply(params["grid_color"], x))
        return self.decoder(params["decoder"], embed, self._pos_apply(None, x),
                            embed_color)

    def query_sdf(self, params: Dict, x: torch.Tensor, embed: bool = False):
        """SDF (or, with embed=True, the grid embedding) at x [..., 3]."""
        flat = x.reshape(-1, 3)
        embedded = self._grid_apply(params["grid"], flat)
        if embed:
            return embedded.reshape(x.shape[:-1] + (embedded.shape[-1],))
        out = self.decoder.sdf_net(
            params["decoder"],
            torch.cat([embedded, self._pos_apply(None, flat)], -1))
        return out[..., 0].reshape(x.shape[:-1])

    def query_color(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        flat = x.reshape(-1, 3)
        rgb = torch.sigmoid(self.query_color_sdf(params, flat)[..., :3])
        return rgb.reshape(x.shape[:-1] + (3,))

    def run_network(self, params: Dict, pts: torch.Tensor) -> torch.Tensor:
        """Metric points [N_rays, N_samples, 3] -> raw [..., 4]."""
        raw = self.query_color_sdf(params,
                                   self.normalize_coords(pts.reshape(-1, 3)))
        return raw.reshape(pts.shape[:-1] + (raw.shape[-1],))

    # -- rendering ------------------------------------------------------------

    def render_surface_color(self, params: Dict, rays_o: torch.Tensor,
                             normal: torch.Tensor) -> torch.Tensor:
        """Color rendered along vertex normals (mesh.render_color): rays
        from rays_o [N, 3] along normal [N, 3] through n_range_d samples
        evenly in [-trunc, trunc] (coslam_tpu's
        JointEncoding.render_surface_color) -> rgb [N, 3]."""
        tr = self.config["training"]
        z_vals = R.linspace(-tr["trunc"], tr["trunc"], tr["n_range_d"],
                            rays_o.device)
        z_vals = z_vals.expand(rays_o.shape[0], -1)
        pts = rays_o[..., None, :] + normal[..., None, :] * z_vals[..., None]
        raw = self.run_network(params, pts)
        return R.raw2outputs(raw, z_vals, tr["trunc"],
                             self.config["data"]["sc_factor"],
                             tr["white_bkgd"])[0]

    def render_rays(self, params: Dict, rays_o: torch.Tensor,
                    rays_d: torch.Tensor,
                    target_d: Optional[torch.Tensor] = None,
                    t: Optional[torch.Tensor] = None,
                    u: Optional[torch.Tensor] = None) -> Dict:
        """Volume render rays [N, 3]; t is the stratified perturbation
        draw [N, n_z_samples] (None: unperturbed), u the importance draw
        [N, n_importance] of the fine pass (None: the deterministic
        stratum centres). With ``training.n_importance`` > 0 the fine pass
        (coslam_tpu's render_rays) reuses the coarse ``raw``, queries
        only the n_importance new points and merges z and raw by one
        stable argsort; the coarse maps come back as ``rgb0``,
        ``depth0``, ... beside ``z_std``."""
        tr = self.config["training"]
        z_vals = self._coarse_z(rays_o, target_d, t)
        pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
        raw = self.run_network(params, pts)
        trunc, sc = tr["trunc"], self.config["data"]["sc_factor"]
        rgb_map, disp_map, acc_map, weights, depth_map, depth_var = \
            R.raw2outputs(raw, z_vals, trunc, sc, tr["white_bkgd"])
        ret = {}
        if self.n_importance > 0:
            ret.update(rgb0=rgb_map, disp0=disp_map, acc0=acc_map,
                       depth0=depth_map, depth_var0=depth_var)
            z_vals, raw, ret["z_std"] = self._fine_pass(
                params, rays_o, rays_d, z_vals, raw, weights, u)
            rgb_map, disp_map, acc_map, _, depth_map, depth_var = \
                R.raw2outputs(raw, z_vals, trunc, sc, tr["white_bkgd"])
        ret.update(rgb=rgb_map, depth=depth_map, disp_map=disp_map,
                   acc_map=acc_map, depth_var=depth_var, z_vals=z_vals,
                   raw=raw)
        return ret

    def _coarse_z(self, rays_o: torch.Tensor,
                  target_d: Optional[torch.Tensor],
                  t: Optional[torch.Tensor]) -> torch.Tensor:
        """The coarse pass's sample depths [N, n_z_samples] (perturbed
        inside their strata by ``t``)."""
        tr = self.config["training"]
        cam = self.config["cam"]
        return R.stratified_z_vals(
            rays_o.shape[0], target_d, cam["near"], cam["far"],
            tr["range_d"], tr["n_range_d"],
            tr["n_samples_d"] if target_d is not None
            else tr.get("n_samples", tr["n_samples_d"]),
            t=t, device=rays_o.device)

    def _fine_pass(self, params: Dict, rays_o: torch.Tensor,
                   rays_d: torch.Tensor, z_vals: torch.Tensor,
                   raw: torch.Tensor, weights: torch.Tensor,
                   u: Optional[torch.Tensor]):
        """The importance fine pass: n_importance samples drawn from the
        coarse weights (``u``, or the deterministic strata), the network
        queried at those only, and z and raw merged with the coarse pass's
        by one stable argsort -> (z_vals, raw, z_std). Inside a step's
        forward it is that step's span ``<step>.fine``."""
        with in_forward("fine"):
            if u is None:
                u = R.importance_u(rays_o.shape[0], self.n_importance,
                                   rays_o.device)
            z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
            z_samples = R.sample_pdf(z_mid, weights[..., 1:-1], u).detach()
            z_std = z_samples.std(-1, correction=0)
            pts_new = (rays_o[..., None, :]
                       + rays_d[..., None, :] * z_samples[..., :, None])
            raw_new = self.run_network(params, pts_new)
            z_cat = torch.cat([z_vals, z_samples], -1)
            raw_cat = torch.cat([raw, raw_new], -2)
            # Stable, as jnp.argsort: a new sample equal to a coarse z
            # keeps the coarse one first, and raw follows the same order.
            order = torch.argsort(z_cat, dim=-1, stable=True)
            z_vals = torch.gather(z_cat, -1, order)
            raw = torch.gather(
                raw_cat, -2,
                order[..., None].expand(-1, -1, raw_cat.shape[-1]))
        return z_vals, raw, z_std

    def forward(self, params: Dict, rays_o: torch.Tensor,
                rays_d: torch.Tensor, target_rgb: torch.Tensor,
                target_d: torch.Tensor,
                ray_mask: Optional[torch.Tensor] = None,
                t: Optional[torch.Tensor] = None,
                rgb_kernel: Optional[float] = None,
                u: Optional[torch.Tensor] = None,
                align: Optional[torch.Tensor] = None) -> Dict:
        """Render + per-term losses. ray_mask: optional [N] validity mask;
        rgb_kernel: optional Huber delta of the photometric residual;
        align: optional exposure parameters [N, 4] or [4] (3 gains and an
        offset, ops/frame_align.py) mapping the rendered RGB to the
        frame's exposure before the photometric loss. With a fine pass the
        coarse rgb and depth add their terms to rgb_loss and depth_loss."""
        maps, stats = self.loss_stats(params, rays_o, rays_d, target_rgb,
                                      target_d, ray_mask, t, rgb_kernel, u,
                                      align)
        return {**maps, **self.losses_from_stats(stats)}

    def loss_stats(self, params: Dict, rays_o: torch.Tensor,
                   rays_d: torch.Tensor, target_rgb: torch.Tensor,
                   target_d: torch.Tensor,
                   ray_mask: Optional[torch.Tensor] = None,
                   t: Optional[torch.Tensor] = None,
                   rgb_kernel: Optional[float] = None,
                   u: Optional[torch.Tensor] = None,
                   align: Optional[torch.Tensor] = None):
        """:meth:`forward`'s render and its loss terms as sums and counts
        over the rays -> (maps {rgb, depth}, stats). The stats of several
        ray shards add up to the whole batch's, and
        :meth:`losses_from_stats` turns them into the losses."""
        tr = self.config["training"]
        rend = self.render_rays(params, rays_o, rays_d, target_d=target_d,
                                t=t, u=u)
        td = target_d[..., 0]
        valid_depth = ((td > 0.0) & (td < self.config["cam"]["depth_trunc"])
                       ).to(td.dtype)
        rm = (ray_mask.to(td.dtype) if ray_mask is not None
              else torch.ones_like(valid_depth))

        def expose(rgb):
            if align is None:
                return rgb
            return rgb * align[..., :3] + align[..., 3:4]

        def rgb_term(pred):
            if rgb_kernel is None:
                err = (pred * rgb_w - target) ** 2
            else:
                err = L.huber(pred * rgb_w, target, float(rgb_kernel))
            return L.masked_sum(err, rm[:, None])

        # rgb_missing down-weights the color of invalid-depth pixels by
        # scaling prediction and target inside the loss.
        rgb_w = torch.where(valid_depth > 0, 1.0, tr["rgb_missing"])[:, None]
        target = target_rgb * rgb_w
        depth_mask = valid_depth * rm
        stats = {}
        stats["rgb_sum"], stats["rgb_n"] = rgb_term(expose(rend["rgb"]))
        stats["depth_sum"], stats["depth_n"] = L.masked_sum(
            (rend["depth"] - td) ** 2, depth_mask)
        if "rgb0" in rend:
            stats["rgb0_sum"] = rgb_term(expose(rend["rgb0"]))[0]
            stats["depth0_sum"] = L.masked_sum((rend["depth0"] - td) ** 2,
                                               depth_mask)[0]
        truncation = tr["trunc"] * self.config["data"]["sc_factor"]
        stats.update(L.sdf_loss_stats(rend["z_vals"], target_d,
                                      rend["raw"][..., -1], truncation, rm))
        return {"rgb": rend["rgb"], "depth": rend["depth"]}, stats

    def losses_from_stats(self, stats: Dict) -> Dict:
        """The loss terms and the PSNR of :meth:`loss_stats`' sums and
        counts (one shard's, or several shards' added)."""
        rgb_n = stats["rgb_n"].clamp_min(1.0)
        depth_n = stats["depth_n"].clamp_min(1.0)
        rgb_loss = stats["rgb_sum"] / rgb_n
        psnr = L.mse2psnr(rgb_loss)
        depth_loss = stats["depth_sum"] / depth_n
        if "rgb0_sum" in stats:
            rgb_loss = rgb_loss + stats["rgb0_sum"] / rgb_n
            depth_loss = depth_loss + stats["depth0_sum"] / depth_n
        fs_loss, sdf_loss = L.sdf_losses(stats)
        return {"rgb_loss": rgb_loss, "depth_loss": depth_loss,
                "sdf_loss": sdf_loss, "fs_loss": fs_loss, "psnr": psnr}

    # -- smoothness regularizer ----------------------------------------------

    def _smoothness_draw(self, generator: torch.Generator,
                         sample_points: int, voxel_size: float,
                         margin: float):
        """The lattice's six uniform draws: (offset [3] inside the bounds,
        sub-voxel jitter [3] shared by all points)."""
        lo, hi = self.bounding_box[:, 0], self.bounding_box[:, 1]
        offset_max = hi - lo - (sample_points - 1) * voxel_size - 2 * margin
        u = torch.rand(6, generator=generator, device=generator.device
                       ).to(self.device)
        return u[:3] * offset_max + margin, u[3:]

    def smoothness_points(self, generator: torch.Generator,
                          sample_points: int = 256, voxel_size: float = 0.1,
                          margin: float = 0.05) -> torch.Tensor:
        """Jittered lattice of (sample_points - 1)^3 points, normalized,
        flat [g^3, 3]: a random offset inside the bounds and one random
        sub-voxel jitter shared by all points."""
        lo, hi = self.bounding_box[:, 0], self.bounding_box[:, 1]
        offset, jitter = self._smoothness_draw(generator, sample_points,
                                               voxel_size, margin)
        g = sample_points - 1
        ax = torch.arange(g, dtype=torch.float32, device=self.device)
        coords = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1)
        pts = (coords + jitter) * voxel_size + lo + offset
        return ((pts - lo) / (hi - lo)).reshape(-1, 3)

    def smoothness_axes(self, generator: torch.Generator,
                        sample_points: int = 256, voxel_size: float = 0.1,
                        margin: float = 0.05) -> torch.Tensor:
        """Per-axis normalized coordinates [3, g] of the lattice
        smoothness_points builds from the same draws."""
        lo, hi = self.bounding_box[:, 0], self.bounding_box[:, 1]
        offset, jitter = self._smoothness_draw(generator, sample_points,
                                               voxel_size, margin)
        ax = torch.arange(sample_points - 1, dtype=torch.float32,
                          device=self.device)
        pts = (ax[None, :] + jitter[:, None]) * voxel_size + offset[:, None]
        return pts / (hi - lo)[:, None]

    def smoothness_sample(self, generator: torch.Generator,
                          sample_points: int, voxel_size: float,
                          margin: float) -> torch.Tensor:
        """What :meth:`smoothness` takes: the lattice's axes for the
        factorized grids (TensoVM, TriPlaneHybrid, TriPlane), its points
        for the hash grids."""
        draw = (self.smoothness_axes if self._grid_tv is not None
                else self.smoothness_points)
        return draw(generator, sample_points, voxel_size, margin)

    def smoothness(self, params: Dict, sample: torch.Tensor,
                   sample_points: int) -> torch.Tensor:
        """TV of the grid features on the lattice. Factorized grids:
        ``sample`` is the axes [3, g]; TensoVM and TriPlane take the
        analytic separable sum (no point is encoded), TriPlaneHybrid its
        lattice's features (:meth:`_make_lattice_tv`). Hash grid:
        ``sample`` is the points [g^3, 3], encoded as constants (the
        encode backward computes no dx), in the packed and the XOR layout
        alike."""
        if self._grid_tv is not None:
            return self._grid_tv(params["grid"], sample, sample_points)
        g = sample_points - 1
        emb = self.query_sdf(params, sample.reshape(g, g, g, 3), embed=True)
        return L.smoothness_tv(emb, sample_points)
