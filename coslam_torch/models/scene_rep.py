"""Joint scene representation: hash grid or TensoVM + OneBlob -> SDF / color.

Counterpart of coslam_tpu/models/scene_rep.py:JointEncoding for the
HashGrid (or Dense, 4 dense levels, or Tiled) + OneBlob and TensoVM +
OneBlob, ``oneGrid: true`` models; the
hash grid is the packed layout or, with ``grid.grad_impl`` pallas,
scatter or onehot, the XOR hash (ops/hash_pallas.py). As in
the JAX package the class holds only static configuration; the learnable
state is an explicit parameter dict ``{"grid": ..., "decoder":
{"sdf_net": [...], "color_net": [...]}}`` of tensors, where the grid is
the hash table [T, F] or TensoVM's ``{"planes", "lines"}``, and every
method is a function of (params, inputs). Random draws come in as
arguments (the stratified perturbation ``t``, the smoothness sample) or
from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..ops import encodings as enc
from ..ops import losses as L
from ..ops import render as R
from ..ops import tensovm as VM
from .decoder import ColorSDFDecoder


def is_tensovm(config: Dict) -> bool:
    """Whether the grid is TensoVM (its smoothness term is the analytic
    TV over lattice axes, which encodes no points)."""
    return "vm" in str(config["grid"]["enc"]).lower()


def check_supported(config: Dict) -> None:
    """Raise for the configuration options the port does not run yet."""
    enc_name = str(config["grid"]["enc"]).lower()
    # Every name enc.make_encoder routes to a hash grid (Dense: 4 dense
    # levels), in the packed or the XOR layout.
    is_grid = any(k in enc_name for k in ("dense", "hash", "tiled"))
    unsupported = {
        "grid.enc other than HashGrid, Dense, Tiled or TensoVM":
            not (is_grid or is_tensovm(config)),
        "grid.grad_impl other than auto, packed, pallas, scatter or onehot":
            is_grid and config["grid"].get("grad_impl", "auto") not in (
                "auto", "packed", *enc.XOR_GRAD_IMPLS),
        "grid.oneGrid: false": not config["grid"]["oneGrid"],
        "pos.enc other than OneBlob":
            "blob" not in str(config["pos"]["enc"]).lower(),
        "training.n_importance > 0": config["training"]["n_importance"] > 0,
        "training.frame_align": bool(config["training"].get("frame_align")),
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
        dim_max = float((bb[:, 1] - bb[:, 0]).max())
        vs = config["grid"]["voxel_sdf"]
        self.resolution_sdf = int(vs) if vs > 10 else int(dim_max / vs)

        (self._pos_init, self._pos_apply, self.input_ch_pos, _
         ) = enc.make_encoder(config["pos"]["enc"],
                              n_bins=config["pos"]["n_bins"])
        vm = is_tensovm(config)
        grid_kw = {}
        if vm:
            # Pyramid depth and features per level (no reference
            # counterpart; the JAX package's defaults).
            grid_kw = dict(
                n_levels=int(config["grid"].get("triplane_levels", 4)),
                level_dim=int(config["grid"].get("triplane_features", 2)))
        (self._grid_init, self._grid_apply, self.input_ch, self.grid_spec
         ) = enc.make_encoder(config["grid"]["enc"],
                              log2_hashmap_size=config["grid"]["hash_size"],
                              desired_resolution=self.resolution_sdf,
                              grad_impl=config["grid"].get("grad_impl",
                                                           "auto"),
                              **grid_kw)
        self._grid_tv = (VM.make_tensovm_lattice_tv(self.grid_spec) if vm
                         else None)
        self.decoder = ColorSDFDecoder(config, self.input_ch,
                                       self.input_ch_pos)

    def init_params(self, generator: torch.Generator) -> Dict:
        """Fresh parameters on the model's device, drawn from generator."""
        return {"grid": self._grid_init(generator, self.device),
                "decoder": self.decoder.init(generator, self.device)}

    @property
    def n_z_samples(self) -> int:
        """Samples per ray with depth guidance (the shape of ``t``)."""
        tr = self.config["training"]
        return tr["n_samples_d"] + tr["n_range_d"]

    # -- coordinate helpers --------------------------------------------------

    def normalize_coords(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi = self.bounding_box[:, 0], self.bounding_box[:, 1]
        return (x - lo) / (hi - lo)

    # -- queries (x normalized to [0, 1]) -----------------------------------

    def query_color_sdf(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        """[N, 3] -> raw [N, 4] = [rgb logits, sdf]."""
        embed = self._grid_apply(params["grid"], x)
        return self.decoder(params["decoder"], embed, self._pos_apply(None, x))

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

    def render_rays(self, params: Dict, rays_o: torch.Tensor,
                    rays_d: torch.Tensor,
                    target_d: Optional[torch.Tensor] = None,
                    t: Optional[torch.Tensor] = None) -> Dict:
        """Volume render rays [N, 3]; t is the stratified perturbation
        draw [N, n_z_samples] (None: unperturbed)."""
        tr = self.config["training"]
        cam = self.config["cam"]
        z_vals = R.stratified_z_vals(
            rays_o.shape[0], target_d, cam["near"], cam["far"],
            tr["range_d"], tr["n_range_d"],
            tr["n_samples_d"] if target_d is not None
            else tr.get("n_samples", tr["n_samples_d"]),
            t=t, device=rays_o.device)
        pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
        raw = self.run_network(params, pts)
        rgb_map, disp_map, acc_map, _, depth_map, depth_var = R.raw2outputs(
            raw, z_vals, tr["trunc"], self.config["data"]["sc_factor"],
            tr["white_bkgd"])
        return {"rgb": rgb_map, "depth": depth_map, "disp_map": disp_map,
                "acc_map": acc_map, "depth_var": depth_var, "z_vals": z_vals,
                "raw": raw}

    def forward(self, params: Dict, rays_o: torch.Tensor,
                rays_d: torch.Tensor, target_rgb: torch.Tensor,
                target_d: torch.Tensor,
                ray_mask: Optional[torch.Tensor] = None,
                t: Optional[torch.Tensor] = None,
                rgb_kernel: Optional[float] = None) -> Dict:
        """Render + per-term losses. ray_mask: optional [N] validity mask;
        rgb_kernel: optional Huber delta of the photometric residual."""
        tr = self.config["training"]
        rend = self.render_rays(params, rays_o, rays_d, target_d=target_d,
                                t=t)
        td = target_d[..., 0]
        valid_depth = ((td > 0.0) & (td < self.config["cam"]["depth_trunc"])
                       ).to(td.dtype)
        rm = (ray_mask.to(td.dtype) if ray_mask is not None
              else torch.ones_like(valid_depth))

        # rgb_missing down-weights the color of invalid-depth pixels by
        # scaling prediction and target inside the loss.
        rgb_w = torch.where(valid_depth > 0, 1.0, tr["rgb_missing"])[:, None]
        pred, target = rend["rgb"] * rgb_w, target_rgb * rgb_w
        if rgb_kernel is None:
            rgb_loss = L.compute_loss(pred, target, mask=rm[:, None])
        else:
            rgb_loss = L.huber_loss(pred, target, float(rgb_kernel),
                                    mask=rm[:, None])
        depth_loss = L.compute_loss(rend["depth"], td, mask=valid_depth * rm)
        truncation = tr["trunc"] * self.config["data"]["sc_factor"]
        fs_loss, sdf_loss = L.get_sdf_loss(
            rend["z_vals"], target_d, rend["raw"][..., -1], truncation, "l2",
            ray_mask=rm)
        return {"rgb": rend["rgb"], "depth": rend["depth"],
                "rgb_loss": rgb_loss, "depth_loss": depth_loss,
                "sdf_loss": sdf_loss, "fs_loss": fs_loss,
                "psnr": L.mse2psnr(rgb_loss)}

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
        """What :meth:`smoothness` takes: the lattice's axes for TensoVM,
        its points otherwise."""
        draw = (self.smoothness_axes if self._grid_tv is not None
                else self.smoothness_points)
        return draw(generator, sample_points, voxel_size, margin)

    def smoothness(self, params: Dict, sample: torch.Tensor,
                   sample_points: int) -> torch.Tensor:
        """TV of the grid features on the lattice. TensoVM: ``sample`` is
        the axes [3, g] and the TV is the analytic separable sum (no point
        is encoded). Hash grid: ``sample`` is the points [g^3, 3], encoded
        as constants (the encode backward computes no dx), in the packed
        and the XOR layout alike."""
        if self._grid_tv is not None:
            return self._grid_tv(params["grid"], sample, sample_points)
        g = sample_points - 1
        emb = self.query_sdf(params, sample.reshape(g, g, g, 3), embed=True)
        return L.smoothness_tv(emb, sample_points)
