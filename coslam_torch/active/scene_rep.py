"""Scene representation with an uncertainty (beta) output channel.

Counterpart of coslam_tpu/active/scene_rep.py (the reference's
ActiveCoSLAM/ac_scene_rep.py): the decoder is ColorSDFNetV3, so raw is
[rgb logits, sdf, beta]; rendering also returns ``uncert_map`` = sum_i
w_i^2 beta_i and the weights, and the RGB loss is the heteroscedastic
NLL mean((x - y)^2 / (2 beta)) + 0.5 mean(log beta) + 4.0 (with
``active.detach_nll``: the plain MSE plus that NLL on a detached
residual and detached weights, so it trains the beta head only).

Random draws come in as arguments, as in the base model: the stratified
perturbation ``t`` and the fine pass's importance draw ``u``. The fine
pass queries only its new points and merges them with the coarse pass's
raw (JointEncoding._fine_pass), where the JAX variant queries the merged
set again: the same function at the same points.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..models.scene_rep import JointEncoding
from ..ops import losses as L
from ..ops import render as R
from .decoder import ColorSDFNetV3, linear


class ActiveJointEncoding(JointEncoding):
    def _build_decoder(self, config: Dict) -> None:
        self.decoder = ColorSDFNetV3(config, self.input_ch, self.input_ch_pos)

    def query_sdf(self, params: Dict, x: torch.Tensor, embed: bool = False):
        """SDF (through sdf_linear: the backbone's output is a feature
        vector) or, with embed=True, the grid embedding, at x [..., 3]."""
        flat = x.reshape(-1, 3)
        embedded = self._grid_apply(params["grid"], flat)
        if embed:
            return embedded.reshape(x.shape[:-1] + (embedded.shape[-1],))
        h = self.decoder.sdf_net(
            params["decoder"],
            torch.cat([embedded, self._pos_apply(None, flat)], -1))
        return linear(params["decoder"]["sdf_linear"], h)[..., 0].reshape(
            x.shape[:-1])

    def _maps(self, raw: torch.Tensor, z_vals: torch.Tensor) -> Dict:
        tr = self.config["training"]
        rgb, disp, acc, weights, depth, depth_var = R.raw2outputs(
            raw[..., :4], z_vals, tr["trunc"],
            self.config["data"]["sc_factor"], tr["white_bkgd"])
        uncert_map = (weights * weights * raw[..., 4]).sum(-1)
        return dict(rgb=rgb, disp_map=disp, acc_map=acc, weights=weights,
                    depth=depth, depth_var=depth_var, uncert_map=uncert_map)

    def render_rays(self, params: Dict, rays_o: torch.Tensor,
                    rays_d: torch.Tensor,
                    target_d: Optional[torch.Tensor] = None,
                    t: Optional[torch.Tensor] = None,
                    u: Optional[torch.Tensor] = None) -> Dict:
        """The base render plus ``uncert_map`` and ``weights`` of the
        coarse pass and, with training.n_importance > 0, of the fine pass
        (the coarse ones as ``uncert_map0`` and ``weights0``)."""
        z_vals = self._coarse_z(rays_o, target_d, t)
        pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
        raw = self.run_network(params, pts)
        maps = self._maps(raw, z_vals)
        ret = {}
        if self.n_importance > 0:
            ret.update(rgb0=maps["rgb"], disp0=maps["disp_map"],
                       acc0=maps["acc_map"], depth0=maps["depth"],
                       depth_var0=maps["depth_var"],
                       uncert_map0=maps["uncert_map"],
                       weights0=maps["weights"])
            z_vals, raw, ret["z_std"] = self._fine_pass(
                params, rays_o, rays_d, z_vals, raw, maps["weights"], u)
            maps = self._maps(raw, z_vals)
        ret.update(maps, sdf=raw[..., 3], z_vals=z_vals, raw=raw)
        return ret

    def loss_stats(self, params: Dict, rays_o: torch.Tensor,
                   rays_d: torch.Tensor, target_rgb: torch.Tensor,
                   target_d: torch.Tensor,
                   ray_mask: Optional[torch.Tensor] = None,
                   t: Optional[torch.Tensor] = None,
                   rgb_kernel: Optional[float] = None,
                   u: Optional[torch.Tensor] = None,
                   align: Optional[torch.Tensor] = None):
        """Render + the loss terms as sums and counts (the base model's
        :meth:`JointEncoding.loss_stats`). ``align`` maps the rendered rgb
        to the frame's exposure before the NLL; ``rgb_kernel`` is accepted
        and not used (beta already weights the residuals), as in the JAX
        variant."""
        tr = self.config["training"]
        rend = self.render_rays(params, rays_o, rays_d, target_d, t=t, u=u)
        rgb = rend["rgb"]
        if align is not None:
            rgb = rgb * align[..., :3] + align[..., 3:4]

        td = target_d[..., 0]
        valid_depth = ((td > 0.0) & (td < self.config["cam"]["depth_trunc"])
                       ).to(td.dtype)
        rm = (ray_mask.to(td.dtype) if ray_mask is not None
              else torch.ones_like(valid_depth))
        rgb_w = torch.where(valid_depth > 0, 1.0, tr["rgb_missing"])[:, None]

        uncert = rend["uncert_map"] + 1e-9
        sq = (rgb * rgb_w - target_rgb * rgb_w) ** 2
        stats = {}
        stats["sq_sum"], stats["rgb_n"] = L.masked_sum(sq, rm[:, None])
        if self.config.get("active", {}).get("detach_nll", False):
            # The plain MSE drives color, geometry and pose; the NLL on a
            # detached residual and detached weights trains the beta head
            # only.
            w_sg = rend["weights"].detach()
            unc_sg = (w_sg * w_sg * rend["raw"][..., -1]).sum(-1) + 1e-9
            stats["nll_sum"] = L.masked_sum(
                sq.detach() / (2.0 * unc_sg[:, None]), rm[:, None])[0]
            stats["log_sum"], stats["ray_n"] = L.masked_sum(
                torch.log(unc_sg), rm)
        else:
            stats["nll_sum"] = L.masked_sum(sq / (2.0 * uncert[:, None]),
                                            rm[:, None])[0]
            stats["log_sum"], stats["ray_n"] = L.masked_sum(
                torch.log(uncert), rm)
        depth_mask = valid_depth * rm
        stats["depth_sum"], stats["depth_n"] = L.masked_sum(
            (rend["depth"] - td) ** 2, depth_mask)
        if "rgb0" in rend:
            stats["rgb0_sum"] = L.masked_sum(
                (rend["rgb0"] * rgb_w - target_rgb * rgb_w) ** 2,
                rm[:, None])[0]
            stats["depth0_sum"] = L.masked_sum((rend["depth0"] - td) ** 2,
                                               depth_mask)[0]
        truncation = tr["trunc"] * self.config["data"]["sc_factor"]
        stats.update(L.sdf_loss_stats(rend["z_vals"], target_d, rend["sdf"],
                                      truncation, rm))
        maps = {"rgb": rgb, "depth": rend["depth"],
                "uncert_map": rend["uncert_map"], "weights": rend["weights"],
                "raw": rend["raw"]}
        return maps, stats

    def losses_from_stats(self, stats: Dict) -> Dict:
        rgb_n = stats["rgb_n"].clamp_min(1.0)
        ray_n = stats["ray_n"].clamp_min(1.0)
        depth_n = stats["depth_n"].clamp_min(1.0)
        mse = stats["sq_sum"] / rgb_n
        rgb_loss = stats["nll_sum"] / rgb_n
        if self.config.get("active", {}).get("detach_nll", False):
            rgb_loss = mse + rgb_loss
        rgb_loss = rgb_loss + 0.5 * (stats["log_sum"] / ray_n) + 4.0
        depth_loss = stats["depth_sum"] / depth_n
        if "rgb0_sum" in stats:
            rgb_loss = rgb_loss + stats["rgb0_sum"] / rgb_n
            depth_loss = depth_loss + stats["depth0_sum"] / depth_n
        fs_loss, sdf_loss = L.sdf_losses(stats)
        return {"rgb_loss": rgb_loss, "depth_loss": depth_loss,
                "sdf_loss": sdf_loss, "fs_loss": fs_loss,
                "psnr": L.mse2psnr(mse)}
