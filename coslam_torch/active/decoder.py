"""ColorSDFNetV3: an SDF backbone with separate SDF, uncertainty and
feature heads.

Counterpart of coslam_tpu/active/decoder.py (the reference's
ActiveCoSLAM/ac_decoder.py:153-198). Output per point: [rgb logits (3),
sdf (1), beta (1)], with beta = softplus(uncertainty_linear(h)) +
beta_min, h the backbone's output. The backbone and the color MLP are
the bias-free ReLU MLPs of models/decoder.py in f32; each head is a
linear layer with a bias, ``{"w": [in, out], "b": [out]}``.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..models.decoder import _layer_dims, init_mlp, mlp_apply


def init_linear(d_in: int, d_out: int, generator: torch.Generator,
                device=None) -> Dict[str, torch.Tensor]:
    """torch.nn.Linear's default init (weight and bias U(-1/sqrt(d_in),
    1/sqrt(d_in))), drawn on the generator's device."""
    bound = 1.0 / d_in ** 0.5
    out = {}
    for name, shape in (("w", (d_in, d_out)), ("b", (d_out,))):
        u = torch.rand(shape, generator=generator, device=generator.device)
        out[name] = ((u * 2.0 - 1.0) * bound).to(device or generator.device)
    return out


def linear(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


class ColorSDFNetV3:
    def __init__(self, config: Dict, input_ch: int, input_ch_pos: int,
                 beta_min: float = 1e-4):
        dec = config["decoder"]
        a = config.get("active", {})
        self.beta_min = float(a.get("beta_min", beta_min))
        # With detach_nll (the default) the uncertainty head reads a
        # detached copy of the trunk's features: beta's training signal
        # reaches uncertainty_linear only, never the trunk or the grid.
        self.detach_trunk = bool(a.get("detach_nll", True))
        self.geo_feat_dim = dec["geo_feat_dim"]
        self.backbone_out = 1 + dec["geo_feat_dim"]
        self.sdf_dims = _layer_dims(input_ch + input_ch_pos, dec["hidden_dim"],
                                    self.backbone_out, dec["num_layers"])
        self.color_dims = _layer_dims(input_ch_pos + self.backbone_out,
                                      dec["hidden_dim_color"], 3,
                                      dec["num_layers_color"])

    def init(self, generator: torch.Generator, device=None) -> Dict:
        W = self.backbone_out
        return {
            "sdf_net": init_mlp(self.sdf_dims, generator, device),
            "color_net": init_mlp(self.color_dims, generator, device),
            "feature_linear": init_linear(W, W, generator, device),
            "sdf_linear": init_linear(W, 1, generator, device),
            "uncertainty_linear": init_linear(W, 1, generator, device),
        }

    def sdf_net(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        """The backbone's output h [., 1 + geo_feat_dim]; the SDF is
        sdf_linear on top of it (ActiveJointEncoding.query_sdf)."""
        return mlp_apply(params["sdf_net"], x)

    def color_net(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(params["color_net"], x)

    def __call__(self, params: Dict, embed: torch.Tensor,
                 embed_pos: torch.Tensor, embed_color=None) -> torch.Tensor:
        h = self.sdf_net(params, torch.cat([embed, embed_pos], -1))
        sdf = linear(params["sdf_linear"], h)
        h_u = h.detach() if self.detach_trunk else h
        beta = (torch.nn.functional.softplus(
            linear(params["uncertainty_linear"], h_u)) + self.beta_min)
        geo_feat = linear(params["feature_linear"], h)
        rgb = self.color_net(params, torch.cat([embed_pos, geo_feat], -1))
        return torch.cat([rgb, sdf, beta], -1)
