"""Bias-free ReLU MLP decoders for SDF + color.

Counterpart of coslam_tpu/models/decoder.py. Parameters are plain
tensors in the JAX package's layout (a list of [in, out] weight matrices
per net), so converted JAX parameters drop in unchanged; the products are
``torch.matmul``, as the JAX package leaves them to XLA.

``decoder.dtype: bfloat16`` rounds the activations and the weights to
bf16 before each product and the hidden activation again after each
ReLU; the products accumulate in f32 and the output is f32, as the JAX
package's ``preferred_element_type=f32`` dots. A product of two bf16
values is exact in f32, so the rounded operands are multiplied as f32
tensors; that needs TF32 off for matrix products (PyTorch's default,
``torch.backends.cuda.matmul.allow_tf32 = False``). The parameters stay
f32.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch


def init_mlp(dims: Sequence[int], generator: torch.Generator,
             device=None) -> List[torch.Tensor]:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) weights (torch.nn.Linear's
    default init), drawn on the generator's device."""
    ws = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        bound = 1.0 / d_in ** 0.5
        u = torch.rand((d_in, d_out), generator=generator,
                       device=generator.device)
        ws.append(((u * 2.0 - 1.0) * bound).to(device or generator.device))
    return ws


def _to_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (nearest even), kept as f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def mlp_apply(ws: Sequence[torch.Tensor], x: torch.Tensor,
              bf16: bool = False) -> torch.Tensor:
    """ReLU MLP, no activation on the output layer. bf16: operands
    rounded to bf16, f32 sums and output (the module docstring)."""
    if not bf16:
        for w in ws[:-1]:
            x = torch.relu(x @ w)
        return x @ ws[-1]
    x = _to_bf16(x)
    for w in ws[:-1]:
        x = _to_bf16(torch.relu(x @ _to_bf16(w)))
    return x @ _to_bf16(ws[-1])


def _layer_dims(in_dim: int, hidden: int, out_dim: int, n_layers: int):
    return [in_dim] + [hidden] * (n_layers - 1) + [out_dim]


class ColorSDFDecoder:
    """One-grid decoder (``oneGrid: true``): sdf_net([embed, embed_pos])
    -> [sdf, geo_feat]; color_net([embed_pos, geo_feat]) -> rgb logits.
    Two grids (``oneGrid: false``): color_net([embed_pos, embed_color,
    geo_feat]), embed_color the color grid's encoding. Output [rgb(3),
    sdf]."""

    def __init__(self, config: Dict, input_ch: int, input_ch_pos: int,
                 input_ch_color: int = 0, one_grid: bool = True):
        dec = config["decoder"]
        dtype = dec.get("dtype", "float32")
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(f"decoder.dtype {dtype!r}: float32 or bfloat16")
        self.bf16 = dtype == "bfloat16"
        self.one_grid = one_grid
        self.geo_feat_dim = dec["geo_feat_dim"]
        self.sdf_dims = _layer_dims(input_ch + input_ch_pos, dec["hidden_dim"],
                                    1 + dec["geo_feat_dim"], dec["num_layers"])
        color_in = input_ch_pos + dec["geo_feat_dim"]
        if not one_grid:
            color_in += input_ch_color
        self.color_dims = _layer_dims(color_in, dec["hidden_dim_color"], 3,
                                      dec["num_layers_color"])

    def init(self, generator: torch.Generator, device=None) -> Dict:
        return {"sdf_net": init_mlp(self.sdf_dims, generator, device),
                "color_net": init_mlp(self.color_dims, generator, device)}

    def sdf_net(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(params["sdf_net"], x, self.bf16)

    def color_net(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(params["color_net"], x, self.bf16)

    def __call__(self, params: Dict, embed: torch.Tensor,
                 embed_pos: torch.Tensor,
                 embed_color: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.sdf_net(params, torch.cat([embed, embed_pos], -1))
        sdf, geo_feat = h[..., :1], h[..., 1:]
        cin = ([embed_pos, geo_feat] if self.one_grid
               else [embed_pos, embed_color, geo_feat])
        rgb = self.color_net(params, torch.cat(cin, -1))
        return torch.cat([rgb, sdf], -1)
