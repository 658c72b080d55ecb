"""Visualization helpers: depth colormapping and scene-bound inspection.

The port's own copy of coslam_tpu/tools/viz.py, in numpy, with its own
copy of the turbo colormap (tools/_turbo.py; the loop's live view,
runtime/slam.py:CoSLAM.visualise_frame, and tools/render_view.py use
colormap_image on the card's machine, which has no matplotlib).
colormap_image replaces the reference's SimpleRecon-derived torch
implementation (reference utils.py:208-263); ``main`` replaces the
interactive bound-picking notebook (reference vis_bound.ipynb) with a
headless script that back-projects sampled depth frames and reports a
bounding box suggestion:

    python -m coslam_torch.tools.viz --config configs/Replica/room0.yaml
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def colormap_image(image_hw: np.ndarray, mask_hw: Optional[np.ndarray] = None,
                   invalid_color=(0.0, 0.0, 0.0), flip: bool = True,
                   vmin: Optional[float] = None, vmax: Optional[float] = None,
                   colormap: str = "turbo") -> np.ndarray:
    """Colormap a single-channel image -> [H, W, 3] float RGB. Turbo comes
    from the port's own table (no matplotlib needed); another colormap
    from matplotlib."""
    valid = image_hw if mask_hw is None else image_hw[mask_hw.astype(bool)]
    vmin = float(valid.min()) if vmin is None else vmin
    vmax = float(valid.max()) if vmax is None else vmax

    if colormap == "turbo":
        from ._turbo import TURBO

        lut = np.asarray(TURBO, np.float64)
    else:
        import matplotlib

        lut = matplotlib.colormaps[colormap](np.linspace(0, 1, 256))[:, :3]
    if flip:
        lut = lut[::-1]
    norm = np.clip((image_hw - vmin) / max(vmax - vmin, 1e-12), 0, 1)
    out = lut[(norm * 255).astype(np.uint8)]
    if mask_hw is not None:
        out = np.where(mask_hw[..., None].astype(bool), out,
                       np.asarray(invalid_color)[None, None])
    return out.astype(np.float32)


def estimate_scene_bounds(dataset, every: int = 20, pad: float = 0.1,
                          depth_trunc: float = 10.0
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Back-project sampled frames' depth with GT poses and return
    (bound [3,2], percentile-robust bound [3,2]) for mapping.bound."""
    pts_all = []
    for i in range(0, len(dataset), every):
        b = dataset[i]
        d = b["depth"].reshape(-1)
        valid = (d > 0) & (d < depth_trunc)
        dirs = b["direction"].reshape(-1, 3)[valid]
        c2w = np.asarray(b["c2w"], np.float64)
        rays_d = dirs @ c2w[:3, :3].T
        pts = c2w[:3, 3][None] + rays_d * d[valid][:, None]
        pts_all.append(pts[::17])
    pts = np.concatenate(pts_all)
    lo, hi = pts.min(0) - pad, pts.max(0) + pad
    lo_r = np.percentile(pts, 0.5, axis=0) - pad
    hi_r = np.percentile(pts, 99.5, axis=0) + pad
    return (np.stack([lo, hi], 1).astype(np.float32),
            np.stack([lo_r, hi_r], 1).astype(np.float32))


def main(argv=None):
    import argparse

    from ..config import load_config
    from ..data.datasets import get_dataset

    p = argparse.ArgumentParser(description="suggest mapping.bound for a scene")
    p.add_argument("--config", required=True)
    args = p.parse_args(argv)
    ds = get_dataset(load_config(args.config))
    bound, robust = estimate_scene_bounds(ds)
    print("tight bound:", bound.tolist())
    print("robust bound (0.5-99.5 pct):", robust.tolist())
    return bound, robust


if __name__ == "__main__":
    main()
