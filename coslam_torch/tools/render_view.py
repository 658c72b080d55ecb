"""Novel-view RGB-D rendering from a trained checkpoint.

Counterpart of coslam_tpu/tools/render_view.py (the reference's one-shot
render evaluation, ActiveCoSLAM/ac_coslam.py:703-741 ``test()``, for any
trained model): volume-render a full RGB + depth image from a chosen
pose and save an [rgb | turbo-depth] composite and a 16-bit depth PNG.
With ``--frame --compare`` it also prints PSNR and depth-L1 against the
dataset's frame as one JSON line. The grid's encode kernel runs in every
chunk of rays on the card.

Rendering is deterministic (``training.perturb`` forced to 0, so the
render draws nothing). Without ``--use_depth`` the z samples are the
uniform near..far stratum only; ``--use_depth`` adds the training-time
depth-guided band from the dataset frame. The chunks are plain slices of
the ray list (the JAX tool pads the last one to avoid a recompile).

Pose sources, in precedence order: ``--pose FILE`` (whitespace 4x4
c2w), ``--gt_pose --frame N`` (the dataset's trajectory), ``--frame N``
(the checkpoint's estimated pose). The checkpoint is the port's or the
JAX package's ``.npz``; with ``active.isActive`` the model is the
beta-head variant.

Usage:
  python -m coslam_torch.tools.render_view --config configs/Replica/room0.yaml \
      --ckpt out/room0/checkpoint1999.npz --frame 500 --compare
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..parallel.sharding import on_device


def render_image(model, params, c2w: np.ndarray, H: int, W: int,
                 fx: float, fy: float, cx: float, cy: float, *,
                 target_d: Optional[np.ndarray] = None,
                 chunk: int = 2 ** 14, device="cuda"):
    """Full-image volume render through ``model.render_rays`` in chunks
    of ``chunk`` rays on ``device`` -> (rgb [H, W, 3], depth [H, W]) as
    numpy arrays. ``target_d`` [H, W]: the depth guiding the samples
    (None: the uniform stratum)."""
    from ..ops.rays import get_camera_rays

    device = torch.device(device)
    dirs = torch.from_numpy(np.ascontiguousarray(
        get_camera_rays(H, W, fx, fy, cx, cy).reshape(-1, 3),
        np.float32)).to(device)
    c2w = torch.from_numpy(np.asarray(c2w, np.float32)).to(device)
    td = (None if target_d is None else torch.from_numpy(
        np.asarray(target_d, np.float32).reshape(-1, 1)).to(device))
    rgb, depth = [], []
    with torch.no_grad(), on_device(device):
        for lo in range(0, dirs.shape[0], chunk):
            rays_d = dirs[lo:lo + chunk] @ c2w[:3, :3].T
            ret = model.render_rays(params, c2w[:3, 3].expand_as(rays_d),
                                    rays_d,
                                    None if td is None else td[lo:lo + chunk])
            rgb.append(ret["rgb"])
            depth.append(ret["depth"])
    return (torch.cat(rgb).reshape(H, W, 3).cpu().numpy(),
            torch.cat(depth).reshape(H, W).cpu().numpy())


def load_params(model, path: str, device):
    """(the parameters of a checkpoint, the port's or the JAX package's,
    on ``device``; its estimated pose table)."""
    from .. import convert
    from ..runtime.checkpoint import load_ckpt

    like = model.init_params(torch.Generator().manual_seed(0))
    params, est, _, _ = load_ckpt(path, like)
    return (convert.params_from_numpy(params, device, spec=model.grid_spec),
            est)


def make_model(cfg: Dict, device):
    """The run's model: ActiveJointEncoding with active.isActive, else
    JointEncoding."""
    bound = np.array(cfg["mapping"]["bound"], np.float32)
    if (cfg.get("active") or {}).get("isActive"):
        from ..active.scene_rep import ActiveJointEncoding as cls
    else:
        from ..models.scene_rep import JointEncoding as cls
    return cls(cfg, bound, device)


def save_outputs(out_png: str, rgb: np.ndarray, depth: np.ndarray,
                 depth_trunc: float, png_depth_scale: float) -> Dict:
    """The [rgb | turbo-depth] composite at ``out_png`` and the depth as a
    16-bit PNG beside it (``*_depth.png``)."""
    import cv2

    from .viz import colormap_image

    mask = (depth > 0) & (depth < depth_trunc)
    if not mask.any():
        # No valid depth pixel to scale the colormap by: map the raw
        # depth.
        mask = None
    dvis = colormap_image(depth, mask, invalid_color=(1.0, 1.0, 1.0))
    comp = np.hstack([np.clip(rgb, 0, 1), dvis])
    os.makedirs(os.path.dirname(os.path.abspath(out_png)), exist_ok=True)
    cv2.imwrite(out_png, cv2.cvtColor((comp * 255).astype(np.uint8),
                                      cv2.COLOR_RGB2BGR))
    depth_png = out_png.rsplit(".", 1)[0] + "_depth.png"
    cv2.imwrite(depth_png, np.clip(depth * png_depth_scale, 0,
                                   65535).astype(np.uint16))
    return {"png": out_png, "depth_png": depth_png}


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(
        description="render an RGB-D view from a trained checkpoint")
    p.add_argument("--config", required=True)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--frame", type=int, default=None,
                   help="frame index for the pose (and --compare target)")
    p.add_argument("--pose", default=None,
                   help="whitespace 4x4 c2w text file (overrides --frame)")
    p.add_argument("--gt_pose", action="store_true",
                   help="pose from the dataset GT trajectory instead of "
                        "the checkpoint's estimate")
    p.add_argument("--out", default=None,
                   help="output PNG path (default: next to the checkpoint)")
    p.add_argument("--chunk", type=int, default=2 ** 14)
    p.add_argument("--use_depth", action="store_true",
                   help="depth-guided sampling from the dataset frame "
                        "(training-time sampler; needs --frame)")
    p.add_argument("--compare", action="store_true",
                   help="report PSNR / depth-L1 vs the dataset frame "
                        "(needs --frame)")
    p.add_argument("--device", default="cuda",
                   help="torch device (CUDA runs the kernels; cpu their "
                        "plain versions)")
    args = p.parse_args(argv)

    if args.frame is None:
        for flag in ("compare", "use_depth", "gt_pose"):
            if getattr(args, flag):
                p.error(f"--{flag} requires --frame")

    from ..config import load_config

    cfg = load_config(args.config)
    cfg["training"]["perturb"] = 0.0  # a deterministic render
    model = make_model(cfg, args.device)
    params, est_c2w = load_params(model, args.ckpt, args.device)

    # Camera and the dataset frame: a --frame render takes the loader's
    # camera (after its downsample and crop) when the data is on disk; a
    # --pose render, or a --frame render without the data, the config's.
    cam = cfg["cam"]
    H, W = cam["H"], cam["W"]
    fx, fy, cx, cy = cam["fx"], cam["fy"], cam["cx"], cam["cy"]
    batch = None
    if args.frame is not None:
        from ..data.datasets import get_dataset

        need_data = args.compare or args.use_depth or args.gt_pose
        try:
            ds = get_dataset(cfg)
            H, W, fx, fy, cx, cy = ds.H, ds.W, ds.fx, ds.fy, ds.cx, ds.cy
            batch = ds[args.frame]
        except Exception as e:
            if need_data:
                raise SystemExit(
                    f"--compare/--use_depth/--gt_pose need the dataset at "
                    f"{cfg['data'].get('datadir')}: {e}")
            print(f"note: dataset unavailable ({e}); rendering with raw "
                  "config intrinsics")

    if args.pose is not None:
        c2w = np.loadtxt(args.pose).reshape(4, 4).astype(np.float32)
    elif args.frame is None:
        p.error("need --pose or --frame")
    elif args.gt_pose:
        c2w = np.asarray(batch["c2w"], np.float32)
    else:
        if args.frame >= len(est_c2w) or not np.any(est_c2w[args.frame]):
            raise SystemExit(f"frame {args.frame} has no estimated pose "
                             f"in {args.ckpt} (untracked)")
        c2w = np.asarray(est_c2w[args.frame], np.float32)

    target_d = (np.asarray(batch["depth"])
                if args.use_depth and batch is not None else None)
    rgb, depth = render_image(model, params, c2w, H, W, fx, fy, cx, cy,
                              target_d=target_d, chunk=args.chunk,
                              device=args.device)

    tag = "pose" if args.pose is not None else f"{args.frame:05d}"
    out_png = args.out or os.path.join(
        os.path.dirname(os.path.abspath(args.ckpt)), f"render_{tag}.png")
    result = save_outputs(out_png, rgb, depth, cam["depth_trunc"],
                          cam.get("png_depth_scale", 6553.5))
    result.update(rgb=rgb, depth=depth)

    if args.compare and batch is not None:
        gt_rgb = np.asarray(batch["rgb"], np.float32)
        gt_d = np.asarray(batch["depth"], np.float32)
        valid = (gt_d > 0) & (gt_d < cam["depth_trunc"])
        mse = float(np.mean((rgb - gt_rgb) ** 2))
        result["psnr"] = -10.0 * np.log10(max(mse, 1e-12))
        result["depth_l1"] = float(np.abs(depth - gt_d)[valid].mean())
        print(json.dumps({"frame": args.frame,
                          "psnr": round(result["psnr"], 3),
                          "depth_l1": round(result["depth_l1"], 5),
                          "png": out_png}))
    else:
        print(f"render saved to {out_png}")
    return result


if __name__ == "__main__":
    main()
