"""Evaluation CLIs: reconstruction metrics and mesh culling.

The port's own copy of coslam_tpu/eval/cli.py (the reference's
evaluation/eval_recon.py and evaluation/cull_mesh.py surfaces):

  recon: python -m coslam_torch.eval.cli recon --rec_mesh R --gt_mesh G
         [-2d -3d]
  cull:  python -m coslam_torch.eval.cli cull --config C --input_mesh M
         [--remove_occlusion --virtual_cameras --ckpt_path ...]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def recon_main(argv):
    from .recon import calc_2d_metric, calc_3d_metric

    p = argparse.ArgumentParser(description="reconstruction evaluation")
    p.add_argument("--rec_mesh", required=True)
    p.add_argument("--gt_mesh", required=True)
    p.add_argument("-2d", "--metric_2d", action="store_true")
    p.add_argument("-3d", "--metric_3d", action="store_true")
    p.add_argument("--dataset_type", default="Replica")
    p.add_argument("--gt_pc_unseen", default=None)
    p.add_argument("--n_imgs", type=int, default=1000)
    p.add_argument("--no_align", action="store_true")
    args = p.parse_args(argv)

    out = {}
    if args.metric_3d:
        out.update(calc_3d_metric(args.rec_mesh, args.gt_mesh,
                                  align=not args.no_align))
    if args.metric_2d:
        out.update(calc_2d_metric(args.rec_mesh, args.gt_mesh,
                                  unseen_gt_pcd_file=args.gt_pc_unseen,
                                  align=not args.no_align,
                                  n_imgs=args.n_imgs))
    print(json.dumps(out, indent=2))
    return out


def cull_main(argv):
    from ..config import load_config
    from ..data.datasets import get_dataset
    from .cull import cull_one_mesh

    p = argparse.ArgumentParser(description="mesh culling")
    p.add_argument("--config", required=True)
    p.add_argument("--input_mesh", required=True)
    p.add_argument("--output_mesh", default=None)
    p.add_argument("--ckpt_path", default=None,
                   help="use the estimated poses of a checkpoint .npz (the "
                        "port's or the JAX package's)")
    p.add_argument("--remove_occlusion", action="store_true")
    p.add_argument("--virtual_cameras", action="store_true")
    p.add_argument("--virt_cam_path", default=None)
    p.add_argument("--save_unseen", action="store_true")
    p.add_argument("--gt_pose", action="store_true",
                   help="cull with ground-truth trajectory poses")
    p.add_argument("--eps", type=float, default=0.03)
    args = p.parse_args(argv)

    cfg = load_config(args.config)
    if args.ckpt_path:
        with np.load(args.ckpt_path, allow_pickle=False) as data:
            est_c2w = np.asarray(data["pose"])
        poses = [est_c2w[i] for i in range(len(est_c2w))]
    else:
        ds = get_dataset(cfg)
        poses = [np.asarray(p) for p in ds.poses]

    save_path = args.output_mesh or args.input_mesh.replace(
        ".ply", "_cull_occlusion.ply")
    bounds = None
    if "marching_cubes_bound" in cfg.get("mapping", {}):
        b = np.array(cfg["mapping"]["marching_cubes_bound"])
        bounds = np.stack([b[:, 0], b[:, 1]])
    cull_one_mesh(cfg, poses, args.input_mesh, save_path,
                  save_unseen=args.save_unseen,
                  remove_occlusion=args.remove_occlusion,
                  virtual_cameras=args.virtual_cameras,
                  virt_cam_path=args.virt_cam_path,
                  scene_bounds=bounds, eps=args.eps)
    print(f"culled mesh saved to {save_path}")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in ("recon", "cull"):
        print("usage: python -m coslam_torch.eval.cli {recon|cull} ...")
        sys.exit(1)
    if argv[0] == "recon":
        return recon_main(argv[1:])
    return cull_main(argv[1:])


if __name__ == "__main__":
    main()
