"""The disk route's colors of a JPEG protocol, saved for the memory route.

Replica's and ScanNet's writers store colors as JPEG (quality 97), which
the in-memory route (data/synth.py:SyntheticFrames) skips. This writes
the protocol's files with its writer (``cv2`` needed), decodes every
color file as the loaders do (uint8 RGB, before any crop) and saves them
as ``rgb`` [n, H, W, 3] in an ``.npz``; ``quality_bench --frames_in
memory --colors_from <npz>`` then runs the memory route on the disk
route's frames (tests/test_torch_synth.py holds the two routes equal but
for this loss), on a machine without ``cv2``.

Run: python -m coslam_torch.tools.disk_colors --protocol replica
     --scene room --frames 300 --hw 120x160 --out colors.npz
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--protocol", default="replica",
                   choices=["replica", "scannet"])
    p.add_argument("--scene", default=None)
    p.add_argument("--frames", type=int, default=300)
    p.add_argument("--hw", default="120x160")
    p.add_argument("--seed", type=int, default=0,
                   help="the trajectory's seed (corridor, walkthrough) and "
                        "the noise's (ScanNet), as quality_bench's")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    import cv2

    from ..data import synth as S
    from .quality_bench import recipe_config

    H, W = (int(v) for v in args.hw.split("x"))
    scene_name = args.scene or ("apartment" if args.protocol == "scannet"
                                else "room")
    cam = recipe_config(args.protocol, "", "", H, W, args.frames)["cam"]
    camera = (H, W, cam["fx"], cam["fy"], cam["cx"], cam["cy"])
    scene = S.SCENES[scene_name]()
    with tempfile.TemporaryDirectory() as d:
        if args.protocol == "scannet":
            poses = S.make_walkthrough_trajectory(args.frames, seed=args.seed)
            S.write_scannet_format(d, scene, poses, *camera,
                                   png_depth_scale=cam["png_depth_scale"],
                                   seed=args.seed, device="cpu")
            paths = [os.path.join(d, "color", f"{i}.jpg")
                     for i in range(args.frames)]
        else:
            poses = (S.make_corridor_trajectory(args.frames, seed=args.seed)
                     if scene_name == "corridor"
                     else S.make_scan_trajectory(args.frames))
            S.write_replica_format(d, scene, poses, *camera, device="cpu")
            paths = [os.path.join(d, "results", f"frame{i:06d}.jpg")
                     for i in range(args.frames)]
        rgb = np.stack([cv2.cvtColor(cv2.imread(f), cv2.COLOR_BGR2RGB)
                        for f in paths])
    np.savez_compressed(args.out, rgb=rgb)
    print(f"saved {rgb.shape} colors to {args.out}")


if __name__ == "__main__":
    main()
