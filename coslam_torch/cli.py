"""Command-line entry point: ``python -m coslam_torch --config <yaml>``.

Loads the YAML config (recursive inherit_from) with the port's loader
(coslam_torch/config.py), builds the dataset from it and runs the
sequential loop on the chosen device, resuming from a checkpoint with
``--ckpt <path|auto>`` and writing one every ``--ckpt_every`` frames.
``yaml`` and the image decoders of the dataset loaders are imported here
only, never by the package.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="coslam_torch: Co-SLAM on PyTorch and CUDA")
    parser.add_argument("--config", type=str, required=True,
                        help="Path to config file.")
    parser.add_argument("--input_folder", type=str,
                        help="overrides data.datadir from the config")
    parser.add_argument("--output", type=str,
                        help="overrides data.output from the config")
    parser.add_argument("--max_frames", type=int, default=None,
                        help="process only the first N frames")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (CUDA runs the kernels; cpu "
                             "runs their plain versions)")
    parser.add_argument("--ckpt", type=str, default=None,
                        help="resume from a checkpoint .npz (the port's or "
                             "the JAX package's: map, poses, keyframes, "
                             "optimizer state, frame cursor); 'auto' picks "
                             "the newest checkpoint*.npz in the run's "
                             "output directory")
    parser.add_argument("--ckpt_every", type=int, default=0,
                        help="write a resumable checkpoint every N frames "
                             "(0: the final one only)")
    args = parser.parse_args(argv)

    from .config import load_config
    from .data.datasets import get_dataset
    from .runtime.slam import CoSLAM

    cfg = load_config(args.config)
    if args.input_folder is not None:
        cfg["data"]["datadir"] = args.input_folder
    if args.output is not None:
        cfg["data"]["output"] = args.output
    out = os.path.join(cfg["data"]["output"], cfg["data"]["exp_name"])
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "config.json"), "w", encoding="utf-8") as f:
        f.write(json.dumps(cfg, indent=4))

    slam = CoSLAM(cfg, get_dataset(cfg), device=args.device)
    start_frame = 0
    if args.ckpt:
        path = newest_checkpoint(out) if args.ckpt == "auto" else args.ckpt
        start_frame = slam.load_checkpoint(path)
        print(f"resuming from frame {start_frame} of {path}")
    slam.run(n_frames=args.max_frames, ckpt_every=args.ckpt_every,
             start_frame=start_frame)


def newest_checkpoint(out_dir: str) -> str:
    """The checkpoint*.npz of out_dir with the highest frame number;
    exits with a message when there is none."""
    import glob
    import re

    found = {}
    for path in glob.glob(os.path.join(out_dir, "checkpoint*.npz")):
        m = re.fullmatch(r"checkpoint(\d+)\.npz", os.path.basename(path))
        if m:
            found[int(m.group(1))] = path
    if not found:
        raise SystemExit(f"--ckpt auto: no checkpoint*.npz under {out_dir}")
    return found[max(found)]


if __name__ == "__main__":
    main()
