"""Command-line entry point: ``python -m coslam_torch --config <yaml>``.

Loads the YAML config (recursive inherit_from) with the port's loader
(coslam_torch/config.py), builds the dataset from it and runs the
sequential loop on the chosen device. ``yaml`` and the image decoders of
the dataset loaders are imported here only, never by the package.
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
    slam.run(n_frames=args.max_frames)


if __name__ == "__main__":
    main()
