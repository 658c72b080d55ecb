"""Command-line entry point: ``python -m coslam_torch --config <yaml>``.

Loads the YAML config (recursive inherit_from) with the port's loader
(coslam_torch/config.py), builds the dataset from it and runs the
sequential loop on the chosen device, resuming from a checkpoint with
``--ckpt <path|auto>`` and writing one every ``--ckpt_every`` frames.
``--pipelined`` runs the concurrent tracker/mapper runtime
(runtime/pipeline.py), ``--active`` (or ``active.isActive`` in the
config) ActiveCoSLAM (active/), which takes no ``--ckpt`` and ignores
``--ckpt_every``; the two exclude each other. ``--devices N`` sets
``parallel.dp``: the sequential loop splits its ray batches over N cards,
the pipelined runtime keeps the tracker on the first and gives the mapper
the other N - 1 (parallel/sharding.py).
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
    parser.add_argument("--devices", type=int, default=None,
                        help="use N devices (overrides parallel.dp): the "
                             "sequential loop splits its ray batches over "
                             "N cards; --pipelined keeps the tracker on the "
                             "first and gives the mapper the other N - 1")
    parser.add_argument("--pipelined", action="store_true",
                        help="the concurrent tracker/mapper runtime (two "
                             "threads, each on its own CUDA stream)")
    parser.add_argument("--active", action="store_true",
                        help="ActiveCoSLAM (info-gain keyframes); also "
                             "chosen when the config sets active.isActive")
    args = parser.parse_args(argv)

    from .config import load_config
    from .data.datasets import get_dataset

    cfg = load_config(args.config)
    use_active = args.active or bool((cfg.get("active") or {}).get(
        "isActive"))
    if use_active and args.pipelined:
        parser.error("--active and --pipelined exclude each other (the "
                     "reference's ac_coslam.py is sequential)")
    if use_active and args.ckpt:
        parser.error("--ckpt: the active variant does not resume (its train "
                     "set grows as it runs); run it from frame 0")
    if use_active:
        from .active.slam import ActiveCoSLAM as slam_cls
    elif args.pipelined:
        from .runtime.pipeline import PipelinedCoSLAM as slam_cls
    else:
        from .runtime.slam import CoSLAM as slam_cls
    if args.input_folder is not None:
        cfg["data"]["datadir"] = args.input_folder
    if args.output is not None:
        cfg["data"]["output"] = args.output
    if args.devices is not None:
        cfg.setdefault("parallel", {})["dp"] = args.devices
    out = os.path.join(cfg["data"]["output"], cfg["data"]["exp_name"])
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "config.json"), "w", encoding="utf-8") as f:
        f.write(json.dumps(cfg, indent=4))

    slam = slam_cls(cfg, get_dataset(cfg), device=args.device)
    if use_active:
        if args.ckpt_every:
            print("--ckpt_every ignored in active mode")
        slam.run(n_frames=args.max_frames)
        return
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
