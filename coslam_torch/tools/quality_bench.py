"""End-to-end quality benchmark on an analytic synthetic scene.

The port's counterpart of coslam_tpu/tools/quality_bench.py: render a
protocol's RGB-D sequence of an analytic scene, run the sequential SLAM
loop (``--pipelined``: the tracker/mapper runtime; ``--active``:
ActiveCoSLAM) on ``--device`` (the card by default), then evaluate ATE
and the culled mesh's Acc/Comp/Comp-ratio/depth-L1 against the scene's
analytic ground-truth mesh.

``--frames_in`` says how the frames reach the loop: ``disk`` (the
default, as in the JAX package) writes the protocol's on-disk layout and
reads it back through its loader, which needs ``cv2``; ``memory`` keeps
them in memory (data/synth.py:SyntheticFrames) and needs no image codec,
for hosts that have none. The choice is always the caller's.

Run: python -m coslam_torch.tools.quality_bench [--frames 100]
     [--frames_in memory] [--device cuda] [--out F]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=100)
    p.add_argument("--hw", type=str, default="120x160")
    p.add_argument("--out", default=None)
    p.add_argument("--workdir", default=None)
    p.add_argument("--protocol", default="replica",
                   choices=["replica", "tum", "scannet", "rgbd"],
                   help="'replica': scan trajectory, exact depth, Replica "
                        "layout and recipe. 'tum': handheld trajectory, "
                        "Kinect-style depth noise and holes, TUM layout "
                        "(timestamp association) and the TUM recipe at "
                        "its tuned operating point. 'scannet': two-room "
                        "apartment walkthrough, sensor noise, ScanNet "
                        "layout and recipe. 'rgbd': SyntheticRGBD: scan "
                        "trajectory, depth noise without holes, "
                        "NeuralRGBD layout and recipe")
    p.add_argument("--frames_in", default="disk", choices=["disk", "memory"],
                   help="'disk': write the protocol's files and read them "
                        "through its loader (needs cv2); 'memory': the "
                        "same frames held in memory (no image codec; the "
                        "colors skip Replica's and ScanNet's JPEG loss)")
    p.add_argument("--colors_from", default=None, metavar="NPZ",
                   help="memory route only: serve these uint8 colors "
                        "('rgb' [n, H, W, 3], e.g. the disk route's JPEG "
                        "colors from coslam_torch.tools.disk_colors) in "
                        "place of the rendered ones")
    p.add_argument("--device", default="cuda",
                   help="torch device of the SLAM loop and of the device "
                        "tracer (cpu: the kernels' plain versions)")
    p.add_argument("--dagger", action="store_true",
                   help="the reference's dagger protocol: double tracking "
                        "iterations + best-pose selection")
    p.add_argument("--pipelined", action="store_true",
                   help="the concurrent tracker/mapper runtime")
    p.add_argument("--active", action="store_true",
                   help="the ActiveCoSLAM variant")
    p.add_argument("--enc", default=None,
                   help="override grid.enc (e.g. TriPlaneHybrid, TriPlane)")
    p.add_argument("--samples_d", type=int, default=None,
                   help="override training.n_samples_d")
    p.add_argument("--set", action="append", default=[],
                   metavar="SECTION.KEY=VALUE",
                   help="ad-hoc config override (repeatable)")
    p.add_argument("--culling", default="coslam",
                   choices=["frustum", "frustum_occlusion", "coslam"],
                   help="mesh culling strategy; 'coslam' (default) is the "
                        "reference protocol: frustum + occlusion + virtual "
                        "cameras")
    p.add_argument("--eval_views", type=int, default=50,
                   help="virtual views for the 2D depth-L1 (the reference "
                        "uses 1000; use >= 200 for tables)")
    p.add_argument("--scene", default=None,
                   choices=["room", "apartment", "thin", "plain",
                            "room2", "corridor"],
                   help="analytic scene (default: apartment for scannet, "
                        "else room)")
    p.add_argument("--exposure_drift", type=float, default=0.0,
                   help="per-frame exposure random walk on the rendered "
                        "RGB (replica protocol only)")
    p.add_argument("--motion_blur", type=float, default=0.0,
                   help="camera motion blur shutter fraction (tum "
                        "protocol only)")
    p.add_argument("--tag", default=None,
                   help="suffix of the SLAM output dir only (not of the "
                        "rendered data dir)")
    p.add_argument("--seed", type=int, default=0,
                   help="replication seed: the SLAM random streams, and "
                        "the rendered data where the protocol is "
                        "stochastic (handheld/walkthrough/corridor "
                        "trajectories, sensor noise)")
    return p


def card_name(device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or
    'cpu'."""
    import torch

    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def gt_mesh(scene, scene_name: str, path: str) -> None:
    """The analytic GT mesh over the scene's bound (~3.4 cm spacing; the
    thin scene at half that, or its cm-scale slabs fall between grid
    points), the SDF evaluated one x-slab at a time."""
    import numpy as np

    from ..mesh.io import TriMesh
    from ..mesh.mcubes import marching_cubes

    spacing = 4.4 / 255 if scene_name == "thin" else 4.4 / 127
    lo = scene.bound[:, 0]
    axes = [np.linspace(l, h, int(round((h - l) / spacing)) + 1
                        ).astype(np.float32) for l, h in scene.bound]
    Y, Z = np.meshgrid(axes[1], axes[2], indexing="ij")
    sdf = np.stack([scene.sdf(np.stack(
        [np.full_like(Y, x), Y, Z], -1)).astype(np.float32)
        for x in axes[0]])
    v, f = marching_cubes(sdf, 0.0, truncation=5.0)
    sp = np.array([ax[1] - ax[0] for ax in axes], np.float32)
    TriMesh(v * sp[None, :] + lo[None, :], f).export(path)


def recipe_config(protocol: str, datadir: str, outdir: str, H: int, W: int,
                  n_frames: int) -> dict:
    """The protocol's recipe config as the benchmark runs it: the TUM,
    ScanNet and SyntheticRGBD makers as they are; the Replica protocol
    with 500 first-frame iterations, 2048 mapping and 1024 tracking rays,
    15 tracking iterations at lr 0.004; every final mesh at 5 cm."""
    from ..data import synth as S

    if protocol == "tum":
        cfg = S.make_tum_synthetic_config(datadir, outdir, H=H, W=W,
                                          n_frames=n_frames)
    elif protocol == "scannet":
        cfg = S.make_scannet_synthetic_config(datadir, outdir, H=H, W=W,
                                              n_frames=n_frames)
    elif protocol == "rgbd":
        cfg = S.make_rgbd_synthetic_config(datadir, outdir, H=H, W=W,
                                           n_frames=n_frames)
    else:
        cfg = S.make_synthetic_config(datadir, outdir, H=H, W=W,
                                      n_frames=n_frames)
        cfg["mapping"]["first_iters"] = 500
        cfg["mapping"]["sample"] = 2048
        cfg["tracking"]["sample"] = 1024
        cfg["tracking"]["iter"] = 15
        cfg["tracking"]["lr_rot"] = 0.004
        cfg["tracking"]["lr_trans"] = 0.004
    cfg["mesh"]["vis"] = 0
    cfg["mesh"]["voxel_final"] = 0.05
    return cfg


def main(argv=None):
    p = _parser()
    args = p.parse_args(argv)
    if args.motion_blur and args.protocol != "tum":
        p.error(f"--motion_blur only renders under --protocol tum "
                f"(got {args.protocol})")
    if args.exposure_drift and args.protocol != "replica":
        p.error(f"--exposure_drift only renders under --protocol replica "
                f"(got {args.protocol})")
    if args.pipelined and args.active:
        p.error("--pipelined and --active exclude each other")
    if args.colors_from and args.frames_in != "memory":
        p.error("--colors_from needs --frames_in memory")

    import numpy as np

    from ..data import synth as S
    from ..eval.benchmark import run_benchmark

    H, W = (int(v) for v in args.hw.split("x"))
    work = args.workdir or tempfile.mkdtemp(prefix="coslam_quality_")
    scene_name = args.scene or ("apartment" if args.protocol == "scannet"
                                else "room")
    if args.protocol == "replica" and scene_name == "room" \
            and args.seed == 0 and not args.exposure_drift:
        suffix = None
        datadir = os.path.join(work, "scene")
        outdir = os.path.join(work, "out"
                              + (f"_{args.tag}" if args.tag else ""))
        gt_name = "gt.ply"
    else:
        suffix = f"{args.protocol}_{scene_name}"
        if args.seed:
            suffix += f"_s{args.seed}"
        if args.exposure_drift:
            suffix += f"_xd{args.exposure_drift}"
        if args.motion_blur:
            suffix += f"_mb{args.motion_blur}"
        datadir = os.path.join(work, f"scene_{suffix}")
        outdir = os.path.join(work, f"out_{suffix}"
                              + (f"_{args.tag}" if args.tag else ""))
        gt_name = f"gt_{args.protocol}_{scene_name}.ply"
    if args.frames_in == "memory":
        # Its own directories: a disk-route render cache beside it keeps
        # its stamp, and the memory route writes no frames there.
        datadir += "_mem"
        outdir += "_mem"
    cfg = recipe_config(args.protocol, datadir, outdir, H, W, args.frames)
    if args.active:
        # The reference's proportions (ac_coslam.py:962: init 200 of
        # ~600-frame sequences, topK 1): a contiguous init segment, then
        # 2 of each 5-frame window by information gain (the JAX
        # harness's block).
        cfg["active"] = {"isActive": True, "check_info_gain_every": 5,
                         "init_image": max(10, args.frames // 2),
                         "choose_k": 2, "w": 0.01,
                         "downsample_rate": 2, "beta_min": 0.01}
    if args.dagger:
        cfg["tracking"]["iter"] *= 2
        cfg["tracking"]["best"] = True
    if args.samples_d is not None:
        cfg["training"]["n_samples_d"] = args.samples_d
    if args.enc is not None:
        cfg["grid"]["enc"] = args.enc
    for kv in args.set:
        path, _, raw = kv.partition("=")
        sec, _, key = path.partition(".")
        try:
            val = int(raw)
        except ValueError:
            try:
                val = float(raw)
            except ValueError:
                val = raw
        cfg.setdefault(sec, {})[key] = val

    scene = S.SCENES[scene_name]()
    cfg["seed"] = args.seed
    cam = cfg["cam"]
    if args.protocol == "tum":
        poses = S.make_handheld_trajectory(args.frames, seed=args.seed)
    elif args.protocol == "scannet":
        poses = S.make_walkthrough_trajectory(args.frames, seed=args.seed)
    elif args.protocol == "replica" and scene_name == "corridor":
        poses = S.make_corridor_trajectory(args.frames, seed=args.seed)
    else:
        poses = S.make_scan_trajectory(args.frames)
    camera = (cam["H"], cam["W"], cam["fx"], cam["fy"], cam["cx"], cam["cy"])
    print(f"rendering {args.frames} frames at {H}x{W} "
          f"({args.frames_in})...", flush=True)
    dataset = None
    if args.frames_in == "memory":
        os.makedirs(datadir, exist_ok=True)
        dataset = S.SyntheticFrames(
            cfg, args.frames, protocol=args.protocol, scene=scene,
            poses=poses, seed=args.seed, exposure_drift=args.exposure_drift,
            motion_blur=args.motion_blur, device=args.device)
        if args.colors_from:
            with np.load(args.colors_from) as npz:
                dataset.replace_colors(npz["rgb"])
    elif args.protocol == "tum":
        S.write_tum_format(datadir, scene, poses, *camera,
                           png_depth_scale=cam["png_depth_scale"],
                           seed=args.seed, motion_blur=args.motion_blur,
                           device=args.device)
    elif args.protocol == "scannet":
        S.write_scannet_format(datadir, scene, poses, *camera,
                               png_depth_scale=cam["png_depth_scale"],
                               seed=args.seed, device=args.device)
    elif args.protocol == "rgbd":
        S.write_rgbd_format(datadir, scene, poses, *camera,
                            png_depth_scale=cam["png_depth_scale"],
                            seed=args.seed, device=args.device)
    else:
        S.write_replica_format(datadir, scene, poses, *camera,
                               exposure_drift=args.exposure_drift,
                               exposure_seed=args.seed, device=args.device)

    gt_path = os.path.join(work, gt_name)
    gt_mesh(scene, scene_name, gt_path)

    print("running SLAM...", flush=True)
    slam_cls = None
    if args.active:
        from ..active.slam import ActiveCoSLAM as slam_cls
    elif args.pipelined:
        from ..runtime.pipeline import PipelinedCoSLAM as slam_cls
    res = run_benchmark(cfg, gt_mesh_path=gt_path, culling=args.culling,
                        n_eval_views=args.eval_views, dataset=dataset,
                        device=args.device, slam_cls=slam_cls)
    res.update(culling=args.culling, active=bool(args.active),
               pipelined=bool(args.pipelined),
               protocol=args.protocol, scene=scene_name,
               n_frames=args.frames, resolution=f"{H}x{W}",
               dagger=bool(args.dagger),
               n_samples_d=cfg["training"]["n_samples_d"],
               enc=cfg["grid"]["enc"], device=card_name(args.device),
               seed=args.seed, frames_in=args.frames_in)
    if args.motion_blur:
        res["motion_blur"] = args.motion_blur
    if args.exposure_drift:
        res["exposure_drift"] = args.exposure_drift
    if args.set:
        res["overrides"] = list(args.set)
    if args.colors_from:
        res["colors_from"] = os.path.basename(args.colors_from)
    res["dataset_sha1"] = (dataset.content_hash() if dataset is not None
                           else S.dataset_content_hash(datadir))
    print(json.dumps(res, indent=2))
    if args.out:
        with open(args.out, "w") as fo:
            json.dump(res, fo, indent=2)
    return res


if __name__ == "__main__":
    main()
