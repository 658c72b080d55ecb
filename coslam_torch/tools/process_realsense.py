"""RealSense .bag capture preprocessing (reference:
evaluation/datasets/process_realsense.py).

The port's own copy of coslam_tpu/tools/process_realsense.py: extracts
aligned color/depth frames from a RealSense .bag recording into the
color/ + depth/ + scene/ layout that coslam_torch/data/datasets.py's
RealsenseDataset reads, and writes the camera intrinsics. Requires
pyrealsense2 (not bundled); raises ImportError with guidance otherwise.

Usage:
  python -m coslam_torch.tools.process_realsense --bag capture.bag \
      --out data/realsense/scene0 [--max_frames N]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def process_bag(bag_path: str, out_dir: str, max_frames: int = 0) -> int:
    try:
        import pyrealsense2 as rs
    except ImportError as e:
        raise ImportError(
            "pyrealsense2 is required for .bag preprocessing "
            "(pip install pyrealsense2); alternatively extract frames with "
            "the RealSense SDK and use the color/ + depth/ layout directly."
        ) from e
    import cv2

    os.makedirs(os.path.join(out_dir, "color"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "scene"), exist_ok=True)

    pipeline = rs.pipeline()
    cfg = rs.config()
    cfg.enable_device_from_file(bag_path, repeat_playback=False)
    profile = pipeline.start(cfg)
    playback = profile.get_device().as_playback()
    playback.set_real_time(False)
    align = rs.align(rs.stream.color)

    intr = (profile.get_stream(rs.stream.color)
            .as_video_stream_profile().get_intrinsics())
    np.savetxt(os.path.join(out_dir, "scene", "intrinsics.txt"),
               np.array([intr.fx, intr.fy, intr.ppx, intr.ppy]))

    i = 0
    try:
        while True:
            frames = pipeline.wait_for_frames(timeout_ms=2000)
            frames = align.process(frames)
            color = np.asanyarray(frames.get_color_frame().get_data())
            depth = np.asanyarray(frames.get_depth_frame().get_data())
            cv2.imwrite(os.path.join(out_dir, "color", f"{i:06d}.jpg"),
                        cv2.cvtColor(color, cv2.COLOR_RGB2BGR))
            cv2.imwrite(os.path.join(out_dir, "depth", f"{i:06d}.png"), depth)
            i += 1
            if max_frames and i >= max_frames:
                break
    except RuntimeError:
        pass  # end of bag
    finally:
        pipeline.stop()
    return i


def main(argv=None):
    p = argparse.ArgumentParser(
        description="extract a RealSense .bag into color/ + depth/ + scene/")
    p.add_argument("--bag", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--max_frames", type=int, default=0)
    args = p.parse_args(argv)
    n = process_bag(args.bag, args.out, args.max_frames)
    print(f"extracted {n} frames to {args.out}")


if __name__ == "__main__":
    main()
