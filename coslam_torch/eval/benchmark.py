"""Full benchmark protocol: SLAM -> mesh culling -> Acc/Comp/Ratio/L1 + ATE.

The port's own copy of coslam_tpu/eval/benchmark.py: the reference's
evaluation recipe (evaluation/README.md: cull_mesh.py with the Co-SLAM
strategy, then eval_recon.py -2d -3d, with the ATE of the run) as one
call. The SLAM half runs on ``device``; the evaluation half is the host's
numpy and native rasterizer, as in the JAX package.

Unlike the JAX package, the virtual cameras of the Co-SLAM culling are
regenerated unless their directory holds a MANIFEST saying they came
from the ground-truth trajectory (tools/virtual_cameras.py), so a set
made any other way, or a set of zero cameras without a manifest, is not
reused silently; the count in use is logged either way.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np


def run_benchmark(config: Dict, gt_mesh_path: Optional[str] = None,
                  n_frames: Optional[int] = None,
                  culling: str = "frustum_occlusion",
                  n_eval_views: int = 200, out_path: Optional[str] = None,
                  dataset=None, device="cuda", slam_cls=None) -> Dict:
    """Run SLAM on a scene (``dataset``, or the config's loader) and
    evaluate trajectory + reconstruction. ``slam_cls``: the runtime
    (default CoSLAM; PipelinedCoSLAM, ActiveCoSLAM).

    culling: 'frustum' | 'frustum_occlusion' | 'coslam' (adds virtual
    cameras from <datadir>/virtual_cameras). Returns the metric dict
    {ate_rmse_cm, acc_cm, comp_cm, comp_ratio_pct, depth_l1_cm,
    runtime_s, tracking_ms, mapping_ms, n_params, ...}.
    """
    from ..runtime.checkpoint import param_leaves
    from ..runtime.slam import CoSLAM

    slam = (slam_cls or CoSLAM)(config, dataset, device=device)
    t0 = time.perf_counter()
    ate = slam.run(n_frames=n_frames, verbose=False, eval_ate=True)
    runtime = time.perf_counter() - t0

    results = {
        "runtime_s": round(runtime, 1),
        "n_params": int(sum(p.numel() for p in param_leaves(slam.params))),
    }
    if ate is not None:
        results["ate_rmse_cm"] = round(
            ate["absolute_translational_error.rmse"] * 100, 3)
        results["ate_rmse_noalign_cm"] = round(
            ate["absolute_translational_error.rmse_noalign"] * 100, 3)
    for phase in ("tracking", "mapping"):
        vals = slam.timings[phase][1:] or slam.timings[phase]
        if vals:
            results[f"{phase}_ms"] = round(1e3 * float(np.mean(vals)), 2)
    results.update(evaluate_run(config, slam.est_c2w, slam.dataset.poses,
                                gt_mesh_path, culling, n_eval_views,
                                n_frames or len(slam.dataset)))
    if out_path:
        with open(out_path, "w") as f:
            json.dump(results, f, indent=2)
    return results


def evaluate_run(config: Dict, est_c2w: np.ndarray, gt_poses,
                 gt_mesh_path: Optional[str], culling: str,
                 n_eval_views: int, n_frames: int) -> Dict:
    """The evaluation half of run_benchmark on one SLAM output: the final
    mesh ``<output>/<exp_name>/mesh_track{n_frames - 1}.ply``, the
    estimated poses ``est_c2w`` and the ground-truth trajectory
    ``gt_poses``: cull both meshes, then Acc/Comp/Ratio and depth-L1
    (with its surface and hole split). {} without a GT mesh or a mesh."""
    from .cull import cull_one_mesh
    from .recon import calc_2d_metric, calc_3d_metric

    out_dir = os.path.join(config["data"]["output"],
                           config["data"]["exp_name"])
    rec_mesh = os.path.join(out_dir, f"mesh_track{n_frames - 1}.ply")
    if not (gt_mesh_path and os.path.exists(rec_mesh)):
        return {}
    results = {}
    # Skip never-tracked frames (all-zero slots).
    poses = [est_c2w[i] for i in range(len(est_c2w))
             if np.any(est_c2w[i] != 0)]
    gt_traj = [np.asarray(p) for p in gt_poses]
    culled = rec_mesh.replace(".ply", "_culled.ply")
    bounds = np.array(config["mapping"]["marching_cubes_bound"])
    if culling == "coslam":
        results["virtual_cameras"] = ensure_virtual_cameras(
            config, gt_mesh_path, gt_traj)
    cull_one_mesh(config, poses, rec_mesh, culled,
                  save_unseen=True,
                  remove_occlusion=(culling != "frustum"),
                  virtual_cameras=(culling == "coslam"),
                  scene_bounds=np.stack([bounds[:, 0], bounds[:, 1]]))
    # Cull the GT mesh with the GT trajectory so completion is measured
    # over the observed region only (the reference evaluates against
    # pre-culled GT meshes).
    gt_culled = os.path.join(out_dir, "gt_culled.ply")
    cull_one_mesh(config, gt_traj, gt_mesh_path, gt_culled,
                  remove_occlusion=(culling != "frustum"),
                  scene_bounds=np.stack([bounds[:, 0], bounds[:, 1]]))
    m3 = calc_3d_metric(culled, gt_culled, align=False)
    results.update(acc_cm=round(m3["acc"], 3),
                   comp_cm=round(m3["comp"], 3),
                   comp_ratio_pct=round(m3["comp ratio"], 2))
    scene_name = os.path.basename(culled).split("_")[0]
    unseen = os.path.join(os.path.dirname(culled),
                          f"{scene_name}_pc_unseen.npy")
    m2 = calc_2d_metric(culled, gt_culled,
                        unseen_gt_pcd_file=unseen if os.path.exists(unseen)
                        else None,
                        align=False, n_imgs=n_eval_views)
    results["depth_l1_cm"] = round(m2["depth l1"], 3)
    if "depth l1 surface" in m2:
        # surface: both-hit pixels only; hole_px_pct: gt-valid pixels the
        # culled reconstruction misses (|gt - 0| inflates the metric).
        results["depth_l1_surface_cm"] = round(m2["depth l1 surface"], 3)
        results["rec_hole_px_pct"] = m2["hole_px_pct"]
    return results


def ensure_virtual_cameras(config: Dict, gt_mesh_path: str, gt_traj) -> int:
    """The virtual cameras of <datadir>/virtual_cameras: kept when the
    MANIFEST says they came from the ground-truth trajectory, else (no
    manifest, or another source) cleared and made anew from the GT mesh
    and the GT trajectory (a fixed per-scene input, as the reference ships
    them; the run's estimate would make a different set each seed).
    Returns the count in use, which is logged."""
    from ..mesh.io import load_ply
    from ..tools import virtual_cameras as VC

    vdir = os.path.join(config["data"]["datadir"], "virtual_cameras")
    manifest = VC.read_manifest(vdir)
    if manifest is not None and manifest.get("SOURCE") == "gt-traj":
        count = int(manifest["SELECTED"])
        print(f"virtual cameras: {count} from {vdir} (gt-traj)", flush=True)
        return count
    stale = VC.clear_cameras(vdir) if os.path.isdir(vdir) else 0
    cam = config["cam"]
    chosen = VC.create_virtual_cameras(
        load_ply(gt_mesh_path), gt_traj, vdir, cam["fx"], cam["fy"],
        cam["cx"], cam["cy"], cam["H"], cam["W"], n_candidates=64,
        n_select=16, source="gt-traj")
    print(f"virtual cameras: made {len(chosen)} in {vdir} from the GT "
          f"trajectory ({'no manifest' if manifest is None else 'source ' + manifest.get('SOURCE', '?')}; "
          f"{stale} stale removed)", flush=True)
    return len(chosen)


def main(argv=None):
    import argparse

    from ..config import load_config

    p = argparse.ArgumentParser(description="full benchmark protocol")
    p.add_argument("--config", required=True)
    p.add_argument("--gt_mesh", default=None)
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--culling", default="frustum_occlusion",
                   choices=["frustum", "frustum_occlusion", "coslam"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    res = run_benchmark(load_config(args.config), args.gt_mesh,
                        n_frames=args.max_frames, culling=args.culling,
                        out_path=args.out, device=args.device)
    print(json.dumps(res, indent=2))


if __name__ == "__main__":
    main()
