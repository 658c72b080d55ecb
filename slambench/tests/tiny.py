"""A cell cut to a few pixels and iterations, for runs on the CPU."""

import time

from slambench import harness

OVERRIDES = {
    "replica_room0": {
        "cam": {"H": 24, "W": 40, "fx": 20.0, "fy": 20.0, "cx": 19.5,
                "cy": 11.5},
    },
    "tum_fr1_desk": {
        # fr1_desk's camera at a twentieth of its size (its lens
        # distortion holds over the same field of view).
        "cam": {"H": 24, "W": 32, "fx": 25.865, "fy": 25.825, "cx": 15.93,
                "cy": 12.765, "crop_size": [24, 32], "crop_edge": 2},
        "training": {"n_importance": 8},
    },
}
COMMON = {
    "mapping": {"sample": 64, "first_iters": 30, "iters": 3,
                "min_pixels_cur": 8},
    "tracking": {"sample": 32, "iter": 3, "ignore_edge_W": 2,
                 "ignore_edge_H": 2},
    "training": {"n_samples_d": 8, "n_range_d": 5, "smooth_pts": 5},
    "grid": {"hash_size": 10, "voxel_sdf": 32},
    "mesh": {"voxel_eval": 0.15},
    "data": {"num_workers": 1},
}
TRAFFIC = {"sample_span": 8, "track_samples": 2, "trace_offset": 6,
           "trace_frames": 3}
SEQUENCE = {"period": 20, "frames": 400}


def overrides(config: str):
    out = {k: dict(v) for k, v in COMMON.items()}
    for k, v in OVERRIDES[config].items():
        out.setdefault(k, {}).update(v)
    return out


def run(config: str, seed: int = 3, seconds: float = 2.0,
        trace: bool = False, root: str = harness.ROOT, device: str = "cpu",
        **kw):
    """One run of ``config`` under traffic ``seq``, cut to size."""
    spec = harness.cell_files(root, config, "seq")
    spec["per_layer"] = [
        {"name": n, "unit": "-"} for n in (
            "loop_self_ms", "track_ms", "ba_ms.p95", "launches_per_frame",
            "kernA_roofline",
            "kernB_roofline", "step_mfu_pct", "device_idle_pct")]
    spec["end_to_end"] = [{"name": n, "unit": "-"}
                          for n in ("fps", "frame_ms_p95", "setup_s")]
    return harness.run_cell(config + ".seq", seed, seconds, trace,
                            time.perf_counter(), device=device, root=root,
                            overrides=overrides(config),
                            traffic_overrides=TRAFFIC,
                            sequence_overrides=SEQUENCE, spec=spec, **kw)
