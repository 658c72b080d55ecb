"""One run of one cell: set-up, the measured window of the program's SLAM
loop, the metrics, and the comparison with the plain reference.

The cell (``BENCHMARK.json``'s workload) names a configuration file
(``slambench/configs/<config>.json``: the Co-SLAM configuration as it is
run, and the sequence it reads) and a traffic file
(``slambench/traffic/<traffic>.json``: the loop, the window's phase, the
traced stretch and the sampled answers). Each metric is a reader in
``slambench/metrics/<name>.py`` (``read(run) -> number or None``), found
by the metric's name (a name ``<metric>.<qualifier>`` without a file of
its own is read by ``<metric>``'s reader: a cell added later names the
metrics it reports in entries of its own, listing it under
``workloads``). Limits of the comparison are in
``slambench/limits/<config>.json``.

The window is a stretch of the program's own ``CoSLAM.run``: the loop
runs from frame 0, and the benchmark watches it through its tracking
step, which it wraps (one call a frame, after the frame's wall is taken).
The window starts at a fixed frame phase (right after the first BA frame
with two keyframes), holds whole frames, and closes at the first frame
that starts ``seconds`` after it: the wrapper then raises, which ends
the loop before that frame's tracking. On sampled frames the wrapper
(and a wrapper of the BA call) also keeps what the reference needs to
follow the step: the map, the start pose, the rays and the generator's
state; the first frame's mapping (set-up) is kept the same way.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import check, data

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "coslam_tpu")


class WindowClosed(Exception):
    """Raised inside the loop when the window's time is up."""


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell_spec(root: str, workload: str) -> Dict:
    """The workload's entry, its configuration file, traffic file, limits
    and the metrics it reports."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"unknown workload {workload!r}")
    spec = cell_files(root, wl["config"], wl["traffic"])
    spec.update(workload=wl,
                end_to_end=[m for m in bench["end_to_end"]
                            if applies(m, workload)],
                per_layer=[m for m in bench["per_layer"]
                           if applies(m, workload)])
    return spec


def cell_files(root: str, config: str, traffic: str) -> Dict:
    """A configuration's file and limits, and a traffic file."""
    here = os.path.join(root, "slambench")
    return {"config_name": config,
            "config": load_json(os.path.join(here, "configs",
                                             config + ".json")),
            "traffic": load_json(os.path.join(here, "traffic",
                                              traffic + ".json")),
            "limits": load_json(os.path.join(here, "limits",
                                             config + ".json")),
            "end_to_end": [], "per_layer": []}


def window_start(cfg: Dict) -> int:
    """The frame after the first BA frame that sees two keyframes (the
    keyframes before BA on frame i are frames 0, k, 2k, ... below i)."""
    m, k = cfg["mapping"]["map_every"], cfg["mapping"]["keyframe_every"]
    i = m
    while (i - 1) // k + 1 < 2:
        i += m
    return i + 1


def reader(name: str) -> Callable:
    """The reader of metric ``name``: ``metrics/<name>.py``, or for a name
    ``<base>.<qualifier>`` without a file of its own, the reader of
    ``<base>``. So a cell that a later entry adds reports a quantity that
    other cells report under a name of its own (``track_ms.tum``, whose
    ``workloads`` list that cell), with no edit of the entries there."""
    base = name
    while (not os.path.isfile(os.path.join(HERE, "metrics", base + ".py"))
           and "." in base):
        base = base.rsplit(".", 1)[0]
    path = os.path.join(HERE, "metrics", base + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no reader for metric {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        "slambench_metric_" + base.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# What a run leaves for the metrics
# ---------------------------------------------------------------------------


class Run:
    """The window's record: the loop's frame walls and spans, the window's
    first and end frame, the frames left out of the host spans (the traced
    stretch and after), the traced stretch's figures, the configuration
    and its hash grid's layout (``reference.GridSpec``)."""

    def __init__(self, cfg, walls, timings, events, k0, k_end, setup_s,
                 excluded=(), stretch=None, grid=None):
        self.cfg = cfg
        self.walls = list(walls)
        self.timings = timings
        self.events = list(events)
        self.k0, self.k_end = k0, k_end
        self.setup_s = setup_s
        self.excluded = set(excluded)
        self.stretch = stretch
        self.grid = grid

    def frames(self, with_excluded: bool = False) -> List[int]:
        """The window's frames (without those left out)."""
        return [k for k in range(self.k0, self.k_end)
                if with_excluded or k not in self.excluded]

    def frame_s(self, k: int) -> float:
        return self.walls[k + 1] - self.walls[k]

    def window_s(self) -> float:
        return self.walls[self.k_end] - self.walls[self.k0]

    def ba_frames(self) -> List[int]:
        m = self.cfg["mapping"]["map_every"]
        return [k for k in self.frames() if k % m == 0]

    def ba_s(self, k: int) -> float:
        """The BA call of frame k (timings["mapping"] holds one a BA
        frame, from frame map_every on)."""
        return self.timings["mapping"][k // self.cfg["mapping"]["map_every"]
                                       - 1]

    def track_s(self, k: int) -> float:
        return self.timings["tracking"][k - 1]

    def events_in(self, k: int):
        lo, hi = self.walls[k], self.walls[k + 1]
        return [(a, b, t) for a, b, t in self.events if lo <= a < hi]


def p95(values) -> float:
    """The 95th percentile (linear between order statistics)."""
    return float(np.percentile(np.asarray(values, np.float64), 95))


# ---------------------------------------------------------------------------
# The window and the records for the reference
# ---------------------------------------------------------------------------


class Watch:
    """Wraps the loop's first-frame mapping, tracking step and BA call:
    opens and closes the window, starts and stops the traced stretch, and
    keeps the first frame's and the sampled steps' inputs and outputs."""

    def __init__(self, slam, k0: int, seconds: float, track_frames,
                 ba_frame: int, stretch=None):
        self.slam = slam
        self.k0, self.seconds = k0, seconds
        self.track_frames = set(track_frames)
        self.ba_frame = ba_frame
        self.stretch = stretch
        self.t0 = None
        self.k_end = None
        self.track_records: List[Dict] = []
        self.ba_record: Optional[Dict] = None
        self.first_record: Optional[Dict] = None
        self.track_spans: List = []
        self._step = slam._track_step
        self._first = slam._first_step
        slam._first_step = self.first
        bundle = self._ba = slam._ba
        self._ba_loss = bundle.loss
        self._ba_losses = None
        bundle.loss = self.ba_loss
        slam._track_step = self.track
        slam._ba = self.ba

    def frame(self) -> int:
        return len(self.slam.frame_walls) - 1

    def first(self, params, c2w, frame_rays, generator):
        """The first frame's mapping (set-up), kept whole for the
        reference, with the loss of its first iteration (the model's first
        forward of the call)."""
        rec = {"params": _clone(params), "c2w": c2w.clone(),
               "frame_rays": frame_rays, "gen_state": generator.get_state()}
        model = self.slam.model
        forward = model.forward

        def first_forward(*args, **kw):
            ret = forward(*args, **kw)
            if "loss0" not in rec:
                rec["loss0"] = float(total_loss(ret, self.slam.config))
            return ret

        model.forward = first_forward
        try:
            out = self._first(params, c2w, frame_rays, generator)
        finally:
            del model.forward
        rec["params_after"] = _clone(params)
        self.first_record = rec
        return out

    def track(self, params, c2w_init, rays, generator=None, align=None):
        k = self.frame()
        now = self.slam.frame_walls[-1]
        st = self.stretch
        if k == self.k0:
            self.t0 = now
        elif (self.t0 is not None and now - self.t0 >= self.seconds
              and (st is None or st.t1 is not None)):
            # A traced run's window stays open until its stretch is done.
            self.k_end = k
            raise WindowClosed
        if st is not None and k == st.first:
            st.start()
        elif st is not None and k == st.last:
            st.stop()
        rec = None
        if k in self.track_frames:
            rec = {"frame": k, "params": _clone(params),
                   "c2w_init": c2w_init.clone(), "rays": rays,
                   "gen_state": generator.get_state()}
        a = time.perf_counter()
        out = self._step(params, c2w_init, rays, generator, align)
        self.track_spans.append((a, time.perf_counter(), "track"))
        if rec is not None:
            rec["c2w"], rec["losses"] = out[0].clone(), out[1].clone()
            self.track_records.append(rec)
        return out

    def ba(self, params, kf_db, kf_poses, cur_pose, cur_rays, generator,
           kf_aligns=None, cur_align=None):
        k = self.frame()
        if k != self.ba_frame:
            return self._ba(params, kf_db, kf_poses, cur_pose, cur_rays,
                            generator, kf_aligns, cur_align)
        opt = self.slam.map_opt
        rec = {"frame": k, "params": _clone(params),
               "opt_state": _opt_state(opt, params),
               "kf_count": kf_db.count, "kf_rays": kf_db.rays,
               "kf_poses": kf_poses.clone(), "cur_pose": cur_pose.clone(),
               "cur_rays": cur_rays, "gen_state": generator.get_state()}
        self._ba_losses = []
        out = self._ba(params, kf_db, kf_poses, cur_pose, cur_rays,
                       generator, kf_aligns, cur_align)
        rec["losses"] = [x.detach().clone() for x in self._ba_losses]
        self._ba_losses = None
        rec["params_after"] = _clone(params)
        rec["kf_poses_after"], rec["cur_after"] = out[0].clone(), out[1].clone()
        self.ba_record = rec
        return out

    def ba_loss(self, *args, **kw):
        loss = self._ba_loss(*args, **kw)
        if self._ba_losses is not None:
            self._ba_losses.append(loss.detach())
        return loss


def total_loss(ret: Dict, cfg: Dict) -> torch.Tensor:
    """The weighted sum of a forward's loss terms (the steps' loss without
    the smoothness term)."""
    w = cfg["training"]
    return (w["rgb_weight"] * ret["rgb_loss"]
            + w["depth_weight"] * ret["depth_loss"]
            + w["sdf_weight"] * ret["sdf_loss"]
            + w["fs_weight"] * ret["fs_loss"]).detach()


def _clone(params: Dict) -> Dict:
    return {"grid": params["grid"].detach().clone(),
            "decoder": {k: [w.detach().clone() for w in v]
                        for k, v in params["decoder"].items()}}


def _opt_state(opt, params: Dict) -> Dict:
    """The map optimizer's Adam state of the table and of the decoder's
    tensors (sdf_net, then color_net), cloned."""
    def one(p):
        s = opt.state[p]
        return (s["exp_avg"].clone(), s["exp_avg_sq"].clone(),
                s["step"].clone() if torch.is_tensor(s["step"])
                else torch.tensor(float(s["step"])))
    dec = params["decoder"]["sdf_net"] + params["decoder"]["color_net"]
    return {"grid": one(params["grid"]), "decoder": [one(p) for p in dec]}


def sample_frames(traffic: Dict, k0: int, cfg: Dict, seed: int):
    """(tracked frames, BA frame) whose steps the reference follows, drawn
    from the seed among the window's first frames."""
    rng = np.random.default_rng([seed, 7])
    lo, hi = k0 + 1, k0 + int(traffic["sample_span"])
    track = sorted(int(v) for v in rng.choice(
        np.arange(lo, hi), size=int(traffic["track_samples"]),
        replace=False))
    m = cfg["mapping"]["map_every"]
    ba = [f for f in range(lo, hi) if f % m == 0]
    return track, int(rng.choice(ba))


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------


def build_config(cfgfile: Dict, seed: int, datadir: str, outdir: str,
                 overrides: Optional[Dict] = None) -> Dict:
    cfg = copy.deepcopy(cfgfile["config"])
    for group, vals in (overrides or {}).items():
        cfg[group].update(vals)
    cfg["data"].update(datadir=datadir, output=outdir, exp_name="run")
    cfg["seed"] = int(seed)
    return cfg


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", root: str = ROOT,
             overrides: Optional[Dict] = None,
             traffic_overrides: Optional[Dict] = None,
             sequence_overrides: Optional[Dict] = None,
             control: bool = False, hook: Optional[Callable] = None,
             spec: Optional[Dict] = None) -> Dict:
    """One run of a cell. Returns the result line's dict (and, with
    ``control``, the control's readings beside the program's under
    "control"). ``hook(slam)`` is called before the loop starts (the
    fault tests break the program there). ``spec``: the cell's files, in
    place of the workload's in BENCHMARK.json (``cell_files``)."""
    spec = spec or cell_spec(root, workload)
    cfgfile, traffic = spec["config"], dict(spec["traffic"])
    traffic.update(traffic_overrides or {})
    seq = dict(cfgfile["sequence"], **(sequence_overrides or {}))
    dev = torch.device(device)
    from coslam_torch.data.datasets import get_dataset
    from coslam_torch.runtime.slam import CoSLAM

    datadir = data.ensure_frames(root, spec["config_name"],
                                 build_config(cfgfile, seed, "", "",
                                              overrides), seq, dev)
    outdir = tempfile.mkdtemp(prefix="slambench-run-")
    try:
        cfg = build_config(cfgfile, seed, datadir, outdir, overrides)
        dataset = get_dataset(cfg)
        slam = CoSLAM(cfg, dataset, device=dev)
        k0 = window_start(cfg)
        track_frames, ba_frame = sample_frames(traffic, k0, cfg, seed)
        stretch = None
        if trace:
            from .stretch import Stretch

            stretch = Stretch(k0 + int(traffic["trace_offset"]),
                              int(traffic["trace_frames"]), outdir, dev)
        if hook is not None:
            hook(slam)
        watch = Watch(slam, k0, seconds, track_frames, ba_frame, stretch)
        try:
            slam.run(verbose=False, eval_ate=True, mesh=False)
        except WindowClosed:
            pass
        except BaseException:
            if stretch is not None:
                stretch.abandon()
            raise
        slam._mesh_worker.wait()
        _sync(dev)
        if watch.k_end is None:
            raise RuntimeError("the sequence ended before the window closed")
        if stretch is not None and stretch.t1 is None:
            raise RuntimeError("the window closed before the traced stretch "
                               "ended")
        memory_peak = (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else 0)
        walls = slam.frame_walls[:watch.k_end + 1]
        # The profiler's cost outlasts its stretch: the host spans of a
        # traced run are read from the frames before it.
        excluded = (range(stretch.first, watch.k_end)
                    if stretch is not None else ())
        stretch_read = None
        if stretch is not None:
            spans = watch.track_spans + [e for e in slam.frame_events]
            stretch_read = stretch.read(spans)
        run = Run(cfg, walls, slam.timings, slam.frame_events, k0,
                  watch.k_end, walls[k0] - t_start, excluded,
                  stretch_read, check.model_spec(cfg))
        ate = _ate(slam, watch.k_end)
        losses = np.asarray(slam.losses["tracking"], np.float64)
        failed = int(sum(1 for k in run.frames(True)
                         if not np.all(np.isfinite(slam.est_c2w[k]))
                         or not math.isfinite(losses[k - 1])))
        # The reference reads the program's records and its final map.
        program = {"model": slam.model, "params": slam.params,
                   "tracks": watch.track_records, "ba": watch.ba_record,
                   "first": watch.first_record,
                   "track_frames": track_frames, "ba_frame": ba_frame}
        del slam, watch, dataset
        _free(dev)
        numbers = check.compare(cfg, program, seed, dev, control)
        limits = spec["limits"]
        correct = check.correct(numbers["program"], limits)
        metrics = {}
        for m in (spec["per_layer"] if trace else spec["end_to_end"]):
            v = reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                       "kind": (torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu"),
                       "count": 1, "memory_peak_bytes": int(memory_peak)}
        result = {"correct": bool(correct and failed == 0),
                  "attempted": len(run.frames(True)), "failed": failed,
                  "metrics": metrics, "device": device_info}
        if stretch_read is not None:
            device_info["busy_s"] = stretch_read["busy_s"]
            device_info["window_s"] = stretch_read["window_s"]
            result["breakdown"] = breakdown(stretch_read)
        result["info"] = {"window_frames": len(run.frames(True)),
                          "window_s": run.window_s(),
                          "frame_samples": len(run.frames()),
                          "ate_rmse_m": ate, "seed": seed}
        result["info"]["details"] = dict(
            numbers["details"], **{n: v for n, v in numbers["program"].items()
                                   if n not in limits})
        result["checks"] = {n: {"value": numbers["program"].get(n),
                                "limit": lim} for n, lim in limits.items()}
        if control:
            result["control"] = numbers["control"]
            result["control_details"] = numbers["control_details"]
        return result
    finally:
        shutil.rmtree(outdir, ignore_errors=True)


def breakdown(st: Dict) -> Dict:
    ops = sorted(st["kernel_s"].items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(st["idle_s"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:64], v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}


def _ate(slam, n: int) -> Optional[float]:
    """The ATE RMSE (m) of the frames tracked so far (the loop's final
    ATE, of the frames before the window closed)."""
    try:
        res = slam.evaluate_ate(n)
        return float(res["absolute_translational_error.rmse"])
    except Exception as e:  # a report line, not a metric
        print(f"ATE not computed: {e!r}", file=sys.stderr)
        return None


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _free(dev) -> None:
    import gc

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})
