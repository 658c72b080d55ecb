"""Co-SLAM sequential loop on PyTorch tensors.

Counterpart of coslam_tpu/runtime/slam.py:CoSLAM.run (the sequential
loop): first-frame mapping, tracking of every frame from the
constant-speed prediction (after point-cloud tracking when
``tracking.iter_point`` > 0), BA every ``mapping.map_every`` frames
(after the current-frame step when ``mapping.cur_frame_iters`` > 0), a
keyframe every ``mapping.keyframe_every`` frames, the periodic mesh and
ATE every ``mesh.vis`` frames, a resumable checkpoint every
``ckpt_every`` frames, then the final checkpoint, mesh and ATE
(absolute, and from the keyframe-relative poses). Everything runs on
tensors on ``device``; the host reads one packed [pose, loss, psnr] array
per tracked frame and one per BA call.

Tracking's pixels are a uniform draw, or with
``tracking.sample_info_frac`` > 0 one weighted by the image gradient
(:meth:`CoSLAM._info_weights`), from a numpy stream keyed by (seed,
frame id), the JAX package's draw. The loop records ``frame_walls`` (one
time a frame) and ``frame_events`` (spans around the checkpoint, BA,
keyframe and mesh steps) for runtime/latency.attribute_tails. Every span
of the run goes through one recorder (:attr:`CoSLAM.spans`,
runtime/spans.py), which also fills ``timings``: the wall of each call
of the first-frame mapping, tracking, BA and the mesh, each step's
forward, backward, update and wait on the card (``<step>.forward`` and
so on: a call's sums over its iterations; with an importance fine pass
also ``<step>.fine``), a mesh's phases (``mesh.query``, ``.mcubes``,
``.color``, ``.export``: a mesh's sums), each periodic mesh job's wall
(``mesh_job``: the mesh.vis mesh with its ATE, ``ate``; one entry a
job, in the order of the loop's ``mesh_eval`` events that submit them),
and a frame's wait for the prefetcher (``load_wait``) and its frame
blocks (``frame_block``).

Frames come through a :class:`PrefetchIterator` (``data.num_workers``
loader threads, frames handed over in order). The periodic mesh and ATE
run on a single-flight worker thread (``mesh.async_vis``, default true;
false keeps them in the loop): the parameters are cloned on the loop's
stream and the pose tables copied on the host when the job is submitted,
so the next frames' steps do not change what the job reads (an event
recorded after the clones, which the worker's stream waits on, orders
the clones before the job on any stream). With
``training.frame_align`` the loop keeps the exposure parameters
(ops/frame_align.py): the current frame's [4], optimized by tracking
with the pose, and the keyframes' [num_kf, 4], optimized by BA; a new
keyframe takes the current frame's.

``parallel.dp`` > 1 splits every step's rays over the first dp devices
(parallel/sharding.py; tracking.sample and mapping.sample must divide by
dp); the parameters, the optimizers, the keyframes and the generator
live on the first, which the checkpoint reads. ``mesh.visualisation``
writes each frame's [rgb | depth] composite under ``vis/``
(:meth:`CoSLAM.visualise_frame`).

Resuming (``load_checkpoint``, then ``run(start_frame=cursor)``) gives
the straight run's bits when every step adds in a fixed order: on the CPU
always; on the card under ``torch.use_deterministic_algorithms(True)``
(with ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before cuBLAS starts),
which takes kernels B's and D's serial modes and H. The checkpoint holds
the map, both pose tables, the keyframe reservoir, the map optimizer's
Adam state, the generator's state and, with frame_align, the exposure
parameters; tracking's pixels (and point-cloud tracking's) come from
numpy streams keyed by (seed, frame id), so they need no state. Like the
JAX package, it does not hold the current-frame optimizer's moments.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import convert
from ..data.prefetch import PrefetchIterator
from ..models.scene_rep import JointEncoding
from ..ops.frame_align import init_frame_align
from ..parallel.sharding import check_divisible, make_devices, on_device
from .checkpoint import (AsyncCheckpointWriter, SingleFlightWorker, _clone,
                         load_ckpt, param_leaves, save_ckpt)
from .keyframe import KeyFrameDatabase
from .mapping import (BundleAdjust, make_current_frame_step,
                      make_first_frame_step)
from .optim import make_cur_map_optimizer, make_map_optimizer
from .spans import MESH_PHASES, Spans, phases
from .tracking import (make_tracking_pc_step, make_tracking_step,
                       predict_current_pose)


def dp_of(config: Dict) -> int:
    """``parallel.dp`` (1 when unset)."""
    return int((config.get("parallel") or {}).get("dp", 1) or 1)


def _record_event(device: torch.device):
    """A CUDA event recorded on the current stream of ``device`` (None on
    the CPU, where there are no streams)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def _wait_event(device: torch.device, event):
    """Make the current stream of ``device`` wait for ``event`` (queued
    on the card, the host does not wait); returns that stream (None on the
    CPU)."""
    if event is None:
        return None
    stream = torch.cuda.current_stream(device)
    stream.wait_event(event)
    return stream


class CoSLAM:
    def __init__(self, config: Dict, dataset=None, device="cuda"):
        self.config = config
        # parallel.dp: the devices the tracking and the mapping steps split
        # their rays over; the first of map_devices (the master) holds the
        # parameters, the optimizers, the keyframes and the generator.
        self.track_devices, self.map_devices = self._placement(
            config, device)
        if dataset is None:
            from ..data.datasets import get_dataset
            dataset = get_dataset(config)
        self.dataset = dataset
        self.device = self.map_devices[0]
        self.track_device = self.track_devices[0]
        self.bounding_box = np.array(config["mapping"]["bound"], np.float32)
        self.marching_cube_bound = np.array(
            config["mapping"]["marching_cubes_bound"], np.float32)

        n = dataset.num_frames
        self.est_c2w = np.zeros((n, 4, 4), np.float32)
        # Non-keyframe poses relative to their keyframe's, as tracked
        # (frame 0: its absolute pose); convert_relative_pose composes them.
        self.est_c2w_rel: Dict[int, np.ndarray] = {}
        self.pose_gt = {i: np.asarray(p, np.float32)
                        for i, p in enumerate(dataset.poses)}

        seed = int(config.get("seed", 0))
        self._seed = seed
        # One generator on the device for every draw of the run (ray
        # indices, perturbations, lattices, keyframe subsets), one on the
        # CPU for the parameter init (device-independent values).
        # Tracking draws from track_generator: the same generator here,
        # one of its own in the pipelined runtime.
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.track_generator = self.generator
        self.model = self._make_model(config)
        self.params = self.model.init_params(
            torch.Generator().manual_seed(seed))
        self.map_opt = make_map_optimizer(config, self.params)

        num_kf = int(n // config["mapping"]["keyframe_every"] + 1)
        self.kf_db = KeyFrameDatabase(config, num_kf, dataset.num_rays_to_save,
                                      self.device)
        self.kf_poses = torch.eye(4, device=self.device).repeat(num_kf, 1, 1)
        # The exposure parameters (None without training.frame_align).
        self.kf_aligns = self.cur_align = None
        if config["training"].get("frame_align", False):
            self.kf_aligns = init_frame_align(num_kf, self.device)
            self.cur_align = torch.tensor([1.0, 1.0, 1.0, 0.0],
                                          device=self.device)
        # Each span of the run: the steps' walls and phases (timings), the
        # loop's events (frame_events) and, under torch.profiler, ranges.
        self.spans = Spans()
        self.timings.update({"first_frame": [], "tracking": [],
                             "mapping": [], "mesh": []})
        # The steps' fine passes are phases of their own (<step>.fine).
        self._fine = self.model.n_importance > 0
        track, mapping = self.track_devices, self.map_devices
        self._track_step = make_tracking_step(self.model, config, track,
                                              self.spans)
        self._track_pc_step = (make_tracking_pc_step(self.model, config,
                                                     track)
                               if config["tracking"]["iter_point"] > 0
                               else None)
        self._first_step = make_first_frame_step(self.model, config,
                                                 self.map_opt, mapping,
                                                 self.spans)
        self._ba = BundleAdjust(self.model, config, self.map_opt, num_kf,
                                mapping, self.spans)
        self.cur_map_opt = self._cur_step = None
        if config["mapping"]["cur_frame_iters"] > 0:
            self.cur_map_opt = make_cur_map_optimizer(config, self.params)
            self._cur_step = make_current_frame_step(self.model, config,
                                                     self.cur_map_opt,
                                                     mapping)
        self._ckpt_writer = AsyncCheckpointWriter()
        self._mesh_worker = SingleFlightWorker(name="mesh-eval")
        self.losses = {"first_frame": [], "tracking": [], "mapping": []}
        self.final_mesh = None
        # runtime/latency.py's inputs: a time at each frame's start and
        # (t0, t1, tag) spans around the steps that make frames slow
        # (frame_events, the recorder's events).
        self.frame_walls = []
        # Guards the pose tables' writes against another thread's copy
        # (the pipelined tracker writes while the mapper checkpoints).
        self._pose_lock = threading.Lock()
        # (loss, psnr, pose L1 against the ground truth) of the last
        # tracked frame.
        self._last_track_info = (float("nan"),) * 3

    def _make_model(self, config: Dict):
        """Hook for variants (ActiveCoSLAM builds the beta-head model)."""
        return JointEncoding(config, self.bounding_box, self.device)

    def _placement(self, config: Dict, device):
        """(tracking's devices, mapping's devices) for ``parallel.dp``:
        both the first dp devices (parallel/sharding.make_devices, which
        raises past the visible count), after the JAX package's check
        that tracking.sample and mapping.sample divide by dp."""
        dp = dp_of(config)
        devices = make_devices(dp, device)
        if dp > 1:
            check_divisible(config, dp)
        return devices, devices

    @property
    def timings(self) -> Dict:
        """The recorder's timings: name -> one wall (s) a call."""
        return self.spans.timings

    @property
    def frame_events(self) -> list:
        """The recorder's events: (t0, t1, tag), the host's time of a
        step (its work on the card may land in a later frame, which
        latency.attribute_tails looks back for)."""
        return self.spans.events

    @frame_events.setter
    def frame_events(self, events: list) -> None:
        self.spans.events = events

    # -- frames -----------------------------------------------------------------

    def _frame_block(self, batch: Dict) -> torch.Tensor:
        """[H*W, 7] = [direction, rgb, depth] on the device (a span
        ``frame_block``: the host's concatenation and cast, and the
        upload)."""
        with self.spans.span("frame_block"):
            block = np.concatenate(
                [np.asarray(batch["direction"]).reshape(-1, 3),
                 np.asarray(batch["rgb"]).reshape(-1, 3),
                 np.asarray(batch["depth"]).reshape(-1, 1)], axis=1)
            return torch.from_numpy(block.astype(np.float32)).to(
                self.device)

    def _frame_rays_flat(self, batch: Dict) -> np.ndarray:
        """[H*W, 7] = [direction, rgb, depth] on the host."""
        return np.concatenate(
            [np.asarray(batch["direction"]).reshape(-1, 3),
             np.asarray(batch["rgb"]).reshape(-1, 3),
             np.asarray(batch["depth"]).reshape(-1, 1)],
            axis=1).astype(np.float32)

    def _draw_rays(self, batch: Dict, S: int, stream: int,
                   p: Optional[np.ndarray] = None) -> torch.Tensor:
        """S pixels of the edge-cropped image without replacement (with
        the probabilities ``p`` over its pixels, or uniform), drawn from a
        numpy stream keyed by (seed, frame id[, stream]) -> [S, 7] on the
        host (the caller moves it to tracking's device)."""
        iH = self.config["tracking"]["ignore_edge_H"]
        iW = self.config["tracking"]["ignore_edge_W"]
        direction = batch["direction"]
        H, W = direction.shape[:2]
        cw = W - 2 * iW
        key = (self._seed, int(batch["frame_id"])) + ((stream,) if stream
                                                       else ())
        idx = np.random.default_rng(key).choice(
            (H - 2 * iH) * cw, size=min(S, (H - 2 * iH) * cw), replace=False,
            p=p)
        r, c = idx // cw + iH, idx % cw + iW
        rays = np.concatenate([direction[r, c], np.asarray(batch["rgb"])[r, c],
                               np.asarray(batch["depth"])[r, c, None]], 1)
        return torch.from_numpy(rays.astype(np.float32))

    def _sample_tracking_rays(self, batch: Dict) -> torch.Tensor:
        """``tracking.sample`` pixels, drawn as in the JAX package (a
        stream keyed by (seed, frame id)); with
        ``tracking.sample_info_frac`` > 0, weighted by
        :meth:`_info_weights`."""
        tcfg = self.config["tracking"]
        frac = float(tcfg.get("sample_info_frac", 0.0) or 0.0)
        p = (self._info_weights(batch, tcfg["ignore_edge_H"],
                                tcfg["ignore_edge_W"], frac)
             if frac > 0.0 else None)
        return self._draw_rays(batch, tcfg["sample"], 0, p)

    def _info_weights(self, batch: Dict, iH: int, iW: int,
                      frac: float) -> np.ndarray:
        """The sampling probabilities over the edge-cropped image, flat:
        ``frac`` parts image-gradient weight and ``1 - frac`` parts
        uniform (coslam_tpu's _info_weights). The weight is |grad gray| +
        |grad depth|, each over its own mean; pixels without a valid
        depth keep only the gray term."""
        gray = np.asarray(batch["rgb"], np.float32).mean(-1)
        depth = np.asarray(batch["depth"], np.float32)
        H, W = depth.shape
        gray = gray[iH:H - iH, iW:W - iW]
        depth = depth[iH:H - iH, iW:W - iW]
        gy, gx = np.gradient(gray)
        gg = np.hypot(gx, gy)
        dy, dx = np.gradient(depth)
        gd = np.where(depth > 0.0, np.hypot(dx, dy), 0.0)
        w = (gg / max(float(gg.mean()), 1e-12)
             + gd / max(float(gd.mean()), 1e-12)).ravel().astype(np.float64)
        p = frac * w / max(float(w.sum()), 1e-12)
        p += (1.0 - frac) / p.size
        return p / p.sum()

    def _pc_rays(self, batch: Dict) -> torch.Tensor:
        """Point-cloud tracking's ``tracking.pc_samples`` pixels (a stream
        keyed by (seed, frame id, 1); the JAX package draws them from its
        numpy generator's state)."""
        return self._draw_rays(batch, self.config["tracking"]["pc_samples"],
                               1)

    # -- phases -----------------------------------------------------------------

    def first_frame_mapping(self, batch: Dict) -> float:
        with self.spans.span("first_frame", timed=True,
                             sums=phases("first_frame", self._fine)):
            c2w = np.asarray(batch["c2w"], np.float32)
            self.est_c2w[0] = c2w
            self.est_c2w_rel[0] = c2w
            frame_rays = self._frame_block(batch)
            loss, _ = self._first_step(self.params,
                                       torch.from_numpy(c2w).to(self.device),
                                       frame_rays, self.generator)
            self.add_keyframe(batch, frame_rays)
            with self.spans.span("first_frame.wait"):
                loss = float(loss)  # waits for the device
        self.losses["first_frame"].append(loss)
        return loss

    def _predict(self, frame_id: int) -> np.ndarray:
        prev = self.est_c2w[frame_id - 1]
        prev_prev = self.est_c2w[frame_id - 2] if frame_id >= 2 else None
        return predict_current_pose(prev, prev_prev,
                                    self.config["tracking"]["const_speed"])

    def tracking_pc(self, batch: Dict, frame_id: int,
                    params: Optional[Dict] = None) -> float:
        """Point-cloud tracking from the motion-model prediction
        (tracking.iter_point > 0; coslam_tpu's tracking_pc): writes the
        frame's pose, which tracking_render then starts from. ``params``:
        the map to track against (default self.params)."""
        c2w, loss = self._track_pc_step(
            self.params if params is None else params,
            torch.from_numpy(self._predict(frame_id)).to(self.track_device),
            self._pc_rays(batch).to(self.track_device))
        packed = torch.cat([c2w.reshape(-1), loss[None]]).cpu().numpy()
        self.est_c2w[frame_id] = packed[:16].reshape(4, 4)
        return float(packed[16])

    def tracking_render(self, batch: Dict, frame_id: int,
                        params: Optional[Dict] = None,
                        c2w_init: Optional[np.ndarray] = None) -> float:
        """Track the frame (coslam_tpu's tracking_render). ``params``: the
        map to track against (default self.params; the pipelined tracker
        passes its snapshot). ``c2w_init``: the start pose (default: the
        point-cloud tracking's pose, or the motion-model prediction;
        ActiveCoSLAM passes its own for frames out of sequence)."""
        with self.spans.span("tracking", timed=True,
                             sums=(*phases("tracking", self._fine),
                                   "tracking.replay")):
            loss = self._tracking_render(batch, frame_id, params, c2w_init)
        self.losses["tracking"].append(loss)
        return loss

    def _tracking_render(self, batch: Dict, frame_id: int,
                         params: Optional[Dict],
                         c2w_init: Optional[np.ndarray]) -> float:
        if c2w_init is None:
            # After point-cloud tracking the frame's pose is its start.
            c2w_init = (self.est_c2w[frame_id]
                        if self._track_pc_step is not None
                        else self._predict(frame_id))
        c2w_init = torch.from_numpy(np.array(c2w_init, np.float32)).to(
            self.track_device)
        c2w, losses, psnrs, self.cur_align = self._track_step(
            self.params if params is None else params, c2w_init,
            self._sample_tracking_rays(batch).to(self.track_device),
            self.track_generator,
            self.cur_align)
        finite = torch.isfinite(c2w).all()
        # A non-finite pose would poison every later frame through the
        # prediction and BA: keep the motion-model prediction instead.
        c2w = torch.where(finite, c2w, c2w_init)
        with self.spans.span("tracking.wait"):
            packed = torch.cat([c2w.reshape(-1), losses[-1:], psnrs[-1:],
                                finite.float()[None]]).cpu().numpy()
        c2w = packed[:16].reshape(4, 4)
        kf_every = self.config["mapping"]["keyframe_every"]
        with self._pose_lock:
            self.est_c2w[frame_id] = c2w
            c2w_key = self.est_c2w[(frame_id // kf_every) * kf_every]
            # ActiveCoSLAM tracks frames out of sequence: a keyframe slot
            # not tracked yet (all zero) gives no relative pose.
            if frame_id % kf_every != 0 and np.any(c2w_key):
                self.est_c2w_rel[frame_id] = (
                    c2w.astype(np.float64)
                    @ np.linalg.inv(c2w_key.astype(np.float64))
                ).astype(np.float32)
        if packed[18] == 0.0:
            print(f"tracking produced a non-finite pose at frame {frame_id}; "
                  "keeping the motion-model prediction")
        gt = self.pose_gt.get(frame_id)
        err = (float(np.abs(c2w[:3] - gt[:3]).mean())
               if gt is not None and np.all(np.isfinite(gt))
               else float("nan"))
        self._last_track_info = (float(packed[16]), float(packed[17]), err)
        return float(packed[16])

    def current_frame_mapping(self, batch: Dict,
                              cur_frame_id: int) -> Optional[float]:
        """The grid-only refinement on the current frame at its tracked
        pose (coslam_tpu's current_frame_mapping); None unless
        mapping.cur_frame_iters > 0."""
        if self._cur_step is None:
            return None
        loss = self._cur_step(
            self.params, torch.from_numpy(self.est_c2w[cur_frame_id]).to(
                self.device), self._frame_block(batch), self.generator)
        return float(loss)

    def global_BA(self, batch: Dict, cur_frame_id: int) -> float:
        with self.spans.span("mapping", timed=True,
                             sums=phases("mapping", self._fine)):
            loss = self._global_BA(batch, cur_frame_id)
        self.losses["mapping"].append(loss)
        return loss

    def _global_BA(self, batch: Dict, cur_frame_id: int) -> float:
        cur_pose = torch.from_numpy(self.est_c2w[cur_frame_id]).to(self.device)
        kf_poses, new_cur, loss, self.kf_aligns, self.cur_align = self._ba(
            self.params, self.kf_db, self.kf_poses, cur_pose,
            self._frame_block(batch), self.generator, self.kf_aligns,
            self.cur_align)
        self.kf_poses = kf_poses
        count = self.kf_db.count
        with self.spans.span("mapping.wait"):
            packed = torch.cat([kf_poses[:count].reshape(-1),
                                new_cur.reshape(-1), loss[None]]).cpu().numpy()
        if count >= 2:
            kf_np = packed[:count * 16].reshape(count, 4, 4)
            with self._pose_lock:
                for slot in range(1, count):
                    self.est_c2w[int(self.kf_db.frame_ids[slot])] = \
                        kf_np[slot]
                if self.config["mapping"]["optim_cur"]:
                    self.est_c2w[cur_frame_id] = \
                        packed[count * 16:count * 16 + 16].reshape(4, 4)
        return float(packed[-1])

    def add_keyframe(self, batch: Dict,
                     frame_rays: Optional[torch.Tensor] = None) -> None:
        if frame_rays is None:
            frame_rays = self._frame_block(batch)
        fid = int(batch["frame_id"])
        slot = self.kf_db.add_keyframe(
            frame_rays, fid, self.generator,
            filter_depth=self.config["mapping"]["filter_depth"])
        self.kf_poses[slot] = torch.from_numpy(self.est_c2w[fid]).to(
            self.device)
        if self.kf_aligns is not None:
            # The new keyframe inherits the latest exposure estimate.
            self.kf_aligns[slot] = self.cur_align

    def save_mesh(self, i: int, voxel_size: float = 0.05,
                  params: Optional[Dict] = None):
        """mesh_track{i}.ply of the map (``params``, or the current
        parameters)."""
        with self.spans.span("mesh", timed=True, sums=MESH_PHASES):
            out = os.path.join(self.config["data"]["output"],
                               self.config["data"]["exp_name"])
            os.makedirs(out, exist_ok=True)
            # Any thread (the mesh worker's too) launches on the map's card.
            with on_device(self.device):
                return self._extract(i, out, voxel_size, params)

    def _extract(self, i: int, out: str, voxel_size: float,
                 params: Optional[Dict]):
        from ..mesh.extract import extract_mesh

        return extract_mesh(self.model,
                            self.params if params is None else params,
                            self.config,
                            self.bounding_box,
                            marching_cube_bound=self.marching_cube_bound,
                            color_func=(
                                self.model.render_surface_color
                                if self.config["mesh"]["render_color"]
                                else self.model.query_color),
                            voxel_size=voxel_size,
                            mesh_savepath=os.path.join(
                                out, f"mesh_track{i}.ply"),
                            span=self.spans.span)

    def convert_relative_pose(self) -> Dict[int, np.ndarray]:
        """Every tracked frame's pose recomposed from its keyframe's and
        its stored relative pose (coslam_tpu's convert_relative_pose);
        keyframes keep their own."""
        kf_every = self.config["mapping"]["keyframe_every"]
        poses = {}
        with self._pose_lock:
            est, rel = self.est_c2w.copy(), dict(self.est_c2w_rel)
        for i in range(len(est)):
            if not np.any(est[i]):
                continue                              # not tracked yet
            if i % kf_every == 0:
                poses[i] = est[i]
                continue
            delta = rel.get(i, np.eye(4, dtype=np.float32))
            poses[i] = (delta.astype(np.float64)
                        @ est[(i // kf_every) * kf_every].astype(
                            np.float64)).astype(np.float32)
        return poses

    def evaluate_ate(self, n_frames: int, poses: Optional[Dict] = None,
                     name: str = "output.txt",
                     gt: Optional[Dict] = None) -> Dict:
        """ATE of the first n_frames poses (the absolute table, or
        ``poses``) against the ground truth (``gt``, default the
        dataset's; coslam_tpu.eval.ate without its plot); appends to
        ``name`` in the run's output directory."""
        from ..eval.ate import convert_poses, evaluate_ate

        src = self.est_c2w if poses is None else poses
        est = {i: src[i] for i in range(n_frames)}
        gt_arr, mask = convert_poses(self.pose_gt if gt is None else gt,
                                     n_frames, 1.0)
        est_arr, _ = convert_poses(est, n_frames, 1.0, gt=False)
        est_arr = est_arr[mask[:len(est_arr)]]
        results = evaluate_ate({k: v for k, v in enumerate(gt_arr)},
                               {k: v for k, v in enumerate(est_arr)})
        results["Name"] = n_frames - 1
        out = os.path.join(self.config["data"]["output"],
                           self.config["data"]["exp_name"])
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, name), "a") as f:
            print(results, file=f)
        return results

    def _evaluate(self, n_frames: int, est=None, rel=None) -> Dict:
        """The absolute ATE (output.txt) and the relative one
        (output_relative.txt), of the pose tables (or of the snapshots
        ``est`` and ``rel``); returns the absolute."""
        results = self.evaluate_ate(n_frames, est)
        self.evaluate_ate(n_frames, self.convert_relative_pose()
                          if rel is None else rel, "output_relative.txt")
        return results

    def _periodic_mesh_eval(self, i: int, eval_ate: bool) -> None:
        """The mesh.vis mesh and ATE of frame i (coslam_tpu's
        _periodic_mesh_eval). With mesh.async_vis (the default) they run
        on the single-flight worker from a snapshot taken here: the
        parameters cloned on the loop's stream, before the next optimizer
        step changes them in place, and the pose tables copied on the
        host; mesh.async_vis false runs them here, in the loop."""
        voxel = self.config["mesh"]["voxel_eval"]
        span = self.spans.span

        def mesh_and_ate(params=None, est=None, rel=None):
            self.save_mesh(i, voxel_size=voxel, params=params)
            if eval_ate:
                with span("ate", timed=True):
                    self._evaluate(i + 1, est, rel)

        if not self.config["mesh"].get("async_vis", True):
            with span("mesh_job", timed=True):
                mesh_and_ate()
            return
        with torch.no_grad():
            params = _clone(self.params)
        ready = _record_event(self.device)
        est = rel = None
        if eval_ate:
            with self._pose_lock:
                est = self.est_c2w.copy()
            rel = {k: np.array(v)
                   for k, v in self.convert_relative_pose().items()}

        def job():
            with span("mesh_job", timed=True):
                # The clones were made on the submitting thread's stream.
                stream = _wait_event(self.device, ready)
                try:
                    mesh_and_ate(params, est, rel)
                finally:
                    # Nothing of this stream reads the clones once they
                    # are freed (back to the submitting stream's pool).
                    if stream is not None:
                        stream.synchronize()

        self._mesh_worker.submit(job)

    # -- checkpoints ------------------------------------------------------------

    def save_checkpoint(self, path: str, frame_cursor: Optional[int] = None,
                        async_write: bool = False) -> None:
        """The crash-resume state (coslam_tpu's save_checkpoint): params,
        pose tables, keyframe reservoir (rays [num_kf, R, 7], ids, count,
        wrap pointer, poses), the map optimizer's state in the JAX
        layout, the generator's state (``torch_generator``, in place of
        the JAX key; and the tracker's, ``torch_track_generator``, where
        it has one of its own), with frame_align the exposure parameters
        (``kf_aligns``, ``cur_align``) and ``frame_cursor``, the next
        frame to process.
        async_write hands the copies and the write to the background
        writer, which snapshots every tensor on the device at submit."""
        self._ckpt_writer.wait()  # the previous write lands first
        extra = {
            "kf_rays": self.kf_db.rays,
            "kf_frame_ids": self.kf_db.frame_ids.copy(),
            "kf_count": np.int64(self.kf_db.count),
            "kf_wrap_ptr": np.int64(self.kf_db._wrap_ptr),
            "kf_poses": self.kf_poses,
            "opt_state": convert.adam_state_to_jax(self.map_opt, self.params),
            "torch_generator": self.generator.get_state().numpy(),
        }
        if self.kf_aligns is not None:
            extra["kf_aligns"] = self.kf_aligns
            extra["cur_align"] = self.cur_align
        if self.track_generator is not self.generator:
            extra["torch_track_generator"] = \
                self.track_generator.get_state().numpy()
        if frame_cursor is not None:
            extra["frame_cursor"] = np.int64(frame_cursor)
        with self._pose_lock:
            est = self.est_c2w.copy()
            rel = {k: v.copy() for k, v in self.est_c2w_rel.items()}
        if async_write:
            self._ckpt_writer.submit(path, self.params, est, rel, extra)
        else:
            save_ckpt(path, self.params, est, rel, extra)

    def load_checkpoint(self, path: str) -> int:
        """Restore what save_checkpoint wrote, from the port's file or the
        JAX package's (whose packed keyframe rays are unpacked, and whose
        JAX key and numpy RNG state are not read: the run goes on with its
        own generator). Returns the frame to resume from (0 without a
        cursor)."""
        params, est, rel, extra = load_ckpt(path, self.params)
        if est.shape != self.est_c2w.shape:
            raise ValueError(f"checkpoint pose table {est.shape} does not "
                             f"match the sequence's {self.est_c2w.shape}")
        with torch.no_grad():
            for p, a in zip(param_leaves(self.params), param_leaves(params)):
                p.copy_(torch.from_numpy(np.asarray(a, np.float32)))
        self.est_c2w = np.array(est, np.float32)
        self.est_c2w_rel = {k: np.array(v, np.float32)
                            for k, v in rel.items()}
        if "kf_rays" in extra:
            self.kf_db.restore(extra["kf_rays"], extra["kf_frame_ids"],
                               int(extra["kf_count"]),
                               int(extra["kf_wrap_ptr"]))
            self.kf_poses = torch.from_numpy(
                np.array(extra["kf_poses"], np.float32)).to(self.device)
        if "opt_state" in extra:
            convert.adam_state_from_jax(self.map_opt, self.params,
                                        extra["opt_state"])
        if self.kf_aligns is not None and "kf_aligns" in extra:
            self.kf_aligns = torch.from_numpy(np.array(
                extra["kf_aligns"], np.float32)).to(self.device)
            self.cur_align = torch.from_numpy(np.array(
                extra["cur_align"], np.float32)).to(self.device)
        if "torch_generator" in extra:
            self.generator.set_state(torch.from_numpy(
                np.array(extra["torch_generator"], np.uint8)))
        if ("torch_track_generator" in extra
                and self.track_generator is not self.generator):
            self.track_generator.set_state(torch.from_numpy(
                np.array(extra["torch_track_generator"], np.uint8)))
        return int(extra.get("frame_cursor", 0))

    # -- main loop --------------------------------------------------------------

    def run(self, n_frames: Optional[int] = None, verbose: bool = True,
            eval_ate: bool = True, mesh: bool = True, ckpt_every: int = 0,
            start_frame: int = 0):
        """Process the first n_frames frames (all by default); returns the
        ATE statistics (None with eval_ate=False). ckpt_every: write
        checkpoint{i}.npz (cursor i) every that many frames (0: only the
        final checkpoint{total - 1}.npz, cursor total). start_frame:
        resume there (the cursor load_checkpoint returned), skipping
        first-frame mapping when it is past 0."""
        cfg = self.config
        frames = PrefetchIterator(self.dataset, n_frames, start=start_frame,
                                  workers=cfg["data"].get("num_workers"))
        total = len(frames)
        out = os.path.join(cfg["data"]["output"], cfg["data"]["exp_name"])
        map_every = cfg["mapping"]["map_every"]
        kf_every = cfg["mapping"]["keyframe_every"]
        mesh_every = int(cfg["mesh"].get("vis", 0) or 0)
        visualise = bool(cfg["mesh"].get("visualisation"))
        self.frame_walls, self.frame_events = [], []
        spans = self.spans
        # Each frame's wall ends with the wait for the next frame.
        for i, batch in spans.each_after("load_wait", frames):
            self.frame_walls.append(time.perf_counter())
            # The frame's frame blocks, summed: one frame_block entry a frame.
            with spans.span("frame", sums=("frame_block",)):
                if visualise:
                    self.visualise_frame(batch, i, out)
                if ckpt_every and i > start_frame and i % ckpt_every == 0:
                    # The state covers frames [0, i): a resume starts at i.
                    with spans.span("checkpoint", event=True):
                        self.save_checkpoint(
                            os.path.join(out, f"checkpoint{i}.npz"),
                            frame_cursor=i, async_write=True)
                if i == 0:
                    loss = self.first_frame_mapping(batch)
                    if cfg["mapping"].get("first_mesh"):
                        self.save_mesh(0,
                                       voxel_size=cfg["mesh"]["voxel_eval"])
                    if verbose:
                        print(f"frame 0: first-frame mapping loss "
                              f"{loss:.5f}")
                    continue
                if self._track_pc_step is not None:
                    self.tracking_pc(batch, i)
                loss = self.tracking_render(batch, i)
                if verbose:
                    err = np.abs(self.est_c2w[i][:3]
                                 - self.pose_gt[i][:3]).mean()
                    print(f"it: {i}, loss: {loss:.5f}, "
                          f"pose L1 vs gt: {err:.5f}")
                if i % map_every == 0:
                    with spans.span("ba", event=True):
                        self.current_frame_mapping(batch, i)
                        self.global_BA(batch, i)
                if i % kf_every == 0:
                    with spans.span("keyframe", event=True):
                        self.add_keyframe(batch)
                if mesh_every and i % mesh_every == 0:
                    with spans.span("mesh_eval", event=True):
                        self._periodic_mesh_eval(i, eval_ate)
        self.frame_walls.append(time.perf_counter())
        # The periodic jobs land before the final files (output.txt's
        # lines stay in frame order).
        self._mesh_worker.wait()
        self._ckpt_writer.wait()
        # Cursor total: resuming a finished run only finalizes it.
        self.save_checkpoint(os.path.join(out, f"checkpoint{total - 1}.npz"),
                             frame_cursor=total)
        if mesh:
            self.final_mesh = self.save_mesh(
                total - 1, voxel_size=cfg["mesh"]["voxel_final"])
        results = self._evaluate(total) if eval_ate else None
        if verbose and results is not None:
            print(f"ATE RMSE {results['absolute_translational_error.rmse']}")
        if verbose:
            self.print_timings()
        return results

    def visualise_frame(self, batch: Dict, i: int, out_dir: str) -> str:
        """The loop's live view (mesh.visualisation; coslam_tpu's
        visualise_frame): the frame's [rgb | turbo-depth] composite
        written to <out_dir>/vis/rgbd_<i:05d>.png, and shown in a window
        when DISPLAY is set. Returns the PNG's path."""
        import cv2

        from ..tools.viz import colormap_image

        depth = np.asarray(batch["depth"])
        mask = depth < self.config["cam"]["depth_trunc"]
        dvis = colormap_image(depth, mask, invalid_color=(1.0, 1.0, 1.0))
        comp = np.hstack([np.asarray(batch["rgb"]), dvis])
        vis_dir = os.path.join(out_dir, "vis")
        os.makedirs(vis_dir, exist_ok=True)
        path = os.path.join(vis_dir, f"rgbd_{i:05d}.png")
        bgr = cv2.cvtColor((comp * 255).astype(np.uint8), cv2.COLOR_RGB2BGR)
        cv2.imwrite(path, bgr)
        if os.environ.get("DISPLAY"):
            try:
                cv2.imshow("RGB-D", bgr)
                cv2.waitKey(1)
            except cv2.error:
                pass
        return path

    def print_timings(self) -> None:
        """Each phase's mean wall per call in ms (the first call, which
        builds the kernels, left out of the mean), a step's phases
        (``<step>.forward`` and so on) under the step, and the frame-time
        report of latency.attribute_tails."""
        from .latency import attribute_tails

        def line(name, vals, indent=""):
            steady = vals[1:] if len(vals) > 1 else vals
            print(f"[timing] {indent}{name}: mean "
                  f"{1e3 * np.mean(steady):.2f} ms ({len(vals)} calls, "
                  f"first {1e3 * vals[0]:.0f} ms)")

        for step, vals in self.timings.items():
            if vals and "." not in step:
                line(step, vals)
                for name, sub in self.timings.items():
                    if sub and name.startswith(step + "."):
                        line(name[len(step) + 1:], sub, "  ")
        print(f"[timing] frames: "
              f"{attribute_tails(self.frame_walls, self.frame_events)}")
