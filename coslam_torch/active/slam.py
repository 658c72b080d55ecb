"""ActiveCoSLAM: information-gain keyframe selection.

Counterpart of coslam_tpu/active/slam.py (the reference's
ActiveCoSLAM/ac_coslam.py:1014-1131). The run starts on the first
``init_image`` frames; every keyframe interval past that it renders a
window of ``check_info_gain_every`` holdout frames at 1 /
``downsample_rate`` of their pixels, computes each frame's expected
information gain

    pre  = sum over rays and samples of beta
    post = sum of 1 / (1 / beta + w^2 / beta_render)

(:func:`info_gain`, through the beta-head model), appends the top
``choose_k`` frames to the train set and makes the best one a keyframe
once it is tracked. Frames the window passes over are skipped for good,
so the run trains on a subsequence; its motion model scales the last
velocity by the frame gap (tracking.predict_current_pose's
``gap_ratio``), and a frame after a gap is tracked twice.

The holdout pixels come from a numpy stream keyed by (seed, the window's
first frame id, 2), as runtime/slam.py's draws are keyed, where the JAX
package draws them from its shared numpy generator;
:meth:`ActiveCoSLAM.select_info_gain_indices` also takes them as an
argument.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..runtime.slam import CoSLAM
from ..runtime.tracking import predict_current_pose
from .scene_rep import ActiveJointEncoding

# The stream number of the holdout pixels' numpy stream (tracking's is
# none, point-cloud tracking's 1).
HOLDOUT_STREAM = 2


def info_gain(model, params: Dict, rays: torch.Tensor, c2w: torch.Tensor,
              t: Optional[torch.Tensor] = None,
              u: Optional[torch.Tensor] = None):
    """(pre, post) of one holdout frame: rays [S, 7] (direction, rgb,
    depth) seen from c2w [4, 4], rendered by the beta-head ``model``
    with the draws t and u (None: unperturbed). No gradient is kept."""
    with torch.no_grad():
        rays_d = rays[:, :3] @ c2w[:3, :3].T
        rays_o = c2w[:3, 3].expand_as(rays_d)
        rend = model.render_rays(params, rays_o, rays_d,
                                 target_d=rays[:, 6:7], t=t, u=u)
        uncert_render = rend["uncert_map"][:, None] + 1e-9
        uncert_pts = rend["raw"][..., -1] + 1e-9
        w = rend["weights"]
        pre = uncert_pts.sum()
        post = (1.0 / (1.0 / uncert_pts + w * w / uncert_render)).sum()
    return pre, post


class ActiveCoSLAM(CoSLAM):
    def __init__(self, config: Dict, dataset=None, device="cuda"):
        # The 'active' section with the reference's defaults
        # (ActiveCoSLAM/active_tum.yaml:117-124) and the JAX package's
        # detach_nll default.
        config.setdefault("active", {})
        a = config["active"]
        a.setdefault("isActive", True)
        a.setdefault("check_info_gain_every", 10)
        a.setdefault("init_image", 20)
        a.setdefault("choose_k", 1)
        a.setdefault("w", 0.01)
        a.setdefault("downsample_rate", 4)
        a.setdefault("beta_min", 0.01)
        a.setdefault("detach_nll", True)
        super().__init__(config, dataset, device)
        self._pending_kf = set()
        self.train_set_size = 0

    def _make_model(self, config: Dict):
        return ActiveJointEncoding(config, self.bounding_box, self.device)

    def holdout_pixels(self, first_frame_id: int) -> np.ndarray:
        """The pixel indices of a window's info-gain render: H W /
        downsample_rate^2 of the H W pixels without replacement, from the
        stream keyed by (seed, the window's first frame id, 2)."""
        ds = int(self.config["active"]["downsample_rate"])
        H, W = self.dataset.H, self.dataset.W
        return np.random.default_rng(
            (self._seed, int(first_frame_id), HOLDOUT_STREAM)).choice(
                H * W, size=(H // ds) * (W // ds), replace=False)

    def info_gains(self, window, idx: Optional[np.ndarray] = None
                   ) -> np.ndarray:
        """[len(window)] pre - post of each frame of the window at the
        pixels ``idx`` (default :meth:`holdout_pixels`), each from its
        tracked pose or, not tracked yet, its dataset pose."""
        batches = [window[j] for j in range(len(window))]
        if idx is None:
            idx = self.holdout_pixels(batches[0]["frame_id"])
        pairs = []
        for batch in batches:
            fid = int(batch["frame_id"])
            with self._pose_lock:
                pose = np.array(self.est_c2w[fid])
            if not np.any(pose):
                pose = np.asarray(batch["c2w"], np.float32)
            rays = torch.from_numpy(
                self._frame_rays_flat(batch)[idx]).to(self.device)
            t, u = self.model.ray_draws(self.generator, rays.shape[0],
                                        self.device)
            pairs.append(torch.stack(info_gain(
                self.model, self.params, rays,
                torch.from_numpy(pose).to(self.device), t, u)))
        pre, post = torch.stack(pairs).cpu().numpy().astype(np.float64).T
        return pre - post

    def select_info_gain_indices(self, holdout_view,
                                 idx: Optional[np.ndarray] = None
                                 ) -> List[int]:
        """The view-local indices of the top ``choose_k`` frames of a
        holdout view by information gain (reference
        ac_coslam.py:1049-1108)."""
        gains = self.info_gains(holdout_view, idx)
        order = np.argsort(gains)[::-1]
        return [int(j) for j in order[:self.config["active"]["choose_k"]]]

    def _kf_ids(self) -> set:
        return {int(f) for f in self.kf_db.frame_ids[:self.kf_db.count]}

    def _grow_train_set(self, train_ds, holdout, verbose: bool):
        """Append the info-gain top-K of the next holdout window to the
        train set and move the window past it (the JAX package's
        _grow_train_set): the chosen frames in temporal order, the whole
        window consumed, and only the top-1 frame made a keyframe, once
        it has a tracked pose (the keyframe pose table mirrors est_c2w
        when the keyframe is added)."""
        wsize = min(int(self.config["active"]["check_info_gain_every"]),
                    len(holdout))
        window = holdout.slice(range(wsize))
        by_gain = self.select_info_gain_indices(window)
        chosen = window.slice(sorted(by_gain))
        train_ds = train_ds + chosen
        holdout = holdout.slice(range(wsize, len(holdout)))
        if by_gain:
            kf = int(window[by_gain[0]]["frame_id"])
            self._pending_kf.add(kf)
            if verbose:
                print(f"info-gain chose "
                      f"{[int(window[j]['frame_id']) for j in by_gain]} "
                      f"(kf: {kf}, train set -> {len(train_ds)})")
        return train_ds, holdout

    def run(self, n_frames: Optional[int] = None, verbose: bool = True,
            eval_ate: bool = True, mesh: bool = True):
        """The active loop over a growing train set (reference
        ac_coslam.py:956-1172; the JAX package's ActiveCoSLAM.run): first
        ``init_image`` frames, then, every keyframe interval, the
        info-gain picks of the next holdout window. Returns the ATE
        statistics over the processed frames (None with
        eval_ate=False)."""
        cfg = self.config
        active = cfg["active"]
        out = os.path.join(cfg["data"]["output"], cfg["data"]["exp_name"])
        os.makedirs(out, exist_ok=True)
        total = len(self.dataset) if n_frames is None else min(
            n_frames, len(self.dataset))
        init_image = int(active["init_image"])
        if active["isActive"] and init_image < total:
            train_ds = self.dataset.slice(range(0, init_image))
            holdout = self.dataset.slice(range(init_image, total))
        else:
            train_ds = self.dataset.slice(range(0, total))
            holdout = self.dataset.slice([])

        processed = []   # frame ids in processing order
        self._pending_kf = set()
        i = 0
        while i < len(train_ds):   # the train set grows inside the loop
            batch = train_ds[i]
            fid = int(batch["frame_id"])
            if i == 0:
                self.first_frame_mapping(batch)
                processed.append(fid)
                i += 1
                continue
            prev = self.est_c2w[processed[-1]]
            prev_prev = (self.est_c2w[processed[-2]]
                         if len(processed) >= 2 else None)
            gap_ratio = 1.0
            if len(processed) >= 2:
                g1 = processed[-1] - processed[-2]
                gap_ratio = (fid - processed[-1]) / g1 if g1 else 1.0
            c2w_init = predict_current_pose(prev, prev_prev,
                                            cfg["tracking"]["const_speed"],
                                            gap_ratio=gap_ratio)
            self.tracking_render(batch, fid, c2w_init=c2w_init)
            if fid - processed[-1] > 1:
                # After a gap: one more pass from the first pass's pose.
                self.tracking_render(batch, fid, c2w_init=self.est_c2w[fid])
            processed.append(fid)
            if fid in self._pending_kf:
                self._pending_kf.discard(fid)
                if fid not in self._kf_ids():
                    self.add_keyframe(batch)
                    if verbose:
                        print(f"info-gain keyframe: {fid}")
            if verbose:
                loss, psnr, err = self._last_track_info
                print(f"it: {i} (frame {fid}), loss: {loss:.5f}, "
                      f"psnr: {psnr:.3f}, pose L1 vs gt: {err:.5f}")
            if i % cfg["mapping"]["map_every"] == 0:
                self.global_BA(batch, fid)
            if i % cfg["mapping"]["keyframe_every"] == 0:
                if (not active["isActive"] or i <= init_image
                        or len(holdout) == 0):
                    # A cadence keyframe (one slot a frame).
                    if fid not in self._kf_ids():
                        self.add_keyframe(batch)
                else:
                    train_ds, holdout = self._grow_train_set(
                        train_ds, holdout, verbose)
            if (active["isActive"] and len(holdout) > 0
                    and i == len(train_ds) - 1):
                # The train set would run dry: pull the next window.
                train_ds, holdout = self._grow_train_set(train_ds, holdout,
                                                         verbose)
            if cfg["mesh"]["vis"] and i % cfg["mesh"]["vis"] == 0:
                self._periodic_mesh_eval(i, eval_ate=False)
            i += 1

        self.train_set_size = len(train_ds)
        self._mesh_worker.wait()
        self._ckpt_writer.wait()
        if mesh:
            # Named by the sequence's last frame, as CoSLAM.run names it.
            self.final_mesh = self.save_mesh(
                total - 1, voxel_size=cfg["mesh"]["voxel_final"])
        self.save_checkpoint(
            os.path.join(out, f"checkpoint{len(train_ds) - 1}.npz"),
            frame_cursor=total)
        if not eval_ate:
            return None
        # The processed frames only, renumbered 0.. in frame order.
        ids = [f for f in range(len(self.est_c2w))
               if np.any(self.est_c2w[f])]
        results = self.evaluate_ate(
            len(ids), poses={j: self.est_c2w[f] for j, f in enumerate(ids)},
            gt={j: self.pose_gt[f] for j, f in enumerate(ids)})
        if verbose:
            print(f"ATE RMSE {results['absolute_translational_error.rmse']}")
        return results

    def test(self, batch: Dict, frame_id: int) -> Dict:
        """One forward at the motion-model pose of the frame, on its
        tracking pixels (reference ac_coslam.py:703-741) -> its outputs as
        numpy arrays."""
        prev = self.est_c2w[frame_id - 1]
        prev_prev = self.est_c2w[frame_id - 2] if frame_id >= 2 else None
        c2w = torch.from_numpy(predict_current_pose(
            prev, prev_prev, self.config["tracking"]["const_speed"])).to(
                self.device)
        rays = self._sample_tracking_rays(batch).to(self.device)
        rays_d = rays[:, :3] @ c2w[:3, :3].T
        t, u = self.model.ray_draws(self.generator, rays.shape[0],
                                    self.device)
        with torch.no_grad():
            ret = self.model.forward(self.params, c2w[:3, 3].expand_as(rays_d),
                                     rays_d, rays[:, 3:6], rays[:, 6:7],
                                     t=t, u=u)
        return {k: v.detach().cpu().numpy() for k, v in ret.items()}
