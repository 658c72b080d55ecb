"""Keyframe ray reservoir: a preallocated [num_kf, R, 7] device tensor.

Counterpart of coslam_tpu/runtime/keyframe.py without its TPU layout (the
16-rays-per-128-lane packing, which only a JAX checkpoint brings in):
each keyframe stores R rays (direction, rgb, depth) sampled uniformly
without replacement from its frame.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# The JAX package's storage layout, which its checkpoints carry: 16 rays
# a 128-lane row, each ray padded from 7 to 8 floats
# (coslam_tpu/runtime/keyframe.py RAY_CHUNK, pack_rays).
RAY_CHUNK = 16


def unpack_rays(packed: np.ndarray) -> np.ndarray:
    """[..., C, 128] packed rows -> [..., C * 16, 7] rays (the port's copy
    of coslam_tpu/runtime/keyframe.py:unpack_rays)."""
    *lead, c, w = packed.shape
    if w != 8 * RAY_CHUNK:
        raise ValueError(f"packed keyframe rays must be [..., C, 128], got "
                         f"{tuple(packed.shape)}")
    return packed.reshape(*lead, c * RAY_CHUNK, 8)[..., :7]


class KeyFrameDatabase:
    def __init__(self, config: Dict, num_kf: int, num_rays_to_save: int,
                 device="cpu"):
        self.num_kf = num_kf
        self.num_rays_to_save = max(1, int(num_rays_to_save))
        self.rays = torch.zeros((num_kf, self.num_rays_to_save, 7),
                                device=device)
        self.frame_ids = np.full((num_kf,), -1, np.int64)
        self.count = 0
        self._wrap_ptr = 1  # next slot to recycle once the buffer is full
        self._depth_trunc = float(config["cam"]["depth_trunc"])

    def add_keyframe(self, frame_rays: torch.Tensor, frame_id: int,
                     generator: torch.Generator,
                     filter_depth: bool = False) -> int:
        """Store a uniform sample of frame_rays [H*W, 7] (valid-depth rays
        first with filter_depth). Returns the slot written; when the
        buffer is full, slots >= 1 are recycled round-robin and slot 0
        stays pinned, because BA freezes the first keyframe's pose."""
        if self.count < self.num_kf:
            slot = self.count
            self.count += 1
        else:
            slot = self._wrap_ptr
            self._wrap_ptr = self._wrap_ptr % (self.num_kf - 1) + 1
        perm = torch.randperm(frame_rays.shape[0], generator=generator,
                              device=generator.device).to(frame_rays.device)
        if filter_depth:
            d = frame_rays[perm, 6]
            invalid = ~((d > 0.0) & (d <= self._depth_trunc))
            perm = perm[torch.argsort(invalid.to(torch.int8), stable=True)]
        self.rays[slot] = frame_rays[perm[:self.num_rays_to_save]]
        self.frame_ids[slot] = frame_id
        return slot

    def restore(self, rays: np.ndarray, frame_ids: np.ndarray, count: int,
                wrap_ptr: int) -> None:
        """Take a checkpoint's reservoir: rays [num_kf, R, 7], or the JAX
        package's packed [num_kf, R / 16, 128], with their own ray count
        R (the JAX reservoir keeps R - R mod 16 rays a keyframe)."""
        rays = np.asarray(rays, np.float32)
        if rays.shape[-1] != 7:
            rays = unpack_rays(rays)
        if rays.shape[0] != self.num_kf:
            raise ValueError(f"checkpoint holds {rays.shape[0]} keyframe "
                             f"slots, this run {self.num_kf}")
        self.rays = torch.from_numpy(np.ascontiguousarray(rays)).to(
            self.rays.device)
        self.num_rays_to_save = rays.shape[1]
        self.frame_ids = np.array(frame_ids, np.int64)
        self.count = int(count)
        self._wrap_ptr = int(wrap_ptr)

    def sample_global_rays(self, bs: int, generator: torch.Generator):
        """bs rays drawn with replacement from all stored keyframes ->
        (rays [bs, 7], keyframe slot [bs])."""
        R = self.num_rays_to_save
        idx = torch.randint(0, self.count * R, (bs,), generator=generator,
                            device=generator.device).to(self.rays.device)
        return self.rays.reshape(-1, 7)[idx], idx // R
