"""Per-frame affine exposure alignment: 3 per-channel gains and an
offset a frame, applied to the rendered RGB before the photometric loss.

Counterpart of coslam_tpu/ops/frame_align.py (``training.frame_align``):
tracking optimizes the frame's 4 parameters with its pose, and BA a
[max_kf + 1, 4] table of the keyframes' and the current frame's.
"""

from __future__ import annotations

import torch


def init_frame_align(n_frames: int, device=None,
                     dtype=torch.float32) -> torch.Tensor:
    """[n_frames, 4]: gains 1, offset 0."""
    p = torch.zeros((n_frames, 4), dtype=dtype, device=device)
    p[:, :3] = 1.0
    return p


def apply_frame_align(params: torch.Tensor, frame_id,
                      rgb: torch.Tensor) -> torch.Tensor:
    """rgb [..., 3] -> gains * rgb + offset of frame ``frame_id`` (an
    index, or an index tensor broadcasting against rgb's leading
    dimensions)."""
    p = params[frame_id]
    return rgb * p[..., :3] + p[..., 3:4]
