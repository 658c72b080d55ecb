"""Analytic synthetic RGB-D scenes, their sequences and their protocols.

The port's own copy of coslam_tpu/data/synth.py: the exact-SDF scenes
(the single room, the two-room apartment, the thin-geometry room, the
texture-poor room, the rearranged room and the corridor), the sphere
tracer, the trajectories (scan, corridor, handheld, walkthrough), the
Kinect-like depth noise, the motion-blur renderer, the four on-disk
writers (Replica, TUM, ScanNet, NeuralRGBD) and the protocol configs;
the same numpy arithmetic in the same order, so frames, poses and files
are the same bits.

Every scene method accepts a numpy array or a torch tensor, as the JAX
package's accept ``xp=jnp``: the array's type picks the array namespace
(``_ns``), so the tracer on a device (``DeviceRenderer``) runs the same
scene code. ``make_renderer`` takes that tracer only for a CUDA device
and a job of at least 40 M pixel-frames (the JAX package's rule); on the
CPU it takes the numpy tracer, and nothing falls back silently.

The writers import ``cv2`` inside the function, as the JAX ones do.
``SyntheticFrames`` with a ``protocol`` is the route that needs no image
codec: it yields, frame by frame, what that protocol's loader in
``data/datasets.py`` yields from the writer's files (colors as uint8,
depth as uint16 at ``png_depth_scale`` with the noise and holes applied,
the poses through the files' text, the crop, the TUM timestamp
association and the NeuralRGBD invalid-pose filter), with one
difference: Replica's and ScanNet's color files are JPEG (quality 97),
and the frames in memory skip that loss.

:func:`room0_config` carries the model widths and recipe of
configs/Replica/room0.yaml (with replica.yaml) onto the single room,
:func:`room0_vm_config` those of configs/Replica/room0_vm.yaml, and
:func:`room0_xor_config` room0's with the XOR-hash grid.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.rays import get_camera_rays
from .datasets import DatasetAlgebra

_ROOM_HALF = 2.0  # wall positions: |x|,|y|,|z| = 2


# ---------------------------------------------------------------------------
# Array namespaces: numpy, or torch on the tensor's device
# ---------------------------------------------------------------------------


class _NumpyNS:
    """The numpy calls the scene methods make, as numpy makes them."""

    asarray = staticmethod(lambda a: np.asarray(a, np.float32))
    const = staticmethod(lambda a: a)
    abs, sqrt, sin = np.abs, np.sqrt, np.sin
    arctan2, maximum, minimum = np.arctan2, np.maximum, np.minimum
    argmin, argmax = staticmethod(np.argmin), staticmethod(np.argmax)
    clip, stack = staticmethod(np.clip), staticmethod(np.stack)
    select = staticmethod(np.select)
    take_along_axis = staticmethod(np.take_along_axis)
    amax = staticmethod(lambda x, axis: x.max(axis=axis))
    amin = staticmethod(lambda x, axis: x.min(axis=axis))
    f32 = staticmethod(lambda x: x.astype(np.float32))
    flip_last = staticmethod(lambda x: x[..., ::-1])

    @staticmethod
    def norm(x, axis=-1, keepdims=False):
        return np.linalg.norm(x, axis=axis, keepdims=keepdims)

    @staticmethod
    def offset(p, e):
        """p + e, e a float64 constant: in float64, as numpy promotes."""
        return p + e


class _TorchNS:
    """The same calls on torch tensors of one device, in float32."""

    def __init__(self, device: torch.device):
        self.device = device

    def const(self, a):
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def asarray(self, a):
        return a.float() if torch.is_tensor(a) else self.const(a)

    abs, sin = staticmethod(torch.abs), staticmethod(torch.sin)
    arctan2 = staticmethod(torch.atan2)
    take_along_axis = staticmethod(torch.take_along_dim)
    f32 = staticmethod(lambda x: x.float())
    flip_last = staticmethod(lambda x: torch.flip(x, (-1,)))

    @staticmethod
    def sqrt(x):
        # Correctly rounded, as numpy's (torch's vectorized CPU sqrt is
        # not): the float64 root rounds to the float32 one.
        return torch.sqrt(x.double()).float()

    @staticmethod
    def maximum(a, b):
        if not torch.is_tensor(b):
            return torch.clamp(a, min=b)
        return torch.maximum(a, b)

    @staticmethod
    def minimum(a, b):
        if not torch.is_tensor(b):
            return torch.clamp(a, max=b)
        return torch.minimum(a, b)

    @staticmethod
    def clip(x, lo, hi):
        return torch.clamp(x, lo, hi)

    @staticmethod
    def amax(x, axis):
        return torch.amax(x, dim=axis)

    @staticmethod
    def amin(x, axis):
        return torch.amin(x, dim=axis)

    @staticmethod
    def argmin(x, axis):
        return torch.argmin(x, dim=axis)

    @staticmethod
    def argmax(x, axis):
        return torch.argmax(x, dim=axis)

    @staticmethod
    def stack(xs, axis):
        return torch.stack(list(xs), dim=axis)

    @staticmethod
    def norm(x, axis=-1, keepdims=False):
        # numpy's order for a short axis: ((x0^2 + x1^2) + x2^2), then sqrt.
        sq = x * x
        acc = sq.select(axis, 0)
        for k in range(1, x.shape[axis]):
            acc = acc + sq.select(axis, k)
        out = _TorchNS.sqrt(acc)
        return out.unsqueeze(axis) if keepdims else out

    @staticmethod
    def select(conds, choices):
        out = torch.zeros_like(choices[0])
        for c, v in zip(reversed(conds), reversed(choices)):
            out = torch.where(c, v, out)
        return out

    @staticmethod
    def offset(p, e):
        """p + e rounded as numpy does it (in float64, then to float32)."""
        return (p.double() + torch.as_tensor(e, dtype=torch.float64,
                                             device=p.device)).float()


_NUMPY = _NumpyNS()


def _ns(p):
    """The namespace of array p: torch's on p's device, else numpy's."""
    return _TorchNS(p.device) if torch.is_tensor(p) else _NUMPY


# ---------------------------------------------------------------------------
# Scenes
# ---------------------------------------------------------------------------


class AnalyticScene:
    """Closed room (walls at +-2) containing a sphere, a rounded box and
    a capped cylinder. ``sdf`` is an exact signed distance (positive in
    free space), which sphere tracing relies on."""

    # Metric AABB enclosing all surfaces (used to build GT-mesh grids).
    bound = np.array([[-2.2, 2.2], [-2.2, 2.2], [-2.2, 2.2]], np.float32)

    sphere_c = np.array([0.7, -1.35, 0.55], np.float32)
    sphere_r = 0.6
    box_c = np.array([-1.1, -1.5, -0.6], np.float32)
    box_half = np.array([0.45, 0.5, 0.45], np.float32)
    box_round = 0.04
    cyl_c = np.array([0.9, -1.3, -1.0], np.float32)
    cyl_r = 0.35
    cyl_h = 0.7

    def _parts(self, p) -> Tuple:
        """Component SDFs at p [..., 3] -> (room, sphere, box, cylinder)."""
        xp = _ns(p)
        c = xp.const
        room = _ROOM_HALF - xp.amax(xp.abs(p), -1)

        sph = xp.norm(p - c(self.sphere_c), axis=-1) - self.sphere_r

        q = xp.abs(p - c(self.box_c)) - c(self.box_half - self.box_round)
        box = (xp.norm(xp.maximum(q, 0.0), axis=-1)
               + xp.minimum(xp.amax(q, -1), 0.0) - self.box_round)

        pc = p - c(self.cyl_c)
        dxz = xp.sqrt(pc[..., 0] ** 2 + pc[..., 2] ** 2) - self.cyl_r
        dy = xp.abs(pc[..., 1]) - self.cyl_h
        cyl = (xp.minimum(xp.maximum(dxz, dy), 0.0)
               + xp.sqrt(xp.maximum(dxz, 0.0) ** 2
                         + xp.maximum(dy, 0.0) ** 2))
        return room, sph, box, cyl

    def sdf(self, p):
        """Exact SDF at p [..., 3]: positive in free space."""
        xp = _ns(p)
        room, sph, box, cyl = self._parts(xp.asarray(p))
        return xp.minimum(xp.minimum(room, sph), xp.minimum(box, cyl))

    def normal(self, p, eps: float = 1e-3):
        """Finite-difference SDF gradient, normalized."""
        xp = _ns(p)
        p = xp.asarray(p)
        n = xp.stack(
            [self.sdf(xp.offset(p, e)) - self.sdf(xp.offset(p, -e))
             for e in (np.array([eps, 0, 0]), np.array([0, eps, 0]),
                       np.array([0, 0, eps]))], axis=-1)
        return n / xp.maximum(xp.norm(n, axis=-1, keepdims=True), 1e-12)

    def _wall_tex(self, p):
        """The walls' aperiodic texture [..., 1]: incommensurate sinusoids
        (a periodic pattern makes photometric tracking translation-
        ambiguous) with ~25 cm detail, so a bare wall filling the view
        still gives the tracker image gradients."""
        xp = _ns(p)
        px, py, pz = p[..., 0], p[..., 1], p[..., 2]
        tex = (0.5 + 0.26 * xp.sin(4.7 * px + 1.3) * xp.sin(3.9 * py + 0.7)
               + 0.16 * xp.sin(2.9 * pz + 1.1 * px)
               + 0.10 * xp.sin(6.53 * (px + py + pz))
               + 0.08 * xp.sin(23.7 * px + 17.3 * pz + 5.1 * py)
               + 0.06 * xp.sin(12.9 * py + 19.1 * pz + 2.0))
        return xp.clip(tex, 0.05, 1.0)[..., None]

    _HUES = [[0.85, 0.50, 0.45], [0.50, 0.75, 0.55], [0.80, 0.80, 0.58],
             [0.55, 0.55, 0.62], [0.48, 0.58, 0.80], [0.75, 0.58, 0.75]]

    def albedo(self, p):
        """Textured per-component albedo [..., 3] in [0, 1]."""
        xp = _ns(p)
        p = xp.asarray(p)
        room, sph, box, cyl = self._parts(p)
        which = xp.argmin(xp.stack([room, sph, box, cyl], axis=-1), axis=-1)

        tex = self._wall_tex(p)
        face = xp.argmax(xp.abs(p), axis=-1)
        neg = xp.take_along_axis(p, face[..., None], -1)[..., 0] < 0
        hues = _hues(xp, self._HUES)
        wall = hues[face * 2 + neg] * (0.40 + 0.60 * tex)
        bands = 0.5 + 0.5 * xp.sin(12.0 * p[..., 1])
        sphere = xp.stack([0.75 + 0.2 * bands, 0.25 + 0.2 * bands,
                           0.20 + 0.1 * bands], axis=-1)
        stripes = 0.5 + 0.5 * xp.sin(9.0 * (p[..., 0] + p[..., 2]))
        boxc = xp.stack([0.20 + 0.15 * stripes, 0.65 + 0.25 * stripes,
                         0.25 + 0.1 * stripes], axis=-1)
        ang = xp.arctan2(p[..., 2] - float(self.cyl_c[2]),
                         p[..., 0] - float(self.cyl_c[0]))
        spin = 0.5 + 0.5 * xp.sin(6.0 * ang)
        cylc = xp.stack([0.20 + 0.1 * spin, 0.30 + 0.2 * spin,
                         0.70 + 0.25 * spin], axis=-1)

        w = which[..., None]
        out = xp.select([w == 0, w == 1, w == 2, w == 3],
                        [wall, sphere, boxc, cylc])
        return xp.f32(out)

    def shade(self, p):
        """Lambert shading with a fixed light; rgb [..., 3] in [0, 1]."""
        xp = _ns(p)
        light = np.array([0.45, 0.80, 0.35], np.float32)
        light = light / np.linalg.norm(light)
        lam = xp.maximum((self.normal(p) * xp.const(light)).sum(-1), 0.0)
        rgb = self.albedo(p) * (0.55 + 0.45 * lam)[..., None]
        return xp.f32(xp.clip(rgb, 0.0, 1.0))


def _hues(xp, rows):
    """A palette table: float64 under numpy (as the JAX package's), float32
    under torch."""
    return np.asarray(rows) if xp is _NUMPY else xp.const(rows)


def _box_interior(p, c: np.ndarray, half: np.ndarray):
    """Signed distance of an axis-aligned box INTERIOR (positive inside,
    exact inside — the free-space convention AnalyticScene.room uses)."""
    xp = _ns(p)
    return xp.amin(xp.const(half) - xp.abs(p - xp.const(c)), -1)


def _rounded_box(p, c, half, r):
    xp = _ns(p)
    q = xp.abs(p - xp.const(c)) - xp.const(half - r)
    return (xp.norm(xp.maximum(q, 0.0), axis=-1)
            + xp.minimum(xp.amax(q, -1), 0.0) - r)


def _sd_box(p, c, half):
    """Exact box SDF (sharp corners); c, half as float32 constants."""
    xp = _ns(p)
    q = xp.abs(p - xp.const(np.asarray(c, np.float32))) \
        - xp.const(np.asarray(half, np.float32))
    return (xp.norm(xp.maximum(q, 0.0), axis=-1)
            + xp.minimum(xp.amax(q, -1), 0.0))


def _capped_cylinder(p, c, r, h):
    xp = _ns(p)
    pc = p - xp.const(c)
    dxz = xp.sqrt(pc[..., 0] ** 2 + pc[..., 2] ** 2) - r
    dy = xp.abs(pc[..., 1]) - h
    return (xp.minimum(xp.maximum(dxz, dy), 0.0)
            + xp.sqrt(xp.maximum(dxz, 0.0) ** 2 + xp.maximum(dy, 0.0) ** 2))


class AnalyticApartment(AnalyticScene):
    """ScanNet-class scene: TWO rooms joined by a doorway, six textured
    objects. Free space is the union of the two room interiors and the
    door opening (max of interior SDFs: a conservative distance bound with
    the exact zero set, which sphere tracing and marching cubes need); the
    walls between and around are solid. The apartment spans 8.3 m along x,
    so trajectories must pass a doorway and the map must hold two
    visually distinct rooms. ``normal``/``shade`` are inherited."""

    bound = np.array([[-4.3, 4.3], [-2.1, 2.1], [-2.7, 2.7]], np.float32)

    room_a = np.array([-2.15, 0.0, 0.0], np.float32)
    room_b = np.array([2.15, 0.0, 0.0], np.float32)
    room_half = np.array([2.0, 2.0, 2.5], np.float32)
    door_c = np.array([0.0, -0.6, 0.7], np.float32)
    door_half = np.array([0.6, 1.35, 0.6], np.float32)

    # Room A furniture (the single-room trio, moved into room A).
    sphere_c = np.array([-2.8, -1.35, 0.55], np.float32)
    sphere_r = 0.6
    box_c = np.array([-3.2, -1.5, -1.2], np.float32)
    box_half = np.array([0.45, 0.5, 0.45], np.float32)
    box_round = 0.04
    cyl_c = np.array([-1.2, -1.3, -1.6], np.float32)
    cyl_r = 0.35
    cyl_h = 0.7
    # Room B furniture.
    torus_c = np.array([2.6, -1.55, 1.2], np.float32)
    torus_R = 0.55
    torus_r = 0.22
    ward_c = np.array([3.55, -1.0, -1.8], np.float32)
    ward_half = np.array([0.4, 1.0, 0.35], np.float32)
    sph2_c = np.array([1.2, -1.55, -1.7], np.float32)
    sph2_r = 0.4

    def _parts(self, p) -> Tuple:
        xp = _ns(p)
        c = xp.const
        walls = xp.maximum(
            xp.maximum(_box_interior(p, self.room_a, self.room_half),
                       _box_interior(p, self.room_b, self.room_half)),
            _box_interior(p, self.door_c, self.door_half))

        sph = xp.norm(p - c(self.sphere_c), axis=-1) - self.sphere_r
        box = _rounded_box(p, self.box_c, self.box_half, self.box_round)
        cyl = _capped_cylinder(p, self.cyl_c, self.cyl_r, self.cyl_h)

        pt = p - c(self.torus_c)
        ring = xp.sqrt(pt[..., 0] ** 2 + pt[..., 2] ** 2) - self.torus_R
        torus = xp.sqrt(ring ** 2 + pt[..., 1] ** 2) - self.torus_r

        ward = _rounded_box(p, self.ward_c, self.ward_half, self.box_round)
        sph2 = xp.norm(p - c(self.sph2_c), axis=-1) - self.sph2_r
        return walls, sph, box, cyl, torus, ward, sph2

    def sdf(self, p):
        xp = _ns(p)
        parts = self._parts(xp.asarray(p))
        out = parts[0]
        for d in parts[1:]:
            out = xp.minimum(out, d)
        return out

    def albedo(self, p):
        xp = _ns(p)
        p = xp.asarray(p)
        parts = self._parts(p)
        which = xp.argmin(xp.stack(parts, axis=-1), axis=-1)

        px, py, pz = p[..., 0], p[..., 1], p[..., 2]
        tex = self._wall_tex(p)
        # Face hue relative to the nearer room's center (normalized by the
        # half-size so floor, ceiling and side walls classify right), with
        # room B's palette rotated: a global which-room cue.
        in_b = (px > 0.0)
        rc = (np.where(in_b[..., None], self.room_b, self.room_a)
              if xp is _NUMPY else
              torch.where(in_b[..., None], xp.const(self.room_b),
                          xp.const(self.room_a)))
        rel = (p - rc) / xp.const(self.room_half)
        face = xp.argmax(xp.abs(rel), axis=-1)
        neg = xp.take_along_axis(rel, face[..., None], -1)[..., 0] < 0
        hues = _hues(xp, self._HUES)
        idx = (face * 2 + neg + 3 * in_b) % 6
        wall = hues[idx] * (0.40 + 0.60 * tex)

        bands = 0.5 + 0.5 * xp.sin(12.0 * py)
        sphere = xp.stack([0.75 + 0.2 * bands, 0.25 + 0.2 * bands,
                           0.20 + 0.1 * bands], axis=-1)
        stripes = 0.5 + 0.5 * xp.sin(9.0 * (px + pz))
        boxc = xp.stack([0.20 + 0.15 * stripes, 0.65 + 0.25 * stripes,
                         0.25 + 0.1 * stripes], axis=-1)
        ang = xp.arctan2(pz - float(self.cyl_c[2]), px - float(self.cyl_c[0]))
        spin = 0.5 + 0.5 * xp.sin(6.0 * ang)
        cylc = xp.stack([0.20 + 0.1 * spin, 0.30 + 0.2 * spin,
                         0.70 + 0.25 * spin], axis=-1)
        angt = xp.arctan2(pz - float(self.torus_c[2]),
                          px - float(self.torus_c[0]))
        tspin = 0.5 + 0.5 * xp.sin(8.0 * angt + 4.0 * py)
        torc = xp.stack([0.70 + 0.2 * tspin, 0.55 + 0.15 * tspin,
                         0.20 + 0.1 * tspin], axis=-1)
        wstripes = 0.5 + 0.5 * xp.sin(11.0 * py + 5.0 * pz)
        wardc = xp.stack([0.45 + 0.2 * wstripes, 0.30 + 0.1 * wstripes,
                          0.15 + 0.1 * wstripes], axis=-1)
        checks = 0.5 + 0.5 * xp.sin(10.0 * px) * xp.sin(10.0 * py)
        sph2c = xp.stack([0.25 + 0.1 * checks, 0.60 + 0.2 * checks,
                          0.60 + 0.25 * checks], axis=-1)

        w = which[..., None]
        out = xp.select([w == 0, w == 1, w == 2, w == 3, w == 4, w == 5,
                         w == 6],
                        [wall, sphere, boxc, cylc, torc, wardc, sph2c])
        return xp.f32(out)


class AnalyticThinScene(AnalyticScene):
    """Thin-geometry stress scene, the analog of the reference's worst
    SyntheticRGBD case ("thin geometry"): two ~3.5 cm plates (one
    standing, one floating shelf), a 3 cm rod and a table whose top and
    legs are all thin. _parts keeps the base class's 4-slot layout (room,
    A, B, C) so the inherited textured albedo applies unchanged."""

    rod_c = np.array([0.55, -1.30, -0.90], np.float32)
    rod_r = 0.03
    rod_h = 0.70

    def _parts(self, p) -> Tuple:
        xp = _ns(p)
        room = _ROOM_HALF - xp.amax(xp.abs(p), -1)

        # Standing plate + floating shelf (one thin axis each).
        plates = xp.minimum(
            _sd_box(p, [-0.70, -1.45, 0.65], [0.018, 0.55, 0.40]),
            _sd_box(p, [0.75, -0.90, 0.75], [0.35, 0.016, 0.30]))

        rod = _capped_cylinder(p, self.rod_c, self.rod_r, self.rod_h)

        # Table: thin top + 4 thin legs.
        table = _sd_box(p, [-0.85, -1.05, -0.70], [0.40, 0.018, 0.30])
        for sx in (-1, 1):
            for sz in (-1, 1):
                table = xp.minimum(table, _sd_box(
                    p, [-0.85 + 0.34 * sx, -1.50, -0.70 + 0.24 * sz],
                    [0.022, 0.43, 0.022]))
        return room, plates, rod, table


class AnalyticPlainScene(AnalyticScene):
    """Texture-poor variant: AnalyticScene's geometry with a near-uniform
    matte albedo (~5 % contrast, low-frequency only): the photometric-
    degenerate regime, where tracking leans on the depth and SDF terms."""

    def albedo(self, p):
        xp = _ns(p)
        p = xp.asarray(p)
        px, py, pz = p[..., 0], p[..., 1], p[..., 2]
        v = (0.55 + 0.035 * xp.sin(1.7 * px + 0.3) * xp.sin(1.3 * py)
             + 0.025 * xp.sin(1.1 * pz + 0.5))
        out = xp.stack([v, v * 0.97, v * 0.94], axis=-1)
        return xp.f32(xp.clip(out, 0.0, 1.0))


class AnalyticRoom2(AnalyticScene):
    """Second room variant: the same construction with another furniture
    arrangement, sizes and palette."""

    sphere_c = np.array([-0.9, -1.25, 0.9], np.float32)
    sphere_r = 0.75
    box_c = np.array([1.2, -1.45, 0.7], np.float32)
    box_half = np.array([0.55, 0.55, 0.35], np.float32)
    box_round = 0.06
    cyl_c = np.array([-0.6, -1.35, -1.2], np.float32)
    cyl_r = 0.45
    cyl_h = 0.65

    def albedo(self, p):
        # The palette reversed, so the two rooms differ photometrically.
        return _ns(p).flip_last(super().albedo(p))


class AnalyticCorridor(AnalyticScene):
    """Textureless corridor walked end to end while looking forward: the
    view-filling end wall carries almost no texture and the forward
    translation is weakly observable photometrically. Two door-jamb
    pillars and a ceiling beam are the only mid-field geometry. Pair with
    make_corridor_trajectory."""

    bound = np.array([[-2.2, 2.2], [-1.2, 1.2], [-0.95, 0.95]], np.float32)

    _room_half = np.array([2.1, 1.1, 0.85], np.float32)
    _pil1_c = np.array([-0.7, 0.0, 0.62], np.float32)
    _pil2_c = np.array([0.8, 0.0, -0.62], np.float32)
    _pil_half = np.array([0.12, 1.1, 0.22], np.float32)
    _beam_c = np.array([0.1, 1.0, 0.0], np.float32)
    _beam_half = np.array([0.10, 0.12, 0.85], np.float32)

    def _parts(self, p):
        xp = _ns(p)
        p = xp.asarray(p)
        room = _box_interior(p, np.zeros(3, np.float32), self._room_half)
        pil1 = _sd_box(p, self._pil1_c, self._pil_half)
        pil2 = _sd_box(p, self._pil2_c, self._pil_half)
        beam = _sd_box(p, self._beam_c, self._beam_half)
        return room, pil1, pil2, beam

    def albedo(self, p):
        # Near-uniform matte paint everywhere (the plain scene's contrast).
        xp = _ns(p)
        p = xp.asarray(p)
        px, py, pz = p[..., 0], p[..., 1], p[..., 2]
        v = (0.58 + 0.03 * xp.sin(1.9 * px + 0.7) * xp.sin(1.5 * pz)
             + 0.02 * xp.sin(1.2 * py + 0.2))
        out = xp.stack([v * 0.96, v, v * 0.93], axis=-1)
        return xp.f32(xp.clip(out, 0.0, 1.0))


SCENES = {"room": AnalyticScene, "apartment": AnalyticApartment,
          "thin": AnalyticThinScene, "plain": AnalyticPlainScene,
          "room2": AnalyticRoom2, "corridor": AnalyticCorridor}


# ---------------------------------------------------------------------------
# Sphere tracers
# ---------------------------------------------------------------------------


def render_frame(scene: AnalyticScene, c2w: np.ndarray, H: int, W: int,
                 fx: float, fy: float, cx: float, cy: float,
                 max_steps: int = 96, far: float = 12.0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Sphere-trace one frame on the host -> (rgb [H,W,3] in [0,1],
    depth [H,W]).

    Depth is the OpenGL z-depth (the ray parameter t of p = o + d*t with
    the unnormalized d of ``get_camera_rays``, whose z component is -1).
    """
    c2w = np.asarray(c2w, np.float32)
    dirs = get_camera_rays(H, W, fx, fy, cx, cy).reshape(-1, 3)
    d = (dirs @ c2w[:3, :3].T).astype(np.float32)
    o = c2w[:3, 3].astype(np.float32)
    dn = np.linalg.norm(d, axis=-1)

    n = d.shape[0]
    t = np.zeros(n, np.float32)
    active = np.arange(n)
    for _ in range(max_steps):
        p = o + d[active] * t[active, None]
        s = scene.sdf(p)
        t[active] += 0.95 * s / dn[active]
        keep = (np.abs(s) > 1e-4) & (t[active] < far)
        active = active[keep]
        if active.size == 0:
            break
    # Undamped polish: SDF is exact, two Newton steps land on the surface.
    for _ in range(2):
        p = o + d * t[:, None]
        t += scene.sdf(p) / dn
    t = np.clip(t, 0.0, far)
    rgb = scene.shade(o + d * t[:, None]).reshape(H, W, 3)
    return rgb, t.reshape(H, W).astype(np.float32)


class DeviceRenderer:
    """The sphere tracer on a torch device, with :func:`render_frame`'s
    contract (rgb f32 [H,W,3] in [0,1], z-depth f32 [H,W], as numpy
    arrays) and its steps: up to ``max_steps`` damped steps of each ray
    still active (|sdf| > 1e-4 and t < far after its step), then two
    undamped Newton steps of every ray. The scene methods run on the
    tensors (module-generic), so the math is the numpy tracer's; the
    tensors stay on ``device`` (a CUDA device raises there if there is
    none)."""

    def __init__(self, scene: AnalyticScene, H: int, W: int, fx: float,
                 fy: float, cx: float, cy: float, device="cuda",
                 max_steps: int = 96, far: float = 12.0):
        self.scene, self.H, self.W = scene, H, W
        self.device = torch.device(device)
        self.max_steps, self.far = max_steps, far
        self.dirs = torch.from_numpy(
            get_camera_rays(H, W, fx, fy, cx, cy).reshape(-1, 3)).to(
                self.device)

    def __call__(self, c2w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        return self.render_many(np.asarray(c2w)[None])[0]

    @torch.no_grad()
    def render_many(self, c2ws: np.ndarray):
        """[(rgb, depth)] of each pose of c2ws [B, 4, 4], traced together
        (each ray's steps are its own, so the frames are those of B
        calls)."""
        c2w = torch.from_numpy(np.asarray(c2ws, np.float32)).to(self.device)
        B, n = c2w.shape[0], self.dirs.shape[0]
        d = torch.einsum("nj,bij->bni", self.dirs, c2w[:, :3, :3]).reshape(
            B * n, 3)
        o = c2w[:, None, :3, 3].expand(B, n, 3).reshape(B * n, 3)
        dn = _TorchNS.norm(d, axis=-1)
        scene, far = self.scene, self.far
        t = torch.zeros(B * n, device=self.device)
        active = torch.ones_like(t, dtype=torch.bool)
        for step in range(self.max_steps):
            s = scene.sdf(o + d * t[:, None])
            t = torch.where(active, t + 0.95 * s / dn, t)
            active &= (s.abs() > 1e-4) & (t < far)
            if step % 8 == 7 and not bool(active.any()):
                break
        for _ in range(2):
            t = t + scene.sdf(o + d * t[:, None]) / dn
        t = torch.clamp(t, 0.0, far)
        rgb = scene.shade(o + d * t[:, None]).reshape(B, self.H, self.W, 3)
        rgb, t = rgb.cpu().numpy(), t.reshape(B, self.H, self.W).cpu().numpy()
        return list(zip(rgb, t))


# The JAX package's rule: below this much pixel-work the host tracer is
# cheaper than building the device one. 40M = ~130 frames at 480x640.
_DEVICE_RENDER_MIN_PIXEL_FRAMES = 40_000_000


def make_renderer(scene: AnalyticScene, H: int, W: int, fx: float,
                  fy: float, cx: float, cy: float,
                  n_frames: Optional[int] = None, device="cuda"):
    """:func:`render_frame` bound to (scene, camera): the tracer on the
    card (:class:`DeviceRenderer`) when ``device`` is a CUDA device and
    the job is big enough (``n_frames`` hint; None = assume big), else
    the numpy tracer."""
    big = (n_frames is None
           or n_frames * H * W >= _DEVICE_RENDER_MIN_PIXEL_FRAMES)
    if big and torch.device(device).type == "cuda":
        return DeviceRenderer(scene, H, W, fx, fy, cx, cy, device)
    return lambda c2w: render_frame(scene, c2w, H, W, fx, fy, cx, cy)


# ---------------------------------------------------------------------------
# Trajectories
# ---------------------------------------------------------------------------


def _look_at(eye: np.ndarray, target: np.ndarray,
             up=np.array([0.0, 1.0, 0.0])) -> np.ndarray:
    """OpenGL c2w: camera -z looks from eye toward target."""
    z = eye - target
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, eye
    return c2w


def make_scan_trajectory(n: int, deg_per_frame: float = 1.5) -> np.ndarray:
    """[n, 4, 4] room-coverage scan: the camera drifts on a slow inner
    orbit, looking across the room at a slowly wandering point, at a
    constant angular velocity of ``deg_per_frame``."""
    poses = []
    for i in range(n):
        th = np.deg2rad(deg_per_frame) * i
        eye = np.array([1.15 * np.cos(th),
                        0.25 + 0.25 * np.sin(0.9 * th + 0.3),
                        1.15 * np.sin(th)])
        target = np.array([0.45 * np.cos(0.63 * th + 2.0),
                           -0.75 + 0.55 * np.sin(0.41 * th),
                           0.45 * np.sin(0.63 * th + 2.0)])
        poses.append(_look_at(eye, target))
    return np.stack(poses).astype(np.float32)


def make_corridor_trajectory(n: int, seed: int = 0) -> np.ndarray:
    """[n, 4, 4] corridor walk for AnalyticCorridor: the camera advances
    along +x looking mostly forward, with gentle seeded lateral sway and
    gaze wander, about 3 m of travel whatever n."""
    rng = np.random.default_rng(seed)
    phase = rng.uniform(0, 2 * np.pi, 3)
    poses = []
    for i in range(n):
        u = i / max(n - 1, 1)
        x = -1.5 + 3.0 * u
        eye = np.array([
            x,
            0.1 + 0.08 * np.sin(2.1 * np.pi * u + phase[0]),
            0.18 * np.sin(1.7 * np.pi * u + phase[1])])
        target = np.array([
            x + 1.2,
            0.05 * np.sin(2.9 * np.pi * u + phase[2]),
            0.35 * np.sin(2.3 * np.pi * u + phase[1] + 1.1)])
        poses.append(_look_at(eye, target))
    return np.stack(poses).astype(np.float32)


def _tremor(rng: np.random.Generator, n: int, scale: float,
            smooth: int = 5) -> np.ndarray:
    """Band-limited random walk [n, 3]: integrated white noise, smoothed
    with a short box filter, centred and scaled to a peak of ``scale``."""
    w = np.cumsum(rng.normal(size=(n + smooth, 3)), axis=0)
    w = np.stack([np.convolve(w[:, k], np.ones(smooth) / smooth,
                              mode="valid") for k in range(3)], -1)
    w = w[:n] - w[:n].mean(axis=0)
    return (scale * w / max(np.abs(w).max(), 1e-9)).astype(np.float32)


def make_handheld_trajectory(n: int, seed: int = 0,
                             deg_per_frame: float = 1.0) -> np.ndarray:
    """[n, 4, 4] TUM-style handheld trajectory: a desk-orbit base path
    with hand tremor and jerky attention shifts (~1 deg/frame on average,
    peaks ~2.5x the mean, beyond the constant-speed prediction)."""
    rng = np.random.default_rng(seed)
    eye_j = _tremor(rng, n, 0.035)           # ~cm-scale positional tremor
    tgt_j = _tremor(rng, n, 0.11, smooth=3)  # jerky attention shifts
    roll_j = _tremor(rng, n, 0.06, smooth=4)[:, 0]  # radians of roll

    poses = []
    for i in range(n):
        th = np.deg2rad(deg_per_frame) * i
        eye = np.array([1.2 * np.cos(th),
                        0.30 + 0.18 * np.sin(0.83 * th + 0.4),
                        1.2 * np.sin(th)]) + eye_j[i]
        target = np.array([0.4 * np.cos(0.57 * th + 2.1),
                           -0.8 + 0.45 * np.sin(0.37 * th),
                           0.4 * np.sin(0.57 * th + 2.1)]) + tgt_j[i]
        up = np.array([np.sin(roll_j[i]), np.cos(roll_j[i]), 0.0])
        poses.append(_look_at(eye, target, up=up))
    return np.stack(poses).astype(np.float32)


def make_walkthrough_trajectory(n: int, seed: int = 0) -> np.ndarray:
    """[n, 4, 4] ScanNet-style walkthrough of :class:`AnalyticApartment`:
    orbit room A, pass the doorway, orbit room B, with handheld tremor
    throughout. Below 160 frames it is a partial orbit of room A; the
    phases are joined by a box filter so velocities stay continuous."""
    rng = np.random.default_rng(seed)

    orbit_rate = np.deg2rad(1.2)            # rad/frame
    if n < 160:
        n_a, n_t, n_b = n, 0, 0
    else:
        n_t = 63                            # 2.5 m at ~4 cm/frame
        n_a = (n - n_t) // 2
        n_b = n - n_t - n_a
    a_c = AnalyticApartment.room_a
    b_c = AnalyticApartment.room_b

    door = AnalyticApartment.door_c
    p0 = np.array([-1.25, 0.05, door[2]], np.float32)  # transit endpoints
    p1 = np.array([1.25, 0.05, door[2]], np.float32)

    def yaw_pitch(d):
        d = d / max(np.linalg.norm(d), 1e-9)
        return (float(np.arctan2(d[2], d[0])),
                float(np.arcsin(np.clip(d[1], -1.0, 1.0))))

    def gaze_schedule(d_from, d_to):
        """Fixed yaw/pitch turn schedule between two view directions,
        computed once per phase (re-deriving it per frame flips the
        rotation plane near 180-degree turns)."""
        y0, p0_ = yaw_pitch(d_from)
        y1, p1_ = yaw_pitch(d_to)
        dyaw = (y1 - y0 + np.pi) % (2 * np.pi) - np.pi
        return lambda t: np.array(
            [np.cos(p0_ + t * (p1_ - p0_)) * np.cos(y0 + t * dyaw),
             np.sin(p0_ + t * (p1_ - p0_)),
             np.cos(p0_ + t * (p1_ - p0_)) * np.sin(y0 + t * dyaw)],
            np.float32)

    eyes, tgts = [], []
    # Phase A: inward orbit of room A ending at the transit start p0; the
    # look-at ramps from room-center wander to the door over the last
    # third.
    ahead_vec = np.array([1.5, -0.3, 0.0], np.float32)

    rel0 = p0 - a_c
    th_end = float(np.arctan2(rel0[2], rel0[0]))
    r_a = float(np.hypot(rel0[0], rel0[2]))
    ang_a = min(2.6 * np.pi, orbit_rate * n_a)

    def eye_wander_a(u):
        th = th_end + ang_a * (u - 1.0)
        h = p0[1] + (0.2 + 0.15 * np.sin(0.7 * th)) * (1 - u)
        eye = np.array([a_c[0] + r_a * np.cos(th), h,
                        a_c[2] + r_a * np.sin(th)], np.float32)
        wander = a_c + np.array([0.35 * np.cos(0.57 * th + 2.0), -0.9,
                                 0.35 * np.sin(0.57 * th + 2.0)],
                                np.float32)
        return eye, wander

    turn_a = min(max(45, int(0.33 * n_a)), max(n_a - 1, 1))
    u_turn = 1.0 - turn_a / max(n_a - 1, 1) if n_t else 2.0
    e_t, w_t = eye_wander_a(u_turn)
    sched_a = gaze_schedule(w_t - e_t, ahead_vec)
    for i in range(n_a):
        u = i / max(n_a - 1, 1)
        eye, wander = eye_wander_a(u)
        eyes.append(eye)
        if u <= u_turn:
            tgts.append(wander)
        else:  # turn toward the door over the final stretch
            s = (u - u_turn) / (1.0 - u_turn)
            s = s * s * (3 - 2 * s)
            tgts.append(eye + 1.5 * sched_a(s))
    # Phase T: straight transit through the door center, looking ahead.
    for i in range(n_t):
        s = i / max(n_t - 1, 1)
        s = s * s * (3 - 2 * s)  # smoothstep: ease in/out of the door
        e = p0 + (p1 - p0) * s
        eyes.append(e)
        tgts.append(e + ahead_vec)
    # Phase B: inward orbit of room B from the transit end p1; the gaze
    # turns from look-ahead to room-center wander over the first third.
    rel1 = p1 - b_c
    th0 = float(np.arctan2(rel1[2], rel1[0]))
    r_b = float(np.hypot(rel1[0], rel1[2]))
    ang_b = min(2.6 * np.pi, orbit_rate * n_b)

    def eye_wander_b(u):
        th = th0 + ang_b * u
        h = p1[1] + (0.2 + 0.15 * np.sin(0.7 * th + 1.0)) * u
        eye = np.array([b_c[0] + r_b * np.cos(th), h,
                        b_c[2] + r_b * np.sin(th)], np.float32)
        wander = b_c + np.array([0.35 * np.cos(0.57 * th + 0.5), -0.9,
                                 0.35 * np.sin(0.57 * th + 0.5)],
                                np.float32)
        return eye, wander

    turn_b = min(max(45, int(0.33 * n_b)), max(n_b - 1, 1))
    u_turn_b = turn_b / max(n_b - 1, 1)
    e_t, w_t = eye_wander_b(u_turn_b)
    sched_b = gaze_schedule(ahead_vec, w_t - e_t)
    for i in range(n_b):
        u = i / max(n_b - 1, 1)
        eye, wander = eye_wander_b(u)
        eyes.append(eye)
        if u >= u_turn_b:
            tgts.append(wander)
        else:
            s = u / u_turn_b
            s = s * s * (3 - 2 * s)
            tgts.append(eye + 1.5 * sched_b(s))

    eyes = np.asarray(eyes, np.float32)
    tgts = np.asarray(tgts, np.float32)
    # Join phases smoothly: box-filter each coordinate (edge-padded).
    k = max(min(n // 40, 15), 1)
    if k > 1:
        pad = k // 2
        for arr in (eyes, tgts):
            ext = np.concatenate([np.repeat(arr[:1], pad, 0), arr,
                                  np.repeat(arr[-1:], pad, 0)])
            for c in range(3):
                arr[:, c] = np.convolve(ext[:, c], np.ones(k) / k,
                                        mode="valid")[:n]

    # Handheld tremor (the TUM protocol's statistics).
    eyes = eyes + _tremor(rng, n, 0.03)
    tgts = tgts + _tremor(rng, n, 0.09, smooth=3)
    roll = _tremor(rng, n, 0.05, smooth=4)[:, 0]
    poses = []
    for e, t, r in zip(eyes, tgts, roll):
        up = np.array([np.sin(r), np.cos(r), 0.0])
        poses.append(_look_at(e, t, up=up))
    return np.stack(poses).astype(np.float32)


# ---------------------------------------------------------------------------
# Sensor noise and motion blur
# ---------------------------------------------------------------------------


def _cubic_coeffs(f: np.ndarray) -> Tuple[np.ndarray, ...]:
    """The four bicubic weights of fractional offsets f (float32), the
    Keys kernel with a = -0.75, written as OpenCV's interpolateCubic."""
    A = np.float32(-0.75)
    one, f1, g = np.float32(1), f + np.float32(1), np.float32(1) - f
    c0 = ((A * f1 - 5 * A) * f1 + 8 * A) * f1 - 4 * A
    c1 = ((A + 2) * f - (A + 3)) * f * f + one
    c2 = ((A + 2) * g - (A + 3)) * g * g + one
    return c0, c1, c2, one - c0 - c1 - c2


def _cubic_taps(n_out: int, n_in: int):
    """(tap indices [4, n_out], weights [4, n_out]) of one axis: sources
    at half-pixel centres, taps clamped to the edge (replicated border)."""
    x = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    sx = np.floor(x)
    coeffs = _cubic_coeffs((x - sx).astype(np.float32))
    sx = sx.astype(np.int64)
    idx = np.stack([np.clip(sx + k, 0, n_in - 1) for k in (-1, 0, 1, 2)])
    return idx, np.stack(coeffs)


def resize_cubic(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Bicubic resize of a float32 [h, w] image to ``size`` = (W, H): what
    ``cv2.resize(img, size, interpolation=cv2.INTER_CUBIC)`` computes
    (a = -0.75, half-pixel centres, replicated border; rows first, then
    columns, in float32)."""
    Wo, Ho = size
    img = np.asarray(img, np.float32)
    xi, xw = _cubic_taps(Wo, img.shape[1])
    rows = img[:, xi[0]] * xw[0]
    for k in range(1, 4):
        rows = rows + img[:, xi[k]] * xw[k]
    yi, yw = _cubic_taps(Ho, img.shape[0])
    out = rows[yi[0]] * yw[0][:, None]
    for k in range(1, 4):
        out = out + rows[yi[k]] * yw[k][:, None]
    return out.astype(np.float32)


def add_kinect_noise(depth: np.ndarray, rng: np.random.Generator,
                     sigma0: float = 0.0012, sigma_quad: float = 0.0019,
                     hole_grad: float = 0.05,
                     speckle_frac: float = 0.015) -> np.ndarray:
    """Kinect-like sensor corruption of an exact depth map [H, W] (m):
    axial Gaussian noise with quadratic-in-z sigma; dropout at depth
    discontinuities and grazing surfaces (a screen-space depth-gradient
    threshold, ``hole_grad`` meters per pixel at a 640-wide image, scaled
    by the width); and random speckle dropout blobs (a low-frequency
    noise field, upsampled bicubically and thresholded). Invalid pixels
    get depth 0.0, the TUM loader's convention."""
    z = depth.astype(np.float32)
    sigma = sigma0 + sigma_quad * np.square(np.maximum(z - 0.4, 0.0))
    noisy = z + rng.normal(size=z.shape).astype(np.float32) * sigma

    gy, gx = np.gradient(z)
    holes = np.hypot(gx, gy) > hole_grad * (640.0 / z.shape[1])

    h8, w8 = max(z.shape[0] // 24, 2), max(z.shape[1] // 24, 2)
    field = rng.normal(size=(h8, w8)).astype(np.float32)
    field = resize_cubic(field, (z.shape[1], z.shape[0]))
    holes |= field > np.quantile(field, 1.0 - speckle_frac)

    noisy[holes] = 0.0
    return np.maximum(noisy, 0.0)


def interpolate_pose(p0: np.ndarray, p1: np.ndarray,
                     u: float) -> np.ndarray:
    """Pose interpolation between two c2w poses: the relative delta
    ``p1 @ inv(p0)`` scaled by ``u`` as an axis-angle rotation plus a
    linearly scaled translation (endpoints exact, O(angle^2) off the SE(3)
    geodesic for sub-frame deltas). u=0 -> p0, u=1 -> p1."""
    from scipy.spatial.transform import Rotation

    p0 = np.asarray(p0, np.float64)
    delta = np.asarray(p1, np.float64) @ np.linalg.inv(p0)
    rotvec = Rotation.from_matrix(delta[:3, :3]).as_rotvec()
    out = np.eye(4)
    out[:3, :3] = Rotation.from_rotvec(u * rotvec).as_matrix()
    out[:3, 3] = u * delta[:3, 3]
    return (out @ p0).astype(np.float32)


def make_blur_renderer(render, poses: np.ndarray, shutter: float,
                       taps: int = 5):
    """Wrap a bound ``render(c2w) -> (rgb, depth)`` with camera motion
    blur: frame i's RGB becomes the average of ``taps`` renders at poses
    interpolated across a shutter window of ``shutter`` frame intervals
    centred on pose i (toward pose i-1 / i+1, clamped at the ends). Depth
    keeps the centre tap only (a separate short IR exposure).

    Returns ``render2(i) -> (rgb, depth)`` indexed by frame number."""
    n = len(poses)
    offsets = np.linspace(-0.5, 0.5, max(int(taps), 2)) * float(shutter)

    def render2(i: int):
        center_rgb, depth = render(poses[i])
        acc = np.zeros_like(center_rgb)
        for u in offsets:
            j = (min(i + 1, n - 1)) if u >= 0 else (max(i - 1, 0))
            if u == 0.0 or j == i:
                # The tap pose is the centre pose: reuse its render.
                acc += center_rgb
                continue
            acc += render(interpolate_pose(poses[i], poses[j], abs(u)))[0]
        return acc / len(offsets), depth

    return render2


def exposure_drift_walk(n: int, drift: float, seed: int = 0) -> np.ndarray:
    """Per-frame exposure parameters [n, 4] (3 gains + offset) following
    a random walk: log-gains and offset integrate N(0, drift) /
    N(0, drift/10) steps (auto-exposure and white-balance drift)."""
    rng = np.random.default_rng(seed)
    log_gain = np.cumsum(rng.normal(0.0, drift, (n, 3)), axis=0)
    offset = np.cumsum(rng.normal(0.0, drift * 0.1, (n, 1)), axis=0)
    return np.concatenate([np.exp(log_gain), offset],
                          axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# Protocol frames: what each writer stores, before any image codec
# ---------------------------------------------------------------------------


def _to_u8(rgb: np.ndarray) -> np.ndarray:
    return (rgb * 255).astype(np.uint8)


def _to_u16(depth: np.ndarray, scale: float) -> np.ndarray:
    return np.clip(depth * scale, 0, 65535).astype(np.uint16)


def _cv_pose(c2w: np.ndarray) -> np.ndarray:
    """OpenGL c2w -> the OpenCV-convention float64 pose the files store."""
    cv = np.array(c2w, np.float64)
    cv[:3, 1] *= -1
    cv[:3, 2] *= -1
    return cv


def _tum_stamps(n: int, seed: int, fps: float):
    """The TUM writer's (t_rgb, t_depth, t_gt) per frame."""
    rng_t = np.random.default_rng(seed + 977)
    out = []
    for i in range(n):
        t_rgb = i / fps + abs(float(rng_t.normal()) * 1e-3)
        t_depth = t_rgb + 0.008 + float(rng_t.normal()) * 2e-3
        t_gt = t_rgb + float(rng_t.normal()) * 1e-3
        out.append((t_rgb, t_depth, t_gt))
    return out


def _tum_gt_line(t_gt: float, c2w: np.ndarray) -> str:
    from scipy.spatial.transform import Rotation

    cv = _cv_pose(c2w)
    q = Rotation.from_matrix(cv[:3, :3]).as_quat()  # x y z w
    return f"{t_gt:.6f} " + " ".join(f"{v:.6f}" for v in (*cv[:3, 3], *q))


_TRACE_BATCH = 8


def _render_protocol(protocol: str, scene: AnalyticScene, poses: np.ndarray,
                     H: int, W: int, fx: float, fy: float, cx: float,
                     cy: float, png_depth_scale: float, seed: int = 0,
                     depth_noise: bool = True, motion_blur: float = 0.0,
                     blur_taps: int = 5, exposure_drift: float = 0.0,
                     device="cuda", frames=None):
    """Yield (i, rgb uint8 [H,W,3], depth uint16 [H,W]) of each frame as
    the protocol's writer stores it (before the image codec): the render,
    the protocol's blur, exposure drift and depth noise, quantized.
    ``frames`` limits it to those indices."""
    render = make_renderer(scene, H, W, fx, fy, cx, cy,
                           n_frames=len(poses), device=device)
    blurred = (make_blur_renderer(render, poses, motion_blur, blur_taps)
               if protocol == "tum" and motion_blur > 0 else None)
    expo = (exposure_drift_walk(len(poses), exposure_drift, seed)
            if protocol == "replica" and exposure_drift > 0 else None)
    order = list(range(len(poses)) if frames is None else frames)
    if isinstance(render, DeviceRenderer) and blurred is None:
        # The card traces a batch of frames at once (fewer launches).
        done = {}

        def sharp(i):
            if i not in done:
                batch = order[order.index(i):order.index(i) + _TRACE_BATCH]
                done.clear()
                done.update(zip(batch, render.render_many(poses[batch])))
            return done.pop(i)
    else:
        sharp = (blurred if blurred is not None
                 else lambda i: render(poses[i]))
    for i in order:
        rgb, depth = sharp(i)
        if expo is not None:
            rgb = np.clip(rgb * expo[i, :3] + expo[i, 3], 0.0, 1.0)
        if depth_noise and protocol in ("tum", "scannet"):
            depth = add_kinect_noise(
                depth, np.random.default_rng(seed * 100003 + i))
        elif depth_noise and protocol == "rgbd":
            depth = add_kinect_noise(
                depth, np.random.default_rng(seed * 100003 + i),
                hole_grad=np.inf, speckle_frac=0.0)
        yield i, _to_u8(rgb), _to_u16(depth, png_depth_scale)


# ---------------------------------------------------------------------------
# On-disk writers (the disk route; cv2 is imported inside each)
# ---------------------------------------------------------------------------


def _bgr(rgb8: np.ndarray) -> np.ndarray:
    import cv2

    return cv2.cvtColor(rgb8, cv2.COLOR_RGB2BGR)


def write_tum_format(datadir: str, scene: AnalyticScene, poses: np.ndarray,
                     H: int, W: int, fx: float, fy: float, cx: float,
                     cy: float, png_depth_scale: float = 5000.0,
                     fps: float = 30.0, depth_noise: bool = True,
                     seed: int = 0, motion_blur: float = 0.0,
                     blur_taps: int = 5, device="cuda") -> None:
    """Render ``poses`` and write the TUM RGB-D layout: rgb/<t>.png +
    depth/<t>.png + rgb.txt / depth.txt / groundtruth.txt. Timestamps
    carry per-stream jitter (rgb/depth offset ~8 ms) so the loader's
    association does real matching; groundtruth.txt stores quaternion +
    translation rows in the OpenCV convention. ``depth_noise`` applies
    :func:`add_kinect_noise` with a per-frame seed; ``motion_blur`` > 0
    renders each RGB frame through :func:`make_blur_renderer`."""
    extra = (None if (depth_noise and seed == 0 and not motion_blur)
             else ("noise", depth_noise, seed)
             + (("blur", motion_blur, blur_taps) if motion_blur else ()))
    _fresh_render_dir(datadir, poses, H, W, extra=extra)
    import cv2

    os.makedirs(os.path.join(datadir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(datadir, "depth"), exist_ok=True)
    stamps = _tum_stamps(len(poses), seed, fps)
    rel = [(f"rgb/{tr:.6f}.png", f"depth/{td:.6f}.png")
           for tr, td, _ in stamps]
    todo = [i for i, (r, d) in enumerate(rel)
            if not (os.path.exists(os.path.join(datadir, r))
                    and os.path.exists(os.path.join(datadir, d)))]
    for i, rgb8, d16 in _render_protocol(
            "tum", scene, poses, H, W, fx, fy, cx, cy, png_depth_scale,
            seed, depth_noise, motion_blur, blur_taps, device=device,
            frames=todo):
        cv2.imwrite(os.path.join(datadir, rel[i][0]), _bgr(rgb8))
        cv2.imwrite(os.path.join(datadir, rel[i][1]), d16)
    rgb_lines = [f"{tr:.6f} {r}" for (tr, _, _), (r, _) in zip(stamps, rel)]
    depth_lines = [f"{td:.6f} {d}" for (_, td, _), (_, d) in zip(stamps, rel)]
    gt_lines = [_tum_gt_line(tg, c2w) for (_, _, tg), c2w in zip(stamps,
                                                                 poses)]
    for name, lines in (("rgb.txt", rgb_lines), ("depth.txt", depth_lines),
                        ("groundtruth.txt", gt_lines)):
        with open(os.path.join(datadir, name), "w") as f:
            f.write(f"# synthetic TUM-format sequence\n"
                    + "\n".join(lines) + "\n")


def write_scannet_format(datadir: str, scene: AnalyticScene,
                         poses: np.ndarray, H: int, W: int, fx: float,
                         fy: float, cx: float, cy: float,
                         png_depth_scale: float = 1000.0,
                         depth_noise: bool = True, seed: int = 0,
                         device="cuda") -> None:
    """Render ``poses`` and write the ScanNet layout: color/<i>.jpg +
    depth/<i>.png (mm) + pose/<i>.txt (4x4 OpenCV matrices), with the TUM
    writer's sensor noise."""
    _fresh_render_dir(datadir, poses, H, W,
                      extra=(None if (depth_noise and seed == 0)
                             else ("noise", depth_noise, seed)))
    import cv2

    for sub in ("color", "depth", "pose"):
        os.makedirs(os.path.join(datadir, sub), exist_ok=True)
    todo = [i for i in range(len(poses))
            if not (os.path.exists(os.path.join(datadir, "color", f"{i}.jpg"))
                    and os.path.exists(os.path.join(datadir, "depth",
                                                    f"{i}.png")))]
    for i, rgb8, d16 in _render_protocol(
            "scannet", scene, poses, H, W, fx, fy, cx, cy, png_depth_scale,
            seed, depth_noise, device=device, frames=todo):
        cv2.imwrite(os.path.join(datadir, "color", f"{i}.jpg"), _bgr(rgb8),
                    [cv2.IMWRITE_JPEG_QUALITY, 97])
        cv2.imwrite(os.path.join(datadir, "depth", f"{i}.png"), d16)
    for i, c2w in enumerate(poses):
        np.savetxt(os.path.join(datadir, "pose", f"{i}.txt"), _cv_pose(c2w))


def _rgbd_pose_lines(poses: np.ndarray, invalid: Sequence[int]):
    invalid = set(int(i) for i in invalid)
    lines = []
    for i, c2w in enumerate(poses):
        if i in invalid:
            lines.extend(["nan nan nan nan"] * 4)
        else:
            for row in np.asarray(c2w, np.float64):
                lines.append(" ".join(f"{v:.10f}" for v in row))
    return lines


def write_rgbd_format(datadir: str, scene: AnalyticScene,
                      poses: np.ndarray, H: int, W: int, fx: float,
                      fy: float, cx: float, cy: float,
                      png_depth_scale: float = 1000.0,
                      depth_noise: bool = True, seed: int = 0,
                      invalid: Sequence[int] = (), device="cuda") -> None:
    """Render ``poses`` and write the NeuralRGBD layout:
    images/img####.png + depth_filtered/depth####.png (mm) + poses.txt
    with four text lines per 4x4 OpenGL matrix. Frames in ``invalid`` get
    an all-nan pose block (the loader drops them; their images are still
    written). The depth noise is the Kinect model without dropout holes
    (the filtered stream has none)."""
    _fresh_render_dir(datadir, poses, H, W,
                      extra=(None if (depth_noise and seed == 0)
                             else ("noise", depth_noise, seed)))
    import cv2

    os.makedirs(os.path.join(datadir, "images"), exist_ok=True)
    os.makedirs(os.path.join(datadir, "depth_filtered"), exist_ok=True)
    paths = [(os.path.join(datadir, "images", f"img{i:04d}.png"),
              os.path.join(datadir, "depth_filtered", f"depth{i:04d}.png"))
             for i in range(len(poses))]
    todo = [i for i, (r, d) in enumerate(paths)
            if not (os.path.exists(r) and os.path.exists(d))]
    for i, rgb8, d16 in _render_protocol(
            "rgbd", scene, poses, H, W, fx, fy, cx, cy, png_depth_scale,
            seed, depth_noise, device=device, frames=todo):
        cv2.imwrite(paths[i][0], _bgr(rgb8))
        cv2.imwrite(paths[i][1], d16)
    with open(os.path.join(datadir, "poses.txt"), "w") as f:
        f.write("\n".join(_rgbd_pose_lines(poses, invalid)) + "\n")


def _replica_pose_line(c2w: np.ndarray) -> str:
    # The loader flips y/z columns back to OpenGL; pre-flip on write.
    return " ".join(f"{v:.10f}" for v in _cv_pose(c2w).reshape(-1))


def write_replica_format(datadir: str, scene: AnalyticScene,
                         poses: np.ndarray, H: int, W: int, fx: float,
                         fy: float, cx: float, cy: float,
                         png_depth_scale: float = 6553.5,
                         exposure_drift: float = 0.0,
                         exposure_seed: int = 0, device="cuda") -> None:
    """Render ``poses`` and write the Replica layout
    (results/frame%06d.jpg + results/depth%06d.png + traj.txt).
    exposure_drift > 0 applies a per-frame gain/offset random walk to the
    rendered RGB (depth untouched)."""
    import cv2

    _fresh_render_dir(datadir, poses, H, W,
                      extra=((exposure_drift, exposure_seed)
                             if exposure_drift > 0 else None))
    results = os.path.join(datadir, "results")
    os.makedirs(results, exist_ok=True)
    todo = [i for i in range(len(poses))
            if not (os.path.exists(os.path.join(results, f"frame{i:06d}.jpg"))
                    and os.path.exists(os.path.join(results,
                                                    f"depth{i:06d}.png")))]
    for i, rgb8, d16 in _render_protocol(
            "replica", scene, poses, H, W, fx, fy, cx, cy, png_depth_scale,
            exposure_seed, exposure_drift=exposure_drift, device=device,
            frames=todo):
        cv2.imwrite(os.path.join(results, f"frame{i:06d}.jpg"), _bgr(rgb8),
                    [cv2.IMWRITE_JPEG_QUALITY, 97])
        cv2.imwrite(os.path.join(results, f"depth{i:06d}.png"), d16)
    with open(os.path.join(datadir, "traj.txt"), "w") as f:
        f.write("\n".join(_replica_pose_line(c) for c in poses) + "\n")


def _fresh_render_dir(datadir: str, poses: np.ndarray, H: int,
                      W: int, extra=None) -> None:
    """Resumable-render cache guard: cached frames are valid only for the
    same trajectory and resolution (make_walkthrough_trajectory is not
    prefix-stable in n), so a stamp of (poses, H, W[, extra render
    params]) clears the directory on a mismatch."""
    import hashlib
    import shutil

    h = hashlib.sha1()
    h.update(np.asarray(poses, np.float64).tobytes())
    h.update(np.asarray([H, W], np.int64).tobytes())
    if extra is not None:
        h.update(repr(extra).encode())
    want = h.hexdigest()
    stamp = os.path.join(datadir, ".render_stamp")
    if os.path.isdir(datadir):
        have = (open(stamp).read().strip() if os.path.exists(stamp)
                else None)
        if have != want:
            shutil.rmtree(datadir)
    os.makedirs(datadir, exist_ok=True)
    with open(stamp, "w") as f:
        f.write(want)


def dataset_content_hash(datadir: str, sample_every: int = 7) -> str:
    """Content fingerprint of a rendered dataset directory: sha1 over the
    sorted file list, every file's size, and the full bytes of every
    ``sample_every``-th file, so a reported metric is tied to the pixels
    it was measured on."""
    import hashlib

    h = hashlib.sha1()
    entries = []
    for root, _, files in os.walk(datadir):
        for f in files:
            entries.append(os.path.join(root, f))
    for i, path in enumerate(sorted(entries)):
        rel = os.path.relpath(path, datadir)
        h.update(rel.encode())
        h.update(str(os.path.getsize(path)).encode())
        if i % sample_every == 0:
            with open(path, "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


def make_synthetic_config(datadir: str, output: str, H: int = 40,
                          W: int = 52, n_frames: int = 8,
                          exp_name: str = "synth") -> Dict:
    """Full Co-SLAM config for the analytic scene (same schema as
    configs/Replica/replica.yaml, sized for small images and CPU tests)."""
    return _base_synth_config(datadir, output, H, W, n_frames, exp_name)


def make_tum_synthetic_config(datadir: str, output: str, H: int = 480,
                              W: int = 640, n_frames: int = 500,
                              exp_name: str = "synth_tum",
                              tuned: bool = True) -> Dict:
    """TUM-recipe config for the TUM-format handheld protocol: the
    reference's TUM recipe (configs/Tum/tum.yaml: 20-iteration BA over
    2048 rays, first_iters 1000, rgb_weight 1 / sdf_weight 5000 / trunc
    0.05, lr 0.01 tracking over 1024 rays, range_d 0.25 with n_range_d
    21). ``tuned`` (default) takes the tuned operating point of
    configs/Tum/fr1_desk_vm.yaml: TensoVM and a 32-sample uniform stratum
    in place of the importance stage; ``tuned=False`` is the reference
    recipe (HashGrid, 64 uniform + 128 importance samples)."""
    cfg = _base_synth_config(datadir, output, H, W, n_frames, exp_name)
    cfg["dataset"] = "tum"
    cfg["cam"].update(png_depth_scale=5000.0, depth_trunc=8.0)
    cfg["mapping"].update(sample=2048, iters=20, first_iters=1000,
                          min_pixels_cur=100)
    cfg["tracking"].update(iter=10, sample=1024, lr_rot=0.01,
                           lr_trans=0.01, ignore_edge_W=20,
                           ignore_edge_H=20, best=False)
    cfg["training"].update(rgb_weight=1.0, depth_weight=0.1,
                           sdf_weight=5000, fs_weight=10,
                           smooth_weight=1e-8, smooth_pts=64,
                           smooth_vox=0.04, smooth_margin=0.0,
                           range_d=0.25, n_range_d=21, trunc=0.05,
                           rgb_missing=1.0)
    cfg["grid"].update(hash_size=16, voxel_color=0.04, voxel_sdf=0.02)
    if tuned:
        cfg["grid"].update(enc="TensoVM", triplane_levels=3)
        cfg["training"].update(n_samples_d=32, n_importance=0)
    else:
        cfg["training"].update(n_samples_d=64, n_importance=128)
    return cfg


def make_scannet_synthetic_config(datadir: str, output: str, H: int = 480,
                                  W: int = 640, n_frames: int = 1000,
                                  exp_name: str = "synth_scannet",
                                  tuned: bool = True) -> Dict:
    """ScanNet-recipe config for the apartment walkthrough: the
    reference's ScanNet recipe (configs/ScanNet/scannet.yaml: 2048-ray
    10-iteration BA with optim_cur off, rgb_weight 5 / sdf_weight 1000 /
    trunc 0.1, smooth_weight 1e-3 over 0.1 m voxels, quat pose tangents,
    crop_edge 10, mm depth) with bounds covering the 8.6 m apartment.
    ``tuned`` (default) takes configs/ScanNet/scene0000_vm.yaml's
    operating point: TensoVM, a 32-sample uniform stratum and 20 tracking
    iterations; ``tuned=False`` is the reference recipe (HashGrid
    hash_size 19, n_samples_d 96)."""
    cfg = _base_synth_config(datadir, output, H, W, n_frames, exp_name)
    cfg["dataset"] = "scannet"
    cfg["cam"].update(png_depth_scale=1000.0, crop_edge=10,
                      depth_trunc=8.0, far=8)
    b = AnalyticApartment.bound
    cfg["mapping"].update(
        sample=2048, iters=10, first_iters=500, optim_cur=False,
        min_pixels_cur=20,
        bound=[[float(lo - 0.3), float(hi + 0.3)] for lo, hi in b],
        marching_cubes_bound=[[float(lo), float(hi)] for lo, hi in b])
    cfg["tracking"].update(iter=10, sample=1024, lr_rot=0.001,
                           lr_trans=0.001, ignore_edge_W=20,
                           ignore_edge_H=20, best=True)
    cfg["training"].update(rgb_weight=5.0, depth_weight=0.1,
                           sdf_weight=1000, fs_weight=10,
                           smooth_weight=0.001, smooth_pts=64,
                           smooth_vox=0.1, smooth_margin=0.05,
                           range_d=0.25, n_range_d=21, trunc=0.1,
                           rot_rep="quat", rgb_missing=0.0)
    cfg["grid"].update(hash_size=19, voxel_color=0.08, voxel_sdf=0.04)
    if tuned:
        cfg["grid"].update(enc="TensoVM", triplane_levels=3)
        cfg["training"].update(n_samples_d=32)
        cfg["tracking"].update(iter=20)
    else:
        cfg["training"].update(n_samples_d=96)
    return cfg


def make_rgbd_synthetic_config(datadir: str, output: str, H: int = 480,
                               W: int = 640, n_frames: int = 300,
                               exp_name: str = "synth_rgbd",
                               tuned: bool = True) -> Dict:
    """SyntheticRGBD-recipe config for the NeuralRGBD-format protocol: the
    reference's recipe (configs/Synthetic/synthetic.yaml: 2048-ray
    10-iteration BA with optim_cur on, lr_embed 0.001, first_iters 200,
    voxel_sdf 0.01, smooth_weight 1e-5 over 0.1 m voxels, 32+11 samples
    with range_d 0.1, rgb_missing 0.05). ``tuned`` (default) takes the
    TensoVM 3-level pyramid with a 16-sample stratum
    (configs/Replica/room0_vm.yaml); ``tuned=False`` is the reference
    recipe (HashGrid hash_size 16)."""
    cfg = _base_synth_config(datadir, output, H, W, n_frames, exp_name)
    cfg["dataset"] = "synthetic"
    cfg["cam"].update(png_depth_scale=1000.0, depth_trunc=8.0, far=5)
    cfg["mapping"].update(sample=2048, iters=10, first_iters=200,
                          lr_embed=0.001, optim_cur=True,
                          min_pixels_cur=100)
    cfg["tracking"].update(iter=10, sample=1024, lr_rot=0.001,
                           lr_trans=0.001, ignore_edge_W=20,
                           ignore_edge_H=20, best=True)
    cfg["training"].update(rgb_weight=5.0, depth_weight=0.1,
                           sdf_weight=1000, fs_weight=10,
                           smooth_weight=1e-5, smooth_pts=32,
                           smooth_vox=0.1, smooth_margin=0.05,
                           range_d=0.1, n_range_d=11, trunc=0.1,
                           rot_rep="axis_angle", rgb_missing=0.05)
    cfg["grid"].update(hash_size=16, voxel_color=0.08, voxel_sdf=0.01)
    if tuned:
        cfg["grid"].update(enc="TensoVM", triplane_levels=3)
        cfg["training"].update(n_samples_d=16)
    else:
        cfg["training"].update(n_samples_d=32)
    return cfg


def _base_synth_config(datadir: str, output: str, H: int, W: int,
                       n_frames: int, exp_name: str) -> Dict:
    fx = 0.8 * W
    return {
        "dataset": "replica",
        "data": {"datadir": datadir, "output": output, "exp_name": exp_name,
                 "trainskip": 1, "downsample": 1, "sc_factor": 1,
                 "translation": 0, "num_workers": 0, "n_frames": n_frames},
        "cam": {"H": H, "W": W, "fx": fx, "fy": fx, "cx": (W - 1) / 2.0,
                "cy": (H - 1) / 2.0, "png_depth_scale": 6553.5,
                "crop_edge": 0, "near": 0, "far": 8, "depth_trunc": 100.0},
        "mapping": {
            "sample": 512, "first_mesh": False, "iters": 10,
            "cur_frame_iters": 0, "lr_embed": 0.01, "lr_decoder": 0.01,
            "lr_rot": 0.001, "lr_trans": 0.001, "keyframe_every": 5,
            "map_every": 5, "n_pixels": 0.05, "first_iters": 200,
            "optim_cur": True, "min_pixels_cur": 20, "map_accum_step": 1,
            "pose_accum_step": 5, "map_wait_step": 0, "filter_depth": False,
            "bound": [[-2.5, 2.5], [-2.5, 2.5], [-2.5, 2.5]],
            "marching_cubes_bound": [[-2.2, 2.2], [-2.2, 2.2], [-2.2, 2.2]],
        },
        "tracking": {
            "iter": 10, "sample": 512, "pc_samples": 1024,
            "lr_rot": 0.001, "lr_trans": 0.001, "ignore_edge_W": 4,
            "ignore_edge_H": 4, "iter_point": 0, "wait_iters": 100,
            "const_speed": True, "best": True,
            # The Huber photometric tracking kernel; 0 recovers plain MSE.
            "robust_delta": 0.1,
        },
        "grid": {"enc": "HashGrid", "tcnn_encoding": True, "hash_size": 13,
                 "voxel_color": 0.08, "voxel_sdf": 0.04, "oneGrid": True},
        "pos": {"enc": "OneBlob", "n_bins": 16},
        "decoder": {"geo_feat_dim": 15, "hidden_dim": 32, "num_layers": 2,
                    "num_layers_color": 2, "hidden_dim_color": 32,
                    "tcnn_network": False},
        "training": {
            "rgb_weight": 5.0, "depth_weight": 0.1, "sdf_weight": 1000,
            "fs_weight": 10, "eikonal_weight": 0, "smooth_weight": 1e-6,
            "smooth_pts": 8, "smooth_vox": 0.1, "smooth_margin": 0.05,
            "n_samples_d": 32, "range_d": 0.1, "n_range_d": 11,
            "n_importance": 0, "perturb": 1, "white_bkgd": False,
            "trunc": 0.08, "rot_rep": "axis_angle", "rgb_missing": 0.05,
        },
        "mesh": {"resolution": 128, "render_color": False, "vis": 0,
                 "voxel_eval": 0.08, "voxel_final": 0.08,
                 "visualisation": False},
    }


def room0_config(output: str, H: int = 480, W: int = 640,
                 n_frames: int = 15, exp_name: str = "room0_synth") -> Dict:
    """The analytic scene's config with room0's model and recipe: hash
    grid 16 levels x 2 at hash_size 16 and resolution 400, trunc 0.1, TV
    lattice of smooth_pts 32, 1024 tracking rays with 20-pixel edges,
    2048 mapping rays, first frame 200 iterations, final mesh at 2 cm."""
    cfg = make_synthetic_config("", output, H=H, W=W, n_frames=n_frames,
                                exp_name=exp_name)
    cfg["grid"].update(hash_size=16, voxel_sdf=400)
    cfg["training"].update(trunc=0.1, smooth_pts=32)
    cfg["mapping"].update(sample=2048, min_pixels_cur=100, first_iters=200)
    cfg["tracking"].update(sample=1024, ignore_edge_W=20, ignore_edge_H=20)
    cfg["mesh"].update(voxel_final=0.02)
    return cfg


def tum_config(output: str, H: int = 480, W: int = 640, n_frames: int = 15,
               exp_name: str = "tum_synth") -> Dict:
    """The analytic scene's config with the TUM reference recipe
    (configs/Tum/tum.yaml) at configs/Tum/fr1_desk.yaml's width, read
    from TUM-layout files under ``output``/<exp_name>_data: the hash grid
    16 levels x 2 at hash_size 16 and resolution 325 (fr1_desk: a 6.5 m
    bound over voxel_sdf 0.02 m; voxel_sdf 325 here, so that the scene's 5
    m bound does not shrink it: 822,884 rows), OneBlob 16, the 2 x 32
    MLPs with geo_feat_dim 15, 64 uniform + 21 depth-guided samples per
    ray (range_d 0.25) and 128 importance samples, trunc 0.05, loss
    weights rgb 1, depth 0.1, sdf 5000, fs 10, smooth 1e-8 on a 63^3
    lattice of 0.04 m (smooth_pts 64, margin 0), tracking 1024 rays x 10
    iterations at lr 0.01 (robust_delta 0.1, best false), BA 2048 rays x
    20 iterations every 5th frame, first frame 1000 iterations, 4 loader
    threads, 40,960 point-cloud tracking rays (tracking.iter_point stays
    0, as in tum.yaml), meshes at 5 cm (the first and the periodic ones)
    and 3 cm (the final one). The camera is
    make_tum_synthetic_config's (the synthetic sensor's intrinsics, depth
    in 1/5000 m). One depth cut: mesh.vis 5 (from 50), so that a
    15-frame run meshes at frames 5 and 10."""
    cfg = make_tum_synthetic_config(
        os.path.join(output, f"{exp_name}_data"), output, H, W, n_frames,
        exp_name, tuned=False)
    cfg["data"]["num_workers"] = 4
    cfg["grid"]["voxel_sdf"] = 325
    cfg["tracking"].update(robust_delta=0.1, pc_samples=40960)
    cfg["mapping"]["first_mesh"] = True
    cfg["mesh"].update(vis=5, voxel_eval=0.05, voxel_final=0.03)
    return cfg


def room0_vm_config(output: str, H: int = 480, W: int = 640,
                    n_frames: int = 15,
                    exp_name: str = "room0_vm_synth") -> Dict:
    """room0_config with what configs/Replica/room0_vm.yaml changes: the
    TensoVM grid with a 3-level pyramid (resolutions 32/100/311 at
    voxel_sdf 400) and 16 uniform + 11 depth-guided samples per ray."""
    cfg = room0_config(output, H, W, n_frames, exp_name)
    cfg["grid"].update(enc="TensoVM", triplane_levels=3)
    cfg["training"].update(n_samples_d=16, n_range_d=11)
    return cfg


def room0_hybrid_config(output: str, H: int = 480, W: int = 640,
                        n_frames: int = 15,
                        exp_name: str = "room0_hybrid_synth") -> Dict:
    """room0_config with what configs/Replica/room0_hybrid.yaml changes:
    the TriPlaneHybrid grid, 3 dense levels (16/26/44, 115,721 rows) and
    a 4-level tri-plane pyramid (32/68/146/311, 374,409 rows) at
    voxel_sdf 400."""
    cfg = room0_config(output, H, W, n_frames, exp_name)
    cfg["grid"]["enc"] = "TriPlaneHybrid"
    return cfg


def room0_xor_config(output: str, H: int = 480, W: int = 640,
                     n_frames: int = 15,
                     exp_name: str = "room0_xor_synth",
                     grad_impl: str = "pallas") -> Dict:
    """room0_config with ``grid.grad_impl: pallas``: the same model at the
    same width, but the grid is tiny-cuda-nn's XOR hash (the reference
    Co-SLAM's), 16 levels x 2 at hash_size 16 and resolution 400, levels
    0-4 dense and 5-15 hashed at 2^16 rows each, 834,097 rows, with the
    deterministic table gradient of the Pallas K4. ``grad_impl`` scatter
    or onehot keeps the grid and takes the atomic table gradient."""
    cfg = room0_config(output, H, W, n_frames, exp_name)
    cfg["grid"]["grad_impl"] = grad_impl
    return cfg


# ---------------------------------------------------------------------------
# In-memory sequences (the route that needs no image codec)
# ---------------------------------------------------------------------------


PROTOCOLS = ("replica", "tum", "scannet", "rgbd")


class SyntheticFrames(DatasetAlgebra):
    """RGB-D sequence of an analytic scene held in memory: the dataset
    interface CoSLAM reads (frames as dicts, poses, sizes).

    Without ``protocol``: the single room on the scan trajectory, the
    tracer's float frames as they are. With ``protocol`` (one of
    PROTOCOLS): ``poses`` rendered as that protocol's writer renders them
    (``seed``: the depth noise and the TUM timestamps; ``exposure_drift``
    for replica, ``motion_blur`` for tum, ``invalid`` for rgbd), kept as
    the writer's uint8 colors and uint16 depths, and served as that
    protocol's loader serves its files: the same frame ids, poses (their
    text round trip), crop and camera model. Replica's and ScanNet's
    colors skip the writer's JPEG loss."""

    def __init__(self, cfg: Dict, n_frames: int, protocol: Optional[str] = None,
                 scene: Optional[AnalyticScene] = None,
                 poses: Optional[np.ndarray] = None, seed: int = 0,
                 exposure_drift: float = 0.0, motion_blur: float = 0.0,
                 blur_taps: int = 5, invalid: Sequence[int] = (),
                 depth_noise: bool = True, device="cuda"):
        cam = cfg["cam"]
        self.config, self.protocol = cfg, protocol
        self.H, self.W = cam["H"], cam["W"]
        self.fx, self.fy, self.cx, self.cy = (cam["fx"], cam["fy"],
                                              cam["cx"], cam["cy"])
        scene = scene or AnalyticScene()
        if poses is None:
            poses = make_scan_trajectory(n_frames)
        poses = np.asarray(poses, np.float32)[:n_frames]
        if protocol is None:
            self.poses = poses
            self.frame_ids = list(range(len(poses)))
            self.frames = [render_frame(scene, c2w, self.H, self.W, self.fx,
                                        self.fy, self.cx, self.cy)
                           for c2w in poses]
            self._finish(cfg, crop=0)
            return
        if protocol not in PROTOCOLS:
            raise ValueError(f"unknown protocol {protocol!r}")
        self.png_depth_scale = float(cam["png_depth_scale"])
        self.sc_factor = float(cfg["data"].get("sc_factor", 1.0))
        if int(cfg["data"].get("downsample", 1)) != 1:
            raise NotImplementedError("data.downsample > 1 in memory")
        self.frames = [None] * len(poses)
        for i, rgb8, d16 in _render_protocol(
                protocol, scene, poses, self.H, self.W, self.fx, self.fy,
                self.cx, self.cy, self.png_depth_scale, seed, depth_noise,
                motion_blur, blur_taps, exposure_drift, device):
            self.frames[i] = (rgb8, d16)
        skip = max(int(cfg["data"].get("trainskip", 1)), 1)
        if protocol == "tum":
            self._tum_frames(poses, seed, skip)
        elif protocol == "rgbd":
            self.poses, valid = [], []
            lines = _rgbd_pose_lines(poses, invalid)
            for i in range(0, len(lines) - 3, 4):
                block = lines[i:i + 4]
                if any("nan" in ln.lower() for ln in block):
                    self.poses.append(np.eye(4, dtype=np.float32))
                    valid.append(False)
                else:
                    mat = np.array([[float(x) for x in ln.split()]
                                    for ln in block], np.float32)
                    self.poses.append(mat)
                    valid.append(np.all(np.isfinite(mat)))
            self.frame_ids = [i for i in range(0, len(poses), skip)
                              if valid[i]]
            self._pairs = [(i, i) for i in range(len(poses))]
        else:
            if protocol == "replica":
                self.poses = []
                for c2w in poses:
                    p = _opengl(np.array(list(map(
                        float, _replica_pose_line(c2w).split()))).reshape(4, 4))
                    p[:3, 3] *= self.sc_factor
                    self.poses.append(p)
            else:   # scannet: np.savetxt's '%.18e' round-trips float64
                self.poses = [_opengl(_cv_pose(c2w)) for c2w in poses]
            self.frame_ids = list(range(0, len(poses), skip))
            self._pairs = [(i, i) for i in range(len(poses))]
        self._finish(cfg, crop=int(cam.get("crop_edge", 0))
                     if protocol in ("tum", "scannet") else 0)

    def _tum_frames(self, poses: np.ndarray, seed: int, skip: int,
                    fps: float = 30.0, frame_rate: int = 32) -> None:
        """The TUM loader's association of the writer's timestamps, its
        subsampling to ~frame_rate Hz and its quaternion poses."""
        from scipy.spatial.transform import Rotation

        from .datasets import TUMDataset

        stamps = _tum_stamps(len(poses), seed, fps)
        t_img = np.array([float(f"{s[0]:.6f}") for s in stamps])
        t_depth = np.array([float(f"{s[1]:.6f}") for s in stamps])
        vecs = np.array([[float(v) for v in _tum_gt_line(s[2], c).split()]
                         for s, c in zip(stamps, poses)])
        assoc = TUMDataset._associate(t_img, t_depth, vecs[:, 0])
        if not assoc:
            raise ValueError("TUM timestamp association produced no frames")
        indices = [0]
        for i in range(1, len(assoc)):
            if t_img[assoc[i][0]] - t_img[assoc[indices[-1]][0]] \
                    > 1.0 / frame_rate:
                indices.append(i)
        self._pairs, self.poses = [], []
        for ix in indices:
            i, j, k = assoc[ix]
            self._pairs.append((i, j))
            c2w = np.eye(4)
            c2w[:3, :3] = Rotation.from_quat(vecs[k, 4:]).as_matrix()
            c2w[:3, 3] = vecs[k, 1:4]
            self.poses.append(_opengl(c2w))
        self.frame_ids = list(range(0, len(self._pairs), skip))

    def _finish(self, cfg: Dict, crop: int) -> None:
        """The camera model after the crop, and the keyframe ray budget
        (of the cropped image, as the loaders count it)."""
        self.crop = crop
        self.H, self.W = self.H - 2 * crop, self.W - 2 * crop
        self.cx, self.cy = self.cx - crop, self.cy - crop
        self.num_frames = len(self.frame_ids)
        self.num_rays_to_save = int(self.H * self.W
                                    * cfg["mapping"]["n_pixels"])
        self.direction = get_camera_rays(self.H, self.W, self.fx, self.fy,
                                         self.cx, self.cy)

    def __len__(self):
        return self.num_frames

    def __getitem__(self, index: int) -> Dict:
        i = self.frame_ids[index]
        if self.protocol is None:
            rgb, depth = self.frames[i]
        else:
            ci, di = self._pairs[i]
            rgb = (self.frames[ci][0] / 255.0).astype(np.float32)
            depth = (self.frames[di][1].astype(np.float32)
                     / self.png_depth_scale * self.sc_factor)
            e = self.crop
            if e > 0:
                rgb, depth = rgb[e:-e, e:-e], depth[e:-e, e:-e]
        return {"frame_id": i, "c2w": np.asarray(self.poses[i], np.float32),
                "rgb": rgb, "depth": depth, "direction": self.direction}

    def replace_colors(self, rgb8: np.ndarray) -> None:
        """Serve the uint8 colors rgb8 [n, H, W, 3] (before the crop) in
        place of the rendered ones: e.g. a disk route's decoded JPEG
        colors (tools/disk_colors.py), to run the memory route with the
        disk route's exact frames."""
        rgb8 = np.asarray(rgb8)
        want = (len(self.frames),) + self.frames[0][0].shape
        if rgb8.dtype != np.uint8 or rgb8.shape != want:
            raise ValueError(f"colors {rgb8.dtype} {rgb8.shape}, want uint8 "
                             f"{want}")
        self.frames = [(c, d) for c, (_, d) in zip(rgb8, self.frames)]

    def content_hash(self) -> str:
        """sha1 over the stored colors and depths and the served poses: the
        in-memory counterpart of :func:`dataset_content_hash`."""
        import hashlib

        h = hashlib.sha1()
        for rgb, depth in self.frames:
            h.update(np.ascontiguousarray(rgb).tobytes())
            h.update(np.ascontiguousarray(depth).tobytes())
        h.update(np.asarray(self.poses, np.float32).tobytes())
        return h.hexdigest()


def _opengl(c2w: np.ndarray) -> np.ndarray:
    """Flip y/z columns (the loaders' ``_opengl``): OpenCV -> OpenGL."""
    c2w = np.array(c2w, np.float32)
    c2w[:3, 1] *= -1
    c2w[:3, 2] *= -1
    return c2w
