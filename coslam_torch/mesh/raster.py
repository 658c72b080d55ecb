"""Depth rendering of triangle meshes: the native z-buffer rasterizer.

The port's own copy of coslam_tpu/mesh/raster.py. ``render_depth`` calls
``raster_depth`` of native/raster.cpp (the same C++ as the JAX
package's), which g++ builds into the library of mcubes.py; a failed
build raises there, and there is no numpy fallback behind it.
``_render_depth_numpy`` is the plain version the tests hold it to.
Cameras use the OpenCV convention (+z forward); a helper converts
OpenGL (SLAM) poses.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from .mcubes import library


@functools.lru_cache(maxsize=1)
def _raster_fn():
    fn = library().raster_depth
    fn.restype = None
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float)]
    return fn


def opengl_to_opencv_w2c(c2w_gl: np.ndarray) -> np.ndarray:
    """OpenGL c2w (x right, y up, -z fwd) -> OpenCV w2c (+z fwd)."""
    c2w = np.asarray(c2w_gl, np.float64).copy()
    c2w[:3, 1] *= -1
    c2w[:3, 2] *= -1
    return np.linalg.inv(c2w).astype(np.float32)


def render_depth(vertices: np.ndarray, faces: np.ndarray, w2c: np.ndarray,
                 fx: float, fy: float, cx: float, cy: float, H: int, W: int,
                 near: float = 0.01, far: float = 100.0) -> np.ndarray:
    """Z-buffer depth map [H, W] (0 where nothing is hit); both faces of a
    triangle are drawn.

    w2c: [4,4] world-to-camera, OpenCV convention.
    """
    v = np.ascontiguousarray(vertices, np.float32)
    f = np.ascontiguousarray(faces, np.int64)
    m = np.ascontiguousarray(w2c, np.float32)
    out = np.empty((H, W), np.float32)
    _raster_fn()(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(v),
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(f),
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        fx, fy, cx, cy, H, W, near, far,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def _render_depth_numpy(vertices, faces, w2c, fx, fy, cx, cy, H, W,
                        near=0.01, far=100.0):
    """The plain version of render_depth (a per-triangle loop), for the
    tests."""
    v = np.asarray(vertices, np.float64)
    cam = v @ w2c[:3, :3].T + w2c[:3, 3]
    z = cam[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        px = fx * cam[:, 0] / z + cx
        py = fy * cam[:, 1] / z + cy
    depth = np.full((H, W), np.inf)
    for f in faces:
        zf = z[f]
        if np.any(zf <= 1e-8) or np.all(zf > far):
            continue
        xs, ys = px[f], py[f]
        x0, x1 = int(max(0, np.floor(xs.min()))), int(min(W - 1, np.ceil(xs.max())))
        y0, y1 = int(max(0, np.floor(ys.min()))), int(min(H - 1, np.ceil(ys.max())))
        if x0 > x1 or y0 > y1:
            continue
        xa, xb, xc = xs
        ya, yb, yc = ys
        den = (yb - yc) * (xa - xc) + (xc - xb) * (ya - yc)
        if abs(den) < 1e-12:
            continue
        gx, gy = np.meshgrid(np.arange(x0, x1 + 1), np.arange(y0, y1 + 1))
        w0 = ((yb - yc) * (gx - xc) + (xc - xb) * (gy - yc)) / den
        w1 = ((yc - ya) * (gx - xc) + (xa - xc) * (gy - yc)) / den
        w2 = 1 - w0 - w1
        inside = (w0 >= -1e-6) & (w1 >= -1e-6) & (w2 >= -1e-6)
        iz = w0 / zf[0] + w1 / zf[1] + w2 / zf[2]
        with np.errstate(divide="ignore"):
            zpix = 1.0 / iz
        ok = inside & (zpix >= near) & (zpix <= far)
        sub = depth[y0:y1 + 1, x0:x1 + 1]
        sub[ok] = np.minimum(sub[ok], zpix[ok])
    depth[np.isinf(depth)] = 0.0
    return depth.astype(np.float32)
