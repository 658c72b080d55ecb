"""Marching cubes: the native C++ library (native/mc.cpp), through ctypes.

The port's own copy of coslam_tpu/mesh/mcubes.py's native path:

    marching_cubes(volume, isovalue, truncation) -> (verts [N,3], faces [M,3])

The library is compiled with g++ at first use (the same flags as the JAX
package's) into ``build/coslam_torch/`` at the repository root, under a
name keyed by a hash of the sources, the flags and the host's CPU model
(``-march=native`` builds for that CPU alone), and written under a
temporary name first, so concurrent first uses do not race. A failed
build raises: there is no slower fallback to hide behind.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np

_NATIVE = Path(__file__).resolve().parent / "native"
_SOURCES = (_NATIVE / "mc.cpp", _NATIVE / "raster.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "coslam_torch"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


def _cpu_model() -> str:
    """The host's architecture, CPU model name and CPU flags: what
    -march=native builds for (a virtual machine's model name can be
    generic; its flags say which instructions the build may use)."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                info.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    return " ".join((platform.machine(), platform.processor(),
                     info.get("model name", ""), info.get("flags", "")))


def build() -> Path:
    """Compile the library unless one for these sources, flags and CPU
    exists; returns its path."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_cpu_model().encode())
    for src in (*_SOURCES, _NATIVE / "mc_tables.h"):
        h.update(src.read_bytes())
    lib = BUILD_DIR / f"libmc_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, *map(str, _SOURCES), "-o",
                           str(tmp)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"marching cubes: g++ failed ({proc.returncode}):"
                           f"\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded native library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    lib.mc_run.restype = ctypes.c_void_p
    lib.mc_run.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float]
    lib.mc_num_vertices.restype = ctypes.c_int64
    lib.mc_num_vertices.argtypes = [ctypes.c_void_p]
    lib.mc_num_faces.restype = ctypes.c_int64
    lib.mc_num_faces.argtypes = [ctypes.c_void_p]
    lib.mc_copy.argtypes = [ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_float),
                            ctypes.POINTER(ctypes.c_int64)]
    lib.mc_free.argtypes = [ctypes.c_void_p]
    return lib


def marching_cubes(volume: np.ndarray, isovalue: float = 0.0,
                   truncation: float = 3.0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Extract an isosurface from a truncated SDF volume.

    volume: [nx, ny, nz] float; voxels with |v| >= truncation (or
    non-finite) are treated as unobserved and suppress any cell touching
    them. Vertices are returned in voxel-index coordinates.
    """
    volume = np.ascontiguousarray(volume, np.float32)
    lib = library()
    handle = lib.mc_run(
        volume.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        volume.shape[0], volume.shape[1], volume.shape[2],
        ctypes.c_float(isovalue), ctypes.c_float(truncation))
    try:
        nv = lib.mc_num_vertices(handle)
        nf = lib.mc_num_faces(handle)
        verts = np.empty((nv, 3), np.float32)
        faces = np.empty((nf, 3), np.int64)
        lib.mc_copy(handle,
                    verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    finally:
        lib.mc_free(handle)
    return verts, faces
