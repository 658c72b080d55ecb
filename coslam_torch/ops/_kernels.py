"""Build and bind the port's CUDA kernels (coslam_torch/csrc/*.cu).

Each source is compiled with ``nvcc`` for ``sm_90a`` (one compiler
process per source, all started together), and the objects are linked
into one shared library with a plain C interface, loaded with
``ctypes``. The build happens at first use, from the repository's own
sources, into ``build/coslam_torch/`` at the repository root, under a
name keyed by a hash of all sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. Nothing here runs at
import time: a machine without ``nvcc`` imports this module and only
fails when a kernel is asked for.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

_PKG = Path(__file__).resolve().parents[1]
_SOURCES = (_PKG / "csrc" / "grid_encode.cu",
            _PKG / "csrc" / "tensovm_encode.cu",
            _PKG / "csrc" / "xor_grid_encode.cu",
            _PKG / "csrc" / "row_accum.cu",
            _PKG / "csrc" / "probe_accum.cu")
BUILD_DIR = _PKG.parent / "build" / "coslam_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I64, _I32, _U32 = ctypes.c_int64, ctypes.c_int, ctypes.c_uint


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels of coslam_torch "
                           "build only on a machine with the CUDA toolkit")
    return nvcc


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless a library for these exact sources and
    flags exists. Returns the library path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _SOURCES:
        h.update(src.read_bytes())
    lib = BUILD_DIR / f"coslam_torch_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in _SOURCES]
    t0 = time.perf_counter()
    try:
        ptxas = ["-Xptxas", "-v"] if verbose else []
        _nvcc_all([[*NVCC_FLAGS, *ptxas, "-c", "-o", str(obj), str(src)]
                   for src, obj in zip(_SOURCES, objs)], verbose)
        _nvcc_all([[*NVCC_FLAGS, "-shared", "-o", str(tmp),
                    *map(str, objs)]], verbose)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    if verbose:
        print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")
    os.replace(tmp, lib)
    return lib


def _nvcc_all(arg_lists, verbose: bool) -> None:
    """Run one nvcc per argument list, all at once; wait for every one,
    then raise if any failed."""
    nvcc = _nvcc()
    procs = [subprocess.Popen([nvcc, *args], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for args in arg_lists]
    outs = [proc.communicate()[0] for proc in procs]
    for proc, out in zip(procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(proc.args)}\n{out}")
        if verbose and out:
            print(out)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    lib.grid_encode_fwd.argtypes = [_P, _P, _P, ctypes.c_int64, ctypes.c_int,
                                    _P, ctypes.c_int, ctypes.c_uint, _P]
    lib.grid_encode_fwd.restype = ctypes.c_int
    lib.grid_encode_bwd.argtypes = [_P, _P, _P, _P, _P, ctypes.c_int64,
                                    ctypes.c_int, _P, ctypes.c_int,
                                    ctypes.c_uint, _P]
    lib.grid_encode_bwd.restype = ctypes.c_int
    lib.tensovm_encode_fwd.argtypes = [_P, _P, _P, _P, ctypes.c_int64,
                                       ctypes.c_int, _P, ctypes.c_int, _P]
    lib.tensovm_encode_fwd.restype = ctypes.c_int
    lib.tensovm_encode_bwd.argtypes = [_P, _P, _P, _P, _P, _P, _P,
                                       ctypes.c_int64, ctypes.c_int, _P,
                                       ctypes.c_int, ctypes.c_int, _P]
    lib.tensovm_encode_bwd.restype = ctypes.c_int
    lib.xor_grid_encode_fwd.argtypes = [_P, _P, _P, _I64, _I32, _P, _I32,
                                        _U32, _P]
    lib.xor_grid_encode_bwd.argtypes = [_P, _P, _P, _P, _P, _P, _I64, _I32,
                                        _P, _I32, _U32, _P]
    lib.row_accum_sort.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I64, _P,
                                   _I64, _I32, _I32, _I32, _P]
    lib.row_accum_starts.argtypes = [_P, _P, _I64, _I32, _P]
    lib.row_accum_walk.argtypes = [_P, _P, _P, _P, _P, _I64, _I32, _I32, _P]
    lib.probe_accum.argtypes = [_P, _P, _P, _I64, _I32, _I32, _I32, _I32,
                                _I32, _I32, _I32, _I32, _I32, _P]
    lib.probe_accum_pair_merged.argtypes = [_P, _P, _P, _P, _P, _P, _I64,
                                            _I32, _I32, _I32, _I32, _P]
    lib.probe_accum_run_merge.argtypes = [_P, _P, _P, _I64, _I32, _I32, _I32,
                                          _I32, _I32, _P]
    for fn in (lib.xor_grid_encode_fwd, lib.xor_grid_encode_bwd,
               lib.row_accum_sort, lib.row_accum_starts, lib.row_accum_walk,
               lib.probe_accum,
               lib.probe_accum_pair_merged, lib.probe_accum_run_merge):
        fn.restype = ctypes.c_int
    lib.grid_encode_error_string.argtypes = [ctypes.c_int]
    lib.grid_encode_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if code != 0:
        msg = library().grid_encode_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")


def on_cpu(*tensors: torch.Tensor) -> bool:
    """Whether every tensor lies on the CPU (the wrappers then take the
    plain versions)."""
    return all(t.device.type == "cpu" for t in tensors)


def check_tensors(what: str, device: torch.device, **tensors) -> None:
    """Raise unless every tensor is contiguous float32 on the CUDA device
    ``device``."""
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}; the kernel "
                             f"needs every tensor on {device} (CPU tensors "
                             "take the plain version only when all of them "
                             "are on the CPU)")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous float32, "
                             f"got {t.dtype}")


@functools.lru_cache(maxsize=None)
def level_table(spec, device: torch.device) -> torch.Tensor:
    """int32 [3, L] (resolution, table offset, hashed) of a hash grid spec
    (packed or XOR) on the kernel's device."""
    arr = np.array([spec.resolutions, spec.offsets,
                    [int(h) for h in spec.hashed]], np.int32)
    return torch.from_numpy(arr).to(device)


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
