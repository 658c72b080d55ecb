"""Run one cell of the benchmark once and print its result line.

    python3 slambench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. It loads the cell's configuration, renders
the cell's frames into ``.slambench_cache/`` on its first run there,
runs the program's SLAM loop (``coslam_torch``) from frame 0, measures
the window of ``--seconds`` seconds that starts at the cell's frame
phase, compares what the window's steps produced with the plain
reference, and prints each compared number beside its limit as the last
lines of standard error, then one JSON line as the last line of standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics read in a
traced stretch of the window) and ``device``. It exits non-zero, with no
result, without a CUDA device, or when JAX or the JAX package is loaded
once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Run as a script, the benchmark's folder heads sys.path: take it off, so
# that its modules are found only as the package's.
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]


def _environment(root: str) -> None:
    """Kernel caches in fixed directories of the checkout."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, ".slambench_cache",
                                                  "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(
        root, ".slambench_cache", "torch_extensions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    wl = next((w for w in bench["workloads"] if w["name"] == args.workload),
              None)
    if wl is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    _environment(ROOT)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)

    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < int(wl["chips"]):
        print(f"needs {wl['chips']} CUDA device(s), found {found}",
              file=sys.stderr)
        return 3

    from slambench import harness

    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 4
    info = result.pop("info")
    print(f"window: {info['window_frames']} frames in "
          f"{info['window_s']:.4f} s, {info['frame_samples']} frame walls "
          f"before the traced stretch; ATE RMSE {info['ate_rmse_m']} m; "
          f"seed {info['seed']}", file=sys.stderr)
    print(f"details (not compared): {json.dumps(info['details'])}",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
