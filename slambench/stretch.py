"""The traced stretch of a ``--trace 1`` run: torch.profiler over a few
BA periods, and what is read from its trace.

Read from the exported trace (written to the run's own directory and
removed): every device interval (kernels, copies, fills) and their union,
each kernel by name, and the idle gaps between the busy intervals, each
put down to what the host was doing at its middle (a span of the loop:
the tracking step, BA, a keyframe, the periodic mesh, else the loop's
own work). The union of intervals is the program's own
``tools/profile_slice._busy_us``, copied. The stretch adds nothing to
the program's work: the encode kernels' bytes are counted from the
configuration's shapes (``yardstick``), not from their calls.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Tuple

import torch

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_SYNC = "slambench.sync"


def busy_union(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def gaps(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The idle (start, end) stretches of [lo, hi] between the union of
    the intervals."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


class Stretch:
    """torch.profiler over frames [first, first + n) of the window."""

    def __init__(self, first: int, n: int, workdir: str, device):
        self.first, self.n = first, n
        self.device = torch.device(device)
        self.workdir = workdir
        self.prof = None
        self.t0 = self.t1 = self.sync = None

    @property
    def last(self) -> int:
        return self.first + self.n

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        with record_function(_SYNC):
            self.sync = time.perf_counter()
        self.t0 = time.perf_counter()

    def abandon(self) -> None:
        """Stop the profiler of a run that failed inside the stretch."""
        if self.prof is not None and self.t1 is None:
            self.prof.stop()
            self.prof = None

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        self.prof.stop()

    def read(self, host_spans: List[Tuple[float, float, str]]) -> Dict:
        """The stretch's device figures from the exported trace:
        busy_s, window_s, launches, kernel seconds by name, the encode
        kernels' device seconds, and the idle seconds by host activity."""
        path = os.path.join(self.workdir, "stretch_trace.json")
        self.prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(path)
        self.prof = None
        sync_ts = next((e["ts"] for e in events if e.get("name") == _SYNC
                        and e.get("ph") == "X"), None)
        dev = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
               for e in events if e.get("cat") in _DEVICE_CATS]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        by_name: Dict[str, float] = {}
        for e in kernels:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] * 1e-6
        enc = {"fwd": [], "bwd": []}
        for e in sorted(kernels, key=lambda e: e["ts"]):
            if "grid_encode_fwd_kernel" in e["name"]:
                enc["fwd"].append(e["dur"] * 1e-6)
            elif "grid_encode_bwd_kernel" in e["name"]:
                enc["bwd"].append(e["dur"] * 1e-6)
        window_s = self.t1 - self.t0
        idle: Dict[str, float] = {}
        if sync_ts is not None:
            # Trace microseconds -> host seconds.
            off = self.sync - sync_ts * 1e-6
            lo, hi = (self.t0 - off) * 1e6, (self.t1 - off) * 1e6
            spans = sorted(host_spans)
            for s, e in gaps(dev, lo, hi):
                mid = 0.5 * (s + e) * 1e-6 + off
                tag = next((t for a, b, t in spans if a <= mid < b), "loop")
                idle[tag] = idle.get(tag, 0.0) + (e - s) * 1e-6
        return {"busy_s": busy_union(dev) * 1e-6, "window_s": window_s,
                "launches": len(kernels), "first": self.first,
                "frames": self.n, "kernel_s": by_name, "encode_s": enc,
                "idle_s": idle}
