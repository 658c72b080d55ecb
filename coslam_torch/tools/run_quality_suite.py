"""The multi-scene, seed-replicated quality suite, through the port.

The port's counterpart of tools/bench/run_quality_suite.py: the same
seven rows (RUNS) at the same frames, resolutions and seeds, each run
through coslam_torch.tools.quality_bench, and the table written beside
the JAX package's (results/BENCH_QUALITY_MULTI.json) into
results/BENCH_QUALITY_MULTI_TORCH.{json,md}. A row holds when, for each
of ATE, Acc and Comp, the port's mean lies within the JAX mean ± (JAX
half-spread + port half-spread + 10 % of the JAX mean).

Each (row, seed) runs as its own process and writes its own JSON
(``result_<row>_s<seed>.json``) under ``--results_dir``; ``--jobs`` runs
that many processes at once (on one card they share it, so their walls
are not speed measurements); ``--only row:seed,...`` runs just those
pairs; the table aggregates every per-run JSON present, so the suite can
be split over several calls and merged afterwards (``--merge``: no run).
Per-run JSONs in a subdirectory of ``--results_dir`` are a diagnostic
arm (the same rows with one thing changed, e.g. tools/bf16_reads.py's
runs), reported beside the rows.

``--enc`` runs the rows with another grid (quality_bench --enc);
``--room_table`` writes the room row of each grid the port runs
(HashGrid, TriPlaneHybrid, TriPlane: results/quality_torch/,
hybrid/ and triplane/ there) beside the JAX package's rows, the HashGrid
row also beside the JAX package's own runs on a CPU
(results/quality_jax_cpu/), into results/BENCH_QUALITY_ROOM_TORCH.{json,md}.

Run from the repository root:
  python -m coslam_torch.tools.run_quality_suite --frames_in memory
      [--device cuda] [--scenes room,thin] [--seeds 0,1,2]
      [--only room_tum:3] [--jobs 4] [--results_dir D] [--merge]
      [--enc TriPlaneHybrid] [--room_table]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# (row key, scene, protocol, extra args, frames override, extra seeds):
# the JAX suite's rows. The apartment walkthrough needs its full
# 800-frame protocol; room_tum renders a different handheld trajectory
# per seed, so it runs 5 seeds.
RUNS = [
    ("room", "room", "replica", [], None, []),
    ("room2", "room2", "replica", [], None, []),
    ("plain", "plain", "replica", [], None, []),
    ("corridor", "corridor", "replica", [], None, []),
    ("thin", "thin", "rgbd", [], None, []),
    ("room_tum", "room", "tum", [], 500, [3, 4]),
    ("apartment", "apartment", "scannet", ["--hw", "480x640"], 800, []),
]

METRICS = ["ate_rmse_cm", "acc_cm", "comp_cm", "comp_ratio_pct",
           "depth_l1_cm", "depth_l1_surface_cm", "rec_hole_px_pct"]
HOLD_METRICS = ["ate_rmse_cm", "acc_cm", "comp_cm"]
JAX_TABLE = os.path.join(REPO, "results", "BENCH_QUALITY_MULTI.json")
OUT_STEM = os.path.join(REPO, "results", "BENCH_QUALITY_MULTI_TORCH")


def _traj_difficulty(protocol, scene_key, n_frames, seed):
    """Path length (m) and mean angular step (deg/frame) of a seed's
    trajectory, from the generator the render used."""
    import numpy as np

    from ..data.synth import (make_corridor_trajectory,
                              make_handheld_trajectory, make_scan_trajectory,
                              make_walkthrough_trajectory)

    if protocol == "tum":
        poses = make_handheld_trajectory(n_frames, seed=seed)
    elif protocol == "scannet":
        poses = make_walkthrough_trajectory(n_frames, seed=seed)
    elif scene_key == "corridor":
        poses = make_corridor_trajectory(n_frames, seed=seed)
    else:
        poses = make_scan_trajectory(n_frames)
    t = poses[:, :3, 3]
    path_m = float(np.linalg.norm(np.diff(t, axis=0), axis=1).sum())
    rel = np.einsum("nij,nkj->nik", poses[1:, :3, :3], poses[:-1, :3, :3])
    cos = np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1)
    deg = float(np.degrees(np.arccos(cos)).mean())
    return {"path_m": round(path_m, 2), "deg_per_frame": round(deg, 3)}


def _agg(runs):
    """Per-metric mean / half-spread ((max - min) / 2) over seed runs."""
    out = {}
    for m in METRICS:
        vals = [r[m] for r in runs if m in r]
        if not vals:
            continue
        mean = sum(vals) / len(vals)
        half = (max(vals) - min(vals)) / 2.0
        out[m] = {"mean": mean, "half_spread": half,
                  "spread_over_mean_pct":
                      round(100 * 2 * half / max(abs(mean), 1e-9), 1),
                  "values": vals}
    return out


def holds(port: dict, jax: dict) -> dict:
    """{metric: (holds, |port - jax|, allowed)} for HOLD_METRICS: the
    port's mean within the JAX mean ± (JAX half-spread + port half-spread
    + 10 % of the JAX mean)."""
    out = {}
    for m in HOLD_METRICS:
        if m not in port or m not in jax:
            continue
        gap = abs(port[m]["mean"] - jax[m]["mean"])
        allowed = (jax[m]["half_spread"] + port[m]["half_spread"]
                   + 0.1 * abs(jax[m]["mean"]))
        out[m] = (bool(gap <= allowed), gap, allowed)
    return out


def run_one(key, scene, protocol, extra, frames, seed, args) -> list:
    """The quality_bench command of one (row, seed)."""
    out = os.path.join(args.results_dir, f"result_{key}_s{seed}.json")
    if args.enc:
        extra = [*extra, "--enc", args.enc]
    return ([sys.executable, "-m", "coslam_torch.tools.quality_bench",
             "--frames", str(frames or args.frames)]
            + (["--hw", args.hw] if "--hw" not in extra else [])
            + ["--workdir", args.workdir, "--scene", scene,
               "--protocol", protocol, "--out", out, "--eval_views", "200",
               "--seed", str(seed), "--frames_in", args.frames_in,
               "--device", args.device] + extra, out)


def _pending(args) -> list:
    seeds = [int(s) for s in args.seeds.split(",")]
    sel = set(args.scenes.split(",")) if args.scenes else None
    only = None
    if args.only:
        only = {(k, int(s)) for k, s in
                (item.split(":") for item in args.only.split(","))}
    todo = []
    for key, scene, protocol, extra, frames, extra_seeds in RUNS:
        for seed in seeds + extra_seeds:
            if only is not None:
                if (key, seed) not in only:
                    continue
            elif sel and key not in sel:
                continue
            cmd, out = run_one(key, scene, protocol, extra, frames, seed, args)
            if os.path.exists(out):
                print(f"=== {key} seed {seed}: done before ===", flush=True)
                continue
            todo.append((key, seed, frames or args.frames, cmd, out))
    # Longest first, so parallel runs end together.
    return sorted(todo, key=lambda t: -t[2])


def run_all(args) -> None:
    """Run every pending (row, seed), ``args.jobs`` processes at a time;
    raises if any of them fails."""
    todo = _pending(args)
    if todo and args.device.startswith("cuda"):
        # Build the kernels and the native library once, not in each run.
        from ..mesh import mcubes
        from ..ops import _kernels

        _kernels.build()
        mcubes.build()
    env = dict(os.environ)
    if args.jobs > 1:
        env.setdefault("OMP_NUM_THREADS",
                       str(max(1, (os.cpu_count() or 8) // args.jobs)))
    running, failed = [], []
    while todo or running:
        while todo and len(running) < args.jobs:
            key, seed, _, cmd, out = todo.pop(0)
            log = open(os.path.join(args.results_dir,
                                    f"log_{key}_s{seed}.txt"), "w")
            print(f"=== {key} seed {seed}: {' '.join(cmd[1:])}", flush=True)
            running.append((key, seed, out, log, time.perf_counter(),
                            subprocess.Popen(cmd, cwd=REPO, env=env,
                                             stdout=log,
                                             stderr=subprocess.STDOUT)))
        time.sleep(1.0)
        for item in list(running):
            key, seed, out, log, t0, proc = item
            if proc.poll() is None:
                continue
            running.remove(item)
            log.close()
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                failed.append((key, seed, proc.returncode))
                print(f"=== {key} seed {seed}: FAILED rc "
                      f"{proc.returncode} ({wall:.0f} s)", flush=True)
                continue
            with open(out) as f:
                res = json.load(f)
            res.update(concurrent_jobs=args.jobs, process_wall_s=round(wall, 1))
            with open(out, "w") as f:
                json.dump(res, f, indent=2)
            print(f"=== {key} seed {seed}: ATE {res.get('ate_rmse_cm')} cm, "
                  f"{wall:.0f} s", flush=True)
    if failed:
        raise RuntimeError(f"quality runs failed: {failed}")


def merge(results_dir: str, frames: int) -> dict:
    """Aggregate every per-run JSON under results_dir beside the JAX
    table; writes results/BENCH_QUALITY_MULTI_TORCH.{json,md}."""
    import glob
    import re

    with open(JAX_TABLE) as f:
        jax = json.load(f)["scenes"]

    def read(d):
        by_key = {}
        for path in glob.glob(os.path.join(d, "result_*_s*.json")):
            m = re.fullmatch(r"result_(.+)_s(\d+)\.json",
                             os.path.basename(path))
            if m:
                with open(path) as f:
                    by_key.setdefault(m.group(1), []).append(json.load(f))
        return by_key

    runs_by_key = read(results_dir)
    # Each subdirectory with per-run JSONs is a diagnostic arm: the same
    # rows run with one thing changed, reported beside the rows.
    arms = {}
    for sub in sorted(os.listdir(results_dir)):
        by_key = read(os.path.join(results_dir, sub))
        if by_key:
            arms[sub] = {k: {"seeds": sorted(r["seed"] for r in v),
                             "agg": _agg(v)} for k, v in by_key.items()}
    rows = {}
    for key, _, protocol, _, fr, extra_seeds in RUNS:
        runs = sorted(runs_by_key.get(key, []), key=lambda r: r["seed"])
        jrow = jax.get(key)
        want = jrow["seeds"] if jrow else []
        row = {"n_runs": len(runs), "seeds": [r["seed"] for r in runs],
               "missing_seeds": [s for s in want
                                 if s not in [r["seed"] for r in runs]],
               "jax": jrow and {"agg": jrow["agg"], "seeds": jrow["seeds"],
                                "n_frames": jrow.get("n_frames"),
                                "resolution": jrow.get("resolution")}}
        if runs:
            agg = _agg(runs)
            verdict = holds(agg, jrow["agg"]) if jrow else {}
            row.update(
                agg=agg, n_frames=runs[0].get("n_frames"),
                resolution=runs[0].get("resolution"),
                frames_in=sorted({r.get("frames_in") for r in runs}),
                device=sorted({r.get("device") for r in runs}),
                dataset_sha1=[r.get("dataset_sha1") for r in runs],
                runtime_s=[r.get("runtime_s") for r in runs],
                concurrent_jobs=[r.get("concurrent_jobs") for r in runs],
                holds={m: {"holds": h, "gap": g, "allowed": a}
                       for m, (h, g, a) in verdict.items()},
                row_holds=bool(verdict) and all(h for h, _, _ in
                                                verdict.values()))
            if protocol in ("tum", "scannet") or key == "corridor":
                row["per_seed_difficulty"] = {
                    str(r["seed"]): _traj_difficulty(
                        protocol, key, fr or frames, r["seed"])
                    for r in runs}
        rows[key] = row
    table = {"rows": rows, "arms": arms,
             "rule": "port mean within JAX mean +- (JAX half-spread + port "
                     "half-spread + 10% of JAX mean) for "
             + ", ".join(HOLD_METRICS)}
    os.makedirs(os.path.dirname(OUT_STEM), exist_ok=True)
    with open(OUT_STEM + ".json", "w") as f:
        json.dump(table, f, indent=2)
    with open(OUT_STEM + ".md", "w") as f:
        f.write(render_md(rows, arms))
    return table


def _fmt(agg, m):
    if not agg or m not in agg:
        return "—"
    return f"{agg[m]['mean']:.2f} ± {agg[m]['half_spread']:.2f}"


def render_md(rows: dict, arms: dict = None) -> str:
    proto = {k: pr for k, _, pr, _, _, _ in RUNS}
    devices = sorted({d for r in rows.values() for d in r.get("device", [])
                      if d})
    jobs = sorted({j for r in rows.values()
                   for j in r.get("concurrent_jobs", []) if j})
    lines = [
        "# Multi-scene seed-replicated quality table: coslam_torch",
        "",
        "The seven rows of `results/BENCH_QUALITY_MULTI.md` (the JAX "
        "package's, on its own runs), run through the port "
        "(`python -m coslam_torch.tools.run_quality_suite`; mean ± "
        "half-spread over seeds, full Co-SLAM culling, 200 eval views). "
        "Card: " + (", ".join(devices) or "none") + ". Frames: "
        + (", ".join(sorted({f for r in rows.values()
                             for f in r.get("frames_in", []) if f}))
           or "none") + ".",
        "",
        "A row **holds** when, for each of ATE, Acc and Comp, the port's "
        "mean lies within the JAX mean ± (JAX half-spread + port "
        "half-spread + 10 % of the JAX mean). Expected differences: the "
        "TPU read the tables in bf16 and the port reads f32; the random "
        "streams differ.",
        "",
        "| scene | protocol | frames | res | port seeds | missing seeds | "
        "ATE (cm) port / JAX | Acc (cm) port / JAX | Comp (cm) port / JAX "
        "| Ratio (%) port / JAX | Depth-L1 (cm) port / JAX | holds |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for key, r in rows.items():
        a = r.get("agg")
        j = (r.get("jax") or {}).get("agg")
        cells = [f"{_fmt(a, m)} / {_fmt(j, m)}" for m in METRICS[:5]]
        if a is None:
            verdict = "not run"
        else:
            bad = [m for m, v in r["holds"].items() if not v["holds"]]
            verdict = "yes" if r["row_holds"] else "no (" + ", ".join(
                bad) + ")"
        lines.append(
            f"| {key} | {proto[key]} | {r.get('n_frames', '—')} | "
            f"{r.get('resolution', '—')} | "
            f"{','.join(map(str, r['seeds'])) or '—'} | "
            f"{','.join(map(str, r['missing_seeds'])) or '—'} | "
            + " | ".join(cells) + f" | {verdict} |")
    if arms:
        lines += ["", "## Diagnostic arms", "",
                  "The same rows with one thing changed (the arm is the "
                  "subdirectory of the per-run JSONs), beside the row's own "
                  "runs.", "",
                  "| arm | scene | seeds | ATE (cm) arm / row | Acc (cm) "
                  "arm / row | Comp (cm) arm / row | Depth-L1 (cm) arm / "
                  "row |", "|---|---|---|---|---|---|---|"]
        for arm, by_key in arms.items():
            for key, r in by_key.items():
                own = rows.get(key, {}).get("agg")
                lines.append(
                    f"| {arm} | {key} | {','.join(map(str, r['seeds']))} | "
                    + " | ".join(f"{_fmt(r['agg'], m)} / {_fmt(own, m)}"
                                 for m in ("ate_rmse_cm", "acc_cm", "comp_cm",
                                           "depth_l1_cm")) + " |")
    lines += ["", "## Per-run walls", "",
              "Each run's SLAM wall (`runtime_s`: first frame, tracking, BA, "
              "final mesh and ATE; not the render or the evaluation). Runs "
              "shared the card with up to "
              + (", ".join(map(str, jobs)) or "1")
              + " concurrent runs, so these are not speed measurements.", "",
              "| scene | seed | runtime (s) | concurrent runs |",
              "|---|---|---|---|"]
    for key, r in rows.items():
        for s, rt, cj in zip(r.get("seeds", []), r.get("runtime_s", []),
                             r.get("concurrent_jobs", [])):
            lines.append(f"| {key} | {s} | {rt} | {cj} |")
    lines += ["", "## Depth-L1 decomposition (surface vs coverage)", "",
              "| scene | depth-L1 (cm) | surface-only (cm) | hole px % | "
              "per-seed depth-L1 |", "|---|---|---|---|---|"]
    for key, r in rows.items():
        a = r.get("agg")
        if not a or "depth_l1_surface_cm" not in a:
            continue
        vals = ", ".join(f"{v:.2f}" for v in a["depth_l1_cm"]["values"])
        lines.append(f"| {key} | {_fmt(a, 'depth_l1_cm')} | "
                     f"{_fmt(a, 'depth_l1_surface_cm')} | "
                     f"{_fmt(a, 'rec_hole_px_pct')} | {vals} |")
    diff = {k: r for k, r in rows.items() if "per_seed_difficulty" in r}
    if diff:
        lines += ["", "## Per-seed trajectory difficulty (data-varying rows)",
                  "", "| scene | seed | path (m) | deg/frame | ATE (cm) |",
                  "|---|---|---|---|---|"]
        for key, r in diff.items():
            ates = dict(zip(map(str, r["seeds"]),
                            r["agg"]["ate_rmse_cm"]["values"]))
            for sd, t in sorted(r["per_seed_difficulty"].items(),
                                key=lambda kv: int(kv[0])):
                lines.append(f"| {key} | {sd} | {t['path_m']} | "
                             f"{t['deg_per_frame']} | "
                             f"{ates.get(sd, float('nan')):.2f} |")
    return "\n".join(lines) + "\n"


# The JAX package's room rows of the grids beside the hash grid:
# results/BENCH_QUALITY.md:146-154 (room, 300 frames, 120x160, Co-SLAM
# culling; one run each on the TPU). Their half-spread is taken as 0.
JAX_ENC_ROOM = {
    "TriPlaneHybrid": {"ate_rmse_cm": 0.89, "acc_cm": 2.11, "comp_cm": 1.02,
                       "comp_ratio_pct": 99.69, "depth_l1_cm": 0.65},
    "TriPlane": {"ate_rmse_cm": 0.78, "acc_cm": 1.99, "comp_cm": 1.02,
                 "comp_ratio_pct": 99.52, "depth_l1_cm": 3.19},
}
# The port's per-run JSONs of each grid's room row, under results/.
ROOM_DIRS = {"HashGrid": "quality_torch", "TriPlaneHybrid":
             "quality_torch/hybrid", "TriPlane": "quality_torch/triplane"}
# The JAX package's own runs of the same rows on a CPU (f32 tables).
JAX_CPU_DIRS = {"HashGrid": "quality_jax_cpu", "TriPlaneHybrid":
                "quality_jax_cpu/hybrid", "TriPlane": "quality_jax_cpu/triplane"}
ROOM_STEM = os.path.join(REPO, "results", "BENCH_QUALITY_ROOM_TORCH")


def _room_runs(sub: str) -> list:
    d = os.path.join(REPO, "results", sub)
    runs = []
    for seed in range(8):
        path = os.path.join(d, f"result_room_s{seed}.json")
        if os.path.exists(path):
            with open(path) as f:
                runs.append(json.load(f))
    return runs


def room_table() -> dict:
    """The room row (300 frames, 120x160) of every grid the port runs,
    beside the JAX package's: HashGrid against its seeds on the TPU
    (BENCH_QUALITY_MULTI.json), TriPlaneHybrid and TriPlane against the
    one TPU run of each (JAX_ENC_ROOM), and each grid against the JAX
    package's own runs on a CPU where there are some (JAX_CPU_DIRS, its
    f32 path), each under the hold rule (``holds``). Writes
    results/BENCH_QUALITY_ROOM_TORCH.{json,md}."""
    with open(JAX_TABLE) as f:
        jax_tpu = json.load(f)["scenes"]["room"]["agg"]
    refs = {"HashGrid": {"JAX, TPU": jax_tpu}}
    for enc, row in JAX_ENC_ROOM.items():
        refs[enc] = {"JAX, TPU": {m: {"mean": v, "half_spread": 0.0}
                                  for m, v in row.items()}}
    cpu_seeds = {}
    for enc, sub in JAX_CPU_DIRS.items():
        cpu = _room_runs(sub)
        cpu_seeds[enc] = [r["seed"] for r in cpu]
        if cpu:
            refs[enc]["JAX, CPU"] = _agg(cpu)
    rows = {}
    for enc, sub in ROOM_DIRS.items():
        runs = _room_runs(sub)
        agg = _agg(runs) if runs else None
        row = {"seeds": [r["seed"] for r in runs], "agg": agg,
               "device": sorted({str(r.get("device")) for r in runs}),
               "refs": {}}
        for name, ref in refs[enc].items():
            verdict = holds(agg, ref) if agg else {}
            row["refs"][name] = {
                "agg": ref,
                "holds": {m: {"holds": h, "gap": g, "allowed": a}
                          for m, (h, g, a) in verdict.items()},
                "row_holds": bool(verdict) and all(
                    h for h, _, _ in verdict.values())}
        rows[enc] = row
    table = {"rows": rows, "jax_cpu_seeds": cpu_seeds,
             "rule": "port mean within reference mean +- (reference "
                     "half-spread + port half-spread + 10% of reference "
                     "mean) for " + ", ".join(HOLD_METRICS)}
    with open(ROOM_STEM + ".json", "w") as f:
        json.dump(table, f, indent=2)
    with open(ROOM_STEM + ".md", "w") as f:
        f.write(render_room_md(table))
    return table


def render_room_md(table: dict) -> str:
    lines = [
        "# The room row of every grid: coslam_torch beside the JAX package",
        "",
        "Room, replica protocol, 300 frames, 120x160, Co-SLAM culling, 200 "
        "eval views (`python -m coslam_torch.tools.run_quality_suite "
        "--room_table`; mean ± half-spread over seeds). Port: the "
        "per-run JSONs under `results/quality_torch/` (HashGrid), "
        "`hybrid/` and `triplane/` there (`--enc`). JAX, TPU: "
        "`results/BENCH_QUALITY_MULTI.json` (HashGrid, 3 seeds) and "
        "`results/BENCH_QUALITY.md:146-154` (one run each). JAX, CPU: "
        "`python -m coslam_tpu.tools.quality_bench` under "
        "`JAX_PLATFORMS=cpu`, the port's flags (and `--enc`), f32 tables "
        "(`results/quality_jax_cpu/`, `hybrid/` and `triplane/` there).",
        "",
        "Hold rule: " + table["rule"] + ".",
        "",
        "| grid | port seeds | reference | ATE (cm) port / ref | Acc (cm) "
        "port / ref | Comp (cm) port / ref | Ratio (%) port / ref | "
        "Depth-L1 (cm) port / ref | holds |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for enc, r in table["rows"].items():
        for name, ref in r["refs"].items():
            cells = [f"{_fmt(r['agg'], m)} / {_fmt(ref['agg'], m)}"
                     for m in METRICS[:5]]
            if r["agg"] is None:
                verdict = "not run"
            else:
                bad = [m for m, v in ref["holds"].items() if not v["holds"]]
                verdict = "yes" if ref["row_holds"] else (
                    "no (" + ", ".join(bad) + ")")
            lines.append(f"| {enc} | {','.join(map(str, r['seeds'])) or '—'}"
                         f" | {name} | " + " | ".join(cells)
                         + f" | {verdict} |")
    lines += ["", "Port runs' card: " + "; ".join(
        f"{enc} {', '.join(r['device']) or '—'}"
        for enc, r in table["rows"].items()) + "."]
    return "\n".join(lines) + "\n"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=300)
    p.add_argument("--hw", default="120x160")
    p.add_argument("--workdir", default=os.path.join(REPO, "output",
                                                     "quality_suite"))
    p.add_argument("--results_dir", default=None,
                   help="where the per-run JSONs and logs go (default: "
                        "the workdir)")
    p.add_argument("--scenes", default=None,
                   help="comma list subset, e.g. thin,plain")
    p.add_argument("--seeds", default="0,1,2",
                   help="replication seeds per row (room_tum adds 3, 4)")
    p.add_argument("--only", default=None,
                   help="run just these row:seed pairs, e.g. "
                        "room_tum:3,apartment:1")
    p.add_argument("--frames_in", default="disk", choices=["disk", "memory"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--jobs", type=int, default=1,
                   help="runs at once (one process each)")
    p.add_argument("--merge", action="store_true",
                   help="only aggregate the per-run JSONs present")
    p.add_argument("--enc", default=None,
                   help="grid.enc of every run (quality_bench --enc, e.g. "
                        "TriPlaneHybrid); the runs are not merged into the "
                        "HashGrid table (see --room_table)")
    p.add_argument("--room_table", action="store_true",
                   help="only write the room rows of every grid beside the "
                        "JAX package's (room_table)")
    args = p.parse_args(argv)
    if args.room_table:
        table = room_table()
        print(render_room_md(table))
        return table
    args.results_dir = args.results_dir or args.workdir
    os.makedirs(args.results_dir, exist_ok=True)
    os.makedirs(args.workdir, exist_ok=True)
    if not args.merge:
        run_all(args)
    if args.enc:
        return None
    table = merge(args.results_dir, args.frames)
    print(render_md(table["rows"], table["arms"]))
    return table


if __name__ == "__main__":
    main()
