"""The port's quality harness: run_benchmark's evaluation half on one SLAM
output against the JAX package's, quality_bench end to end on the CPU
through the in-memory route with no image codec importable, the refusal
of what is not ported, the suite's merge, diagnostic arms and hold rule,
and the bf16 table reads of tools/bf16_reads.py.

Sizes: a 24x32 camera, 6 frames, analytic-room meshes from 40-48 grid
points a side, 4 eval views. Tolerance 0 for the evaluation half (the
same C++ rasterizer and the same numpy and scipy calls and draws); the
end-to-end run is held to finite metrics only (its ray batches and first-
frame iterations are cut with --set to keep the CPU time small).
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

from coslam_tpu.eval import benchmark as JB
from coslam_torch.data import synth as TS
from coslam_torch.eval import benchmark as TB
from coslam_torch.mesh import io as TIO
from coslam_torch.tools import quality_bench as QB
from coslam_torch.tools import run_quality_suite as RQ

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8


def _room_mesh(n, shift=0.0):
    from coslam_torch.mesh.mcubes import marching_cubes

    ax = np.linspace(-2.2, 2.2, n).astype(np.float32)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    sdf = TS.AnalyticScene().sdf(np.stack([X, Y, Z], -1) - shift)
    v, f = marching_cubes(sdf.astype(np.float32), 0.0, truncation=3.0)
    return TIO.TriMesh(v * (4.4 / (n - 1)) - 2.2, f)


class _FakeSLAM:
    """The SLAM output the JAX run_benchmark evaluates: the mesh already
    written, estimated poses, the GT trajectory, timings in ms."""

    def __init__(self, cfg, est, gt):
        self.est_c2w, self.params = est, {"w": np.zeros(3)}
        self.dataset = type("D", (), {"poses": gt,
                                      "__len__": lambda s: len(gt)})()
        self.timings = {"tracking": [1.0, 2.0], "mapping": [3.0]}

    def run(self, n_frames=None, verbose=False, eval_ate=True):
        return {"absolute_translational_error.rmse": 0.01,
                "absolute_translational_error.rmse_noalign": 0.02}


def test_evaluation_half_matches_jax(tmp_path):
    gt_path = str(tmp_path / "gt.ply")
    _room_mesh(48).export(gt_path)
    rec = _room_mesh(40, shift=0.01)
    gt = list(TS.make_scan_trajectory(N))
    rng = np.random.default_rng(0)
    est = np.stack(gt).copy()
    est[:, :3, 3] += rng.normal(0, 0.01, (N, 3)).astype(np.float32)
    est[N - 2] = 0.0              # a never-tracked slot is skipped
    out = {}
    for name in ("jax", "torch"):
        cfg = TS.make_synthetic_config(str(tmp_path / f"data_{name}"),
                                       str(tmp_path / f"out_{name}"), H=24,
                                       W=32, n_frames=N)
        rec.export(os.path.join(cfg["data"]["output"],
                                cfg["data"]["exp_name"],
                                f"mesh_track{N - 1}.ply"))
        if name == "jax":
            out[name] = JB.run_benchmark(
                cfg, gt_mesh_path=gt_path, culling="coslam", n_eval_views=4,
                slam_cls=lambda c: _FakeSLAM(c, est, gt))
        else:
            out[name] = TB.evaluate_run(cfg, est, gt, gt_path, "coslam", 4,
                                        N)
    keys = ("acc_cm", "comp_cm", "comp_ratio_pct", "depth_l1_cm",
            "depth_l1_surface_cm", "rec_hole_px_pct")
    assert {k: out["torch"][k] for k in keys} == \
        {k: out["jax"][k] for k in keys}
    vdirs = [tmp_path / f"data_{n}" / "virtual_cameras"
             for n in ("jax", "torch")]
    files = sorted(f for f in os.listdir(vdirs[0]) if f.endswith(".txt"))
    assert out["torch"]["virtual_cameras"] == len(files) >= 1
    for f in files:
        assert (vdirs[0] / f).read_bytes() == (vdirs[1] / f).read_bytes()


def test_quality_bench_in_memory_on_the_cpu(tmp_path):
    """quality_bench.main with --device cpu --frames_in memory, in a
    process where cv2, PIL and yaml cannot be imported: finite metrics."""
    out = tmp_path / "res.json"
    code = f"""
import sys
for name in ("cv2", "PIL", "yaml"):
    sys.modules[name] = None
from coslam_torch.tools import quality_bench
quality_bench.main(["--frames", "6", "--hw", "24x32", "--device", "cpu",
                    "--frames_in", "memory", "--workdir", {str(tmp_path)!r},
                    "--out", {str(out)!r}, "--eval_views", "4",
                    "--set", "mapping.first_iters=50",
                    "--set", "mapping.sample=256",
                    "--set", "tracking.sample=128",
                    "--set", "tracking.iter=3"])
"""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(out.read_text())
    for key in ("ate_rmse_cm", "acc_cm", "comp_cm", "comp_ratio_pct",
                "depth_l1_cm"):
        assert math.isfinite(res[key]), (key, res)
    assert res["device"] == "cpu" and res["frames_in"] == "memory"
    assert res["virtual_cameras"] >= 0 and res["n_params"] > 1000
    assert len(res["dataset_sha1"]) == 40


@pytest.mark.parametrize("flags", [["--pipelined"], ["--active"],
                                   ["--enc", "TriPlaneHybrid"]])
def test_quality_bench_refuses_what_is_not_ported(flags):
    with pytest.raises(NotImplementedError):
        QB.main(["--device", "cpu", "--frames_in", "memory"] + flags)


def test_suite_merge_and_hold_rule(tmp_path, monkeypatch):
    """merge: rows beside the JAX table, the hold rule per metric, the
    missing seeds named, rows not run marked so, and a subdirectory's runs
    as a diagnostic arm beside the rows."""
    monkeypatch.setattr(RQ, "OUT_STEM", str(tmp_path / "TABLE"))
    with open(RQ.JAX_TABLE) as f:
        jax = json.load(f)["scenes"]
    room = jax["room"]["agg"]
    for seed, d in ((0, 0.0), (1, 0.02)):
        run = {m: room[m]["mean"] + d for m in RQ.METRICS if m in room}
        run.update(seed=seed, n_frames=300, resolution="120x160",
                   frames_in="memory", device="card, 700.00 W",
                   runtime_s=1.0, concurrent_jobs=4, dataset_sha1="x")
        (tmp_path / f"result_room_s{seed}.json").write_text(json.dumps(run))
    thin = {m: 3 * jax["thin"]["agg"][m]["mean"] for m in RQ.METRICS
            if m in jax["thin"]["agg"]}
    thin.update(seed=0, n_frames=300, resolution="120x160")
    (tmp_path / "result_thin_s0.json").write_text(json.dumps(thin))
    (tmp_path / "arm").mkdir()
    (tmp_path / "arm" / "result_room_s0.json").write_text(json.dumps(
        {"seed": 0, "ate_rmse_cm": 5.0}))
    table = RQ.merge(str(tmp_path), 300)
    rows = table["rows"]
    assert rows["room"]["seeds"] == [0, 1]
    assert table["arms"]["arm"]["room"]["seeds"] == [0]
    assert rows["room"]["row_holds"] and rows["room"]["missing_seeds"] == [2]
    assert not rows["thin"]["row_holds"]
    gap = rows["thin"]["holds"]["ate_rmse_cm"]
    assert gap["gap"] == pytest.approx(2 * jax["thin"]["agg"]["ate_rmse_cm"]
                                       ["mean"])
    assert "agg" not in rows["apartment"]
    md = (tmp_path / "TABLE.md").read_text()
    assert "| room | replica |" in md and "| yes |" in md
    assert "no (ate_rmse_cm, acc_cm, comp_cm)" in md and "not run" in md
    assert "| arm | room | 0 | 5.00 ± 0.00 / " in md
    assert json.loads((tmp_path / "TABLE.json").read_text())["rows"]
    # A rule that moves with the spreads: at exactly the allowed gap the
    # row holds.
    one = {"ate_rmse_cm": {"mean": 1.25, "half_spread": 0.5}}
    ref = {"ate_rmse_cm": {"mean": 2.5, "half_spread": 0.5}}
    assert RQ.holds(one, ref)["ate_rmse_cm"] == (True, 1.25, 1.25)
    one["ate_rmse_cm"]["mean"] = 1.24
    assert RQ.holds(one, ref)["ate_rmse_cm"][0] is False


def test_bf16_reads_rounds_what_the_encoders_read():
    """tools/bf16_reads: the encode sees the bf16-rounded table (its
    output equals the encode of the rounded table), the table's gradient
    is the unrounded run's (the packed grid's table gradient does not read
    the table), --matmuls' MLP multiplies bf16-rounded inputs, and the
    encoders and the MLP are restored after the run, also when it
    raises."""
    import torch

    from coslam_torch.ops import hash_packed as HP
    from coslam_torch.ops import tensovm as VM
    from coslam_torch.tools import bf16_reads

    spec = HP.make_packed_spec(40, 10, n_levels=4)
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(spec.total_entries, spec.n_features, generator=gen)
    x = torch.rand(300, 3, generator=gen)
    g = torch.randn(300, spec.out_dim, generator=gen)
    rounded = table.bfloat16().float()
    assert not torch.equal(rounded, table)
    t1 = table.clone().requires_grad_()
    out = HP.encode(spec, bf16_reads.bf16_read(t1), x)
    torch.testing.assert_close(out, HP.encode(spec, rounded, x), rtol=0,
                               atol=0)
    (out * g).sum().backward()
    t2 = table.clone().requires_grad_()
    (HP.encode(spec, t2, x) * g).sum().backward()
    torch.testing.assert_close(t1.grad, t2.grad, rtol=0, atol=0)
    ws = [torch.randn(7, 5, generator=gen), torch.randn(5, 3, generator=gen)]
    xm = torch.randn(11, 7, generator=gen)
    r = [w.bfloat16().float() for w in ws]
    want = torch.relu(xm.bfloat16().float() @ r[0]).bfloat16().float() @ r[1]
    torch.testing.assert_close(bf16_reads.mlp_apply_bf16(ws, xm), want,
                               rtol=0, atol=0)
    from coslam_torch.models import decoder as D

    before = HP.encode, VM.encode, D.mlp_apply
    with pytest.raises(NotImplementedError):
        bf16_reads.main(["--device", "cpu", "--frames_in", "memory",
                         "--matmuls", "--pipelined"])
    assert (HP.encode, VM.encode, D.mlp_apply) == before
