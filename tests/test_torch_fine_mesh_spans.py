"""The spans of what the TUM recipe adds to the loop
(coslam_torch/runtime/spans.py): the importance fine pass of each step
(``<step>.fine``, inside ``<step>.forward``), the mesh's phases
(``mesh.query``, ``.mcubes``, ``.color``, ``.export``, summed by
``mesh``), each mesh.vis job's wall (``mesh_job``) and the worker's ATE
(``ate``).

A small TUM-recipe run on the CPU (the recipe's keys at 24 x 32, a small
grid, 8 importance samples, 8 frames: BA at frame 5, a periodic mesh
with its ATE on the mesh worker at frames 3 and 6): one fine entry a
call of each step, within its forward; none at all without a fine pass;
a tracking call through the graph's route (its capture and replay run
uncaptured on the CPU) reads ``tracking.fine`` 0 after its eager
warm-up; the mesh's phases on the worker's own stack; and the run's
poses and map bit for bit those of the same run with none of these
spans opened. No tolerance: the checks are counts, names, orders and
inequalities of one run's own clock readings, or equalities of bits.
"""

import contextlib
import threading

import numpy as np
import pytest
import torch

from coslam_torch.data import synth as TS
from coslam_torch.runtime import slam as SLAM
from coslam_torch.runtime import spans as SP
from coslam_torch.runtime import tracking as T
from coslam_torch.runtime.slam import CoSLAM

from test_torch_spans import Probe

torch.set_num_threads(1)

N_FRAMES = 8
VIS = 3
STEPS = ("first_frame", "tracking", "mapping")


def _config(out, n_importance=8):
    """configs/Tum's recipe (synth.tum_config) cut to the CPU."""
    cfg = TS.tum_config(str(out), H=24, W=32, n_frames=N_FRAMES)
    cfg["grid"].update(hash_size=10, voxel_sdf=32)
    cfg["training"].update(n_samples_d=8, n_range_d=5, smooth_pts=8,
                           n_importance=n_importance)
    cfg["tracking"].update(sample=64, iter=3, ignore_edge_W=2,
                           ignore_edge_H=2)
    cfg["mapping"].update(sample=128, iters=3, first_iters=20,
                          min_pixels_cur=8)
    cfg["mesh"].update(vis=VIS, voxel_eval=0.3, voxel_final=0.3)
    cfg["data"]["num_workers"] = 1
    cfg["seed"] = 7
    return cfg


def _run(cfg, recorder):
    """The sequential loop over the in-memory frames, built with
    ``recorder`` as its spans."""
    data = TS.SyntheticFrames(cfg, N_FRAMES, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(SLAM, "Spans", recorder)
        slam = CoSLAM(cfg, data, device="cpu")
    slam.run(verbose=False, eval_ate=True, mesh=False)
    return slam


def _added(name):
    """A span that the TUM recipe's spans add to the loop."""
    return (name.endswith(".fine") or name in SP.MESH_PHASES
            or name in ("mesh_job", "ate"))


class WithoutAdded(SP.Spans):
    """The recorder with the added spans never opened: the loop as it
    ran before them."""

    def span(self, name, **kwargs):
        if _added(name):
            return contextlib.nullcontext()
        return super().span(name, **kwargs)


@pytest.fixture(scope="module")
def tum(tmp_path_factory):
    return _run(_config(tmp_path_factory.mktemp("fine_spans")), Probe)


def test_fine_pass_one_entry_a_call_within_its_forward(tum):
    t = tum.timings
    assert (len(t["first_frame"]), len(t["tracking"]),
            len(t["mapping"])) == (1, N_FRAMES - 1, 1)
    for step in STEPS:
        fine, fwd = t[f"{step}.fine"], t[f"{step}.forward"]
        assert len(fine) == len(fwd) == len(t[step]), step
        for f, w in zip(fine, fwd):
            assert 0.0 < f <= w, (step, f, w)
    # Each iteration's fine pass is a span inside its forward.
    n_fwd = sum(1 for r in tum.spans.log if r[0] == "mapping.forward")
    inner = [r for r in tum.spans.log if r[0] == "mapping.fine"]
    assert len(inner) == n_fwd == tum.config["mapping"]["iters"]
    assert all(r[1][-2:] == ("mapping", "mapping.forward") for r in inner)


def test_no_fine_span_without_a_fine_pass(tmp_path):
    slam = _run(_config(tmp_path, n_importance=0), Probe)
    assert not [k for k in slam.timings if k.endswith(".fine")]
    assert not [r for r in slam.spans.log if r[0].endswith(".fine")]
    assert len(slam.timings["mapping.forward"]) == 1


def test_a_replayed_tracking_call_reads_fine_zero(tmp_path, monkeypatch):
    """The tracking calls routed through GraphedIterations (its capture
    and replay run the body on its buffers, uncaptured, as on the CPU
    they must): the first, eager, times its fine passes; the capture and
    the replay open no span inside the body, so ``tracking.fine`` adds
    0 for them, as the forward does."""
    def capture(graph, body):
        graph.body = body
        graph.run(body)

    monkeypatch.setattr(T._Graph, "capture", capture)
    monkeypatch.setattr(T._Graph, "replay", lambda g: g.run(g.body))
    cfg = _config(tmp_path)
    data = TS.SyntheticFrames(cfg, 4, device="cpu")
    slam = CoSLAM(cfg, data, device="cpu")
    slam.est_c2w[0] = np.asarray(data[0]["c2w"], np.float32)
    eager, span = slam._track_step, slam.spans.span

    def via_graph(params, c2w_init, rays, generator=None, align=None):
        return eager.graphed(params, c2w_init, rays, generator, align,
                             eager, span)

    slam._track_step = via_graph
    for i in (1, 2, 3):
        slam.tracking_render(data[i], i)
    t = slam.timings
    assert eager.graphed.captures == 1
    assert t["tracking.fine"][0] > 0.0 and t["tracking.fine"][1:] == [0, 0]
    assert t["tracking.forward"][1:] == [0, 0]
    assert t["tracking.replay"][0] == 0 and min(t["tracking.replay"][1:]) > 0


def test_mesh_phases_sum_under_mesh_on_the_workers_stack(tum):
    """Frame 0's mesh in the loop, the periodic ones (frames 3 and 6) on
    the worker's thread, each inside its job; one ``mesh_job`` and one
    ``ate`` entry a periodic job, as many as the loop's ``mesh_eval``
    events that submitted them."""
    t, log = tum.timings, tum.spans.log
    jobs = len(range(VIS, N_FRAMES, VIS))
    assert len(t["mesh_job"]) == len(t["ate"]) == jobs
    assert len([e for e in tum.frame_events if e[2] == "mesh_eval"]) == jobs
    assert len(t["mesh"]) == 1 + jobs
    for phase in SP.MESH_PHASES:
        assert len(t[phase]) == len(t["mesh"]), phase
    for k, wall in enumerate(t["mesh"]):
        parts = [t[p][k] for p in SP.MESH_PHASES]
        assert all(p >= 0.0 for p in parts) and sum(parts) <= wall
        assert t["mesh.query"][k] > 0.0 and t["mesh.mcubes"][k] > 0.0
    for wall, job, ate in zip(t["mesh"][1:], t["mesh_job"], t["ate"]):
        assert wall + ate <= job
    main = threading.get_ident()
    queries = [r for r in log if r[0] == "mesh.query"]
    assert queries[0][1] == ("frame", "mesh")
    assert queries[0][2] == main
    for r in queries[1:]:
        assert r[1] == ("mesh_job", "mesh") and r[2] != main
    for r in (r for r in log if r[0] == "ate"):
        assert r[1] == ("mesh_job",) and r[2] != main


def test_the_spans_leave_the_run_bit_for_bit(tum, tmp_path):
    """The same seeded run with none of the added spans opened: the same
    poses and the same map, bit for bit."""
    plain = _run(_config(tmp_path), WithoutAdded)
    assert not [k for k in plain.timings
                if _added(k) and any(plain.timings[k])]
    np.testing.assert_array_equal(plain.est_c2w, tum.est_c2w)
    assert torch.equal(plain.params["grid"], tum.params["grid"])
    for net in ("sdf_net", "color_net"):
        for a, b in zip(plain.params["decoder"][net],
                        tum.params["decoder"][net]):
            assert torch.equal(a, b)
