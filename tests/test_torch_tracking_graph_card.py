"""The tracking step replayed as a CUDA graph, on the card: for each
single-device route (room0's packed hash grid, TensoVM, the XOR hash
grid, TriPlaneHybrid, the TUM recipe with its importance draws and
training.frame_align, room0 under the deterministic switch), the step's
first call (eager: the warm-up), its second (the capture, then a replay)
and its third (a replay) on the same inputs and generator state: the
losses and the chosen pose of the replays within the f32 sum-order
bound of the eager call (bit for bit under the deterministic switch) and
bit for bit of each other, the generator's state after each call equal,
and the same kernel launches counted on the calling stream a call. A
fresh clone of the map (the pipelined tracker's snapshot) gives what the
same values in the old tensors gave; new inputs of the same shapes give
what an eager step gives on them, with no second capture; a new ray
count captures once more. The pipelined tracker's route: a step warmed
up, captured and replayed on a stream of its own, counted there. And the
sequential loop: every call from the third on replays (its
tracking.replay sum above 0, its forward, backward and update 0).

This file imports no jax:

    python -m pytest --noconftest -q tests/test_torch_tracking_graph_card.py

Without a CUDA device every test skips. Sizes: the analytic scene at 120
x 160 with each route's model, samples and 1024 tracking rays x 10
iterations, the map trained by 60 first-frame iterations. Bounds: a
loss within 1e-5 relative, a pose entry within 1e-5 (the benchmark's
plain reference reads 2.4e-7 on the eager step).
"""

import copy

import numpy as np
import pytest
import torch

from coslam_torch.data import synth as S
from coslam_torch.ops import _kernels
from coslam_torch.runtime.slam import CoSLAM
from coslam_torch.runtime.tracking import make_tracking_step

H, W, N_FRAMES = 120, 160, 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the graph is captured on CUDA")
    return torch.device("cuda", 0)


def _tum_align(out):
    cfg = S.tum_config(out, H, W, N_FRAMES)
    cfg["training"]["frame_align"] = True
    return cfg


ROUTES = {
    "room0": lambda out: S.room0_config(out, H, W, N_FRAMES),
    "room0_vm": lambda out: S.room0_vm_config(out, H, W, N_FRAMES),
    "room0_xor": lambda out: S.room0_xor_config(out, H, W, N_FRAMES),
    "room0_hybrid": lambda out: S.room0_hybrid_config(out, H, W, N_FRAMES),
    "tum_frame_align": _tum_align,
    "room0_det": lambda out: S.room0_config(out, H, W, N_FRAMES),
}


@pytest.fixture
def deterministic(monkeypatch):
    """torch.use_deterministic_algorithms(True) for one test."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def _slam(route, device, tmp_path):
    """A CoSLAM of the route on the analytic scene, its map trained by
    the first frame's mapping, and frame 1's tracking inputs."""
    cfg = ROUTES[route](str(tmp_path))
    cfg["mapping"].update(first_iters=60, first_mesh=False)
    cfg["mesh"]["vis"] = 0
    data = S.SyntheticFrames(cfg, N_FRAMES, device=device)
    slam = CoSLAM(cfg, data, device=device)
    slam.est_c2w[0] = np.asarray(data[0]["c2w"], np.float32)
    slam.first_frame_mapping(data[0])
    batch = data[1]
    rays = slam._sample_tracking_rays(batch).to(device)
    c2w = torch.from_numpy(slam._predict(1)).to(device)
    return slam, cfg, c2w, rays


def _call(step, params, c2w, rays, gen, state, align):
    """One call from the generator state ``state``: (outputs, the
    generator's state after it, the launches counted on the calling
    stream)."""
    stream = _kernels.stream(rays.device)
    before = _kernels.stream_launches(stream)
    gen.set_state(state)
    out = step(params, c2w, rays, gen, align)
    torch.cuda.synchronize()
    after = _kernels.stream_launches(stream)
    launches = {k: n - before.get(k, 0) for k, n in after.items()
                if n != before.get(k, 0)}
    return out, gen.get_state(), launches


def _close(got, want, exact):
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        elif exact:
            assert torch.equal(g, w)
    if not exact:
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-5)
        if want[3] is not None:
            torch.testing.assert_close(got[3], want[3], rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_replay_equals_the_eager_step(cuda_device, route, tmp_path,
                                      request):
    if route.endswith("_det"):
        request.getfixturevalue("deterministic")
    slam, cfg, c2w, rays = _slam(route, cuda_device, tmp_path)
    params, align = slam.params, slam.cur_align
    step = make_tracking_step(slam.model, cfg)
    gen = torch.Generator(device=cuda_device).manual_seed(2 ** 31 + 5)
    state = gen.get_state()
    calls = [_call(step, params, c2w, rays, gen, state, align)
             for _ in range(3)]
    assert step.graphed.captures == 1
    (eager, s0, n0), (captured, s1, n1), (replayed, s2, n2) = calls
    assert torch.equal(s0, s1) and torch.equal(s1, s2)
    assert n0 and n0 == n1 == n2, (n0, n1, n2)
    assert torch.isfinite(eager[1]).all()
    _close(captured, eager, exact=route.endswith("_det"))
    _close(replayed, captured, exact=True)

    # The pipelined snapshot: the same values in fresh tensors.
    fresh = copy.deepcopy({k: v for k, v in params.items()})
    again, _, _ = _call(step, fresh, c2w.clone(), rays.clone(), gen, state,
                        None if align is None else align.clone())
    _close(again, replayed, exact=True)

    # New values of the same shapes: what an eager step gives on them.
    moved = c2w.clone()
    moved[:3, 3] += 0.01
    other = gen.get_state()
    got, _, _ = _call(step, params, moved, rays.flip(0), gen, other, align)
    want, _, _ = _call(make_tracking_step(slam.model, cfg), params, moved,
                       rays.flip(0), gen, other, align)
    _close(got, want, exact=route.endswith("_det"))
    assert not torch.equal(got[0], replayed[0])
    assert step.graphed.captures == 1

    # A new ray count is a new key: warmed up, then captured once more.
    for _ in range(2):
        _call(step, params, c2w, rays[:512], gen, state, align)
    assert step.graphed.captures == 2


@pytest.mark.cuda
def test_replay_on_a_stream_of_its_own(cuda_device, tmp_path):
    """The pipelined tracker's route: a step warmed up, captured and
    replayed on a non-default stream (the capture then runs on that
    stream itself) with its own generator gives what the same calls give
    on the default stream, and counts the same launches a call on its
    stream; the default stream's graph replays on it too."""
    slam, cfg, c2w, rays = _slam("room0", cuda_device, tmp_path)
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    state = gen.get_state()
    step = make_tracking_step(slam.model, cfg)
    calls = [_call(step, slam.params, c2w, rays, gen, state, None)
             for _ in range(3)]
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    tracker = make_tracking_step(slam.model, cfg)
    with torch.cuda.stream(side):
        on_side = [_call(tracker, slam.params, c2w, rays, gen, state, None)
                   for _ in range(3)]
        again = _call(step, slam.params, c2w, rays, gen, state, None)
    assert tracker.graphed.captures == step.graphed.captures == 1
    for (out, s, n), (want, ws, wn) in zip([*on_side, again],
                                           [*calls, calls[2]]):
        _close(out, want, exact=True)
        assert torch.equal(s, ws)
        assert n == wn


@pytest.mark.cuda
def test_sequential_loop_replays_from_the_third_call(cuda_device, tmp_path):
    """CoSLAM.run on 4 frames: frame 1's tracking call is eager (its
    replay sum 0), frame 2's captures and replays, frame 3's replays;
    a replayed call spends no host time in its forward, backward or
    update."""
    cfg = S.room0_config(str(tmp_path), H, W, N_FRAMES)
    cfg["mapping"].update(first_iters=60, first_mesh=False)
    cfg["mesh"]["vis"] = 0
    data = S.SyntheticFrames(cfg, N_FRAMES, device=cuda_device)
    slam = CoSLAM(cfg, data, device=cuda_device)
    slam.run(verbose=False, eval_ate=False, mesh=False)
    t = slam.timings
    replay = t["tracking.replay"]
    assert len(replay) == N_FRAMES - 1
    assert replay[0] == 0.0 and all(v > 0.0 for v in replay[1:])
    for phase in ("forward", "backward", "update"):
        vals = t[f"tracking.{phase}"]
        assert vals[0] > 0.0 and all(v == 0.0 for v in vals[1:]), phase
    assert slam._track_step.graphed.captures == 1
