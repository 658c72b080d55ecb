"""The tracking step's CUDA-graph route (coslam_torch/runtime/tracking.py
GraphedIterations) on the CPU, where no graph is captured: the graph's
body run on its own buffers, uncaptured (every iteration's draws made up
front, the inputs copied into the buffers, a fresh Adam in the body, the
outputs cloned), bit for bit against the eager loop, with tracking.best
and without, with and without training.frame_align, with and without the
importance draws; the draws made up front equal to the eager loop's one
by one, the generator left in the same state; and the choice of the
route: CPU tensors and parallel.dp take the eager loop, which adds 0 to
the tracking.replay sum of the loop's tracking span.

Sizes: the 24 x 32 analytic scene's configuration, 64 rays, 5 iterations
(wait_iters 1, so the early stop falls inside them); no tolerance: the
two routes run the same operations on the same values.
"""

import numpy as np
import pytest
import torch

from coslam_torch.data import synth as TS
from coslam_torch.models.scene_rep import JointEncoding
from coslam_torch.runtime.optim import detached
from coslam_torch.runtime.slam import CoSLAM
from coslam_torch.runtime.tracking import _Graph, make_tracking_step

torch.set_num_threads(1)

N_RAYS, N_ITER = 64, 5
CASES = {
    "best": {},
    "last": {"tracking": {"best": False}},
    "frame_align": {"training": {"frame_align": True}},
    "importance": {"training": {"n_importance": 8}},
    "importance_unperturbed": {"training": {"n_importance": 8,
                                            "perturb": 0}},
    "unperturbed": {"training": {"perturb": 0}},
}


def _config(updates):
    cfg = TS.make_synthetic_config("", "/tmp/unused", H=24, W=32)
    for section, vals in updates.items():
        cfg[section].update(vals)
    cfg["tracking"].update(iter=N_ITER, sample=N_RAYS, wait_iters=1)
    return cfg


def _inputs(cfg, seed):
    """A model, its parameters, a start pose, rays and the exposure
    (None without frame_align), all drawn from ``seed``."""
    model = JointEncoding(cfg, np.array(cfg["mapping"]["bound"], np.float32))
    params = model.init_params(torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    rays = torch.rand(N_RAYS, 7, generator=gen)
    rays[:, 6] = 0.2 + 3.0 * rays[:, 6]
    c2w = torch.eye(4)
    c2w[:3, 3] = 0.2 * torch.rand(3, generator=gen) - 0.1
    align = (torch.tensor([1.05, 0.95, 1.0, 0.02])
             if cfg["training"].get("frame_align") else None)
    return model, params, c2w, rays, align


def _equal(got, want):
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert torch.equal(g, w), (g, w)


@pytest.mark.parametrize("case", list(CASES))
def test_buffer_body_equals_the_eager_loop_bit_for_bit(case):
    """The body a graph captures, run on its buffers without a capture:
    its buffers first hold another call's inputs, then this call's are
    copied in (as a replay does), and run twice it gives the same bits
    both times (a fresh Adam each run); the clones a call returns are not
    the buffers' outputs."""
    cfg = _config(CASES[case])
    model, params, c2w, rays, align = _inputs(cfg, 0)
    step = make_tracking_step(model, cfg)
    gen = torch.Generator().manual_seed(5)
    want = step(params, c2w, rays, gen, align)
    want_state = gen.get_state()

    graphed = step.graphed
    _, other_params, other_c2w, other_rays, _ = _inputs(cfg, 9)
    other = [detached(other_params), other_c2w, other_rays,
             *graphed.draw_ahead(torch.Generator().manual_seed(11), N_RAYS,
                                 rays.device),
             None if align is None else align + 0.5]
    graph = _Graph(other)
    gen = torch.Generator().manual_seed(5)
    inputs = [detached(params), c2w, rays,
              *graphed.draw_ahead(gen, N_RAYS, rays.device), align]
    assert torch.equal(gen.get_state(), want_state)
    graph.load(inputs)
    first = tuple(None if x is None else x.clone()
                  for x in graph.run(graphed.body))
    _equal(first, want)
    again = graph.run(graphed.body)
    _equal(again, want)
    assert all(a is None or a.data_ptr() != b.data_ptr()
               for a, b in zip(first, again))


@pytest.mark.parametrize("case", ["best", "importance",
                                  "importance_unperturbed"])
def test_draws_up_front_equal_the_eager_draws(case):
    """draw_ahead's [iter, ...] draws against the model's draws one
    iteration at a time: the same values and the generator's state after
    them; (None, None) where training.perturb is 0, u None without a
    fine pass."""
    cfg = _config(CASES[case])
    model = _inputs(cfg, 0)[0]
    step = make_tracking_step(model, cfg)
    a, b = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    t, u = step.graphed.draw_ahead(a, N_RAYS, torch.device("cpu"))
    each = [model.ray_draws(b, N_RAYS, torch.device("cpu"))
            for _ in range(N_ITER)]
    assert torch.equal(a.get_state(), b.get_state())
    for got, k in ((t, 0), (u, 1)):
        if each[0][k] is None:
            assert got is None
        else:
            assert got.shape[0] == N_ITER
            assert torch.equal(got, torch.stack([d[k] for d in each]))
    if cfg["training"]["perturb"] > 0:
        assert t is not None
        assert (u is None) == (model.n_importance == 0)


@pytest.mark.parametrize("devices", [None, ["cpu", "cpu"]])
def test_cpu_and_data_parallel_stay_eager(devices):
    """On CPU tensors, and over two devices (parallel.dp), every call runs
    the eager loop: no key is kept, nothing is captured, and the result
    is the same call after call."""
    cfg = _config({})
    model, params, c2w, rays, align = _inputs(cfg, 0)
    devs = None if devices is None else [torch.device(d) for d in devices]
    step = make_tracking_step(model, cfg, devs)
    outs = [step(params, c2w, rays, torch.Generator().manual_seed(5), align)
            for _ in range(3)]
    assert step.graphed.graphs == {} and step.graphed.captures == 0
    for out in outs[1:]:
        _equal(out, outs[0])


def test_eager_call_adds_zero_to_the_replay_sum():
    """The loop's tracking span sums tracking.replay beside its phases:
    on the CPU each call adds one entry, 0, while its forward, backward
    and update take time."""
    cfg = _config({})
    cfg["data"]["exp_name"] = "graph"
    data = TS.SyntheticFrames(cfg, 3, device="cpu")
    slam = CoSLAM(cfg, data, device="cpu")
    slam.est_c2w[0] = np.asarray(data[0]["c2w"], np.float32)
    for i in (1, 2):
        slam.tracking_render(data[i], i)
    t = slam.timings
    assert t["tracking.replay"] == [0.0, 0.0]
    assert len(t["tracking"]) == 2
    for phase in ("forward", "backward", "update"):
        assert all(v > 0.0 for v in t[f"tracking.{phase}"])
