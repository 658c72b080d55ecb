"""Camera tracking: a fixed number of Adam steps on the frame's pose.

Counterpart of coslam_tpu/runtime/tracking.py (make_tracking_step and
make_tracking_pc_step). The JAX ``lax.scan`` becomes a Python loop of
steps; the best-pose carry, the stall counter and the early-stop mask
stay on the device as ``torch.where`` selects, so the loop issues no
host read, and on one CUDA device the loop is captured once as a CUDA
graph and replayed (:class:`GraphedIterations`).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..ops import _kernels
from ..ops import losses as L
from ..ops import pose as P
from ..parallel.sharding import (_flatten, add_stats, dp_forward, on_device,
                                 replicate, shard_devices, split_rays)
from .optim import detached, make_pose_optimizer
from .spans import NO_SPANS


def make_tracking_step(model, config: Dict, devices=None, spans=None):
    """Returns step(params, c2w_init [4, 4], rays [S, 7], generator,
    align=None) -> (c2w [4, 4], losses [iter], psnrs [iter], align), all
    on the device. ``align`` [4] (training.frame_align: the frame's
    initial exposure parameters, else None) is optimized with the pose
    (Adam at tracking.lr_align, else mapping.lr_align, else 0.01) and
    returned chosen with it; None stays None.

    The map is frozen (the parameters are detached), so the encode
    backward computes dx only. With ``tracking.best`` the returned pose
    is the lowest-loss pose EVALUATED in some iteration, otherwise the
    pose evaluated in the last executed iteration — not the pose after
    the last update. ``generator`` draws the stratified perturbation and
    the importance samples (unused when ``training.perturb`` is 0).

    ``devices`` (two or more: ``parallel.dp``): the rays are split over
    them (parallel/sharding.py); the frozen map is copied to each once a
    call, the draws are made on the rays' device for the whole batch.

    On one CUDA device the iterations are one CUDA graph
    (:class:`GraphedIterations`): a call with inputs of a new shape runs
    them eagerly (the warm-up), the next captures them, and every later
    call replays the capture in one launch. The step's outputs are the
    same either way, and so is the generator's state after the call.
    Several devices and CPU tensors run them eagerly.

    ``spans`` (runtime/spans.Spans): each eager iteration's phases are
    spans ``tracking.forward`` (the draws, the pose, the forward and the
    loss; the importance fine pass inside it is a span
    ``tracking.fine``), ``tracking.backward`` (the backward) and
    ``tracking.update`` (the best-pose selects, the Adam step and the
    early-stop copy); a replayed call is one span ``tracking.replay``
    (the draws, the copy of the inputs into the graph's, the replay and
    the copy of its outputs)."""
    devices = shard_devices(devices)
    span = (spans or NO_SPANS).span
    tcfg = config["tracking"]
    n_iter = int(tcfg["iter"])
    use_best = bool(tcfg["best"])
    wait_iters = int(tcfg["wait_iters"])
    weights = config["training"]
    robust = float(tcfg.get("robust_delta", 0.0) or 0.0) or None
    prior_t = float(tcfg.get("prior_trans", 0.0) or 0.0)
    prior_r = float(tcfg.get("prior_rot", 0.0) or 0.0)
    lrs = (float(tcfg["lr_rot"]), float(tcfg["lr_trans"]),
           float(tcfg.get("lr_align",
                          config["mapping"].get("lr_align", 0.01))))
    mat_to_tensor, mat_from_tensor = P.get_pose_representation(
        config["training"]["rot_rep"])

    def iterations(params, c2w_init, rays, draw, align=None,
                   span=NO_SPANS.span):
        """The n_iter Adam steps from c2w_init; ``draw(i)``: iteration
        i's (t, u)."""
        params = detached(params)
        replicas = replicate(params, devices) if devices else None
        rot0 = mat_to_tensor(c2w_init[:3, :3])[None]
        trans0 = c2w_init[:3, 3][None]
        state = [rot0.clone(), trans0.clone()]
        if align is not None:
            state.append(align.detach().clone())
        for v in state:
            v.requires_grad_(True)
        rot, trans = state[:2]
        align = state[2] if align is not None else None
        # A fresh Adam each call: its moments start at zero.
        moments = ([torch.zeros_like(v) for v in state],
                   [torch.zeros_like(v) for v in state])
        dirs, target_rgb, target_d = rays[:, :3], rays[:, 3:6], rays[:, 6:7]
        dev = rays.device

        best_loss = torch.full((), float("inf"), device=dev)
        best = [v.detach().clone() for v in state]
        last = [v.detach().clone() for v in state]
        stall = torch.zeros((), dtype=torch.int64, device=dev)
        done = torch.zeros((), dtype=torch.bool, device=dev)
        losses, psnrs = [], []
        for i in range(n_iter):
            with span("tracking.forward"):
                t, u = draw(i)
                c2w = mat_from_tensor(rot, trans)[0]
                rays_d = dirs @ c2w[:3, :3].T
                rays_o = c2w[:3, 3].expand_as(rays_d)
                ret = dp_forward(model, params, devices, rays_o, rays_d,
                                 target_rgb, target_d, replicas, t=t, u=u,
                                 rgb_kernel=robust, align=align)
                loss = L.total_loss(ret, weights)
                if prior_t > 0.0:
                    loss = loss + prior_t * ((trans - trans0) ** 2).sum()
                if prior_r > 0.0:
                    loss = loss + prior_r * ((rot - rot0) ** 2).sum()
            with span("tracking.backward"):
                grads = torch.autograd.grad(loss, state)

            with span("tracking.update"):
                with torch.no_grad():
                    loss_d = loss.detach()
                    improved = loss_d < best_loss
                    take = improved & ~done
                    best = [torch.where(take, v, b)
                            for v, b in zip(state, best)]
                    best_loss = torch.where(take, loss_d, best_loss)
                    stall = torch.where(done, stall,
                                        torch.where(improved, 0, stall + 1))
                    last = [torch.where(done, b, v)
                            for v, b in zip(state, last)]
                    old = [v.clone() for v in state]
                    pose_adam_step(state, grads, moments, lrs, i + 1)
                    # After the early stop the pose stays where it was.
                    for v, o in zip(state, old):
                        v.copy_(torch.where(done, o, v))
                    done = done | (stall > wait_iters)
                losses.append(loss_d)
                psnrs.append(ret["psnr"].detach())

        with torch.no_grad():
            chosen = best if use_best else last
            c2w = mat_from_tensor(chosen[0], chosen[1])[0]
        return (c2w, torch.stack(losses), torch.stack(psnrs),
                chosen[2] if align is not None else None)

    def eager(params, c2w_init, rays, generator=None, align=None):
        n, dev = rays.shape[0], rays.device
        return iterations(params, c2w_init, rays,
                          lambda i: model.ray_draws(generator, n, dev),
                          align, span)

    graphed = GraphedIterations(iterations, model, n_iter)

    def step(params, c2w_init, rays, generator=None, align=None):
        if devices is not None or not rays.is_cuda:
            return eager(params, c2w_init, rays, generator, align)
        return graphed(params, c2w_init, rays, generator, align, eager, span)

    step.graphed = graphed
    return step


def pose_adam_step(params, grads, moments, lrs, step: int,
                   betas=(0.9, 0.999), eps: float = 1e-8) -> None:
    """Adam step ``step`` (1, 2, ...) of the pose tensors, in place, each
    at its learning rate (``lrs``: rotation, translation, exposure);
    ``moments``: (first, second), one a tensor, updated in place. The
    operations and their order are those of torch.optim.Adam's
    multi-tensor step (and, op for op, of its single-tensor one), with
    the bias corrections of the step count as Python numbers: no host
    read, so a CUDA graph can hold it."""
    beta1, beta2 = betas
    exp_avg, exp_avg_sq = moments
    torch._foreach_lerp_(exp_avg, grads, 1 - beta1)
    torch._foreach_mul_(exp_avg_sq, beta2)
    torch._foreach_addcmul_(exp_avg_sq, grads, grads, 1 - beta2)
    bias1 = 1 - beta1 ** step
    denom = torch._foreach_sqrt(exp_avg_sq)
    torch._foreach_div_(denom, (1 - beta2 ** step) ** 0.5)
    torch._foreach_add_(denom, eps)
    torch._foreach_addcdiv_(params, exp_avg, denom,
                            [(lr / bias1) * -1 for lr in lrs[:len(params)]])


class GraphedIterations:
    """The tracking step's iterations as CUDA graphs on one device, one a
    key: the device, the shape and dtype of every input (the map's
    tensors, the start pose, the rays, the draws, the exposure) and the
    deterministic switch.

    A call with a key not seen runs the step eagerly (the warm-up: the
    kernels' builds, cuBLAS's workspaces, autograd's, the caches of
    render.linspace and _kernels.level_table). The next call with it
    draws every iteration's t and u up front, with the calls and in the
    order the eager iterations make them (the same values, the generator
    left in the same state), copies its inputs into buffers of the
    graph's own and captures the iterations once on them, with no spans.
    Every later call draws, copies its inputs in (a fresh snapshot of
    the map, a replaced tensor: the buffers are never the caller's),
    replays the graph on the calling stream and returns clones of its
    outputs, which the next replay overwrites.

    The kernels' launch counters (_kernels.counted) count at the
    capture: the capture's counts stand for its own call's launches, on
    the calling stream, and each replay adds them again."""

    def __init__(self, iterations: Callable, model, n_iter: int):
        self.iterations = iterations
        self.model = model
        self.n_iter = n_iter
        self.graphs: Dict = {}      # key -> _Graph or WARM
        self.captures = 0

    def draw_ahead(self, generator, n_rays: int, device) -> tuple:
        """Every iteration's draws, as the eager iterations make them:
        (t [iter, S, z] or None, u [iter, S, k] or None)."""
        draws = [self.model.ray_draws(generator, n_rays, device)
                 for _ in range(self.n_iter)]
        return tuple(None if d[0] is None else torch.stack(d)
                     for d in zip(*draws))

    def body(self, params, c2w_init, rays, t, u, align):
        """The iterations on pre-drawn t and u, with no spans."""
        return self.iterations(
            params, c2w_init, rays,
            lambda i: (None if t is None else t[i],
                       None if u is None else u[i]), align)

    def __call__(self, params, c2w_init, rays, generator, align, eager,
                 span):
        inputs = [detached(params), c2w_init, rays, None, None, align]
        leaves: list = []
        _flatten([x for x in inputs if x is not None], leaves)
        key = (rays.device, torch.are_deterministic_algorithms_enabled(),
               align is None,
               tuple((tuple(x.shape), x.dtype) for x in leaves))
        graph = self.graphs.get(key)
        if graph is None:
            self.graphs[key] = WARM
            return eager(params, c2w_init, rays, generator, align)
        with span("tracking.replay"):
            inputs[3:5] = self.draw_ahead(generator, rays.shape[0],
                                          rays.device)
            if graph is WARM:
                graph = self.graphs[key] = _Graph(inputs)
                graph.capture(self.body)
                self.captures += 1
            else:
                graph.load(inputs)
                graph.replay()
            return _clones(graph.outputs)


# A key whose first call has run eagerly: its next call captures.
WARM = "warm"


def _clones(tensors) -> tuple:
    return tuple(None if x is None else x.clone() for x in tensors)


class _Graph:
    """One key's CUDA graph: the buffers of its inputs, its outputs and
    the launches its capture counted."""

    def __init__(self, inputs: list):
        leaves: list = []
        rebuild = _flatten([x for x in inputs if x is not None], leaves)
        self.leaves = [x.detach().clone() for x in leaves]
        it = iter(rebuild(self.leaves))
        self.inputs = [None if x is None else next(it) for x in inputs]
        self.graph = self.outputs = None
        self.launches: Dict = {}

    def load(self, inputs: list) -> None:
        """Copy a call's inputs into the buffers."""
        leaves: list = []
        _flatten([x for x in inputs if x is not None], leaves)
        for buf, x in zip(self.leaves, leaves):
            buf.copy_(x)

    def run(self, body: Callable):
        """The body on the buffers, as it is captured, without a graph."""
        self.outputs = body(*self.inputs)
        return self.outputs

    def capture(self, body: Callable) -> None:
        """Capture the body on the buffers, then replay it once on the
        calling stream. The capture runs on the calling stream, or on a
        stream of its own where that is the device's default stream
        (which cannot capture). Its launches count on the calling
        stream."""
        device = self.inputs[2].device
        calling = torch.cuda.current_stream(device)
        stream = (torch.cuda.Stream(device)
                  if calling == torch.cuda.default_stream(device)
                  else calling)
        before = _kernels.stream_launches(stream.cuda_stream)
        graph = torch.cuda.CUDAGraph()
        # thread_local: the pipelined mapper's thread may sync meanwhile.
        with torch.cuda.device(device), torch.cuda.stream(stream):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.run(body)
            finally:
                graph.capture_end()
        counted = _kernels.stream_launches(stream.cuda_stream)
        self.launches = {k: n - before.get(k, 0) for k, n in counted.items()
                         if n != before.get(k, 0)}
        _kernels.add_launches(self.launches, stream.cuda_stream, -1)
        _kernels.add_launches(self.launches, calling.cuda_stream)
        self.graph = graph
        graph.replay()

    def replay(self) -> None:
        """Replay the graph on the calling stream; its launches count."""
        _kernels.add_launches(self.launches,
                              _kernels.stream(self.inputs[2].device))
        self.graph.replay()


def make_tracking_pc_step(model, config: Dict, devices=None):
    """Point-cloud tracking (tracking.iter_point > 0; coslam_tpu's
    make_tracking_pc_step): returns step(params, c2w_init [4, 4], rays
    [S, 7]) -> (c2w [4, 4], last loss). Each of max(iter_point, 1) Adam
    steps back-projects the rays' depths from the current pose, queries
    SDF and color there and minimizes 5 mse(rgb) + 1000 mse(sdf) over the
    rays with depth in (0, 5) m; the pose returned is the best evaluated
    (tracking.best) or the last evaluated. The map is frozen. ``devices``:
    the points split over them, as :func:`make_tracking_step`'s rays."""
    devices = shard_devices(devices)
    tcfg = config["tracking"]
    n_iter = max(int(tcfg["iter_point"]), 1)
    use_best = bool(tcfg["best"])
    mat_to_tensor, mat_from_tensor = P.get_pose_representation(
        config["training"]["rot_rep"])

    def stats(params, pts, target_rgb, valid):
        out = model.query_color_sdf(params, model.normalize_coords(pts))
        rgb_sum, rgb_n = L.masked_sum(
            (torch.sigmoid(out[:, :3]) - target_rgb) ** 2, valid[:, None])
        sdf_sum, sdf_n = L.masked_sum(out[:, -1] ** 2, valid)
        return {"rgb_sum": rgb_sum, "rgb_n": rgb_n, "sdf_sum": sdf_sum,
                "sdf_n": sdf_n}

    def step(params, c2w_init, rays):
        params = detached(params)
        replicas = replicate(params, devices) if devices else None
        rot = mat_to_tensor(c2w_init[:3, :3])[None].clone().requires_grad_()
        trans = c2w_init[:3, 3][None].clone().requires_grad_()
        opt = make_pose_optimizer(rot, trans, tcfg["lr_rot"],
                                  tcfg["lr_trans"])
        dirs, target_rgb, target_d = rays[:, :3], rays[:, 3:6], rays[:, 6:7]
        # A fixed 5 m bound, as the JAX step's (not cam.depth_trunc).
        valid = ((target_d[:, 0] > 0.0) & (target_d[:, 0] < 5.0)).float()
        best_loss = torch.tensor(float("inf"), device=rays.device)
        best = last = (rot.detach().clone(), trans.detach().clone())
        loss_d = None
        for _ in range(n_iter):
            c2w = mat_from_tensor(rot, trans)[0]
            pts = c2w[:3, 3][None] + target_d * (dirs @ c2w[:3, :3].T)
            if devices:
                shards = []
                for dev, rep, *block in zip(
                        devices, replicas, *(split_rays(x, devices)
                                             for x in (pts, target_rgb,
                                                       valid))):
                    with on_device(dev):
                        shards.append(stats(rep, *block))
                s = add_stats(shards, rays.device)
            else:
                s = stats(params, pts, target_rgb, valid)
            rgb_l = s["rgb_sum"] / s["rgb_n"].clamp_min(1.0)
            sdf_l = s["sdf_sum"] / s["sdf_n"].clamp_min(1.0)
            loss = 5.0 * rgb_l + 1000.0 * sdf_l
            opt.zero_grad(set_to_none=True)
            loss.backward()
            with torch.no_grad():
                loss_d = loss.detach()
                improved = loss_d < best_loss
                best = tuple(torch.where(improved, v, b)
                             for v, b in zip((rot, trans), best))
                best_loss = torch.minimum(loss_d, best_loss)
                last = (rot.detach().clone(), trans.detach().clone())
            opt.step()
        with torch.no_grad():
            chosen = best if use_best else last
            return mat_from_tensor(*chosen)[0], loss_d

    return step


def predict_current_pose(est_prev, est_prev_prev=None, constant_speed=True,
                         gap_ratio: float = 1.0):
    """Constant-speed motion model (coslam_tpu.runtime.tracking
    .predict_current_pose): apply the last inter-frame delta to the
    previous pose, or copy it when there is no history. ``gap_ratio``
    rescales that delta for frames spaced unevenly (ActiveCoSLAM tracks
    an info-gain subsequence): the rotation vector and the translation
    are scaled together (scipy's rotation-vector map). At 1 the delta is
    applied as it is."""
    if est_prev_prev is None or not constant_speed:
        return np.array(est_prev, np.float32)
    delta = est_prev @ np.linalg.inv(est_prev_prev.astype(np.float64))
    if gap_ratio != 1.0:
        from scipy.spatial.transform import Rotation

        rotvec = Rotation.from_matrix(delta[:3, :3]).as_rotvec()
        scaled = np.eye(4)
        scaled[:3, :3] = Rotation.from_rotvec(gap_ratio * rotvec).as_matrix()
        scaled[:3, 3] = gap_ratio * delta[:3, 3]
        delta = scaled
    return (delta @ est_prev).astype(np.float32)
