"""Concurrent tracker/mapper runtime on two CUDA streams.

Counterpart of coslam_tpu/runtime/pipeline.py (the reference's
coslam_mp.py, with mp_slam/tracker.py and mp_slam/mapper.py): one
process, two host threads.

- The MAPPER thread owns the parameters and the map optimizer's state:
  first-frame mapping, then global BA (and a keyframe, on the keyframe
  cadence) on frame ``mapping_idx + map_every`` as soon as tracking has
  passed it; after each it publishes a snapshot of the parameters. It
  writes the periodic checkpoint (``ckpt_every``; a resume goes through
  ``load_checkpoint`` and ``run(start_frame=cursor)``) and hands the
  periodic mesh (``mesh.vis``) to the single-flight mesh worker. As in
  the JAX package it runs no current-frame step (``mapping
  .cur_frame_iters``).
- The TRACKER thread tracks every frame against the latest published
  snapshot and never reads ``self.params``, which Adam updates in place.
  It waits while ``mapping_idx < tracking_idx - map_every - map_every //
  2`` (the reference's throttle, mp_slam/tracker.py:150-152).

On CUDA each thread runs on a non-default stream of its own, created by
:meth:`PipelinedCoSLAM.run`. What one stream makes and another reads
goes with an event recorded after it, which the reader's stream waits
on:

- the parameter snapshot: cloned on the mapper's stream, an event
  recorded, the pair swapped in as one reference. The tracker keeps its
  snapshot referenced until its frame's readback (``.cpu()``) has
  waited for its stream, so the mapper stream's caching allocator never
  hands the snapshot's blocks out while the tracker reads them;
- the exposure parameters of ``training.frame_align``
  (:attr:`PipelinedCoSLAM.cur_align`): the tracker writes the current
  frame's with its pose, BA reads and writes them, and the last write
  wins, as in the JAX pipeline. Each write records an event; each read
  waits on it and marks the tensor in use by the reading stream
  (``record_stream``);
- the periodic mesh job's parameter clone (CoSLAM._periodic_mesh_eval)
  and the checkpoint writer's clones (AsyncCheckpointWriter), each with
  an event recorded on the submitting stream.

The caches of render.linspace, _kernels.level_table and the tri-plane's
axes upload from pageable host memory once, and such an upload has
finished when ``.to()`` returns, so either thread may read them. The
table gradients (and serial_scatter.serial_sort's scratch, which serves
one stream) are computed by the mapper only: the snapshot holds no
tensor that asks for a gradient and tracking detaches the map, so the
tracker's backward computes dx only. Neither loop calls
``torch.cuda.synchronize()``, which would wait for both streams; a
readback waits for its own.

The tracker draws from a device generator of its own (seeded from the
run's seed; the checkpoint holds both generators' states), so the two
threads never share a generator's offset. Under
``torch.use_deterministic_algorithms(True)`` a pipelined run is still
not bit-reproducible: the thread schedule decides which snapshot a frame
is tracked against, as in the JAX pipeline.

Placement (coslam_tpu's _setup_meshes of the pipeline): the tracker
keeps the first card; the mapper takes the second when one is visible.
``parallel.dp = N`` >= 2 names the total: the mapper owns cards 1 ...
N-1, and with N > 2 its first-frame and BA rays split over them
(parallel/sharding.py; ``mapping.sample`` must divide by N - 1). On the
CPU the devices are N times the CPU. Across cards:

- the snapshot: the mapper copies the parameters to the tracker's card
  (``.to(non_blocking=True)`` on its stream) and records its event after
  the copies; the tracker's stream waits on it, and the tracker marks the
  copies in use by its stream (``record_stream``);
- the exposure parameters: a read from the other card waits on the
  writer's event on that card's current stream, marks the tensor in use
  there and copies it to the reader's card; each thread's current device
  is its stream's.

Both threads record their spans in the loop's one recorder
(runtime/spans.py), each on its own stack: the tracker's steps and its
wait for the next frame (``load_wait``), the mapper's BA.

Not ported: the JAX pipeline's compile warm-up call, its device pose
chain and deferred-readback FIFO (the port reads one packed pose a
frame) and ``mapping.ba_chunks``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..data.prefetch import PrefetchIterator
from ..parallel.sharding import make_devices
from .checkpoint import _clone, param_leaves
from .slam import CoSLAM, _record_event, _wait_event, dp_of


def _current_device(like: torch.device) -> torch.device:
    """The calling thread's current device of ``like``'s type."""
    if like.type != "cuda":
        return like
    return torch.device("cuda", torch.cuda.current_device())


class PipelinedCoSLAM(CoSLAM):
    def __init__(self, config: Dict, dataset=None, device="cuda"):
        super().__init__(config, dataset, device)
        # The tracker's own random stream (perturbations and importance
        # draws of tracking), seeded from the run's seed.
        self.track_generator = torch.Generator(device=self.track_device)
        self.track_generator.manual_seed(int(np.random.default_rng(
            (self._seed, 1)).integers(2 ** 62)))
        # Shared state, each with one writer (the reference's
        # mapping_idx, tracking_idx and mapping_first_frame).
        self.tracking_idx = 0
        self.mapping_idx = 0
        self.mapping_first_frame = False
        self._shared = None     # (parameter snapshot, its event)
        self._stop = False
        self._error: Optional[BaseException] = None
        self._frames: Dict[int, Dict] = {}
        self._frames_lock = threading.Lock()
        # Thread name -> the raw handle of the stream it ran on.
        self.thread_streams: Dict[str, int] = {}
        # Frames the tracker was ahead of the mapped frame after each BA.
        self.mapper_lag = []

    def _placement(self, config: Dict, device):
        """(tracker's devices, mapper's devices): see the module
        docstring. Raises ValueError when parallel.dp exceeds the visible
        cards or mapping.sample does not divide by dp - 1."""
        dp = dp_of(config)
        device = torch.device(device)
        if dp > 1:
            devices = make_devices(dp, device)
            if dp > 2:
                n = dp - 1
                size = config["mapping"]["sample"]
                if size % n:
                    raise ValueError(
                        f"mapping.sample={size} not divisible by the mapper "
                        f"mesh size {n} (= parallel.dp - 1)")
            return devices[:1], devices[1:]
        if device.type == "cuda" and torch.cuda.device_count() > 1:
            return [torch.device("cuda", 0)], [torch.device("cuda", 1)]
        return [device], [device]

    # -- state shared between the streams --------------------------------------

    @property
    def cur_align(self) -> Optional[torch.Tensor]:
        """The current frame's exposure parameters, ready on the calling
        thread's stream (see the module docstring)."""
        pub = self.__dict__.get("_cur_align_pub")
        if pub is None:
            return None
        value, event = pub
        stream = _wait_event(value.device, event)
        if stream is not None:
            value.record_stream(stream)
        here = _current_device(value.device)
        if value.device != here:
            value = value.to(here, non_blocking=True)
        return value

    @cur_align.setter
    def cur_align(self, value: Optional[torch.Tensor]) -> None:
        self._cur_align_pub = (None if value is None
                               else (value, _record_event(value.device)))

    def _publish_params(self) -> None:
        """Swap in a snapshot of the parameters on the tracker's device:
        cloned on this thread's stream, or copied to the tracker's card
        when the mapper has its own, with an event recorded after the
        clones or copies."""
        with torch.no_grad():
            if self.track_device == self.device:
                snap = _clone(self.params)
            else:
                snap = _to_device(self.params, self.track_device)
        assert not any(t.requires_grad for t in param_leaves(snap))
        self._shared = (snap, _record_event(self.device))

    def _fail(self, e: BaseException) -> None:
        if self._error is None:
            self._error = e
        self._stop = True

    def _on_stream(self, name: str, stream):
        """The context a thread runs in: its stream (nothing on the CPU);
        records the stream's handle under the thread's name."""
        if stream is None:
            return contextlib.nullcontext()
        self.thread_streams[name] = stream.cuda_stream
        return torch.cuda.stream(stream)

    # -- threads --------------------------------------------------------------

    def _tracker_loop(self, total: int, start: int, stream) -> None:
        try:
            with self._on_stream("tracker", stream):
                cfg = self.config
                map_every = cfg["mapping"]["map_every"]
                lag = map_every + map_every // 2
                frames = PrefetchIterator(
                    self.dataset, total, start=start,
                    workers=cfg["data"].get("num_workers"))
                while not self.mapping_first_frame and not self._stop:
                    time.sleep(0.005)
                spans = self.spans
                for i, batch in spans.each_after("load_wait", frames):
                    if self._stop:
                        return
                    if self.mapping_idx < i - lag:
                        with spans.span("throttle", event=True):
                            while (self.mapping_idx < i - lag
                                   and not self._stop):
                                time.sleep(0.002)
                    self.frame_walls.append(time.perf_counter())
                    # Held until the next snapshot is taken, after this
                    # frame's readback.
                    params, ready = self._shared
                    on = _wait_event(self.track_device, ready)
                    if on is not None and self.track_device != self.device:
                        # The copies were allocated on the mapper's
                        # thread: in use by this stream until released.
                        for leaf in param_leaves(params):
                            leaf.record_stream(on)
                    if self._track_pc_step is not None:
                        self.tracking_pc(batch, i, params=params)
                    self.tracking_render(batch, i, params=params)
                    if i % map_every == 0:
                        # Only the frames the mapper takes are kept.
                        with self._frames_lock:
                            self._frames[i] = batch
                    self.tracking_idx = i
                self.frame_walls.append(time.perf_counter())
        except BaseException as e:
            self._fail(e)

    def _mapper_loop(self, total: int, start: int, ckpt_every: int, out: str,
                     eval_ate: bool, stream) -> None:
        try:
            with self._on_stream("mapper", stream):
                cfg = self.config
                map_every = cfg["mapping"]["map_every"]
                kf_every = cfg["mapping"]["keyframe_every"]
                vis = int(cfg["mesh"].get("vis", 0) or 0)
                spans = self.spans
                if start <= 1:
                    self.first_frame_mapping(self.dataset[0])
                    next_map = map_every
                else:
                    # Resume: the map and keyframes up to the cursor came
                    # from load_checkpoint; BA goes on at the next frame
                    # of its cadence.
                    next_map = ((start - 1) // map_every + 1) * map_every
                    self.mapping_idx = next_map - map_every
                self._publish_params()
                self.mapping_first_frame = True
                while next_map < total and not self._stop:
                    if self.tracking_idx < next_map:
                        time.sleep(0.002)
                        continue
                    with self._frames_lock:
                        batch = self._frames.pop(next_map, None)
                    if batch is None:
                        batch = self.dataset[next_map]
                    with spans.span("ba", event=True):
                        self.global_BA(batch, next_map)
                    if next_map % kf_every == 0:
                        with spans.span("keyframe", event=True):
                            self.add_keyframe(batch)
                    self._publish_params()
                    self.mapping_idx = next_map
                    self.mapper_lag.append(self.tracking_idx - next_map)
                    if ckpt_every and next_map % ckpt_every == 0 \
                            and next_map > start:
                        # Frames [0, next_map] are tracked, mapped and
                        # keyframed: a resume starts at next_map + 1.
                        with spans.span("checkpoint", event=True):
                            self.save_checkpoint(
                                os.path.join(out,
                                             f"checkpoint{next_map}.npz"),
                                frame_cursor=next_map + 1, async_write=True)
                    if vis and next_map % vis == 0:
                        with spans.span("mesh_eval", event=True):
                            self._periodic_mesh_eval(next_map, eval_ate)
                    next_map += map_every
                if not self._stop:
                    self.mapping_idx = total  # releases a throttled tracker
        except BaseException as e:
            self._fail(e)
            self.mapping_first_frame = True

    def _stop_mapper_when_done(self, total: int,
                               mapper: threading.Thread) -> None:
        """After the tracker's last frame: wait until the mapper has
        mapped the last frame of its cadence (or failed), then stop it."""
        map_every = self.config["mapping"]["map_every"]
        last = ((total - 1) // map_every) * map_every
        while (self.mapping_idx < last and not self._stop
               and mapper.is_alive()):
            time.sleep(0.01)
        self._stop = True

    # -- entry ----------------------------------------------------------------

    def run(self, n_frames: Optional[int] = None, verbose: bool = True,
            eval_ate: bool = True, mesh: bool = True, ckpt_every: int = 0,
            start_frame: int = 0):
        """Process the first n_frames frames (all by default) on the two
        threads; returns the ATE statistics (None with eval_ate=False).
        ckpt_every: the mapper writes checkpoint{i}.npz (cursor i + 1)
        after mapping frame i, every that many frames. start_frame:
        resume there (the cursor load_checkpoint returned). An exception
        in either thread stops both and is raised here."""
        cfg = self.config
        out = os.path.join(cfg["data"]["output"], cfg["data"]["exp_name"])
        os.makedirs(out, exist_ok=True)
        total = len(self.dataset) if n_frames is None else min(
            n_frames, len(self.dataset))
        start = max(1, int(start_frame))
        if start_frame <= 0:
            self.est_c2w[0] = np.asarray(self.dataset[0]["c2w"], np.float32)
        self.frame_walls, self.frame_events = [], []
        self.thread_streams, self.mapper_lag = {}, []
        self._stop, self._error = False, None
        self.mapping_first_frame = False
        streams = ((torch.cuda.Stream(self.track_device),
                    torch.cuda.Stream(self.device))
                   if self.device.type == "cuda" else (None, None))
        mapper = threading.Thread(
            target=self._mapper_loop,
            args=(total, start, ckpt_every, out, eval_ate, streams[1]),
            name="mapper")
        tracker = threading.Thread(target=self._tracker_loop,
                                   args=(total, start, streams[0]),
                                   name="tracker")
        mapper.start()
        tracker.start()
        tracker.join()
        self._stop_mapper_when_done(total, mapper)
        mapper.join()
        # The threads are done: this thread's stream takes over.
        for s in streams:
            if s is not None:
                s.synchronize()
        self._mesh_worker.wait()   # the periodic meshes land first
        self._ckpt_writer.wait()
        if self._error is not None:
            raise self._error

        self.save_checkpoint(os.path.join(out, f"checkpoint{total - 1}.npz"),
                             frame_cursor=total)
        if mesh:
            self.final_mesh = self.save_mesh(
                total - 1, voxel_size=cfg["mesh"]["voxel_final"])
        results = self._evaluate(total) if eval_ate else None
        if verbose:
            if results is not None:
                print(f"ATE RMSE "
                      f"{results['absolute_translational_error.rmse']}")
            self.print_timings()
        return results


def _to_device(tree, device: torch.device):
    """Every tensor of a parameter tree copied to ``device`` on the
    current stream, without waiting for the host."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, non_blocking=True)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return [_to_device(v, device) for v in tree]

