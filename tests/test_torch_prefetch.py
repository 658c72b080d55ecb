"""The port's frame prefetcher (coslam_torch/data/prefetch.py), the twins
of tests/test_prefetch.py: strict frame order whatever the worker count,
the serial stage, failures re-raised at the consumer, bounded look-ahead;
and the loop's periodic mesh and ATE on the mesh worker (mesh.async_vis),
the twin of tests/test_integration.py:test_async_periodic_mesh_eval: the
files equal the synchronous path's byte for byte on the CPU, where every
step adds in a fixed order.
"""

import os
import threading
import time

import pytest
import torch

from coslam_torch.data.prefetch import PrefetchIterator

torch.set_num_threads(1)


class SlowDataset:
    """Variable-latency loads to force out-of-order completion."""

    def __init__(self, n=24):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        # Earlier frames are slower: with 4 workers, frame i + 1 often
        # finishes before frame i, and the stage must reorder.
        time.sleep(0.002 if i % 3 == 0 else 0.0)
        return {"frame_id": i, "payload": i * 10}


@pytest.mark.parametrize("workers", [1, 4])
def test_order_and_content(workers):
    ds = SlowDataset()
    out = list(PrefetchIterator(ds, workers=workers))
    assert [i for i, _ in out] == list(range(len(ds)))
    assert [b["payload"] for _, b in out] == [i * 10 for i in range(len(ds))]


def test_start_and_n_frames():
    ds = SlowDataset()
    out = list(PrefetchIterator(ds, n_frames=10, start=3, workers=4))
    assert [i for i, _ in out] == list(range(3, 10))


def test_transform_runs_serially_in_order():
    ds = SlowDataset()
    seen = []
    tids = set()

    def transform(i, batch):
        seen.append(i)
        tids.add(threading.get_ident())
        batch["staged"] = True
        return batch

    out = list(PrefetchIterator(ds, workers=4, transform=transform))
    assert seen == list(range(len(ds)))  # strict frame order
    assert len(tids) == 1                # one stage thread
    assert all(b["staged"] for _, b in out)


@pytest.mark.parametrize("workers", [1, 4])
def test_loader_exception_propagates(workers):
    class Failing(SlowDataset):
        def __getitem__(self, i):
            if i == 7:
                raise RuntimeError("decode failed")
            return super().__getitem__(i)

    it = iter(PrefetchIterator(Failing(), workers=workers))
    got = []
    with pytest.raises(RuntimeError, match="decode failed"):
        for i, _ in it:
            got.append(i)
    assert got == list(range(7))  # the frames before the failure arrive


def test_transform_exception_propagates():
    def transform(i, batch):
        if i == 5:
            raise ValueError("stage failed")
        return batch

    it = iter(PrefetchIterator(SlowDataset(), workers=4,
                               transform=transform))
    with pytest.raises(ValueError, match="stage failed"):
        list(it)


def test_slow_consumer_bounded_lookahead():
    """A stalled consumer must not let the loaders run to the end of the
    dataset (memory bound: workers + 2 depth frames)."""
    loaded = []

    class Tracking(SlowDataset):
        def __getitem__(self, i):
            loaded.append(i)
            return super().__getitem__(i)

    it = iter(PrefetchIterator(Tracking(n=100), workers=4, depth=2))
    next(it)
    time.sleep(0.1)  # the consumer stalls; the loaders hit the budget
    assert len(loaded) <= 4 + 2 * 2 + 1


def test_async_periodic_mesh_eval(tmp_path):
    """mesh.async_vis: the mesh.vis meshes and ATE lines, made on the mesh
    worker from snapshots taken at submit, equal the synchronous path's
    byte for byte, and are on disk when run() returns; the loop reads its
    frames from disk through the prefetcher (4 loader threads), and the
    periodic meshes come from the worker thread."""
    from coslam_tpu.data.synth import (AnalyticScene, make_synthetic_config,
                                       make_trajectory, write_replica_format)
    from coslam_torch.data.datasets import get_dataset
    from coslam_torch.runtime.slam import CoSLAM

    outs = {}
    for mode in ("async", "sync"):
        d = tmp_path / mode
        datadir = str(d / "scene")
        cfg = make_synthetic_config(datadir, str(d / "out"), H=40, W=52,
                                    n_frames=12)
        cfg["data"]["num_workers"] = 4
        cfg["mapping"].update(first_iters=30, iters=4, sample=128)
        cfg["tracking"].update(sample=128, iter=4)
        cfg["mesh"].update(vis=5, voxel_eval=0.12, voxel_final=0.12,
                           async_vis=mode == "async")
        cam = cfg["cam"]
        write_replica_format(datadir, AnalyticScene(),
                             make_trajectory(12, orbit_fraction=0.02),
                             cam["H"], cam["W"], cam["fx"], cam["fy"],
                             cam["cx"], cam["cy"])
        slam = CoSLAM(cfg, get_dataset(cfg), device="cpu")
        threads, save_mesh = {}, slam.save_mesh

        def recorded(i, *args, save_mesh=save_mesh, threads=threads,
                     **kwargs):
            threads.setdefault(i, []).append(threading.current_thread().name)
            return save_mesh(i, *args, **kwargs)

        slam.save_mesh = recorded
        slam.run(verbose=False, eval_ate=True)
        want = "mesh-eval" if mode == "async" else "MainThread"
        assert threads[5] == [want] and threads[10] == [want], threads
        out = os.path.join(cfg["data"]["output"], cfg["data"]["exp_name"])
        for f in ("mesh_track5.ply", "mesh_track10.ply", "output.txt"):
            assert os.path.getsize(os.path.join(out, f)) > 0, (mode, f)
        outs[mode] = out
    for f in ("mesh_track5.ply", "mesh_track10.ply", "output.txt",
              "output_relative.txt"):
        with open(os.path.join(outs["async"], f), "rb") as fa, \
                open(os.path.join(outs["sync"], f), "rb") as fb:
            assert fa.read() == fb.read(), f
