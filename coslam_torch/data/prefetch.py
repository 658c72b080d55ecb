"""Background frame prefetcher: overlap disk reads and image decode with
the card's work.

Counterpart of coslam_tpu/data/prefetch.py. The SLAM loop is a strict
frame sequence, but loading frame i + 1 (imread, PNG or JPEG decode,
resize) does not depend on processing frame i: a pool of loader threads
keeps a small queue ahead of the consumer, as the reference's torch
DataLoader with ``num_workers: 4`` does. The image decoders release the
GIL, so threads suffice.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Optional


class PrefetchIterator:
    """Iterate ``(i, dataset[i])`` for i in [0, n_frames) with lookahead.

    ``workers`` loader threads call ``dataset[i]`` concurrently (the
    loaders are read-only over files + cached intrinsics, so concurrent
    ``__getitem__`` is safe); frames are re-sequenced and handed IN
    FRAME ORDER to a single stage thread that applies ``transform`` and
    feeds the consumer queue. Exceptions raised by a loader or the
    transform are re-raised at the consumer's next ``__next__``.

    ``transform(i, batch) -> batch`` (optional) runs in the stage
    thread right after the load, strictly serially in frame order; it
    must not touch consumer-thread state.

    ``workers`` defaults to min(4, cpu_count) like the reference's
    DataLoader; ``workers=1`` is one loader thread beside the stage
    thread. Loader lookahead is bounded to ``workers + depth``
    frames (a semaphore ticks once per consumed frame), so memory
    stays O(workers + depth) regardless of consumer speed.
    """

    def __init__(self, dataset, n_frames: Optional[int] = None,
                 depth: int = 2, start: int = 0, transform=None,
                 workers: Optional[int] = None):
        self.dataset = dataset
        total = len(dataset)
        self.total = total if n_frames is None else min(n_frames, total)
        self.start = min(max(int(start), 0), self.total)
        self.transform = transform
        if workers is None:
            workers = min(4, os.cpu_count() or 1)
        self.workers = max(1, int(workers))
        self.depth = max(depth, 1)
        self._q: queue.Queue = queue.Queue(maxsize=self.depth)
        self._threads: list = []
        self._started = False

    def __len__(self):
        return self.total

    # -- loader pool -> in-order stage thread

    def _loader(self):
        while True:
            self._budget.acquire()
            with self._idx_lock:
                i = self._next_idx
                if i >= self.total or self._failed:
                    self._budget.release()
                    return
                self._next_idx += 1
            try:
                batch = self.dataset[i]
            except BaseException as e:
                with self._loaded_cv:
                    self._loaded[i] = e
                    self._loaded_cv.notify_all()
                return
            with self._loaded_cv:
                self._loaded[i] = batch
                self._loaded_cv.notify_all()

    def _stage(self):
        try:
            for i in range(self.start, self.total):
                with self._loaded_cv:
                    while i not in self._loaded:
                        self._loaded_cv.wait()
                    batch = self._loaded.pop(i)
                if isinstance(batch, BaseException):
                    raise batch
                if self.transform is not None:
                    batch = self.transform(i, batch) or batch
                # self._q is bounded (depth): this put is the
                # backpressure point; the loader budget ticks once per
                # STAGED frame so loads stay <= workers+depth ahead.
                self._q.put((i, batch))
                self._budget.release()
            self._q.put(None)
        except BaseException as e:
            with self._idx_lock:
                self._failed = True
            # Unblock any loader waiting on budget so threads exit.
            for _ in range(self.workers):
                self._budget.release()
            self._q.put(e)

    def __iter__(self):
        if self._started:  # idempotent: `iter(it)` then `for .. in it`
            return self
        self._started = True
        self._idx_lock = threading.Lock()
        self._next_idx = self.start
        self._failed = False
        self._loaded: dict = {}
        self._loaded_cv = threading.Condition()
        # workers in flight + depth staged-but-unconsumed.
        self._budget = threading.Semaphore(self.workers + self.depth)
        self._threads = [
            threading.Thread(target=self._loader, daemon=True,
                             name=f"prefetch-load-{k}")
            for k in range(self.workers)]
        stage = threading.Thread(target=self._stage, daemon=True,
                                 name="prefetch-stage")
        for t in self._threads:
            t.start()
        stage.start()
        self._threads.append(stage)
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item
