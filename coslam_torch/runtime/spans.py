"""Spans of the loop's work: one recorder for the steps' walls, their
phases, the loop's events and the profiler's ranges.

A span is a ``with`` block, ``spans.span(name)``. Each thread keeps its
own stack of open spans, so the pipelined tracker and mapper and the
mesh worker each sum into their own steps. As it is asked to, a span:

- ``timed``: appends its wall to ``timings[name]``, one entry a call;
- ``event``: appends ``(start, end, name)`` to :attr:`Spans.events`
  (the loop's ``frame_events``, read by runtime/latency.attribute_tails);
- ``sums``: sums the walls of the spans so named that run inside it
  on the same thread (each adds to the innermost open span of its
  recorder that sums it), and on its exit appends each sum, 0 where
  none ran, to ``timings[that name]``: one entry a call of this span,
  aligned with its own entries.

Code deep inside a step's forward, which is handed no recorder, opens a
phase of that step with :func:`in_forward` (the importance fine pass:
``<step>.fine``).

A block that raises records its event but no timing and no sum: the
call did not finish.

While torch.profiler records on the calling thread, each span also opens
a ``record_function`` range ``coslam.<name>``, so that the spans lie on
the trace's own clock, nested as they are, beside the kernels they
launch. Otherwise a span costs two clock reads and a few list
operations: no range, no lock, no device work and no synchronisation.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterable, List, Tuple

import torch
from torch.autograd.profiler import record_function

RANGE_PREFIX = "coslam."
STEP_PHASES = ("forward", "backward", "update", "wait")
# A mesh's phases (mesh/extract.py): the SDF's queries up to the volume's
# readback, marching cubes on the host, the vertex colors, the file.
MESH_PHASES = ("mesh.query", "mesh.mcubes", "mesh.color", "mesh.export")


def phases(step: str, fine: bool = False) -> Tuple[str, ...]:
    """The phase spans of a step: ``<step>.forward``, ``.backward``,
    ``.update`` and ``.wait``, then with ``fine`` (a model with an
    importance fine pass) ``<step>.fine``, which nests in the forward."""
    return tuple(f"{step}.{p}"
                 for p in STEP_PHASES + (("fine",) if fine else ()))


class Spans:
    """The recorder. ``timings``: name -> one wall (s) a call;
    ``events``: (start, end, tag) of the spans opened with ``event``
    (perf_counter seconds)."""

    # Each thread's stack of open spans, of every recorder.
    _local = threading.local()

    def __init__(self):
        self.timings: Dict[str, List[float]] = {}
        self.events: List[Tuple[float, float, str]] = []

    def span(self, name: str, timed: bool = False, event: bool = False,
             sums: Tuple[str, ...] = ()) -> "_Span":
        """A span of ``name`` (the module docstring)."""
        return _Span(self, name, timed, event, sums)

    def each_after(self, name: str, iterable: Iterable):
        """Yield ``iterable``'s items; each wait for the next item (and
        for its end) after the first one is a timed span ``name``: entry
        k is the wait that follows item k."""
        it = iter(iterable)
        end = object()
        item = next(it, end)
        while item is not end:
            yield item
            with self.span(name, timed=True):
                item = next(it, end)


class _Span:
    __slots__ = ("spans", "name", "timed", "event", "acc", "range", "t0")

    def __init__(self, spans: Spans, name: str, timed: bool, event: bool,
                 sums: Tuple[str, ...]):
        self.spans, self.name = spans, name
        self.timed, self.event = timed, event
        self.acc = dict.fromkeys(sums, 0.0) if sums else None

    def __enter__(self) -> "_Span":
        local = self.spans._local
        stack = getattr(local, "stack", None)
        if stack is None:
            stack = local.stack = []
        stack.append(self)
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = record_function(RANGE_PREFIX + self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        spans, name, t0 = self.spans, self.name, self.t0
        stack = spans._local.stack
        stack.pop()
        if self.event:
            spans.events.append((t0, t1, name))
        if exc_type is not None:
            return False
        timings = spans.timings
        if self.timed:
            timings.setdefault(name, []).append(t1 - t0)
        if self.acc is not None:
            for key, total in self.acc.items():
                timings.setdefault(key, []).append(total)
        for up in reversed(stack):
            if up.acc is not None and name in up.acc and up.spans is spans:
                up.acc[name] += t1 - t0
                break
        return False


def in_forward(phase: str):
    """A span ``<step>.<phase>`` where the span open innermost on this
    thread is a step's forward, ``<step>.forward``, on that span's
    recorder (the step's span sums it where it is asked to); elsewhere,
    as in a replayed graph's capture, a block that records nothing."""
    stack = getattr(Spans._local, "stack", None)
    if stack:
        top = stack[-1]
        step, _, name = top.name.rpartition(".")
        if name == "forward" and step:
            return top.spans.span(f"{step}.{phase}")
    return contextlib.nullcontext()


class _NoSpans:
    """The recorder of a step built without one: records nothing."""

    @staticmethod
    def span(*args, **kwargs):
        return contextlib.nullcontext()


NO_SPANS = _NoSpans()
