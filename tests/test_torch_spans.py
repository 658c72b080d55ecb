"""The spans of the port's loop (coslam_torch/runtime/spans.py): the
recorder alone (a phase adds to its step's call, one entry a call, a
block that raises, the wait after each item, each thread's own stack
under a stress of threads, nothing kept that was not asked for), a small
sequential run on the CPU (every step's phases aligned with the step and
within its wall, one load wait and one frame-block sum a frame, the
spans' parents and frames, and frame_events and the frame-time report as
they were), the pipelined runtime's two threads, the profiler's ranges
(one a span, named and nested as the spans; none without a profiler),
and the trace reader of tools/profile_slice.py.

The recorder keeps no log of its spans; the tests that look at each span
build the loop with :class:`Probe`, the recorder with a log of its own.

Sizes: the 40 x 52 analytic scene of tests/test_torch_integration.py
with its 128-ray batches, 8 frames (BA and a keyframe at frame 5), 30
first-frame iterations; no tolerance: the checks are counts, names,
orders and inequalities of one run's own clock readings, or of a clock
the test moves by hand.
"""

import copy
import json
import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from coslam_torch.data import synth as TS
from coslam_torch.data.datasets import get_dataset
from coslam_torch.runtime import latency
from coslam_torch.runtime import slam as SLAM
from coslam_torch.runtime import spans as SP
from coslam_torch.runtime.pipeline import PipelinedCoSLAM
from coslam_torch.runtime.slam import CoSLAM
from coslam_torch.tools.profile_slice import range_stats

torch.set_num_threads(1)

STEPS = ("first_frame", "tracking", "mapping")
ROOT_TAGS = {"checkpoint", "ba", "keyframe", "mesh_eval", "throttle"}
N_FRAMES = 8


class Probe(SP.Spans):
    """The recorder, with a log of every span for the tests: at its exit,
    (name, the names open around it on its thread, outermost first, its
    thread, the load waits recorded before it began (the sequential
    loop's frame), its start, a clock reading after its exit)."""

    def __init__(self):
        super().__init__()
        self.log = []

    def span(self, name, **kwargs):
        return _Logged(self, super().span(name, **kwargs))


class _Logged:
    def __init__(self, probe, inner):
        self.probe, self.inner = probe, inner

    def __enter__(self):
        self.frame = len(self.probe.timings.get("load_wait", ()))
        self.inner.__enter__()
        self.around = tuple(s.name for s in self.probe._local.stack[:-1])
        return self

    def __exit__(self, *exc):
        out = self.inner.__exit__(*exc)
        self.probe.log.append((self.inner.name, self.around,
                               threading.get_ident(), self.frame,
                               self.inner.t0, time.perf_counter()))
        return out


def probed(cls, cfg):
    """A ``cls`` loop built with a :class:`Probe` as its recorder."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(SLAM, "Spans", Probe)
        slam = cls(cfg, get_dataset(cfg), device="cpu")
    assert isinstance(slam.spans, Probe)
    return slam


class Clock:
    """A perf_counter the test moves by hand."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now

    def advance(self, dt):
        self.now += dt


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(SP, "time", c)
    return c


# -- the recorder alone ------------------------------------------------------

def test_a_phase_adds_to_its_step_one_entry_a_call(clock):
    """Three calls of a step with 2, 0 and 3 iterations of a phase, each
    inside a span that does not sum it: one entry a call in the step's
    and the phase's lists, the phase's the sum of its spans' walls (0 for
    the call without one), within the step's wall; a phase outside any
    step that sums it adds nowhere."""
    sp = SP.Spans()
    for n in (2, 0, 3):
        with sp.span("step", timed=True, sums=("step.phase",)):
            clock.advance(10.0)
            for k in range(n):
                with sp.span("inner"):
                    clock.advance(0.5)
                    with sp.span("step.phase"):
                        clock.advance(k + 1.0)
    with sp.span("step.phase"):
        clock.advance(100.0)
    assert sp.timings == {"step": [14.0, 10.0, 17.5],
                          "step.phase": [3.0, 0.0, 6.0]}


def test_a_block_that_raises_records_its_span_and_event_only(clock):
    """The call did not finish: no timing and no sum, but its event; the
    thread's stack is left as it was, so the next span sums as before."""
    sp = SP.Spans()
    with pytest.raises(KeyError):
        with sp.span("step", timed=True, event=True, sums=("step.p",)):
            clock.advance(1.0)
            with sp.span("step.p"):
                clock.advance(2.0)
                raise KeyError("x")
    assert sp.timings == {}
    assert sp.events == [(0.0, 3.0, "step")]
    assert sp._local.stack == []
    with sp.span("after", timed=True, sums=("after.p",)):
        with sp.span("after.p"):
            clock.advance(4.0)
    assert sp.timings == {"after": [4.0], "after.p": [4.0]}


def test_each_after_times_the_wait_after_each_item(clock):
    """n items, n waits: entry k is the wait after item k (the last one
    the wait for the end), and the wait for the first item is not
    counted."""
    def items():
        for k in range(4):
            clock.advance(10.0 ** k)
            yield k
        clock.advance(7.0)

    sp = SP.Spans()
    got = []
    for k in sp.each_after("load_wait", items()):
        got.append(k)
    assert got == [0, 1, 2, 3]
    assert sp.timings == {"load_wait": [10.0, 100.0, 1000.0, 7.0]}
    assert list(sp.each_after("w", [])) == [] and "w" not in sp.timings


def test_threads_keep_their_own_parents_under_stress():
    """16 threads, each 300 steps of 2 phases, with the interpreter
    switching threads every microsecond: inside every span the thread's
    stack holds its own spans and no other thread's, every step has one
    sum a call, within its wall."""
    sp = SP.Spans()
    n_threads, n_steps = 16, 300
    old = sys.getswitchinterval()
    start = threading.Barrier(n_threads)
    wrong = []

    def stack():
        return [s.name for s in sp._local.stack]

    def work(t):
        start.wait()
        with sp.span(f"t{t}"):
            for _ in range(n_steps):
                with sp.span(f"s{t}", timed=True, sums=(f"s{t}.p",)):
                    for _ in range(2):
                        with sp.span(f"s{t}.p"):
                            if stack() != [f"t{t}", f"s{t}", f"s{t}.p"]:
                                wrong.append((t, stack()))
                    if stack() != [f"t{t}", f"s{t}"]:
                        wrong.append((t, stack()))
        if stack() != []:
            wrong.append((t, stack()))

    threads = [threading.Thread(target=work, args=(t,))
               for t in range(n_threads)]
    sys.setswitchinterval(1e-6)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert wrong == []
    for t in range(n_threads):
        walls, sums = sp.timings[f"s{t}"], sp.timings[f"s{t}.p"]
        assert len(walls) == len(sums) == n_steps
        assert all(0.0 < p <= w for w, p in zip(walls, sums))


def test_a_span_keeps_nothing_it_was_not_asked_to():
    """Spans that are neither timed, events nor summed into an open span
    leave the recorder as it was, however many run; a phase summed into
    its step adds one entry a call of the step, not one a span."""
    sp = SP.Spans()
    for _ in range(1000):
        with sp.span("plain"):
            with sp.span("plain.inner"):
                pass
    assert sp.timings == {} and sp.events == []
    with sp.span("step", sums=("step.p",)):
        for _ in range(1000):
            with sp.span("step.p"):
                pass
    assert list(sp.timings) == ["step.p"] and len(sp.timings["step.p"]) == 1
    assert sp._local.stack == []


def test_no_range_without_a_profiler(monkeypatch):
    """With no profiler recording, a span opens no record_function
    range."""
    def refuse(name):
        raise AssertionError(f"range {name} opened")

    monkeypatch.setattr(SP, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    sp = SP.Spans()
    with sp.span("a", timed=True, event=True, sums=("a.b",)):
        with sp.span("a.b"):
            pass
    assert set(sp.timings) == {"a", "a.b"} and len(sp.events) == 1


# -- a small run on the CPU --------------------------------------------------

@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_spans")
    datadir = str(d / "scene")
    cfg = TS.make_synthetic_config(datadir, str(d / "out"), H=40, W=52,
                                   n_frames=N_FRAMES)
    cfg["mapping"].update(first_iters=30, sample=128)
    cfg["tracking"]["sample"] = 128
    cfg["mesh"]["vis"] = 0
    cam = cfg["cam"]
    TS.write_replica_format(datadir, TS.AnalyticScene(),
                            TS.make_scan_trajectory(N_FRAMES),
                            cam["H"], cam["W"], cam["fx"], cam["fy"],
                            cam["cx"], cam["cy"])
    return cfg


@pytest.fixture(scope="module")
def run(scene):
    slam = probed(CoSLAM, scene)
    slam.run(verbose=False, eval_ate=False, mesh=False)
    return slam


def test_phases_align_with_their_steps_and_fit_in_them(run):
    """Each step's four phases have one entry a call, aligned with the
    step's, and sum to no more than the step's wall; the iterations'
    phases are spans of their own (``tracking.iter`` a tracking call)."""
    t = run.timings
    assert (len(t["first_frame"]), len(t["tracking"]),
            len(t["mapping"])) == (1, N_FRAMES - 1, 1)
    for step in STEPS:
        for phase in SP.phases(step):
            assert len(t[phase]) == len(t[step]), phase
        for k, wall in enumerate(t[step]):
            parts = [t[p][k] for p in SP.phases(step)]
            assert all(p > 0.0 for p in parts), (step, k, parts)
            assert sum(parts) <= wall, (step, k)
    n_iter = run.config["tracking"]["iter"]
    fwd = [r for r in run.spans.log if r[0] == "tracking.forward"]
    assert len(fwd) == n_iter * (N_FRAMES - 1)


def test_load_wait_and_frame_block_one_entry_a_frame(run):
    """One load wait and one frame-block sum a frame of the loop (the
    frame walls' count less the end); the frame blocks are built on
    frame 0 (first-frame mapping) and frame 5 (BA, then the keyframe:
    two blocks), none elsewhere."""
    t = run.timings
    assert len(run.frame_walls) == N_FRAMES + 1
    assert len(t["load_wait"]) == len(t["frame_block"]) == N_FRAMES
    built = [k for k, s in enumerate(t["frame_block"]) if s > 0.0]
    assert built == [0, 5]
    blocks = [r for r in run.spans.log if r[0] == "frame_block"]
    assert [r[3] for r in blocks] == [0, 5, 5]
    assert [r[1][-1] for r in blocks] == ["first_frame", "mapping",
                                          "keyframe"]
    assert t["frame_block"][5] <= blocks[2][5] - blocks[1][4]
    for k, wait in enumerate(t["load_wait"]):
        assert 0.0 <= wait <= run.frame_walls[k + 1] - run.frame_walls[k]


def test_spans_carry_their_parents_and_frames(run):
    """Each span's parent, the span open around it on its thread, is the
    one it belongs to: each phase's its step, each step's the loop's
    frame span (BA's the ``ba`` event); and each tracking span lies in
    its own frame."""
    want = {"tracking": "frame", "first_frame": "frame", "mapping": "ba",
            "ba": "frame", "keyframe": "frame", "frame": None,
            "load_wait": None}
    seen = set()
    for name, around, _, _, _, _ in run.spans.log:
        parent = around[-1] if around else None
        step = name.split(".")[0]
        if name in SP.phases(step):
            assert parent == step, name
            seen.add(name)
        elif name in want:
            assert parent == want[name], name
            seen.add(name)
    assert seen >= set(want) | set(SP.phases("tracking"))
    assert [r[3] for r in run.spans.log if r[0] == "tracking"] == list(
        range(1, N_FRAMES))
    assert [r[3] for r in run.spans.log if r[0] == "mapping"] == [5]
    assert len({r[2] for r in run.spans.log}) == 1


def test_frame_events_and_the_tail_report_keep_their_form(run):
    """frame_events holds (t0, t1, tag) 3-tuples of the loop's root tags
    only (none of the new spans), one an event span, in the order the
    spans closed, each from its span's start to its end; attribute_tails
    reads the same report from it as from a plain list of those
    spans."""
    ev = run.frame_events
    assert ev and all(isinstance(e, tuple) and len(e) == 3 for e in ev)
    assert {e[2] for e in ev} <= ROOT_TAGS
    assert {e[2] for e in ev} == {"ba", "keyframe"}
    logged = [r for r in run.spans.log if r[0] in ROOT_TAGS]
    assert [e[2] for e in ev] == [r[0] for r in logged]
    for (t0, t1, _), r in zip(ev, logged):
        assert t0 == r[4] and t0 < t1 <= r[5]
    plain = [(float(a), float(b), str(c)) for a, b, c in ev]
    assert (latency.attribute_tails(run.frame_walls, ev)
            == latency.attribute_tails(run.frame_walls, plain))


def test_print_timings_lists_phases_under_their_step(run, capsys):
    run.print_timings()
    lines = capsys.readouterr().out.splitlines()
    names = [ln.split(":")[0].replace("[timing] ", "") for ln in lines]
    i = names.index("tracking")
    assert names[i + 1:i + 5] == ["  forward", "  backward", "  update",
                                  "  wait"]
    assert "load_wait" in names and "frame_block" in names


def _innermost(ranges, r):
    """The innermost of ``ranges`` (lo, hi, name) that holds r, but r."""
    outer = [o for o in ranges if o is not r and o[0] <= r[0]
             and r[1] <= o[1]]
    return max(outer, key=lambda o: (o[0], -o[1]))[2] if outer else None


def test_profiler_ranges_are_the_spans(scene, tmp_path):
    """Under torch.profiler (CPU), a tracking call and a BA call leave
    one ``coslam.<name>`` range a span, with the span's name, and each
    range's innermost enclosing range is its span's parent."""
    slam = probed(CoSLAM, scene)
    data = slam.dataset
    slam.first_frame_mapping(data[0])
    before = len(slam.spans.log)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        slam.tracking_render(data[1], 1)
        slam.global_BA(data[1], 1)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = sorted((e["ts"], e["ts"] + e["dur"],
                     e["name"][len(SP.RANGE_PREFIX):]) for e in events
                    if e.get("cat") == "user_annotation"
                    and e["name"].startswith(SP.RANGE_PREFIX))
    recs = sorted(slam.spans.log[before:], key=lambda r: r[4])
    assert [r[2] for r in ranges] == [r[0] for r in recs]
    names = [r[0] for r in recs]
    assert names.count("tracking.forward") == scene["tracking"]["iter"]
    assert set(names) >= set(SP.phases("tracking")) | set(
        SP.phases("mapping")) | {"frame_block"}
    for rng, rec in zip(ranges, recs):
        assert _innermost(ranges, rng) == (rec[1][-1] if rec[1]
                                           else None), rec
    assert not torch.autograd._profiler_enabled()


# -- the pipelined runtime ---------------------------------------------------

def test_pipelined_threads_keep_their_own_parents(scene):
    """The tracker's and the mapper's spans interleave in one recorder,
    each thread on its own stack: the tracker's steps and load waits
    open on no other span, the mapper's BA inside its ``ba`` event, each
    phase inside its own step; no span has the other thread's open
    around it; one load wait a tracked frame and the phases aligned with
    their steps."""
    cfg = copy.deepcopy(scene)
    cfg["data"]["exp_name"] = "spans_pipe"
    slam = probed(PipelinedCoSLAM, cfg)
    slam.run(verbose=False, eval_ate=False, mesh=False)
    log = slam.spans.log
    tracker = {r[2] for r in log if r[0].startswith("tracking")}
    mapper = {r[2] for r in log if r[0].startswith(("mapping", "ba",
                                                     "first_frame"))}
    assert len(tracker) == len(mapper) == 1 and tracker != mapper
    mine = {"tracker": {"tracking", "load_wait", "throttle"},
            "mapper": {"first_frame", "ba", "mapping", "keyframe",
                       "frame_block", "checkpoint", "mesh_eval"}}
    for name, around, tid, _, _, _ in log:
        side = "tracker" if tid in tracker else "mapper"
        assert {n.split(".")[0] for n in around + (name,)} <= mine[side], \
            (name, around)
        parent = around[-1] if around else None
        step = name.split(".")[0]
        if name in SP.phases(step):
            assert parent == step, name
    want = {"tracking": None, "load_wait": None, "mapping": "ba",
            "ba": None, "first_frame": None}
    for name, around, _, _, _, _ in log:
        if name in want:
            assert (around[-1] if around else None) == want[name], name
    assert sum(r[0] == "mapping" for r in log) == 1
    assert sum(r[0] == "tracking" for r in log) == N_FRAMES - 1
    t = slam.timings
    assert len(t["load_wait"]) == N_FRAMES - 1
    for step in STEPS:
        for phase in SP.phases(step):
            assert len(t[phase]) == len(t[step]) >= 1


# -- the trace reader of tools/profile_slice.py ------------------------------

def _trace():
    """A step range [0, 100) holding phases [10, 40) and [50, 90) (the
    second holding a wait [80, 90)), launches at host times 5, 20, 60 and
    85, one launch with no host call, and a launch outside every range;
    device busy [0, 30), [45, 70) and [95, 120)."""
    def rng(name, ts, dur):
        return {"name": SP.RANGE_PREFIX + name, "cat": "user_annotation",
                "ts": ts, "dur": dur}

    ev = [rng("step", 0, 100), rng("step.forward", 10, 30),
          rng("step.backward", 50, 40), rng("step.wait", 80, 10),
          {"name": "other", "cat": "user_annotation", "ts": 0, "dur": 200}]
    for cid, ts in ((1, 5), (2, 20), (3, 60), (4, 85), (6, 150)):
        ev.append({"name": "cudaLaunchKernel", "cat": "cuda_runtime",
                   "ts": ts, "dur": 1, "args": {"correlation": cid}})
    for cid, (ts, dur) in zip((1, 2, 3, 5, 6), ((0, 30), (22, 8), (45, 25),
                                                (95, 25), (151, 1))):
        ev.append({"name": "k", "cat": "kernel", "ts": ts, "dur": dur,
                   "args": {"correlation": cid}})
    ev.append({"name": "k4", "cat": "kernel", "ts": 86, "dur": 2,
               "args": {"correlation": 4}})
    return ev


def test_range_stats_puts_launches_and_idle_under_the_innermost_range():
    got = range_stats(_trace())
    assert got["ranges"] == {"step": [1, 100.0], "step.forward": [1, 30.0],
                             "step.backward": [1, 40.0],
                             "step.wait": [1, 10.0]}
    assert got["launches"] == {"step": 1, "step.forward": 1,
                               "step.backward": 1, "step.wait": 1,
                               "none": 2}
    # Gaps within [0, 100): [30, 45) mid 37.5 (forward), [70, 86) mid 78
    # (backward), [88, 95) mid 91.5 (the step).
    assert got["idle_us"] == {"step.forward": 15.0, "step.backward": 16.0,
                              "step": 7.0}
    assert range_stats([e for e in _trace()
                        if e["cat"] != "user_annotation"]) == {}


def test_range_stats_puts_a_launch_under_its_own_threads_range():
    """Two threads' ranges overlap: a launch goes to the innermost range
    open on its own thread, and to the innermost on any thread only
    where its thread has none open (autograd's backward thread)."""
    def rng(name, ts, dur, tid):
        return {"name": SP.RANGE_PREFIX + name, "cat": "user_annotation",
                "ts": ts, "dur": dur, "tid": tid}

    ev = [rng("tracking", 0, 100, 1), rng("tracking.forward", 10, 80, 1),
          rng("mapping", 20, 60, 2)]
    for cid, ts, tid in ((1, 30, 1), (2, 40, 2), (3, 50, 9)):
        ev.append({"name": "cudaLaunchKernel", "cat": "cuda_runtime",
                   "ts": ts, "dur": 1, "tid": tid,
                   "args": {"correlation": cid}})
        ev.append({"name": "k", "cat": "kernel", "ts": ts + 1, "dur": 1,
                   "args": {"correlation": cid}})
    got = range_stats(ev)
    assert got["launches"] == {"tracking.forward": 1, "mapping": 2}
