"""track_graphed_pct: the share of the window's tracking calls before the
traced stretch that replayed the step's CUDA graph (the span
tracking.replay, summed by the tracking span: above 0 on a replayed
call, 0 on an eager one), in %."""


def read(run):
    vals = run.timings.get("tracking.replay")
    frames = run.frames()
    if not vals or not frames:
        return None
    return 100.0 * sum(vals[k - 1] > 0.0 for k in frames) / len(frames)
