"""track_ms: the tracking step's wall (the loop's timings["tracking"],
which ends in the pose's readback), the mean over the window's frames
before the traced stretch, in ms."""


def read(run):
    ts = [run.track_s(k) for k in run.frames()]
    return 1e3 * sum(ts) / len(ts) if ts else None
