"""ba_ms.p95: the BA call's wall (the loop's timings["mapping"], which
ends in the poses' readback), the mean over the window's BA calls before
the traced stretch, in ms."""


def read(run):
    ts = [run.ba_s(k) for k in run.ba_frames()]
    return 1e3 * sum(ts) / len(ts) if ts else None
