"""frame_ms_p95: the 95th percentile of the window's frame walls (host
clock, the loop's frame_walls), in ms."""


def read(run):
    from slambench.harness import p95

    return 1e3 * p95([run.frame_s(k) for k in run.frames(True)])
