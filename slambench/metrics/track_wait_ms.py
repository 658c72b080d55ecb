"""track_wait_ms: the tracking step's wait on the card (the span
tracking.wait: the pose's readback), the mean a frame of the window
before the traced stretch, in ms."""


def read(run):
    from slambench import phases

    return phases.tracking_ms(run, "tracking.wait")
