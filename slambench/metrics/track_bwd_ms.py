"""track_bwd_ms: the tracking step's backward (the span
tracking.backward: zero_grad and the backward, summed over a call's
iterations), the mean a frame of the window before the traced stretch,
in ms."""


def read(run):
    from slambench import phases

    return phases.tracking_ms(run, "tracking.backward")
