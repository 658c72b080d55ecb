"""track_fwd_ms: the tracking step's forward (the span tracking.forward:
the draws, the pose, the forward and the loss, summed over a call's
iterations), the mean a frame of the window before the traced stretch,
in ms."""


def read(run):
    from slambench import phases

    return phases.tracking_ms(run, "tracking.forward")
