"""track_update_ms: the tracking step's pose update (the span
tracking.update: the best-pose selects, the Adam step and the early-stop
copy, summed over a call's iterations), the mean a frame of the window
before the traced stretch, in ms."""


def read(run):
    from slambench import phases

    return phases.tracking_ms(run, "tracking.update")
