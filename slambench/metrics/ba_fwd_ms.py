"""ba_fwd_ms: BA's forward (the span mapping.forward: the keyframe and
current-frame rays, the TV lattice, the draws, the poses and the loss,
summed over a call's iterations), the mean a BA call of the window
before the traced stretch, in ms."""


def read(run):
    from slambench import phases

    return phases.ba_ms(run, "mapping.forward")
