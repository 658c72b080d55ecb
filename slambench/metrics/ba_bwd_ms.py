"""ba_bwd_ms: BA's backward (the span mapping.backward, summed over a
call's iterations), the mean a BA call of the window before the traced
stretch, in ms."""


def read(run):
    from slambench import phases

    return phases.ba_ms(run, "mapping.backward")
