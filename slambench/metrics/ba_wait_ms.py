"""ba_wait_ms: BA's wait on the card (the span mapping.wait: the
poses' readback), the mean a BA call of the window before the traced
stretch, in ms."""


def read(run):
    from slambench import phases

    return phases.ba_ms(run, "mapping.wait")
