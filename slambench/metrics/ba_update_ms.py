"""ba_update_ms: BA's map and pose update (the span mapping.update:
the map's and the poses' optimizer steps, summed over a call's
iterations), the mean a BA call of the window before the traced
stretch, in ms."""


def read(run):
    from slambench import phases

    return phases.ba_ms(run, "mapping.update")
