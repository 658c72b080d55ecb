"""ba_fine_ms: BA's importance fine pass (the span mapping.fine, inside
mapping.forward: the draw's inversion through sample_pdf, the fine
query and the merge, summed over a call's iterations), the mean a BA
call of the window before the traced stretch, in ms. None where the
program has no such span (a coarse-only recipe, or a program without
it)."""


def read(run):
    from slambench import phases

    return phases.ba_ms(run, "mapping.fine")
