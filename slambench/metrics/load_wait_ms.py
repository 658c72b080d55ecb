"""load_wait_ms: the loop's wait for the next frame from the prefetcher
(the span load_wait: the wait that ends a frame's wall), the mean a
frame of the window before the traced stretch, in ms."""


def read(run):
    from slambench import phases

    return phases.frame_ms(run, "load_wait", run.frames())
