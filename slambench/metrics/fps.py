"""fps: frames completed in the window over the window's seconds (host
clock; every frame and all the time of the window)."""


def read(run):
    return len(run.frames(True)) / run.window_s()
