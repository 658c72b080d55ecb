"""setup_s: from the benchmark's start to the window's first frame: the
frames' cache, the program's load and kernel build, first-frame mapping
and the loop's frames before the window (host clock)."""


def read(run):
    return run.setup_s
