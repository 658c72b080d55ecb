"""launches_per_frame: every CUDA kernel in the traced stretch's device
trace over the stretch's frames."""


def read(run):
    st = run.stretch
    if st is None or not st["frames"]:
        return None
    return st["launches"] / st["frames"]
