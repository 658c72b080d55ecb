"""device_idle_pct: 100 - the union of device intervals (kernels, copies,
fills) over the traced stretch's wall, in %."""


def read(run):
    st = run.stretch
    if st is None or st["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - st["busy_s"] / st["window_s"])
