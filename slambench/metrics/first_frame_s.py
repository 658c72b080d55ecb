"""first_frame_s: the first-frame mapping's four phases (the spans
first_frame.forward, .backward, .update, summed over its iterations, and
first_frame.wait, its loss's readback), summed: the set-up's mapping
of frame 0, in s."""


def read(run):
    vals = [run.timings.get(f"first_frame.{p}")
            for p in ("forward", "backward", "update", "wait")]
    if not all(vals):
        return None
    return sum(v[0] for v in vals)
