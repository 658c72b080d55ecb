"""loop_self_ms: the host loop's own time a frame (CoSLAM.run): the frame
wall less its tracking step and its BA, keyframe and periodic-mesh spans,
the mean over the window's frames before the traced stretch, in ms."""


def read(run):
    own = []
    for k in run.frames():
        spans = sum(b - a for a, b, tag in run.events_in(k)
                    if tag in ("ba", "keyframe", "mesh_eval"))
        own.append(run.frame_s(k) - run.track_s(k) - spans)
    return 1e3 * sum(own) / len(own) if own else None
