"""frame_block_ms: a BA frame's frame blocks (the spans frame_block:
the [H*W, 7] block concatenated and cast on the host and uploaded, for
BA and for the keyframe, summed over the frame), the mean over the BA
frames of the window before the traced stretch, in ms."""


def read(run):
    from slambench import phases

    return phases.frame_ms(run, "frame_block", run.ba_frames())
