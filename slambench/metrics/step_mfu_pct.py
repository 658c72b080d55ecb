"""step_mfu_pct: the operations of the window's tracking steps and BA
calls, counted from the configuration's shapes (yardstick: the encode
and the MLPs, forward and backward; the render's and the losses'
elementwise work is not counted), over the window's seconds outside the
traced stretch times the chip's float32 peak (the matrix products run in
float32 with TF32 off), in %."""


def read(run):
    from slambench import yardstick as Y

    cfg, spec = run.cfg, run.grid
    m = cfg["mapping"]["map_every"]
    flops, secs = 0, 0.0
    for k in run.frames():
        flops += Y.tracking_flops(cfg, spec)
        if k % m == 0:
            flops += Y.ba_flops(cfg, spec, Y.kf_count_at(cfg, k))
        secs += run.frame_s(k)
    if secs <= 0:
        return None
    return 100.0 * flops / (secs * Y.peaks()["fp32_flops_per_s"])
