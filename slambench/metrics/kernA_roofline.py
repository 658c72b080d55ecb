"""kernA_roofline: kernel A's share of its roofline over the traced stretch
(yardstick.encode_roofline), in %."""


def read(run):
    from slambench import yardstick

    return yardstick.encode_roofline(run, "fwd")
