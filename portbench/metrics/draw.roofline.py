"""The posterior draw kernel's share of its roofline: one byte written for
each output code and each layer's mean and std codes read once, at 3.35
TB/s (portbench/roofline.py), for each traced batch's draw, over the
device time of draw_kernel."""

from portbench import roofline


def read(trace):
    f = trace.extra
    t = trace.device_s(lambda n: "draw_kernel" in n)
    if t <= 0 or f["method"] != "bbb":
        return None
    codes = roofline.stochastic_layer_codes(f["architecture"])
    return 100.0 * trace.units * roofline.draw_bound_s(codes,
                                                       f["samples"]) / t
