"""The posterior draw kernel's share of its roofline on a bottleneck
ResNet: one byte written for each output code and each layer's mean and
std codes read once (25.50 M codes x (S + 2) bytes for the ResNet-50) at
3.35 TB/s, for each traced batch's draw, over the device time of
draw_kernel."""

from portbench import roofline, roofline_bottleneck


def read(trace):
    f = trace.extra
    t = trace.device_s(lambda n: "draw_kernel" in n)
    if t <= 0 or f.get("method") != "bbb" or "expansion" not in \
            f.get("architecture", {}):
        return None
    codes = roofline_bottleneck.stochastic_layer_codes(f["architecture"])
    return 100.0 * trace.units * roofline.draw_bound_s(codes,
                                                       f["samples"]) / t
