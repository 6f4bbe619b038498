"""The int8 conv kernel's share of its roofline on a bottleneck ResNet:
the least time of the traced batches' convs (portbench/
roofline_bottleneck.py: every conv's bytes and operations, the 16
epilogues' residual reads among them, the larger of the two bounds) over
the device time of the kernel's launches (every body: int_conv_kernel,
int_conv_halo_kernel, int_conv_pixel_kernel)."""

from portbench import roofline_bottleneck


def read(trace):
    f = trace.extra
    t = trace.device_s(lambda n: "int_conv" in n and "_kernel" in n)
    if t <= 0 or not trace.unit_sizes or "expansion" not in \
            f.get("architecture", {}):
        return None
    bound = sum(roofline_bottleneck.conv_bound_s(f["architecture"], b,
                                                 f["samples"])[0]
                for b in trace.unit_sizes)
    return 100.0 * bound / t
