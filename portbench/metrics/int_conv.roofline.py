"""The int8 conv kernel's share of its roofline: the least time of the
traced batches' convs (portbench/roofline.py: bytes bind; weights counted
once where every sample shares them) over the device time of the
kernel's launches (every body: int_conv_kernel, int_conv_halo_kernel,
int_conv_pixel_kernel)."""

from portbench import roofline


def read(trace):
    f = trace.extra
    t = trace.device_s(lambda n: "int_conv" in n and "_kernel" in n)
    if t <= 0 or not trace.unit_sizes:
        return None
    bound = sum(roofline.conv_bound_s(f["architecture"], b, f["samples"],
                                      f["method"] != "bbb")[0]
                for b in trace.unit_sizes)
    return 100.0 * bound / t
