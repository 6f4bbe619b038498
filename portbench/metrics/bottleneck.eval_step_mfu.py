"""The whole INT8 MC batch of a bottleneck ResNet as a share of the card's
int8 peak: the int8 operations of the forward's 53 convs and dense head
(2 x MACs, from shapes, portbench/roofline_bottleneck.py) for the batches
of the trace's device phase (the card alone profiled), over that phase's
wall time and 1,979 TOP/s."""

from portbench import roofline, roofline_bottleneck


def read(trace):
    f = trace.extra
    examples = sum(trace.unit_sizes)
    if not examples or trace.window_s <= 0 or "expansion" not in \
            f.get("architecture", {}):
        return None
    ops = roofline_bottleneck.int8_ops_per_example(
        f["architecture"], f["samples"]) * examples
    return 100.0 * ops / trace.window_s / roofline.INT8_OPS_PER_S
