"""The whole training step's share of the card's float32 peak: the float32
operations of the Bayes-by-backprop forward and backward as the local
reparametrisation formulates them (portbench/roofline.py) for the steps
of the trace's device phase (the card alone profiled), over that phase's
wall time and 67 TFLOP/s (the step runs without TF32)."""

from portbench import roofline


def read(trace):
    examples = sum(trace.unit_sizes)
    if not examples or trace.window_s <= 0:
        return None
    flops = roofline.train_flops_per_example(trace.extra["architecture"])
    return 100.0 * flops * examples / trace.window_s \
        / roofline.FP32_OPS_PER_S
