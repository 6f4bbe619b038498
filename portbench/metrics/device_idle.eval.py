"""The share of the traced INT8 evaluation window in which no operation
ran on the device, over the trace's device phase (the card alone
profiled): 1 - (union of the device operations' intervals / the
phase's wall time)."""


def read(trace):
    if not trace.ops or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
