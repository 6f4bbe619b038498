"""aten calls on the host per training step of the trace's host phase
(every call, nested ones included, as torch.profiler records them)."""


def read(trace):
    if not trace.host_units or not trace.host_ops:
        return None
    return trace.host_ops / trace.host_units
