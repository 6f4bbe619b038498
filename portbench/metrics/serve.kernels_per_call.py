"""Device kernels launched per served call in the trace's device phase
(every device operation but copies and sets)."""


def read(trace):
    if not trace.units:
        return None
    kernels = [n for n, _s, _e in trace.ops
               if not n.startswith(("Memcpy", "Memset"))]
    return len(kernels) / trace.units if kernels else None
