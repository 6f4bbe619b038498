"""Device milliseconds per batch of the trace's host phase inside the
profiler ranges that the benchmark opens and closes around each
MC-Dropout site call (forward pre-hooks and hooks on every
BernoulliDropout module); a range's device time needs the host's
profile."""


def read(trace):
    t = trace.ranges.get("portbench.dropout_site", 0.0)
    if t <= 0 or not trace.host_units:
        return None
    return 1e3 * t / trace.host_units
