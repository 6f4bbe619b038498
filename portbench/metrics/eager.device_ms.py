"""Device milliseconds per traced batch of every operation that is not one
of the port's hand-written kernels: the INT layers' eager PyTorch passes
(input quant, dropout multiplies, residual adds, pool, dense head,
softmax, the mean), copies and sets."""

from portbench.tracing import is_port_kernel


def read(trace):
    if not trace.ops or not trace.units:
        return None
    return 1e3 * trace.device_s(lambda n: not is_port_kernel(n)) \
        / trace.units
