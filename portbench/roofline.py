"""Operations and bytes of the port's kernels and steps, from shapes, and
the peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at
the full 700 W limit).

Each bound counts each input byte read once and each output byte written
once, and each multiply-accumulate as two operations, whatever the
kernel reads again; a roofline share is the bound's time over the
kernel's measured device time, so it cannot pass 100% unless the time
leaves out part of the work.
"""

from __future__ import annotations

from typing import List, NamedTuple

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP32_OPS_PER_S = 67e12


class Conv(NamedTuple):
    name: str
    cin: int
    cout: int
    k: int
    stride: int
    hw: int             # input height and width
    stem: bool          # the input is the image (one per example)


def resnet_convs(arch) -> List[Conv]:
    """The convs of a CIFAR ResNet's forward, in order: the stem, then
    each basic block's two 3x3 convs and its 1x1 shortcut where the block
    changes shape."""
    widths, hw = arch["widths"], arch["input"][0]
    out = [Conv("stem", arch["input"][2], widths[0], 3, 1, hw, True)]
    cin = widths[0]
    for s, (planes, n, stride) in enumerate(zip(widths, arch["blocks"],
                                                 arch["strides"])):
        for b in range(n):
            st = stride if b == 0 else 1
            name = f"stage{s}_block{b}"
            out.append(Conv(f"{name}.conv_bn_relu", cin, planes, 3, st, hw,
                            False))
            ho = (hw + 2 - 3) // st + 1
            out.append(Conv(f"{name}.conv_bn", planes, planes, 3, 1, ho,
                            False))
            if st != 1 or cin != planes:
                out.append(Conv(f"{name}.shortcut", cin, planes, 1, st, hw,
                                False))
            cin, hw = planes, ho
    return out


def out_hw(c: Conv) -> int:
    pad = c.k // 2
    return (c.hw + 2 * pad - c.k) // c.stride + 1


def rows_read(c: Conv) -> int:
    """How many of the input's rows (or columns) the conv reads: all of
    them unless the kernel is narrower than its stride (the 1x1/2
    shortcuts read every second row)."""
    pad, ho = c.k // 2, out_hw(c)
    return len({o * c.stride + i - pad for o in range(ho)
                for i in range(c.k)} & set(range(c.hw)))


def conv_work(c: Conv, batch: int, samples: int, shared_weights: bool):
    """(bytes, operations) of one int8 conv with its requant epilogue.

    Bayes-by-backprop (shared_weights False): S weight samples; the stem
    reads the image once for all of them. Shared weights (MC-Dropout):
    one set of weights; the stem runs once (the samples part at the
    first dropout site)."""
    s_x = 1 if c.stem else samples
    s_out = 1 if (c.stem and shared_weights) else samples
    s_w = 1 if shared_weights else samples
    ho, read = out_hw(c), rows_read(c)
    nbytes = (s_x * batch * read * read * c.cin
              + s_w * c.k * c.k * c.cin * c.cout
              + s_out * batch * ho * ho * c.cout + 4 * c.cout)
    ops = 2 * s_out * batch * ho * ho * c.k * c.k * c.cin * c.cout
    return nbytes, ops


def conv_bound_s(arch, batch: int, samples: int, shared_weights: bool):
    """The least seconds of a forward's convs: the larger of all their
    bytes over the HBM bandwidth and all their operations over the int8
    peak (bytes bind at the ResNet-18's shapes). Returns (seconds,
    'bytes' or 'operations')."""
    nbytes = ops = 0
    for c in resnet_convs(arch):
        b, o = conv_work(c, batch, samples, shared_weights)
        nbytes, ops = nbytes + b, ops + o
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def draw_bound_s(layer_codes: List[int], samples: int) -> float:
    """The least seconds of the posterior draw, bound by bytes: one byte
    written for each output code, and each layer's mean and std codes read
    once, at the HBM bandwidth. layer_codes: each stochastic layer's
    number of weights."""
    n = sum(layer_codes)
    return (samples * n + 2 * n) / HBM_BYTES_PER_S


def stochastic_layer_codes(arch) -> List[int]:
    """The weights of every Bayes-by-backprop layer: the convs and the
    dense head."""
    convs = [c.k * c.k * c.cin * c.cout for c in resnet_convs(arch)]
    return convs + [arch["widths"][-1] * arch["classes"]]


def int8_ops_per_example(arch, samples: int, shared_weights: bool) -> int:
    """The int8 operations of one example's INT MC forward: the convs
    and the dense head, 2 x MACs."""
    ops = sum(conv_work(c, 1, samples, shared_weights)[1]
              for c in resnet_convs(arch))
    return ops + 2 * samples * arch["widths"][-1] * arch["classes"]


def train_flops_per_example(arch) -> int:
    """Float32 operations of one example of a Bayes-by-backprop training
    step as the local reparametrisation formulates it: each conv and the
    dense head compute a mean (x w) and a variance (x^2 sigma^2) product
    forward; backward, each product's weight gradient, and its input
    gradient except at the stem (the image needs none); 2 x MACs each."""
    total = 0
    for c in resnet_convs(arch):
        macs = out_hw(c) ** 2 * c.k * c.k * c.cin * c.cout
        products = 2 * (2 if c.stem else 3)
        total += products * 2 * macs
    dense = arch["widths"][-1] * arch["classes"]
    return total + 2 * 3 * 2 * dense
