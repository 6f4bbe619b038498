"""Operations and bytes of a bottleneck ResNet's INT8 Monte-Carlo forward
(the ImageNet ResNet-50), from the configuration's shapes, on the peaks
and the counting rules of portbench/roofline.py: each input byte read
once, each output byte written once, each weight sample's bytes once,
each multiply-accumulate two operations. The last 1x1 conv of every
block runs the residual add in its epilogue and reads the residual's
codes once besides.
"""

from __future__ import annotations

from typing import List, NamedTuple

from portbench import roofline
from portbench.roofline import Conv, out_hw


class BConv(NamedTuple):
    conv: Conv
    residual: bool          # the block's add runs in this conv's epilogue


def bottleneck_convs(arch) -> List[BConv]:
    """The convs of the forward, in order: the stem, then each block's
    conv_0 (1x1), conv_1 (3x3, the stage's stride on the first block),
    conv_2 (1x1, with the residual) and the shortcut (a strided 1x1)
    where the block changes shape."""
    k, st, _pad = arch["stem"]
    stem = Conv("stem", arch["input"][2], arch["widths"][0], k, st,
                arch["input"][0], True)
    out = [BConv(stem, False)]
    win, pst, ppad = arch["stem_pool"]
    hw = (out_hw(stem) + 2 * ppad - win) // pst + 1
    cin, e = arch["widths"][0], arch["expansion"]
    for s, (planes, n, stride) in enumerate(zip(arch["widths"],
                                                 arch["blocks"],
                                                 arch["strides"])):
        for b in range(n):
            st = stride if b == 0 else 1
            name = f"stage{s}_block{b}"
            ho = (hw - 1) // st + 1
            out += [BConv(Conv(f"{name}.conv_0", cin, planes, 1, 1, hw,
                               False), False),
                    BConv(Conv(f"{name}.conv_1", planes, planes, 3, st, hw,
                               False), False),
                    BConv(Conv(f"{name}.conv_2", planes, planes * e, 1, 1,
                               ho, False), True)]
            if st != 1 or cin != planes * e:
                out.append(BConv(Conv(f"{name}.shortcut", cin, planes * e,
                                      1, st, hw, False), False))
            cin, hw = planes * e, ho
    return out


def conv_work(c: BConv, batch: int, samples: int):
    """(bytes, operations) of one conv launch with per-sample weights, its
    requant epilogue and its residual read."""
    nbytes, ops = roofline.conv_work(c.conv, batch, samples, False)
    if c.residual:
        nbytes += samples * batch * out_hw(c.conv) ** 2 * c.conv.cout
    return nbytes, ops


def conv_bound_s(arch, batch: int, samples: int):
    """The least seconds of a forward's convs: the larger of all their
    bytes over the HBM bandwidth and all their operations over the int8
    peak. Returns (seconds, 'bytes' or 'operations')."""
    nbytes = ops = 0
    for c in bottleneck_convs(arch):
        b, o = conv_work(c, batch, samples)
        nbytes, ops = nbytes + b, ops + o
    t_bytes = nbytes / roofline.HBM_BYTES_PER_S
    t_ops = ops / roofline.INT8_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stochastic_layer_codes(arch) -> List[int]:
    """The weights of every Bayes-by-backprop layer: the convs and the
    dense head."""
    convs = [c.conv.k ** 2 * c.conv.cin * c.conv.cout
             for c in bottleneck_convs(arch)]
    return convs + [arch["widths"][-1] * arch["expansion"] * arch["classes"]]


def int8_ops_per_example(arch, samples: int) -> int:
    """The int8 operations of one example's INT MC forward: the convs and
    the dense head, 2 x MACs."""
    ops = sum(conv_work(c, 1, samples)[1] for c in bottleneck_convs(arch))
    head = arch["widths"][-1] * arch["expansion"] * arch["classes"]
    return ops + 2 * samples * head
