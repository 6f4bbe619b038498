"""portbench/roofline.py against chip_smoke.py's arithmetic at the
flagship's shapes (B=256, S=100: 3.463 ms, 3.230 ms with shared
weights), and the counts the per-layer metrics divide by."""

import pytest

from portbench import roofline

ARCH = {"widths": [24, 48, 96, 192], "blocks": [2, 2, 2, 2],
        "strides": [1, 2, 2, 2], "input": [32, 32, 3], "classes": 10}


def test_twenty_convs():
    convs = roofline.resnet_convs(ARCH)
    assert len(convs) == 20
    assert sum(c.k == 3 and not c.stem for c in convs) == 16


@pytest.mark.parametrize("shared, ms", [(False, 3.463), (True, 3.230)])
def test_conv_bound_as_chip_smoke(shared, ms):
    t, by = roofline.conv_bound_s(ARCH, 256, 100, shared)
    assert by == "bytes"
    assert round(1e3 * t, 3) == ms


def test_draw_bound_counts_bytes():
    codes = roofline.stochastic_layer_codes(ARCH)
    assert sum(codes) == 1_571_592         # 157,159,200 codes at S=100
    t = roofline.draw_bound_s(codes, 20)
    assert t == pytest.approx((20 + 2) * 1_571_592 / 3.35e12)


def test_rows_read_of_a_strided_shortcut():
    sc = roofline.Conv("sc", 24, 48, 1, 2, 32, False)
    assert roofline.rows_read(sc) == 16
    assert roofline.out_hw(sc) == 16


def test_operation_counts():
    # the stem of an MC-Dropout forward runs once for all samples
    bbb = roofline.int8_ops_per_example(ARCH, 20, False)
    mcd = roofline.int8_ops_per_example(ARCH, 20, True)
    stem = 2 * 32 * 32 * 9 * 3 * 24
    assert bbb - mcd == 19 * stem
    # about 241 GFLOP a step of 256 (78.5 M MACs an image, two products,
    # forward and backward)
    assert roofline.train_flops_per_example(ARCH) * 256 == \
        pytest.approx(240.54e9, rel=1e-4)
