"""The port's quantisation bound tables and noise contract equal
qbn_tpu's exactly (integers and one float constant: no tolerance)."""

import pytest

from qbn_tpu.models.layers import QuantConfig as JQuantConfig
from qbn_tpu.quant import bounds as jb

from qbn_tpu_torch.config import QuantConfig
from qbn_tpu_torch.quant import bounds as tb


def test_tables_equal():
    assert tb.UINT_BOUNDS == jb.UINT_BOUNDS
    assert tb.INT_BOUNDS == jb.INT_BOUNDS


def test_noise_contract_equal():
    assert tb.NOISE_SCALE == jb.NOISE_SCALE
    assert tb.NOISE_ZERO_POINT == jb.NOISE_ZERO_POINT == 0


@pytest.mark.parametrize("bits", range(2, 9))
def test_bound_functions_equal(bits):
    assert tb.uint_bounds(bits) == jb.uint_bounds(bits)
    assert tb.int_bounds(bits) == jb.int_bounds(bits)


@pytest.mark.parametrize("a_bits,w_bits", [(7, 8), (4, 4), (2, 2)])
def test_quant_config_bounds_equal(a_bits, w_bits):
    t = QuantConfig(a_bits=a_bits, w_bits=w_bits)
    j = JQuantConfig(enabled=True, a_bits=a_bits, w_bits=w_bits)
    assert t.a_bounds == j.a_bounds and t.w_bounds == j.w_bounds
