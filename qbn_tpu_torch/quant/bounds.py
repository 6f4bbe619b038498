"""Integer bound tables for sub-8-bit quantisation (port of
qbn_tpu/quant/bounds.py).

Activations are quantised to unsigned ranges [0, 2^a - 1] for a in 2..8,
weights to signed ranges [-2^(w-1), 2^(w-1) - 1] for w in 2..8.
"""

UINT_BOUNDS = {
    8: (0, 255),
    7: (0, 127),
    6: (0, 63),
    5: (0, 31),
    4: (0, 15),
    3: (0, 7),
    2: (0, 3),
}

INT_BOUNDS = {
    8: (-128, 127),
    7: (-64, 63),
    6: (-32, 31),
    5: (-16, 15),
    4: (-8, 7),
    3: (-4, 3),
    2: (-2, 1),
}


def uint_bounds(bits: int):
    """Unsigned (activation) quantisation bounds for a given bit width."""
    return UINT_BOUNDS[bits]


def int_bounds(bits: int):
    """Signed (weight) quantisation bounds for a given bit width."""
    return INT_BOUNDS[bits]


# Noise quantisation contract for converted-int inference: posterior noise is
# drawn in fp32 and quantised to int8 with a fixed scale of 3/127 (so the
# representable range is +-3 sigma) and zero point 0.
NOISE_SCALE = 0.02362204724409449  # 3 / 127
NOISE_ZERO_POINT = 0
