"""The plain reference against small cases worked out by hand."""

import math
import struct

import numpy as np
import pytest
import torch

from portbench.reference import draw, float_resnet, int_resnet, msgpack

F32 = torch.float32


def t(v, dtype=F32):
    return torch.tensor(v, dtype=dtype)


def test_philox_known_answers():
    # Random123's kat_vectors for philox4x32-10
    zero = [torch.tensor([0], dtype=torch.int64)] * 4
    out = draw.philox(*zero, 0, 0)
    assert [int(w) for w in out] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C,
                                     0x9B00DBD8]
    ones = [torch.tensor([0xFFFFFFFF], dtype=torch.int64)] * 4
    out = draw.philox(*ones, 0xFFFFFFFF, 0xFFFFFFFF)
    assert [int(w) for w in out] == [0x408F276D, 0x41C83B0E, 0xA20BC7C6,
                                     0x6D5451FD]


def test_normals_follow_the_inverse_cdf():
    # uniforms u = 2 - (1 + k / 2^23): the median, and both tails
    k = torch.tensor([2 ** 22, 1, 2 ** 23 - 1], dtype=torch.int64)
    z = draw.normals(k << 9)
    assert abs(float(z[0])) < 1e-6
    assert float(z[1]) > 4.5 and float(z[2]) < -4.5
    bits = draw.random_bits(7, 11, 0, 1 << 16, "cpu")
    z = draw.normals(bits)
    assert abs(float(z.mean())) < 0.02 and abs(float(z.std()) - 1) < 0.02


def test_quantised_sample_by_hand():
    qp = {k: t(v) for k, v in dict(
        w_scale=0.5, w_zp=2.0, std_scale=0.25, std_zp=-128.0,
        mul_scale=0.125, mul_zp=0.0, add_scale=0.5, add_zp=1.0).items()}
    w = torch.tensor([[6]], dtype=torch.int8)          # w_f = 2.0
    std = torch.tensor([[-124]], dtype=torch.int8)     # std_f = 1.0
    eps = torch.full((1, 1, 1), 0.5)                   # eps_q = 21
    # prod = round(1.0 * 21 * 3/127 / 0.125) = round(3.969) = 4 -> 0.5;
    # w + prod = 2.5 -> round(5.0) + 1 = 6
    out = draw.quantised_sample(w, std, qp, eps, -128, 127)
    assert out.tolist() == [[[6]]]
    assert draw.quantised_sample(w, std, qp, eps, -4, 3).tolist() == [[[3]]]


def test_quantize_and_requant_round_half_to_even():
    q = int_resnet.quantize(t([0.5, 1.5, 2.5, -0.5]), t(1.0),
                            torch.tensor(3, dtype=torch.int32), 0, 127)
    assert q.tolist() == [0, 2, 2, 0]        # round(.5) = 0, round(2.5) = 2
    acc = t([2.5, -10.0, 300.0])
    r = int_resnet.requant(acc, None, t(1.0),
                           torch.tensor(5, dtype=torch.int32), True, 0, 127)
    # 2 + 5 = 7; ReLU keeps the zero point; 305 clips at 127
    assert r.tolist() == [2, 0, 122]


@pytest.mark.parametrize("cin", [4, 64])       # K = 36 and K = 576 > 520
def test_conv_is_the_exact_integer_conv(cin):
    g = torch.Generator().manual_seed(cin)
    x = torch.randint(-20, 20, (2, 5, 5, cin), generator=g,
                      dtype=torch.int8)
    w = torch.randint(-30, 30, (3, 3, cin, 3), generator=g,
                      dtype=torch.int8)
    zw = torch.tensor(-3, dtype=torch.int32)
    out = int_resnet.conv(x, t(1.0), w, t(1.0), zw, None, t(1.0),
                          torch.tensor(0, dtype=torch.int32), 1, 1, False,
                          (0, 127))
    # by hand: sum over the 3x3 window of x (zero padded) * (w - zw)
    xp = np.pad(x.numpy().astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    wc = w.numpy().astype(np.int64) + 3
    want = np.zeros((2, 5, 5, 3), np.int64)
    for i in range(5):
        for j in range(5):
            want[:, i, j] = np.einsum("bhwc,hwco->bo",
                                      xp[:, i:i + 3, j:j + 3], wc)
    assert np.array_equal(out.numpy(), np.clip(want, 0, 127))


def test_dropout_site_by_hand():
    q = {"mul_scale": t(0.25), "mul_zp": torch.tensor(2, dtype=torch.int32)}
    x = torch.tensor([[[[8, 8]]]], dtype=torch.int8)          # 2.0 each
    mask = torch.tensor([[[[1.0, 0.0]]]])
    codes, scale = int_resnet.site(x, t(0.25), q, mask, 0.2, (0, 127))
    # kept: 2.0 / 0.25 = 8 codes; dropped: 0; scale 0.25 / 0.8
    assert codes.tolist() == [[[[8, 0]]]]
    assert float(scale) == pytest.approx(0.3125)


def test_a_tiny_resnet_forward_by_hand():
    arch = {"widths": [1], "blocks": [1], "strides": [1],
            "input": [4, 4, 1], "classes": 2}
    one, zero = t(1.0), torch.tensor(0, dtype=torch.int32)

    def block(w):
        return {"q": {"w_codes": w, "w_scale": one, "w_zp": zero,
                      "bias_f": torch.zeros(1), "act_scale": one,
                      "act_zp": zero}}

    centre = torch.zeros((3, 3, 1, 1), dtype=torch.int8)
    centre[1, 1] = 1                                    # identity conv
    qc = {"input_quant": {"q": {"scale": one, "zp": zero}},
          "stem": block(centre),
          "stage0_block0": {"conv_bn_relu": block(centre),
                            "conv_bn": block(centre),
                            "add": {"q": {"scale": one, "zp": zero}}},
          "fc": {"q": {"w_codes": torch.tensor([[1, -1]], dtype=torch.int8),
                       "w_scale": one, "w_zp": zero, "act_scale": one,
                       "act_zp": torch.tensor(64, dtype=torch.int32)}}}
    x = torch.arange(16, dtype=F32).reshape(1, 4, 4, 1)

    def weights(path):
        q = qc
        for k in path:
            q = q[k]
        return q["q"]["w_codes"], one, zero

    logits = int_resnet.sample_logits(qc, x, arch, (0, 127), weights)
    # x + x after the block, the 4x4 mean of 2x = 15, logits (15, -15)
    # on the head's grid (zero point 64)
    assert logits.tolist() == [[15.0, -15.0]]


def test_msgpack_reads_flax_arrays(tmp_path):
    arr = np.arange(6, dtype=np.int8).reshape(2, 3)
    payload = (b"\x93" + b"\x92\x02\x03" + b"\xa4int8"
               + b"\xc4\x06" + arr.tobytes())
    blob = (b"\x82" + b"\xa1a" + b"\xc7" + bytes([len(payload)]) + b"\x01"
            + payload + b"\xa1b" + b"\xca" + struct.pack(">f", 1.5))
    path = tmp_path / "w.msgpack"
    path.write_bytes(blob)
    tree = msgpack.read_tree(str(path))
    assert np.array_equal(tree["a"], arr) and tree["b"] == 1.5


def test_kl_and_loss_by_hand():
    mu, sigma = t([0.1, -0.2]), t([0.05, 0.1])
    want = sum(0.5 * (2 * math.log(0.05 / s) - 1 + (s / 0.05) ** 2
                      + (m / 0.05) ** 2)
               for m, s in [(0.1, 0.05), (-0.2, 0.1)])
    assert float(float_resnet.kl_gauss(mu, sigma, 0.05)) == \
        pytest.approx(want, rel=1e-6)
    probs = t([[0.5, 0.5], [0.25, 0.75]])
    y = torch.tensor([0, 1])
    loss = float_resnet.loss_fn(probs, y, t(100.0), 0.01, 10)
    want = -(math.log(0.5 + 1e-8) + math.log(0.75 + 1e-8)) / 2 \
        + 0.01 * 100 / (2 * 10)
    assert loss == pytest.approx(want, rel=1e-6)


def test_softplus_and_init():
    assert float(float_resnet.softplus(t(-10.0))) == \
        pytest.approx(math.log1p(math.exp(-10)), rel=1e-6)
    arch = {"widths": [4, 8], "blocks": [1, 1], "strides": [1, 2],
            "input": [8, 8, 3], "classes": 2}
    g = torch.Generator().manual_seed(0)
    params, stats = float_resnet.init_state(
        arch, {"kernel_bound": 0.01, "std_conv": -10.0, "std_dense": -3.0},
        g, "cpu")
    paths = [p for p, _v in float_resnet.leaves(params)]
    assert ("stage1_block0", "shortcut", "kernel") in paths
    assert float(params["fc"]["std"][0, 0]) == -3.0
    k = params["stem"]["kernel"]
    assert k.shape == (3, 3, 3, 4) and float(k.abs().max()) <= 0.01
    assert float(stats["stem"]["var"].sum()) == 4.0
