"""The port's posterior draw against qbn_tpu's XLA oracle.

Given the same float32 noise, `sample_weights_plain` must give bitwise the
codes of `sample_weights_oracle` (integers out of the same float32 chain:
no tolerance). The CUDA kernel runs only on the card (chip_smoke.py holds
it against the plain version there); here a numpy emulation of its
thread -> (layer, sample, element) mapping checks the pack layout, with
explicit noise and with its seeded counters and eps_q table.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from qbn_tpu.ops.pallas.sample_weights import sample_weights_oracle

from qbn_tpu_torch.ops import sample_weights as sw

QP_KEYS = sw.QPARAM_KEYS
CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "examples", "campaign", "bbb-cifar-a_7_w_8-seed1",
    "weights.msgpack")


def _random_qp(rng):
    f = np.float32
    return dict(w_scale=f(rng.uniform(5e-4, 5e-3)),
                w_zp=np.int32(rng.integers(-60, 60)),
                std_scale=f(rng.uniform(5e-5, 2e-3)),
                std_zp=np.int32(-128),
                mul_scale=f(rng.uniform(5e-4, 5e-3)),
                mul_zp=np.int32(rng.integers(-4, 4)),
                add_scale=f(rng.uniform(5e-4, 5e-3)),
                add_zp=np.int32(rng.integers(-20, 20)))


def _both(w, std, qp, noise, lo, hi):
    j = np.asarray(sample_weights_oracle(
        jnp.asarray(w), jnp.asarray(std), {k: jnp.asarray(v) for k, v in
                                           qp.items()},
        jnp.asarray(noise), lo, hi))
    t = sw.sample_weights_plain(
        torch.tensor(w), torch.tensor(std),
        {k: torch.tensor(v) for k, v in qp.items()},
        torch.from_numpy(noise), lo, hi).numpy()
    return j, t


@pytest.mark.parametrize("seed,m,n,lo,hi,noise_scale", [
    (0, 32, 128, -128, 127, 1.0),
    (1, 27, 24, -128, 127, 3.0),          # stem shape, noise past +-3 sigma
    (2, 64, 48, -8, 7, 2.0),              # sub-8-bit clamp
    (3, 9, 10, -2, 1, 1.0),
])
def test_plain_matches_oracle_bitwise(seed, m, n, lo, hi, noise_scale):
    rng = np.random.default_rng(seed)
    w = rng.integers(-128, 128, (m, n)).astype(np.int8)
    std = rng.integers(-128, 128, (m, n)).astype(np.int8)
    noise = (rng.standard_normal((4, m, n)) * noise_scale).astype(np.float32)
    qp = _random_qp(rng)
    j, t = _both(w, std, qp, noise, lo, hi)
    np.testing.assert_array_equal(t, j)
    assert t.dtype == np.int8 and t.min() >= lo and t.max() <= hi
    assert np.std(t.astype(np.float32), axis=0).mean() > 0


def test_plain_matches_oracle_on_flagship_layers():
    with open(CKPT, "rb") as fh:
        qconst = serialization.msgpack_restore(fh.read())["qconst"]
    rng = np.random.default_rng(7)
    n_layers = 0

    def walk(node):
        nonlocal n_layers
        if "w_codes" in node:
            shape = node["w_codes"].shape
            m, n = int(np.prod(shape[:-1])), shape[-1]
            noise = rng.standard_normal((2, m, n)).astype(np.float32)
            qp = {k: node[k] for k in QP_KEYS}
            j, t = _both(node["w_codes"].reshape(m, n),
                         node["std_codes"].reshape(m, n), qp, noise,
                         int(node["w_lo"]), int(node["w_hi"]))
            np.testing.assert_array_equal(t, j)
            n_layers += 1
            return
        for v in node.values():
            if isinstance(v, dict):
                walk(v)

    walk(qconst)
    assert n_layers == 21


def _layers(rng, shapes, device="cpu"):
    out = []
    for shape in shapes:
        qp = {k: torch.tensor(v) for k, v in _random_qp(rng).items()}
        out.append((torch.from_numpy(rng.integers(-128, 128, shape)
                                     .astype(np.int8)).to(device),
                    torch.from_numpy(rng.integers(-128, 128, shape)
                                     .astype(np.int8)).to(device),
                    qp, -128, 127))
    return out


SHAPES = [(3, 3, 3, 24), (1, 1, 5, 7), (192, 10), (2450, 500)]


def _kernel_outputs(pack):
    """The kernel's work, thread by thread, in numpy: tile t of _TILE
    items belongs to layer tile_layer[t], its thread x takes item
    (t - tile0) * _TILE + x; where n % 16 == 0 item sg * n/16 + j covers
    elements 16 j .. 16 j + 15 of samples 4 sg .. 4 sg + 3, else 16
    consecutive outputs of the (S, n) block. Returns per layer the block
    index e of every output written."""
    meta = pack.meta.numpy()
    tile_layer = pack.tile_layer.numpy()
    out = []
    for li, (tile0, items, _dst, _src, n, s, _lo, _hi) in enumerate(meta):
        tiles = np.nonzero(tile_layer == li)[0]
        assert (tiles == tile0 + np.arange(-(-items // sw._TILE))).all()
        item = (tiles[:, None] - tile0) * sw._TILE + np.arange(sw._TILE)
        item = item.reshape(-1)
        item = item[item < items]
        lane = np.arange(16)
        if n % 16 == 0:
            sg, j = np.divmod(item, n // 16)
            smp = sg[:, None] * sw._SAMPLES_PER_ITEM + np.arange(
                sw._SAMPLES_PER_ITEM)
            e = (smp[:, :, None] * n + 16 * j[:, None, None] + lane)
            e = e[np.broadcast_to(smp[:, :, None] < s, e.shape)]
        else:
            e = (16 * item[:, None] + lane).reshape(-1)
            e = e[e < s * n]
        out.append(e)
    return out


def _emulate_kernel(pack, noise=None, seed_offset=None):
    """The kernel's output buffer, from _kernel_outputs and the plain chain:
    with explicit noise read at dst + e, or seeded: the Philox bits of
    counter (e // 4, layer, offset) lane e % 4, eps_q through the table."""
    qtab = pack.qtab.numpy()
    w, std = pack.w.numpy(), pack.std.numpy()
    out = np.zeros(pack.total, np.int8)
    table = sw.icdf_table("cpu")
    for li, e in enumerate(_kernel_outputs(pack)):
        _t0, _it, dst, src, n, s, lo, hi = pack.meta[li].tolist()
        assert np.array_equal(np.sort(e), np.arange(s * n))   # once each
        if noise is not None:
            eps = torch.from_numpy(noise[li].reshape(-1).numpy()[e])
        else:
            seed, offset = seed_offset
            et = torch.from_numpy(e)
            words = sw.philox4x32(
                (et >> 2, li, offset & 0xFFFFFFFF, offset >> 32),
                (seed & 0xFFFFFFFF, seed >> 32))
            bits = torch.stack([torch.as_tensor(x).expand(et.shape)
                                for x in words], 1)
            bits = bits.gather(1, (et & 3)[:, None])[:, 0]
            eps = sw.lookup_eps_q(bits, table) * torch.tensor(
                sw.NOISE_SCALE, dtype=torch.float32)
        i = e % n
        qp = {key: torch.tensor(qtab[li, j]) for j, key in
              enumerate(QP_KEYS)}
        out[dst + e] = sw.sample_weights_plain(
            torch.from_numpy(w[src + i]), torch.from_numpy(std[src + i]), qp,
            eps, lo, hi).numpy()
    return out


def test_pack_layout_and_kernel_mapping():
    rng = np.random.default_rng(3)
    s = 3
    layers = _layers(rng, SHAPES)
    pack = sw.pack_layers(layers, s)
    assert all(d % 16 == 0 for d in pack.dst)
    assert pack.total % 16 == 0
    assert all(r[3] % 16 == 0 for r in pack.meta.tolist())   # code starts
    assert pack.tiles == len(pack.tile_layer)
    noise = [torch.from_numpy(rng.standard_normal((s,) + sh)
                              .astype(np.float32)) for sh in SHAPES]
    expect = [sw.sample_weights_plain(w, st, qp, e, lo, hi)
              for (w, st, qp, lo, hi), e in zip(layers, noise)]
    got = sw.draw_layers(pack, noise=noise)           # CPU: plain version
    emu = _emulate_kernel(pack, noise)
    for l_, (g, e, d) in enumerate(zip(got, expect, pack.dst)):
        assert g.shape == (s,) + SHAPES[l_] and g.dtype == torch.int8
        np.testing.assert_array_equal(g.numpy(), e.numpy())
        np.testing.assert_array_equal(
            emu[d:d + e.numel()].reshape(e.shape), e.numpy())
    # seeded: the kernel's counters and table give the CPU's codes
    gen = torch.Generator().manual_seed(12)
    emu = _emulate_kernel(pack,
                          seed_offset=sw.key_from_generator(gen).tolist())
    got = sw.draw_layers(pack, torch.Generator().manual_seed(12))
    for g, d in zip(got, pack.dst):
        np.testing.assert_array_equal(
            emu[d:d + g.numel()].reshape(g.shape), g.numpy())
    # the largest layer is over 1024 rows of 512 lanes, as in LeNet fc1
    assert -(-2450 * 500 // 512) > 1024


def test_single_layer_entry_and_launch_count_on_cpu():
    rng = np.random.default_rng(4)
    (w, std, qp, lo, hi), = _layers(rng, [(27, 24)])
    noise = torch.from_numpy(rng.standard_normal((5, 27, 24))
                             .astype(np.float32))
    before = sw.launches
    got = sw.sample_weights_int8(w, std, qp, 5, lo, hi, noise=noise)
    np.testing.assert_array_equal(
        got.numpy(), sw.sample_weights_plain(w, std, qp, noise, lo,
                                             hi).numpy())
    g1 = sw.sample_weights_int8(w, std, qp, 5, lo, hi,
                                generator=torch.Generator().manual_seed(1))
    g2 = sw.sample_weights_int8(w, std, qp, 5, lo, hi,
                                generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(g1.numpy(), g2.numpy())
    assert sw.launches == before          # the plain version is no launch


def test_entry_points_refuse_a_missing_card():
    """Asked for the card where there is none, the port raises instead of
    running on the CPU."""
    from qbn_tpu_torch.utils import resolve_device
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()
    assert resolve_device("cpu").type == "cpu"
