"""The port's seeded posterior draw against qbn_tpu's default transform.

qbn_tpu draws its seeded normals by the inverse CDF (`_fast_ndtri` of a
23-bit uniform, QBN_DRAW_ICDF on by default). The port computes the same
transform in float32 (`icdf_normals`) from Philox-4x32-10 bits, and its
CUDA kernel reads eps_q of that transform from a threshold table. These
tests hold the transform against qbn_tpu's (JAX on the CPU), the table
against the transform over every 23-bit input, the torch Philox against a
pure-Python one written from the algorithm's definition, and the CPU
seeded draw for determinism, pack-layout independence and its law.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qbn_tpu.ops.pallas.sample_weights import _cheap_neg_log, _fast_ndtri

from qbn_tpu_torch.ops import sample_weights as sw

NS = 3.0 / 127.0
# XLA on the CPU contracts some of the polynomials' multiply-adds, the port
# rounds each operation alone: the two normals may differ by a few ulps
# (5 seen), -ln by a few ulps of its value
X_ULPS = 8
X_TOL = 2e-6


def _ulps(x):
    return np.spacing(np.abs(x).astype(np.float32)).astype(np.float64)


def _bitcast(x, dtype):
    return jax.lax.bitcast_convert_type(x, dtype)


def _jax_icdf(k):
    """qbn_tpu's normal of the 23-bit uniforms k: _uniform12's f, then
    _fast_ndtri(2 - f)."""
    f = _bitcast(jnp.asarray(k.astype(np.uint32) | np.uint32(0x3F800000)),
                 jnp.float32)
    return np.asarray(jax.jit(lambda f: _fast_ndtri(2.0 - f, _bitcast))(f))


def _grid():
    """Every 8th of the 2^23 uniforms, the ends and both neighbours of the
    middle."""
    k = np.arange(0, 1 << 23, 8, dtype=np.int64)
    edges = np.array([1, 2, 3, (1 << 22) - 1, 1 << 22, (1 << 22) + 1,
                      (1 << 23) - 2, (1 << 23) - 1], dtype=np.int64)
    return np.concatenate([k, edges])


def test_icdf_transform_matches_qbn_tpu_on_a_dense_grid():
    k = _grid()
    want = _jax_icdf(k).astype(np.float64)
    got = sw.icdf_normals(torch.from_numpy(k << 9)).numpy().astype(
        np.float64)
    assert np.isfinite(got).all()
    tol = X_ULPS * _ulps(got)
    err = np.abs(got - want)
    assert (err <= tol).all(), (err / _ulps(got)).max()
    eq_want = np.clip(np.round(want.astype(np.float32)
                               * np.float32(1 / NS)), -128, 127)
    eq_got = sw.eps_q_of(torch.from_numpy(got.astype(np.float32))).numpy()
    # eps_q may differ only where the normal lies within tol of a bin
    # edge; such inputs are few (under 100 of the 1,048,584 here)
    z = got / NS
    near = np.abs(z - np.floor(z) - 0.5) * NS <= tol
    assert near.sum() <= 1000, near.sum()
    assert (eq_got[~near] == eq_want[~near]).all()
    assert (np.abs(eq_got - eq_want) <= 1).all()
    # the clamp: u = 1 (k = 0) and the smallest u give the int8 ends
    assert eq_got[0] == 127 and eq_got[-1] == -128


def test_cheap_neg_log_matches_qbn_tpu():
    rng = np.random.default_rng(0)
    v = np.concatenate([rng.uniform(2.0 ** -22, 1.0, 1 << 18),
                        2.0 ** -np.arange(0, 24)]).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: _cheap_neg_log(v, _bitcast))(
        jnp.asarray(v)))
    got = sw.cheap_neg_log(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=X_TOL)
    # and -ln itself to the reference's stated ~9e-4
    np.testing.assert_allclose(got, -np.log(v.astype(np.float64)), rtol=0,
                               atol=9e-4)


def test_threshold_table_gives_eps_q_at_every_uniform():
    """All 2^23 inputs: the kernel's table lookup equals eps_q of the
    plain transform (the table exists only because the transform is
    monotone, which its build checks)."""
    table = sw.icdf_table("cpu")
    assert table.shape == (1 << 14,) and table.dtype == torch.int32
    off = table >> 8
    assert bool(((off >= 1) & (off <= 512)).all())
    c0 = table & 255
    assert bool((torch.diff(c0) >= 0).all())
    g = torch.Generator().manual_seed(0)
    chunk = 1 << 20
    for k0 in range(0, 1 << 23, chunk):
        k = torch.arange(k0, k0 + chunk, dtype=torch.int64)
        low = torch.randint(0, 512, (chunk,), generator=g)   # ignored bits
        bits = (k << 9) | low
        want = sw.eps_q_of(sw.icdf_normals(bits))
        assert torch.equal(sw.lookup_eps_q(bits, table), want), k0


# -- Philox ---------------------------------------------------------------

def _philox_py(ctr, key, rounds=10):
    """Philox-4x32 from its definition (Salmon et al., SC'11; Random123's
    round order): counter (c0, c1, c2, c3) and key (k0, k1) become
    (hi(M1 c2) ^ c1 ^ k0, lo(M1 c2), hi(M0 c0) ^ c3 ^ k1, lo(M0 c0)), then
    the key is bumped by the Weyl constants; the 64-bit products are
    Python integers."""
    m0, m1 = 0xD2511F53, 0xCD9E8D57
    w0, w1 = 0x9E3779B9, 0xBB67AE85
    c = list(ctr)
    k = list(key)
    for _ in range(rounds):
        p0, p1 = m0 * c[0], m1 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & 0xFFFFFFFF,
             (p0 >> 32) ^ c[3] ^ k[1], p0 & 0xFFFFFFFF]
        k = [(k[0] + w0) & 0xFFFFFFFF, (k[1] + w1) & 0xFFFFFFFF]
    return c


# Random123's known-answer vectors for philox4x32_10
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    assert tuple(_philox_py(ctr, key)) == want
    got = sw.philox4x32(tuple(torch.tensor([c]) for c in ctr),
                        tuple(torch.tensor([v]) for v in key))
    assert tuple(int(w[0]) for w in got) == want


def test_philox_torch_matches_python_reference():
    rng = np.random.default_rng(1)
    ctrs = rng.integers(0, 1 << 32, (64, 4), dtype=np.uint64).astype(
        np.int64)
    ctrs[0] = 0xFFFFFFFF
    ctrs[1, :2] = 0xFFFFFFFF
    keys = rng.integers(0, 1 << 32, (64, 2), dtype=np.uint64).astype(
        np.int64)
    keys[0] = 0xFFFFFFFF
    keys[2] = 0
    got = sw.philox4x32(tuple(torch.from_numpy(ctrs[:, i]) for i in range(4)),
                        tuple(torch.from_numpy(keys[:, i]) for i in range(2)))
    got = torch.stack(got, 1).numpy()
    for i in range(64):
        assert list(got[i]) == _philox_py(ctrs[i].tolist(),
                                          keys[i].tolist()), i


def test_philox_bits_counter_layout():
    """Element e is lane e % 4 of call e // 4 with counter (e // 4, layer,
    offset low, offset high), key (seed low, seed high)."""
    seed, offset, layer = 0x123456789ABCDEF, 0xFEDCBA9876543, 5
    bits = sw.philox_bits(seed, offset, layer, 4 * 9 + 3)
    assert bits.shape == (39,) and bits.dtype == torch.int64
    for e in (0, 1, 7, 38):
        words = _philox_py((e // 4, layer, offset & 0xFFFFFFFF,
                            offset >> 32),
                           (seed & 0xFFFFFFFF, seed >> 32))
        assert int(bits[e]) == words[e % 4]


# -- the CPU seeded draw --------------------------------------------------

def _qp(rng):
    f = np.float32
    return {k: torch.tensor(v) for k, v in dict(
        w_scale=f(rng.uniform(5e-4, 5e-3)), w_zp=np.int32(-6),
        std_scale=f(rng.uniform(5e-5, 2e-3)), std_zp=np.int32(-128),
        mul_scale=f(rng.uniform(5e-4, 5e-3)), mul_zp=np.int32(0),
        add_scale=f(rng.uniform(5e-4, 5e-3)),
        add_zp=np.int32(rng.integers(-20, 20))).items()}


def _layer(rng, shape, lo=-128, hi=127):
    return (torch.from_numpy(rng.integers(-128, 128, shape).astype(np.int8)),
            torch.from_numpy(rng.integers(-128, 128, shape).astype(np.int8)),
            _qp(rng), lo, hi)


def _draw(layers, samples, seed):
    return sw.draw_layers(sw.pack_layers(layers, samples),
                          torch.Generator().manual_seed(seed))


def test_cpu_seeded_draw_is_the_plain_chain_on_icdf_normals():
    rng = np.random.default_rng(2)
    layers = [_layer(rng, (3, 3, 3, 24)), _layer(rng, (48, 10), -8, 7)]
    got = _draw(layers, 5, 11)
    seed, offset = sw.key_from_generator(
        torch.Generator().manual_seed(11)).tolist()
    for i, ((w, std, qp, lo, hi), g) in enumerate(zip(layers, got)):
        x = sw.seeded_noise(seed, offset, i, (5,) + tuple(w.shape))
        assert torch.equal(g, sw.sample_weights_plain(w, std, qp, x, lo, hi))
        assert int(g.min()) >= lo and int(g.max()) <= hi


def test_cpu_seeded_draw_deterministic_and_independent_of_pack_layout():
    rng = np.random.default_rng(3)
    a, b, c = (_layer(rng, sh) for sh in ((3, 3, 3, 24), (24, 48),
                                          (1, 1, 5, 7)))
    ab = _draw([a, b], 4, 7)
    assert all(torch.equal(x, y) for x, y in zip(ab, _draw([a, b], 4, 7)))
    # the same layer at the same index of another pack: other neighbours,
    # other output offsets, the same codes
    ac, cb = _draw([a, c], 4, 7), _draw([c, b], 4, 7)
    assert sw.pack_layers([c, b], 4).dst[1] != sw.pack_layers([a, b],
                                                               4).dst[1]
    assert torch.equal(ab[0], ac[0]) and torch.equal(ab[1], cb[1])
    # another seed, other codes
    assert not torch.equal(ab[1], _draw([a, b], 4, 8)[1])
    # a single-layer entry is the pack's layer 0
    w, std, qp, lo, hi = a
    one = sw.sample_weights_int8(w, std, qp, 4, lo, hi,
                                 generator=torch.Generator().manual_seed(7))
    assert torch.equal(one, ab[0])


def test_cpu_seeded_eps_histogram_follows_the_icdf_law():
    """10^6 seeded draws with unit qparams, where the code is eps_q: their
    histogram against the transform's exact law, TV within three times
    its expected sampling size 0.5 sqrt(2 K / N); and the law itself is
    the quantised normal's to within 0.001 TV (0.00015)."""
    n_el, samples = 10_000, 100
    unit = {"w_scale": 1.0, "w_zp": 0.0, "std_scale": 1.0, "std_zp": 0.0,
            "mul_scale": NS, "mul_zp": 0.0, "add_scale": NS, "add_zp": 0.0}
    unit = {k: torch.tensor(v, dtype=torch.float32) for k, v in unit.items()}
    codes = sw.sample_weights_int8(
        torch.zeros(n_el, dtype=torch.int8), torch.ones(n_el,
                                                        dtype=torch.int8),
        unit, samples, -128, 127, generator=torch.Generator().manual_seed(5))
    n = codes.numel()
    h = torch.bincount(codes.reshape(-1).to(torch.int64) + 128,
                       minlength=256).double() / n
    p = sw.eps_q_law()
    assert abs(float(p.sum()) - 1) < 1e-12
    k = int((p > 0).sum())
    tv = 0.5 * float((h - p).abs().sum())
    assert tv <= 3 * 0.5 * math.sqrt(2 * k / n), tv
    ks = torch.arange(-128, 128, dtype=torch.float64)
    cdf = lambda z: 0.5 * (1 + torch.erf(z / math.sqrt(2)))  # noqa: E731
    hi = torch.where(ks == 127, torch.tensor(math.inf, dtype=torch.float64),
                     (ks + 0.5) * NS)
    lo = torch.where(ks == -128, torch.tensor(-math.inf,
                                              dtype=torch.float64),
                     (ks - 0.5) * NS)
    gauss = cdf(hi) - cdf(lo)
    assert 0.5 * float((p - gauss).abs().sum()) < 0.001
