"""The port's pure-Python msgpack reader against flax's.

Leaf for leaf, the flagship checkpoint decodes to bitwise the same arrays
(same dtype, shape and bytes) as flax.serialization.msgpack_restore, and
a synthetic blob holding every msgpack type the reader claims decodes to
what the msgpack package returns. No tolerance: decoding is exact."""

import os

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from qbn_tpu.training.checkpoint import _merge as j_merge

from qbn_tpu_torch.convert import from_jax_state
from qbn_tpu_torch.training.checkpoint import (
    load_variables, merge, msgpack_restore, read_checkpoint, unpackb)

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "examples", "campaign", "bbb-cifar-a_7_w_8-seed1",
    "weights.msgpack")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.fixture(scope="module")
def both():
    with open(CKPT, "rb") as fh:
        blob = fh.read()
    return read_checkpoint(CKPT), serialization.msgpack_restore(blob)


def test_flagship_leaves_bitwise(both):
    ours, flax_tree = both
    a, b = dict(_leaves(ours)), dict(_leaves(flax_tree))
    assert a.keys() == b.keys()
    assert set(ours) == {"batch_stats", "kl", "params", "qconst", "quant"}
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def test_flagship_weight_count(both):
    ours, _ = both
    n = sum(np.asarray(v).size for p, v in _leaves(ours["qconst"])
            if p[-1] == "w_codes")
    assert n == 1571592


def test_every_msgpack_type():
    arr = np.arange(12, dtype=np.int32).reshape(3, 4)
    obj = {
        "fixint": 7, "negfix": -5, "u8": 200, "u16": 60000, "u32": 2 ** 31,
        "u64": 2 ** 40, "i8": -100, "i16": -30000, "i32": -2 ** 20,
        "i64": -2 ** 40, "f64": 1.25, "nil": None, "t": True, "f": False,
        "str": "x" * 40, "long": "y" * 300, "bin": b"\x00\x01" * 200,
        "list": list(range(20)), "nested": {str(i): i for i in range(20)},
        "arr": arr, "scalar": np.float32(2.5), "c": complex(1.0, -2.0),
        "bf": np.ones((2,), np.float16),
    }
    blob = serialization.msgpack_serialize(obj)
    got = msgpack_restore(blob)
    want = serialization.msgpack_restore(blob)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k] and type(got[k]) == type(want[k]), k
    f32 = msgpack.packb(np.float32(0.1).item(), use_single_float=True)
    assert unpackb(f32) == msgpack.unpackb(f32)


def test_chunked_array_joins():
    arr = np.arange(10, dtype=np.float32)
    tree = {"a": {"__msgpack_chunked_array__": True,
                  "shape": {"0": 10},
                  "chunks": {"0": arr[:6], "1": arr[6:]}}}
    blob = msgpack.packb(tree, default=serialization._msgpack_ext_pack)
    np.testing.assert_array_equal(msgpack_restore(blob)["a"], arr)
    np.testing.assert_array_equal(serialization.msgpack_restore(blob)["a"],
                                  arr)


def test_truncated_blob_raises():
    blob = serialization.msgpack_serialize({"a": np.ones(4, np.float32)})
    with pytest.raises(ValueError):
        unpackb(blob[:-3])


def test_merge_matches_qbn_tpu():
    target = {"q": {"a": np.zeros((2, 2), np.float32),
                    "b": np.zeros((3,), np.int32), "keep": np.ones(2)},
              "only_target": np.zeros(1, np.int8)}
    restored = {"q": {"a": np.full((2, 2), 3.0, np.float64),
                      "b": np.zeros((4,), np.int32)},
                "extra": np.ones(5)}
    ours, theirs = merge(target, restored), j_merge(target, restored)
    a, b = dict(_leaves(ours)), dict(_leaves(theirs))
    assert a.keys() == b.keys()
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_load_variables_intersects(both):
    ours, _ = both
    target = {"qconst": {"stem": {"q": {"act_zp": np.zeros((), np.int32),
                                        "w_codes": np.zeros((1,), np.int8)}}}}
    got = load_variables(target, CKPT)["qconst"]["stem"]["q"]
    assert int(got["act_zp"]) == int(ours["qconst"]["stem"]["q"]["act_zp"])
    assert got["w_codes"].shape == (1,)          # shape mismatch: kept


def test_from_jax_state_keeps_dtype_and_values(both):
    _, flax_tree = both
    jtree = {"qconst": {"stem": {k: jnp.asarray(v) for k, v in
                                 flax_tree["qconst"]["stem"]["q"].items()}}}
    for tree in (flax_tree, jtree):
        t = from_jax_state(tree)
        src = tree["qconst"]["stem"]
        src = src["q"] if "q" in src else src
        dst = t["qconst"]["stem"]
        dst = dst["q"] if "q" in dst else dst
        for k, v in src.items():
            v = np.asarray(v)
            assert isinstance(dst[k], torch.Tensor)
            assert dst[k].numpy().dtype == v.dtype, k
            np.testing.assert_array_equal(dst[k].numpy(), v)
