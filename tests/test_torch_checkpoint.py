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


# -- the writer -------------------------------------------------------------

def test_packb_matches_msgpack_on_every_type():
    """The port's encoder writes the bytes that msgpack (with flax's
    extension hook) writes, at every length and integer boundary."""
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
            2 ** 63, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
            -2 ** 31 - 1, -2 ** 63]
    obj = {
        "ints": ints,
        "strs": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256,
                 "e" * 65536],
        "bins": [b"", b"x" * 255, b"y" * 256, b"z" * 65536],
        "map16": {str(i): i for i in range(16)},
        "list16": list(range(16)),
        "arr": {str(n): np.arange(n, dtype=np.float32) for n in
                (0, 1, 2, 3, 4, 40, 70000)},
        "i8": np.arange(-8, 8, dtype=np.int8).reshape(4, 4),
        "scalar0d": np.asarray(2.5, np.float32),
    }
    from qbn_tpu_torch.training.checkpoint import packb
    want = msgpack.packb(obj, default=serialization._msgpack_ext_pack,
                         strict_types=True)
    assert packb(obj) == want


@pytest.fixture(scope="module")
def trained_lenet():
    """A LeNet state after two float training steps of the port (B=4),
    validated after its epoch."""
    from qbn_tpu_torch.flows import fit
    from qbn_tpu_torch.presets import preset
    cfg = preset("bbb", "mnist", tpu_fused=True, epochs=1, seed=3)
    rng = np.random.default_rng(0)
    batches = [(rng.random((4, 28, 28, 1), dtype=np.float32),
                rng.integers(0, 10, 4)) for _ in range(2)]
    _model, trainer, state = fit(cfg, batches, batches[:1], device="cpu")
    (row,) = trainer.history
    assert row["epoch"] == 0 and row["valid"]["error"] >= 0
    assert all(np.isfinite(v) for v in {**row["train"],
                                         **row["valid"]}.values())
    return trainer.variables(state)


def test_written_lenet_reads_back_bitwise(trained_lenet, tmp_path):
    """The port writes a trained LeNet; flax's own serializer gives the
    same bytes, and qbn_tpu's load_variables (into qbn_tpu's init of the
    same model) and the port's reader read it back bitwise."""
    import jax
    from qbn_tpu.models.factory import build_model as j_build
    from qbn_tpu.presets import preset as j_preset
    from qbn_tpu.training.checkpoint import load_variables as j_load
    from qbn_tpu.utils import init_variables as j_init
    from qbn_tpu_torch.convert import to_numpy_state
    from qbn_tpu_torch.training.checkpoint import save_variables

    path = str(tmp_path / "weights.msgpack")
    save_variables(trained_lenet, path)
    want = dict(_leaves(to_numpy_state(trained_lenet)))
    with open(path, "rb") as fh:
        blob = fh.read()
    assert blob == serialization.msgpack_serialize(
        to_numpy_state(trained_lenet))

    jmodel = j_build(j_preset("bbb", "mnist"))
    target = j_init(jmodel, jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)))
    got_j = dict(_leaves(jax.tree.map(np.asarray, j_load(target, path))))
    got_t = dict(_leaves(read_checkpoint(path)))
    assert got_j.keys() == got_t.keys() == want.keys()
    assert ("params", "fc_0", "kernel") in want
    for k in want:
        for got in (got_j[k], got_t[k]):
            assert got.dtype == want[k].dtype and got.shape == want[k].shape
            assert got.tobytes() == want[k].tobytes(), k


def test_from_jax_state_requires_grad_only_params():
    tree = {"params": {"fc": {"kernel": np.ones((2, 2), np.float32)}},
            "kl": {"fc": {"kl": np.asarray(1.0, np.float32)}}}
    t = from_jax_state(tree, requires_grad=True)
    assert t["params"]["fc"]["kernel"].requires_grad
    assert not t["kl"]["fc"]["kl"].requires_grad
    assert not from_jax_state(tree)["params"]["fc"]["kernel"].requires_grad
