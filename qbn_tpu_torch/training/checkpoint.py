"""Checkpoints: flax msgpack variable trees, encoded and decoded in pure
Python (port of qbn_tpu/training/checkpoint.py's save_variables and
load_variables).

qbn_tpu writes checkpoints with `flax.serialization.msgpack_serialize`.
The port writes the same bytes for the same tree (`save_variables`: maps
with str keys, every leaf an ndarray extension) and reads them with its
own small msgpack decoder, so that it needs neither flax nor the msgpack
package. It decodes maps, arrays, str, bin,
ints, floats, nil and bool, and flax's extension types: an ndarray
(ext 1, whose payload is a msgpack array of shape, dtype name and raw
bytes), a numpy scalar (ext 3, the same payload) and a complex (ext 2).
Arrays over flax's chunk limit are stored as chunked maps and are joined
again, as `flax.serialization.msgpack_restore` does.
"""

from __future__ import annotations

import os
import re
import struct

import numpy as np

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"
_CHUNK_BYTES = 2 ** 30           # flax.serialization.MAX_CHUNK_SIZE


class _Reader:
    """Cursor over one msgpack byte string."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in sized:                                   # bin 8/16/32
            return bytes(self.take(self.unpack(sized[b])))
        ext_sized = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in ext_sized:                               # ext 8/16/32
            n = self.unpack(ext_sized[b])
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(n)))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(fixext[b])))
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        str_sized = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in str_sized:
            return self.str(self.unpack(str_sized[b]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def _ext(code: int, payload: bytes):
    if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
        shape, dtype_name, buf = unpackb(payload)
        if isinstance(dtype_name, bytes):
            dtype_name = dtype_name.decode()
        arr = np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr
    if code == _EXT_COMPLEX:
        real, imag = unpackb(payload)
        return complex(real, imag)
    raise ValueError(f"unsupported msgpack ext type {code}")


def unpackb(data: bytes):
    """Decode one msgpack object that spans all of `data`."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after msgpack object")
    return out


def _unchunk(tree):
    """Join arrays that flax split into chunks (its `_unchunk`)."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(encoded: bytes):
    """Nested dicts of numpy arrays, as flax.serialization.msgpack_restore
    returns them."""
    return _unchunk(unpackb(encoded))


def _pack_uint(n: int, fix_max: int, fix_tag: int, tags) -> bytes:
    """msgpack's smallest length header: fix_tag | n up to fix_max, else
    the first of (tag, struct format) that holds n."""
    if n <= fix_max:
        return bytes([fix_tag | n])
    for tag, fmt in tags:
        if n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack length {n} too large")


def _pack_int(n: int) -> bytes:
    if 0 <= n <= 0x7F:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for tag, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"),
                         (0xCF, ">Q")):
            if n < 1 << (8 * struct.calcsize(fmt)):
                return bytes([tag]) + struct.pack(fmt, n)
    for tag, fmt in ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"),
                     (0xD3, ">q")):
        bits = 8 * struct.calcsize(fmt)
        if -(1 << (bits - 1)) <= n:
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"int {n} out of msgpack range")


def _pack_ext(code: int, payload: bytes) -> bytes:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(payload)
    if n in fixext:
        head = bytes([fixext[n]])
    else:
        head = _pack_uint(n, -1, 0, ((0xC7, ">B"), (0xC8, ">H"),
                                     (0xC9, ">I")))
    return head + struct.pack(">b", code) + payload


def packb(obj) -> bytes:
    """msgpack bytes of a tree of dicts (str keys), lists/tuples, str,
    bytes, int and numpy arrays (as flax's ndarray extension), byte for
    byte as flax.serialization's packer writes them."""
    if isinstance(obj, dict):
        head = _pack_uint(len(obj), 15, 0x80, ((0xDE, ">H"), (0xDF, ">I")))
        return head + b"".join(packb(k) + packb(v) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        head = _pack_uint(len(obj), 15, 0x90, ((0xDC, ">H"), (0xDD, ">I")))
        return head + b"".join(packb(v) for v in obj)
    if isinstance(obj, str):
        raw = obj.encode("utf-8")
        return _pack_uint(len(raw), 31, 0xA0, ((0xD9, ">B"), (0xDA, ">H"),
                                               (0xDB, ">I"))) + raw
    if isinstance(obj, bytes):
        return _pack_uint(len(obj), -1, 0, ((0xC4, ">B"), (0xC5, ">H"),
                                            (0xC6, ">I"))) + obj
    if isinstance(obj, np.ndarray):
        payload = packb((obj.shape, obj.dtype.name, obj.tobytes("C")))
        return _pack_ext(_EXT_NDARRAY, payload)
    if isinstance(obj, int) and not isinstance(obj, bool):
        return _pack_int(obj)
    raise TypeError(f"cannot msgpack {type(obj)}")


def msgpack_serialize(tree) -> bytes:
    """flax.serialization.msgpack_serialize of a tree of numpy arrays: the
    keys of every map in sorted order, as JAX's tree_map leaves them.
    flax splits an array over 2^30 bytes into chunks; the port's models
    have none, so it raises instead."""
    def canonical(node):
        if isinstance(node, dict):
            return {k: canonical(node[k]) for k in sorted(node)}
        if isinstance(node, np.ndarray) and node.nbytes > _CHUNK_BYTES:
            raise ValueError("array over flax's chunk size: not supported")
        return node
    return packb(canonical(tree))


def save_variables(variables, path: str) -> None:
    """Write a variable tree (tensor or numpy leaves) as qbn_tpu's
    save_variables does: every leaf an ndarray."""
    from qbn_tpu_torch.convert import to_numpy_state
    with open(path, "wb") as fh:
        fh.write(msgpack_serialize(to_numpy_state(variables)))


def model_size_mb(variables) -> float:
    """The model's serialised size in MB (qbn_tpu's `model_size_mb`: the
    byte count of its msgpack checkpoint, the same bytes here)."""
    from qbn_tpu_torch.convert import to_numpy_state
    return len(msgpack_serialize(to_numpy_state(variables))) / 1e6


def read_checkpoint(path: str):
    with open(path, "rb") as fh:
        return msgpack_restore(fh.read())


def merge(target, restored):
    """Recursively take restored values where keys and shapes line up;
    missing or mismatched entries keep the target's value."""
    if isinstance(target, dict):
        if not isinstance(restored, dict):
            return target
        return {k: (merge(v, restored[k]) if k in restored else v)
                for k, v in target.items()}
    if restored is None:
        return target
    r = np.asarray(restored)
    t = np.asarray(target)
    if r.shape != t.shape:
        return target
    return r.astype(t.dtype)


def load_variables(variables, path: str):
    """Restore into `variables` (nested dicts of arrays), intersecting
    keys: missing or mismatched entries keep their current values."""
    return merge(variables, read_checkpoint(path))


def checkpoint_path(save_dir: str, special_info: str = "") -> str:
    return os.path.join(save_dir, f"weights{special_info}.msgpack")


def _natural_key(text: str):
    return [int(c) if c.isdigit() else c
            for c in re.split(r"(-?\d+)", text)]


def list_snapshots(save_dir: str, special_info: str = ""):
    """Epoch-stamped SGHMC snapshots 'weights_<info><epoch>.msgpack' in
    natural order, as qbn_tpu lists them."""
    pat = re.compile(r"weights_" + re.escape(special_info)
                     + r"[0-9]+\.msgpack$")
    names = [f for f in os.listdir(save_dir) if pat.fullmatch(f)]
    names.sort(key=_natural_key)
    return [os.path.join(save_dir, n) for n in names]
