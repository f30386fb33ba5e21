"""Reader and writer of the msgpack files flax.serialization writes, for
the subset a checkpoint holds (no flax, no msgpack package needed).

flax's `to_bytes` turns a pytree into a state dict (dicts with string keys;
lists, tuples and named tuples become dicts keyed "0", "1", ... or by
field) and packs it with msgpack: maps, strings, ints, floats, and arrays
as msgpack ext types (`_MsgpackExtType`: 1 = ndarray, 3 = numpy scalar),
whose payload is the msgpack array [shape, dtype name, raw C-order bytes].
bfloat16 is the name "bfloat16" over 2-byte words. flax splits an array
over 1 GiB into chunks under `{"__msgpack_chunked_array__": True, "shape":
..., "chunks": ...}`; the reader here joins them, the writer never splits
(no leaf of the model comes near 1 GiB, and flax reads an unsplit array
as well). Here tensors (any torch dtype with a numpy name, bf16
included) and numpy arrays are written that way, and arrays are read back
as CPU tensors, so a checkpoint written here loads in the JAX package and
the other way round (tests/test_torch_checkpoint.py).
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"

_TORCH_OF_NAME = {"bfloat16": torch.bfloat16}


# ---------------------------------------------------------------- state dict


def to_state_dict(tree: Any) -> Any:
    """flax's state dict of a nested dict/list/tuple tree: sequences become
    dicts keyed "0", "1", ...; leaves are kept."""
    if isinstance(tree, dict):
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    return tree


def from_state_dict(template: Any, sd: Any) -> Any:
    """Inverse of to_state_dict along `template`'s structure: sequences of
    the template are rebuilt from the "0", "1", ... keys; leaves come from
    `sd` as stored."""
    if isinstance(template, dict):
        missing = set(template) - set(sd)
        if missing:
            raise ValueError(f"state dict lacks keys {sorted(missing)}")
        return {k: from_state_dict(v, sd[str(k)]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(from_state_dict(v, sd[str(i)])
                              for i, v in enumerate(template))
    return sd


# ------------------------------------------------------------------- arrays


def _array_parts(x) -> Tuple[tuple, str, bytes]:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()
        x = t.numpy()
    a = np.asarray(x)
    return a.shape, a.dtype.name, a.tobytes("C")


def _array_of(shape, name, buf: bytes) -> torch.Tensor:
    name = name.decode() if isinstance(name, bytes) else name
    shape = tuple(shape)
    if name in _TORCH_OF_NAME:
        return torch.frombuffer(bytearray(buf), dtype=_TORCH_OF_NAME[name]).reshape(shape)
    return torch.from_numpy(np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy())


def _unchunk(d: dict) -> torch.Tensor:
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    parts = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    return torch.cat([p.reshape(-1) for p in parts]).reshape(shape)


# ----------------------------------------------------------------- packing


def _pack_len(out: bytearray, n: int, fix: int, fix_max: int, codes):
    if n < fix_max and fix is not None:
        out.append(fix | n)
    elif n < 2 ** 8 and codes[0] is not None:
        out += bytes([codes[0], n])
    elif n < 2 ** 16:
        out += bytes([codes[1]]) + struct.pack(">H", n)
    else:
        out += bytes([codes[2]]) + struct.pack(">I", n)


def _pack_ext(out: bytearray, code: int, data: bytes):
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out += bytes([fixed[n], code])
    elif n < 2 ** 8:
        out += bytes([0xC7, n, code])
    elif n < 2 ** 16:
        out += bytes([0xC8]) + struct.pack(">H", n) + bytes([code])
    else:
        out += bytes([0xC9]) + struct.pack(">I", n) + bytes([code])
    out += data


def _pack(x: Any, out: bytearray):
    if x is None:
        out.append(0xC0)
    elif x is True or x is False:
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, int) and not isinstance(x, np.generic):
        if 0 <= x < 128:
            out.append(x)
        elif -32 <= x < 0:
            out.append(x & 0xFF)
        elif x >= 0:
            for code, fmt, lim in ((0xCC, ">B", 2 ** 8), (0xCD, ">H", 2 ** 16),
                                   (0xCE, ">I", 2 ** 32), (0xCF, ">Q", 2 ** 64)):
                if x < lim:
                    out += bytes([code]) + struct.pack(fmt, x)
                    break
        else:
            for code, fmt, lim in ((0xD0, ">b", 2 ** 7), (0xD1, ">h", 2 ** 15),
                                   (0xD2, ">i", 2 ** 31), (0xD3, ">q", 2 ** 63)):
                if x >= -lim:
                    out += bytes([code]) + struct.pack(fmt, x)
                    break
    elif isinstance(x, float):
        out += b"\xcb" + struct.pack(">d", x)
    elif isinstance(x, str):
        b = x.encode("utf-8")
        _pack_len(out, len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(x, (bytes, bytearray)):
        _pack_len(out, len(x), None, 0, (0xC4, 0xC5, 0xC6))
        out += x
    elif isinstance(x, (list, tuple)):
        _pack_len(out, len(x), 0x90, 16, (None, 0xDC, 0xDD))
        for v in x:
            _pack(v, out)
    elif isinstance(x, dict):
        _pack_len(out, len(x), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(x, np.generic):
        shape, name, buf = _array_parts(np.asarray(x))
        _pack_ext(out, EXT_NPSCALAR, packb([list(shape), name, buf]))
    elif isinstance(x, (torch.Tensor, np.ndarray)):
        shape, name, buf = _array_parts(x)
        _pack_ext(out, EXT_NDARRAY, packb([list(shape), name, buf]))
    else:
        raise TypeError(f"cannot pack {type(x).__name__}")


def packb(x: Any) -> bytes:
    out = bytearray()
    _pack(x, out)
    return bytes(out)


def to_bytes(tree: Any) -> bytes:
    """flax.serialization.to_bytes of a nested dict/list tree of tensors,
    numpy arrays and Python scalars."""
    return packb(to_state_dict(tree))


# --------------------------------------------------------------- unpacking


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        if len(b) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return bytes(b)

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        c = self.take(1)[0]
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.read() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self.take(c & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        nums = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in nums:
            return self.num(nums[c])
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
                0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
                0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if c in fixext or c in (0xC7, 0xC8, 0xC9):
            n = fixext[c] if c in fixext else self.num(lens[c])
            code = self.num(">b")
            return self.ext(code, self.take(n))
        if c not in lens:
            raise ValueError(f"unsupported msgpack type byte 0x{c:02x}")
        n = self.num(lens[c])
        if c in (0xC4, 0xC5, 0xC6):
            return self.take(n)
        if c in (0xD9, 0xDA, 0xDB):
            return self.take(n).decode("utf-8")
        if c in (0xDC, 0xDD):
            return [self.read() for _ in range(n)]
        return self.map(n)

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    @staticmethod
    def ext(code: int, data: bytes) -> Any:
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, name, buf = unpackb(data)
        arr = _array_of(shape, name, buf)
        return arr if code == EXT_NDARRAY else arr.reshape(()).item()


def unpackb(data: bytes) -> Any:
    r = _Reader(data)
    out = r.read()
    if r.pos != len(data):
        raise ValueError("trailing bytes after msgpack object")
    return out


def _unchunk_tree(x: Any) -> Any:
    if isinstance(x, dict):
        if x.get(CHUNKED):
            return _unchunk(x)
        return {k: _unchunk_tree(v) for k, v in x.items()}
    return x


def msgpack_restore(data: bytes) -> Any:
    """flax.serialization.msgpack_restore: the raw state dict, arrays as
    CPU tensors."""
    return _unchunk_tree(unpackb(data))


def from_bytes(template: Any, data: bytes) -> Any:
    """flax.serialization.from_bytes along a nested dict/list template."""
    return from_state_dict(template, msgpack_restore(data))
