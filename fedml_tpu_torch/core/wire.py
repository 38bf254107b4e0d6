"""The msgpack wire format of the JAX package, written over ``struct``.

The JAX package puts every message on the wire through
``flax.serialization.msgpack_serialize`` (``fedml_tpu/core/message.py``,
``core/comm/tensor_rpc.py``); the port imports neither flax nor the
``msgpack`` package, so it writes the same bytes itself. The subset is
the one flax writes:

- nil, bool, int (the smallest encoding that holds it), float (always
  float 64, as ``msgpack.packb`` packs a Python float), str, bin, array
  (from a list) and map (from a dict);
- ext 1, an array: ``packb((shape, dtype name, C-order bytes))``; ext 2,
  a Python complex: ``packb((real, imag))``; ext 3, a numpy scalar,
  packed as its 0-d array and read back as a scalar;
- an array leaf of more than ``MAX_CHUNK_SIZE`` bytes held directly in
  a dict (or the whole tree) goes out as flax's chunked map
  ``{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks":
  {"0": ..., "1": ...}}`` of flat slices.

Flax first rebuilds the tree with ``jax.tree_util.tree_map``, which
writes every dict in sorted key order, so :func:`msgpack_serialize`
sorts keys too (the chunked maps it makes afterwards keep their
insertion order, as flax's do). ``strict_types`` refuses a tuple, and so
does this encoder, with msgpack's words.

Tensors meet the wire here and only here: a ``torch.Tensor`` leaf is
copied to the host (a CUDA tensor included) and written as ext 1 under
numpy's dtype name. ``bfloat16`` has no numpy dtype without
``ml_dtypes``, so a bf16 tensor is written from its raw 16-bit words
under the name ``"bfloat16"``, as flax writes a JAX bf16 array, and read
back as a CPU ``torch.bfloat16`` tensor; every other dtype reads back as
a (read-only) numpy array, as flax reads it.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

import numpy as np
import torch

__all__ = ["MAX_CHUNK_SIZE", "packb", "unpackb", "msgpack_serialize", "msgpack_restore",
           "host_array"]

# flax's limit: msgpack caps one object at 2**31 - 1 bytes, so leaves above
# 2**30 bytes are cut into flat chunks
MAX_CHUNK_SIZE = 2**30

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_BF16 = "bfloat16"
_CHUNKED = "__msgpack_chunked_array__"


class _Host:
    """An array leaf on the host: its C-order words and dtype name (bf16's
    words as uint16 under ``"bfloat16"``)."""

    __slots__ = ("arr", "name")

    def __init__(self, arr: np.ndarray, name: str) -> None:
        self.arr, self.name = arr, name

    @property
    def nbytes(self) -> int:
        return int(self.arr.size * self.arr.dtype.itemsize)


def host_array(v) -> Tuple[np.ndarray, str]:
    """A tensor or ndarray leaf as (host numpy array, dtype name); a bf16
    tensor as its uint16 words under ``"bfloat16"``."""
    if isinstance(v, torch.Tensor):
        t = v.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.uint16), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(v)
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError(
            "Object and structured dtypes not supported for serialization of ndarrays."
        )
    return arr, arr.dtype.name


# -- encoder -----------------------------------------------------------


def _pack_int(n: int, out: List[bytes]) -> None:
    if n >= 0:
        if n < 0x80:
            out.append(struct.pack("B", n))
        elif n <= 0xFF:
            out.append(struct.pack(">BB", 0xCC, n))
        elif n <= 0xFFFF:
            out.append(struct.pack(">BH", 0xCD, n))
        elif n <= 0xFFFFFFFF:
            out.append(struct.pack(">BI", 0xCE, n))
        elif n <= 0xFFFFFFFFFFFFFFFF:
            out.append(struct.pack(">BQ", 0xCF, n))
        else:
            raise OverflowError("Integer value out of range")
    else:
        if n >= -32:
            out.append(struct.pack("b", n))
        elif n >= -0x80:
            out.append(struct.pack(">Bb", 0xD0, n))
        elif n >= -0x8000:
            out.append(struct.pack(">Bh", 0xD1, n))
        elif n >= -0x80000000:
            out.append(struct.pack(">Bi", 0xD2, n))
        elif n >= -0x8000000000000000:
            out.append(struct.pack(">Bq", 0xD3, n))
        else:
            raise OverflowError("Integer value out of range")


def _pack_len(n: int, fix: int, fix_max: int, m8, m16: int, m32: int,
              out: List[bytes]) -> None:
    if n <= fix_max:
        out.append(struct.pack("B", fix | n))
    elif m8 is not None and n <= 0xFF:
        out.append(struct.pack(">BB", m8, n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", m16, n))
    elif n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", m32, n))
    else:
        raise ValueError("object too large to pack")


def _pack_bin(b, out: List[bytes]) -> None:
    n = len(b)
    if n <= 0xFF:
        out.append(struct.pack(">BB", 0xC4, n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", 0xC5, n))
    elif n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", 0xC6, n))
    else:
        raise ValueError("bytes object is too large")
    out.append(b if type(b) is bytes else bytes(b))


# fixext markers by payload length
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack_ext(code: int, data: bytes, out: List[bytes]) -> None:
    n = len(data)
    if n in _FIXEXT:
        out.append(struct.pack(">Bb", _FIXEXT[n], code))
    elif n <= 0xFF:
        out.append(struct.pack(">BBb", 0xC7, n, code))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BHb", 0xC8, n, code))
    elif n <= 0xFFFFFFFF:
        out.append(struct.pack(">BIb", 0xC9, n, code))
    else:
        raise ValueError("EXT data is too large")
    out.append(data)


def _ndarray_bytes(h: _Host) -> bytes:
    """flax's ``_ndarray_to_bytes``: ``packb((shape, dtype name, bytes))``."""
    out: List[bytes] = []
    _pack_len(3, 0x90, 15, None, 0xDC, 0xDD, out)
    _pack_len(len(h.arr.shape), 0x90, 15, None, 0xDC, 0xDD, out)
    for d in h.arr.shape:
        _pack_int(int(d), out)
    _pack_str(h.name, out)
    _pack_bin(h.arr.tobytes("C"), out)
    return b"".join(out)


def _pack_str(s: str, out: List[bytes]) -> None:
    b = s.encode("utf-8")
    _pack_len(len(b), 0xA0, 31, 0xD9, 0xDA, 0xDB, out)
    out.append(b)


def _pack(obj: Any, out: List[bytes]) -> None:
    t = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif t is int:
        _pack_int(obj, out)
    elif t is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif t is str:
        _pack_str(obj, out)
    elif t in (bytes, bytearray, memoryview):
        _pack_bin(obj, out)
    elif t is dict:
        _pack_len(len(obj), 0x80, 15, None, 0xDE, 0xDF, out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif t is list:
        _pack_len(len(obj), 0x90, 15, None, 0xDC, 0xDD, out)
        for v in obj:
            _pack(v, out)
    elif t is _Host:
        _pack_ext(_EXT_NDARRAY, _ndarray_bytes(obj), out)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_ext(_EXT_NDARRAY, _ndarray_bytes(_Host(*host_array(obj))), out)
    elif isinstance(obj, np.generic):
        _pack_ext(_EXT_NPSCALAR, _ndarray_bytes(_Host(*host_array(np.asarray(obj)))), out)
    elif t is complex:
        inner: List[bytes] = [b"\x92"]
        inner.append(struct.pack(">Bd", 0xCB, obj.real))
        inner.append(struct.pack(">Bd", 0xCB, obj.imag))
        _pack_ext(_EXT_COMPLEX, b"".join(inner), out)
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def packb(obj: Any) -> bytes:
    """msgpack bytes of ``obj`` as ``msgpack.packb(obj, default=flax's
    ext packer, strict_types=True)`` writes them: no key sorting, no
    chunking (see :func:`msgpack_serialize`)."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


def _prepare(obj: Any) -> Any:
    """flax's tree_map + numpy conversion: dicts rebuilt in sorted key
    order, tensor and ndarray leaves as ``_Host`` (a tensor copied to the
    host here)."""
    t = type(obj)
    if t is dict:
        return {k: _prepare(obj[k]) for k in sorted(obj)}
    if t is list:
        return [_prepare(v) for v in obj]
    if t is tuple:
        return tuple(_prepare(v) for v in obj)
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return _Host(*host_array(obj))
    return obj


def _chunk(h: _Host) -> dict:
    """flax's ``_chunk``: flat slices of at most MAX_CHUNK_SIZE bytes."""
    chunksize = max(1, int(MAX_CHUNK_SIZE / h.arr.dtype.itemsize))
    flat = h.arr.reshape(-1)
    chunks = [_Host(flat[i:i + chunksize], h.name) for i in range(0, flat.size, chunksize)]
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(h.arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _chunk_in_place(d: Any) -> Any:
    """flax's ``_chunk_array_leaves_in_place``: only leaves held directly
    by a dict (or the whole tree) are chunked, never a list's."""
    if type(d) is dict:
        for k, v in d.items():
            if type(v) is _Host:
                if v.nbytes > MAX_CHUNK_SIZE:
                    d[k] = _chunk(v)
            elif type(v) is dict:
                _chunk_in_place(v)
    elif type(d) is _Host and d.nbytes > MAX_CHUNK_SIZE:
        return _chunk(d)
    return d


def msgpack_serialize(tree: Any) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize`` writes for the
    same tree (tensor leaves standing for JAX arrays)."""
    return packb(_chunk_in_place(_prepare(tree)))


# -- decoder -----------------------------------------------------------


class _Reader:
    __slots__ = ("buf", "pos", "raw")

    def __init__(self, data, raw: bool) -> None:
        self.buf = memoryview(data).cast("B") if not isinstance(data, memoryview) else data
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        p = self.pos
        if p + n > len(self.buf):
            raise ValueError("Unpack failed: incomplete input")
        self.pos = p + n
        return self.buf[p:p + n]

    def fmt(self, f: str):
        s = struct.calcsize(f)
        return struct.unpack(f, self.take(s))[0]


def _str(r: _Reader, n: int):
    b = r.take(n)
    return bytes(b) if r.raw else str(b, "utf-8")


def _ext(code: int, data: memoryview):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_COMPLEX:
        re, im = unpackb(data)
        return complex(re, im)
    if code == _EXT_NPSCALAR:
        a = _ndarray_from_bytes(data)
        return a.reshape(()) if isinstance(a, torch.Tensor) else a[()]
    raise ValueError(f"unknown msgpack ext type {code}")


def _ndarray_from_bytes(data: memoryview):
    shape, name, buffer = unpackb(data, raw=True)
    if name == _BF16.encode():
        words = np.frombuffer(buffer, dtype=np.uint16).copy()
        return torch.from_numpy(words).view(torch.bfloat16).reshape([int(s) for s in shape])
    return np.frombuffer(buffer, dtype=np.dtype(name.decode())).reshape(shape, order="C")


def _array(r: _Reader, n: int) -> list:
    return [_read(r) for _ in range(n)]


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _read(r)
        if type(k) not in (str, bytes):
            raise ValueError(f"{type(k).__name__} is not allowed for map key")
        out[k] = _read(r)
    return out


def _read(r: _Reader):
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _array(r, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        return _str(r, b & 0x1F)
    if b == 0xC0:
        return None
    if b == 0xC2:
        return False
    if b == 0xC3:
        return True
    if b in (0xC4, 0xC5, 0xC6):
        n = r.fmt({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
        return bytes(r.take(n))
    if b in (0xC7, 0xC8, 0xC9):
        n = r.fmt({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
        code = r.fmt(">b")
        return _ext(code, r.take(n))
    if b == 0xCA:
        return r.fmt(">f")
    if b == 0xCB:
        return r.fmt(">d")
    if 0xCC <= b <= 0xD3:
        return r.fmt({0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                      0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}[b])
    if 0xD4 <= b <= 0xD8:
        code = r.fmt(">b")
        return _ext(code, r.take(1 << (b - 0xD4)))
    if b in (0xD9, 0xDA, 0xDB):
        return _str(r, r.fmt({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]))
    if b in (0xDC, 0xDD):
        return _array(r, r.fmt(">H" if b == 0xDC else ">I"))
    if b in (0xDE, 0xDF):
        return _map(r, r.fmt(">H" if b == 0xDE else ">I"))
    raise ValueError(f"Unpack failed: unknown msgpack type 0x{b:02x}")


def unpackb(data, raw: bool = False) -> Any:
    """One msgpack object from ``data`` (all of it), flax's ext types
    decoded; ``raw=True`` leaves strings as bytes."""
    r = _Reader(data, raw)
    obj = _read(r)
    if r.pos != len(r.buf):
        raise ValueError("Unpack failed: extra data")
    return obj


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    parts = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts).reshape(shape)
    return np.concatenate(parts).reshape(shape)


def _unchunk_in_place(d: Any) -> Any:
    if isinstance(d, dict):
        if _CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict) and _CHUNKED in v:
                d[k] = _unchunk(v)
            elif isinstance(v, dict):
                _unchunk_in_place(v)
    return d


def msgpack_restore(data) -> Any:
    """What ``flax.serialization.msgpack_restore`` reads from ``data``
    (bf16 leaves as CPU ``torch.bfloat16`` tensors)."""
    return _unchunk_in_place(unpackb(data))
