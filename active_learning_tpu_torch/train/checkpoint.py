"""Checkpoint I/O in flax's msgpack format, without flax or msgpack.

The JAX package writes model variables (``params`` + ``batch_stats``)
with ``flax.serialization.msgpack_serialize``.  This module reads and
writes the same bytes with its own codec, so the port serves a
checkpoint the JAX package trained, and the JAX package restores one the
port wrote.  The format, as flax defines it:

  * msgpack maps with str keys, str, bin, int, float, bool, nil, arrays;
  * ExtType 1: an ndarray, whose payload is itself msgpack of the triple
    ``(shape, dtype name, C-order bytes)``; ExtType 3: a numpy scalar,
    same payload;
  * arrays above 2**30 bytes are stored "chunked": a map holding
    ``__msgpack_chunked_array__``, ``shape`` and ``chunks``, both
    ``{"0": ..., "1": ...}``.  Read here, never written (no served
    model has a leaf that large).

Also the best-checkpoint bus of the JAX package's
``train/checkpoint.py``: ``publish_best`` (weights, then a
``.tag.json`` sidecar with the monotonic (round, epoch), each an atomic
tmp+rename), ``latest_best_ckpt``, ``read_best_tag`` and
``BestCkptWatcher`` for the executor's hot reload.
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


# -- msgpack writer ----------------------------------------------------------

def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif n < 0:
        if n >= -0x20:
            out += struct.pack(">b", n)
        elif n >= -0x80:
            out += b"\xd0" + struct.pack(">b", n)
        elif n >= -0x8000:
            out += b"\xd1" + struct.pack(">h", n)
        elif n >= -0x80000000:
            out += b"\xd2" + struct.pack(">i", n)
        else:
            out += b"\xd3" + struct.pack(">q", n)
    elif n < 0x100:
        out += b"\xcc" + struct.pack(">B", n)
    elif n < 0x10000:
        out += b"\xcd" + struct.pack(">H", n)
    elif n < 0x100000000:
        out += b"\xce" + struct.pack(">I", n)
    else:
        out += b"\xcf" + struct.pack(">Q", n)


def _pack_len(n: int, fix: int, fix_max: int, codes: Tuple[int, ...],
              out: bytearray) -> None:
    """Header of a str/bin/array/map of length ``n``: the fix form when
    it fits, else the 8/16/32-bit length forms (``codes``; None where
    the type has no such form)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (0x100, 0x10000, 0x100000000)):
        if code is not None and n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"object of length {n} is too large for msgpack")


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError(f"cannot serialize an array of dtype {arr.dtype}")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixext:
        out.append(fixext[n])
    else:
        _pack_len(n, None, 0, (0xc7, 0xc8, 0xc9), out)
    out += struct.pack(">b", code)
    out += data


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xc0)
    elif obj is True or obj is False:
        out.append(0xc3 if obj else 0xc2)
    elif isinstance(obj, np.ndarray):
        _pack_ext(_EXT_NDARRAY, _ndarray_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(_EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)), out)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), 0xa0, 32, (0xd9, 0xda, 0xdb), out)
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _pack_len(len(b), None, 0, (0xc4, 0xc5, 0xc6), out)
        out += b
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (None, 0xdc, 0xdd), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        if not all(isinstance(k, str) for k in obj):
            raise TypeError("map keys must be str")
        _pack_len(len(obj), 0x80, 16, (None, 0xde, 0xdf), out)
        # Sorted keys: flax copies the tree through jax's tree_map, which
        # orders dict keys, so its bytes list them sorted.
        for k in sorted(obj):
            _pack(k, out)
            _pack(obj[k], out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """msgpack bytes of a tree of dicts, lists, scalars and ndarrays,
    in the smallest encoding of each object and with sorted map keys:
    the bytes flax writes for the same tree."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# -- msgpack reader ----------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        v = self.data[self.pos:self.pos + n]
        self.pos += n
        return v

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.obj() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        sized = {0xc4: (">B", "bin"), 0xc5: (">H", "bin"),
                 0xc6: (">I", "bin"), 0xd9: (">B", "str"),
                 0xda: (">H", "str"), 0xdb: (">I", "str"),
                 0xdc: (">H", "arr"), 0xdd: (">I", "arr"),
                 0xde: (">H", "map"), 0xdf: (">I", "map"),
                 0xc7: (">B", "ext"), 0xc8: (">H", "ext"),
                 0xc9: (">I", "ext")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.str(n)
            if kind == "arr":
                return [self.obj() for _ in range(n)]
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        numbers = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H",
                   0xce: ">I", 0xcf: ">Q", 0xd0: ">b", 0xd1: ">h",
                   0xd2: ">i", 0xd3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            if not isinstance(k, (str, bytes)):
                raise ValueError(f"map key of type {type(k).__name__}")
            out[k] = self.obj()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray_from_payload(data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_payload(data)[()]
        raise ValueError(f"unsupported msgpack ext type {code}")


# numpy's own dtypes.  flax also writes bfloat16 and the other ml_dtypes
# names, which numpy alone (and so torch.from_numpy) cannot hold.
_NUMPY_DTYPES = frozenset(
    ("bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
     "uint64", "float16", "float32", "float64", "complex64", "complex128"))


def _ndarray_from_payload(data: bytes) -> np.ndarray:
    shape, name, buf = unpackb(data)
    if isinstance(name, bytes):
        name = name.decode()
    if name not in _NUMPY_DTYPES:
        raise ValueError(
            f"checkpoint leaf of dtype {name!r} is not a numpy dtype "
            "(model variables are float32)")
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _unchunk(tree: Any) -> Any:
    """Reassemble flax's chunked form of oversized array leaves."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)]
                      for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def unpackb(data: bytes) -> Any:
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after the "
                         "msgpack object")
    return out


def msgpack_restore(data: bytes) -> Any:
    """The tree ``flax.serialization.msgpack_restore`` gives for the same
    bytes (numpy leaves)."""
    return _unchunk(unpackb(data))


def msgpack_serialize(tree: Any) -> bytes:
    """Bytes ``flax.serialization.msgpack_restore`` reads back into an
    equal tree."""
    return packb(tree)


# -- variables files ---------------------------------------------------------

def save_variables(path: str, variables: Dict[str, Any]) -> None:
    """Atomic write (tmp + rename): a reader never sees a half-written
    checkpoint."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as fh:
        fh.write(msgpack_serialize(variables))
    os.replace(tmp, path)


def load_variables(path: str) -> Dict[str, Any]:
    with open(path, "rb") as fh:
        return msgpack_restore(fh.read())


_BEST_CKPT_RE = re.compile(r"^best_rd_(\d+)\.msgpack$")


def latest_best_ckpt(ckpt_dir: str) -> Tuple[Optional[str], int]:
    """(path, round) of the newest round's ``best_rd_{n}.msgpack`` under
    ``ckpt_dir``, or (None, -1) when none exists."""
    best: Tuple[Optional[str], int] = (None, -1)
    try:
        names = os.listdir(ckpt_dir)
    except (FileNotFoundError, NotADirectoryError):
        return best
    for name in names:
        m = _BEST_CKPT_RE.match(name)
        if m and int(m.group(1)) > best[1]:
            best = (os.path.join(ckpt_dir, name), int(m.group(1)))
    return best


def publish_best(path: str, variables: Dict[str, Any], *, round_idx: int,
                 epoch: int) -> None:
    """Atomically publish a best checkpoint, then its monotonic
    (round, epoch) tag sidecar.  Within a round the best epoch only
    grows, so the tag orders publishes exactly where mtimes cannot."""
    save_variables(path, variables)
    tag = {"round": int(round_idx), "epoch": int(epoch)}
    tmp = f"{path}.tag.json.tmp"
    with open(tmp, "w") as fh:
        json.dump(tag, fh)
    os.replace(tmp, f"{path}.tag.json")


def read_best_tag(path: str) -> Optional[Tuple[int, int]]:
    """The (round, epoch) tag published alongside ``path``; None when the
    sidecar is absent or unreadable."""
    try:
        with open(f"{path}.tag.json") as fh:
            tag = json.load(fh)
        return (int(tag["round"]), int(tag["epoch"]))
    except (OSError, ValueError, KeyError, TypeError):
        return None


class BestCkptWatcher:
    """Hot-reload probe over an experiment's checkpoint directory.

    ``poll()`` returns ``(variables, round, tag)`` when a best checkpoint
    newer than the last successful poll is completely published, else
    None.  Newness is the (round, epoch) tag when there is one, else
    (round, mtime).  The tag is re-read after the weights load; a
    mismatch means the writer is between its two renames, and reads as
    not-ready until the next poll."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._stamp: Optional[Tuple] = None

    @staticmethod
    def _stamp_of(rd: int, tag, mtime: float) -> Tuple:
        return ((rd, 0, (-1, -1), mtime) if tag is None
                else (rd, 1, tag, 0.0))

    def poll(self):
        path, rd = latest_best_ckpt(self.ckpt_dir)
        if path is None:
            return None
        tag = read_best_tag(path)
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            return None
        stamp = self._stamp_of(rd, tag, mtime)
        if self._stamp is not None and stamp <= self._stamp:
            return None
        try:
            variables = load_variables(path)
        except (OSError, ValueError):
            # Rotated away or replaced mid-read; the next poll settles.
            return None
        if read_best_tag(path) != tag:
            return None
        self._stamp = stamp
        return variables, rd, tag


def flatten_tree(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
                 ) -> List[Tuple[Tuple[str, ...], Any]]:
    """[(path, leaf)] of a nested dict, in insertion order."""
    out: List[Tuple[Tuple[str, ...], Any]] = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += flatten_tree(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out
