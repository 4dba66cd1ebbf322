"""
Readers for the two weight-file formats the port loads, written against
their published layouts so that the port needs neither `safetensors` nor
`msgpack` (nor flax):

- safetensors: an 8-byte little-endian header length, a JSON header of
  {name: {dtype, shape, data_offsets}} (and an optional "__metadata__"),
  then the raw little-endian bytes. F32, F16 and BF16 are read.
- flax msgpack (`flax.serialization.to_bytes`, what the JAX package's
  `save_native` writes): nested maps with str keys; each array is msgpack
  ext type 1 holding a packed (shape, dtype name, bytes). Arrays over 1 GiB
  are stored in flax's chunked form, {"__msgpack_chunked_array__": True,
  "shape": {"0": ...}, "chunks": {"0": array, ...}}, and joined here.
  float32, float16 and bfloat16 are read; bfloat16's bytes are viewed as
  torch.bfloat16 directly.

Each file is read into one host buffer; the tensors are views into it
(copied only where an array's bytes are not aligned to its element size).
Anything else (another dtype, a msgpack type a parameter tree does not
hold) raises ValueError naming it.
"""

from __future__ import annotations

import json
import math
import os
import struct
import typing as T

import torch

SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}
MSGPACK_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                  "bfloat16": torch.bfloat16}
CHUNKED = "__msgpack_chunked_array__"


def _read_all(path: T.Union[str, os.PathLike]) -> bytearray:
    buf = bytearray(os.path.getsize(path))
    view = memoryview(buf)
    with open(path, "rb") as fh:
        done = 0
        while done < len(buf):
            n = fh.readinto(view[done:])
            if not n:
                raise ValueError(f"{path}: file ended after {done} of {len(buf)} bytes")
            done += n
    return buf


def _tensor(buf: bytearray, offset: int, dtype: torch.dtype, shape: T.Sequence[int],
            nbytes: int, what: str) -> torch.Tensor:
    """A tensor over buf[offset:offset + nbytes], checked against its shape."""
    count = math.prod(shape)
    itemsize = torch.empty((), dtype=dtype).element_size()
    if count * itemsize != nbytes or offset + nbytes > len(buf):
        raise ValueError(f"{what}: {nbytes} bytes at offset {offset} do not hold "
                         f"{tuple(shape)} of {dtype}")
    if count == 0:
        return torch.empty(tuple(shape), dtype=dtype)
    t = torch.frombuffer(buf, dtype=dtype, count=count, offset=offset)
    if offset % itemsize:
        t = t.clone()
    return t.view(tuple(shape))


def read_safetensors(
    path: T.Union[str, os.PathLike], keep: T.Optional[T.Callable[[str], bool]] = None
) -> T.Dict[str, torch.Tensor]:
    """{name: tensor} of a .safetensors file, on the CPU in its own dtype;
    with `keep`, only the names it accepts are decoded (a loader passes the
    keys it skips, such as transformers' int64 position_ids, this way)."""
    buf = _read_all(path)
    if len(buf) < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    (n,) = struct.unpack_from("<Q", buf, 0)
    header = json.loads(bytes(buf[8:8 + n]))
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__" or (keep is not None and not keep(name)):
            continue
        dtype = SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}; the reader "
                             f"takes {sorted(SAFETENSORS_DTYPES)}")
        start, end = info["data_offsets"]
        out[name] = _tensor(buf, base + start, dtype, info["shape"], end - start,
                            f"{path}: {name!r}")
    return out


class _Msgpack:
    """A msgpack decoder over one buffer for the types a flax parameter tree
    holds: maps, str, int, bool, arrays (an ndarray's shape) and ext type 1."""

    _EXT_NAMES = {2: "native complex", 3: "numpy scalar"}

    def __init__(self, buf: bytearray, path: str):
        self.buf, self.pos, self.path = buf, 0, path

    def _take(self, fmt: str) -> int:
        (value,) = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += struct.calcsize(fmt)
        return value

    def _refuse(self, what: str) -> T.NoReturn:
        raise ValueError(f"{self.path}: msgpack {what} at byte {self.pos} is not part of a "
                         "flax parameter tree; the reader does not take it")

    def value(self) -> T.Any:
        b = self.buf[self.pos]
        self.pos += 1
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        fixed = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self._take(fixed[b])
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xD9, 0xDA, 0xDB):
            return self._str(self._take({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):
            return [self.value() for _ in range(self._take(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self._map(self._take(">H" if b == 0xDE else ">I"))
        if 0xD4 <= b <= 0xD8:
            return self._ext(1 << (b - 0xD4))
        if b in (0xC7, 0xC8, 0xC9):
            return self._ext(self._take({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b]))
        self.pos -= 1
        names = {0xC0: "nil", 0xCA: "float32", 0xCB: "float64",
                 0xC4: "bin", 0xC5: "bin", 0xC6: "bin"}
        self._refuse(f"type {names.get(b, f'0x{b:02x}')}")

    def _str(self, n: int) -> str:
        s = bytes(self.buf[self.pos:self.pos + n]).decode("utf-8")
        self.pos += n
        return s

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            if not isinstance(key, str):
                self._refuse(f"map key of type {type(key).__name__}")
            out[key] = self.value()
        return out

    def _ext(self, n: int) -> torch.Tensor:
        code = self._take(">b")
        end = self.pos + n
        if code != 1:
            self.pos -= 1
            self._refuse(f"ext type {code} ({self._EXT_NAMES.get(code, 'unknown')})")
        # the payload: a 3-array of (shape array, dtype name, bin bytes)
        if self.buf[self.pos] != 0x93:
            self._refuse("ndarray payload that is not a 3-array")
        self.pos += 1
        shape = self.value()
        name = self.value()
        b = self.buf[self.pos]
        self.pos += 1
        size_fmt = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}.get(b)
        if size_fmt is None or not isinstance(name, str):
            self._refuse("ndarray payload without (shape, dtype name, bytes)")
        nbytes = self._take(size_fmt)
        dtype = MSGPACK_DTYPES.get(name)
        if dtype is None:
            raise ValueError(f"{self.path}: array of dtype {name} at byte {self.pos}; the reader "
                             f"takes {sorted(MSGPACK_DTYPES)}")
        out = _tensor(self.buf, self.pos, dtype, shape, nbytes, f"{self.path}: array")
        self.pos += nbytes
        if self.pos != end:
            self._refuse("ndarray ext with trailing bytes")
        return out


def _unchunk(tree: T.Any) -> T.Any:
    """Join flax's chunked arrays back into single tensors."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(CHUNKED):
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return torch.cat([c.reshape(-1) for c in chunks]).view(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_flax_msgpack(path: T.Union[str, os.PathLike]) -> T.Dict[str, T.Any]:
    """The nested {name: subtree or tensor} of a flax msgpack file."""
    dec = _Msgpack(_read_all(path), str(path))
    tree = dec.value()
    if dec.pos != len(dec.buf):
        dec._refuse("data after the tree")
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: the top level is a {type(tree).__name__}, not a map")
    return _unchunk(tree)
