"""Apache Parquet, written and read with numpy and the standard library.

The reference's block layer writes and reads Parquet through pyarrow
(`tempo_tpu/block/{writer,wal,reader}.py`). The port carries its own codec
so that it needs no Arrow build: the files it writes are valid Parquet
that pyarrow reads, and it reads what pyarrow writes as the reference's
writer calls it (dictionary pages, `use_dictionary=True`) with the codecs
the standard library has.

What it writes:

- `PAR1`, one column chunk per column per row group, then `FileMetaData`
  in the Thrift compact protocol, its length and `PAR1`;
- `DataPage` V1 pages of PLAIN values, cut at row boundaries into pages of
  at most about `PAGE_BYTES` of values;
- definition and repetition levels in the RLE/bit-packed hybrid (one RLE
  run when a page's levels are constant, else one bit-packed run);
- `UNCOMPRESSED` or `GZIP` pages. zstd, snappy and every other codec
  raise `NotImplementedError`: the standard library has none of them;
- no column statistics (no reader of the block layer uses them).

Column types (the type strings of a `ColumnTable` schema), and how they
are laid out in memory:

- `fixed16`, `fixed8`: `FIXED_LEN_BYTE_ARRAY`, a uint8 array [n, width];
- `int8` (`INT32` with the `INT(8, signed)` logical type), `int32`,
  `int64`, `double`, `bool` (bit-packed PLAIN): a numpy array [n];
- `string` (`BYTE_ARRAY`, `STRING`): `Strings`, offsets plus UTF-8 bytes,
  with an optional validity mask (the only column kind that may hold
  nulls here);
- `list<T>` for any of the above T: the standard 3-level `LIST` group, as
  `Lists` (row offsets plus the child column). Lists may be empty; a null
  list or a null element raises on read.

Every field is optional, as the reference's `pa.field` defaults are.

Fixed-width values, offsets and levels are encoded and decoded with numpy
(`tobytes`/`frombuffer`, `packbits`); PLAIN byte arrays are written
through their offsets. Reading them back needs one pass over the lengths,
which interleave with the bytes: that pass is the one loop per value here.
"""

from __future__ import annotations

import struct
import zlib
from typing import Callable, Iterable, Sequence

import numpy as np

MAGIC = b"PAR1"
PAGE_BYTES = 1 << 20
CREATED_BY = "tempo_tpu_torch parquet codec"

# physical types
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FIXED = range(8)
# repetition
REQUIRED, OPTIONAL, REPEATED = 0, 1, 2
# encodings
ENC_PLAIN, ENC_PLAIN_DICTIONARY, ENC_RLE, ENC_RLE_DICTIONARY = 0, 2, 3, 8
ENCODING_NAMES = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE",
                  4: "BIT_PACKED", 5: "DELTA_BINARY_PACKED",
                  6: "DELTA_LENGTH_BYTE_ARRAY", 7: "DELTA_BYTE_ARRAY",
                  8: "RLE_DICTIONARY", 9: "BYTE_STREAM_SPLIT"}
# page types
PAGE_DATA, PAGE_INDEX, PAGE_DICTIONARY, PAGE_DATA_V2 = 0, 1, 2, 3
# compression codecs
CODECS = {"none": 0, "uncompressed": 0, "gzip": 2}
CODEC_NAMES = {0: "UNCOMPRESSED", 1: "SNAPPY", 2: "GZIP", 3: "LZO",
               4: "BROTLI", 5: "LZ4", 6: "ZSTD", 7: "LZ4_RAW"}
# converted types
CONV_UTF8, CONV_LIST, CONV_INT_8 = 0, 3, 15

_FIXED_DTYPES = {"int8": np.int8, "int32": np.int32, "int64": np.int64,
                 "double": np.float64, "bool": np.bool_}


class ParquetError(ValueError):
    """A file that is not valid Parquet (torn, truncated or corrupt)."""


def codec_id(compression: str) -> int:
    """The Parquet codec id of a `compression` name the port can write."""
    name = (compression or "none").lower()
    if name in CODECS:
        return CODECS[name]
    raise NotImplementedError(
        f"Parquet compression {compression!r}: the port writes only "
        f"'none' and 'gzip', the codecs Python's standard library has "
        f"(zlib); there is no {name} library to link")


# ---------------------------------------------------------------------------
# In-memory columns
# ---------------------------------------------------------------------------

class Strings:
    """Variable-length UTF-8 values: `offsets` int64 [n + 1] into `data`
    (uint8), and `valid` (bool [n]) when some values are null."""

    __slots__ = ("offsets", "data", "valid")

    def __init__(self, offsets: np.ndarray, data: np.ndarray,
                 valid: np.ndarray | None = None) -> None:
        self.offsets = np.asarray(offsets, np.int64)
        self.data = np.asarray(data, np.uint8)
        self.valid = valid

    @staticmethod
    def from_list(values: Sequence[str | None]) -> "Strings":
        enc = [b"" if v is None else v.encode() for v in values]
        offsets = np.zeros(len(enc) + 1, np.int64)
        if enc:
            np.cumsum(np.fromiter(map(len, enc), np.int64, len(enc)),
                      out=offsets[1:])
        valid = None
        if any(v is None for v in values):
            valid = np.fromiter((v is not None for v in values), bool,
                                len(values))
        return Strings(offsets, np.frombuffer(b"".join(enc), np.uint8), valid)

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def slice(self, lo: int, hi: int) -> "Strings":
        a, b = int(self.offsets[lo]), int(self.offsets[hi])
        return Strings(self.offsets[lo:hi + 1] - a, self.data[a:b],
                       None if self.valid is None else self.valid[lo:hi])

    def take(self, idx: np.ndarray) -> "Strings":
        idx = np.asarray(idx, np.int64)
        lens = self.lengths()[idx]
        offsets = np.zeros(len(idx) + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        src = np.repeat(self.offsets[idx] - offsets[:-1], lens) + \
            np.arange(int(offsets[-1]), dtype=np.int64)
        return Strings(offsets, self.data[src],
                       None if self.valid is None else self.valid[idx])

    def tolist(self) -> list[str | None]:
        raw = self.data.tobytes()
        o = self.offsets.tolist()
        out = [raw[o[i]:o[i + 1]].decode() for i in range(len(o) - 1)]
        if self.valid is not None:
            out = [v if ok else None for v, ok in zip(out, self.valid.tolist())]
        return out

    @property
    def nbytes(self) -> int:
        return self.offsets.nbytes + self.data.nbytes


class Lists:
    """List values: `offsets` int64 [n + 1] into the child column
    `values` (a numpy array, a uint8 [m, width] array or `Strings`)."""

    __slots__ = ("offsets", "values")

    def __init__(self, offsets: np.ndarray, values) -> None:
        self.offsets = np.asarray(offsets, np.int64)
        self.values = values

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def slice(self, lo: int, hi: int) -> "Lists":
        a, b = int(self.offsets[lo]), int(self.offsets[hi])
        return Lists(self.offsets[lo:hi + 1] - a, _slice(self.values, a, b))

    def take(self, idx: np.ndarray) -> "Lists":
        idx = np.asarray(idx, np.int64)
        lens = np.diff(self.offsets)[idx]
        offsets = np.zeros(len(idx) + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        src = np.repeat(self.offsets[idx] - offsets[:-1], lens) + \
            np.arange(int(offsets[-1]), dtype=np.int64)
        return Lists(offsets, _take(self.values, src))

    def tolist(self) -> list[list]:
        flat = column_pylist(self.values)
        o = self.offsets.tolist()
        return [flat[o[i]:o[i + 1]] for i in range(len(o) - 1)]

    @property
    def nbytes(self) -> int:
        return self.offsets.nbytes + self.values.nbytes


def _slice(col, lo: int, hi: int):
    return col.slice(lo, hi) if isinstance(col, (Strings, Lists)) else col[lo:hi]


def _take(col, idx: np.ndarray):
    return col.take(idx) if isinstance(col, (Strings, Lists)) else col[idx]


def _concat(cols: list):
    first = cols[0]
    if isinstance(first, np.ndarray):
        return np.concatenate(cols)
    lens = [len(c) for c in cols]
    offsets = np.zeros(sum(lens) + 1, np.int64)
    at, base = 1, 0
    for c in cols:
        offsets[at:at + len(c)] = c.offsets[1:] + base
        at += len(c)
        base += int(c.offsets[-1])
    if isinstance(first, Strings):
        valid = None
        if any(c.valid is not None for c in cols):
            valid = np.concatenate([np.ones(len(c), bool) if c.valid is None
                                    else c.valid for c in cols])
        return Strings(offsets, np.concatenate([c.data for c in cols]), valid)
    return Lists(offsets, _concat([c.values for c in cols]))


def column_pylist(col) -> list:
    """A column's values as Python objects: bytes for fixed-width binary,
    str (or None) for strings, lists for lists."""
    if isinstance(col, (Strings, Lists)):
        return col.tolist()
    if col.ndim == 2:
        raw = col.tobytes()
        w = col.shape[1]
        return [raw[i:i + w] for i in range(0, len(raw), w)]
    return col.tolist()


class ColumnTable:
    """Named columns of equal length with their type strings (module
    docstring), in schema order."""

    def __init__(self, schema: Sequence[tuple[str, str]], columns: dict,
                 num_rows: int | None = None) -> None:
        self.schema = [(n, t) for n, t in schema]
        self.columns = columns
        if num_rows is None:
            num_rows = len(columns[self.schema[0][0]]) if self.schema else 0
        self.num_rows = int(num_rows)

    @property
    def names(self) -> list[str]:
        return [n for n, _ in self.schema]

    def column(self, name: str):
        return self.columns[name]

    def slice(self, lo: int, hi: int) -> "ColumnTable":
        return ColumnTable(self.schema, {n: _slice(c, lo, hi)
                                         for n, c in self.columns.items()},
                           hi - lo)

    def take(self, rows: np.ndarray) -> "ColumnTable":
        rows = np.asarray(rows, np.int64)
        return ColumnTable(self.schema, {n: _take(c, rows)
                                         for n, c in self.columns.items()},
                           len(rows))

    def with_column(self, name: str, values) -> "ColumnTable":
        """A table with column `name` replaced (same type and length)."""
        if name not in self.columns or len(values) != self.num_rows:
            raise ValueError(f"replace {name!r}: no such column or "
                             f"{len(values)} rows for {self.num_rows}")
        return ColumnTable(self.schema, {**self.columns, name: values},
                           self.num_rows)

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self.columns.values())

    def to_pylist(self) -> list[dict]:
        cols = {n: column_pylist(self.columns[n]) for n in self.names}
        return [{n: cols[n][i] for n in self.names}
                for i in range(self.num_rows)]

    @staticmethod
    def concat(tables: list["ColumnTable"]) -> "ColumnTable":
        if len(tables) == 1:
            return tables[0]
        first = tables[0]
        return ColumnTable(first.schema,
                           {n: _concat([t.columns[n] for t in tables])
                            for n in first.names},
                           sum(t.num_rows for t in tables))


def column_from_pylist(typ: str, values: Sequence) -> object:
    """Build one column of type `typ` from Python values."""
    if typ.startswith("list<"):
        inner = typ[5:-1]
        lens = np.fromiter(map(len, values), np.int64, len(values))
        offsets = np.zeros(len(values) + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        flat = [v for row in values for v in row]
        return Lists(offsets, column_from_pylist(inner, flat))
    if typ == "string":
        return Strings.from_list(values)
    if typ.startswith("fixed"):
        w = int(typ[5:])
        raw = b"".join(values)
        if len(raw) != w * len(values):
            raise ValueError(f"{typ}: every value must be {w} bytes")
        return np.frombuffer(raw, np.uint8).reshape(len(values), w)
    return np.array(values, dtype=_FIXED_DTYPES[typ]).reshape(len(values))


# ---------------------------------------------------------------------------
# Thrift compact protocol
# ---------------------------------------------------------------------------

T_TRUE, T_FALSE, T_BYTE, T_I16, T_I32, T_I64, T_DOUBLE, T_BINARY, T_LIST, \
    T_SET, T_MAP, T_STRUCT = range(1, 13)


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _tvalue(t: int, v) -> bytes:
    if t in (T_I16, T_I32, T_I64):
        return _varint(_zigzag(int(v)))
    if t == T_BYTE:
        return struct.pack("<b", v)
    if t == T_BINARY:
        b = v.encode() if isinstance(v, str) else bytes(v)
        return _varint(len(b)) + b
    if t == T_STRUCT:
        return v                        # an encoded struct
    if t == T_LIST:
        et, items = v
        n = len(items)
        head = bytes([(n << 4) | et]) if n < 15 else \
            bytes([0xF0 | et]) + _varint(n)
        return head + b"".join(_tvalue(et, x) for x in items)
    if t == T_DOUBLE:
        return struct.pack("<d", v)
    raise ValueError(f"thrift type {t}")


def tstruct(*fields: tuple[int, int, object]) -> bytes:
    """Encode a struct from (field id, type, value); None values are
    omitted, booleans use T_TRUE as their type."""
    out = bytearray()
    last = 0
    for fid, t, v in fields:
        if v is None:
            continue
        if t == T_TRUE:
            t = T_TRUE if v else T_FALSE
        delta = fid - last
        if 0 < delta <= 15:
            out.append((delta << 4) | t)
        else:
            out.append(t)
            out += _varint(_zigzag(fid))
        last = fid
        if t not in (T_TRUE, T_FALSE):
            out += _tvalue(t, v)
    out.append(0)
    return bytes(out)


def _rvarint(buf, pos: int) -> tuple[int, int]:
    b = buf[pos]
    pos += 1
    if b < 0x80:
        return b, pos
    out = b & 0x7F
    shift = 7
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if b < 0x80:
            return out, pos
        shift += 7
        if shift > 70:
            raise ParquetError("varint too long")


def _rvalue(buf, pos: int, t: int):
    """One compact-protocol value of type `t` at `pos`: (value, end)."""
    if t == T_I32 or t == T_I64 or t == T_I16:
        z, pos = _rvarint(buf, pos)
        return (z >> 1) ^ -(z & 1), pos
    if t == T_STRUCT:
        return _rstruct(buf, pos)
    if t == T_BINARY:
        n, pos = _rvarint(buf, pos)
        if pos + n > len(buf):
            raise ParquetError("truncated binary")
        return bytes(buf[pos:pos + n]), pos + n
    if t == T_LIST or t == T_SET:
        head = buf[pos]
        pos += 1
        n, et = head >> 4, head & 0x0F
        if n == 15:
            n, pos = _rvarint(buf, pos)
        out = []
        for _ in range(n):
            if et == T_TRUE or et == T_FALSE:
                v, pos = buf[pos] == 1, pos + 1
            else:
                v, pos = _rvalue(buf, pos, et)
            out.append(v)
        return out, pos
    if t == T_TRUE:
        return True, pos
    if t == T_FALSE:
        return False, pos
    if t == T_BYTE:
        b = buf[pos]
        return (b - 256 if b > 127 else b), pos + 1
    if t == T_DOUBLE:
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if t == T_MAP:
        n, pos = _rvarint(buf, pos)
        out = {}
        if n:
            kv = buf[pos]
            pos += 1
            for _ in range(n):
                k, pos = _rvalue(buf, pos, kv >> 4)
                out[k], pos = _rvalue(buf, pos, kv & 0x0F)
        return out, pos
    raise ParquetError(f"thrift type {t}")


def _rstruct(buf, pos: int) -> tuple[dict, int]:
    """A compact-protocol struct as {field id: value}: (struct, end)."""
    out = {}
    fid = 0
    while True:
        head = buf[pos]
        pos += 1
        if head == 0:
            return out, pos
        delta = head >> 4
        if delta:
            fid += delta
        else:
            z, pos = _rvarint(buf, pos)
            fid = (z >> 1) ^ -(z & 1)
        out[fid], pos = _rvalue(buf, pos, head & 0x0F)


def _decode_struct(buf, pos: int = 0) -> tuple[dict, int]:
    try:
        return _rstruct(buf, pos)
    except (IndexError, struct.error) as e:
        raise ParquetError(f"truncated thrift struct: {e}") from None


# ---------------------------------------------------------------------------
# RLE / bit-packed hybrid
# ---------------------------------------------------------------------------

def bit_width(max_value: int) -> int:
    return int(max_value).bit_length()


def _bitpack(vals: np.ndarray, bw: int) -> bytes:
    """LSB-first bit packing of `vals` (padded to a multiple of 8)."""
    n = len(vals)
    pad = (-n) % 8
    v = np.concatenate([vals.astype(np.uint32), np.zeros(pad, np.uint32)])
    bits = ((v[:, None] >> np.arange(bw, dtype=np.uint32)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(-1), bitorder="little").tobytes()


def _bitunpack(raw, count: int, bw: int) -> np.ndarray:
    bits = np.unpackbits(np.frombuffer(raw, np.uint8), bitorder="little")
    bits = bits[:count * bw].reshape(count, bw).astype(np.uint32)
    return (bits << np.arange(bw, dtype=np.uint32)).sum(1, dtype=np.uint32)


def rle_encode(vals: np.ndarray, bw: int) -> bytes:
    """One RLE run when `vals` is constant, else one bit-packed run."""
    n = len(vals)
    if n == 0:
        return b""
    if bw == 0:
        return _varint(n << 1)
    v0 = int(vals[0])
    if (vals == v0).all():
        return _varint(n << 1) + v0.to_bytes((bw + 7) // 8, "little")
    groups = (n + 7) // 8
    return _varint((groups << 1) | 1) + _bitpack(vals, bw)


def rle_decode(buf, pos: int, end: int, bw: int, count: int) -> np.ndarray:
    """`count` values of the hybrid encoding in buf[pos:end]."""
    if bw == 0:
        return np.zeros(count, np.uint32)
    parts = []
    got = 0
    vbytes = (bw + 7) // 8
    try:
        while got < count:
            if pos >= end:
                raise ParquetError("RLE data ends early")
            head, pos = _rvarint(buf, pos)
            if head & 1:
                nbytes = (head >> 1) * bw
                take = min((head >> 1) * 8, count - got)
                parts.append(_bitunpack(buf[pos:pos + nbytes], take, bw))
                pos += nbytes
            else:
                v = int.from_bytes(buf[pos:pos + vbytes], "little")
                pos += vbytes
                take = min(head >> 1, count - got)
                parts.append(np.full(take, v, np.uint32))
            got += take
    except IndexError:
        raise ParquetError("truncated RLE data") from None
    out = np.concatenate(parts) if len(parts) != 1 else parts[0]
    if len(out) != count:
        raise ParquetError("RLE data short")
    return out


# ---------------------------------------------------------------------------
# PLAIN values
# ---------------------------------------------------------------------------

def _plain_bytes(col, typ: str) -> bytes:
    if typ == "string":
        lens = col.lengths()
        if col.valid is not None:
            keep = np.flatnonzero(col.valid)
            col = col.take(keep)
            lens = col.lengths()
        n = len(lens)
        out = np.empty(4 * n + len(col.data), np.uint8)
        # each value is its u32 length, then its bytes
        starts = col.offsets[:-1] + 4 * np.arange(1, n + 1, dtype=np.int64)
        head = (starts - 4)[:, None] + np.arange(4, dtype=np.int64)
        out[head.reshape(-1)] = np.frombuffer(
            lens.astype("<u4").tobytes(), np.uint8)
        dst = np.repeat(starts - col.offsets[:-1], lens) + \
            np.arange(len(col.data), dtype=np.int64)
        out[dst] = col.data
        return out.tobytes()
    if typ == "bool":
        return np.packbits(col.astype(np.uint8), bitorder="little").tobytes()
    if typ == "int8":
        return col.astype("<i4").tobytes()
    if typ.startswith("fixed"):
        return np.ascontiguousarray(col).tobytes()
    return col.astype(col.dtype.newbyteorder("<")).tobytes()


def _plain_decode(raw, typ: str, n: int, width: int = 0):
    if typ == "string":
        return _decode_byte_arrays(raw, n)
    if typ == "bool":
        return np.unpackbits(np.frombuffer(raw, np.uint8),
                             bitorder="little")[:n].astype(bool)
    if typ.startswith("fixed"):
        out = np.frombuffer(raw, np.uint8, n * width).reshape(n, width)
        return out
    if typ == "int8":
        return np.frombuffer(raw, "<i4", n).astype(np.int8)
    dt = {"int32": "<i4", "int64": "<i8", "double": "<f8"}[typ]
    out = np.frombuffer(raw, dt, n)
    if len(out) != n:
        raise ParquetError("PLAIN values short")
    return out


def _decode_byte_arrays(raw, n: int) -> Strings:
    """PLAIN byte arrays: the lengths interleave with the bytes, so one
    pass finds where each value starts; the bytes are then gathered."""
    buf = bytes(raw)
    unpack = struct.Struct("<I").unpack_from
    lens = []
    append = lens.append
    pos = 0
    try:
        for _ in range(n):
            (ln,) = unpack(buf, pos)
            append(ln)
            pos += 4 + ln
    except struct.error:
        raise ParquetError("truncated BYTE_ARRAY values") from None
    if pos > len(buf):
        raise ParquetError("truncated BYTE_ARRAY values")
    lens = np.array(lens, np.int64)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    # value i starts after i + 1 length words and the bytes before it
    starts = offsets[:-1] + 4 * np.arange(1, n + 1, dtype=np.int64)
    src = np.repeat(starts - offsets[:-1], lens) + \
        np.arange(int(offsets[-1]), dtype=np.int64)
    return Strings(offsets, np.frombuffer(buf, np.uint8)[src])


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------

def _leaf_element(name: str, typ: str) -> bytes:
    phys, tlen, conv, logical = _physical(typ)
    return tstruct((1, T_I32, phys), (2, T_I32, tlen), (3, T_I32, OPTIONAL),
                   (4, T_BINARY, name), (6, T_I32, conv),
                   (10, T_STRUCT, logical))


def _physical(typ: str):
    """(physical type, type_length, converted type, logical type)."""
    if typ.startswith("fixed"):
        return FIXED, int(typ[5:]), None, None
    if typ == "string":
        return BYTE_ARRAY, None, CONV_UTF8, tstruct((1, T_STRUCT, tstruct()))
    if typ == "int8":
        return INT32, None, CONV_INT_8, tstruct(
            (10, T_STRUCT, tstruct((1, T_BYTE, 8), (2, T_TRUE, True))))
    return {"int32": INT32, "int64": INT64, "double": DOUBLE,
            "bool": BOOLEAN}[typ], None, None, None


_SCHEMA_CACHE: dict[tuple, list[bytes]] = {}


def _schema_elements(schema: Sequence[tuple[str, str]]) -> list[bytes]:
    """The encoded SchemaElements of a table schema (kept per schema: a
    WAL writes one small file a trace, all with the block schema)."""
    key = tuple(schema)
    got = _SCHEMA_CACHE.get(key)
    if got is None:
        if len(_SCHEMA_CACHE) >= 64:
            _SCHEMA_CACHE.clear()
        got = _SCHEMA_CACHE[key] = _encode_schema(schema)
    return got


def _encode_schema(schema: Sequence[tuple[str, str]]) -> list[bytes]:
    out = [tstruct((4, T_BINARY, "schema"), (5, T_I32, len(schema)))]
    for name, typ in schema:
        if typ.startswith("list<"):
            out.append(tstruct((3, T_I32, OPTIONAL), (4, T_BINARY, name),
                               (5, T_I32, 1), (6, T_I32, CONV_LIST),
                               (10, T_STRUCT, tstruct((3, T_STRUCT,
                                                       tstruct())))))
            out.append(tstruct((3, T_I32, REPEATED), (4, T_BINARY, "list"),
                               (5, T_I32, 1)))
            out.append(_leaf_element("element", typ[5:-1]))
        else:
            _physical(typ)          # raises on an unknown type
            out.append(_leaf_element(name, typ))
    return out


class _Leaf:
    """One leaf column of a file: its top-level field, type string, path,
    levels and physical type."""

    __slots__ = ("field", "typ", "path", "max_def", "max_rep", "phys",
                 "width", "inner", "empty_def")

    def __init__(self, field, typ, path, max_def, max_rep, phys, width,
                 inner, empty_def=0):
        self.field, self.typ, self.path = field, typ, path
        self.max_def, self.max_rep = max_def, max_rep
        self.phys, self.width, self.inner = phys, width, inner
        # a list's definition level when it is present but empty
        self.empty_def = empty_def


def _leaf_type(el: dict) -> str:
    phys = el.get(1)
    logical = el.get(10) or {}
    conv = el.get(6)
    if phys == FIXED:
        return f"fixed{el.get(2)}"
    if phys == BYTE_ARRAY and (conv == CONV_UTF8 or 1 in logical):
        return "string"
    if phys == INT32:
        bits = (logical.get(10) or {}).get(1)
        if bits == 8 or conv == CONV_INT_8:
            return "int8"
        return "int32"
    if phys == INT64:
        return "int64"
    if phys == DOUBLE:
        return "double"
    if phys == BOOLEAN:
        return "bool"
    raise NotImplementedError(
        f"Parquet column {el.get(4, b'?').decode()}: physical type {phys} "
        f"with converted type {conv} is not read (the block schema's types "
        f"only)")


def _parse_schema(elements: list[dict]) -> tuple[list[tuple[str, str]],
                                                  list[_Leaf]]:
    """Top-level (name, type string) fields and the leaves in column
    order. Flat optional or required leaves and 3-level LIST groups."""
    schema, leaves = [], []
    i = 1
    n_top = elements[0].get(5, 0)
    for _ in range(n_top):
        el = elements[i]
        name = el[4].decode()
        rep = el.get(3, REQUIRED)
        d = 1 if rep == OPTIONAL else 0
        if el.get(5):                    # a group: must be a LIST
            mid = elements[i + 1]
            leaf = elements[i + 2] if i + 2 < len(elements) else {}
            if el.get(5) != 1 or mid.get(3) != REPEATED or mid.get(5) != 1 \
                    or leaf.get(5):
                raise NotImplementedError(
                    f"Parquet group {name!r}: only 3-level LIST groups are "
                    f"read")
            inner = _leaf_type(leaf)
            empty = d
            d += 1 + (1 if leaf.get(3, REQUIRED) == OPTIONAL else 0)
            typ = f"list<{inner}>"
            leaves.append(_Leaf(name, typ, (name, mid[4].decode(),
                                            leaf[4].decode()), d, 1,
                                leaf.get(1), leaf.get(2) or 0, inner, empty))
            i += 3
        else:
            typ = _leaf_type(el)
            leaves.append(_Leaf(name, typ, (name,), d, 0, el.get(1),
                                el.get(2) or 0, typ))
            i += 1
        schema.append((name, typ))
    return schema, leaves


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

def _row_costs(col, typ: str) -> np.ndarray:
    """Approximate encoded bytes of each row, for cutting pages."""
    if isinstance(col, Lists):
        inner = _row_costs(col.values, typ[5:-1])
        cs = np.zeros(len(inner) + 1, np.int64)
        np.cumsum(inner, out=cs[1:])
        return cs[col.offsets[1:]] - cs[col.offsets[:-1]] + 1
    if isinstance(col, Strings):
        return col.lengths() + 4
    width = col.shape[1] if col.ndim == 2 else max(col.dtype.itemsize, 4)
    return np.full(len(col), width, np.int64)


def _total_cost(col) -> int:
    """An upper bound of a column's encoded value bytes (no per-row work)."""
    if isinstance(col, Lists):
        return _total_cost(col.values) + len(col)
    if isinstance(col, Strings):
        return len(col.data) + 4 * len(col)
    width = col.shape[1] if col.ndim == 2 else max(col.dtype.itemsize, 4)
    return width * len(col)


def _page_rows(col, typ: str, page_bytes: int) -> list[tuple[int, int]]:
    n = len(col)
    if n == 0 or _total_cost(col) <= page_bytes:
        return [(0, n)]
    cs = np.cumsum(_row_costs(col, typ))
    cuts = [0]
    while cuts[-1] < n:
        base = cs[cuts[-1] - 1] if cuts[-1] else 0
        hi = int(np.searchsorted(cs, base + page_bytes, side="right"))
        cuts.append(max(hi, cuts[-1] + 1))
    cuts[-1] = n
    return list(zip(cuts[:-1], cuts[1:]))


def _levels(col, typ: str):
    """(rep levels or None, def levels, the non-null values) of a column
    slice, for a max definition level of 1 (flat) or 3 (list)."""
    if isinstance(col, Lists):
        lens = np.diff(col.offsets)
        n_rows = len(lens)
        slots = np.maximum(lens, 1)
        total = int(slots.sum())
        first = np.zeros(total, bool)
        if n_rows:
            starts = np.zeros(n_rows, np.int64)
            np.cumsum(slots[:-1], out=starts[1:])
            first[starts] = True
        rep = np.where(first, 0, 1).astype(np.uint32)
        defs = np.full(total, 3, np.uint32)
        if n_rows:
            defs[starts[lens == 0]] = 1
        values = col.values
        if isinstance(values, Strings) and values.valid is not None:
            raise ValueError("null list elements are not written")
        return rep, defs, values
    if isinstance(col, Strings) and col.valid is not None:
        return None, col.valid.astype(np.uint32), col
    return None, np.ones(len(col), np.uint32), col


def _compress(body: bytes, codec: int) -> bytes:
    return body if codec == 0 else zlib.compress(body, 6, 31)   # gzip


def _page_header(uncompressed: int, compressed: int, n_values: int) -> bytes:
    """PageHeader{DATA_PAGE, sizes, DataPageHeader{n, PLAIN, RLE, RLE}}."""
    return b"".join((
        b"\x15\x00\x15", _varint(uncompressed << 1), b"\x15",
        _varint(compressed << 1), b"\x2c\x15", _varint(n_values << 1),
        b"\x15\x00\x15\x06\x15\x06\x00\x00"))


_CHUNK_HEADS: dict[tuple, bytes] = {}


def _chunk_head(name: str, typ: str, codec: int) -> bytes:
    """ColumnMetaData fields 1-4 (type, encodings, path, codec), which a
    column keeps in every file."""
    key = (name, typ, codec)
    got = _CHUNK_HEADS.get(key)
    if got is None:
        if len(_CHUNK_HEADS) >= 1024:
            _CHUNK_HEADS.clear()
        inner = typ[5:-1] if typ.startswith("list<") else typ
        path = [name, "list", "element"] if typ.startswith("list<") else [name]
        got = _CHUNK_HEADS[key] = tstruct(
            (1, T_I32, _physical(inner)[0]),
            (2, T_LIST, (T_I32, [ENC_PLAIN, ENC_RLE])),
            (3, T_LIST, (T_BINARY, path)),
            (4, T_I32, codec))[:-1]                  # without its stop
    return got


def _write_chunk(out: bytearray, col, name: str, typ: str, codec: int,
                 page_bytes: int) -> tuple[bytes, int]:
    """Append one column chunk's pages to `out`; returns its ColumnChunk
    struct and its uncompressed bytes."""
    inner = typ[5:-1] if typ.startswith("list<") else typ
    max_def = 3 if typ.startswith("list<") else 1
    start = len(out)
    n_values = 0
    uncompressed = 0
    for lo, hi in _page_rows(col, typ, page_bytes):
        rep, defs, values = _levels(_slice(col, lo, hi), typ)
        body = bytearray()
        if rep is not None:
            enc = rle_encode(rep, 1)
            body += struct.pack("<I", len(enc)) + enc
        enc = rle_encode(defs, bit_width(max_def))
        body += struct.pack("<I", len(enc)) + enc
        body += _plain_bytes(values, inner)
        comp = _compress(bytes(body), codec)
        header = _page_header(len(body), len(comp), len(defs))
        out += header
        out += comp
        n_values += len(defs)
        uncompressed += len(header) + len(body)
    # fields 5-7 and 9 (delta 2) as i64, then the stop
    meta = b"".join((_chunk_head(name, typ, codec), b"\x16",
                     _varint(n_values << 1), b"\x16",
                     _varint(uncompressed << 1), b"\x16",
                     _varint((len(out) - start) << 1), b"\x26",
                     _varint(start << 1), b"\x00"))
    return b"".join((b"\x26", _varint(start << 1), b"\x1c", meta,
                     b"\x00")), uncompressed


def write_table(table: ColumnTable, *, compression: str = "gzip",
                row_groups: Iterable[tuple[int, int]] | None = None,
                page_bytes: int = PAGE_BYTES) -> bytes:
    """Encode `table` as one Parquet file; `row_groups` are row ranges
    (default: one row group of every row)."""
    codec = codec_id(compression)
    n = table.num_rows
    ranges = list(row_groups) if row_groups is not None else \
        ([(0, n)] if n else [])
    out = bytearray(MAGIC)
    rg_structs = []
    for ordinal, (lo, hi) in enumerate(ranges):
        part = table.slice(lo, hi)
        rg_start = len(out)
        chunks, total = [], 0
        for name, typ in table.schema:
            chunk, size = _write_chunk(out, part.columns[name], name, typ,
                                       codec, page_bytes)
            chunks.append(chunk)
            total += size
        rg_structs.append(tstruct(
            (1, T_LIST, (T_STRUCT, chunks)), (2, T_I64, total),
            (3, T_I64, hi - lo), (5, T_I64, rg_start),
            (6, T_I64, len(out) - rg_start), (7, T_I16, ordinal)))
    footer = tstruct(
        (1, T_I32, 1),
        (2, T_LIST, (T_STRUCT, _schema_elements(table.schema))),
        (3, T_I64, n),
        (4, T_LIST, (T_STRUCT, rg_structs)),
        (6, T_BINARY, CREATED_BY))
    out += footer
    out += struct.pack("<I", len(footer)) + MAGIC
    return bytes(out)


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------

class ParquetFile:
    """A Parquet file read through `read_range(offset, length) -> bytes`
    (or from bytes): the footer once, then only the column chunks of the
    row groups and columns asked for."""

    def __init__(self, source: bytes | Callable[[int, int], bytes],
                 size: int | None = None) -> None:
        if isinstance(source, (bytes, bytearray, memoryview)):
            data = bytes(source)
            self._read = lambda off, n: data[off:off + n]
            size = len(data)
        else:
            self._read = source
            if size is None:
                raise ValueError("a range reader needs the file size")
        self.size = int(size)
        if self.size < 12:
            raise ParquetError(f"{self.size} bytes: too short for Parquet")
        tail_n = min(self.size, 64 << 10)
        tail = self._read(self.size - tail_n, tail_n)
        if len(tail) != tail_n or tail[-4:] != MAGIC:
            raise ParquetError("no PAR1 footer magic")
        flen = struct.unpack_from("<I", tail, tail_n - 8)[0]
        if flen + 8 > self.size - 4:
            raise ParquetError(f"footer length {flen} beyond the file")
        if flen + 8 > tail_n:
            tail = self._read(self.size - 8 - flen, flen + 8)
        footer = tail[len(tail) - 8 - flen:len(tail) - 8]
        meta, _ = _decode_struct(footer)
        try:
            self.num_rows = int(meta[3])
            self.schema, self._leaves = _parse_schema(meta[2])
            self._row_groups = meta.get(4, [])
        except (KeyError, IndexError, TypeError, AttributeError) as e:
            raise ParquetError(f"malformed FileMetaData: {e!r}") from None

    @property
    def num_row_groups(self) -> int:
        return len(self._row_groups)

    @property
    def names(self) -> list[str]:
        return [n for n, _ in self.schema]

    def row_group_bytes(self, i: int) -> int:
        """Uncompressed size of row group `i` (`RowGroup.total_byte_size`)."""
        return int(self._row_groups[i].get(2, 0))

    def column_chunk_sizes(self, i: int) -> list[tuple[str, int, int]]:
        """(dotted path in the schema, compressed bytes, uncompressed
        bytes) of each column chunk of row group `i`, from its
        `ColumnMetaData` (what pyarrow's `metadata.row_group(i)` reports)."""
        out = []
        for chunk in self._row_groups[i][1]:
            cm = chunk[3]
            path = ".".join(p.decode() if isinstance(p, bytes) else str(p)
                            for p in cm[3])
            out.append((path, int(cm[7]), int(cm[6])))
        return out

    def read_row_group(self, i: int,
                       columns: Sequence[str] | None = None) -> ColumnTable:
        rg = self._row_groups[i]
        n_rows = int(rg[3])
        want = set(columns) if columns is not None else None
        cols = {}
        for leaf, chunk in zip(self._leaves, rg[1]):
            if want is not None and leaf.field not in want:
                continue
            cols[leaf.field] = self._read_chunk(leaf, chunk[3], n_rows)
        schema = [(n, t) for n, t in self.schema
                  if want is None or n in want]
        return ColumnTable(schema, cols, n_rows)

    def read(self, columns: Sequence[str] | None = None) -> ColumnTable:
        if not self._row_groups:
            schema = [(n, t) for n, t in self.schema
                      if columns is None or n in columns]
            return ColumnTable(schema, {n: column_from_pylist(t, [])
                                        for n, t in schema}, 0)
        return ColumnTable.concat([self.read_row_group(i, columns)
                                   for i in range(self.num_row_groups)])

    # -- column chunks -----------------------------------------------------

    def _read_chunk(self, leaf: _Leaf, meta: dict, n_rows: int):
        codec = meta[4]
        if codec not in (0, 2):
            name = CODEC_NAMES.get(codec, str(codec))
            raise NotImplementedError(
                f"Parquet column {'.'.join(leaf.path)}: codec {name} is not "
                f"read; the port reads UNCOMPRESSED and GZIP, the codecs "
                f"Python's standard library has")
        start = meta[9]
        if meta.get(11):                 # a dictionary page comes first
            start = min(meta[11], start)
        raw = self._read(start, meta[7])
        if len(raw) != meta[7]:
            raise ParquetError(f"column chunk {'.'.join(leaf.path)} "
                               f"truncated")
        n_values = meta[5]
        got = 0
        pos = 0
        dictionary = None
        defs, reps, vals = [], [], []
        try:
            while got < n_values:
                header, pos = _decode_struct(raw, pos)
                csize = header[3]
                page = raw[pos:pos + csize]
                pos += csize
                ptype = header[1]
                if ptype == PAGE_DATA_V2:
                    raise NotImplementedError(
                        f"Parquet column {'.'.join(leaf.path)}: a "
                        f"DATA_PAGE_V2 page is not read (DataPage V1 only)")
                if ptype == PAGE_INDEX:
                    continue
                body = page if codec == 0 else zlib.decompress(page, 47)
                if len(body) != header[2]:
                    raise ParquetError("page size mismatch")
                if ptype == PAGE_DICTIONARY:
                    dh = header[7]
                    dictionary = _plain_decode(body, leaf.inner, dh[1],
                                               leaf.width)
                    continue
                d, r, v = self._data_page(leaf, header[5], body, dictionary)
                defs.append(d)
                if r is not None:
                    reps.append(r)
                vals.append(v)
                got += len(d)
        except zlib.error as e:
            raise ParquetError(f"bad GZIP page: {e}") from None
        return _assemble(leaf, defs, reps, vals, n_rows)

    def _data_page(self, leaf: _Leaf, dh: dict, body: bytes, dictionary):
        n = dh[1]
        enc = dh[2]
        pos = 0
        reps = None
        if leaf.max_rep:
            if dh[4] != ENC_RLE:
                raise NotImplementedError(
                    f"repetition levels in {ENCODING_NAMES.get(dh[4])}")
            ln = struct.unpack_from("<I", body, pos)[0]
            reps = rle_decode(body, pos + 4, pos + 4 + ln,
                              bit_width(leaf.max_rep), n)
            pos += 4 + ln
        if leaf.max_def:
            if dh[3] != ENC_RLE:
                raise NotImplementedError(
                    f"definition levels in {ENCODING_NAMES.get(dh[3])}")
            ln = struct.unpack_from("<I", body, pos)[0]
            defs = rle_decode(body, pos + 4, pos + 4 + ln,
                              bit_width(leaf.max_def), n)
            pos += 4 + ln
        else:
            defs = np.zeros(n, np.uint32)
        n_present = int((defs == leaf.max_def).sum())
        rest = body[pos:]
        if enc == ENC_PLAIN:
            values = _plain_decode(rest, leaf.inner, n_present, leaf.width)
        elif enc in (ENC_PLAIN_DICTIONARY, ENC_RLE_DICTIONARY):
            if dictionary is None:
                raise ParquetError("dictionary-encoded page with no "
                                   "dictionary page")
            bw = rest[0] if len(rest) else 0
            idx = rle_decode(rest, 1, len(rest), bw, n_present).astype(
                np.int64)
            values = _take(dictionary, idx)
        else:
            raise NotImplementedError(
                f"Parquet column {'.'.join(leaf.path)}: values in "
                f"{ENCODING_NAMES.get(enc, enc)} are not read")
        return defs, reps, values


def _assemble(leaf: _Leaf, defs: list, reps: list, vals: list, n_rows: int):
    """Columns of the module docstring from each page's levels and
    values."""
    if not vals:
        if n_rows:
            raise ParquetError(f"column {leaf.field}: no pages for {n_rows} "
                               f"rows")
        return column_from_pylist(leaf.typ, [])
    values = _concat(vals) if len(vals) > 1 else vals[0]
    d = np.concatenate(defs) if len(defs) > 1 else defs[0]
    if not leaf.max_rep:
        if leaf.max_def == 0 or (d == leaf.max_def).all():
            return values
        valid = d == leaf.max_def
        if leaf.inner != "string":
            raise NotImplementedError(
                f"Parquet column {leaf.field}: null {leaf.inner} values "
                f"are not read (only strings may be null)")
        lens = np.zeros(len(d), np.int64)
        lens[valid] = values.lengths()
        offsets = np.zeros(len(d) + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        return Strings(offsets, values.data, valid)
    r = np.concatenate(reps) if len(reps) > 1 else reps[0]
    present = d == leaf.max_def
    if ((d > leaf.empty_def) & ~present).any():
        raise NotImplementedError(
            f"Parquet column {leaf.field}: null list elements are not read")
    if (d < leaf.empty_def).any():
        raise NotImplementedError(
            f"Parquet column {leaf.field}: null lists are not read")
    row_start = np.flatnonzero(r == 0)
    if len(row_start) != n_rows:
        raise ParquetError(f"column {leaf.field}: {len(row_start)} rows of "
                           f"{n_rows}")
    counts = np.add.reduceat(present.astype(np.int64), row_start) \
        if n_rows else np.zeros(0, np.int64)
    offsets = np.zeros(n_rows + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    return Lists(offsets, values)


def read_table(data: bytes, columns: Sequence[str] | None = None
               ) -> ColumnTable:
    return ParquetFile(data).read(columns)
