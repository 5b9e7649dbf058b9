"""Minimal protobuf wire-format codec (no generated code, no schema files).

Plays the role of the reference's generated `pkg/tempopb` marshaling for the
two external protobuf schemas we must speak on the wire:

- decode: OTLP `ExportTraceServiceRequest` (opentelemetry-proto trace.proto,
  a stable public schema) — see tempo_tpu_torch.model.otlp.
- encode: Prometheus remote-write `WriteRequest` — see
  tempo_tpu_torch.generator.remote_write.

Only the features those schemas need are implemented: varint, fixed64/32,
length-delimited. Messages decode into {field_number: [values]} dicts; the
caller interprets fields by number.
"""

from __future__ import annotations

import struct

WT_VARINT, WT_FIXED64, WT_LEN, WT_SGROUP, WT_EGROUP, WT_FIXED32 = 0, 1, 2, 3, 4, 5


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------

def read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a serialized message.

    LEN fields yield memoryview slices (zero-copy); numeric fields yield ints.
    """
    view = memoryview(buf)
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = read_varint(buf, pos)
        fnum, wt = key >> 3, key & 7
        if wt == WT_VARINT:
            val, pos = read_varint(buf, pos)
        elif wt == WT_FIXED64:
            val = int.from_bytes(view[pos:pos + 8], "little")
            pos += 8
        elif wt == WT_FIXED32:
            val = int.from_bytes(view[pos:pos + 4], "little")
            pos += 4
        elif wt == WT_LEN:
            ln, pos = read_varint(buf, pos)
            val = view[pos:pos + ln]
            pos += ln
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield fnum, wt, val


def decode_fields(buf: bytes) -> dict[int, list]:
    out: dict[int, list] = {}
    for fnum, _, val in iter_fields(buf):
        out.setdefault(fnum, []).append(val)
    return out


def zigzag_decode(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def f64(v: int) -> float:
    return struct.unpack("<d", v.to_bytes(8, "little"))[0]


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------

def enc_varint(v: int) -> bytes:
    out = bytearray()
    if v < 0:
        v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def enc_tag(fnum: int, wt: int) -> bytes:
    return enc_varint((fnum << 3) | wt)


def enc_field_varint(fnum: int, v: int) -> bytes:
    return enc_tag(fnum, WT_VARINT) + enc_varint(v)


def enc_field_double(fnum: int, v: float) -> bytes:
    return enc_tag(fnum, WT_FIXED64) + struct.pack("<d", v)


def enc_field_fixed64(fnum: int, v: int) -> bytes:
    return enc_tag(fnum, WT_FIXED64) + v.to_bytes(8, "little")


def enc_field_bytes(fnum: int, v: bytes) -> bytes:
    return enc_tag(fnum, WT_LEN) + enc_varint(len(v)) + v


def enc_field_str(fnum: int, v: str) -> bytes:
    return enc_field_bytes(fnum, v.encode("utf-8"))


def enc_field_msg(fnum: int, v: bytes) -> bytes:
    return enc_field_bytes(fnum, v)
