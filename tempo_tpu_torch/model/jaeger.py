"""Jaeger ingest: thrift-over-HTTP collector payloads → span dicts.

The reference hosts a jaeger receiver inside the distributor's OTel shim
(`modules/distributor/receiver/shim.go:165-171`); Jaeger SDK reporters
POST a TBinaryProtocol-encoded `jaeger.thrift` Batch to
`/api/traces` with content-type application/x-thrift. This module is a
from-scratch minimal TBinaryProtocol reader for exactly the structures in
the public jaeger.thrift IDL (Batch/Process/Span/Tag/SpanRef/Log) plus
the OTel semantic mapping (span.kind / error tags → kind/status), the
same translation the jaeger receiver performs before handing ptraces to
the distributor.

Counterpart of `tempo_tpu/model/jaeger.py`, host code copied with its imports
moved to the port; it runs no device code of its own.
"""

from __future__ import annotations

import struct
from typing import Any, Iterator

# thrift TBinaryProtocol type ids
T_STOP, T_BOOL, T_BYTE, T_DOUBLE = 0, 2, 3, 4
T_I16, T_I32, T_I64, T_STRING = 6, 8, 10, 11
T_STRUCT, T_MAP, T_SET, T_LIST = 12, 13, 14, 15

_KIND_FROM_STR = {"unspecified": 0, "internal": 1, "server": 2,
                  "client": 3, "producer": 4, "consumer": 5}


class _R:
    """Cursor over TBinaryProtocol bytes."""

    __slots__ = ("b", "i")

    def __init__(self, b: bytes):
        self.b = b
        self.i = 0

    def u8(self) -> int:
        v = self.b[self.i]
        self.i += 1
        return v

    def i16(self) -> int:
        v = struct.unpack_from(">h", self.b, self.i)[0]
        self.i += 2
        return v

    def i32(self) -> int:
        v = struct.unpack_from(">i", self.b, self.i)[0]
        self.i += 4
        return v

    def i64(self) -> int:
        v = struct.unpack_from(">q", self.b, self.i)[0]
        self.i += 8
        return v

    def f64(self) -> float:
        v = struct.unpack_from(">d", self.b, self.i)[0]
        self.i += 8
        return v

    def raw(self) -> bytes:
        n = self.i32()
        if n < 0 or self.i + n > len(self.b):
            raise ValueError("thrift string overruns buffer")
        v = self.b[self.i:self.i + n]
        self.i += n
        return v

    # minimum wire bytes per element of each type (guards collection
    # counts: an attacker-supplied count must fit the remaining buffer
    # before any loop runs, or a tiny payload spins for billions of steps)
    _MIN = {T_BOOL: 1, T_BYTE: 1, T_DOUBLE: 8, T_I16: 2, T_I32: 4,
            T_I64: 8, T_STRING: 4, T_STRUCT: 1, T_MAP: 6, T_SET: 5,
            T_LIST: 5}

    def count(self, elem_type: int) -> int:
        n = self.i32()
        per = self._MIN.get(elem_type)
        if per is None:
            raise ValueError(f"unknown thrift type {elem_type}")
        if n < 0 or n * per > len(self.b) - self.i:
            raise ValueError("thrift collection count overruns buffer")
        return n

    def skip(self, t: int, depth: int = 0) -> None:
        if depth > 64:
            # hostile nesting must be a 400, not a RecursionError/500
            raise ValueError("thrift nesting too deep")
        if t == T_BOOL or t == T_BYTE:
            self.i += 1
        elif t == T_I16:
            self.i += 2
        elif t == T_I32:
            self.i += 4
        elif t in (T_I64, T_DOUBLE):
            self.i += 8
        elif t == T_STRING:
            self.raw()
        elif t == T_STRUCT:
            while True:
                ft = self.u8()
                if ft == T_STOP:
                    break
                self.i16()
                self.skip(ft, depth + 1)
        elif t in (T_LIST, T_SET):
            et = self.u8()
            for _ in range(self.count(et)):
                self.skip(et, depth + 1)
        elif t == T_MAP:
            kt, vt = self.u8(), self.u8()
            n = self.count(kt)
            if n * self._MIN[vt] > len(self.b) - self.i:
                raise ValueError("thrift map count overruns buffer")
            for _ in range(n):
                self.skip(kt, depth + 1)
                self.skip(vt, depth + 1)
        else:
            raise ValueError(f"unknown thrift type {t}")

    def fields(self) -> Iterator[tuple[int, int]]:
        """Yield (field_id, type) until STOP; caller reads or skips."""
        while True:
            ft = self.u8()
            if ft == T_STOP:
                return
            yield self.i16(), ft


def _read_tag(r: _R) -> tuple[str, Any]:
    key, vtype = "", 0
    vstr: bytes = b""
    vdouble, vbool, vlong = 0.0, False, 0
    vbin: bytes = b""
    for fid, ft in r.fields():
        if fid == 1 and ft == T_STRING:
            key = r.raw().decode("utf-8", "replace")
        elif fid == 2 and ft == T_I32:
            vtype = r.i32()
        elif fid == 3 and ft == T_STRING:
            vstr = r.raw()
        elif fid == 4 and ft == T_DOUBLE:
            vdouble = r.f64()
        elif fid == 5 and ft == T_BOOL:
            vbool = r.u8() != 0
        elif fid == 6 and ft == T_I64:
            vlong = r.i64()
        elif fid == 7 and ft == T_STRING:
            vbin = r.raw()
        else:
            r.skip(ft)
    val: Any
    if vtype == 0:
        val = vstr.decode("utf-8", "replace")
    elif vtype == 1:
        val = vdouble
    elif vtype == 2:
        val = vbool
    elif vtype == 3:
        val = vlong
    else:
        val = vbin
    return key, val


def _read_tags(r: _R) -> dict[str, Any]:
    et = r.u8()
    n = r.count(et)
    out: dict[str, Any] = {}
    for _ in range(n):
        if et == T_STRUCT:
            k, v = _read_tag(r)
            out[k] = v
        else:
            r.skip(et)
    return out


def _intrinsics_from_tags(attrs: dict) -> tuple[int, int]:
    """(kind, status_code) from OTel-mapped jaeger tags — span.kind is
    POPPED from attrs; error/otel.status_code stay (the translator keeps
    them). Shared by the thrift and api_v2-proto decoders so the two
    receiver protocols can never diverge on the mapping."""
    kind = 0
    sk = attrs.pop("span.kind", None)
    if isinstance(sk, str):
        kind = _KIND_FROM_STR.get(sk.lower(), 0)
    status_code = 0
    err = attrs.get("error")
    if err is True or (isinstance(err, str) and err.lower() == "true"):
        status_code = 2            # STATUS_CODE_ERROR, like the translator
    otel_status = attrs.get("otel.status_code")
    if isinstance(otel_status, str):
        status_code = {"OK": 1, "ERROR": 2}.get(otel_status.upper(),
                                                status_code)
    return kind, status_code



def _span_dict(tid_hi: int, tid_lo: int, sid: int, psid: int, name: str,
               start_us: int, dur_us: int, attrs: dict) -> dict:
    """Shared span-dict epilogue for the thrift decoders (binary +
    compact agent — the api_v2 proto path carries ids as bytes and times
    in ns, so it shares only `_intrinsics_from_tags`): one place owns the
    id packing and the µs→ns mapping, so the wire forms cannot diverge."""
    kind, status_code = _intrinsics_from_tags(attrs)
    u64 = lambda v: v & ((1 << 64) - 1)
    start_ns = start_us * 1000
    return {
        "trace_id": struct.pack(">QQ", u64(tid_hi), u64(tid_lo)),
        "span_id": struct.pack(">Q", u64(sid)),
        "parent_span_id": struct.pack(">Q", u64(psid)) if psid else b"",
        "name": name,
        "service": "",
        "kind": kind,
        "status_code": status_code,
        "start_unix_nano": start_ns,
        "end_unix_nano": start_ns + dur_us * 1000,
        "attrs": attrs,
        "res_attrs": None,
    }


def _patch_batch(out: list, service: str, res_attrs: dict) -> list:
    """Apply the Batch's Process (service + resource tags) to its spans."""
    res_attrs = dict(res_attrs)
    res_attrs.setdefault("service.name", service)
    for s in out:
        s["service"] = service
        s["res_attrs"] = res_attrs
    return out


def _read_span(r: _R) -> dict:
    """One jaeger.thrift Span → span dict (service/res_attrs patched in by
    the caller once the Process struct is known)."""
    tid_lo = tid_hi = sid = psid = 0
    name = ""
    start_us = dur_us = 0
    attrs: dict[str, Any] = {}
    for fid, ft in r.fields():
        if fid == 1 and ft == T_I64:
            tid_lo = r.i64()
        elif fid == 2 and ft == T_I64:
            tid_hi = r.i64()
        elif fid == 3 and ft == T_I64:
            sid = r.i64()
        elif fid == 4 and ft == T_I64:
            psid = r.i64()
        elif fid == 5 and ft == T_STRING:
            name = r.raw().decode("utf-8", "replace")
        elif fid == 8 and ft == T_I64:
            start_us = r.i64()
        elif fid == 9 and ft == T_I64:
            dur_us = r.i64()
        elif fid == 10 and ft == T_LIST:
            attrs = _read_tags(r)
        else:
            r.skip(ft)

    return _span_dict(tid_hi, tid_lo, sid, psid, name, start_us, dur_us,
                      attrs)


def spans_from_jaeger_thrift(data: bytes) -> list[dict]:
    """Decode one TBinaryProtocol `jaeger.thrift` Batch into span dicts.

    One pass: spans decode as encountered, and the Process struct
    (service name + resource tags) patches them afterwards, so a
    Process-after-spans field order costs nothing extra. Raises ValueError
    on malformed bytes (the receiver maps it to 400)."""
    try:
        r = _R(data)
        service = ""
        res_attrs: dict[str, Any] = {}
        out: list[dict] = []
        for fid, ft in r.fields():
            if fid == 1 and ft == T_STRUCT:       # Process
                for pfid, pft in r.fields():
                    if pfid == 1 and pft == T_STRING:
                        service = r.raw().decode("utf-8", "replace")
                    elif pfid == 2 and pft == T_LIST:
                        res_attrs = _read_tags(r)
                    else:
                        r.skip(pft)
            elif fid == 2 and ft == T_LIST:       # spans
                et = r.u8()
                n = r.count(et)
                if n and et != T_STRUCT:
                    raise ValueError("Batch.spans must hold structs")
                for _ in range(n):
                    out.append(_read_span(r))
            else:
                r.skip(ft)
        return _patch_batch(out, service, res_attrs)
    except (struct.error, IndexError) as e:
        raise ValueError(f"malformed jaeger thrift payload: {e}") from None


# -- jaeger api_v2 protobuf (model.proto) -----------------------------------
#
# The gRPC collector variant (`jaeger.api_v2.CollectorService/PostSpans`,
# ref `modules/distributor/receiver/shim.go:165-171` jaeger receiver
# protocols). Same span-dict mapping as the thrift path above; the wire is
# protobuf Batch{spans=1, process=2} instead of TBinaryProtocol.

def _pb_ts_ns(buf: bytes) -> int:
    """Timestamp/Duration {seconds=1, nanos=2} → nanoseconds."""
    from tempo_tpu_torch.model.proto_wire import iter_fields

    sec = nanos = 0
    for fnum, wt, val in iter_fields(buf):
        if fnum == 1 and wt == 0:
            sec = val
        elif fnum == 2 and wt == 0:
            nanos = val
    return sec * 1_000_000_000 + nanos


def _pb_keyvalues(bufs: list) -> dict:
    """repeated model.KeyValue → attrs dict (typed like the thrift tags)."""
    from tempo_tpu_torch.model.proto_wire import f64, iter_fields

    out: dict[str, Any] = {}
    for kv in bufs:
        key = ""
        vtype = 0
        vals: dict[int, Any] = {}
        for fnum, wt, val in iter_fields(kv):
            if fnum == 1 and wt == 2:
                key = bytes(val).decode("utf-8", "replace")
            elif fnum == 2 and wt == 0:
                vtype = val
            elif fnum in (3, 7) and wt == 2:
                vals[fnum] = val
            elif fnum in (4, 5) and wt == 0:
                vals[fnum] = val
            elif fnum == 6 and wt == 1:
                vals[fnum] = f64(val)
        if not key:
            continue
        if vtype == 1:
            out[key] = bool(vals.get(4, 0))
        elif vtype == 2:
            v = vals.get(5, 0)
            out[key] = v - (1 << 64) if v >= (1 << 63) else v
        elif vtype == 3:
            out[key] = float(vals.get(6, 0.0))
        elif vtype == 4:
            out[key] = bytes(vals.get(7) or b"").hex()
        else:
            out[key] = bytes(vals.get(3) or b"").decode("utf-8", "replace")
    return out


def _pb_process(buf: bytes) -> tuple[str, dict]:
    from tempo_tpu_torch.model.proto_wire import decode_fields

    f = decode_fields(buf)
    service = bytes(f.get(1, [b""])[0] or b"").decode("utf-8", "replace") \
        if f.get(1) else ""
    return service, _pb_keyvalues(f.get(2, []))


def _pb_span(buf: bytes) -> dict:
    from tempo_tpu_torch.model.proto_wire import decode_fields, iter_fields

    f = decode_fields(buf)
    tid = bytes(f.get(1, [b""])[0] or b"")
    sid = bytes(f.get(2, [b""])[0] or b"")
    name = bytes(f.get(3, [b""])[0] or b"").decode("utf-8", "replace") \
        if f.get(3) else ""
    psid = b""
    for ref in f.get(4, []):
        r_sid = b""
        r_type = 0
        for fnum, wt, val in iter_fields(ref):
            if fnum == 2 and wt == 2:
                r_sid = bytes(val)
            elif fnum == 3 and wt == 0:
                r_type = val
        if r_type == 0 and r_sid:                 # CHILD_OF
            psid = r_sid
    start_ns = _pb_ts_ns(f[6][0]) if f.get(6) else 0
    dur_ns = _pb_ts_ns(f[7][0]) if f.get(7) else 0
    attrs = _pb_keyvalues(f.get(8, []))
    service = ""
    res_attrs: "dict | None" = None
    if f.get(10):                                 # per-span Process override
        service, tags = _pb_process(f[10][0])
        res_attrs = dict(tags)
        res_attrs.setdefault("service.name", service)

    kind, status_code = _intrinsics_from_tags(attrs)
    return {
        "trace_id": tid, "span_id": sid,
        "parent_span_id": psid,
        "name": name, "service": service, "kind": kind,
        "status_code": status_code,
        "start_unix_nano": start_ns,
        "end_unix_nano": start_ns + dur_ns,
        "attrs": attrs, "res_attrs": res_attrs,
    }


def spans_from_jaeger_proto(data: bytes, wrapped: bool = True) -> list[dict]:
    """Decode one api_v2 `PostSpansRequest` (wrapped=True; its field 1 is
    the Batch) or a bare `Batch` into span dicts. Raises ValueError on
    malformed bytes."""
    from tempo_tpu_torch.model.proto_wire import decode_fields

    try:
        f = decode_fields(data)
        if wrapped:
            f = decode_fields(f[1][0]) if f.get(1) else {}
        service = ""
        res_attrs: dict[str, Any] = {}
        if f.get(2):
            service, res_attrs = _pb_process(f[2][0])
        out = [_pb_span(b) for b in f.get(1, [])]
        base = dict(res_attrs)
        base.setdefault("service.name", service)
        for s in out:
            if s["res_attrs"] is None:            # batch Process applies
                s["service"] = service
                s["res_attrs"] = base
            elif not s["service"]:
                s["service"] = s["res_attrs"].get("service.name", "")
        return out
    except (ValueError, TypeError, struct.error, IndexError, KeyError) as e:
        # TypeError: a message-typed field encoded as a varint decodes to
        # int and memoryview()/iter_fields() reject it
        raise ValueError(f"malformed jaeger proto payload: {e}") from None


__all__ = ["spans_from_jaeger_thrift", "spans_from_jaeger_proto",
           "spans_from_jaeger_agent"]


# -- jaeger agent UDP (TCompactProtocol Agent.emitBatch) ---------------------
#
# The deprecated-but-still-deployed jaeger agent path: clients fire
# one-way `Agent.emitBatch(Batch)` calls as UDP datagrams on port 6831,
# encoded with the thrift COMPACT protocol (ref
# `modules/distributor/receiver/shim.go:165-171` jaeger protocols map).
# Same span-dict mapping as the binary/protobuf decoders above — the
# three jaeger wire forms cannot diverge because they share
# `_intrinsics_from_tags` and the field semantics below.

_C_BOOL_TRUE, _C_BOOL_FALSE = 1, 2
_C_BYTE, _C_I16, _C_I32, _C_I64, _C_DOUBLE = 3, 4, 5, 6, 7
_C_BINARY, _C_LIST, _C_SET, _C_MAP, _C_STRUCT = 8, 9, 10, 11, 12


class _CR:
    """Cursor over TCompactProtocol bytes."""

    __slots__ = ("b", "i")

    def __init__(self, b: bytes):
        self.b = b
        self.i = 0

    def u8(self) -> int:
        v = self.b[self.i]
        self.i += 1
        return v

    def uvarint(self) -> int:
        out = shift = 0
        while True:
            byte = self.b[self.i]
            self.i += 1
            out |= (byte & 0x7F) << shift
            if not byte & 0x80:
                return out
            shift += 7
            if shift > 70:
                raise ValueError("varint too long")

    def zigzag(self) -> int:
        v = self.uvarint()
        return (v >> 1) ^ -(v & 1)

    def f64(self) -> float:
        # compact doubles are little-endian (the thrift library quirk —
        # opposite of the binary protocol)
        v = struct.unpack_from("<d", self.b, self.i)[0]
        self.i += 8
        return v

    def raw(self) -> bytes:
        n = self.uvarint()
        if self.i + n > len(self.b):
            raise ValueError("binary field overruns datagram")
        v = self.b[self.i:self.i + n]
        self.i += n
        return v

    def fields(self):
        """Yield (field id, compact type) until STOP; short-form ids are
        delta-encoded against the previous field of THIS struct."""
        last = 0
        while True:
            h = self.u8()
            if h == 0:
                return
            delta, ctype = h >> 4, h & 0x0F
            fid = last + delta if delta else self.zigzag()
            last = fid
            yield fid, ctype

    def check_count(self, n: int, elem_type: int, pairs: bool = False
                    ) -> int:
        """Bound an attacker-supplied collection count by the remaining
        datagram bytes BEFORE any loop runs — fixed-size skips (`i += 1`)
        never touch the buffer, so a crafted 13-byte datagram claiming
        2^40 elements would otherwise spin the receiver thread forever
        (remote unauthenticated DoS)."""
        per = 8 if elem_type == _C_DOUBLE else 1
        if pairs:
            per += 1                     # a map entry is >= 2 wire bytes
        if n < 0 or n * per > len(self.b) - self.i:
            raise ValueError("compact collection count overruns datagram")
        return n

    def list_header(self) -> tuple[int, int]:
        h = self.u8()
        n, et = h >> 4, h & 0x0F
        if n == 15:
            n = self.uvarint()
        return self.check_count(n, et), et

    def skip(self, ctype: int, depth: int = 0) -> None:
        if depth > 32:
            raise ValueError("nesting too deep")
        if ctype in (_C_BOOL_TRUE, _C_BOOL_FALSE):
            return                       # value lives in the field header
        if ctype == _C_BYTE:
            self.i += 1
        elif ctype in (_C_I16, _C_I32, _C_I64):
            self.zigzag()
        elif ctype == _C_DOUBLE:
            self.i += 8
        elif ctype == _C_BINARY:
            self.raw()
        elif ctype in (_C_LIST, _C_SET):
            n, et = self.list_header()
            for _ in range(n):
                self.skip_elem(et, depth + 1)
        elif ctype == _C_MAP:
            n = self.uvarint()
            if n:
                kv = self.u8()
                self.check_count(n, kv & 0x0F, pairs=True)
                for _ in range(n):
                    self.skip_elem(kv >> 4, depth + 1)
                    self.skip_elem(kv & 0x0F, depth + 1)
        elif ctype == _C_STRUCT:
            for _fid, ft in self.fields():
                self.skip(ft, depth + 1)
        else:
            raise ValueError(f"bad compact type {ctype}")

    def skip_elem(self, et: int, depth: int = 0) -> None:
        # list/set/map elements: bools take one byte (unlike field bools)
        if et in (_C_BOOL_TRUE, _C_BOOL_FALSE):
            self.i += 1
        else:
            self.skip(et, depth)


def _c_read_tag(r: _CR) -> tuple[str, Any]:
    key, vtype = "", 0
    vstr: bytes = b""
    vdouble, vbool, vlong = 0.0, False, 0
    vbin: bytes = b""
    for fid, ft in r.fields():
        if fid == 1 and ft == _C_BINARY:
            key = r.raw().decode("utf-8", "replace")
        elif fid == 2 and ft == _C_I32:
            vtype = r.zigzag()
        elif fid == 3 and ft == _C_BINARY:
            vstr = r.raw()
        elif fid == 4 and ft == _C_DOUBLE:
            vdouble = r.f64()
        elif fid == 5 and ft in (_C_BOOL_TRUE, _C_BOOL_FALSE):
            vbool = ft == _C_BOOL_TRUE
        elif fid == 6 and ft == _C_I64:
            vlong = r.zigzag()
        elif fid == 7 and ft == _C_BINARY:
            vbin = r.raw()
        else:
            r.skip(ft)
    val: Any
    if vtype == 0:
        val = vstr.decode("utf-8", "replace")
    elif vtype == 1:
        val = vdouble
    elif vtype == 2:
        val = vbool
    elif vtype == 3:
        val = vlong
    else:
        val = vbin
    return key, val


def _c_read_tag_list(r: _CR) -> dict[str, Any]:
    n, et = r.list_header()
    out: dict[str, Any] = {}
    for _ in range(n):
        if et == _C_STRUCT:
            k, v = _c_read_tag(r)
            out[k] = v
        else:
            r.skip_elem(et)
    return out


def _c_read_span(r: _CR) -> dict:
    tid_lo = tid_hi = sid = psid = 0
    name = ""
    start_us = dur_us = 0
    attrs: dict[str, Any] = {}
    for fid, ft in r.fields():
        if fid == 1 and ft == _C_I64:
            tid_lo = r.zigzag()
        elif fid == 2 and ft == _C_I64:
            tid_hi = r.zigzag()
        elif fid == 3 and ft == _C_I64:
            sid = r.zigzag()
        elif fid == 4 and ft == _C_I64:
            psid = r.zigzag()
        elif fid == 5 and ft == _C_BINARY:
            name = r.raw().decode("utf-8", "replace")
        elif fid == 8 and ft == _C_I64:
            start_us = r.zigzag()
        elif fid == 9 and ft == _C_I64:
            dur_us = r.zigzag()
        elif fid == 10 and ft == _C_LIST:
            attrs = _c_read_tag_list(r)
        else:
            r.skip(ft)
    return _span_dict(tid_hi, tid_lo, sid, psid, name, start_us, dur_us,
                      attrs)


def spans_from_jaeger_agent(datagram: bytes) -> list[dict]:
    """Decode one UDP `Agent.emitBatch` datagram (compact protocol) into
    span dicts. Raises ValueError on malformed bytes (the receiver counts
    and drops — UDP has nobody to answer)."""
    try:
        r = _CR(datagram)
        if r.u8() != 0x82:
            raise ValueError("not a compact-protocol message")
        vt = r.u8()
        if (vt & 0x1F) != 1:
            raise ValueError("unsupported compact version")
        if (vt >> 5) not in (1, 4):          # CALL / ONEWAY
            raise ValueError("not a call message")
        r.uvarint()                          # seqid
        if r.raw() != b"emitBatch":
            raise ValueError("not an emitBatch call")
        service = ""
        res_attrs: dict[str, Any] = {}
        out: list[dict] = []
        for fid, ft in r.fields():           # Agent.emitBatch args
            if fid == 1 and ft == _C_STRUCT:     # Batch
                for bfid, bft in r.fields():
                    if bfid == 1 and bft == _C_STRUCT:   # Process
                        for pfid, pft in r.fields():
                            if pfid == 1 and pft == _C_BINARY:
                                service = r.raw().decode("utf-8", "replace")
                            elif pfid == 2 and pft == _C_LIST:
                                res_attrs = _c_read_tag_list(r)
                            else:
                                r.skip(pft)
                    elif bfid == 2 and bft == _C_LIST:   # spans
                        n, et = r.list_header()
                        if n and et != _C_STRUCT:
                            raise ValueError("Batch.spans must hold structs")
                        for _ in range(n):
                            out.append(_c_read_span(r))
                    else:
                        r.skip(bft)
            else:
                r.skip(ft)
        return _patch_batch(out, service, res_attrs)
    except (struct.error, IndexError) as e:
        raise ValueError(f"malformed jaeger agent datagram: {e}") from None
