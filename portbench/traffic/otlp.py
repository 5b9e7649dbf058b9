"""OTLP/protobuf `ExportTraceServiceRequest` bytes from span columns.

The benchmark's own encoder, written with numpy over whole payloads so
that set-up encodes some hundreds of 8,192-span payloads in seconds.
The layout is the OTLP trace proto's: ResourceSpans (1) with a Resource
(1) holding `service.name` and one ScopeSpans (2) whose Spans (2) carry
trace_id (1), span_id (2), parent_span_id (4), name (5), kind (6),
start and end (7, 8, fixed64), attributes (9: `db.system` on database
calls) and status (15, code 3, left out when unset). Spans are grouped
into one ResourceSpans a service.

A `Payload` keeps the byte offsets of each span's trace id and times, so
that a client stamps a push with a trace-id prefix of its own and its
base time (`Payload.stamp`) without encoding again.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench.traffic.trees import DB_SYSTEMS, LabelSpace, SpanColumns


def varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(fnum: int, body: bytes) -> bytes:
    """A length-delimited field."""
    return varint(fnum << 3 | 2) + varint(len(body)) + body


def _varints(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[n, 3] varint bytes and their lengths of values below 2**21."""
    if v.size and int(v.max()) >= 1 << 21:
        raise ValueError("span message too long for the encoder")
    out = np.zeros((v.size, 3), np.uint8)
    out[:, 0] = v & 0x7F
    out[:, 1] = (v >> 7) & 0x7F
    out[:, 2] = (v >> 14) & 0x7F
    ln = np.where(v >= 1 << 14, 3, np.where(v >= 1 << 7, 2, 1))
    out[:, 0] |= np.where(ln > 1, 0x80, 0).astype(np.uint8)
    out[:, 1] |= np.where(ln > 2, 0x80, 0).astype(np.uint8)
    return out, ln


def _table(entries: list[bytes]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Concatenated byte table: (bytes, offsets, lengths)."""
    lens = np.array([len(e) for e in entries], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    return np.frombuffer(b"".join(entries), np.uint8), offs, lens


def _concat(pieces, n: int) -> tuple[np.ndarray, np.ndarray, list]:
    """Row-wise concatenation: for each row i, the bytes src[start[i]:
    start[i] + length[i]] of every piece in order. Returns the bytes, each
    row's offset, and each piece's offset within its row."""
    lens = np.zeros(n, np.int64)
    within = []
    for _, _, ln in pieces:
        within.append(lens.copy())
        lens += ln
    row_off = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    out = np.empty(int(lens.sum()), np.uint8)
    for (src, start, ln), w in zip(pieces, within):
        tot = int(ln.sum())
        if not tot:
            continue
        first = np.concatenate([[0], np.cumsum(ln)[:-1]])
        j = np.arange(tot) - np.repeat(first, ln)
        out[np.repeat(row_off + w, ln) + j] = src[np.repeat(start, ln) + j]
    return out, row_off, within


@dataclasses.dataclass
class Payload:
    """One encoded request and the offsets a push stamps."""

    data: np.ndarray          # uint8 wire bytes
    tid_off: np.ndarray       # [n] offset of each span's trace id
    time_off: np.ndarray      # [n] offset of each span's start value
    start_ns: np.ndarray      # [n] relative start times, in wire order
    end_ns: np.ndarray        # [n] relative end times, in wire order
    order: np.ndarray         # [n] column row of each wire span
    span_bytes: np.ndarray    # [n] size of each span message, column order

    @property
    def n(self) -> int:
        return int(self.order.size)

    def stamp(self, trace_prefix: bytes, base_ns: int) -> bytes:
        """The payload with every trace id's first 8 bytes set to
        `trace_prefix` and every time moved by `base_ns`."""
        buf = self.data.copy()
        pre = np.frombuffer(trace_prefix, np.uint8)
        buf[self.tid_off[:, None] + np.arange(8)] = pre
        t = np.stack([self.start_ns + base_ns, self.end_ns + base_ns], 1)
        tb = t.astype("<u8").view(np.uint8).reshape(-1, 2, 8)
        at = self.time_off[:, None] + np.arange(8)
        buf[at] = tb[:, 0]
        buf[at + 9] = tb[:, 1]
        return buf.tobytes()


def encode(cols: SpanColumns, space: LabelSpace) -> Payload:
    """The columns' spans as one request (see the module docstring)."""
    n = cols.n
    order = np.argsort(cols.service, kind="stable")
    c = {k: getattr(cols, k)[order] for k in (
        "trace_id", "span_id", "parent_span_id", "has_parent", "service",
        "name", "kind", "status", "db", "start_ns", "end_ns")}
    head = np.zeros((n, 38), np.uint8)
    head[:, 0], head[:, 1] = 0x0A, 16
    head[:, 2:18] = c["trace_id"]
    head[:, 18], head[:, 19] = 0x12, 8
    head[:, 20:28] = c["span_id"]
    head[:, 28], head[:, 29] = 0x22, 8
    head[:, 30:38] = c["parent_span_id"]
    head_len = np.where(c["has_parent"], 38, 28)
    # name and kind: one entry a (name, kind)
    nk = [_field(5, space.span_name(i).encode()) + bytes([0x30, k])
          for i in range(space.names) for k in (2, 3)]
    nk_src, nk_off, nk_len = _table(nk)
    nk_idx = c["name"] * 2 + (c["kind"] == 3)
    times = np.zeros((n, 18), np.uint8)
    times[:, 0], times[:, 9] = 0x39, 0x41
    # attributes and status: one entry a (db system or none, status)
    tail = []
    for d in range(-1, len(DB_SYSTEMS)):
        attrs = b"" if d < 0 else _field(9, _field(1, b"db.system") + _field(
            2, _field(1, DB_SYSTEMS[d].encode())))
        for st in range(space.statuses):
            tail.append(attrs + (_field(15, bytes([0x18, st])) if st else b""))
    t_src, t_off, t_len = _table(tail)
    t_idx = (c["db"] + 1) * space.statuses + c["status"]
    span_len = head_len + nk_len[nk_idx] + 18 + t_len[t_idx]
    wrap, wrap_len = _varints(span_len)
    wrap = np.concatenate([np.full((n, 1), 0x12, np.uint8), wrap], 1)
    ar = np.arange(n, dtype=np.int64)
    body, row_off, within = _concat([
        (wrap.ravel(), ar * 4, 1 + wrap_len),
        (head.ravel(), ar * 38, head_len),
        (nk_src, nk_off[nk_idx], nk_len[nk_idx]),
        (times.ravel(), ar * 18, np.full(n, 18, np.int64)),
        (t_src, t_off[t_idx], t_len[t_idx]),
    ], n)
    # one ResourceSpans a service, around its run of span messages
    svc = c["service"]
    cuts = np.flatnonzero(np.diff(svc)) + 1
    lo = np.concatenate([[0], cuts])
    hi = np.concatenate([cuts, [n]])
    out, shift = [], np.zeros(n, np.int64)
    pos = 0
    for a, b in zip(lo.tolist(), hi.tolist()):
        end = body.size if b == n else int(row_off[b])
        spans = body[int(row_off[a]):end].tobytes()
        res = _field(1, _field(1, _field(1, b"service.name") + _field(
            2, _field(1, space.service_name(svc[a]).encode()))))
        scope = varint(2 << 3 | 2) + varint(len(spans))
        rs_body_len = len(res) + len(scope) + len(spans)
        hdr = varint(1 << 3 | 2) + varint(rs_body_len) + res + scope
        shift[a:b] = pos + len(hdr) - int(row_off[a])
        out += [hdr, spans]
        pos += len(hdr) + len(spans)
    data = np.frombuffer(b"".join(out), np.uint8).copy()
    tid_off = row_off + shift + within[1] + 2
    time_off = row_off + shift + within[3] + 1
    span_bytes = np.empty(n, np.int64)
    span_bytes[order] = span_len
    return Payload(data=data, tid_off=tid_off, time_off=time_off,
                   start_ns=c["start_ns"], end_ns=c["end_ns"], order=order,
                   span_bytes=span_bytes)
