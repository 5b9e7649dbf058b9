"""Record encoding: span-dict groups ↔ bus record bytes, with size splits.

Counterpart of `tempo_tpu/ingest/encoding.py`, host code copied with its imports
moved to the port.

Analog of `pkg/ingest/encoding.go:40` (`Encode` splits a PushBytesRequest
into ≤max_record_bytes records so one huge push can't exceed the bus's
record limit; `Decode` reassembles). The wire format here is the
framework's own compact msgpack-less encoding built on the proto_wire
varint helpers: repeated (trace_id, n_spans, span_json...) — JSON per span
keeps it debuggable; the hot columnar path never touches this (records
stage back into SpanBatches at the consumer).
"""

from __future__ import annotations

import json
from typing import Iterable, Iterator, Sequence

from tempo_tpu_torch.model import proto_wire as pw

MAX_RECORD_BYTES = 1 << 20  # franz-go default-ish ceiling


def _enc_span(s: dict) -> bytes:
    d = dict(s)
    for k in ("trace_id", "span_id", "parent_span_id"):
        if k in d and isinstance(d[k], bytes):
            d[k] = d[k].hex()
    if d.get("links"):     # link ids are bytes in span dicts too
        d["links"] = [
            {**ln, **{k: ln[k].hex() for k in ("trace_id", "span_id")
                      if isinstance(ln.get(k), bytes)}}
            for ln in d["links"]]
    return json.dumps(d, separators=(",", ":")).encode()


def _dec_span(b: bytes) -> dict:
    d = json.loads(b)
    for k in ("trace_id", "span_id", "parent_span_id"):
        if k in d:
            d[k] = bytes.fromhex(d[k])
    if d.get("links"):
        d["links"] = [
            {**ln, **{k: bytes.fromhex(ln[k]) for k in ("trace_id", "span_id")
                      if isinstance(ln.get(k), str)}}
            for ln in d["links"]]
    return d


def encode_push(traces: Sequence[tuple[bytes, list[dict]]],
                max_record_bytes: int = MAX_RECORD_BYTES) -> list[bytes]:
    """Encode (trace_id, spans) groups into 1+ records of bounded size."""
    records: list[bytes] = []
    buf = bytearray()
    for tid, spans in traces:
        group = bytearray()
        group += pw.enc_field_bytes(1, tid)
        for s in spans:
            group += pw.enc_field_bytes(2, _enc_span(s))
        framed = pw.enc_field_bytes(3, bytes(group))
        if buf and len(buf) + len(framed) > max_record_bytes:
            records.append(bytes(buf))
            buf = bytearray()
        buf += framed
    if buf:
        records.append(bytes(buf))
    return records


def decode_push(record: bytes) -> Iterator[tuple[bytes, list[dict]]]:
    for fnum, _, group in pw.iter_fields(record):
        if fnum != 3:
            continue
        tid = b""
        spans: list[dict] = []
        for f2, _, v in pw.iter_fields(bytes(group)):
            if f2 == 1:
                tid = bytes(v)
            elif f2 == 2:
                spans.append(_dec_span(bytes(v)))
        yield tid, spans


def produce_traces(bus, tenant: str,
                   traces: Sequence[tuple[bytes, list[dict]]],
                   tokens, n_partitions: int | None = None) -> None:
    """Producer side: encode trace groups and spread them over partitions
    by token (`sendToKafka` `distributor.go:612`). Lives with the encoding
    so producers don't depend on any consumer service."""
    nparts = n_partitions or bus.n_partitions
    parts = partition_for(tokens, nparts)
    by_part: dict[int, list] = {}
    for (tid_spans, part) in zip(traces, parts):
        by_part.setdefault(int(part), []).append(tid_spans)
    for part, group in by_part.items():
        for record in encode_push(group):
            bus.produce(part, tenant, record)


def partition_for(tokens, n_partitions: int):
    """Token → partition (the partition ring's stable assignment,
    `distributor.go:612-679` ActivePartitionBatchRing). Tokens are remixed
    first: raw fnv tokens have parity artifacts (all-equal-byte trace ids
    always hash odd), so `token % n` would starve even partitions. Pure
    numpy — the producer hot path never dispatches to a device."""
    import numpy as np

    with np.errstate(over="ignore"):
        h = np.asarray(tokens, np.uint32)
        h = h + np.uint32(0x9E3779B9)
        h = (h ^ (h >> np.uint32(16))) * np.uint32(0x21F0AAAD)
        h = (h ^ (h >> np.uint32(15))) * np.uint32(0x735A2D97)
        h = h ^ (h >> np.uint32(15))
    return h % n_partitions
