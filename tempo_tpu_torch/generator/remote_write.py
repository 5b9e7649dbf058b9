"""Prometheus remote write: WriteRequest encoding + snappy framing + HTTP.

Counterpart of `tempo_tpu/generator/remote_write.py`; pure host code.

The output half of the reference's per-tenant generator storage
(`modules/generator/storage/instance.go:60-127`): collected samples are
encoded as a `prometheus.WriteRequest` protobuf (remote-write 1.0 schema),
snappy block-compressed, and POSTed with per-tenant headers. We encode the
proto directly with the wire codec in tempo_tpu_torch.model.proto_wire, so no
generated code or vendored schema is needed.

Snappy note: the environment ships no snappy binding, so we emit a *valid*
snappy block stream using only literal chunks (the format permits arbitrary
literal/copy interleaving; all-literals is legal, just uncompressed-size).
Any compliant decoder (Prometheus/Mimir) accepts it.

WriteRequest field numbers (public prometheus/prompb/remote.proto + types.proto):
  WriteRequest{ repeated TimeSeries timeseries = 1; repeated MetricMetadata metadata = 3 }
  TimeSeries { repeated Label labels = 1; repeated Sample samples = 2;
               repeated Exemplar exemplars = 3; repeated Histogram histograms = 4 }
  Label      { string name = 1; string value = 2 }
  Sample     { double value = 1; int64 timestamp = 2 }
  Exemplar   { repeated Label labels = 1; double value = 2; int64 timestamp = 3 }
  Histogram  { uint64 count_int = 1; double sum = 3; sint32 schema = 4;
               double zero_threshold = 5; uint64 zero_count_int = 6;
               repeated BucketSpan positive_spans = 11;
               repeated sint64 positive_deltas = 12; int64 timestamp = 15 }
  BucketSpan { sint32 offset = 1; uint32 length = 2 }
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
import urllib.error
import urllib.request
from typing import Iterable, Sequence

import numpy as np

from tempo_tpu_torch.model import proto_wire as pw
from tempo_tpu_torch.registry.series import Sample

MAX_LITERAL = (1 << 32) - 1

# process-wide delivery counters across every RemoteWriteClient (one per
# tenant instance)
_RW_LOCK = threading.Lock()
_RW_RETRIES: dict[str, int] = {}      # cause -> count
_RW_STATS = {"sends": 0, "failed": 0}


def _note_retry(cause: str) -> None:
    with _RW_LOCK:
        _RW_RETRIES[cause] = _RW_RETRIES.get(cause, 0) + 1


def snappy_compress(data: bytes) -> bytes:
    """Snappy block-format framing using literal chunks only."""
    out = bytearray(pw.enc_varint(len(data)))
    pos, n = 0, len(data)
    while pos < n:
        chunk = data[pos: pos + 65536]
        ln = len(chunk)
        if ln <= 60:
            out.append((ln - 1) << 2)
        elif ln <= 256:
            out.append(60 << 2)
            out.append(ln - 1)
        else:
            out.append(61 << 2)
            out += (ln - 1).to_bytes(2, "little")
        out += chunk
        pos += ln
    return bytes(out)


def snappy_decompress_literals(buf: bytes) -> bytes:
    """Inverse of `snappy_compress`: decode a block of literal chunks.
    Raises on a copy chunk, which this encoder never emits."""
    n, pos = pw.read_varint(buf, 0)
    out = bytearray()
    while pos < len(buf):
        tag = buf[pos]
        pos += 1
        if tag & 3:
            raise ValueError("non-literal snappy chunk")
        ln = tag >> 2
        if ln == 60:
            ln, pos = buf[pos], pos + 1
        elif ln == 61:
            ln, pos = int.from_bytes(buf[pos:pos + 2], "little"), pos + 2
        out += buf[pos:pos + ln + 1]
        pos += ln + 1
    if len(out) != n:
        raise ValueError(f"snappy length {len(out)} != {n}")
    return bytes(out)


def decode_write_request(body: bytes) -> dict:
    """Snappy-framed WriteRequest → {sorted label pairs: [sample values in
    write order]}. A histogram's `_count` and `_sum` samples carry the same
    label set (`__name__` is the family name), so a label set maps to a
    list."""
    out: dict = {}
    for f, _, ts in pw.iter_fields(snappy_decompress_literals(body)):
        if f != 1:
            continue
        labels, value = [], None
        for f2, _, v2 in pw.iter_fields(bytes(ts)):
            if f2 == 1:
                kv = pw.decode_fields(bytes(v2))
                labels.append((bytes(kv[1][0]).decode(), bytes(kv[2][0]).decode()))
            elif f2 == 2:
                value = pw.f64(pw.decode_fields(bytes(v2))[1][0])
        out.setdefault(tuple(sorted(labels)), []).append(value)
    return out


class LocalReceiver:
    """A remote-write endpoint on 127.0.0.1 that keeps every POST body,
    keyed by path, for checks of what a generator wrote:

        with LocalReceiver() as rx:
            ... RemoteWriteConfig(url=rx.url + "/a") ...
        decode_write_request(rx.bodies["/a"])
    """

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, HTTPServer

        bodies: dict[str, bytes] = {}

        class _Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0) or 0)
                bodies[self.path] = self.rfile.read(n)
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *a):
                pass

        self.bodies = bodies
        self._srv = HTTPServer(("127.0.0.1", 0), _Handler)
        self.url = f"http://127.0.0.1:{self._srv.server_address[1]}"
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)

    def __enter__(self) -> "LocalReceiver":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(timeout=10)


def _enc_label(name: str, value: str) -> bytes:
    return pw.enc_field_str(1, name) + pw.enc_field_str(2, value)


def _enc_labels(labels: Sequence[tuple[str, str]]) -> bytes:
    return b"".join(pw.enc_field_msg(1, _enc_label(n, v)) for n, v in sorted(labels))


def _zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 63) if v < 0 else v << 1


def encode_native_histogram(log2_counts: np.ndarray, total: float, zeros: float,
                            sum_: float, ts_ms: int, offset: int = 0) -> bytes:
    """Encode a log2-bucket row as a schema-0 native histogram.

    Our log2 bucket b>0 covers [2^(b-1-offset), 2^(b-offset)); Prometheus
    schema-0 index i covers (2^(i-1), 2^i], so i = b - offset. Contiguous
    nonzero runs become BucketSpans with delta-encoded counts.
    """
    nz = np.flatnonzero(log2_counts[1:])  # skip zero-bucket; b = idx+1
    spans = b""
    deltas = b""
    prev_count = 0
    prev_idx = None
    run_start = None
    run_len = 0

    def flush_span(start, length, prev_end):
        offset = start - (prev_end if prev_end is not None else 0)
        return pw.enc_field_msg(11, pw.enc_field_varint(1, _zigzag(offset))
                                + pw.enc_field_varint(2, length))

    prev_end = None
    for idx in nz.tolist():
        i = idx + 1 - offset  # prometheus index = b - offset where b = idx+1
        if run_start is None:
            run_start, run_len = i, 1
        elif i == run_start + run_len:
            run_len += 1
        else:
            spans += flush_span(run_start, run_len, prev_end)
            prev_end = run_start + run_len
            run_start, run_len = i, 1
        c = int(log2_counts[idx + 1])
        deltas += pw.enc_field_varint(12, _zigzag(c - prev_count))
        prev_count = c
    if run_start is not None:
        spans += flush_span(run_start, run_len, prev_end)
    body = (
        pw.enc_field_varint(1, int(total))
        + pw.enc_field_double(3, float(sum_))
        + pw.enc_field_varint(4, _zigzag(0))      # schema 0
        + pw.enc_field_double(5, 1e-128)          # zero threshold
        + pw.enc_field_varint(6, int(zeros))
        + spans + deltas
        + pw.enc_field_varint(15, ts_ms)
    )
    return body


def encode_write_request(samples: Iterable[Sample],
                         native_histograms: Iterable[tuple] = (),
                         ts_ms: int | None = None) -> bytes:
    """samples → WriteRequest bytes. Stale markers become NaN samples (the
    Prometheus staleness convention the reference relies on)."""
    out = bytearray()
    for s in samples:
        ts = s.ts_ms if ts_ms is None else ts_ms
        body = _enc_labels(s.labels) + pw.enc_field_msg(
            2, pw.enc_field_double(1, s.value) + pw.enc_field_varint(2, ts))
        if s.exemplar is not None:
            ex = (pw.enc_field_msg(1, _enc_label("trace_id", s.exemplar.trace_id_hex))
                  + pw.enc_field_double(2, s.exemplar.value)
                  + pw.enc_field_varint(3, s.exemplar.ts_ms))
            body += pw.enc_field_msg(3, ex)
        out += pw.enc_field_msg(1, body)
    for labels, log2_counts, sum_, count, zeros, ts, *rest in native_histograms:
        offset = rest[0] if rest else 0
        body = _enc_labels(labels) + pw.enc_field_msg(
            4, encode_native_histogram(log2_counts, count, zeros, sum_, ts, offset))
        out += pw.enc_field_msg(1, body)
    return bytes(out)


@dataclasses.dataclass
class RemoteWriteConfig:
    url: str = ""
    headers: dict = dataclasses.field(default_factory=dict)
    timeout_s: float = 30.0
    retries: int = 3
    backoff_s: float = 0.5
    # TOTAL backoff sleep budget per send() call: send runs inline on
    # the shared collection thread, so the stall one tenant's backend
    # can inflict per tick must be bounded regardless of how many
    # retries remain or what Retry-After it advertises (a hostile
    # header cannot buy more than the remaining budget; once spent,
    # remaining retries are abandoned and the send fails)
    max_backoff_total_s: float = 15.0
    send_native_histograms: bool = False  # reference toggle (config_util.go)


class RemoteWriteClient:
    """POSTs snappy-framed WriteRequests with retry/backoff.

    Plays the role of the prometheus agent-WAL remote-write queue in the
    reference (deliberately without the on-disk WAL — the reference wipes it
    on every restart anyway, `storage/instance.go:66-70,135-146`; our
    delivery buffer is in-memory with bounded retry).
    """

    def __init__(self, cfg: RemoteWriteConfig):
        self.cfg = cfg
        self.sent_bytes = 0
        self.sent_samples = 0
        self.failed_sends = 0
        self.retried_sends = 0
        # injectable for tests: retry pacing must be assertable without
        # real sleeps, and jitter without seeding the global RNG
        self._sleep = time.sleep
        self._rng = random.Random()

    @staticmethod
    def _retry_after_s(e: urllib.error.HTTPError) -> "float | None":
        """Seconds advertised by a 429/503 Retry-After header (delta
        form only — the HTTP-date form is ignored rather than parsed
        wrong)."""
        try:
            v = e.headers.get("Retry-After") if e.headers else None
            return float(v) if v is not None else None
        except (TypeError, ValueError):
            return None

    def _backoff(self, attempt_delay: float,
                 retry_after: "float | None") -> float:
        """Full-jitter exponential backoff (sleep ~ U(0, delay)): a fleet
        of generators retrying the same dead endpoint never synchronizes
        into a thundering herd. A server-advertised Retry-After raises
        the floor — we honor it, plus jitter ON TOP so the fleet doesn't
        all return at exactly the advertised second. The caller clamps
        the result to its remaining per-send budget."""
        sleep_s = self._rng.uniform(0.0, attempt_delay)
        if retry_after is not None and retry_after > 0:
            sleep_s = retry_after + self._rng.uniform(
                0.0, max(retry_after * 0.1, self.cfg.backoff_s))
        return sleep_s

    def send(self, samples: Sequence[Sample], native_histograms: Sequence[tuple] = ()) -> bool:
        if not self.cfg.url or (not samples and not native_histograms):
            return True
        payload = snappy_compress(encode_write_request(samples, native_histograms))
        req = urllib.request.Request(self.cfg.url, data=payload, method="POST")
        req.add_header("Content-Encoding", "snappy")
        req.add_header("Content-Type", "application/x-protobuf")
        req.add_header("X-Prometheus-Remote-Write-Version", "0.1.0")
        req.add_header("User-Agent", "tempo-tpu-torch-remote-write/0.1")
        for k, v in self.cfg.headers.items():
            req.add_header(k, v)
        delay = self.cfg.backoff_s
        budget = self.cfg.max_backoff_total_s   # total sleep per send()
        for attempt in range(self.cfg.retries + 1):
            retry_after = None
            cause = None
            try:
                with urllib.request.urlopen(req, timeout=self.cfg.timeout_s) as resp:
                    if 200 <= resp.status < 300:
                        self.sent_bytes += len(payload)
                        self.sent_samples += len(samples)
                        with _RW_LOCK:
                            _RW_STATS["sends"] += 1
                        return True
            except urllib.error.HTTPError as e:
                if e.code == 429 or e.code >= 500:
                    # retryable per prometheus remote-write rules; 429
                    # and 503 commonly advertise Retry-After
                    cause = "http_429" if e.code == 429 else "http_5xx"
                    retry_after = self._retry_after_s(e)
                else:
                    break  # other 4xx: non-retryable
            except (urllib.error.URLError, OSError):
                cause = "network"
            if attempt < self.cfg.retries:
                sleep_s = min(self._backoff(delay, retry_after), budget)
                if sleep_s <= 0:
                    break      # budget spent: abandon remaining retries
                budget -= sleep_s
                self.retried_sends += 1
                _note_retry(cause or "unknown")
                self._sleep(sleep_s)
                delay *= 2
        self.failed_sends += 1
        with _RW_LOCK:
            _RW_STATS["failed"] += 1
        return False
# RUNTIME registry families (process-wide, next to the sched ones): the
# per-client attributes above stay the store, these render them
from tempo_tpu_torch.obs.runtime import RUNTIME  # noqa: E402


def _retries_family() -> list:
    # the lock covers the iteration too: a sender inserting a new cause
    # key mid-scrape would otherwise blow up the /metrics render
    with _RW_LOCK:
        return [((c,), float(v)) for c, v in _RW_RETRIES.items()]


RUNTIME.counter_func(
    "tempo_remote_write_retries_total", _retries_family,
    help="Remote-write attempts retried after a retryable failure, by "
         "cause (429 vs 5xx vs network) — sustained growth means the "
         "metrics backend is rejecting or unreachable",
    labels=("cause",))
RUNTIME.counter_func(
    "tempo_remote_write_sends_total",
    lambda: [((), float(_RW_STATS["sends"]))],
    help="Remote-write requests delivered (2xx)")
RUNTIME.counter_func(
    "tempo_remote_write_failed_sends_total",
    lambda: [((), float(_RW_STATS["failed"]))],
    help="Remote-write requests dropped after exhausting retries "
         "(samples LOST to the metrics backend)")


