"""Process-wide Prometheus-style instrumentation registry.

Counterpart of `tempo_tpu/obs/registry.py`, kept line for line so the
port's exposition is byte-compatible with the reference's.

The single source of truth behind `/metrics`: modules register their own
metric families (Counter / Gauge / Histogram, plus callback-backed
families that snapshot existing module state at scrape time) and the
exposition renderer emits the whole registry as Prometheus text format
0.0.4 — `# HELP`/`# TYPE` metadata, centralized label escaping, sorted
deterministic output, no duplicate series.

Design notes (mirroring prometheus/client_golang semantics sized to this
build):

- Families are get-or-create by name: re-registering the same name with
  the same kind and label names returns the existing family (modules and
  request handlers may race to the same instrument); a kind or label
  mismatch raises.
- Histograms use exponential bucket boundaries by default (the
  "Moment-Based Quantile Sketches" observation that log-spaced buckets
  are the right compact primitive for high-rate latency telemetry) and
  can carry an exemplar-style trace id per series, the bridge between
  self-metrics and `SelfTracer` (slow requests are findable by trace).
- Callback families (`counter_func` / `gauge_func`) read module state at
  render time so hot paths that already keep plain dict counters pay
  ZERO extra cost per event — only new latency histograms touch the hot
  path, and those are one lock + one bisect per observation.
- `Registry(enabled=False)` hands out no-op instruments: the bench
  harness measures instrumentation overhead as (enabled - disabled).
"""

from __future__ import annotations

import bisect
import re
import threading
import time
from typing import Callable, Iterable, Sequence

# ---------------------------------------------------------------------------
# label / value formatting (centralized: call sites never hand-escape)
# ---------------------------------------------------------------------------


def escape_label(v: str) -> str:
    """Prometheus exposition label escaping: backslash, quote, newline.
    Attacker-controlled values (tenant header, span attrs) must never be
    able to forge or corrupt exposition lines."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_le(edge: float) -> str:
    return format(edge, ".12g")


def _fmt_labels(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{escape_label(v)}"'
                     for n, v in zip(names, values))
    return "{" + inner + "}"


def exponential_buckets(start: float, factor: float, count: int) -> tuple:
    """`count` upper bounds starting at `start`, each `factor` apart."""
    return tuple(start * factor ** i for i in range(count))


# 1ms .. ~65s in powers of two — wide enough for request latencies and
# compaction cycles alike while staying 17 buckets per series
DEFAULT_DURATION_BUCKETS = exponential_buckets(0.001, 2.0, 17)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


# ---------------------------------------------------------------------------
# instruments
# ---------------------------------------------------------------------------


class _Family:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: tuple) -> None:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()

    def _check_labels(self, labels: tuple) -> tuple:
        labels = tuple(str(v) for v in labels)
        if len(labels) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: got {len(labels)} label values for "
                f"{len(self.labelnames)} label names {self.labelnames}")
        return labels

    def metric_names(self) -> set[str]:
        return {self.name}

    def render(self, out: list[str]) -> None:
        raise NotImplementedError


class Counter(_Family):
    kind = "counter"

    def __init__(self, name: str, help: str, labelnames: tuple) -> None:
        super().__init__(name, help, labelnames)
        self._series: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, labels: tuple = ()) -> None:
        labels = self._check_labels(labels)
        with self._lock:
            self._series[labels] = self._series.get(labels, 0.0) + amount

    def value(self, labels: tuple = ()) -> float:
        with self._lock:
            return self._series.get(tuple(str(v) for v in labels), 0.0)

    def render(self, out: list[str]) -> None:
        with self._lock:
            items = sorted(self._series.items())
        if not self.labelnames and not items:
            items = [((), 0.0)]          # unlabeled counters expose 0
        for labels, v in items:
            out.append(f"{self.name}{_fmt_labels(self.labelnames, labels)} "
                       f"{_fmt_value(v)}")


class Gauge(_Family):
    kind = "gauge"

    def __init__(self, name: str, help: str, labelnames: tuple) -> None:
        super().__init__(name, help, labelnames)
        self._series: dict[tuple, float] = {}

    def set(self, value: float, labels: tuple = ()) -> None:
        labels = self._check_labels(labels)
        with self._lock:
            self._series[labels] = float(value)

    def add(self, amount: float, labels: tuple = ()) -> None:
        labels = self._check_labels(labels)
        with self._lock:
            self._series[labels] = self._series.get(labels, 0.0) + amount

    def value(self, labels: tuple = ()) -> float:
        with self._lock:
            return self._series.get(tuple(str(v) for v in labels), 0.0)

    def render(self, out: list[str]) -> None:
        with self._lock:
            items = sorted(self._series.items())
        for labels, v in items:
            out.append(f"{self.name}{_fmt_labels(self.labelnames, labels)} "
                       f"{_fmt_value(v)}")


class Histogram(_Family):
    """Cumulative histogram with exponential (configurable) buckets.

    Per-series state is (bucket counts, sum, count) plus the most recent
    exemplar — a `(trace_id, value, ts)` triple attached by observations
    that carried a trace id (the SelfTracer bridge: requests over the SLO
    threshold stamp their trace so a p99 spike is one click from a
    concrete slow trace). Exemplars ride the snapshot API, not the 0.0.4
    text format (which predates them)."""

    kind = "histogram"

    def __init__(self, name: str, help: str, labelnames: tuple,
                 buckets: Sequence[float] | None = None) -> None:
        super().__init__(name, help, labelnames)
        edges = tuple(sorted(buckets or DEFAULT_DURATION_BUCKETS))
        if not edges:
            raise ValueError(f"{name}: histogram needs >= 1 bucket")
        self.edges = edges
        # series -> [per-bucket counts (len edges+1, last = >last edge),
        #            sum, count]
        self._series: dict[tuple, list] = {}
        self._exemplars: dict[tuple, tuple] = {}

    def observe(self, value: float, labels: tuple = (),
                trace_id: str | None = None) -> None:
        labels = self._check_labels(labels)
        value = float(value)
        i = bisect.bisect_left(self.edges, value)
        with self._lock:
            s = self._series.get(labels)
            if s is None:
                s = self._series[labels] = [[0] * (len(self.edges) + 1),
                                            0.0, 0]
            s[0][i] += 1
            s[1] += value
            s[2] += 1
            if trace_id:
                self._exemplars[labels] = (trace_id, value, time.time())

    def snapshot(self, labels: tuple = ()) -> dict | None:
        """(buckets, sum, count, exemplar) for one series, or None."""
        labels = tuple(str(v) for v in labels)
        with self._lock:
            s = self._series.get(labels)
            if s is None:
                return None
            return {"buckets": list(s[0]), "sum": s[1], "count": s[2],
                    "exemplar": self._exemplars.get(labels)}

    def exemplar(self, labels: tuple = ()) -> tuple | None:
        with self._lock:
            return self._exemplars.get(tuple(str(v) for v in labels))

    def metric_names(self) -> set[str]:
        return {self.name, f"{self.name}_bucket", f"{self.name}_sum",
                f"{self.name}_count"}

    def render(self, out: list[str]) -> None:
        with self._lock:
            items = sorted((k, (list(v[0]), v[1], v[2]))
                           for k, v in self._series.items())
        lnames = self.labelnames + ("le",)
        for labels, (counts, total, n) in items:
            cum = 0
            for edge, c in zip(self.edges, counts):
                cum += c
                out.append(
                    f"{self.name}_bucket"
                    f"{_fmt_labels(lnames, labels + (_fmt_le(edge),))} {cum}")
            out.append(f"{self.name}_bucket"
                       f"{_fmt_labels(lnames, labels + ('+Inf',))} {n}")
            base = _fmt_labels(self.labelnames, labels)
            out.append(f"{self.name}_sum{base} {_fmt_value(total)}")
            out.append(f"{self.name}_count{base} {n}")


class _FuncFamily(_Family):
    """Family whose series are produced by a callback at render time:
    `fn() -> iterable[(label_values_tuple, value)]`. The bridge that lets
    modules keep their existing lock-free dict counters and still own a
    first-class registered family (name, HELP, TYPE) — the render pays
    the snapshot, the hot path pays nothing."""

    def __init__(self, name: str, help: str, labelnames: tuple,
                 fn: Callable[[], Iterable], kind: str) -> None:
        super().__init__(name, help, labelnames)
        self.kind = kind
        self.fn = fn

    def render(self, out: list[str]) -> None:
        try:
            items = sorted((tuple(str(v) for v in labels), value)
                           for labels, value in self.fn())
        except Exception:
            return    # a failing collector must never break /metrics
        if not self.labelnames and not items and self.kind == "counter":
            items = [((), 0.0)]
        for labels, v in items:
            if len(labels) != len(self.labelnames):
                continue
            out.append(f"{self.name}{_fmt_labels(self.labelnames, labels)} "
                       f"{_fmt_value(v)}")


class _Noop:
    """Disabled-registry instrument: every method is a cheap no-op."""

    def inc(self, amount: float = 1.0, labels: tuple = ()) -> None: ...
    def set(self, value: float, labels: tuple = ()) -> None: ...
    def add(self, amount: float, labels: tuple = ()) -> None: ...
    def observe(self, value: float, labels: tuple = (),
                trace_id: str | None = None) -> None: ...
    def value(self, labels: tuple = ()) -> float:
        return 0.0
    def snapshot(self, labels: tuple = ()):
        return None
    def exemplar(self, labels: tuple = ()):
        return None


_NOOP = _Noop()


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


class Registry:
    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    # -- registration ------------------------------------------------------

    def _get_or_create(self, cls, name: str, help: str, labels: tuple,
                       **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != cls.kind or fam.labelnames != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.labelnames}, wanted "
                        f"{cls.kind}{tuple(labels)}")
                buckets = kw.get("buckets")
                if buckets is not None:
                    edges = tuple(sorted(buckets))
                    if edges != fam.edges:
                        raise ValueError(
                            f"metric {name!r} already registered with "
                            f"buckets {fam.edges}, wanted {edges}")
                return fam
            fam = cls(name, help, tuple(labels), **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: tuple = ()) -> Counter:
        if not self.enabled:
            return _NOOP
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels: tuple = ()) -> Gauge:
        if not self.enabled:
            return _NOOP
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", labels: tuple = (),
                  buckets: Sequence[float] | None = None) -> Histogram:
        if not self.enabled:
            return _NOOP
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    def counter_func(self, name: str, fn: Callable[[], Iterable],
                     help: str = "", labels: tuple = ()) -> None:
        if not self.enabled:
            return
        with self._lock:
            if name in self._families:
                raise ValueError(f"metric {name!r} already registered")
            self._families[name] = _FuncFamily(name, help, tuple(labels),
                                               fn, "counter")

    def gauge_func(self, name: str, fn: Callable[[], Iterable],
                   help: str = "", labels: tuple = ()) -> None:
        if not self.enabled:
            return
        with self._lock:
            if name in self._families:
                raise ValueError(f"metric {name!r} already registered")
            self._families[name] = _FuncFamily(name, help, tuple(labels),
                                               fn, "gauge")

    # -- introspection / exposition ----------------------------------------

    def get(self, name: str) -> _Family | None:
        with self._lock:
            return self._families.get(name)

    def metric_names(self) -> set[str]:
        """Every exposable sample name, including a histogram's derived
        `_bucket`/`_sum`/`_count` names — the drift gate's ground truth."""
        with self._lock:
            fams = list(self._families.values())
        out: set[str] = set()
        for f in fams:
            out |= f.metric_names()
        return out

    def render(self, extra: "Sequence[Registry]" = ()) -> str:
        """Full text-format exposition of this registry plus any `extra`
        registries (e.g. the process-wide JAX runtime registry). Name
        collisions resolve in favor of the first registry seen."""
        fams: dict[str, _Family] = {}
        for reg in (self, *extra):
            with reg._lock:
                for name, fam in reg._families.items():
                    fams.setdefault(name, fam)
        out: list[str] = []
        for name in sorted(fams):
            fam = fams[name]
            if fam.help:
                out.append(f"# HELP {name} {_escape_help(fam.help)}")
            out.append(f"# TYPE {name} {fam.kind}")
            fam.render(out)
        return "\n".join(out) + ("\n" if out else "")


# ---------------------------------------------------------------------------
# text-format conformance validation (the round-trip parser)
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"          # metric name
    r"(\{(.*)\})?"                           # optional label set
    r" (-?(?:[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)|[+-]Inf|NaN)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_exposition(text: str) -> dict:
    """Parse Prometheus text format; raises ValueError on any conformance
    violation (malformed line, bad escaping, duplicate series, sample
    without a TYPE, non-cumulative histogram buckets). Returns
    {family -> {"type", "help", "samples": {(name, labeltuple): value}}}."""
    families: dict[str, dict] = {}
    seen: set[tuple] = set()
    by_base: dict[str, str] = {}     # sample name -> declaring family

    def family_of(sample_name: str) -> str | None:
        if sample_name in by_base:
            return by_base[sample_name]
        for suffix in ("_bucket", "_sum", "_count"):
            if sample_name.endswith(suffix):
                base = sample_name[: -len(suffix)]
                if families.get(base, {}).get("type") == "histogram":
                    return base
        return None

    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line[len("# HELP "):].split(" ", 1)
            fam = families.setdefault(parts[0], {"type": None, "help": None,
                                                 "samples": {}})
            fam["help"] = parts[1] if len(parts) > 1 else ""
            continue
        if line.startswith("# TYPE "):
            parts = line[len("# TYPE "):].split(" ")
            if len(parts) != 2 or parts[1] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                raise ValueError(f"line {lineno}: bad TYPE line {line!r}")
            fam = families.setdefault(parts[0], {"type": None, "help": None,
                                                 "samples": {}})
            if fam["type"] is not None:
                raise ValueError(f"line {lineno}: duplicate TYPE {parts[0]}")
            fam["type"] = parts[1]
            by_base[parts[0]] = parts[0]
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: malformed sample {line!r}")
        name, _, labelblob, value = m.groups()
        labels: tuple = ()
        if labelblob:
            consumed = _LABEL_RE.sub("", labelblob).strip(", ")
            if consumed:
                raise ValueError(
                    f"line {lineno}: malformed labels {labelblob!r}")
            labels = tuple(sorted(_LABEL_RE.findall(labelblob)))
        key = (name, labels)
        if key in seen:
            raise ValueError(f"line {lineno}: duplicate series {key}")
        seen.add(key)
        fam_name = family_of(name)
        if fam_name is None:
            raise ValueError(f"line {lineno}: sample {name!r} has no TYPE")
        families[fam_name]["samples"][key] = float(value)

    # histogram invariants: buckets cumulative, +Inf == _count
    for fname, fam in families.items():
        if fam["type"] != "histogram":
            continue
        series: dict[tuple, list] = {}
        for (name, labels), v in fam["samples"].items():
            if name == f"{fname}_bucket":
                rest = tuple(kv for kv in labels if kv[0] != "le")
                le = next(kv[1] for kv in labels if kv[0] == "le")
                series.setdefault(rest, []).append((le, v))
        for rest, buckets in series.items():
            def _le_key(item):
                le = item[0]
                return float("inf") if le == "+Inf" else float(le)
            ordered = sorted(buckets, key=_le_key)
            vals = [v for _le, v in ordered]
            if vals != sorted(vals):
                raise ValueError(
                    f"{fname}{dict(rest)}: buckets not cumulative {vals}")
            count = fam["samples"].get((f"{fname}_count", rest))
            if count is not None and ordered and ordered[-1][0] == "+Inf" \
                    and ordered[-1][1] != count:
                raise ValueError(
                    f"{fname}{dict(rest)}: +Inf bucket {ordered[-1][1]} "
                    f"!= count {count}")
    return families


__all__ = ["Registry", "Counter", "Gauge", "Histogram", "escape_label",
           "exponential_buckets", "parse_exposition",
           "DEFAULT_DURATION_BUCKETS"]
