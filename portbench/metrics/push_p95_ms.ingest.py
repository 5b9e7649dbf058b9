"""95th percentile of every `Generator.push_otlp` call in the window, by
the harness's clock around the call, in milliseconds."""

from portbench.core.record import p95


def read(rec):
    v = p95(rec.data.get("push_s", []))
    return None if v is None else v * 1e3
