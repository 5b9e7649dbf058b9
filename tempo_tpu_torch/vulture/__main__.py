"""tempo-vulture analog: black-box write/read consistency prober.

Writes synthetic traces through the public OTLP endpoint, then re-reads
them by ID and by TraceQL search, and checks metrics sanity — the
continuous canary of `cmd/tempo-vulture/main.go:85-110`.

  python -m tempo_tpu_torch.vulture --url http://localhost:3200 --cycles 3

Counterpart of `tempo_tpu/vulture/__main__.py`, host code copied with its imports
moved to the port; it runs no device code of its own.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time


def make_trace(rng: random.Random, t0_ns: int) -> tuple[str, dict]:
    tid = "".join(rng.choice("0123456789abcdef") for _ in range(32))
    n_spans = rng.randint(1, 5)
    spans = []
    for i in range(n_spans):
        sid = "".join(rng.choice("0123456789abcdef") for _ in range(16))
        start = t0_ns + i * 1_000_000
        spans.append({
            "traceId": tid, "spanId": sid,
            "parentSpanId": spans[0]["spanId"] if i else "",
            "name": f"vulture-op-{i}", "kind": 2,
            "startTimeUnixNano": str(start),
            "endTimeUnixNano": str(start + rng.randint(1, 50) * 1_000_000),
            "attributes": [{"key": "vulture", "value": {"boolValue": True}}],
            "status": {"code": 0},
        })
    payload = {"resourceSpans": [{
        "resource": {"attributes": [
            {"key": "service.name", "value": {"stringValue": "vulture"}}]},
        "scopeSpans": [{"spans": spans}]}]}
    return tid, payload


def run_cycle(client, rng: random.Random, read_delay_s: float) -> dict:
    res = {"written": 0, "read_ok": 0, "read_missing": 0,
           "search_ok": 0, "search_missing": 0, "errors": 0}
    t0_ns = int((time.time() - 1) * 1e9)
    written: list[str] = []
    for _ in range(5):
        tid, payload = make_trace(rng, t0_ns)
        try:
            client.push_otlp_json(payload)
            written.append(tid)
            res["written"] += 1
        except Exception:
            res["errors"] += 1
    time.sleep(read_delay_s)
    for tid in written:
        try:
            doc = client.trace_by_id(tid)
            if doc.get("spans"):
                res["read_ok"] += 1
            else:
                res["read_missing"] += 1
        except Exception:
            res["read_missing"] += 1
    try:
        found = client.search('{ resource.service.name = "vulture" }',
                              limit=200)
        ids = {t["traceID"] for t in found.get("traces", [])}
        for tid in written:
            if tid in ids:
                res["search_ok"] += 1
            else:
                res["search_missing"] += 1
    except Exception:
        res["errors"] += 1
    return res


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser("tempo_tpu_torch.vulture")
    ap.add_argument("--url", default="http://127.0.0.1:3200")
    ap.add_argument("--tenant", default="")
    ap.add_argument("--cycles", type=int, default=0, help="0 = forever")
    ap.add_argument("--interval", type=float, default=5.0)
    ap.add_argument("--read-delay", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=None)
    args = ap.parse_args(argv)

    from tempo_tpu_torch.client import Client
    client = Client(args.url, tenant=args.tenant)
    rng = random.Random(args.seed)
    cycle = 0
    failures = 0
    while args.cycles == 0 or cycle < args.cycles:
        res = run_cycle(client, rng, args.read_delay)
        ok = (res["read_missing"] == 0 and res["errors"] == 0
              and res["search_missing"] == 0)
        failures += 0 if ok else 1
        print(json.dumps({"cycle": cycle, "ok": ok, **res}), flush=True)
        cycle += 1
        if args.cycles == 0 or cycle < args.cycles:
            time.sleep(args.interval)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
