"""tempo-query binary: `python -m tempo_tpu_torch.tempoquery --tempo URL`.

Serves the jaeger.storage.v1 gRPC plugin (cmd/tempo-query analog) so a
Jaeger Query instance can use a tempo_tpu_torch cluster as its span store.

Counterpart of `tempo_tpu/tempoquery/__main__.py`, host code copied with its imports
moved to the port; it runs no device code of its own.
"""

from __future__ import annotations

import argparse
import time


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser("tempo_tpu_torch.tempoquery")
    ap.add_argument("--tempo", required=True, help="tempo_tpu_torch base URL")
    ap.add_argument("--tenant", default="")
    ap.add_argument("--listen", default="0.0.0.0:7777")
    args = ap.parse_args(argv)
    from tempo_tpu_torch.tempoquery import build_tempo_query_server
    server, port = build_tempo_query_server(
        args.tempo, tenant=args.tenant, address=args.listen)
    print(f"tempo-query plugin serving jaeger.storage.v1 on port {port} "
          f"→ {args.tempo}")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop(0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
