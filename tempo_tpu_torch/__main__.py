"""`python -m tempo_tpu_torch` — the server binary (`cmd/tempo/main.go:64`).

Counterpart of `tempo_tpu/__main__.py`, with its flags: `-config.file`
(YAML), `-target` (module selection), `-config.check` (validate + print
warnings, exit) and `-server.http-listen-port`. The App runs on the
CUDA device.
"""

from __future__ import annotations

import argparse
import sys


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser("tempo_tpu_torch")
    ap.add_argument("-config.file", dest="config_file", default=None)
    ap.add_argument("-target", dest="target", default=None,
                    help="all | distributor | ingester | metrics-generator | "
                         "querier | query-frontend | compactor")
    ap.add_argument("-config.check", dest="check", action="store_true")
    ap.add_argument("-server.http-listen-port", dest="port", type=int,
                    default=None)
    args = ap.parse_args(argv)

    from tempo_tpu_torch.app import App, load_config
    cfg = load_config(args.config_file)
    if args.target:
        cfg.target = args.target
    if args.port:
        cfg.server.http_listen_port = args.port
    warnings = cfg.check()
    for w in warnings:
        print(f"warning: {w}", file=sys.stderr)
    if args.check:
        print("config ok")
        return 0
    app = App(cfg)
    print(f"tempo_tpu_torch starting: target={cfg.target} "
          f"http={cfg.server.http_listen_address}:{cfg.server.http_listen_port}",
          file=sys.stderr)
    app.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
