"""Fleet process entries.

Counterpart of `tempo_tpu/fleet/worker.py`. Two runnable shapes:

- `python -m tempo_tpu_torch.fleet.worker --config fleet.yaml`: one fleet
  member, a normal App (usually `target: metrics-generator` with
  `fleet.enabled: true`) on the card, whose HTTP server carries the RPC
  plane, the /kv CAS routes when it hosts ring state, and /status.
- `python -m tempo_tpu_torch.fleet.worker --kv-only --port N`: a
  standalone /kv CAS server (the App routes' wire surface over one
  `KVStore`), so ring state survives any member being killed.

Both print one JSON ready line to stdout (`{"ready": true, "port": N}`)
so a parent can wait for it instead of polling. `spawn_worker` and
`reap_workers` are the parent's side.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import unquote


def make_kv_server(port: int = 0, host: str = "127.0.0.1"
                   ) -> ThreadingHTTPServer:
    """A /kv-only CAS HTTP server over a fresh KVStore (wire-compatible
    with the App's /kv routes — `ring.kv._HttpEndpoint` is the client).
    Caller starts/stops it; `.kv_port` carries the bound port."""
    from tempo_tpu_torch.ring.kv import (KVStore, _value_from_json,
                                         _value_to_json)

    store = KVStore()

    class _KVHandler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # noqa: A003
            pass

        def _reply(self, code: int, body: dict | None = None) -> None:
            data = json.dumps(body or {}).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _key(self) -> str | None:
            if not self.path.startswith("/kv/"):
                self._reply(404, {"error": "kv-only server"})
                return None
            return unquote(self.path[len("/kv/"):])

        def do_GET(self) -> None:  # noqa: N802
            key = self._key()
            if key is None:
                return
            ver, val = store.get_versioned(key)
            if val is None and ver == 0:
                return self._reply(404, {"error": f"no key {key}"})
            self._reply(200, {"version": ver, "value": _value_to_json(val)})

        def do_POST(self) -> None:  # noqa: N802
            key = self._key()
            if key is None:
                return
            n = int(self.headers.get("Content-Length", 0) or 0)
            d = json.loads(self.rfile.read(n))
            ok, ver = store.cas_versioned(
                key, int(d["expect_version"]), _value_from_json(d["value"]))
            if not ok:
                return self._reply(409, {"error": "version conflict",
                                         "version": ver})
            self._reply(200, {"version": ver})

        def do_DELETE(self) -> None:  # noqa: N802
            key = self._key()
            if key is None:
                return
            store.delete(key)
            self._reply(200, {})

    srv = ThreadingHTTPServer((host, port), _KVHandler)
    srv.kv_store = store
    srv.kv_port = srv.server_address[1]
    return srv


def _announce_ready(port: int) -> None:
    print(json.dumps({"ready": True, "port": port}), flush=True)


# ---------------------------------------------------------------------------
# parent-side spawn/reap (bench.py and the test harness share these — the
# worker lifecycle must not drift between two copies)
# ---------------------------------------------------------------------------

def _discard_pipe(pipe) -> None:
    try:
        for _ in iter(pipe.readline, ""):
            pass
    except (ValueError, OSError):
        pass                            # reap closed the pipe under us


def spawn_worker(args: list[str], env: dict | None = None,
                 wait_ready_s: float = 60.0, cwd: str | None = None):
    """Spawn `python -m tempo_tpu_torch.fleet.worker ...`; block until its JSON
    ready line (or death, surfaced with the stderr tail; not-ready
    timeout kills the child — never leaks). After ready, both pipes are
    handed to daemon drain threads: a chatty child (warning spew,
    handoff-retry tracebacks) must never block on a full 64KB pipe
    buffer mid-soak. Returns the Popen with `.ready` (the parsed line)
    attached."""
    import os
    import select
    import subprocess
    import time

    e = dict(os.environ)
    e.update(env or {})
    p = subprocess.Popen(
        [sys.executable, "-m", "tempo_tpu_torch.fleet.worker", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=cwd, env=e)
    # stderr must drain BEFORE ready too: heavy startup spew (platform
    # warnings, config.check noise) filling the unread 64KB pipe would
    # block the child in write() and it never reaches its ready line.
    # The tail is kept so a death/timeout still reports the real cause.
    err_tail: list[str] = []

    def read_err() -> None:
        line = p.stderr.readline()
        if line:
            err_tail.append(line)
            del err_tail[:-40]
    deadline = time.time() + wait_ready_s
    while time.time() < deadline:
        if p.poll() is not None:
            err_tail.append(p.stderr.read() or "")
            raise RuntimeError(
                f"fleet worker died rc={p.returncode} before ready: "
                f"{''.join(err_tail)[-2000:]}")
        readable, _, _ = select.select([p.stdout, p.stderr], [], [], 0.2)
        if p.stderr in readable:
            read_err()
        if p.stdout not in readable:
            continue
        line = p.stdout.readline()
        if not line:
            continue
        try:
            doc = json.loads(line)
        except json.JSONDecodeError:
            continue
        if doc.get("ready"):
            p.ready = doc
            for pipe in (p.stdout, p.stderr):
                threading.Thread(target=_discard_pipe, args=(pipe,),
                                 daemon=True).start()
            return p
    p.kill()
    p.wait(timeout=5)
    raise RuntimeError(f"fleet worker not ready in {wait_ready_s}s: "
                       f"{''.join(err_tail)[-2000:]}")


def reap_workers(procs, term_wait_s: float = 10.0) -> None:
    """SIGTERM every child, bounded wait, SIGKILL fallback, close pipes
    — a failing caller must not leak generator processes."""
    import subprocess
    import time

    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.time() + term_wait_s
    for p in procs:
        try:
            p.wait(timeout=max(0.1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=5)
        for pipe in (p.stdout, p.stderr):
            if pipe:
                try:
                    pipe.close()
                except OSError:
                    pass


def main(argv: list[str] | None = None, device=None) -> int:
    """The worker's entry. The member's App runs on `device` (`cuda`
    unless `"cpu"` is asked for, as `python -m tempo_tpu_torch` does)."""
    ap = argparse.ArgumentParser(
        prog="tempo_tpu_torch.fleet.worker",
        description="Run one generator-fleet member (or a KV-only "
                    "ring-state server)")
    ap.add_argument("--config", help="App YAML (fleet member mode)")
    ap.add_argument("--kv-only", action="store_true",
                    help="serve only the /kv CAS routes")
    ap.add_argument("--port", type=int, default=0,
                    help="kv-only listen port (0 = ephemeral)")
    args = ap.parse_args(argv)

    if args.kv_only:
        srv = make_kv_server(args.port)
        _announce_ready(srv.kv_port)
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            srv.shutdown()
        return 0

    if not args.config:
        ap.error("--config is required unless --kv-only")
    from tempo_tpu_torch.app.api import serve
    from tempo_tpu_torch.app.app import App
    from tempo_tpu_torch.app.config import load_config

    app = App(load_config(args.config), device=device)
    app.start_loops()
    srv = serve(app, block=False)
    # handler threads must be JOINABLE: a push acked to the client after
    # the shutdown checkpoint gathered would be silently lost, so
    # shutdown below stops accepting, JOINS in-flight handlers, and only
    # then lets App.shutdown cut the checkpoints
    srv.daemon_threads = False
    # announce the BOUND port, not the configured one: port 0 (ephemeral)
    # must hand the parent a dialable address. The ring joined at App
    # construction with the configured port, so ephemeral members must
    # also re-advertise: patch the config, rewrite each lifecycler's
    # addr, and heartbeat to republish the descriptor before traffic
    # resolves it. (Ephemeral mode needs an explicit instance_id — the
    # derived hostname-port id would collide between two :0 members.)
    bound = srv.server_address[1]
    if bound != app.cfg.server.http_listen_port:
        app.cfg.server.http_listen_port = bound
        for lc in app._lifecyclers:
            lc.desc.addr = app._advertise()
            lc.heartbeat()
    _announce_ready(bound)
    # SIGTERM must run the graceful path: App.shutdown cuts the
    # shutdown checkpoints the restart/handoff protocol depends on
    stop = threading.Event()
    import signal
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    stop.wait()
    srv.shutdown()
    srv.server_close()                  # joins in-flight handler threads
    app.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
