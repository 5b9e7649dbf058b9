"""The port's operator tools against the reference's.

Mirrors `tests/test_cli.py`'s 10 tests on the CPU: `python -m
tempo_tpu_torch.cli` (with `--device cpu`), the HTTP `client.py`, the
`vulture` prober and the `tempoquery` Jaeger storage plugin. The block
fixture is written once by the port (its gzip Parquet, which both
packages read) and copied to one directory a side; each command runs in
both CLIs, and their outputs are compared line for line after block ids
(random UUIDs), the package name and wall-clock stamps are masked. The live-server
tests run each tool against each side's App and compare the answers.
"""

from __future__ import annotations

import json
import re
import shutil
import time
import urllib.request

import pytest

from tests.test_torch_app import free_port, _reset_port
from tests.test_torch_frontend import mod

SIDES = ("port", "ref")
T0 = 1_700_000_000.0
UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                  r"[0-9a-f]{12}")



@pytest.fixture(autouse=True)
def _singletons():
    _reset_port()
    yield
    _reset_port()


def _db(side, path):
    be = mod(side, "backend.local").LocalBackend(path)
    TempoDB = mod(side, "db.tempodb").TempoDB
    return TempoDB(be, be, device="cpu") if side == "port" else TempoDB(be, be)


@pytest.fixture
def block_dir(tmp_path):
    """One block of 10 one-span traces, written by the port, copied to a
    directory a side."""
    src = str(tmp_path / "src")
    db = _db("port", src)
    traces = []
    for i in range(1, 11):
        tid = bytes([i]) * 16
        t0 = int((T0 + i) * 1e9)
        traces.append((tid, [{
            "trace_id": tid, "span_id": bytes([i]) * 8, "name": f"op-{i % 2}",
            "service": "svc", "start_unix_nano": t0,
            "end_unix_nano": t0 + 10 ** 6,
            "attrs": {"http.path": f"/page/{i}"}}]))
    meta = db.write_block("t1", traces)
    db.shutdown()
    paths = {}
    for side in SIDES:
        paths[side] = str(tmp_path / side)
        shutil.copytree(src, paths[side])
    return paths, meta


def run(side, paths, args, capsys):
    """One CLI command on one side: (exit code, masked stdout)."""
    main = mod(side, "cli.__main__").main
    argv = ["--path", paths[side]] + (["--device", "cpu"]
                                      if side == "port" else []) + args
    capsys.readouterr()
    rc = main(argv)
    out = capsys.readouterr().out
    out = UUID.sub("<id>", out).replace(paths[side], "<path>")
    out = re.sub(r'"created_at": [0-9.]+', '"created_at": <t>', out)
    return rc, out.replace("tempo_tpu_torch", "tempo_tpu")


def both(paths, args, capsys):
    """The command on both sides: equal exit codes and outputs."""
    got = {side: run(side, paths, args, capsys) for side in SIDES}
    assert got["port"] == got["ref"], args
    return got["port"]


def test_cli_list_blocks(block_dir, capsys):
    paths, meta = block_dir
    rc, out = both(paths, ["list", "blocks", "t1"], capsys)
    assert rc == 0 and "total: 1 blocks, 10 traces" in out
    rc, out = both(paths, ["list", "block", "t1", meta.block_id], capsys)
    assert rc == 0 and '"total_objects": 10' in out and "row group 0" in out
    assert both(paths, ["list", "compaction-summary", "t1"], capsys)[0] == 0


def test_cli_query(block_dir, capsys):
    paths, meta = block_dir
    tid = (bytes([3]) * 16).hex()
    rc, out = both(paths, ["query", "trace", "t1", tid], capsys)
    assert rc == 0 and '"op-1"' in out
    rc, out = both(paths, ["query", "search", "t1",
                           '{ .http.path = "/page/4" }'], capsys)
    assert rc == 0 and (bytes([4]) * 16).hex() in out
    assert both(paths, ["query", "trace", "t1", "ff" * 16], capsys)[0] == 1


def test_cli_analyse(block_dir, capsys):
    paths, meta = block_dir
    rc, out = both(paths, ["analyse", "block", "t1", meta.block_id], capsys)
    assert rc == 0 and "http.path" in out
    assert "dedicated-column candidates" in out


def test_cli_gen_and_rewrite(block_dir, capsys):
    """`gen bloom`/`gen index` and `rewrite drop`: the same outputs; each
    side's rewritten block (its own writer) lost exactly the dropped
    trace."""
    paths, meta = block_dir
    both(paths, ["gen", "bloom", "t1", meta.block_id], capsys)
    both(paths, ["gen", "index", "t1", meta.block_id], capsys)
    tid = (bytes([5]) * 16).hex()
    rc, out = both(paths, ["rewrite", "drop", "t1", meta.block_id, tid],
                   capsys)
    assert rc == 0 and "10 -> 9 traces" in out
    db = _db("port", paths["port"])
    db.poll_now()
    live = db.blocklist.metas("t1")
    assert len(live) == 1 and live[0].total_objects == 9
    assert db.find_trace_by_id("t1", bytes([5]) * 16) is None
    assert db.find_trace_by_id("t1", bytes([6]) * 16) is not None
    db.shutdown()


def test_cli_migrate_tenant(block_dir, capsys):
    paths, meta = block_dir
    assert both(paths, ["migrate", "tenant", "t1", "t2"], capsys)[0] == 0
    db = _db("port", paths["port"])
    db.poll_now()
    assert len(db.blocklist.metas("t2")) == 1
    assert db.find_trace_by_id("t2", bytes([1]) * 16) is not None
    db.shutdown()


def _app(side, tmp_path, port):
    Config = mod(side, "app.config").Config
    cfg = Config(target="all")
    cfg.storage.backend = "mem"
    cfg.storage.wal_path = str(tmp_path / side / "wal")
    cfg.generator.localblocks.data_dir = str(tmp_path / side / "lb")
    cfg.server.http_listen_port = port
    App = mod(side, "app").App
    app = App(cfg, device="cpu") if side == "port" else App(cfg)
    return app, mod(side, "app.api").serve(app, block=False)


def test_vulture_against_live_server(tmp_path, capsys):
    """Two vulture cycles (seed 42) against each side's App: both pass,
    with the same report."""
    got = {}
    for side in SIDES:
        port = free_port()
        app, srv = _app(side, tmp_path, port)
        app.start_loops()
        try:
            capsys.readouterr()
            rc = mod(side, "vulture.__main__").main(
                ["--url", f"http://127.0.0.1:{port}", "--cycles", "2",
                 "--interval", "0", "--read-delay", "0", "--seed", "42"])
            out = capsys.readouterr().out
            got[side] = (rc, re.sub(r"\d+\.\d+ ?m?s", "<t>", out))
        finally:
            srv.shutdown()
            app.shutdown()
            _reset_port()
    assert got["port"][0] == 0 and got["port"] == got["ref"]


def test_cli_new_commands(block_dir, capsys):
    paths, meta = block_dir
    rc, out = both(paths, ["analyse", "blocks", "t1"], capsys)
    assert "http.path" in out
    # the schema itself prints in each codec's own form (pyarrow's Arrow
    # schema against the port's name: type lines); the counts line equal
    got = {s: run(s, paths, ["view", "pq-schema", "t1", meta.block_id],
                  capsys) for s in SIDES}
    for rc, out in got.values():
        assert rc == 0 and "trace_id" in out and "row groups" in out
    assert got["port"][1].splitlines()[-1] == got["ref"][1].splitlines()[-1]
    rc, out = both(paths, ["query", "metrics", "t1",
                           "{ } | count_over_time()", "--start", str(T0),
                           "--end", str(T0 + 60), "--step", "60"], capsys)
    assert rc == 0 and '"samples"' in out
    rc, out = both(paths, ["query", "tags", "t1"], capsys)
    assert "http.path" in out
    rc, out = both(paths, ["list", "index", "t1"], capsys)
    assert rc == 0 and "<id>" in out
    rc, out = both(paths, ["version"], capsys)
    assert "tempo_tpu" in out
    assert both(paths, ["usage-stats"], capsys)[0] == 1
    for side in SIDES:
        rep = mod(side, "utils.usagestats").UsageReporter(
            mod(side, "ring.kv").KVStore(),
            mod(side, "backend.local").LocalBackend(paths[side]),
            instance_id="cli")
        assert rep.report_once()
    rc, out = {s: run(s, paths, ["usage-stats"], capsys)
               for s in SIDES}["port"]
    assert rc == 0 and "clusterID" in out


def _jaeger_reads(side, tmp_path, t0):
    import grpc

    from tempo_tpu_torch.model import proto_wire as pw

    port = free_port()
    app, srv = _app(side, tmp_path, port)
    qserver = None
    try:
        otlp = {"resourceSpans": [{"resource": {"attributes": [
            {"key": "service.name", "value": {"stringValue": "jq-svc"}}]},
            "scopeSpans": [{"spans": [{
                "traceId": "fe" * 16, "spanId": "12" * 8, "name": "jq-op",
                "kind": 2, "startTimeUnixNano": str(t0),
                "endTimeUnixNano": str(t0 + 5_000_000),
                "attributes": [{"key": "http.status_code",
                                "value": {"intValue": "500"}}]}]}]}]}
        urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/traces",
            data=json.dumps(otlp).encode(),
            headers={"Content-Type": "application/json"}), timeout=10).close()
        qserver, qport = mod(side, "tempoquery").build_tempo_query_server(
            f"http://127.0.0.1:{port}")
        reader = "/jaeger.storage.v1.SpanReaderPlugin/"
        with grpc.insecure_channel(f"127.0.0.1:{qport}") as ch:
            services = [bytes(v).decode() for v in pw.decode_fields(
                ch.unary_unary(reader + "GetServices")(b"")).get(1, [])]
            ops = [bytes(v).decode() for v in pw.decode_fields(
                ch.unary_unary(reader + "GetOperations")(b"")).get(1, [])]
            trace = list(ch.unary_stream(reader + "GetTrace")(
                pw.enc_field_bytes(1, bytes.fromhex("fe" * 16))))
            query = pw.enc_field_str(1, "jq-svc") + pw.enc_field_varint(8, 10)
            found = list(ch.unary_stream(reader + "FindTraces")(
                pw.enc_field_msg(1, query)))
            with pytest.raises(grpc.RpcError) as ei:
                list(ch.unary_stream(reader + "GetTrace")(
                    pw.enc_field_bytes(1, b"\x00" * 16)))
            assert ei.value.code() == grpc.StatusCode.NOT_FOUND
        assert "jq-svc" in services and "jq-op" in ops
        assert len(trace) == 1 and len(found) == 1
        sp = pw.decode_fields(bytes(pw.decode_fields(trace[0])[1][0]))
        assert bytes(sp[1][0]) == bytes.fromhex("fe" * 16)
        assert bytes(sp[3][0]).decode() == "jq-op"
        proc = pw.decode_fields(bytes(sp[10][0]))
        assert bytes(proc[1][0]).decode() == "jq-svc"
        tags = {bytes(pw.decode_fields(bytes(t))[1][0]).decode()
                for t in sp.get(8, [])}
        assert "span.kind" in tags and "http.status_code" in tags
        return services, ops, trace, found
    finally:
        if qserver is not None:
            qserver.stop(0)
        srv.shutdown()
        app.shutdown()
        _reset_port()


def test_tempo_query_jaeger_plugin(tmp_path):
    """The Jaeger storage plugin over each side's live App: services,
    operations, the trace as `api_v2` spans (byte for byte), the search,
    and NOT_FOUND for an unknown trace."""
    t0 = int((time.time() - 3) * 1e9)
    got = {side: _jaeger_reads(side, tmp_path, t0) for side in SIDES}
    assert got["port"] == got["ref"]


def test_cli_round4_commands(block_dir, capsys, tmp_path):
    paths, meta = block_dir
    rc, out = both(paths, ["list", "column-sizes", "t1", meta.block_id],
                   capsys)
    assert rc == 0 and "name" in out and "COMPRESSED" in out
    rc, out = both(paths, ["view", "rows", "t1", meta.block_id, "--limit",
                           "3"], capsys)
    lines = out.strip().splitlines()
    assert len(lines) == 3 and json.loads(lines[0])["service"] == "svc"
    rc, out = both(paths, ["query", "attr", "t1", "http.path", "/page/3"],
                   capsys)
    assert "1 traces" in out
    for side in SIDES:
        wb = mod(side, "block.wal").WALBlock(str(tmp_path / "wal" / side),
                                             "t1")
        wb.append([{"trace_id": b"\x01" * 16, "span_id": b"\x02" * 8,
                    "name": "w", "service": "svc",
                    "start_unix_nano": int(T0 * 1e9),
                    "end_unix_nano": int(T0 * 1e9) + 1000}])
        rc, out = run(side, paths, ["list", "wal",
                                    str(tmp_path / "wal" / side)], capsys)
        assert rc == 0 and "1 wal blocks, 1 spans" in out
    rc, out = both(paths, ["compact", "dry-run", "t1"], capsys)
    assert "nothing to compact" in out
    for side in SIDES:
        db = _db("port", paths[side])
        db.poll_now()
        for _ in range(3):
            db.write_block("t1", [(bytes([99]) * 16, [{
                "trace_id": bytes([99]) * 16, "span_id": bytes([9]) * 8,
                "name": "x", "service": "svc",
                "start_unix_nano": int((T0 + 1) * 1e9),
                "end_unix_nano": int((T0 + 1) * 1e9) + 1000}])])
        db.shutdown()
    rc, out = both(paths, ["compact", "dry-run", "t1"], capsys)
    assert "compaction job(s) pending" in out
    db = _db("port", paths["port"])
    db.poll_now()
    assert len(db.blocklist.metas("t1")) == 4
    db.shutdown()


def test_cli_cachesummary_and_trace_summary(block_dir, capsys):
    paths, meta = block_dir
    rc, out = both(paths, ["list", "cachesummary", "t1"], capsys)
    assert rc == 0 and "compaction level" in out
    assert int(out.rsplit("total bloom bytes:", 1)[1].strip()) > 0
    tid = (bytes([3]) * 16).hex()
    rc, out = both(paths, ["query", "trace-summary", "t1", tid], capsys)
    assert rc == 0 and "number of blocks: 1" in out
    assert "span count: 1" in out and "root service name: svc" in out
    assert "op-1" in out
    rc, out = both(paths, ["query", "trace-summary", "t1", "ff" * 16],
                   capsys)
    assert rc == 1 and "trace not found" in out
