"""The port's cloud backends, hedged reads and the shared cache tier
(`tempo_tpu_torch/backend/{cloud,s3,azure,memcached}.py`,
`utils/hedging.py`), against the reference's tests and in-process fakes.

- `tests/test_backend.py`: the raw-interface round trips over mem, local,
  the S3 fake (`tests/mock_s3.py`, SigV4 verified) and the Azure fake
  (`tests/mock_azure.py`, SharedKey verified), the factory (`:145`) and a
  `TempoDB` over S3 with `HedgedReader` (`:168`); each port client sends
  the same signed requests as the reference's to the same fake;
- `tests/test_aux.py:33,39,60,83` (hedging) and `:409,433,446,498` (the
  memcached and redis clients over `tests/mock_memcached.py`);
- the two memcached faults the port does not copy: `close()` with a full
  write-behind queue joins every worker, and no socket of an exited
  thread is kept.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from tempo_tpu_torch.backend import (
    BlockMeta,
    DoesNotExist,
    KeyPath,
    LocalBackend,
    MemBackend,
    block_keypath,
    blocks,
    clear_block,
    has_meta,
    read_block_meta,
    tenants,
    write_block_meta,
)
from tempo_tpu_torch.backend.cloud import ResilientBackend, open_backend
from tempo_tpu_torch.utils.hedging import HedgedMetrics, HedgedReader, hedged_call


def _s3(port, **kw):
    from tests.mock_s3 import ACCESS_KEY, REGION, SECRET_KEY

    return dict(bucket="test-bucket", endpoint=f"127.0.0.1:{port}",
                region=REGION, access_key=ACCESS_KEY, secret_key=SECRET_KEY,
                insecure=True, **kw)


def _azure(port):
    from tests.mock_azure import ACCOUNT, ACCOUNT_KEY, CONTAINER

    return dict(container_name=CONTAINER, storage_account_name=ACCOUNT,
                storage_account_key=ACCOUNT_KEY,
                endpoint=f"http://127.0.0.1:{port}")


@pytest.fixture(params=["mem", "local", "s3", "azure"])
def backend(request, tmp_path):
    if request.param == "mem":
        return open_backend("mem")
    if request.param == "local":
        return open_backend("local", path=str(tmp_path / "store"))
    if request.param == "s3":
        from tests.mock_s3 import start_mock_s3

        srv, port, _cls = start_mock_s3()
        request.addfinalizer(srv.shutdown)
        return open_backend("s3", **_s3(port))
    from tests.mock_azure import start_mock_azure

    srv, port, _cls = start_mock_azure()
    request.addfinalizer(srv.shutdown)
    return open_backend("azure", **_azure(port))


def test_raw_roundtrip_and_listing(backend):
    kp = block_keypath("b1", "tenant-a")
    backend.write("data.bin", kp, b"hello world")
    assert backend.read("data.bin", kp) == b"hello world"
    assert backend.read_range("data.bin", kp, 6, 5) == b"world"
    assert backend.size("data.bin", kp) == 11
    with pytest.raises(DoesNotExist):
        backend.read("nope", kp)
    for tenant in ("t1", "t2"):
        for b in ("b1", "b2"):
            backend.write("meta.json", block_keypath(b, tenant), b"{}")
    assert tenants(backend) == ["t1", "t2", "tenant-a"]
    assert blocks(backend, "t1") == ["b1", "b2"]
    assert backend.find(KeyPath(("t1",)), suffix="meta.json") == [
        "b1/meta.json", "b2/meta.json"]


def test_delete_append_and_meta(backend):
    kp = block_keypath("b1", "t")
    backend.write("a", kp, b"1")
    backend.write("b", kp, b"2")
    backend.delete("a", kp)
    with pytest.raises(DoesNotExist):
        backend.read("a", kp)
    assert backend.read("b", kp) == b"2"
    tracker = None
    for chunk in (b"aa", b"bb", b"cc"):
        tracker = backend.append("obj", kp, tracker, chunk)
    backend.close_append("obj", kp, tracker)
    assert backend.read("obj", kp) == b"aabbcc"
    clear_block(backend, "b1", "t")
    assert blocks(backend, "t") == []
    meta = BlockMeta.new("t1", start_time=100.0, end_time=200.0,
                         total_objects=10, total_spans=55)
    write_block_meta(backend, meta)
    assert read_block_meta(backend, meta.block_id, "t1") == meta
    assert has_meta(backend, meta.block_id, "t1") == (True, False)


@pytest.mark.parametrize("kind", ["s3", "azure"])
def test_clients_send_the_reference_requests(kind):
    """Both packages' clients against one fake: the same objects, the same
    listings, and the fake's own signature check passing for each."""
    from tempo_tpu.backend.cloud import open_backend as j_open
    from tempo_tpu.backend.raw import block_keypath as j_kp

    if kind == "s3":
        from tests.mock_s3 import start_mock_s3 as start
        cfg = _s3
    else:
        from tests.mock_azure import start_mock_azure as start
        cfg = _azure
    srv, port, _cls = start()
    try:
        t = open_backend(kind, **cfg(port))
        j = j_open(kind, **cfg(port))
        t.write("x", block_keypath("b", "port"), b"from the port")
        j.write("x", j_kp("b", "ref"), b"from the reference")
        for be, kp in ((t, block_keypath), (j, j_kp)):
            assert be.read("x", kp("b", "port")) == b"from the port"
            assert be.read("x", kp("b", "ref")) == b"from the reference"
        assert tenants(t) == ["port", "ref"]
        assert t.read_range("x", block_keypath("b", "ref"), 5, 3) == \
            j.read_range("x", j_kp("b", "ref"), 5, 3) == b"the"
    finally:
        srv.shutdown()


def test_open_backend_factory(tmp_path):
    from tempo_tpu_torch.backend.azure import AzureBackend
    from tempo_tpu_torch.backend.s3 import S3Backend

    assert isinstance(open_backend("mem"), MemBackend)
    assert isinstance(open_backend("local", path=str(tmp_path / "x")),
                      LocalBackend)
    s3 = open_backend("s3", bucket="b", access_key="k", secret_key="s")
    assert isinstance(s3, S3Backend) and s3.timeout == 30.0
    gcs = open_backend("gcs", bucket="b", access_key="k", secret_key="s")
    assert isinstance(gcs, S3Backend)
    assert "storage.googleapis.com" in gcs.base
    with pytest.raises((ValueError, TypeError)):
        open_backend("s3")   # bucket required
    az = open_backend("azure", container_name="c", storage_account_name="a",
                      storage_account_key="", op_timeout_s=3.0)
    assert isinstance(az, AzureBackend) and az.timeout == 3.0
    with pytest.raises((ValueError, TypeError)):
        open_backend("azure")   # container required
    with pytest.raises(ValueError):
        open_backend("bogus")


def test_tempodb_over_s3_with_hedged_reads():
    """Write, search and find against the S3 fake through the port's
    `TempoDB` with the hedged reader (`tests/test_backend.py:168`)."""
    from tempo_tpu_torch.db.tempodb import TempoDB
    from tests.mock_s3 import start_mock_s3

    srv, port, _cls = start_mock_s3()
    try:
        be = open_backend("s3", **_s3(port, prefix="traces"))
        db = TempoDB(HedgedReader(be, delay_s=0.5), be, device="cpu")
        t0 = int((time.time() - 60) * 1e9)
        tid = bytes.fromhex("11" * 16)
        spans = [{"trace_id": tid, "span_id": b"\x01" * 8, "name": "s3-op",
                  "kind": 2, "service": "s3-svc",
                  "start_unix_nano": t0, "end_unix_nano": t0 + 1_000_000,
                  "res_attrs": {"service.name": "s3-svc"}}]
        meta = db.write_block("tenant-s3", [(tid, spans)])
        assert meta.size_bytes > 0
        db.poll_now()
        assert [m.block_id for m in db.blocks("tenant-s3")] == [meta.block_id]
        found = db.find_trace_by_id("tenant-s3", tid)
        assert found and found[0]["name"] == "s3-op"
        res = db.search("tenant-s3", '{ resource.service.name = "s3-svc" }',
                        limit=5)
        assert len(res) == 1
        db.shutdown()
    finally:
        srv.shutdown()


def test_resilient_backend_retries_transient_faults():
    """`ResilientBackend` over the port's fault points: a transient
    failure is retried, a missing key is not."""
    from tempo_tpu_torch.utils import faults

    class Flaky(MemBackend):
        fails = 1

        def read(self, name, keypath):
            if self.fails:
                self.fails -= 1
                raise OSError("transient")
            return super().read(name, keypath)

    inner = Flaky()
    rb = ResilientBackend(inner, retries=2, backoff_s=0.001)
    kp = block_keypath("b", "t")
    rb.write("o", kp, b"v")
    assert rb.read("o", kp) == b"v" and inner.fails == 0
    with pytest.raises(DoesNotExist):
        rb.read("missing", kp)
    faults.configure(faults.FaultsConfig(allow=True, points={
        "backend.write": {"probability": 1.0}}))
    try:
        with pytest.raises(Exception):
            rb.write("o2", kp, b"v")
    finally:
        faults.reset()
    assert rb.size("o", kp) == 1          # unwrapped names forward


# ---------------------------------------------------------------------------
# hedged requests (tests/test_aux.py:33,39,60,83)
# ---------------------------------------------------------------------------

def test_hedged_call_fast_path_no_hedge():
    m = HedgedMetrics()
    assert hedged_call(lambda: 42, delay_s=0.5, metrics=m) == 42
    assert m.requests_total == 1 and m.hedged_total == 0


def test_hedged_call_hedges_slow_first_attempt():
    m = HedgedMetrics()
    calls = []
    lock = threading.Lock()

    def fn():
        with lock:
            calls.append(None)
            n = len(calls)
        if n == 1:
            time.sleep(1.0)  # slow first attempt
            return "slow"
        return "fast"

    t0 = time.perf_counter()
    out = hedged_call(fn, delay_s=0.05, metrics=m)
    assert out == "fast"
    assert time.perf_counter() - t0 < 0.8
    assert m.hedged_total == 1


def test_hedged_call_propagates_error_after_all_fail():
    def boom():
        raise RuntimeError("nope")
    with pytest.raises(RuntimeError, match="nope"):
        hedged_call(boom, delay_s=0.01)


def test_hedged_reader_wraps_reads():
    be = MemBackend()
    kp = KeyPath(("t", "b"))
    be.write("data", kp, b"hello")
    r = HedgedReader(be, delay_s=0.5)
    assert r.read("data", kp) == b"hello"
    assert r.read_range("data", kp, 1, 3) == b"ell"
    assert r.list(KeyPath(("t",))) == ["b"] and r.size("data", kp) == 5
    assert r.metrics.requests_total == 2 and r.metrics.hedged_total == 0


# ---------------------------------------------------------------------------
# the shared cache tier (tests/test_aux.py:409,433,446,498)
# ---------------------------------------------------------------------------

def test_memcached_client_roundtrip_and_sanitization():
    from tempo_tpu.backend.memcached import sanitize_key as j_sanitize
    from tempo_tpu_torch.backend.memcached import MemcachedCache, sanitize_key
    from tests.mock_memcached import start_mock_memcached

    srv, port, mock = start_mock_memcached()
    try:
        c = MemcachedCache(f"127.0.0.1:{port}")
        assert c.get("missing") is None and c.misses == 1
        c.put("k1", b"v1")
        c.flush()
        assert c.get("k1") == b"v1" and c.hits == 1
        long_key = "tenant/" + "x" * 300 + " with spaces"
        c.put(long_key, b"v2")
        c.flush()
        assert c.get(long_key) == b"v2"
        assert mock.bad_requests == 0
        assert sanitize_key(long_key) != long_key.encode()
        for k in ("k1", long_key, "a b", "é"):
            assert sanitize_key(k) == j_sanitize(k)
        c.close()
    finally:
        srv.shutdown()


def test_memcached_write_behind_drops_when_full():
    from tempo_tpu_torch.backend.memcached import MemcachedCache

    # no server at this address: the writer can't drain, the queue fills,
    # further puts DROP (counted) instead of blocking the read path
    c = MemcachedCache("127.0.0.1:1", write_back_buffer=4)
    for i in range(64):
        c.put(f"k{i}", b"v")
    assert c.dropped_writes > 0
    assert c.get("k0") is None          # dead server degrades to miss
    c.close()


def test_memcached_cross_instance_shared_cache():
    """Two port `TempoDB`s share one memcached: A's bloom and footer
    reads leave entries that B's reads hit."""
    from tempo_tpu_torch.backend.cache import CacheProvider, CachingReader
    from tempo_tpu_torch.backend.memcached import MemcachedCache
    from tempo_tpu_torch.db.tempodb import TempoDB, TempoDBConfig
    from tests.mock_memcached import start_mock_memcached

    srv, port, mock = start_mock_memcached()
    try:
        be = MemBackend()
        roles = ("bloom", "parquet-footer")

        def mk_db():
            shared = MemcachedCache(f"127.0.0.1:{port}")
            prov = CacheProvider(caches={r: shared for r in roles})
            return TempoDB(CachingReader(be, prov), be,
                           TempoDBConfig(device_plane=False),
                           device="cpu"), shared

        db_a, ca = mk_db()
        db_b, cb = mk_db()
        rng = np.random.default_rng(3)
        tid0 = None
        traces = []
        for i in range(50):
            tid = rng.bytes(16)
            tid0 = tid0 or tid
            start = 1_700_000_000_000_000_000 + i * 10**9
            traces.append((tid, [{
                "trace_id": tid, "span_id": rng.bytes(8), "name": "op",
                "service": "svc", "kind": 2, "status_code": 0,
                "start_unix_nano": start, "end_unix_nano": start + 10**6}]))
        traces.sort(key=lambda t: t[0])
        db_a.write_block("t", traces, replication_factor=1)
        db_a.poll_now()
        db_b.poll_now()
        assert db_a.find_trace_by_id("t", tid0)
        ca.flush()
        before = cb.hits
        assert db_b.find_trace_by_id("t", tid0)
        assert cb.hits > before, (cb.hits, cb.misses)
        assert mock.sets > 0 and mock.gets > 0
        db_a.shutdown()
        db_b.shutdown()
        ca.close()
        cb.close()
    finally:
        srv.shutdown()


def test_redis_cache_client_roundtrip_and_expiry():
    from tempo_tpu_torch.backend.memcached import RedisCache
    from tests.mock_memcached import start_mock_redis

    srv, port, mock = start_mock_redis()
    try:
        c = RedisCache(f"127.0.0.1:{port}", expiration_s=60)
        assert c.get("missing") is None and c.misses == 1
        c.put("k1", b"v1")
        c.flush()
        assert c.get("k1") == b"v1" and c.hits == 1
        assert mock.sets == 1 and mock.gets == 2
        errs = []

        def reader(i):
            for _ in range(50):
                if c.get("k1") != b"v1":
                    errs.append(i)

        ts = [threading.Thread(target=reader, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=5.0)
            assert not t.is_alive()
        assert not errs
        c.close()
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# the two memcached faults the port does not copy
# ---------------------------------------------------------------------------

def test_close_with_a_full_queue_joins_every_worker():
    """The reference's `close()` stops offering shutdown sentinels at the
    first full queue and joins with a timeout; the port's drops what is
    still queued, so every worker gets its sentinel and is joined."""
    from tempo_tpu_torch.backend.memcached import MemcachedCache

    gate = threading.Event()

    class Stuck(MemcachedCache):
        def _drain(self):
            gate.wait()               # workers busy: the queue stays full
            super()._drain()

    c = Stuck("127.0.0.1:1", write_back_buffer=2, write_back_workers=4)
    for i in range(16):
        c.put(f"k{i}", b"v")
    assert c._q.full() and c.dropped_writes == 14
    workers = list(c._workers)
    threading.Timer(0.05, gate.set).start()
    closer = threading.Thread(target=c.close)
    closer.start()
    closer.join(timeout=5.0)
    assert not closer.is_alive()
    assert not any(t.is_alive() for t in workers)
    assert c._workers == [] and c.dropped_writes == 16
    assert c._q.unfinished_tasks == 0


def test_no_socket_of_an_exited_thread_is_kept():
    from tempo_tpu_torch.backend.memcached import MemcachedCache
    from tests.mock_memcached import start_mock_memcached

    srv, port, _mock = start_mock_memcached()
    try:
        c = MemcachedCache(f"127.0.0.1:{port}")
        (conn,) = c._conns

        def reader():
            assert c.get("missing") is None

        for _ in range(3):
            ts = [threading.Thread(target=reader) for _ in range(4)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=5.0)
                assert not t.is_alive()
            assert len(conn._all) == 0
        reader()                          # this thread's socket stays
        assert len(conn._all) == 1
        conn._reset()
        assert len(conn._all) == 0
        c.close()
    finally:
        srv.shutdown()
