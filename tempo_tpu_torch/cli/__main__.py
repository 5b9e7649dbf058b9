"""tempo-cli analog: block inspection, direct block queries, maintenance.

Commands (subset of the reference's 27, the operationally load-bearing ones):

  list blocks <tenant>            blocklist table (`cmd-list-blocks.go`)
  list block <tenant> <block>     one block's meta + row groups
  list compaction-summary <tenant> per-level rollup (`cmd-list-compactionsummary.go`)
  analyse block <tenant> <block>  attr cardinality/bytes → dedicated-column
                                  candidates (`cmd-analyse-block.go`)
  query trace <tenant> <hex-id>   direct backend trace lookup (`cmd-query-blocks.go`)
  query search <tenant> <traceql> direct backend TraceQL search
  query api ...                   against a live server via the HTTP client
  gen bloom|index <tenant> <block>  regenerate derived files (`cmd-gen-*.go`)
  rewrite drop <tenant> <block> <hex-id>  rebuild a block without a trace
                                  (`cmd-rewrite-blocks.go` drop-trace)
  migrate tenant <src-tenant> <dst-tenant>  copy blocks (`cmd-migrate-tenant.go`)
  list column-sizes <tenant> <block>  per-column byte stats (`cmd-list-column.go`)
  list wal <dir>                  WAL segment/span inventory
  view rows <tenant> <block>      dump span rows as JSON lines
  query attr <tenant> <key> <value>  one-attribute backend search
  compact dry-run <tenant>        pending compaction jobs, read-only

Backend selection: --backend local --path DIR (or mem for tests).

Counterpart of `tempo_tpu/cli/__main__.py`, host code copied with its
imports moved to the port. The commands that open a `TempoDB` run its
read plane on `cuda` unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import sys


def _open_backend(args):
    if args.backend == "local":
        from tempo_tpu_torch.backend.local import LocalBackend
        be = LocalBackend(args.path)
        return be, be
    raise SystemExit(f"unsupported backend {args.backend!r} (use --backend local)")


def _db(args):
    from tempo_tpu_torch.db.tempodb import TempoDB
    r, w = _open_backend(args)
    db = TempoDB(r, w, device=getattr(args, "device", None))
    db.poll_now()
    return db


def cmd_list_blocks(args) -> int:
    db = _db(args)
    metas = db.blocklist.metas(args.tenant)
    print(f"{'ID':38} {'LVL':>3} {'OBJECTS':>9} {'SPANS':>9} {'SIZE':>10} "
          f"{'RF':>2} {'START':>12} {'END':>12}")
    for m in sorted(metas, key=lambda m: m.start_time):
        print(f"{m.block_id:38} {m.compaction_level:>3} {m.total_objects:>9} "
              f"{m.total_spans:>9} {m.size_bytes:>10} {m.replication_factor:>2} "
              f"{m.start_time:>12.0f} {m.end_time:>12.0f}")
    print(f"total: {len(metas)} blocks, "
          f"{sum(m.total_objects for m in metas)} traces, "
          f"{sum(m.size_bytes for m in metas)} bytes")
    return 0


def cmd_list_block(args) -> int:
    db = _db(args)
    from tempo_tpu_torch.backend.meta import read_block_meta
    m = read_block_meta(db.r, args.block, args.tenant)
    print(json.dumps(m.to_json(), indent=2))
    b = db.backend_block(m)
    for i, rg in enumerate(b.row_group_index()):
        print(f"row group {i}: rows={rg['rows']} offset={rg['row_offset']} "
              f"ids=[{rg['min_trace_id'][:8]}..{rg['max_trace_id'][:8]}]")
    return 0


def cmd_cache_summary(args) -> int:
    """Bloom-filter bytes by age (days) × compaction level — the cache
    sizing view (`cmd-list-cachesummary.go`: operators size the bloom
    cache role from this table)."""
    import time as _time

    from tempo_tpu_torch.backend.raw import block_keypath
    from tempo_tpu_torch.block.bloom import shard_name

    db = _db(args)
    now = _time.time()
    # (level, age_days) -> [shard_count, bloom_bytes]
    table: dict[tuple[int, int], list[int]] = {}
    max_lvl = max_age = 0
    for m in db.blocklist.metas(args.tenant):
        age = max(int((now - m.start_time) / 86400), 0)
        lvl = int(m.compaction_level)
        max_lvl, max_age = max(max_lvl, lvl), max(max_age, age)
        cell = table.setdefault((lvl, age), [0, 0])
        kp = block_keypath(m.block_id, args.tenant)
        for i in range(max(m.bloom_shard_count, 1)):
            try:
                cell[1] += db.r.size(shard_name(i), kp)
                cell[0] += 1
            except Exception:
                pass
    print("bloom filter shards by age (days) x compaction level:")
    hdr = "lvl " + "".join(f"{f'{d}d':>12}" for d in range(max_age + 1))
    print(hdr)
    total = 0
    for lvl in range(max_lvl + 1):
        row = [table.get((lvl, d), [0, 0]) for d in range(max_age + 1)]
        total += sum(c[1] for c in row)
        print(f"{lvl:>3} " + "".join(
            f"{f'{c[0]}/{c[1]}B':>12}" for c in row))
    print(f"total bloom bytes: {total}")
    return 0


def cmd_trace_summary(args) -> int:
    """Cross-block summary of one trace: block/span counts, duration,
    root span, service breakdown (`cmd-query-trace-summary.go`)."""
    db = _db(args)
    tid = bytes.fromhex(args.trace_id)
    n_blocks = 0
    spans: list[dict] = []
    size = 0
    for m in db.blocks(args.tenant):
        got = db.backend_block(m).find_trace_by_id(tid)
        if got:
            n_blocks += 1
            spans.extend(got)
            size += sum(len(s.get("name", "")) + 64 for s in got)
    if not spans:
        print("trace not found")
        return 1
    from tempo_tpu_torch.model.combine import combine_spans
    spans = combine_spans(spans)
    start = min(s["start_unix_nano"] for s in spans)
    end = max(s["end_unix_nano"] for s in spans)
    by_svc: dict[str, int] = {}
    root = None
    for s in spans:
        by_svc[s.get("service", "")] = by_svc.get(s.get("service", ""), 0) + 1
        if not s.get("parent_span_id", b"").rstrip(b"\0"):
            root = s
    print(f"number of blocks: {n_blocks}")
    print(f"span count: {len(spans)}")
    print(f"trace size: ~{size} B")
    print(f"trace duration: {(end - start) / 1e9:.3f} seconds")
    print(f"root service name: {root.get('service', '') if root else '-'}")
    if root is not None:
        print(f"root span: name={root.get('name')!r} "
              f"kind={root.get('kind')} status={root.get('status_code')} "
              f"dur={(root['end_unix_nano'] - root['start_unix_nano']) / 1e6:.1f}ms")
    else:
        print("no root span found")
    print("top service.names:")
    for svc, n in sorted(by_svc.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {n:>6} {svc}")
    return 0


def cmd_compaction_summary(args) -> int:
    db = _db(args)
    levels: dict[int, list] = {}
    for m in db.blocklist.metas(args.tenant):
        levels.setdefault(m.compaction_level, []).append(m)
    print(f"{'LVL':>3} {'BLOCKS':>7} {'OBJECTS':>10} {'SIZE':>12}")
    for lvl in sorted(levels):
        ms = levels[lvl]
        print(f"{lvl:>3} {len(ms):>7} {sum(m.total_objects for m in ms):>10} "
              f"{sum(m.size_bytes for m in ms):>12}")
    return 0


def _flat(col) -> list:
    """A list column's values, flattened (the port's `block.parquet`)."""
    from tempo_tpu_torch.block.parquet import column_pylist
    return column_pylist(col.values)


def _accumulate_attr_bytes(pf, totals: dict) -> None:
    """Sum per-(scope, key) value bytes over a block's attr list columns
    (shared by `analyse block` and `analyse blocks`)."""
    for rg in range(pf.num_row_groups):
        tbl = pf.read_row_group(rg, columns=[
            c for c in pf.names if "attr" in c])
        for col in tbl.names:
            if not col.endswith("_keys"):
                continue
            vals_col = col.replace("_keys", "_vals")
            if vals_col not in tbl.names:
                continue
            scope = "span" if col.startswith("s") else "resource"
            kf = _flat(tbl.column(col))
            vf = _flat(tbl.column(vals_col))
            for k, v in zip(kf, vf):
                totals[(scope, k)] = totals.get((scope, k), 0) + len(str(v))


def cmd_analyse_block(args) -> int:
    """Attribute stats → dedicated-column candidates (`cmd-analyse-block.go`)."""
    db = _db(args)
    from tempo_tpu_torch.backend.meta import read_block_meta
    m = read_block_meta(db.r, args.block, args.tenant)
    stats: dict[tuple, int] = {}
    _accumulate_attr_bytes(db.backend_block(m).parquet_file(), stats)
    top = sorted(stats.items(), key=lambda kv: -kv[1])[: args.top]
    print(f"{'SCOPE':>9} {'ATTRIBUTE':40} {'BYTES':>12}")
    for (scope, k), sz in top:
        print(f"{scope:>9} {k:40} {sz:>12}")
    print("\ndedicated-column candidates (YAML):")
    for (scope, k), _ in top[:10]:
        print(f"  - {{scope: {scope}, name: {k}, type: string}}")
    return 0


def cmd_query_trace(args) -> int:
    db = _db(args)
    spans = db.find_trace_by_id(args.tenant, bytes.fromhex(args.trace_id))
    if not spans:
        print("trace not found", file=sys.stderr)
        return 1
    for s in spans:
        print(json.dumps({**s, "trace_id": s["trace_id"].hex(),
                          "span_id": s.get("span_id", b"").hex(),
                          "parent_span_id": s.get("parent_span_id", b"").hex()}))
    return 0


def cmd_query_search(args) -> int:
    db = _db(args)
    res = db.search(args.tenant, args.query, limit=args.limit)
    for md in res:
        print(json.dumps(md.to_json()))
    return 0


def cmd_query_api(args) -> int:
    from tempo_tpu_torch.client import Client
    c = Client(args.url, tenant=args.tenant)
    if args.what == "trace":
        print(json.dumps(c.trace_by_id(args.arg), indent=2))
    elif args.what == "search":
        print(json.dumps(c.search(args.arg, limit=args.limit), indent=2))
    elif args.what == "tags":
        print(json.dumps(c.search_tags(), indent=2))
    return 0


def cmd_gen(args) -> int:
    """Regenerate bloom/index for a block from its data file."""
    db = _db(args)
    from tempo_tpu_torch.backend.meta import read_block_meta
    from tempo_tpu_torch.backend.raw import block_keypath
    from tempo_tpu_torch.block.bloom import ShardedBloom, shard_name
    m = read_block_meta(db.r, args.block, args.tenant)
    b = db.backend_block(m)
    pf = b.parquet_file()
    kp = block_keypath(args.block, args.tenant)
    tids = []
    rgs = []
    row = 0
    for rg in range(pf.num_row_groups):
        from tempo_tpu_torch.block.parquet import column_pylist
        tbl = pf.read_row_group(rg, columns=["trace_id"])
        col = column_pylist(tbl.column("trace_id"))
        tids.extend(col)
        rgs.append({"row_offset": row, "rows": len(col),
                    "min_trace_id": bytes(col[0]).hex() if col else "",
                    "max_trace_id": bytes(col[-1]).hex() if col else ""})
        row += len(col)
    uniq = sorted({bytes(t) for t in tids})
    if args.what == "bloom":
        bloom = ShardedBloom(m.bloom_shard_count, max(len(uniq), 1), 0.01)
        for t in uniq:
            bloom.add(t.ljust(16, b"\0")[:16])
        for i in range(bloom.shard_count):
            db.w.write(shard_name(i), kp, bloom.shard_bytes(i))
        print(f"bloom regenerated: {len(uniq)} ids, {m.bloom_shard_count} shard(s)")
    else:
        db.w.write("index.json", kp, json.dumps({"row_groups": rgs}).encode())
        print(f"index regenerated: {len(rgs)} row groups")
    return 0


def cmd_rewrite_drop(args) -> int:
    """Rebuild a block excluding a trace id (`tempo-cli rewrite-blocks`)."""
    db = _db(args)
    from tempo_tpu_torch.backend.meta import mark_block_compacted, read_block_meta
    from tempo_tpu_torch.block.writer import write_block
    from tempo_tpu_torch.db.compactor import iter_trace_groups
    drop = bytes.fromhex(args.trace_id)
    m = read_block_meta(db.r, args.block, args.tenant)
    b = db.backend_block(m)
    kept = [(tid, spans) for tid, spans in iter_trace_groups(b)
            if tid.rstrip(b"\0") != drop.rstrip(b"\0")]
    new = write_block(db.w, args.tenant, kept,
                      dedicated_columns=m.dedicated_columns,
                      replication_factor=m.replication_factor,
                      compaction_level=m.compaction_level)
    mark_block_compacted(db.r, db.w, m.block_id, args.tenant)
    print(f"rewrote {m.block_id} -> {new.block_id}: "
          f"{m.total_objects} -> {new.total_objects} traces")
    return 0


def cmd_migrate_tenant(args) -> int:
    db = _db(args)
    from tempo_tpu_torch.backend.raw import block_keypath, blocks as list_blocks
    n = 0
    for bid in list_blocks(db.r, args.src):
        src_kp = block_keypath(bid, args.src)
        dst_kp = block_keypath(bid, args.dst)
        for name in db.r.find(src_kp):
            data = db.r.read(name, src_kp)
            if name == "meta.json":
                d = json.loads(data)
                d["tenant_id"] = args.dst
                data = json.dumps(d).encode()
            db.w.write(name, dst_kp, data)
        n += 1
    print(f"migrated {n} blocks {args.src} -> {args.dst}")
    return 0


def cmd_analyse_blocks(args) -> int:
    """Cross-block rollup of `analyse block` (`cmd-analyse-blocks.go`)."""
    db = _db(args)
    metas = sorted(db.blocklist.metas(args.tenant),
                   key=lambda m: -m.size_bytes)[: args.max_blocks]
    if not metas:
        print("no blocks", file=sys.stderr)
        return 1
    totals: dict[tuple, int] = {}
    for m in metas:
        _accumulate_attr_bytes(db.backend_block(m).parquet_file(), totals)
    top = sorted(totals.items(), key=lambda kv: -kv[1])[: args.top]
    print(f"analysed {len(metas)} block(s)")
    print(f"{'SCOPE':>9} {'ATTRIBUTE':40} {'BYTES':>12}")
    for (scope, k), sz in top:
        print(f"{scope:>9} {k:40} {sz:>12}")
    return 0


def cmd_list_index(args) -> int:
    """Tenant index contents (`cmd-list-index.go`)."""
    from tempo_tpu_torch.backend import meta as bm
    db = _db(args)
    try:
        idx = bm.read_tenant_index(db.r, args.tenant)
    except Exception as e:
        print(f"no tenant index: {e}", file=sys.stderr)
        return 1
    print(json.dumps({
        "created_at": idx.created_at,
        "meta": [m.to_json() for m in idx.metas],
        "compacted": [c.to_json() for c in idx.compacted],
    }, indent=2))
    return 0


def cmd_view_schema(args) -> int:
    """Parquet schema of a block's data file (`cmd-view-pq-schema.go`)."""
    db = _db(args)
    from tempo_tpu_torch.backend.meta import read_block_meta
    m = read_block_meta(db.r, args.block, args.tenant)
    pf = db.backend_block(m).parquet_file()
    # the port's codec keeps (name, type) pairs where pyarrow prints an
    # Arrow schema
    for name, typ in pf.schema:
        print(f"{name}: {typ}")
    print(f"\nrow groups: {pf.num_row_groups}  rows: {pf.num_rows}"
          f"  size: {m.size_bytes}B")
    return 0


def cmd_query_metrics(args) -> int:
    """TraceQL metrics over backend blocks (the query-range path the
    metrics queriers run; `tempo-cli query api metrics` analog)."""
    import time as _t

    from tempo_tpu_torch.traceql.engine_metrics import QueryRangeRequest
    db = _db(args)
    end = args.end or _t.time()
    start = args.start or end - 3600
    req = QueryRangeRequest(query=args.query, start_ns=int(start * 1e9),
                            end_ns=int(end * 1e9),
                            step_ns=int(args.step * 1e9))
    for s in db.query_range(args.tenant, req):
        print(json.dumps({"labels": list(s.labels),
                          "samples": [float(v) for v in s.samples]}))
    return 0


def cmd_query_tags(args) -> int:
    """Distinct attr keys straight off the blocks' key-list columns."""
    from tempo_tpu_torch.block.fetch import block_tag_names
    db = _db(args)
    out: dict[str, set] = {"span": set(), "resource": set()}
    for m in db.blocklist.metas(args.tenant):
        got = block_tag_names(db.backend_block(m), limit=args.limit)
        out["span"] |= got["span"]
        out["resource"] |= got["resource"]
    print(json.dumps({k: sorted(v) for k, v in out.items()}, indent=2))
    return 0


def cmd_list_column_sizes(args) -> int:
    """Per-parquet-column compressed/uncompressed byte stats for one block
    (`cmd-list-column.go` / the size half of `cmd-analyse-block.go`)."""
    from tempo_tpu_torch.backend.meta import read_block_meta

    db = _db(args)
    m = read_block_meta(db.r, args.block, args.tenant)
    md = db.backend_block(m).parquet_file()
    agg: dict[str, list[int]] = {}
    for rg in range(md.num_row_groups):
        for path, comp, raw in md.column_chunk_sizes(rg):
            a = agg.setdefault(path, [0, 0])
            a[0] += comp
            a[1] += raw
    total_c = sum(v[0] for v in agg.values()) or 1
    print(f"{'COLUMN':42} {'COMPRESSED':>12} {'RAW':>12} {'%':>6}")
    for name, (comp, raw) in sorted(agg.items(), key=lambda kv: -kv[1][0]):
        print(f"{name:42} {comp:>12} {raw:>12} {100 * comp / total_c:>5.1f}%")
    print(f"total: {total_c} compressed bytes, "
          f"{md.num_rows} rows, {md.num_row_groups} row groups")
    return 0


def cmd_view_rows(args) -> int:
    """Dump span rows of one block as JSON lines (block inspect /
    dump-rows; `cmd-parquet-...`-style deep inspection)."""
    from tempo_tpu_torch.backend.meta import read_block_meta
    from tempo_tpu_torch.block.fetch import scan_views

    db = _db(args)
    block = db.backend_block(read_block_meta(db.r, args.block, args.tenant))
    rgs = [args.rg] if args.rg is not None else None
    left = args.limit
    for view, _cand in scan_views(block, None, row_groups=rgs):
        tid = view.col("trace:id")
        sid = view.col("span:id")
        name = view.col("name")
        svc = view.col("resource.service.name")
        dur = view.col("duration")
        st = view.col("__startTime")
        for i in range(view.n):
            if left <= 0:
                return 0
            print(json.dumps({
                "traceID": tid.values[i], "spanID": sid.values[i],
                "name": name.values[i], "service": svc.values[i],
                "startUnixNano": int(st.values[i]),
                "durationNanos": int(dur.values[i])}))
            left -= 1
    return 0


def cmd_search_attr(args) -> int:
    """Search backend blocks by one attribute equality — the quick
    operator triage shape (`cmd-search.go` attr mode) without writing
    TraceQL by hand."""
    import re as _re

    v = args.value
    qstr = '"' + v.replace('"', '\\"') + '"'
    if _re.fullmatch(r"-?\d+(\.\d+)?", v):
        # numeric-looking values OR both typings: attrs stored as string
        # "200" vs int 200 both match (incomparable arms are just false).
        # Strict literal check — float() would admit nan/inf/1_0, which
        # are not TraceQL numbers
        query = f'{{ .{args.key} = {qstr} || .{args.key} = {v} }}'
    else:
        query = f'{{ .{args.key} = {qstr} }}'
    db = _db(args)
    res = db.search(args.tenant, query, limit=args.limit)
    for md in res:
        print(f"{md.trace_id} {md.root_service_name} "
              f"{md.root_trace_name} {md.duration_ms}ms")
    print(f"{len(res)} traces for {query}")
    return 0


def cmd_list_wal(args) -> int:
    """Inspect a WAL directory: per-block segment/span/byte counts
    (`cmd-list-...` over `tempodb/wal`)."""
    import os

    from tempo_tpu_torch.block.wal import rescan_blocks

    blocks = rescan_blocks(args.dir)
    print(f"{'TENANT':16} {'BLOCK':38} {'SEGMENTS':>8} {'SPANS':>8} "
          f"{'BYTES':>10}")
    total = 0
    for wb in blocks:
        segs = wb.segments()
        nbytes = sum(os.path.getsize(s) for s in segs
                     if os.path.exists(s))
        nspans = sum(1 for _ in wb.iter_spans())
        total += nspans
        print(f"{wb.tenant:16} {wb.block_id:38} {len(segs):>8} "
              f"{nspans:>8} {nbytes:>10}")
    print(f"total: {len(blocks)} wal blocks, {total} spans")
    return 0


def cmd_compact_dryrun(args) -> int:
    """Show which block groups the time-window selector WOULD compact —
    no reads, no writes (`tempodb/compaction_block_selector.go` applied
    read-only)."""
    db = _db(args)
    metas = db.blocklist.metas(args.tenant)
    jobs = db.selector.blocks_to_compact(metas)
    if not jobs:
        print("nothing to compact")
        return 0
    for gi, group in enumerate(jobs):
        total = sum(m.size_bytes for m in group)
        print(f"job {gi}: {len(group)} blocks, {total} bytes")
        for m in group:
            print(f"  {m.block_id} lvl={m.compaction_level} "
                  f"objects={m.total_objects} size={m.size_bytes}")
    print(f"{len(jobs)} compaction job(s) pending")
    return 0


def cmd_usage_stats(args) -> int:
    """Print the persisted anonymized usage report (pkg/usagestats)."""
    from tempo_tpu_torch.backend.raw import KeyPath
    from tempo_tpu_torch.utils.usagestats import REPORT_NAME
    r, _w = _open_backend(args)
    try:
        print(r.read(REPORT_NAME, KeyPath(("usage-stats",))).decode())
    except Exception as e:
        print(f"no usage report: {e}", file=sys.stderr)
        return 1
    return 0


def cmd_version(_args) -> int:
    from tempo_tpu_torch import __version__
    print(f"tempo_tpu_torch {__version__}")
    return 0


def cmd_gen_docs(_args) -> int:
    """Config manifest from the dataclasses (`pkg/docsgen`
    generate_manifest.go analog): every key, type, and default."""
    import dataclasses

    from tempo_tpu_torch.app.config import Config

    print("# Configuration manifest\n")
    print("Generated from the config dataclasses "
          "(`python -m tempo_tpu_torch.cli gen docs`).\n")

    def walk(cls, prefix: str) -> None:
        rows = []
        subs = []
        for f in dataclasses.fields(cls):
            default = f.default
            if default is dataclasses.MISSING and \
                    f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
                default = f.default_factory()                       # type: ignore[misc]
            if dataclasses.is_dataclass(default):
                subs.append((f.name, type(default)))
                continue
            t = getattr(f.type, "__name__", None) or str(f.type)
            rows.append((f.name, t, default))
        if rows:
            print(f"## {prefix or '(root)'}\n")
            print("| key | type | default |")
            print("|---|---|---|")
            for name, t, d in rows:
                print(f"| `{prefix}{name}` | {t} | `{d!r}` |")
            print()
        for name, sub in subs:
            walk(sub, f"{prefix}{name}.")

    walk(Config, "")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser("tempo_tpu_torch.cli")
    ap.add_argument("--backend", default="local")
    ap.add_argument("--path", default="./tempo-data/blocks")
    ap.add_argument("--device", default=None,
                    help="the read plane's device (default cuda; cpu)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("list")
    ls = p.add_subparsers(dest="what", required=True)
    q = ls.add_parser("blocks"); q.add_argument("tenant"); q.set_defaults(fn=cmd_list_blocks)
    q = ls.add_parser("block"); q.add_argument("tenant"); q.add_argument("block"); q.set_defaults(fn=cmd_list_block)
    q = ls.add_parser("compaction-summary"); q.add_argument("tenant"); q.set_defaults(fn=cmd_compaction_summary)
    q = ls.add_parser("index"); q.add_argument("tenant"); q.set_defaults(fn=cmd_list_index)
    q = ls.add_parser("column-sizes"); q.add_argument("tenant"); q.add_argument("block")
    q.set_defaults(fn=cmd_list_column_sizes)
    q = ls.add_parser("wal"); q.add_argument("dir"); q.set_defaults(fn=cmd_list_wal)
    q = ls.add_parser("cachesummary"); q.add_argument("tenant")
    q.set_defaults(fn=cmd_cache_summary)

    p = sub.add_parser("analyse")
    an = p.add_subparsers(dest="what", required=True)
    q = an.add_parser("block"); q.add_argument("tenant"); q.add_argument("block")
    q.add_argument("--top", type=int, default=20); q.set_defaults(fn=cmd_analyse_block)
    q = an.add_parser("blocks"); q.add_argument("tenant")
    q.add_argument("--top", type=int, default=20)
    q.add_argument("--max-blocks", type=int, default=10)
    q.set_defaults(fn=cmd_analyse_blocks)

    p = sub.add_parser("view")
    vw = p.add_subparsers(dest="what", required=True)
    q = vw.add_parser("pq-schema"); q.add_argument("tenant"); q.add_argument("block")
    q.set_defaults(fn=cmd_view_schema)
    q = vw.add_parser("rows"); q.add_argument("tenant"); q.add_argument("block")
    q.add_argument("--rg", type=int, default=None)
    q.add_argument("--limit", type=int, default=50)
    q.set_defaults(fn=cmd_view_rows)

    p = sub.add_parser("query")
    qs = p.add_subparsers(dest="what", required=True)
    q = qs.add_parser("trace"); q.add_argument("tenant"); q.add_argument("trace_id"); q.set_defaults(fn=cmd_query_trace)
    q = qs.add_parser("trace-summary"); q.add_argument("tenant")
    q.add_argument("trace_id"); q.set_defaults(fn=cmd_trace_summary)
    q = qs.add_parser("search"); q.add_argument("tenant"); q.add_argument("query")
    q.add_argument("--limit", type=int, default=20); q.set_defaults(fn=cmd_query_search)
    q = qs.add_parser("metrics"); q.add_argument("tenant"); q.add_argument("query")
    q.add_argument("--start", type=float, default=0.0)
    q.add_argument("--end", type=float, default=0.0)
    q.add_argument("--step", type=float, default=60.0)
    q.set_defaults(fn=cmd_query_metrics)
    q = qs.add_parser("tags"); q.add_argument("tenant")
    q.add_argument("--limit", type=int, default=1000)
    q.set_defaults(fn=cmd_query_tags)
    q = qs.add_parser("attr"); q.add_argument("tenant")
    q.add_argument("key"); q.add_argument("value")
    q.add_argument("--limit", type=int, default=20)
    q.set_defaults(fn=cmd_search_attr)
    for what in ("trace", "search", "tags"):
        q = qs.add_parser(f"api-{what}")
        q.add_argument("url"); q.add_argument("tenant")
        q.add_argument("arg", nargs="?" if what == "tags" else None, default="")
        q.add_argument("--limit", type=int, default=20)
        q.set_defaults(fn=cmd_query_api, what=what)

    p = sub.add_parser("gen")
    g = p.add_subparsers(dest="what", required=True)
    for what in ("bloom", "index"):
        q = g.add_parser(what); q.add_argument("tenant"); q.add_argument("block")
        q.set_defaults(fn=cmd_gen, what=what)
    q = g.add_parser("docs"); q.set_defaults(fn=cmd_gen_docs)

    p = sub.add_parser("rewrite")
    rw = p.add_subparsers(dest="what", required=True)
    q = rw.add_parser("drop"); q.add_argument("tenant"); q.add_argument("block")
    q.add_argument("trace_id"); q.set_defaults(fn=cmd_rewrite_drop)

    p = sub.add_parser("migrate")
    mg = p.add_subparsers(dest="what", required=True)
    q = mg.add_parser("tenant"); q.add_argument("src"); q.add_argument("dst")
    q.set_defaults(fn=cmd_migrate_tenant)

    p = sub.add_parser("compact")
    cp = p.add_subparsers(dest="what", required=True)
    q = cp.add_parser("dry-run"); q.add_argument("tenant")
    q.set_defaults(fn=cmd_compact_dryrun)

    q = sub.add_parser("usage-stats"); q.set_defaults(fn=cmd_usage_stats)
    q = sub.add_parser("version"); q.set_defaults(fn=cmd_version)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
