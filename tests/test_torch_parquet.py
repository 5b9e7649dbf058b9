"""The port's Parquet codec (`tempo_tpu_torch/block/parquet.py`) against
pyarrow, the reference's Parquet library, on seeded numpy inputs.

- The port's files read by `pyarrow.parquet.read_table(...).to_pylist()`:
  every column type of the block schema (`CORE_FIELDS`) plus a nullable
  dedicated string column, with empty lists, empty strings, 0 rows,
  several row groups, several pages a column chunk, and both codecs.
- Files the reference's block writer makes (`write_block(...,
  compression="none"|"gzip")`: dictionary pages, `use_dictionary=True`)
  read by the port's reader, whole and by row group and column.
- Codecs the port cannot run raise `NotImplementedError` naming the codec,
  on write and on read (the input a reference block written with zstd);
  a DataPage V2 page raises naming it; a torn file raises `ParquetError`.
"""

from __future__ import annotations

import io

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from tempo_tpu.backend.mem import MemBackend as JMem
from tempo_tpu.block import schema as jschema
from tempo_tpu.block.writer import DATA_NAME
from tempo_tpu.block.writer import write_block as j_write_block
from tempo_tpu.backend.raw import block_keypath
from tempo_tpu.backend.meta import DedicatedColumn as JDed

from tempo_tpu_torch.block import parquet as P
from tempo_tpu_torch.block import schema as tschema

TYPES = sorted({t for _, t in tschema.CORE_FIELDS})


def _value(rng, typ):
    if typ.startswith("list<"):
        return [_value(rng, typ[5:-1]) for _ in range(int(rng.integers(0, 4)))]
    if typ.startswith("fixed"):
        return rng.bytes(int(typ[5:]))
    if typ == "string":
        return "".join(rng.choice(list("abcé✓ "), int(rng.integers(0, 12))))
    if typ == "bool":
        return bool(rng.integers(0, 2))
    if typ == "double":
        return float(rng.normal() * 1e6)
    if typ == "int8":
        return int(rng.integers(-128, 128))
    if typ == "int32":
        return int(rng.integers(-2**31, 2**31))
    return int(rng.integers(-2**62, 2**62))


def _rows(n, seed, schema):
    rng = np.random.default_rng(seed)
    cols = {name: [_value(rng, typ) for _ in range(n)] for name, typ in schema}
    for name, typ in schema:
        if name == "ded":
            cols[name] = [None if i % 3 == 0 else v
                          for i, v in enumerate(cols[name])]
    return cols


def _table(cols, schema):
    return P.ColumnTable(schema, {n: P.column_from_pylist(t, cols[n])
                                  for n, t in schema})


SCHEMA = list(tschema.CORE_FIELDS) + [("ded", "string")]


@pytest.mark.parametrize("compression", ["none", "gzip"])
@pytest.mark.parametrize("shape", ["one_group", "groups_and_pages"])
def test_port_files_read_by_pyarrow(compression, shape):
    n = 700
    cols = _rows(n, 11, SCHEMA)
    table = _table(cols, SCHEMA)
    kw = {}
    if shape == "groups_and_pages":
        kw = dict(row_groups=[(0, 250), (250, 251), (251, n)],
                  page_bytes=2048)
    data = P.write_table(table, compression=compression, **kw)
    want = [{name: cols[name][i] for name, _ in SCHEMA} for i in range(n)]
    pf = pq.ParquetFile(io.BytesIO(data))
    assert pf.read().to_pylist() == want
    assert pf.num_row_groups == (3 if kw else 1)
    codec = pf.metadata.row_group(0).column(0).compression
    assert codec == ("GZIP" if compression == "gzip" else "UNCOMPRESSED")
    # the port reads its own file back to the same values
    assert P.read_table(data).to_pylist() == want
    if kw:
        # several data pages in a chunk: more bytes than one page holds
        meta = pf.metadata.row_group(2).column(
            [n for n, _ in SCHEMA].index("sattr_str_keys"))
        assert meta.total_uncompressed_size > 2 * 2048


@pytest.mark.parametrize("typ", TYPES)
def test_each_type_alone_with_empties(typ):
    """One column of each block type: empty lists and strings in every
    position, beside ordinary values."""
    rng = np.random.default_rng(3)
    vals = [_value(rng, typ) for _ in range(40)]
    if typ.startswith("list<"):
        vals[0] = vals[17] = vals[-1] = []
    if typ == "string":
        vals[0] = vals[-1] = ""
    table = _table({"c": vals}, [("c", typ)])
    for compression in ("none", "gzip"):
        data = P.write_table(table, compression=compression,
                             row_groups=[(0, 17), (17, 40)], page_bytes=64)
        got = pq.read_table(io.BytesIO(data)).column("c").to_pylist()
        assert got == vals
        assert P.read_table(data).column("c") is not None
        assert P.column_pylist(P.read_table(data).column("c")) == vals


def test_zero_rows():
    table = _table({n: [] for n, _ in SCHEMA}, SCHEMA)
    data = P.write_table(table)
    got = pq.read_table(io.BytesIO(data))
    assert got.num_rows == 0 and got.column_names == [n for n, _ in SCHEMA]
    back = P.read_table(data)
    assert back.num_rows == 0 and back.names == [n for n, _ in SCHEMA]


def _ref_traces(seed, n_traces=40):
    rng = np.random.default_rng(seed)
    traces = []
    for _ in range(n_traces):
        tid = rng.bytes(16)
        spans = []
        sids = [rng.bytes(8) for _ in range(int(rng.integers(1, 6)))]
        for j, sid in enumerate(sids):
            spans.append({
                "trace_id": tid, "span_id": sid,
                "parent_span_id": b"" if j == 0 else sids[j - 1],
                "name": f"op-{int(rng.integers(0, 5))}",
                "service": f"svc-{int(rng.integers(0, 3))}",
                "kind": int(rng.integers(0, 6)),
                "status_code": int(rng.integers(0, 3)),
                "status_message": "" if j % 2 else "boom",
                "start_unix_nano": 10**18 + j,
                "end_unix_nano": 10**18 + j + int(rng.integers(0, 10**9)),
                "attrs": {"http.method": "GET", "code": int(rng.integers(0, 600)),
                          "ratio": float(rng.random()), "ok": bool(j % 2)}
                if j % 3 else {},
                "res_attrs": {"service.name": f"svc-{j}", "zone": "z1"},
                "events": [{"time_unix_nano": 5 + j, "name": "ev"}] * (j % 2),
                "links": [{"trace_id": rng.bytes(16), "span_id": rng.bytes(8)}]
                * (j % 3 == 2),
            })
        traces.append((tid, spans))
    return sorted(traces, key=lambda t: t[0])


@pytest.mark.parametrize("compression", ["none", "gzip"])
def test_reference_blocks_read_by_port(compression):
    """The reference writer's `data.parquet` (dictionary pages, several row
    groups) read whole, by row group and by column."""
    traces = _ref_traces(21)
    be = JMem()
    ded = [JDed("span", "http.method"), JDed("resource", "zone")]
    meta = j_write_block(be, "t", traces, row_group_rows=30,
                         dedicated_columns=ded, compression=compression)
    data = be.read(DATA_NAME, block_keypath(meta.block_id, "t"))
    ref = pq.ParquetFile(io.BytesIO(data))
    enc = ref.metadata.row_group(0).column(
        ref.schema_arrow.names.index("name")).encodings
    assert any("DICTIONARY" in e for e in enc)
    pf = P.ParquetFile(data)
    assert pf.num_row_groups == ref.num_row_groups > 1
    assert pf.read().to_pylist() == ref.read().to_pylist()
    for rg in range(pf.num_row_groups):
        assert pf.read_row_group(rg, ["trace_id", "sattr_str_vals"]) \
            .to_pylist() == ref.read_row_group(
                rg, columns=["trace_id", "sattr_str_vals"]).to_pylist()
    assert [n for n, _ in pf.schema] == jschema.block_schema(
        [type("D", (), {"scope": d.scope})() for d in ded]).names


@pytest.mark.parametrize("codec", ["zstd", "snappy", "brotli"])
def test_unsupported_codecs_raise_naming_them(codec):
    table = _table(_rows(5, 1, SCHEMA), SCHEMA)
    with pytest.raises(NotImplementedError, match=codec):
        P.write_table(table, compression=codec)
    if codec == "zstd":
        be = JMem()
        meta = j_write_block(be, "t", _ref_traces(5, 4))   # zstd default
        data = be.read(DATA_NAME, block_keypath(meta.block_id, "t"))
    else:
        buf = io.BytesIO()
        pq.write_table(pa.table({"s": ["a", "b"]}), buf, compression=codec)
        data = buf.getvalue()
    with pytest.raises(NotImplementedError, match=codec.upper()):
        P.read_table(data)


def test_data_page_v2_and_torn_files_raise():
    buf = io.BytesIO()
    pq.write_table(pa.table({"x": pa.array([1, 2, 3], pa.int64())}), buf,
                   compression="none", data_page_version="2.0")
    with pytest.raises(NotImplementedError, match="DATA_PAGE_V2"):
        P.read_table(buf.getvalue())
    data = P.write_table(_table(_rows(20, 2, SCHEMA), SCHEMA))
    for torn in (data[:-3], data[:len(data) // 2], b"PAR1", b""):
        with pytest.raises(P.ParquetError):
            P.read_table(torn)


def test_rle_hybrid_levels_round_trip():
    """Levels of max 0, 1 and 2 through the hybrid encoder and decoder,
    and pyarrow's mixed RLE / bit-packed runs through the decoder."""
    rng = np.random.default_rng(7)
    for bw in (0, 1, 2):
        for n in (1, 7, 8, 9, 1000):
            vals = rng.integers(0, 1 << bw, n).astype(np.uint32)
            enc = P.rle_encode(vals, bw)
            assert (P.rle_decode(enc, 0, len(enc), bw, n) == vals).all()
            const = np.full(n, (1 << bw) - 1, np.uint32)
            enc = P.rle_encode(const, bw)
            assert (P.rle_decode(enc, 0, len(enc), bw, n) == const).all()
    # runs then literals: dictionary indices of a column with repeats
    vals = ["a"] * 100 + [f"v{i}" for i in range(37)] + ["b"] * 9
    buf = io.BytesIO()
    pq.write_table(pa.table({"s": vals}), buf, compression="none",
                   use_dictionary=True)
    assert P.column_pylist(P.read_table(buf.getvalue()).column("s")) == vals
