"""The benchmark's traffic: deterministic by seed, and the encoder's
bytes decode, through the port, to the spans it was given."""

import numpy as np
import pytest

from portbench.traffic import otlp, trees

SPACE = trees.LabelSpace(6, 5)


def _cols(seed, n=300):
    perms = trees.label_permutations(SPACE, [seed])
    return trees.trace_trees(n, space=SPACE, perms=perms,
                             rng=np.random.default_rng(seed), db_share=0.1)


@pytest.mark.parametrize("seed", [1, 2**31 + 17])
def test_trees_and_payloads_repeat_by_seed(seed):
    a, b = _cols(seed), _cols(seed)
    for f in ("trace_id", "span_id", "service", "name", "kind", "status",
              "db", "start_ns", "end_ns", "peer"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
    assert otlp.encode(a, SPACE).stamp(b"\x05" * 8, 10**18) == \
        otlp.encode(b, SPACE).stamp(b"\x05" * 8, 10**18)
    c = _cols(seed + 1)
    assert not np.array_equal(a.start_ns, c.start_ns)


def test_trees_shape():
    c = _cols(3, n=1001)
    assert c.n == 1001
    srv = np.flatnonzero(c.kind == trees.KIND_SERVER)
    # every server's parent is its pair's client span, in the same trace
    assert np.all(c.kind[c.peer[srv]] == trees.KIND_CLIENT)
    assert np.array_equal(c.parent_span_id[srv], c.span_id[c.peer[srv]])
    assert np.array_equal(c.trace_id[srv], c.trace_id[c.peer[srv]])
    assert np.all(c.db[srv] == -1)
    assert np.all(c.peer[c.db >= 0] == -1)
    assert np.all(c.duration_ns > 0)
    lab = trees.label_ids(c, SPACE)
    assert lab.min() >= 0 and lab.max() < SPACE.size


def test_payload_decodes_to_the_same_spans():
    from tempo_tpu_torch.model.otlp import spans_from_otlp_proto

    c = _cols(9)
    p = otlp.encode(c, SPACE)
    base = 1_700_000_000 * 10**9
    got = list(spans_from_otlp_proto(p.stamp(b"\x07" * 8, base)))
    assert len(got) == c.n
    for k, s in enumerate(got):
        i = p.order[k]
        assert s["name"] == SPACE.span_name(c.name[i])
        assert s["res_attrs"]["service.name"] == SPACE.service_name(c.service[i])
        assert s["kind"] == c.kind[i]
        assert s.get("status_code", 0) == c.status[i]
        assert s["start_unix_nano"] == base + c.start_ns[i]
        assert s["end_unix_nano"] == base + c.end_ns[i]
        assert s["trace_id"] == b"\x07" * 8 + c.trace_id[i, 8:].tobytes()
        assert s["span_id"] == c.span_id[i].tobytes()
        want_parent = c.parent_span_id[i].tobytes() if c.has_parent[i] else b""
        assert (s.get("parent_span_id") or b"") == want_parent
        db = s.get("attrs", {}).get("db.system")
        assert db == (trees.DB_SYSTEMS[c.db[i]] if c.db[i] >= 0 else None)


def test_span_sizes_are_the_wire_sizes():
    from tempo_tpu_torch.model.interner import StringInterner
    from tempo_tpu_torch.model.otlp_batch import batch_from_otlp

    c = _cols(4, n=64)
    p = otlp.encode(c, SPACE)
    sb, sizes = batch_from_otlp(p.stamp(b"\x01" * 8, 10**18),
                                StringInterner(), return_sizes=True)
    assert sorted(np.asarray(sizes)[:sb.n].tolist()) == \
        sorted(p.span_bytes.tolist())
