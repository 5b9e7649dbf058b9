"""The port's structural trace analysis (`tempo_tpu_torch/ops/structure.py`)
against the reference's (`tempo_tpu/ops/structure.py`).

On seeded forests with the reference test's corruption menu (extra
roots, orphans, parent 2-cycles, duplicate span ids, children that
outlive their parents: `tests/test_traceanalytics.py::
_gen_structure_batch`) and on hand-made corrupt traces, the port's
`analyze` (torch ops, on the CPU here) equals, bit for bit on every
output, the reference's `structure.analyze` (jitted jnp), the
reference's pure-Python oracle and the port's copy of it, at the cut's
pow-2 pads and at larger ones (`test_structure_padding_invariance`'s
rule). Root causes are compared on every row against the reference's
kernel (both iterate ⌈log2 n_pad⌉+1 times, so cycles end alike) and on
the settled mask the processor attributes under against the oracles.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tempo_tpu.ops import structure as rs
from tempo_tpu_torch.ops import structure as ps
from tests.test_traceanalytics import _bucket, _gen_structure_batch

KEYS = ("parent_row", "on_path", "bc", "ebc", "rc", "cyclic", "anchor")


def _same(a, b, ctx, keys=KEYS):
    for k in keys:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.shape == y.shape and np.array_equal(x, y), (ctx, k, x, y)


def _oracles_agree(grp, sid, pid, end, err):
    ref = rs.reference_analysis(grp, sid, pid, end, err)
    _same(ps.reference_analysis(grp, sid, pid, end, err), ref, "oracles")
    return ref


def _settled(res, err):
    n = len(err)
    return err & ~res["cyclic"] & (res["ebc"][np.clip(res["rc"], 0,
                                                      n - 1)] < 0)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_analyze_matches_both_oracles_at_two_pads(seed):
    """Every output equal to the oracles (root causes on the settled
    mask, where the oracle's chain walk and the pointer jumping agree by
    construction), at the cut's pads and at 4× / 2× larger ones."""
    rng = np.random.default_rng(seed)
    for trial in range(4):
        nt = int(rng.integers(1, 24))
        grp, sid, pid, start, end, err = _gen_structure_batch(nt, rng)
        n = len(grp)
        ref = _oracles_agree(grp, sid, pid, end, err)
        pads = [(_bucket(n, 256), _bucket(nt, 16)),
                (_bucket(n, 256) * 4, _bucket(nt, 16) * 2)]
        outs = [ps.analyze(grp, sid, pid, end, err, nt, *p, device="cpu")
                for p in pads]
        for res in outs:
            _same(res, ref, (seed, trial),
                  ("parent_row", "on_path", "bc", "ebc", "cyclic", "anchor"))
            ok = _settled(res, err)
            assert np.array_equal(ok, _settled(ref, err))
            assert np.array_equal(res["rc"][ok], ref["rc"][ok])
            assert np.array_equal(ps.self_times_ns(start, end, res),
                                  rs.self_times_ns(start, end, ref))
        _same(outs[0], outs[1], ("pads", seed, trial))


@pytest.mark.parametrize("seed", [11, 12])
def test_analyze_matches_the_reference_kernel(seed):
    """The port's analyze against the reference's jitted analyze on the
    same batch and pads: every output bit for bit, `rc` on every row."""
    rng = np.random.default_rng(seed)
    nt = 12
    grp, sid, pid, start, end, err = _gen_structure_batch(nt, rng)
    n = len(grp)
    pads = (_bucket(n, 256), _bucket(nt, 16))
    want = rs.analyze(grp, sid, pid, end, err, nt, *pads)
    got = ps.analyze(grp, sid, pid, end, err, nt, *pads, device="cpu")
    _same(got, want, seed)
    assert got["parent_row"].dtype == np.int32 and got["on_path"].dtype == bool


def _corrupt_batch():
    """Hand-made traces: a healthy tree with an errored chain; an orphan
    subtree; a two-span parent cycle of errored spans; a duplicate span
    id (the later row defines it); a self-parented span; equal end times
    (the row breaks the tie); a trace with no root at all."""
    rows = []   # (trace, span id, parent id, start, end, err)
    # trace 0: root 1 -> {2 (err), 3}; 2 -> 4 (err) -> 5 (err); 3 ends
    # with 2 (tie broken by row)
    rows += [(0, 1, 0, 0, 100, False), (0, 2, 1, 5, 90, True),
             (0, 3, 1, 5, 90, False), (0, 4, 2, 10, 80, True),
             (0, 5, 4, 20, 70, True)]
    # trace 1: root 10; orphan subtree 11 (parent 99, absent) -> 12
    rows += [(1, 10, 0, 0, 50, False), (1, 11, 99, 1, 40, True),
             (1, 12, 11, 2, 30, True)]
    # trace 2: errored 2-cycle 20 <-> 21 beside a root 22
    rows += [(2, 20, 21, 0, 10, True), (2, 21, 20, 0, 11, True),
             (2, 22, 0, 0, 5, False)]
    # trace 3: duplicate id 30 (rows a and b); child 31 resolves to b
    rows += [(3, 30, 0, 0, 60, False), (3, 30, 0, 1, 61, True),
             (3, 31, 30, 2, 50, True)]
    # trace 4: a span that is its own parent, and a child of it
    rows += [(4, 40, 40, 0, 9, True), (4, 41, 40, 1, 8, True)]
    # trace 5: no root: every span's parent is missing
    rows += [(5, 50, 77, 0, 9, False), (5, 51, 78, 0, 9, True)]
    le = lambda v: np.frombuffer(np.uint64(v).tobytes(), np.uint8)
    grp = np.array([r[0] for r in rows], np.int32)
    sid = np.stack([le(r[1]) for r in rows])
    pid = np.stack([le(r[2]) for r in rows])
    start = np.array([r[3] for r in rows], np.int64) + 1_700_000_000 * 10**9
    end = np.array([r[4] for r in rows], np.int64) + 1_700_000_000 * 10**9
    err = np.array([r[5] for r in rows], bool)
    return grp, sid, pid, start, end, err


def test_hand_made_corrupt_traces():
    grp, sid, pid, start, end, err = _corrupt_batch()
    nt, n = int(grp.max()) + 1, len(grp)
    ref = _oracles_agree(grp, sid, pid, end, err)
    res = ps.analyze(grp, sid, pid, end, err, nt, 256, 16, device="cpu")
    _same(res, ref, "corrupt", ("parent_row", "on_path", "bc", "ebc",
                                "cyclic", "anchor"))
    ok = _settled(res, err)
    assert np.array_equal(res["rc"][ok], ref["rc"][ok])
    # the contract's named cases, spelled out
    assert res["parent_row"][6] == ps.ORPHAN and res["parent_row"][7] == 6
    assert res["cyclic"][[8, 9]].all() and not res["cyclic"][10]
    assert res["parent_row"][13] == 12             # the later definition
    assert res["bc"][0] == 2                       # tie on end: larger row
    assert res["cyclic"][[14, 15]].all()           # self-parent loop
    assert res["anchor"][5] == -1                  # no root
    assert res["rc"][1] == 4 and res["rc"][3] == 4  # the chain's deepest
    assert res["on_path"][[0, 2]].all() and not res["on_path"][[1, 3, 4]].any()


def test_n_equal_to_pads_and_bad_pads():
    rng = np.random.default_rng(5)
    grp, sid, pid, start, end, err = _gen_structure_batch(3, rng)
    n, nt = len(grp), 3
    ref = _oracles_agree(grp, sid, pid, end, err)
    res = ps.analyze(grp, sid, pid, end, err, nt, n, nt, device="cpu")
    _same(res, ref, "exact pads", ("parent_row", "on_path", "bc", "ebc",
                                   "cyclic", "anchor"))
    for bad in ((n - 1, 16), (256, nt - 1)):
        with pytest.raises(ValueError, match="bad pad"):
            ps.analyze(grp, sid, pid, end, err, nt, *bad, device="cpu")


def test_large_cut_matches_the_oracle():
    """At least 4,096 spans, one seeded forest a trace (the card's run of
    the same check is in phase 13b of chip_smoke.py)."""
    rng = np.random.default_rng(9)
    parts = []
    while sum(len(p[0]) for p in parts) < 4096:
        parts.append(_gen_structure_batch(1, rng))
    grp = np.concatenate([np.full(len(p[0]), t, np.int32)
                          for t, p in enumerate(parts)])
    cat = [np.concatenate([p[i] for p in parts]) for i in range(1, 6)]
    sid, pid, start, end, err = cat
    nt = len(parts)
    ref = ps.reference_analysis(grp, sid, pid, end, err)
    res = ps.analyze(grp, sid, pid, end, err, nt, _bucket(len(grp), 256),
                     _bucket(nt, 16), device="cpu")
    _same(res, ref, "large", ("parent_row", "on_path", "bc", "ebc",
                              "cyclic", "anchor"))
    ok = _settled(res, err)
    assert np.array_equal(res["rc"][ok], ref["rc"][ok])


def test_id_limbs_match_reference():
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 256, (64, 8), dtype=np.uint8)
    for a, b in zip(ps.id_limbs(ids), rs.id_limbs(ids)):
        assert np.array_equal(a, b) and a.dtype == b.dtype
    assert ps.ROOT == rs.ROOT and ps.ORPHAN == rs.ORPHAN


def test_analyze_runs_on_cuda_unless_asked_for_the_cpu():
    grp, sid, pid, start, end, err = _corrupt_batch()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ps.analyze(grp, sid, pid, end, err, 6, 256, 16)
    res = ps.analyze(grp, sid, pid, end, err, 6, 256, 16, device="cpu")
    assert len(res["anchor"]) == 6 and len(res["rc"]) == len(grp)
    from tempo_tpu_torch.obs.runtime import RUNTIME

    assert 'tempo_jax_device_put_bytes_total{site="structure"}' in \
        RUNTIME.render()
