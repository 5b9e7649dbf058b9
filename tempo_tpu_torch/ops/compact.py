"""Compaction helpers and the sketch sidecar's device pass.

Counterpart of `tempo_tpu/ops/compact.py`. The trace-id limbs, the pad
helper and the sidecar hashes are the reference's numpy code, copied:
`trace_hashes` must be bit-exact, since sidecars interchange between the
packages. `build_sidecar_arrays` is the per-block sidecar pass: a
moments row per dense (service, name) series over span durations
(`ops/moments.py`) and one HyperLogLog register row over trace ids
(`ops/sketches.py`), both computed as torch ops on the caller's device
and returned as host arrays. Both planes merge across blocks
elementwise (add / max), which is what makes a historical quantile a
fold instead of a re-scan.

The cold tier's merge/dedup/re-sort (`merge_order`) reproduces the host
compactor's contract (`heapq.merge` over trace-id-sorted blocks, then
`combine_spans`: the first occurrence of a (trace, span) id pair wins,
concatenation order kept) as torch ops on the caller's device. The
reference's kernel is two stable 7- and 5-key `lax.sort`s over
big-endian uint32 limbs, padded to a power of two with all-ones limbs.
torch sorts neither uint32 nor several keys at once, so here each
8-byte half of an id folds into one int64, big-endian with its sign bit
flipped (signed order is then byte order): a trace id is 2 keys, a span
id 1, and each multi-key sort is a chain of stable `torch.sort`s, least
significant key first. The concat row needs no sort of its own, since
stability keeps it. Nothing is padded, so a real id of sixteen `0xFF`
bytes needs no tie-break against pad rows. `reference_merge_order` is
the pure-Python oracle (a sort over byte keys and a per-trace seen set),
copied from the reference.
"""

from __future__ import annotations

import numpy as np

SIDECAR_HLL_PRECISION = 10   # 1024 int32 registers ≈ 3KB JSON per block


def trace_id_limbs(mat: np.ndarray) -> tuple[np.ndarray, ...]:
    """Four uint32 limbs of an [n, 16] uint8 trace-id column, ordered so
    lexicographic limb comparison equals bytes comparison (big-endian
    reads)."""
    v = np.ascontiguousarray(mat, np.uint8).view(np.dtype(">u4"))
    v = v.astype(np.uint32)
    return v[:, 0], v[:, 1], v[:, 2], v[:, 3]


def span_id_limbs(mat: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Two big-endian uint32 limbs of an [n, 8] uint8 span-id column."""
    v = np.ascontiguousarray(mat, np.uint8).view(np.dtype(">u4"))
    v = v.astype(np.uint32)
    return v[:, 0], v[:, 1]


def pad_pow2(n: int, floor: int = 64) -> int:
    p = floor
    while p < n:
        p <<= 1
    return p


_SIGN = np.uint64(1 << 63)


def _key64(mat: np.ndarray, lo: int) -> np.ndarray:
    """Bytes [lo, lo+8) of each row of an [n, w] uint8 id column as one
    int64 whose signed order is the bytes' lexicographic order."""
    v = np.ascontiguousarray(mat[:, lo:lo + 8], np.uint8)
    v = v.view(np.dtype(">u8")).reshape(-1).astype(np.uint64)
    return (v ^ _SIGN).view(np.int64)


def _stable_order(keys, order=None):
    """Row order sorted by the rows of `keys` (most significant first),
    ties kept in `order` (default: row order), through stable sorts of
    the least significant key first."""
    import torch

    for key in reversed(keys):
        k = key if order is None else key[order]
        o = torch.sort(k, stable=True).indices
        order = o if order is None else order[o]
    return order


def merge_order(trace_id: np.ndarray, span_id: np.ndarray,
                device=None) -> np.ndarray:
    """The merge/dedup/re-sort over the concatenated rows of all input
    blocks (block order, row order within a block), on `device` (`cuda`
    unless `"cpu"` is asked for).

    Returns the output row order as indices into the concatenation:
    traces ascend by trace-id bytes, spans within a trace keep concat
    order, and duplicate (trace_id, span_id) pairs keep only their
    first occurrence: bit-compatible with `heapq.merge` +
    `combine_spans` in the host compactor and equal to
    `reference_merge_order` row for row. One upload of the keys, one
    download of the order.
    """
    import torch

    from tempo_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    n = len(trace_id)
    if n == 0:
        return np.zeros(0, np.int64)
    keys = torch.from_numpy(np.stack(
        [_key64(trace_id, 0), _key64(trace_id, 8), _key64(span_id, 0)])
    ).to(dev)
    t_hi, t_lo, s = keys[0], keys[1], keys[2]
    # pass 1: runs of equal (trace, span) ids, the first concat row
    # leading each; its flag scattered back to the row is the keep set
    o = _stable_order((t_hi, t_lo, s))
    sk = keys[:, o]
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = (sk[:, 1:] != sk[:, :-1]).any(0)
    keep = torch.empty(n, dtype=torch.bool, device=dev)
    keep[o] = first
    # pass 2: the output order, trace-id bytes then concat row
    perm = _stable_order((t_hi, t_lo))
    return perm[keep[perm]].cpu().numpy()


def reference_merge_order(trace_id: np.ndarray,
                          span_id: np.ndarray) -> np.ndarray:
    """Pure-Python oracle for `merge_order`: stable sort on trace-id
    bytes, then a per-trace first-wins span_id seen set."""
    n = len(trace_id)
    order = sorted(range(n), key=lambda i: (bytes(trace_id[i]), i))
    seen: set[tuple[bytes, bytes]] = set()
    out = []
    for i in order:
        key = (bytes(trace_id[i]), bytes(span_id[i]))
        if key in seen:
            continue
        seen.add(key)
        out.append(i)
    return np.asarray(out, np.int64)


# ---------------------------------------------------------------------------
# sketch sidecars — per-block mergeable summaries built while resident
# ---------------------------------------------------------------------------

def _mix32(x: np.ndarray, salt: int) -> np.ndarray:
    """xorshift-multiply finalizer — cheap, stable across processes
    (unlike Python's salted hash())."""
    x = (x.astype(np.uint64) + np.uint64(salt)) & np.uint64(0xFFFFFFFF)
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(0x7FEB352D)) & np.uint64(0xFFFFFFFF)
    x ^= x >> np.uint64(15)
    x = (x * np.uint64(0x846CA68B)) & np.uint64(0xFFFFFFFF)
    x ^= x >> np.uint64(16)
    return x.astype(np.uint32)


def trace_hashes(trace_id: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Two quasi-independent uint32 hashes per trace id for `hll_update`.

    Both hashes see all 128 id bits, combined two different ways (xor vs
    multiply-add): low-entropy id generators that vary only one half
    still spread across registers, and the pair jointly keeps ~64 bits.
    """
    t0, t1, t2, t3 = trace_id_limbs(trace_id)
    a = _mix32(t0 ^ _mix32(t1, 0x9E3779B9), 0x85EBCA6B)
    b = _mix32(t2 ^ _mix32(t3, 0xC2B2AE35), 0x27D4EB2F)
    h1 = _mix32(a ^ b, 0x165667B1)
    h2 = _mix32((a.astype(np.uint64) * np.uint64(2654435761) + b)
                & np.uint64(0xFFFFFFFF), 0xD3A2646C)
    return h1, h2


def build_sidecar_arrays(series_ids: np.ndarray, duration_ns: np.ndarray,
                         n_series: int, trace_id: np.ndarray,
                         k: int, lo: float, hi: float, device=None
                         ) -> tuple[np.ndarray, np.ndarray]:
    """One pass on `device` (`cuda` unless `"cpu"` is asked for) over a
    block's columns → the sidecar planes, fetched to the host.

    Returns (moment rows [n_series, k+3] f32, HLL registers [m] int32):
    a moments row per dense (service, name) series over span durations
    (`moments_update`: its count and bound columns are exact, its sums
    follow the card's f32 atomic order) and one HLL row over trace ids
    (`hll_update`: registers bit-identical to the reference's).
    """
    from tempo_tpu_torch.ops import moments as msk
    from tempo_tpu_torch.ops import sketches as sk

    state = msk.moments_init(max(n_series, 1), k, min_value=float(np.exp(lo)),
                             max_value=float(np.exp(hi)), device=device)
    hll = sk.hll_init(1, precision=SIDECAR_HLL_PRECISION,
                      device=state.data.device)
    if len(duration_ns):
        msk.moments_update(state, np.asarray(series_ids, np.int32),
                           np.asarray(duration_ns, np.float32))
        h1, h2 = trace_hashes(trace_id)
        sk.hll_update(hll, np.zeros(len(h1), np.int32), h1, h2)
    return state.data.cpu().numpy(), hll.registers[0].cpu().numpy()


__all__ = ["merge_order", "reference_merge_order", "trace_id_limbs",
           "span_id_limbs", "pad_pow2", "build_sidecar_arrays", "trace_hashes", "SIDECAR_HLL_PRECISION"]
