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

The device merge/dedup/re-sort of the cold tier (`merge_order`, with its
oracle `reference_merge_order`) comes with the compactor (ROADMAP
section 1, item 11): `merge_order` raises until then.
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


def merge_order(trace_id: np.ndarray, span_id: np.ndarray,
                n_pad: int | None = None) -> np.ndarray:
    raise NotImplementedError(
        "merge_order is the cold tier's device merge, which comes with the "
        "compactor (ROADMAP section 1, item 11)")


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


__all__ = ["merge_order", "trace_id_limbs", "span_id_limbs", "pad_pow2",
           "build_sidecar_arrays", "trace_hashes", "SIDECAR_HLL_PRECISION"]
