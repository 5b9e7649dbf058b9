"""Vectorized FNV hashing on the host (wire-compatible token routing).

Counterpart of the numpy half of `tempo_tpu/ops/hashing.py`. The
reference routes traces onto its consistent-hash ring with a 32-bit
FNV-1 hash over (tenant, traceID) bytes (`pkg/util/hash.go:8-16`
`TokenFor`) and keys ring members with FNV-1a over their ids; these are
the same functions, vectorized over byte matrices, so ring tokens, trace
tokens and placement are bit-identical between the two packages: the
same trace lands on the same member.

The reference's device mixers (`murmur_fmix32`, `splitmix32`,
`hash_columns32`, `hash_columns_pair`) feed HyperLogLog and count-min,
which the port does not carry yet (ROADMAP section 2).
"""

from __future__ import annotations

import numpy as np

_FNV1_32_OFFSET = np.uint32(2166136261)
_FNV1_32_PRIME = np.uint32(16777619)
_FNV1_64_OFFSET = np.uint64(14695981039346656037)
_FNV1_64_PRIME = np.uint64(1099511628211)


def _as_byte_matrix(data) -> np.ndarray:
    """Coerce input to a [n_rows, n_bytes] uint8 matrix."""
    arr = np.asarray(data, dtype=np.uint8)
    if arr.ndim == 1:
        arr = arr[None, :]
    return arr


def fnv1_32(data) -> np.ndarray:
    """FNV-1 32-bit (multiply, then xor — Go fnv.New32) over byte rows.

    Vectorized across rows; sequential across the (small, fixed) byte width.
    Matches the reference's ring token hash `pkg/util/hash.go:8`.
    """
    arr = _as_byte_matrix(data)
    with np.errstate(over="ignore"):
        h = np.full(arr.shape[0], _FNV1_32_OFFSET, dtype=np.uint32)
        for i in range(arr.shape[1]):
            h = (h * _FNV1_32_PRIME) ^ arr[:, i].astype(np.uint32)
    return h


def fnv1a_32(data) -> np.ndarray:
    """FNV-1a 32-bit (xor, then multiply) over byte rows."""
    arr = _as_byte_matrix(data)
    with np.errstate(over="ignore"):
        h = np.full(arr.shape[0], _FNV1_32_OFFSET, dtype=np.uint32)
        for i in range(arr.shape[1]):
            h = (h ^ arr[:, i].astype(np.uint32)) * _FNV1_32_PRIME
    return h


def fnv1a_64(data) -> np.ndarray:
    """FNV-1a 64-bit over byte rows (series hashing analog, registry/hash.go)."""
    arr = _as_byte_matrix(data)
    with np.errstate(over="ignore"):
        h = np.full(arr.shape[0], _FNV1_64_OFFSET, dtype=np.uint64)
        for i in range(arr.shape[1]):
            h = (h ^ arr[:, i].astype(np.uint64)) * _FNV1_64_PRIME
    return h


def token_for(tenant: str, trace_ids: np.ndarray) -> np.ndarray:
    """Ring tokens for a batch of trace IDs: fnv1_32(tenant_bytes || trace_id).

    `trace_ids` is [n, 16] uint8 (128-bit OTLP trace ids). Reference:
    `pkg/util/hash.go:8-16` (`TokenFor`, `TokenForTraceID`). The
    distributor takes the native batch of the same hash
    (`native.token_for`); this is its numpy twin.
    """
    tids = _as_byte_matrix(trace_ids)
    tenant_b = np.frombuffer(tenant.encode("utf-8"), dtype=np.uint8)
    with np.errstate(over="ignore"):
        h = np.full(tids.shape[0], _FNV1_32_OFFSET, dtype=np.uint32)
        for b in tenant_b:
            h = (h * _FNV1_32_PRIME) ^ np.uint32(b)
        for i in range(tids.shape[1]):
            h = (h * _FNV1_32_PRIME) ^ tids[:, i].astype(np.uint32)
    return h


__all__ = ["fnv1_32", "fnv1a_32", "fnv1a_64", "token_for"]
