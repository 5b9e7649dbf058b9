"""Vectorized FNV hashing on the host (wire-compatible token routing).

Counterpart of the numpy half of `tempo_tpu/ops/hashing.py`. The
reference routes traces onto its consistent-hash ring with a 32-bit
FNV-1 hash over (tenant, traceID) bytes (`pkg/util/hash.go:8-16`
`TokenFor`) and keys ring members with FNV-1a over their ids; these are
the same functions, vectorized over byte matrices, so ring tokens, trace
tokens and placement are bit-identical between the two packages: the
same trace lands on the same member.

The device mixers (`murmur_fmix32`, `splitmix32`, `hash_columns32`,
`hash_columns_pair`) are the reference's uint32 avalanche mixes as torch
ops, bit-exact: torch has no wrapping uint32 multiply, so each runs on
int64 lanes holding values in [0, 2^32), the products split in 16-bit
halves, and returns int64 tensors of those values.
"""

from __future__ import annotations

import numpy as np
import torch

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


# ---------------------------------------------------------------------------
# Device-side integer mixers (uint32 values on int64 lanes)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _u32(h) -> torch.Tensor:
    """uint32 values as an int64 tensor on `h`'s device (numpy arrays,
    ints and integer tensors; negative int32 lanes wrap)."""
    from tempo_tpu_torch.ops.pages import u32_on

    return u32_on(h, h.device if isinstance(h, torch.Tensor) else "cpu")


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for h in [0, 2^32): two 16-bit partial products,
    each below 2^48."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def murmur_fmix32(h) -> torch.Tensor:
    """Murmur3 32-bit finalizer. Full-avalanche mix of a uint32 lane."""
    h = _u32(h)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def splitmix32(h) -> torch.Tensor:
    """splitmix-style 32-bit mixer (distinct constants from fmix32)."""
    h = (_u32(h) + 0x9E3779B9) & _M32
    h = _mul32(h ^ (h >> 16), 0x21F0AAAD)
    h = _mul32(h ^ (h >> 15), 0x735A2D97)
    return h ^ (h >> 15)


def hash_columns32(cols, seed: int = 0) -> torch.Tensor:
    """Hash a [n, k] integer matrix row-wise to uint32 values: a
    murmur-style combine per column (each column offset by i * golden
    ratio before its fmix), FNV-prime folding, an fmix finalizer."""
    cols = _u32(cols)
    if cols.dim() == 1:
        cols = cols[:, None]
    h = torch.full(cols.shape[:1], (seed ^ 0x811C9DC5) & _M32,
                   dtype=torch.int64, device=cols.device)
    for i in range(cols.shape[1]):
        k = murmur_fmix32((cols[:, i] + ((i * 0x9E3779B9) & _M32)) & _M32)
        h = _mul32(h ^ k, 0x01000193)
    return murmur_fmix32(h)


def hash_columns_pair(cols, seed: int = 0):
    """Two independent uint32 row hashes (64 hash bits)."""
    return (hash_columns32(cols, seed=seed),
            hash_columns32(cols, seed=seed ^ 0x5BD1E995))


__all__ = ["fnv1_32", "fnv1a_32", "fnv1a_64", "token_for", "murmur_fmix32",
           "splitmix32", "hash_columns32", "hash_columns_pair"]
