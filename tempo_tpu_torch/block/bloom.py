"""Sharded bloom filters over trace IDs.

Analog of the reference's bloom layer (`tempodb/encoding/common` ShardedBloomFilter,
consumed by `vparquet4/block_findtracebyid.go`): trace-by-ID first probes the
bloom shard owning the ID and skips the block entirely on a miss. Shards are
selected by the first trace-ID byte so a reader fetches exactly one shard
object (`bloom-<n>`) per probe.

Implementation: classic m-bit/k-hash bloom backed by a numpy bit array;
the k probe positions come from blake2b-derived double hashing, so filters
are deterministic across processes (no Python hash randomization).

Counterpart of `tempo_tpu/block/bloom.py`, copied whole: filters and
shard bytes are byte-identical to the reference's.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np


def _h2(item: bytes) -> tuple[int, int]:
    d = hashlib.blake2b(item, digest_size=16).digest()
    return int.from_bytes(d[:8], "little"), int.from_bytes(d[8:], "little")


class BloomFilter:
    def __init__(self, n_items: int, fpp: float = 0.01) -> None:
        n = max(n_items, 1)
        m = int(-n * math.log(max(min(fpp, 0.5), 1e-9)) / (math.log(2) ** 2))
        self.m = max(64, (m + 7) & ~7)  # byte-aligned
        self.k = max(1, round(self.m / n * math.log(2)))
        self.bits = np.zeros(self.m, dtype=bool)

    def add(self, item: bytes) -> None:
        h1, h2 = _h2(item)
        for i in range(self.k):
            # wrap to 64 bits to match the vectorized uint64 arithmetic
            self.bits[((h1 + i * h2) & 0xFFFFFFFFFFFFFFFF) % self.m] = True

    def add_many(self, items: list[bytes]) -> None:
        if not items:
            return
        hs = np.array([_h2(it) for it in items], dtype=np.uint64)  # [n, 2]
        ks = np.arange(self.k, dtype=np.uint64)[None, :]
        pos = (hs[:, 0:1] + ks * hs[:, 1:2]) % np.uint64(self.m)
        self.bits[pos.reshape(-1)] = True

    def __contains__(self, item: bytes) -> bool:
        h1, h2 = _h2(item)
        return all(self.bits[((h1 + i * h2) & 0xFFFFFFFFFFFFFFFF) % self.m]
                   for i in range(self.k))

    def to_bytes(self) -> bytes:
        head = self.m.to_bytes(8, "little") + self.k.to_bytes(8, "little")
        return head + np.packbits(self.bits).tobytes()

    @staticmethod
    def from_bytes(data: bytes) -> "BloomFilter":
        m = int.from_bytes(data[:8], "little")
        k = int.from_bytes(data[8:16], "little")
        bf = BloomFilter.__new__(BloomFilter)
        bf.m, bf.k = m, k
        bf.bits = np.unpackbits(np.frombuffer(data[16:], np.uint8))[:m].astype(bool)
        return bf


class ShardedBloom:
    """`bloom_shard_count` filters; shard = first trace-ID byte % shards."""

    def __init__(self, shard_count: int, n_items: int, fpp: float = 0.01) -> None:
        self.shard_count = max(1, shard_count)
        per = max(1, n_items // self.shard_count)
        self.shards = [BloomFilter(per, fpp) for _ in range(self.shard_count)]

    def shard_of(self, trace_id: bytes) -> int:
        return (trace_id[0] if trace_id else 0) % self.shard_count

    def add(self, trace_id: bytes) -> None:
        self.shards[self.shard_of(trace_id)].add(trace_id)

    def __contains__(self, trace_id: bytes) -> bool:
        return trace_id in self.shards[self.shard_of(trace_id)]

    def shard_bytes(self, i: int) -> bytes:
        return self.shards[i].to_bytes()


def shard_name(i: int) -> str:
    return f"bloom-{i}"
