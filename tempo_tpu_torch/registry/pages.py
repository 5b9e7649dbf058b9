"""Process-wide device page pool: paged, ragged registry/sketch state.

Counterpart of `tempo_tpu/registry/pages.py`. One arena tensor per
(dtype, width, role) on the pool's device, carved into fixed-size pages
(pow-2 rows each), allocated on demand as series tables hand out slots
and returned to the free list by the staleness sweeps. On the serving
mesh each series shard's range of physical pages is an arena of its own
on the shard's device (`parallel.mesh.ShardedPlane`, each behind its own
trash page); page numbers, free lists and page maps stay the pool's.

- `PagePool` — process-level state: `configure()` builds it from a
  `PagePoolConfig` on a device (`cuda` unless the caller asks for
  `"cpu"`); tests use `use()` / `reset()`. Its re-entrant lock is the
  state lock of every paged tenant: arenas are shared across tenants and
  updated in place, so every device read and update serializes on it.
- `_Arena` — one tensor `[rows]` or `[rows, width]` (one a series shard
  on the mesh); physical page 0 is reserved as the trash page, never
  allocated and always zero.
- `PagedPlane` — a family plane's view: host page map (logical page →
  physical page or -1), per-page active-slot refcounts, and a cached
  device copy of the map (re-uploaded only when allocation or eviction
  changed it).
- `PageBacking` — per-SeriesTable allocator: `ensure_slot` backs the
  slot's page in every attached plane (all-or-nothing), `release`
  frees pages that emptied.
- `load_reference_state` — installs arenas and page maps taken from the
  JAX reference's pool, so both packages can start from one state.

Arenas are f32, or for the compact-state tier int32 (counts) and
bfloat16 (the latency sum's [rows, 2] Kahan pair).

The reference's `configure` logs a bad config and falls back to the dense
layout; the port raises instead (it has no warn-and-fall-back paths). A
tenant whose capacity the pool's pages do not divide stays dense, as in
the reference (`registry/registry.py`).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import weakref

import numpy as np
import torch

from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.ops import pages as op
from tempo_tpu_torch.parallel import serving
from tempo_tpu_torch.parallel.mesh import ShardedPlane

_LOG = logging.getLogger("tempo_tpu_torch.pages")

_TORCH_DTYPES = {"float32": torch.float32, "int32": torch.int32,
                 "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class PagePoolConfig:
    """Knobs for the device page pool (`pages:` in the app YAML)."""

    enabled: bool = False
    # rows per page; a power of two that divides every paged family's
    # capacity (max_active_series, sketch_max_series)
    page_rows: int = 256
    # arena size per (dtype, width, role), in usable rows: the
    # process-wide active-series budget of the paged layout
    arena_slots: int = 131072

    def check(self, capacities: "tuple[int, ...]" = ()) -> list[str]:
        """Config problems, one string each."""
        problems = []
        pow2 = self.page_rows >= 1 and not (self.page_rows & (self.page_rows - 1))
        if not pow2:
            problems.append(
                f"pages.page_rows ({self.page_rows}) must be a power of two")
        if self.arena_slots < self.page_rows:
            problems.append(
                f"pages.arena_slots ({self.arena_slots}) < page_rows "
                f"({self.page_rows}): the pool could not back a single page")
        for cap in capacities:
            if pow2 and cap % self.page_rows:
                problems.append(
                    f"pages.page_rows ({self.page_rows}) does not divide "
                    f"the configured series capacity {cap}")
        if capacities and self.arena_slots < max(capacities):
            problems.append(
                f"pages.arena_slots ({self.arena_slots}) is below the "
                f"largest single-tenant capacity ({max(capacities)})")
        return ["pages: " + p for p in problems]


class _Arena:
    """One device tensor per (dtype, width, role) + its page free list.
    The role key keeps `arena_slots` meaning "rows per plane role"."""

    def __init__(self, pool: "PagePool", dtype: str, width: int,
                 role: str) -> None:
        if dtype not in _TORCH_DTYPES:
            raise ValueError(f"unsupported arena dtype {dtype!r} "
                             f"(use one of {sorted(_TORCH_DTYPES)})")
        self.dtype = dtype
        self.width = width
        self.role = role
        self.n_pages = pool._arena_pages
        self.rows = self.n_pages * pool.page_rows
        dt = _TORCH_DTYPES[dtype]
        self.itemsize = torch.empty((), dtype=dt).element_size()
        if pool.mesh is None:
            shape = (self.rows,) if width == 1 else (self.rows, width)
            self.data = torch.zeros(shape, dtype=dt, device=pool.device)
        else:
            # physical row g lives in series shard g // (rows / S): each
            # shard's pages an arena of its own on its device
            self.data = ShardedPlane.zeros(
                pool.mesh.registry_mesh.homes, self.rows,
                None if width == 1 else width, pool.page_rows, dtype=dt)
        # physical page 0 is the trash page: never handed out, so every
        # table entry of a backed page is >= 1 and the kernel can skip
        # entries <= 0 without a separate valid bit
        self.free: list[int] = list(range(self.n_pages - 1, 0, -1))
        self.owners: list[str | None] = [None] * self.n_pages

    @property
    def page_bytes(self) -> int:
        return (self.rows // self.n_pages) * self.width * self.itemsize


class PagePool:
    """The process device page pool (see module docstring)."""

    def __init__(self, cfg: PagePoolConfig, device=None) -> None:
        problems = cfg.check()
        if problems:
            raise ValueError("; ".join(problems))
        self.cfg = cfg
        self.device = resolve_device(device)
        self.page_rows = cfg.page_rows
        self.page_shift = cfg.page_rows.bit_length() - 1
        self.lock = threading.RLock()
        self.arenas: dict[tuple[str, int, str], _Arena] = {}
        self.planes: "weakref.WeakSet[PagedPlane]" = weakref.WeakSet()
        self.allocated_total = 0
        self.evicted_total = 0
        self.alloc_failures = 0
        # serving-mesh composition: arenas split page-aligned over
        # 'series', each shard's K1 owning a range of physical pages in
        # an arena of its own on its device. Needs data axis 1 (the
        # serving default): the paged update is an owned-pages write with
        # no data-axis delta.
        sm = serving.active()
        if sm is not None and sm.data_shards != 1:
            _LOG.warning(
                "page pool: serving mesh has data_shards=%d — paged "
                "arenas need the series-only layout (data=1); arenas "
                "stay single-device", sm.data_shards)
            sm = None
        self.mesh = sm
        shards = sm.series_shards if sm is not None else 1
        # +1: physical page 0 is the reserved trash page
        pages = -(-cfg.arena_slots // cfg.page_rows) + 1
        if pages % shards:
            pages += shards - pages % shards  # page-aligned shard ranges
        self._arena_pages = pages

    def arena(self, dtype: str, width: int, role: str) -> _Arena:
        """Get-or-create the (dtype, width, role) arena."""
        key = (dtype, int(width), role)
        with self.lock:
            a = self.arenas.get(key)
            if a is None:
                a = self.arenas[key] = _Arena(self, dtype, width, role)
            return a

    def alloc_page(self, arena: _Arena, tenant: str) -> int:
        """One physical page off the free list, or -1 (pool exhausted)."""
        with self.lock:
            if not arena.free:
                self.alloc_failures += 1
                return -1
            page = arena.free.pop()
            arena.owners[page] = tenant
            self.allocated_total += 1
            return page

    def release_pages(self, arena: _Arena, pages: np.ndarray) -> None:
        """Zero the pages' rows in one indexing op and return them to the
        free list."""
        if not len(pages):
            return
        with self.lock:
            if isinstance(arena.data, ShardedPlane):
                p = np.asarray(pages, np.int64)
                arena.data.zero((p[:, None] * self.page_rows
                                 + np.arange(self.page_rows)).reshape(-1))
            else:
                op.zero_pages_step(
                    arena.data, torch.as_tensor(np.asarray(pages, np.int64)),
                    page_rows=self.page_rows)
            for page in np.asarray(pages).tolist():
                arena.owners[page] = None
                arena.free.append(page)
            self.evicted_total += len(pages)

    def total_pages(self) -> int:
        """Usable pages across arenas (trash pages excluded)."""
        with self.lock:
            return sum(a.n_pages - 1 for a in self.arenas.values())

    def free_pages(self) -> int:
        with self.lock:
            return sum(len(a.free) for a in self.arenas.values())

    def tenant_bytes(self) -> dict[str, int]:
        """Arena bytes held per tenant (page ownership × page bytes), what
        the device-time ledger's status shows next to device-seconds."""
        out: dict[str, int] = {}
        with self.lock:
            for a in self.arenas.values():
                pb = a.page_bytes
                for owner in a.owners:
                    if owner is not None:
                        out[owner] = out.get(owner, 0) + pb
        return out

    def status(self) -> dict:
        """The /status "pages" object, with the reference's keys."""
        with self.lock:
            arenas = [{
                "role": a.role, "dtype": a.dtype, "width": a.width,
                "pages": a.n_pages - 1, "reserved": 1,
                "free": len(a.free),
                "page_bytes": a.page_bytes,
                "bytes": a.page_bytes * a.n_pages,
            } for a in self.arenas.values()]
        top = sorted(self.tenant_bytes().items(), key=lambda kv: -kv[1])[:10]
        return {
            "page_rows": self.page_rows,
            "arena_pages": self._arena_pages,
            "series_shards": self.mesh.series_shards if self.mesh else 1,
            "allocated_total": self.allocated_total,
            "evicted_total": self.evicted_total,
            "alloc_failures": self.alloc_failures,
            "arenas": arenas,
            "top_tenant_bytes": [{"tenant": t, "bytes": b} for t, b in top],
        }


class PagedPlane:
    """One family plane's logical slot space over a pooled arena."""

    def __init__(self, pool: PagePool, dtype: str, width: int,
                 capacity: int, tenant: str, role: str = "") -> None:
        if capacity % pool.page_rows:
            raise ValueError(
                f"paged plane capacity {capacity} not divisible by "
                f"page_rows {pool.page_rows}")
        self.pool = pool
        self.width = int(width)
        self.capacity = capacity
        self.tenant = tenant
        self.role = role
        self._arena = pool.arena(dtype, width, role)
        self.n_lpages = capacity // pool.page_rows
        self.page_map = np.full(self.n_lpages, -1, np.int32)
        self.refcnt = np.zeros(self.n_lpages, np.int64)
        self._dev_map: "torch.Tensor | None" = None
        # each series shard's (arena, localized table) on a mesh-split
        # pool, by page-map version
        self._operands: "tuple | None" = None
        # bumped on every page-map change (stacked-table caches key on it)
        self.version = 0
        pool.planes.add(self)

    def backed(self, lpage: int) -> bool:
        return self.page_map[lpage] >= 0

    def _dirty(self) -> None:
        self._dev_map = None
        self.version += 1

    def alloc(self, lpage: int) -> bool:
        page = self.pool.alloc_page(self._arena, self.tenant)
        if page < 0:
            return False
        self.page_map[lpage] = page
        self._dirty()
        return True

    def free_lpages(self, lpages: np.ndarray) -> None:
        """Unmap and free the listed logical pages."""
        lpages = np.asarray(lpages)
        phys = self.page_map[lpages]
        live = phys[phys >= 0]
        if not live.size:
            return
        self.page_map[lpages] = -1
        self._dirty()
        self.pool.release_pages(self._arena, live)

    def pages_backed(self) -> int:
        return int((self.page_map >= 0).sum())

    def device_state_bytes(self) -> int:
        return self.pages_backed() * self._arena.page_bytes

    # -- device views (callers hold pool.lock) -----------------------------

    def device_map(self) -> torch.Tensor:
        """The indirection table on the pool's device."""
        if self._dev_map is None:
            self._dev_map = torch.from_numpy(self.page_map.copy()).to(
                self.pool.device)
        return self._dev_map

    @property
    def data(self):
        """The arena: a tensor indexed by physical row, or on a mesh-split
        pool the `parallel.mesh.ShardedPlane` of the shards' arenas."""
        return self._arena.data

    def phys_rows(self, slots: np.ndarray) -> np.ndarray:
        """Physical row per slot through the host page map (int64); -1
        for a negative slot or an unbacked page."""
        shift = self.pool.page_shift
        s = np.asarray(slots, np.int64)
        lp = s >> shift
        ok = (s >= 0) & (lp < self.n_lpages)
        page = np.where(ok, self.page_map[np.clip(lp, 0, self.n_lpages - 1)],
                        -1).astype(np.int64)
        return np.where(page >= 0,
                        (page << shift) | (s & (self.pool.page_rows - 1)), -1)

    def operands(self) -> list:
        """(arena, page table) a series shard, for the paged updates of
        `ops.pages`: the arena and `device_map()`, or on a mesh-split pool
        each shard's arena and the map localized to its pages (others
        -1, which every update drops). Caller holds pool.lock."""
        if not isinstance(self.data, ShardedPlane):
            return [(self.data, self.device_map())]
        if self._operands is None or self._operands[0] != self.version:
            from tempo_tpu_torch.parallel.mesh import localize

            per = self._arena.n_pages // len(self.data.views)
            dmap = self.device_map()[None]
            self._operands = (self.version, [
                (a, localize(dmap, [(s * per, (s + 1) * per,
                                     s * per - 1)])[0].to(a.device))
                for s, a in enumerate(self.data.arenas)])
        return self._operands[1]

    def gather(self, slots: np.ndarray) -> np.ndarray:
        """Host copy of the slots' rows ([n] or [n, width]); unbacked or
        negative slots read 0. A bfloat16 plane comes back as f32 (exact;
        numpy has no bfloat16). Caller holds pool.lock."""
        rows = self.gather_dev(slots)
        if rows.dtype == torch.bfloat16:
            rows = rows.float()
        return rows.cpu().numpy()

    def gather_dev(self, slots: np.ndarray) -> torch.Tensor:
        """Like `gather` but stays on the (pool's) device."""
        if isinstance(self.data, ShardedPlane):
            return self.data.gather(self.phys_rows(slots), self.pool.device)
        s = torch.from_numpy(np.ascontiguousarray(slots, np.int32)).to(
            self.pool.device)
        return op.gather_step(self._arena.data, self.device_map(), s,
                              page_shift=self.pool.page_shift)

    def zero_slots(self, slots: np.ndarray) -> None:
        """Zero the slots' rows in place (eviction sweep)."""
        if isinstance(self.data, ShardedPlane):
            self.data.zero(self.phys_rows(slots))
            return
        s = torch.from_numpy(np.ascontiguousarray(slots, np.int32)).to(
            self.pool.device)
        op.zero_step(self._arena.data, self.device_map(), s,
                     page_shift=self.pool.page_shift)


class PageBacking:
    """Per-SeriesTable page allocator over one or more planes: a slot's
    page is backed in all attached planes or in none."""

    def __init__(self, pool: PagePool) -> None:
        self.pool = pool
        self.planes: list[tuple[PagedPlane, int]] = []

    def add_plane(self, plane: PagedPlane, limit: "int | None" = None) -> None:
        """Attach a plane; `limit` caps the slot range it backs (the
        sketch plane may be a strict prefix of the series table)."""
        self.planes.append((plane, plane.capacity if limit is None
                            else min(limit, plane.capacity)))

    def adopt(self, other: "PageBacking") -> None:
        self.planes.extend(other.planes)

    def ensure_slot(self, slot: int) -> bool:
        """Back `slot`'s page in every attached plane (all-or-nothing)."""
        shift = self.pool.page_shift
        with self.pool.lock:
            need: list[tuple[PagedPlane, int]] = []
            per_arena: dict[int, int] = {}
            for plane, limit in self.planes:
                if slot >= limit or plane.backed(slot >> shift):
                    continue
                need.append((plane, slot >> shift))
                per_arena[id(plane._arena)] = \
                    per_arena.get(id(plane._arena), 0) + 1
            # feasibility first: a partial allocation must not strand pages
            arenas = {id(p._arena): p._arena for p, _ in need}
            for aid, want in per_arena.items():
                if len(arenas[aid].free) < want:
                    self.pool.alloc_failures += 1
                    return False
            for plane, lpage in need:
                if not plane.alloc(lpage):  # pragma: no cover — prechecked
                    return False
            for plane, limit in self.planes:
                if slot < limit:
                    plane.refcnt[slot >> shift] += 1
            return True

    def release(self, slots: np.ndarray) -> None:
        """Evicted slots: drop refcounts, free pages that emptied."""
        slots = np.asarray(slots)
        if not slots.size:
            return
        shift = self.pool.page_shift
        with self.pool.lock:
            for plane, limit in self.planes:
                ss = slots[slots < limit]
                if not ss.size:
                    continue
                np.subtract.at(plane.refcnt, ss >> shift, 1)
                empty = np.flatnonzero(
                    (plane.refcnt <= 0) & (plane.page_map >= 0))
                plane.free_lpages(empty)


def load_reference_state(pool: PagePool, arenas: dict, page_maps: dict,
                         refcounts: "dict | None" = None) -> None:
    """Install state taken from the JAX reference's pool.

    `arenas` maps (dtype, width, role) to the reference arena as a numpy
    array (`np.asarray(arena.data)`: float32, int32, or ml_dtypes'
    bfloat16); `page_maps` maps (tenant, role) to a plane's host page map,
    and `refcounts` (optional, same keys) to its per-page active-slot
    counts. Arena contents are copied, each in its own dtype, into this
    pool's arenas (created when missing); each page map is installed in
    the matching plane of this pool, and the pages it names leave the
    arena's free list. Raises on a dtype or shape mismatch or an unknown
    plane."""
    with pool.lock:
        for (dtype, width, role), data in arenas.items():
            a = pool.arena(dtype, width, role)
            data = np.asarray(data)
            if data.dtype.name != a.dtype:
                raise ValueError(f"arena {role}: reference dtype "
                                 f"{data.dtype.name} vs {a.dtype}")
            if a.dtype == "bfloat16":
                # torch cannot take ml_dtypes' bfloat16: move the bits
                src = torch.from_numpy(data.view(np.uint16).copy()).view(
                    torch.bfloat16)
            else:
                src = torch.from_numpy(data.copy())
            shape = (a.rows,) + (() if a.width == 1 else (a.width,))
            if tuple(src.shape) != shape:
                raise ValueError(f"arena {role}: reference shape "
                                 f"{tuple(src.shape)} vs {shape}")
            if isinstance(a.data, ShardedPlane):
                a.data.load(src)
            else:
                a.data.copy_(src)
        by_key = {(p.tenant, p.role): p for p in pool.planes}
        for key, pmap in page_maps.items():
            plane = by_key.get(key)
            if plane is None:
                raise ValueError(f"no plane {key} in this pool")
            pmap = np.asarray(pmap, np.int32)
            if pmap.shape != plane.page_map.shape:
                raise ValueError(f"plane {key}: page map shape {pmap.shape} "
                                 f"vs {plane.page_map.shape}")
            arena = plane._arena
            for page in plane.page_map[plane.page_map >= 0].tolist():
                arena.owners[page] = None
                arena.free.append(page)
            taken = set(pmap[pmap >= 0].tolist())
            if 0 in taken:
                raise ValueError(f"plane {key}: page map names the trash page")
            arena.free = [p for p in arena.free if p not in taken]
            for page in taken:
                arena.owners[page] = plane.tenant
            plane.page_map[:] = pmap
            if refcounts is not None and key in refcounts:
                plane.refcnt[:] = np.asarray(refcounts[key], np.int64)
            plane._dirty()


# ---------------------------------------------------------------------------
# the process-wide pool
# ---------------------------------------------------------------------------

_active: "PagePool | None" = None
_lock = threading.Lock()


def configure(cfg: "PagePoolConfig | None", device=None) -> "PagePool | None":
    """Build (or drop, when disabled) the process page pool on `device`
    (`cuda` unless `"cpu"` is asked for). Raises on a bad config."""
    global _active
    with _lock:
        if cfg is None or not cfg.enabled:
            _active = None
            return None
        _active = PagePool(cfg, device)
        return _active


def active() -> "PagePool | None":
    """The process page pool, or None."""
    return _active


def reset() -> None:
    """Drop the process pool (test isolation)."""
    global _active
    with _lock:
        _active = None


class use:
    """Install a pool (or None) as the process page pool for a with-block."""

    def __init__(self, pool: "PagePool | None") -> None:
        self.pool = pool
        self._prev: "PagePool | None" = None

    def __enter__(self) -> "PagePool | None":
        global _active
        with _lock:
            self._prev, _active = _active, self.pool
        return self.pool

    def __exit__(self, *exc) -> None:
        global _active
        with _lock:
            _active = self._prev


# ---------------------------------------------------------------------------
# obs: page-pool families in the process-wide runtime registry (the
# reference's, less its gather-overhead timer, which the port keeps not)
# ---------------------------------------------------------------------------

from tempo_tpu_torch.obs.runtime import RUNTIME  # noqa: E402

_ARENA_LABELS = ("role", "dtype", "width")


def _arena_rows(field):
    pool = _active
    if pool is None:
        return []
    with pool.lock:
        return [((a.role, a.dtype, str(a.width)), float(field(a)))
                for a in pool.arenas.values()]


RUNTIME.gauge_func(
    "tempo_pages_total",
    lambda: _arena_rows(lambda a: a.n_pages - 1),
    help="Usable device pages per arena kind (absent families when the "
         "page pool is off; excludes each arena's reserved trash page)",
    labels=_ARENA_LABELS)
RUNTIME.gauge_func(
    "tempo_pages_free",
    lambda: _arena_rows(lambda a: len(a.free)),
    help="Free device pages per arena kind — 0 with allocation failures "
         "rising means the pool is exhausted (runbook 'Sizing the page "
         "pool')", labels=_ARENA_LABELS)
RUNTIME.counter_func(
    "tempo_pages_allocated_total",
    lambda: [] if _active is None else [((), float(_active.allocated_total))],
    help="Pages handed out since process start (demand-driven: series "
         "table slot allocation backs pages on first touch)")
RUNTIME.counter_func(
    "tempo_pages_evicted_total",
    lambda: [] if _active is None else [((), float(_active.evicted_total))],
    help="Pages returned to the free list by staleness sweeps / purges")
RUNTIME.counter_func(
    "tempo_pages_alloc_failures_total",
    lambda: [] if _active is None else [((), float(_active.alloc_failures))],
    help="Series allocations refused because the page pool was "
         "exhausted (the paged twin of a spent series budget)")


__all__ = ["PagePoolConfig", "PagePool", "PagedPlane", "PageBacking",
           "configure", "active", "reset", "use", "load_reference_state"]
