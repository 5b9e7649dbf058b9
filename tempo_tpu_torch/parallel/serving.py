"""Process-wide serving mesh: the data x series mesh as a serving mode.

Counterpart of `tempo_tpu/parallel/serving.py`. With `mesh.enabled` the
generator's span-metrics state is split over 'series' and every fused
update launches K1 once per shard (`parallel.mesh.k1_shards`):

- dense state (`place_spanmetrics_state`): each series shard owns an
  equal slot range of every plane, as a row window of the processor's
  own trash-paged arenas, updated in place through localized identity
  page tables;
- paged state: the page pool's arenas split page-aligned over 'series'
  (`registry.pages.PagePool`), each shard owning a range of physical
  pages, updated through localized page tables;
- the scheduler's coalescer aligns a merged window to the 'data' shard
  count (`submit_rows(align=, shards=)`), and the frontend combiner's
  cross-shard fold of a query's series runs as one device reduce
  (`combine`); the read plane adopts the devices data-major
  (`plane_mesh`).

The mesh is a single-process grid of `torch.device`s. `MeshConfig`
resolves the visible devices as the reference does (clamped to the
device count, then to a power of two), so one card gives a 1 x 1 mesh.
`ServingMesh(cfg, devices=[...])` takes an explicit device list that may
repeat a device (`[cuda:0] * 4`): logical shards, for tests and the chip
smoke. Resident state needs every shard on one device (the processor's
reads and evictions address its planes as one tensor); a mesh over
distinct devices serves the functional steps of `parallel.mesh` and the
read side, and a processor on it raises naming ROADMAP section 1, item
13b.

Series sharding keeps collect() bit-identical at every shard count on
the host (each shard applies the same batch rows in the same order to
the rows it owns); on the card K1's atomics leave float sums within
~1e-6. The 'data' axis changes the sums' association: close, not
bit-equal.

Like `tempo_tpu_torch.sched`, the mesh is process-level state: `App`
calls `configure()` from the `mesh:` config block before any module that
dispatches kernels is constructed; standalone callers use `use()` /
`reset()`.
"""

from __future__ import annotations

import dataclasses
import logging
import threading

import numpy as np
import torch

from tempo_tpu_torch.parallel import mesh as pmesh
from tempo_tpu_torch.parallel.mesh import validate_mesh_shape

_LOG = logging.getLogger("tempo_tpu_torch.mesh")


@dataclasses.dataclass
class MeshConfig:
    """Knobs for the serving mesh (`mesh:` in the app YAML)."""

    enabled: bool = False
    # devices to enlist; 0 = every visible device. Non-power-of-two
    # counts are clamped DOWN to the largest power of two so pow-2
    # coalescer buckets always split evenly across shards.
    devices: int = 0
    # series shards; 0 = auto (all enlisted devices — data axis 1, the
    # bit-stable no-collective layout). Must divide the device count;
    # devices // series_shards becomes the 'data' axis.
    series_shards: int = 0
    # frontend in-mesh combine: minimum pending sample count
    # (series x steps) before the cross-shard fold rides the device
    # reduce — small folds are microseconds on the host, and the device
    # path pays a matrix build + H2D + dispatch + gather
    combine_min_elements: int = 16384

    def check(self) -> list[str]:
        """Config warnings (chained into `app.config.Config.check()`).
        Pure shape math — never touches a device."""
        problems = []
        if self.devices < 0:
            problems.append("mesh.devices must be >= 0 (0 = all)")
        elif self.devices and self.devices & (self.devices - 1):
            problems.append(
                f"mesh.devices ({self.devices}) is not a power of two: "
                f"serve time clamps to {_pow2_floor(self.devices)} so "
                "pow-2 batch buckets split evenly across shards")
        if self.series_shards < 0:
            problems.append("mesh.series_shards must be >= 0 (0 = auto)")
        if self.devices and self.series_shards:
            problems += validate_mesh_shape(_pow2_floor(self.devices),
                                            self.series_shards)
        if self.combine_min_elements < 1:
            problems.append("mesh.combine_min_elements must be >= 1")
        return ["mesh: " + p for p in problems] if problems else []


def _pow2_floor(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


MULTI_DEVICE_STATE = ("resident span-metrics state over a mesh of distinct "
                      "devices comes with ROADMAP section 1, item 13b")


class ServingMesh:
    """The resolved serving mesh and its step caches.

    Built once per `configure()`. `devices` lists the mesh's devices
    explicitly (a device may repeat: logical shards); by default every
    visible device of `device` (`cuda` unless `"cpu"` is asked for)."""

    def __init__(self, cfg: MeshConfig, devices=None, device=None) -> None:
        self.cfg = cfg
        devs = [pmesh.device_of(d) for d in devices] if devices is not None \
            else pmesh.visible_devices(device)
        n = cfg.devices or len(devs)
        n = min(n, len(devs))
        p2 = _pow2_floor(max(n, 1))
        if p2 != n:
            _LOG.warning(
                "serving mesh: clamping %d devices to %d (largest power of "
                "two) so pow-2 batch buckets split evenly across shards",
                n, p2)
            n = p2
        series = cfg.series_shards or n
        if validate_mesh_shape(n, series):
            # keep as much series sharding as the clamped device count
            # allows (n is a power of two, so any pow-2 <= n divides it)
            # — falling all the way to 1 would silently pick the
            # data-parallel delta layout instead
            fallback = _pow2_floor(max(min(series, n), 1))
            _LOG.warning(
                "serving mesh: series_shards %d invalid for %d devices "
                "(%s); falling back to %d",
                series, n, "; ".join(validate_mesh_shape(n, series)),
                fallback)
            series = fallback
        self.devices = devs[:n]
        self.n_devices = n
        self.series_shards = series
        self.data_shards = n // series
        # registry mesh: the write-path layout (state over 'series',
        # batch over 'data'); read-plane mesh: every device on 'data'
        self.registry_mesh = pmesh.make_mesh(n, series, devices=self.devices)
        self.plane_mesh = self.registry_mesh if series == 1 \
            else pmesh.make_mesh(n, 1, devices=self.devices)
        self._steps: dict[tuple, object] = {}
        self._lock = threading.Lock()

    @property
    def device(self) -> "torch.device | None":
        """The one device every shard sits on, or None when the mesh
        spans distinct devices."""
        return self.registry_mesh.single_device

    # -- write path --------------------------------------------------------

    def fits_state(self, capacity: int, dd_rows: int,
                   mom_rows: int = 0) -> bool:
        """Whether a (series table, sketch planes) set can shard over
        this mesh (every shard needs an equal slot range)."""
        s = self.series_shards
        return capacity % s == 0 and (not dd_rows or dd_rows % s == 0) \
            and (not mom_rows or mom_rows % s == 0)

    def serving_step(self, edges: tuple, gamma: float, min_value: float,
                     capacity: int, dd_rows: int, packed: bool = False,
                     mom_rows: int = 0, mom_meta: "tuple | None" = None):
        """The functional sharded span-metrics step
        (`mesh.sharded_serving_step`), memoized per hyperparameter set."""
        key = (tuple(edges), float(gamma), float(min_value),
               int(capacity), int(dd_rows), bool(packed),
               int(mom_rows), mom_meta)
        with self._lock:
            fn = self._steps.get(key)
            if fn is None:
                fn = self._steps[key] = pmesh.sharded_serving_step(
                    self.registry_mesh, tuple(edges), gamma, min_value,
                    capacity, dd_rows, packed=packed, mom_rows=mom_rows,
                    mom_meta=mom_meta)
            return fn

    def fused_update(self, plan, batch, **step_kw) -> None:
        """One span-metrics update of resident sharded state, in place:
        K1 launched once per (data, series) shard over `plan`
        (`mesh.dense_plan` / `mesh.pool_plan`). The caller holds the
        state's lock."""
        pmesh.k1_shards(self.registry_mesh, plan, batch, **step_kw)

    def put_batch(self, *arrays):
        """Host batch vectors split over 'data' (contiguous chunks, chunk
        d on the (d, 0) device). Lengths must divide by `data_shards`
        (the coalescer's `align` guarantees it for scheduled windows)."""
        out = pmesh.shard_batch_arrays(self.registry_mesh,
                                       dict(enumerate(arrays)))
        return tuple(out[i] for i in range(len(arrays)))

    def put_packed(self, mat: np.ndarray):
        """One [roles, bucket] f32 matrix, columns split over 'data':
        chunk d on the (d, 0) device."""
        m = torch.from_numpy(np.ascontiguousarray(mat, np.float32))
        per = m.shape[1] // self.data_shards
        return [m[:, d * per:(d + 1) * per].contiguous().to(
                    self.registry_mesh.device(d, 0))
                for d in range(self.data_shards)]

    # -- frontend combine --------------------------------------------------

    def combine(self, stacked: np.ndarray, op: str) -> np.ndarray:
        """The in-mesh cross-shard fold: `stacked` is [K, C, T] f32 — K
        merged series (split over 'series'), C per-series contributions
        (sub-requests, shards, jobs), T steps. Each series shard reduces
        its rows over C on its device (sum, min or max); the results
        leave the mesh once. K must divide by series_shards (callers pad;
        identity fill rows reduce to the identity)."""
        ss = self.series_shards
        red = {"sum": torch.sum, "min": torch.amin, "max": torch.amax}[op]
        m = torch.from_numpy(np.ascontiguousarray(stacked, np.float32))
        per = m.shape[0] // ss
        out = [red(m[s * per:(s + 1) * per].to(
                   self.registry_mesh.device(0, s)), dim=1).cpu()
               for s in range(ss)]
        return torch.cat(out).numpy()


# ---------------------------------------------------------------------------
# the process-wide mesh (configured by App, consulted everywhere)
# ---------------------------------------------------------------------------

_active: "ServingMesh | None" = None
_lock = threading.Lock()


def configure(cfg: MeshConfig | None, device=None) -> "ServingMesh | None":
    """Build (or drop) the process serving mesh from the `mesh:` config
    block over the visible devices of `device`. Returns the active mesh
    or None when disabled. Never raises on a bad shape — it warns and
    falls back (`Config.check()` already surfaced it)."""
    global _active
    with _lock:
        if cfg is None or not cfg.enabled:
            _active = None
            return None
        try:
            _active = ServingMesh(cfg, device=device)
        except Exception as e:  # noqa: BLE001 — config fallback, logged
            _LOG.error("serving mesh disabled: %r", e)
            _active = None
        return _active


def active() -> "ServingMesh | None":
    """The process serving mesh, or None — callers take their
    single-device dispatch."""
    return _active


def reset() -> None:
    """Drop the process mesh (test isolation)."""
    global _active
    with _lock:
        _active = None


class use:
    """Install a mesh (or None) as the process serving mesh for a
    with-block (tests, the chip smoke)."""

    def __init__(self, sm: "ServingMesh | None") -> None:
        self.sm = sm
        self._prev: "ServingMesh | None" = None

    def __enter__(self) -> "ServingMesh | None":
        global _active
        with _lock:
            self._prev, _active = _active, self.sm
        return self.sm

    def __exit__(self, *exc) -> None:
        global _active
        with _lock:
            _active = self._prev


def place_spanmetrics_state(proc, sm: "ServingMesh | None" = None) -> bool:
    """Shard a SpanMetricsProcessor's dense state over the serving mesh:
    each series shard's K1 gets a window of every plane and localized
    identity tables (`proc._mesh_plan`). Idempotent. Returns False (and
    leaves the processor single-device, with a warning) when the
    capacities do not split into equal whole-page shard ranges; raises
    naming item 13b when the mesh's devices are not the one device the
    state lives on. Caller holds the registry state_lock."""
    from tempo_tpu_torch.ops.moments import moments_place
    from tempo_tpu_torch.ops.sketches import dd_place
    from tempo_tpu_torch.registry import metrics as rm

    sm = sm or _active
    if sm is None:
        return False
    if getattr(proc, "_paged", False):
        # paged processors shard at the POOL level: arenas split
        # page-aligned over 'series' when the pool is built
        return False
    dd_rows = proc.dd.counts.shape[0] if proc.dd is not None else 0
    mom = getattr(proc, "mom", None)
    mom_rows = mom.data.shape[0] if mom is not None else 0
    cap = proc.calls.table.capacity
    if not sm.fits_state(cap, dd_rows, mom_rows):
        _LOG.warning(
            "serving mesh: capacity %d / sketch rows %d/%d not divisible "
            "by series_shards %d — processor stays single-device",
            cap, dd_rows, mom_rows, sm.series_shards)
        return False
    pr = proc.registry.dense_page_rows
    if sm.series_shards > 1 and \
            any((r // sm.series_shards) % pr for r in (cap, dd_rows, mom_rows)):
        _LOG.warning(
            "serving mesh: shard ranges of capacity %d / sketch rows %d/%d "
            "over %d series shards are not whole %d-row pages — processor "
            "stays single-device", cap, dd_rows, mom_rows,
            sm.series_shards, pr)
        return False
    if sm.device != pmesh.device_of(proc.device):
        raise NotImplementedError(MULTI_DEVICE_STATE)
    proc.calls.state = rm.place_state(proc.calls.state, sm.device, pr)
    proc.latency.state = rm.place_state(proc.latency.state, sm.device, pr)
    proc.sizes.state = rm.place_state(proc.sizes.state, sm.device, pr)
    if proc.dd is not None:
        proc.dd = dd_place(proc.dd, sm.device, pr)
    if mom is not None:
        proc.mom = moments_place(mom, sm.device, pr)
    views = proc._dense_views()
    proc._mesh_plan = pmesh.dense_plan(
        sm.registry_mesh, proc._dense_arenas, proc._dense_tables,
        [v.shape[0] for v in views], pr)
    return True


# ---------------------------------------------------------------------------
# obs: mesh families in the process-wide runtime registry
# ---------------------------------------------------------------------------

from tempo_tpu_torch.obs.runtime import RUNTIME  # noqa: E402

RUNTIME.gauge_func(
    "tempo_mesh_devices",
    lambda: [] if _active is None else [((), float(_active.n_devices))],
    help="Devices enlisted in the serving mesh (absent family values "
         "when mesh mode is off)")
RUNTIME.gauge_func(
    "tempo_mesh_series_shards",
    lambda: [] if _active is None else [((), float(_active.series_shards))],
    help="'series' axis size of the serving mesh: registry/sketch slot "
         "ranges are partitioned this many ways")
RUNTIME.gauge_func(
    "tempo_mesh_data_shards",
    lambda: [] if _active is None else [((), float(_active.data_shards))],
    help="'data' axis size of the serving mesh: coalesced batch rows "
         "split this many ways per dispatch")


__all__ = ["MeshConfig", "ServingMesh", "configure", "active", "reset",
           "use", "place_spanmetrics_state", "validate_mesh_shape"]
