"""Mesh construction and the sharded steps.

Counterpart of `tempo_tpu/parallel/mesh.py`. The reference's mesh is a
`jax.sharding.Mesh` of one process's devices, and `shard_map` runs one
program per device. The port's mesh is single-process too: a
(`data`, `series`) grid of `torch.device`s, in which a device may repeat
(several logical shards on one card, or on the CPU in tests, the
counterpart of `xla_force_host_platform_device_count`). The reference's
axes keep their meaning:

- `series`: state is split by slot range. Series shard s owns rows
  [s * R / S, (s + 1) * R / S) of each plane of R rows, and each shard's
  update touches only its own rows, so the write path needs no
  collective.
- `data`: the span batch is split into contiguous column chunks. Each
  (data, series) shard updates a zeroed delta of its series shard's rows
  from its chunk; the deltas reduce over `data` in shard order (a sum,
  and the max for the moments plane's two bound columns) onto the
  (0, s) device, and the result adds into the base.

The span-metrics update of every shard is K1 (`ops.pages.fused_step`),
launched once per shard over page tables localized to the shard: the
batch keeps its global slot ids, a page the shard owns maps to its local
page (>= 1) and every other page to -1, which K1 skips. Shard arenas are
row windows of a plane whose first page is the trash page: the window
of shard s starts one page before its first row, so its local page 0 is
never written. No path reduces through a `torch.distributed` process
group: the data-axis reduce copies each delta to the owner's device in
shard order.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from tempo_tpu_torch.device import resolve_device


def validate_mesh_shape(n_devices: int, series_shards: int) -> list[str]:
    """Config-style problem list for a proposed mesh shape (empty = ok).
    Shared by `config.check()` (the `mesh:` block warnings) and the mesh
    constructors, so a bad shard count surfaces as a standard config
    warning at load time instead of an error at serve time."""
    problems = []
    if series_shards < 1:
        problems.append(f"mesh series_shards must be >= 1 "
                        f"(got {series_shards})")
    elif series_shards > n_devices:
        problems.append(f"mesh series_shards ({series_shards}) exceeds the "
                        f"device count ({n_devices}): shards <= devices")
    elif n_devices % series_shards:
        problems.append(f"mesh series_shards ({series_shards}) must divide "
                        f"the device count ({n_devices})")
    return problems


class Mesh:
    """A (data, series) grid of torch devices (devices may repeat)."""

    axis_names = ("data", "series")

    def __init__(self, devices: np.ndarray) -> None:
        self.devices = devices
        d, s = devices.shape
        self.shape = {"data": int(d), "series": int(s)}

    def device(self, d: int, s: int) -> torch.device:
        return self.devices[d, s]

    @property
    def device_set(self) -> set:
        """The distinct devices of the grid."""
        return set(self.devices.flat)

    @property
    def single_device(self) -> "torch.device | None":
        """The one device every shard sits on, or None."""
        ds = self.device_set
        return next(iter(ds)) if len(ds) == 1 else None


def visible_devices(device=None) -> list[torch.device]:
    """The devices a mesh may enlist: every CUDA device (`cuda`, the
    default), or the one device asked for."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def device_of(d) -> torch.device:
    """`d` as a torch.device with its index (`cuda` is the current card)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_devices: int | None = None, series_shards: int = 1,
              devices: "Sequence | None" = None) -> Mesh:
    """2D mesh ('data', 'series') over the first `n_devices` of
    `devices` (default: `visible_devices()`). series_shards must divide
    the device count."""
    devs = [device_of(d) for d in
            (visible_devices() if devices is None else devices)]
    n = len(devs) if n_devices is None else n_devices
    if n > len(devs):
        raise ValueError(f"mesh of {n} devices over {len(devs)} listed")
    problems = validate_mesh_shape(n, series_shards)
    if problems:
        raise ValueError("; ".join(problems))
    grid = np.empty(n, dtype=object)
    grid[:] = devs[:n]
    return Mesh(grid.reshape(n // series_shards, series_shards))


def make_multihost_mesh(series_shards: int = 1,
                        devices: "Sequence | None" = None) -> Mesh:
    """Multi-host mesh: 'data' would span processes, 'series' stay within
    one. Falls back to the flat single-process mesh when only one
    process exists (no initialized `torch.distributed` group, or a
    group of one); a mesh across processes is ROADMAP section 1, item
    13b."""
    if not torch.distributed.is_available() or \
            not torch.distributed.is_initialized() or \
            torch.distributed.get_world_size() == 1:
        return make_mesh(series_shards=series_shards, devices=devices)
    raise NotImplementedError(
        "a serving mesh across processes comes with ROADMAP section 1, "
        "item 13b")


def mesh_fingerprint(mesh: Mesh) -> tuple:
    """Value identity for a mesh, safe to key caches on (`id(mesh)` is
    not: ids are reused after garbage collection)."""
    return (tuple(mesh.shape.items()),
            tuple(str(d) for d in mesh.devices.flat))


def _chunks(n: int, parts: int) -> list[slice]:
    per = n // parts
    return [slice(i * per, (i + 1) * per) for i in range(parts)]


def shard_batch_arrays(mesh: Mesh, arrays: dict) -> dict:
    """Host batch columns split over 'data': each value becomes a list
    of contiguous chunks, chunk d on the (d, 0) device. Lengths must
    divide by the data shard count."""
    dd = mesh.shape["data"]
    out = {}
    for k, v in arrays.items():
        t = torch.as_tensor(np.asarray(v))
        if t.shape[0] % dd:
            raise ValueError(f"{k}: {t.shape[0]} rows do not split over "
                             f"{dd} data shards")
        out[k] = [t[sl].to(mesh.device(d, 0))
                  for d, sl in enumerate(_chunks(t.shape[0], dd))]
    return out


def merge_sketch_states(states: Sequence):
    """Merge per-shard sketch/registry states in shard order: HLL
    registers (a field named `registers`) by max, every other tensor
    (counts, sums) by sum. States are tensors or dataclasses, dicts,
    lists and tuples of them; non-tensor leaves come from the first."""

    def merge(vals, name=""):
        v0 = vals[0]
        if isinstance(v0, torch.Tensor):
            out = v0.clone()
            for v in vals[1:]:
                v = v.to(out.device)
                out = torch.maximum(out, v) if name == "registers" \
                    else out + v
            return out
        if dataclasses.is_dataclass(v0):
            return dataclasses.replace(v0, **{
                f.name: merge([getattr(v, f.name) for v in vals], f.name)
                for f in dataclasses.fields(v0)})
        if isinstance(v0, dict):
            return {k: merge([v[k] for v in vals], k) for k in v0}
        if isinstance(v0, (list, tuple)):
            return type(v0)(merge([v[i] for v in vals], name)
                            for i in range(len(v0)))
        return v0

    return merge(list(states))


# ---------------------------------------------------------------------------
# K1 over series shards
# ---------------------------------------------------------------------------

def shard_page_rows(rows: Sequence[int], shards: int,
                    cap: int = 64) -> int:
    """The largest power of two <= `cap` that divides every shard's row
    count (`rows[r] // shards`): the page of delta planes built for a
    shard."""
    pr = cap
    for r in rows:
        c = r // shards
        while pr > 1 and c % pr:
            pr >>= 1
    return pr


def localize(tables: torch.Tensor, ranges: Sequence[tuple[int, int, int]]
             ) -> torch.Tensor:
    """Per-shard page tables: in role r's row, a physical page p in
    [lo, hi) becomes p - base (its page in the shard's window), every
    other entry -1 (K1 skips it). `ranges[r]` = (lo, hi, base)."""
    out = torch.full_like(tables, -1)
    for r, (lo, hi, base) in enumerate(ranges):
        t = tables[r]
        own = (t >= max(lo, 1)) & (t < hi)
        out[r] = torch.where(own, t - base, out[r])
    return out


def window(arena: torch.Tensor, base: int, hi: int,
           page_rows: int) -> torch.Tensor:
    """Rows [base, hi) pages of `arena`: a shard's window, whose local
    page 0 is the page before the shard's first (never written)."""
    return arena[base * page_rows:hi * page_rows]


def identity_ranges(rows: Sequence[int], shards: int, s: int,
                    page_rows: int) -> list[tuple[int, int, int]]:
    """Shard s's (lo, hi, base) per role over identity-tabled planes
    (`ops.pages.identity_tables`: logical page p at physical p + 1)."""
    out = []
    for r in rows:
        q = -(-(r // shards) // page_rows)   # whole pages unless 1 shard
        out.append((s * q + 1, (s + 1) * q + 1, s * q))
    return out


@dataclasses.dataclass
class ShardPlan:
    """K1's operands for each series shard of one state: the role arena
    windows (each behind its never-written page 0) and the localized
    [R, P] tables, on the shard's (0, s) device."""

    arenas: list
    tables: list
    page_rows: int
    # the data axis's delta windows and tables by (d, s), made at first
    # use and zeroed before each launch: the same tensors every dispatch
    deltas: dict = dataclasses.field(default_factory=dict)


def dense_plan(mesh: Mesh, arenas: Sequence[torch.Tensor],
               tables: torch.Tensor, rows: Sequence[int],
               page_rows: int) -> ShardPlan:
    """The plan of resident dense state: role arenas from
    `ops.pages.dense_zeros`, their identity `tables`, `rows[r]` rows per
    role. Every shard's rows must be whole pages."""
    ss = mesh.shape["series"]
    plan = ShardPlan([], [], page_rows)
    for s in range(ss):
        rng = identity_ranges(rows, ss, s, page_rows)
        plan.arenas.append(tuple(window(a, base, hi, page_rows)
                                 for a, (lo, hi, base) in zip(arenas, rng)))
        plan.tables.append(localize(tables, rng))
    return plan


def pool_plan(mesh: Mesh, arenas: Sequence[torch.Tensor],
              tables: torch.Tensor, n_pages: int,
              page_rows: int) -> ShardPlan:
    """The plan of pooled (paged) state: every arena holds `n_pages`
    pages, series shard s owns physical pages [s P / S, (s+1) P / S)
    (page 0, the pool's trash page, is never in a table)."""
    ss = mesh.shape["series"]
    per = n_pages // ss
    plan = ShardPlan([], [], page_rows)
    for s in range(ss):
        lo, hi = s * per, (s + 1) * per
        base = max(lo - 1, 0)
        plan.arenas.append(tuple(window(a, base, hi, page_rows)
                                 for a in arenas))
        plan.tables.append(localize(tables, [(lo, hi, base)] * len(arenas)))
    return plan


def _pad_batch(batch, parts: int):
    """Pad a packed [4, n] matrix or four vectors to a multiple of
    `parts` columns with discarded rows (slot -1)."""
    n = batch.shape[1] if isinstance(batch, torch.Tensor) else len(batch[0])
    pad = -n % parts
    if not pad:
        return batch, n
    if isinstance(batch, torch.Tensor):
        ext = torch.zeros((batch.shape[0], pad), dtype=batch.dtype,
                          device=batch.device)
        ext[0] = -1
        return torch.cat([batch, ext], dim=1), n + pad
    return (np.concatenate([np.asarray(batch[0], np.int32),
                            np.full(pad, -1, np.int32)]),
            *(np.concatenate([np.asarray(b, np.float32),
                              np.zeros(pad, np.float32)])
              for b in batch[1:])), n + pad


def _cols(batch, sl: slice, device):
    if isinstance(batch, torch.Tensor):
        return batch[:, sl].to(device).contiguous()
    return tuple(np.asarray(b)[sl] for b in batch)


def _merge_delta(acc: torch.Tensor, d: torch.Tensor, mom_k) -> torch.Tensor:
    """acc + d, or for the moments plane (`mom_k`) sums add and the two
    bound columns take the max."""
    if mom_k is None:
        return acc + d
    out = acc.clone()
    out[:, :mom_k + 1] += d[:, :mom_k + 1]
    out[:, mom_k + 1:] = torch.maximum(acc[:, mom_k + 1:], d[:, mom_k + 1:])
    return out


def _fold_into(base: torch.Tensor, delta: torch.Tensor, mom_k) -> None:
    """base <- base (+) delta in place, (+) as in `_merge_delta`."""
    if mom_k is None:
        base += delta
    else:
        base[:, :mom_k + 1] += delta[:, :mom_k + 1]
        base[:, mom_k + 1:] = torch.maximum(base[:, mom_k + 1:],
                                            delta[:, mom_k + 1:])


def _role_mom_k(n_roles: int, r: int, step_kw: dict):
    mom_rows = step_kw.get("mom_rows", 0)
    return step_kw["mom_meta"][0] if mom_rows and r == n_roles - 1 else None


def k1_shards(mesh: Mesh, plan: ShardPlan, batch, *,
              compact: bool = False, scratch=None, **step_kw) -> None:
    """One span-metrics update of a sharded state, in place: K1 launched
    once per (data, series) shard. With one data shard each series
    shard's K1 writes its own window; with more, each (d, s) shard's K1
    writes a zeroed delta of s's window from column chunk d, the deltas
    reduce over 'data' in shard order onto the (0, s) device and fold
    into the window (moments bounds by max)."""
    from tempo_tpu_torch.ops import pages as op

    ds, ss = mesh.shape["data"], mesh.shape["series"]
    shift = plan.page_rows.bit_length() - 1
    if ds == 1:
        for s in range(ss):
            dev = plan.arenas[s][0].device
            op.fused_step(plan.arenas[s], plan.tables[s],
                          _cols(batch, slice(None), dev), page_shift=shift,
                          compact=compact, scratch=scratch, **step_kw)
        return
    if compact:
        raise ValueError("the serving mesh's data axis takes f32 state "
                         "only (compact state needs data_shards 1)")
    batch, n = _pad_batch(batch, ds)
    chunks = _chunks(n, ds)
    pr = plan.page_rows
    for s in range(ss):
        base = plan.arenas[s]
        acc = None
        for d in range(ds):
            dev = mesh.device(d, s)
            got = plan.deltas.get((d, s))
            if got is None:
                got = plan.deltas[(d, s)] = (
                    tuple(torch.zeros_like(a, device=dev) for a in base),
                    plan.tables[s].to(dev))
            else:
                for z in got[0]:
                    z.zero_()
            zeros, tables = got
            op.fused_step(zeros, tables, _cols(batch, chunks[d], dev),
                          page_shift=shift, **step_kw)
            rows = [z[pr:].to(base[0].device) for z in zeros]
            acc = rows if acc is None else [
                _merge_delta(a, z, _role_mom_k(len(base), r, step_kw))
                for r, (a, z) in enumerate(zip(acc, rows))]
        for r, (a, dlt) in enumerate(zip(base, acc)):
            _fold_into(a[pr:], dlt, _role_mom_k(len(base), r, step_kw))


def _delta_plan(mesh: Mesh, rows: Sequence[int], widths: Sequence,
                device) -> ShardPlan:
    """Zeroed trash-paged windows of each shard's rows (and their
    localized identity tables), for the functional steps: their K1
    writes the shard's whole update into these, then adds them to the
    base."""
    from tempo_tpu_torch.ops import pages as op

    ss = mesh.shape["series"]
    pr = shard_page_rows(rows, ss)
    ident = op.identity_tables(rows, pr, device)
    plan = ShardPlan([], [], pr)
    for s in range(ss):
        dev = mesh.device(0, s)
        plan.arenas.append(tuple(
            torch.zeros((pr + r // ss,) if w is None else
                        (pr + r // ss, w), dtype=torch.float32, device=dev)
            for r, w in zip(rows, widths)))
        plan.tables.append(localize(ident, identity_ranges(rows, ss, s,
                                                           pr)).to(dev))
    return plan


def _functional_step(mesh: Mesh, states: Sequence[torch.Tensor], batch,
                     **step_kw) -> tuple:
    """base (+) the sharded K1 update, as new tensors on the base's
    device: each series shard's rows updated from the whole batch by
    `k1_shards` over zeroed windows."""
    ss = mesh.shape["series"]
    rows = [t.shape[0] for t in states]
    widths = [None if t.dim() == 1 else t.shape[1] for t in states]
    plan = _delta_plan(mesh, rows, widths, states[0].device)
    k1_shards(mesh, plan, batch, **step_kw)
    pr = plan.page_rows
    out = []
    for r, t in enumerate(states):
        c = t.shape[0] // ss
        res = t.clone()
        for s in range(ss):
            _fold_into(res[s * c:(s + 1) * c],
                       plan.arenas[s][r][pr:].to(t.device),
                       _role_mom_k(len(states), r, step_kw))
        out.append(res)
    return tuple(out)


def _check_capacity(rows: Sequence[int], ss: int, what: str) -> None:
    if any(r % ss for r in rows if r):
        raise ValueError(f"{what}: state capacities {tuple(rows)} must "
                         f"divide by series_shards ({ss})")


def sharded_spanmetrics_step(mesh: Mesh, edges: tuple, gamma: float,
                             min_value: float):
    """The multi-device span-metrics step over `mesh`, as the reference
    builds it: fn(calls_v, h_buckets, h_sums, h_counts, size_v,
    dd_counts, dd_zeros, slots, dur_s, sizes, weights) -> the seven
    updated states (new tensors). Series shards own slot ranges; data
    shards split the batch, and their deltas reduce over 'data'."""

    def step(calls_v, h_buckets, h_sums, h_counts, size_v, dd_counts,
             dd_zeros, slots, dur_s, sizes, weights):
        ss = mesh.shape["series"]
        _check_capacity((calls_v.shape[0], dd_counts.shape[0]), ss,
                        "sharded_spanmetrics_step")
        states = (calls_v, h_sums, h_counts, size_v, h_buckets, dd_zeros,
                  dd_counts)
        out = _functional_step(
            mesh, states, (slots, dur_s, sizes, weights),
            edges=tuple(edges), gamma=gamma, min_value=min_value,
            dd_rows=dd_counts.shape[0])
        c, hs, hc, sz, hb, ddz, ddc = out
        return c, hb, hs, hc, sz, ddc, ddz

    return step


def sharded_serving_step(mesh: Mesh, edges: tuple, gamma: float,
                         min_value: float, capacity: int, dd_rows: int,
                         packed: bool = False, mom_rows: int = 0,
                         mom_meta: "tuple | None" = None):
    """The serving twin of `sharded_spanmetrics_step`, with the
    reference's signature: fn(calls_v, h_buckets, h_sums, h_counts,
    size_v[, dd_counts, dd_zeros][, mom_data], slots, dur_s, sizes,
    weights) -> states, or fn(states..., packed_matrix) when `packed`.
    `dd_rows=0` builds a sketchless step. Each series shard scatters the
    same batch rows in the same order into the slots it owns, so with
    one data shard the result is bit-identical at every series shard
    count on the host; more data shards change the float sums' order
    (close, not bit-equal). A processor's resident state takes
    `ServingMesh.fused_update` instead, which updates its windows in
    place."""
    ss = mesh.shape["series"]
    _check_capacity((capacity, dd_rows, mom_rows), ss, "serving mesh")
    n_sketch = (2 if dd_rows else 0) + (1 if mom_rows else 0)
    kw = dict(edges=tuple(edges), gamma=gamma, min_value=min_value,
              dd_rows=dd_rows, mom_rows=mom_rows, mom_meta=mom_meta)

    def step(calls_v, h_buckets, h_sums, h_counts, size_v, *rest):
        sk, rest = rest[:n_sketch], rest[n_sketch:]
        states = [calls_v, h_sums, h_counts, size_v, h_buckets]
        if dd_rows:
            states += [sk[1], sk[0]]
        if mom_rows:
            states.append(sk[-1])
        batch = torch.as_tensor(rest[0]) if packed else tuple(rest)
        out = _functional_step(mesh, states, batch, **kw)
        res = (out[0], out[4], out[1], out[2], out[3])
        if dd_rows:
            res += (out[6], out[5])
        if mom_rows:
            res += (out[-1],)
        return res

    return step


def sharded_query_range_step(mesh: Mesh, n_buckets: int = 0):
    """The sequence-parallel TraceQL-metrics observation: spans (slots,
    steps, values) split over 'data', the [series, steps] grid (or
    [series, steps, buckets] with `n_buckets`, counting each span into
    its log2 bucket) split over 'series'. Each (d, s) shard adds its
    span chunk into the rows it owns (`index_add_`), the deltas reduce
    over 'data' in shard order, and the grid adds them.
    Returns fn(grid, slots, steps, values) -> grid (new tensor)."""

    def step(grid, slots, steps, values):
        ds, ss = mesh.shape["data"], mesh.shape["series"]
        grid = torch.as_tensor(grid)
        rows = grid.shape[0]
        _check_capacity((rows,), ss, "sharded_query_range_step")
        c = rows // ss
        cols = [torch.as_tensor(np.asarray(x)) for x in (slots, steps, values)]
        n = cols[0].shape[0]
        if n % ds:
            raise ValueError(f"{n} spans do not split over {ds} data shards")
        out = grid.clone()
        cell = grid[0].numel()
        for s in range(ss):
            acc = None
            for d, sl in enumerate(_chunks(n, ds)):
                dev = mesh.device(d, s)
                sl_, st, v = (x[sl].to(dev) for x in cols)
                sl_ = sl_.to(torch.int64)
                own = (sl_ >= s * c) & (sl_ < (s + 1) * c)
                local = torch.where(own, sl_ - s * c, 0)
                delta = torch.zeros((c * cell,), dtype=torch.float32,
                                    device=dev)
                flat = local * cell + st.to(torch.int64) * (
                    n_buckets or 1)
                if n_buckets:
                    b = torch.clamp(torch.ceil(torch.log2(torch.clamp(
                        v.to(torch.float32), min=1.0))), 0, n_buckets - 1)
                    flat = flat + b.to(torch.int64)
                    add = torch.where(own, 1.0, 0.0)
                else:
                    add = torch.where(own, v.to(torch.float32), 0.0)
                delta.index_add_(0, flat, add.to(torch.float32))
                delta = delta.to(grid.device)
                acc = delta if acc is None else acc + delta
            out[s * c:(s + 1) * c] += acc.view(out[s * c:(s + 1) * c].shape)
        return out

    return step


__all__ = ["Mesh", "ShardPlan", "validate_mesh_shape", "visible_devices",
           "make_mesh", "make_multihost_mesh", "mesh_fingerprint",
           "shard_batch_arrays", "merge_sketch_states", "dense_plan",
           "pool_plan", "k1_shards", "sharded_spanmetrics_step",
           "sharded_serving_step", "sharded_query_range_step"]
