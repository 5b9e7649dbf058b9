"""Paged device state: page-table translation + paged scatter updates.

Counterpart of `tempo_tpu/ops/pages.py`. State lives in a few
process-wide arenas carved into fixed-size pages (pow-2 rows each), and
every update gathers the physical page of each row through a small
indirection table before it scatters:

    logical slot s  →  page_table[s >> page_shift]          (gather)
                    →  phys_page * page_rows + (s & mask)   (arena row)

Discards keep the dense -1 semantics: a negative slot or an unbacked
page (table entry -1) translates to `arena_rows`, one past the last row,
and every update drops such rows. The adds drop them without selecting
them out: each add is one `index_add_` over all the spans, a dropped
span aimed at row 0 with a zero addend (`add_rows`, `add_cells`) — in a
pool arena row 0 is the trash page, which stays zero. A boolean
selection would sync with the host and PyTorch's accumulating
`index_put_` sorts its indices on the card; neither is used.

The reference builds memoized jitted steps that take and return
(donated) arenas. PyTorch runs eagerly and has no donation, so each
`*_step` here is a plain function that updates its arena tensor in
place; callers hold the pool lock across the call, as the reference's
callers hold it across dispatch and rebind.

`fused_step` is the slice's hot path: it hands the whole span-metrics
plane family to `ops.cuda_kernels.paged_fused_update`, which launches
the hand-written CUDA kernel for tensors on the card and runs its plain
version for tensors on the host: the composed scatters of `_fused_body`
into per-role logical-row deltas (`dispatch_deltas`), folded into the
backed pages under each arena's storage rule (`fold_deltas`).

Arenas are f32, or under the compact-state tier int32 (counts and bucket
grids) and bf16 [rows, 2] (the latency sum's Kahan pair).

Dense state (no page pool) uses the same step: each dense tensor is a
row view of its own arena behind one leading trash page (`dense_zeros`),
and `identity_tables` maps logical page p to physical page p + 1.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch


def translate(page_table: torch.Tensor, slots: torch.Tensor, page_shift: int,
              arena_rows: int) -> torch.Tensor:
    """Logical slots → physical arena rows (int64); discards and unbacked
    pages → `arena_rows`."""
    s = slots.to(torch.int64)
    n_lp = page_table.shape[0]
    lp = s >> page_shift
    phys = page_table[lp.clamp(0, n_lp - 1)].to(torch.int64)
    row = (phys << page_shift) | (s & ((1 << page_shift) - 1))
    bad = (s < 0) | (phys < 0) | (lp >= n_lp)
    return torch.where(bad, arena_rows, row)


def add_rows(t: torch.Tensor, rows: torch.Tensor, keep: torch.Tensor,
             vals: torch.Tensor) -> None:
    """t[rows] += vals for the kept spans, in place, as one `index_add_`
    over every span: a dropped span adds zero to row 0. `rows` int64
    (any value where not kept), `vals` of t's dtype."""
    t.index_add_(0, torch.where(keep, rows, 0),
                 torch.where(keep, vals, vals.new_zeros(())))


def add_cells(t: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
              keep: torch.Tensor, vals: torch.Tensor) -> None:
    """t[rows, cols] += vals for the kept spans of a contiguous 2-D t, in
    place, as one `index_add_` on its flat view (int64 flat indices, so
    `rows * width` cannot overflow): a dropped span adds zero to row 0.
    `vals` [N] with `cols` [N] in [0, width), or [N, C] with `cols` [C]."""
    if vals.dim() == 2:
        rows, keep, cols = rows[:, None], keep[:, None], cols[None, :]
    flat = torch.where(keep, rows, 0) * t.shape[1] + cols
    t.view(-1).index_add_(0, flat.reshape(-1), torch.where(
        keep, vals, vals.new_zeros(())).reshape(-1))


def max_rows(t: torch.Tensor, rows: torch.Tensor, keep: torch.Tensor,
             vals: torch.Tensor) -> None:
    """t[rows] = max(t[rows], vals) for the kept spans, in place; a dropped
    span maxes zero into row 0, so `t` and `vals` must be non-negative."""
    t.scatter_reduce_(0, torch.where(keep, rows, 0),
                      torch.where(keep, vals, vals.new_zeros(())), "amax")


def _kept(arena: torch.Tensor, table, slots, page_shift):
    """(rows, keep): the slots' arena rows and which of them are backed
    (discards and unbacked pages translate past the last row)."""
    r = translate(table, slots, page_shift, arena.shape[0])
    return r, r < arena.shape[0]


def _add1(arena, table, slots, vals, page_shift) -> None:
    add_rows(arena, *_kept(arena, table, slots, page_shift), vals)


def _hist_scatter(arena2d, table, slots, buckets, w, page_shift) -> None:
    """Add weights into a wide arena at (row(slot), bucket)."""
    r, keep = _kept(arena2d, table, slots, page_shift)
    add_cells(arena2d, r, buckets, keep, w)


def round_i32(x: torch.Tensor) -> torch.Tensor:
    """Compact-tier integer projection: nearest int, ties to even (as
    `jnp.round`)."""
    return torch.round(x).to(torch.int32)


def _moments_scatter(am, table, slots, dur_s, w, mom_meta: tuple,
                     page_shift: int) -> None:
    """Paged moments update (ops/moments.py layout), in place: count and
    Chebyshev log-moment sums add into columns 0..k, the two shifted
    bound columns take the max, unweighted. Discards drop."""
    from tempo_tpu_torch.ops import moments as msk

    mk, mlo, mhi = mom_meta
    r, keep = _kept(am, table, slots, page_shift)
    msk.moments_scatter(am, r, keep, dur_s, w, mk, mlo, mhi)


# ---------------------------------------------------------------------------
# per-family updates (the non-fused registry paths)
# ---------------------------------------------------------------------------

def counter_add_step(arena, table, slots, vals, *, page_shift: int) -> None:
    """Paged counter add, in place (values cast to the arena's dtype)."""
    _add1(arena, table, slots,
          torch.as_tensor(vals, device=arena.device).to(arena.dtype),
          page_shift)


def gauge_set_step(arena, table, slots, vals, *, page_shift: int) -> None:
    """Paged gauge set, in place (the host already resolved last-wins
    per slot)."""
    r, keep = _kept(arena, table, slots, page_shift)
    v = torch.as_tensor(vals, dtype=torch.float32, device=arena.device)
    # a dropped span sets zero into row 0, the trash page (the host
    # resolved one row per slot, so the kept rows are distinct)
    arena.index_put_((torch.where(keep, r, 0),),
                     torch.where(keep, v, v.new_zeros(())))


def hist_bucket(v: torch.Tensor, edges: tuple) -> torch.Tensor:
    """Latency histogram bucket Σ(v > e) over the f32 edges —
    `searchsorted(side="left")`: a value equal to an edge falls in that
    edge's bucket."""
    e = _edges_on(tuple(edges), v.device)
    return (v[:, None] > e[None, :]).sum(dim=1)


@functools.lru_cache(maxsize=64)
def _edges_on(edges: tuple, device: torch.device) -> torch.Tensor:
    """The f32 edges on `device`, copied there once (callers only read)."""
    return torch.tensor(edges, dtype=torch.float32, device=device)


def histogram_observe_step(a_sums, a_counts, ab, t_bucket, t_sums, t_counts,
                           slots, values, weights, *, edges: tuple,
                           page_shift: int) -> None:
    """Classic histogram over f32 arenas, in place: bucket increments in
    the wide arena, sums and counts each in their own role arena."""
    dev = ab.device
    v = torch.as_tensor(values, dtype=torch.float32, device=dev)
    w = torch.as_tensor(weights, dtype=torch.float32, device=dev)
    _hist_scatter(ab, t_bucket, slots, hist_bucket(v, tuple(edges)), w,
                  page_shift)
    _add1(a_sums, t_sums, slots, v * w, page_shift)
    _add1(a_counts, t_counts, slots, w, page_shift)


# ---------------------------------------------------------------------------
# reads: gather / zero through the table
# ---------------------------------------------------------------------------

def gather_step(arena, table, slots, *, page_shift: int) -> torch.Tensor:
    """Rows [n] or [n, width] of the slots; unbacked or negative slots
    read 0 (freed pages are zeroed, so a stale table entry can never
    leak another tenant's rows)."""
    r = translate(table, slots, page_shift, arena.shape[0])
    bad = r >= arena.shape[0]
    got = arena[torch.where(bad, 0, r)]
    fill = bad if arena.ndim == 1 else bad[:, None]
    return got.masked_fill(fill, 0)


def u32_on(h, device) -> torch.Tensor:
    """uint32 hashes (numpy or a tensor) as int64 on `device`: CUDA has
    few uint32 ops, so hashes ride in int64 and a signed 32-bit tensor is
    read back as its unsigned value."""
    if isinstance(h, torch.Tensor):
        return h.to(device=device, dtype=torch.int64) & 0xFFFFFFFF
    return torch.from_numpy(np.asarray(h, np.uint32).astype(np.int64)).to(
        device)


def hll_cells(h1: torch.Tensor, h2: torch.Tensor,
              precision: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(register, rho) of int64 hashes in [0, 2^32): the register is h1's
    top `precision` bits; rho = clz32(h2) + 1 = 33 - bit_length(h2), so 33
    for h2 = 0 and 1 for h2 >= 2^31. There is no clz op in torch, and a
    float log2 rounds up just below a power of two, so the bit length is
    a binary search in integer shifts."""
    n = torch.zeros_like(h2)
    x = h2
    for s in (16, 8, 4, 2, 1):
        big = x >= (1 << s)
        n = n + big * s
        x = torch.where(big, x >> s, x)
    rho = (33 - (n + x)).to(torch.int32)
    return h1 >> (32 - precision), rho


def hll_step(ar, table, slots, h1, h2, *, precision: int,
             page_shift: int) -> None:
    """Paged HyperLogLog, in place: the scatter-max of each item's rho
    into its register of the row the page table resolves for its slot
    (`ar` [rows, 2^precision] int32); discards and unbacked pages drop."""
    dev = ar.device
    r, keep = _kept(ar, table, torch.as_tensor(slots, device=dev), page_shift)
    idx, rho = hll_cells(u32_on(h1, dev), u32_on(h2, dev), precision)
    max_rows(ar.view(-1), r * ar.shape[1] + idx, keep, rho)


NUM_LOG2_BUCKETS = 64


def log2_bucket(values: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """Power-of-two bucket of f32 values, int64: 0 for v <= 0, else
    floor(log2 v) + 1 + offset, clipped to [0, 63]. As in the reference,
    the f32 log2 takes a 1e-4 nudge so an exact power of two (2^62
    included) lands in its own bucket; the nudge is a device tensor, not
    a host scalar."""
    v = torch.clamp(values.to(torch.float32), min=0.0)
    nudge = torch.tensor(1e-4, dtype=torch.float32, device=v.device)
    b = torch.floor(torch.log2(torch.clamp(v, min=1e-30)) + nudge) \
        + (1.0 + offset)
    b = torch.where(v > 0, b, torch.zeros((), dtype=b.dtype, device=b.device))
    return b.clamp(0, NUM_LOG2_BUCKETS - 1).to(torch.int64)


def native_hist_step(a_sums, a_counts, a_zeros, ah, t_hist, t_sums, t_counts,
                     t_zeros, slots, values, weights, *, offset: int,
                     page_shift: int) -> None:
    """Exponential (native) histogram over f32 arenas, in place: the log2
    counts in the wide arena `ah` [rows, 64], the sum, count and
    zero-count each in their own role arena."""
    dev = ah.device
    s = torch.as_tensor(slots, device=dev)
    v = torch.as_tensor(values, dtype=torch.float32, device=dev)
    w = torch.as_tensor(weights, dtype=torch.float32, device=dev)
    _hist_scatter(ah, t_hist, s, log2_bucket(v, offset), w, page_shift)
    _add1(a_sums, t_sums, s, v * w, page_shift)
    _add1(a_counts, t_counts, s, w, page_shift)
    _add1(a_zeros, t_zeros, s, torch.where(v == 0, w, w.new_zeros(())),
          page_shift)


def log2_hist_step(ah, table, slots, values, weights, *, offset: int,
                   page_shift: int) -> None:
    """The bare paged log2-histogram update, in place (the paged twin of
    `ops.sketches.log2_hist_update`)."""
    dev = ah.device
    v = torch.as_tensor(values, dtype=torch.float32, device=dev)
    _hist_scatter(ah, table, torch.as_tensor(slots, device=dev),
                  log2_bucket(v, offset),
                  torch.as_tensor(weights, dtype=torch.float32, device=dev),
                  page_shift)


def dd_step(a_zeros, ad, t_counts, t_zeros, slots, values, weights, *,
            gamma: float, min_value: float, page_shift: int) -> None:
    """The paged DDSketch update, in place: log-γ bucket counts into the
    wide arena `ad` [Rd, B] through `t_counts`, zero counts into their
    width-1 arena through `t_zeros`. Masking slots past a plane smaller
    than the series table is the caller's job (pass -1)."""
    dev = ad.device
    slots = torch.as_tensor(slots, device=dev).to(torch.int64)
    v = torch.as_tensor(values, dtype=torch.float32, device=dev)
    w = torch.as_tensor(weights, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    is_zero = v <= torch.tensor(min_value, dtype=torch.float32, device=dev)
    idx = dd_index(v, gamma, min_value, ad.shape[-1])
    _hist_scatter(ad, t_counts, slots, idx, torch.where(is_zero, zero, w),
                  page_shift)
    _add1(a_zeros, t_zeros, slots, torch.where(is_zero, w, zero), page_shift)


def zero_step(arena, table, slots, *, page_shift: int) -> None:
    """Zero the slots' rows in place (eviction sweep)."""
    r = translate(table, slots, page_shift, arena.shape[0])
    arena[r[r < arena.shape[0]]] = 0


def zero_pages_step(arena, pages, *, page_rows: int) -> None:
    """Zero every listed physical page in place, in one indexing op
    (negative page ids are ignored): pages return to the free list all
    zero so the next owner starts clean."""
    p = torch.as_tensor(pages, device=arena.device).to(torch.int64)
    p = p[p >= 0]
    rows = (p[:, None] * page_rows
            + torch.arange(page_rows, device=arena.device)[None, :])
    arena[rows.reshape(-1)] = 0


# ---------------------------------------------------------------------------
# dense state: row views of trash-paged arenas, identity page tables
# ---------------------------------------------------------------------------

# Rows per page of dense state. Each dense arena carries one trash page,
# so the page costs every role `page_rows` rows of padding, and the
# stacked [8, P] identity table (P = capacity / page_rows) must fit the
# shared memory K1 stages it in (`cuda_kernels.MAX_TABLE_BYTES`). At the
# default deployment (65,536 series, DDSketch over 16,384) 64 rows give
# 329,984 B of trash pages, 0.37% of the 88.2 MB of state, and a 32 KB
# table; larger capacities double the page until the table fits.
DENSE_PAGE_ROWS = 64


def dense_page_rows(capacity: int) -> int:
    """Rows per page of a dense tenant of `capacity` series."""
    from tempo_tpu_torch.ops.cuda_kernels import MAX_ROLES, MAX_TABLE_BYTES

    pr = DENSE_PAGE_ROWS
    while MAX_ROLES * 4 * -(-capacity // pr) > MAX_TABLE_BYTES:
        pr <<= 1
    return pr


def dense_zeros(rows: int, width: "int | None", *, page_rows: int, device,
                dtype=torch.float32) -> torch.Tensor:
    """Zero state [rows] (width None) or [rows, width]: rows [page_rows,
    page_rows + rows) of an arena whose first page is the trash page and
    whose row count is a whole number of pages, so K1 can address it
    through an identity table (`arena_of` recovers the arena)."""
    n = page_rows + -(-rows // page_rows) * page_rows
    arena = torch.zeros((n,) if width is None else (n, width), dtype=dtype,
                        device=device)
    return arena[page_rows:page_rows + rows]


def arena_of(view: torch.Tensor, page_rows: int) -> torch.Tensor:
    """The arena a `dense_zeros` view lies in; raises if `view` is not
    such a view."""
    base = view._base
    if base is None or base.dtype != view.dtype or \
            base.shape[1:] != view.shape[1:] or base.shape[0] % page_rows or \
            view.data_ptr() != base.data_ptr() + page_rows * base.stride(0) \
            * base.element_size():
        raise ValueError("not a row view of a trash-paged arena "
                         f"(page_rows {page_rows})")
    return base


def place_view(view: torch.Tensor, device, page_rows: int) -> torch.Tensor:
    """`view` as a row view of a trash-paged arena on `device` with
    `page_rows`-row pages: itself when it already is one, else a copy
    into a new `dense_zeros` arena (the serving mesh's placement)."""
    dev = torch.device(device)
    try:
        arena_of(view, page_rows)
        if view.device == dev:
            return view
    except ValueError:
        pass
    out = dense_zeros(view.shape[0], view.shape[1] if view.dim() > 1
                      else None, page_rows=page_rows, device=dev,
                      dtype=view.dtype)
    out.copy_(view)
    return out


def identity_tables(rows: Sequence[int], page_rows: int,
                    device) -> torch.Tensor:
    """The stacked [R, P] int32 page tables of dense state: role r maps
    logical page p < ceil(rows[r] / page_rows) to physical page p + 1
    (page 0 is the trash page), the rest is -1."""
    pages = [-(-r // page_rows) for r in rows]
    t = torch.full((len(rows), max(pages)), -1, dtype=torch.int32)
    for r, n in enumerate(pages):
        t[r, :n] = torch.arange(1, n + 1, dtype=torch.int32)
    return t.to(device)


# ---------------------------------------------------------------------------
# the fused span-metrics step (calls + latency hist + size + DDSketch)
# ---------------------------------------------------------------------------

def dd_index(v: torch.Tensor, gamma: float, min_value: float,
             nb: int) -> torch.Tensor:
    """DDSketch bucket of f32 durations, in the reference's f32 op order:
    ceil(log(max(v, min) / min) / f32(log γ)), clipped to [0, nb-1].
    Divisors are device tensors, never Python scalars: PyTorch's CUDA
    division by a host scalar multiplies by its reciprocal, which is not
    IEEE division."""
    mn = torch.tensor(min_value, dtype=torch.float32, device=v.device)
    lg = torch.tensor(math.log(gamma), dtype=torch.float32, device=v.device)
    idx = torch.ceil(torch.log(torch.maximum(v, mn) / mn) / lg)
    return idx.clamp(0, nb - 1).to(torch.int64)


def _fused_body(arenas: Sequence[torch.Tensor], tables: Sequence[torch.Tensor],
                slots, dur_s, sizes, weights, *, edges: tuple, gamma: float,
                min_value: float, dd_rows: int, page_shift: int,
                mom_rows: int = 0, mom_meta: "tuple | None" = None) -> None:
    """One paged step for all span-metrics families over f32 arenas, as
    composed scatters, in place. `arenas` / `tables` are role-aligned:
    (calls, hist_sums, hist_counts, sizes, hist_buckets[, dd_zeros,
    dd_counts][, moments]); each plane scatters into its own role arena
    through its own table. The op order and f32 arithmetic follow the
    reference's `_fused_body` (`tempo_tpu/ops/pages.py:416`). The paged
    fused update's plain version runs it on f32 logical-row deltas
    (`dispatch_deltas`) and folds them under each arena's storage rule
    (`fold_deltas`), as the reference's Pallas kernel does."""
    a_calls, a_hs, a_hc, a_sz, ab = arenas[:5]
    t_calls, t_hs, t_hc, t_sz, t_hb = tables[:5]
    dev = a_calls.device
    slots = torch.as_tensor(slots, device=dev).to(torch.int64)
    w = torch.as_tensor(weights, dtype=torch.float32, device=dev)
    v = torch.as_tensor(dur_s, dtype=torch.float32, device=dev)
    _add1(a_calls, t_calls, slots, w, page_shift)
    _hist_scatter(ab, t_hb, slots, hist_bucket(v, tuple(edges)), w, page_shift)
    _add1(a_hs, t_hs, slots, v * w, page_shift)
    _add1(a_hc, t_hc, slots, w, page_shift)
    _add1(a_sz, t_sz, slots,
          torch.as_tensor(sizes, dtype=torch.float32, device=dev) * w,
          page_shift)
    if dd_rows:
        a_ddz, ad = arenas[5], arenas[6]
        t_ddz, t_ddc = tables[5], tables[6]
        # the DDSketch plane may cover a strict prefix of the table
        dd_slots = torch.where(slots < dd_rows, slots, -1)
        mn = torch.tensor(min_value, dtype=torch.float32, device=dev)
        is_zero = v <= mn
        idx = dd_index(v, gamma, min_value, ad.shape[-1])
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        _hist_scatter(ad, t_ddc, dd_slots, idx, torch.where(is_zero, zero, w),
                      page_shift)
        _add1(a_ddz, t_ddz, dd_slots, torch.where(is_zero, w, zero),
              page_shift)
    if mom_rows:
        mom_slots = torch.where(slots < mom_rows, slots, -1)
        _moments_scatter(arenas[-1], tables[-1], mom_slots, v, w, mom_meta,
                         page_shift)


def delta_shapes(n_lrows: int, n_edges: int, dd_rows: int, nb_dd: int,
                 mom_rows: int, mom_k: int) -> list[tuple[int, int]]:
    """(rows, width) of each role's dispatch delta by logical row: calls,
    latency sum, latency count and size 1 wide, the latency histogram
    n_edges+1, the DDSketch zeros 1 and grid `nb_dd`, the moments row
    k+3; rows are the series table's `n_lrows`, `dd_rows` or `mom_rows`
    (the sketch planes cover a prefix of the table)."""
    shapes = [(n_lrows, 1)] * 4 + [(n_lrows, n_edges + 1)]
    if dd_rows:
        shapes += [(dd_rows, 1), (dd_rows, nb_dd)]
    if mom_rows:
        shapes.append((mom_rows, mom_k + 3))
    return shapes


def dispatch_deltas(slots, vals, *, n_lrows: int, edges: tuple, gamma: float,
                    min_value: float, dd_rows: int, nb_dd: int, mom_rows: int,
                    mom_meta: "tuple | None", page_shift: int
                    ) -> list[torch.Tensor]:
    """Each role's whole-dispatch f32 delta by LOGICAL row (shapes from
    `delta_shapes`): the accumulation the reference's Pallas kernel makes
    per page before it writes back. Spans aimed at any logical page land
    here; the fold keeps only backed pages."""
    dev = vals.device
    shapes = delta_shapes(n_lrows, len(edges), dd_rows, nb_dd, mom_rows,
                          mom_meta[0] if mom_rows else 0)
    deltas = [torch.zeros((r,) if w == 1 else (r, w), dtype=torch.float32,
                          device=dev) for r, w in shapes]
    rows = [r for r, _ in shapes]
    # identity page tables: logical page p → delta page p
    ident = [torch.arange(-(-r // (1 << page_shift)), dtype=torch.int32,
                          device=dev) for r in rows]
    _fused_body(deltas, ident, slots, vals[0], vals[1], vals[2],
                edges=edges, gamma=gamma, min_value=min_value,
                dd_rows=dd_rows, page_shift=page_shift, mom_rows=mom_rows,
                mom_meta=mom_meta)
    return deltas


def fold_deltas(arenas: Sequence[torch.Tensor], tables: torch.Tensor,
                deltas: Sequence[torch.Tensor], *, page_shift: int,
                mom_k: "int | None") -> None:
    """Fold logical-row deltas into every backed page of each role, in
    place, under the arena's storage rule (the write-back of the
    reference's Pallas kernel, `pallas_kernels.py:338-378`):

      int32            += round-half-even(delta), once per dispatch
      bf16 [rows, 2]   the Kahan pair (sum, compensation): y = delta +
                       comp, tot = sum + y, comp' = y - (tot - sum) in
                       f32, both stored as bf16 — on EVERY row of every
                       backed page, untouched rows included (delta 0)
      f32              += delta
      moments (last role when `mom_k` is given): columns 0..k add, the
                       two bound columns take the max

    A table entry <= 0 (unbacked, padding) is skipped, so the trash page
    stays zero."""
    pr = 1 << page_shift
    dev = arenas[0].device
    offs = torch.arange(pr, device=dev)
    for r, (a, d) in enumerate(zip(arenas, deltas)):
        n_lp = -(-d.shape[0] // pr)
        t = tables[r, :n_lp].to(torch.int64)
        lps = torch.nonzero(t > 0).flatten()
        if not lps.numel():
            continue
        lrow = (lps[:, None] * pr + offs).reshape(-1)
        prow = (t[lps][:, None] * pr + offs).reshape(-1)
        inb = lrow < d.shape[0]
        lrow, prow = lrow[inb], prow[inb]
        delta = d[lrow]
        if a.dtype == torch.int32:
            a[prow] += round_i32(delta)
        elif a.dtype == torch.bfloat16:
            s, comp = a[prow, 0].float(), a[prow, 1].float()
            y = delta + comp
            tot = s + y
            a[prow] = torch.stack([tot, y - (tot - s)], dim=1).to(a.dtype)
        elif mom_k is not None and r == len(arenas) - 1:
            a[prow, :mom_k + 1] += delta[:, :mom_k + 1]
            a[prow, mom_k + 1:] = torch.maximum(a[prow, mom_k + 1:],
                                                delta[:, mom_k + 1:])
        else:
            a[prow] += delta


def fused_step(arenas: Sequence[torch.Tensor], tables: torch.Tensor, batch, *,
               edges: tuple, gamma: float, min_value: float, dd_rows: int,
               page_shift: int, mom_rows: int = 0,
               mom_meta: "tuple | None" = None, compact: bool = False,
               scratch: "torch.Tensor | None" = None) -> None:
    """The paged fused span-metrics update, in place.

    `tables` is the stacked [R, P] int32 table, padded with -1. `batch`
    is either one [4, N] f32 matrix (slots, dur_s, sizes, weights — slot
    ids exact in f32 under the caller's capacity < 2^24 gate) or a tuple
    of four vectors (int32 slots and three f32 rows). There are 5 roles,
    +2 with the DDSketch planes (dd_rows > 0), +1 with the moments plane
    (mom_rows > 0, `mom_meta` = (k, lo, hi)); `compact` takes int32 count
    arenas and the bf16 pair for the latency sum, and on the card the
    caller's persistent `scratch` (`cuda_kernels.compact_scratch`)."""
    from tempo_tpu_torch.ops import cuda_kernels

    dev = arenas[0].device
    if isinstance(batch, torch.Tensor):
        slots, vals = batch[0], batch[1:4]
    else:
        slots = torch.as_tensor(batch[0], dtype=torch.int32).to(dev)
        vals = torch.stack([torch.as_tensor(x, dtype=torch.float32)
                            for x in batch[1:4]]).to(dev)
    cuda_kernels.paged_fused_update(
        tables, slots, vals, tuple(arenas), page_rows=1 << page_shift,
        edges=tuple(edges), gamma=gamma, min_value=min_value,
        dd_rows=dd_rows, mom_rows=mom_rows, mom_meta=mom_meta,
        compact=compact, scratch=scratch)
