"""Structural trace analytics: per-trace DAG reconstruction as device ops.

Counterpart of `tempo_tpu/ops/structure.py`. Given one cut batch of spans
(many traces concatenated, pow-2 padded), reconstruct every trace's
parent-pointer forest and derive the two structural signals of the
trace-analytics processor:

- **critical path**: the chain of spans bounding the trace's end-to-end
  latency — the trace's anchor root (latest-finishing root span) down
  through each span's *bounding child* (the child that finishes last).
  Per-span self-time on that path is the span's end minus its on-path
  child's end (a leaf contributes its full duration), clamped at zero
  for async overlap.
- **error propagation**: for every errored span, the *root cause* is
  the deepest errored descendant reachable by repeatedly stepping to
  the latest-finishing errored child — the fixed point of that step
  function.

The reference's kernel is jitted jnp; here the same three primitives are
torch ops on the tensors' device, with no host synchronisation between
the upload and the one download at the end:

1. parent resolution by sorted-id matching over 2N interleaved
   (definition, query) entries. Each 8-byte id rides as ONE int64
   (matching needs only equality, so the signed order is harmless), and
   the reference's 4-key sort becomes two stable `torch.sort` passes,
   id then trace: entries are laid out definitions first, each half in
   ascending rows, so ties keep the definitions (ascending rows) ahead
   of the queries and the last definition of a duplicated id is its
   largest row, as the oracle says. The last-non-null scan is a
   `cummax` over definition positions and one gather;
2. lexicographic segment-argmax by (end, row) through
   `scatter_reduce_(..., "amax")`: one pass over the int64 end offsets,
   one over the rows of the spans that reach the maximum (end and row
   are never packed into one integer: ns offsets plus row bits can pass
   63 bits);
3. log-depth pointer jumping for on-path membership and the error fixed
   point: a fixed ⌈log2 N⌉+1 gathers, so parent cycles terminate and are
   flagged `cyclic`, and unresolved parents surface as `ORPHAN`.

`reference_analysis` is the port's own copy of the reference's
pure-Python oracle; `analyze` equals it bit for bit, tiebreaks included.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tempo_tpu_torch.device import resolve_device

# parent_row sentinels
ROOT = -1      # no parent id (all-zero parent span id)
ORPHAN = -2    # parent id set but unresolved within the trace at cut time

_OUT_KEYS = ("parent_row", "on_path", "bc", "ebc", "rc", "cyclic")


def _segment_max(vals: torch.Tensor, seg: torch.Tensor, nseg: int,
                 init: int) -> torch.Tensor:
    out = torch.full((nseg,), init, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, seg, vals, "amax", include_self=True)


def _lex_argmax(ok, seg, nseg: int, end, row) -> torch.Tensor:
    """Per segment, the row maximising (end, row) among `ok` entries, or
    -1 for a segment without one. Entries that are not `ok` go to the
    last segment (the callers' dump segment)."""
    dump = nseg - 1
    seg = torch.where(ok, seg, dump)
    zero = torch.zeros((), dtype=end.dtype, device=end.device)
    me = _segment_max(torch.where(ok, end, zero), seg, nseg, 0)
    ok1 = ok & (end == me[seg])
    seg1 = torch.where(ok1, seg, dump)
    mr = _segment_max(torch.where(ok1, row, -1), seg1, nseg, -1)
    cnt = torch.zeros(nseg, dtype=torch.int32, device=end.device)
    cnt.scatter_add_(0, seg, ok.to(torch.int32))
    return torch.where(cnt > 0, mr, -1)


def _kernel(grp, sid, pid, has_parent, end, err, valid, t_pad: int):
    """The structural analysis of one padded batch on the tensors'
    device: every input [n] (grp int64 with t_pad-1 pads, ids and end
    offsets int64, flags bool). Returns int64 [n] tensors (parent, bc,
    ebc, rc) and bool [n] ones (on_path, cyclic), and anchor [t_pad]."""
    n = grp.shape[0]
    dev = grp.device
    row = torch.arange(n, dtype=torch.int64, device=dev)
    dump_g = t_pad

    # -- 1. parent resolution: sorted-id matching over 2N entries --
    d_grp = torch.where(valid, grp, dump_g)
    q_grp = torch.where(valid & has_parent, grp, dump_g)
    e_grp = torch.cat([d_grp, q_grp])
    e_id = torch.cat([sid, pid])
    order = torch.sort(e_id, stable=True).indices
    order = order[torch.sort(e_grp[order], stable=True).indices]
    s_grp, s_id = e_grp[order], e_id[order]
    s_tag = order >= n                      # True = query entry
    s_row = order - n * s_tag.to(torch.int64)
    pos = torch.arange(2 * n, dtype=torch.int64, device=dev)
    last_pos = torch.cummax(torch.where(s_tag, -1, pos), dim=0).values
    last_def = torch.where(last_pos >= 0,
                           s_row[last_pos.clamp(min=0)], -1)
    c = last_def.clamp(0, n - 1)
    okm = (last_def >= 0) & s_tag & (s_grp < dump_g) \
        & (d_grp[c] == s_grp) & (sid[c] == s_id)
    hp = has_parent[s_row] & valid[s_row]
    qval = torch.where(okm, last_def,
                       torch.where(hp, ORPHAN, ROOT).to(torch.int64))
    parent = torch.full((n + 1,), ROOT, dtype=torch.int64, device=dev)
    parent.scatter_(0, torch.where(s_tag, s_row, n), qval)
    parent = parent[:n]

    # -- 2. lexicographic segment argmax by (end, row) --
    is_child = valid & (parent >= 0)
    bc = _lex_argmax(is_child, parent.clamp(min=0), n + 1, end, row)[:n]
    is_err_child = is_child & err
    ebc = _lex_argmax(is_err_child, parent.clamp(min=0), n + 1, end,
                      row)[:n]
    is_root = valid & (parent == ROOT)
    anchor = _lex_argmax(is_root, grp.clamp(0, t_pad), t_pad + 1, end,
                         row)[:t_pad]

    # -- 3a. on-path membership: AND-prefix over ancestor chains --
    pc = parent.clamp(0, n - 1)
    ga = anchor[grp.clamp(0, t_pad - 1)]
    is_bc = valid & torch.where(parent >= 0, bc[pc] == row,
                                (parent == ROOT) & (ga == row))
    # sentinel node n: a pointer fixed point whose value is True — roots
    # and orphans park there (an orphan's False is_bc kills its subtree)
    ptr = torch.cat([torch.where(valid & (parent >= 0), parent, n),
                     torch.full((1,), n, dtype=torch.int64, device=dev)])
    val = torch.cat([is_bc, torch.ones(1, dtype=torch.bool, device=dev)])
    k_iters = max(1, int(math.ceil(math.log2(max(n, 2)))) + 1)
    for _ in range(k_iters):
        val, ptr = val & val[ptr], ptr[ptr]
    on_path = val[:n] & (ptr[:n] == n) & valid
    cyclic = valid & (ptr[:n] != n)

    # -- 3b. error fixed point: squared composition of the errored-
    # bounding-child step (fixed points absorb; cycles end at the
    # iteration cap and are masked out on the host through `ebc`)
    g = torch.where(ebc >= 0, ebc, row)
    for _ in range(k_iters):
        g = g[g]
    return parent, on_path, bc, ebc, g, cyclic, anchor


def id_limbs(id_mat: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(hi, lo) uint32 limbs of an [n, 8] uint8 id column (the
    reference's layout; the port matches on `_id64` instead)."""
    v = np.ascontiguousarray(id_mat, np.uint8).view(np.uint32)
    return v[:, 0].copy(), v[:, 1].copy()


def _id64(id_mat: np.ndarray) -> np.ndarray:
    """[n, 8] uint8 ids → [n] int64, the same 8 bytes (all-zero → 0)."""
    return np.ascontiguousarray(id_mat, np.uint8).view(np.int64)[:, 0]


def analyze(grp: np.ndarray, span_id: np.ndarray, parent_id: np.ndarray,
            end_ns: np.ndarray, err: np.ndarray, n_traces: int,
            n_pad: int, t_pad: int, device=None) -> dict[str, np.ndarray]:
    """Run the structural analysis over one cut batch on `device` (`cuda`
    unless `"cpu"` is asked for).

    All inputs are length-n host arrays (n real spans); `grp` maps each
    span to its dense trace index in [0, n_traces). `n_pad`/`t_pad` are
    the pow-2 shape buckets. The batch goes up as one int64 matrix and
    the results come back as one; returns host arrays clipped back to n:
    parent_row ([n] int32, ROOT/ORPHAN sentinels), on_path, bounding
    child `bc`, errored bounding child `ebc`, error fixed point `rc`,
    `cyclic`, and the per-trace `anchor` root row ([n_traces] int32).
    """
    n = len(grp)
    if not (0 < n <= n_pad and 0 < n_traces <= t_pad):
        raise ValueError(f"bad pad: n={n}/{n_pad} t={n_traces}/{t_pad}")
    dev = resolve_device(device)
    pid = _id64(parent_id)
    flags = (pid != 0).astype(np.int64) \
        | (np.asarray(err, bool).astype(np.int64) << 1) | 4
    end = np.asarray(end_ns, np.int64)
    host = np.zeros((5, n_pad), np.int64)
    host[0] = t_pad - 1
    host[0, :n] = grp
    host[1, :n] = _id64(span_id)
    host[2, :n] = pid
    host[3, :n] = end - end.min()
    host[4, :n] = flags
    from tempo_tpu_torch.obs.runtime import record_device_put

    record_device_put(int(host.nbytes), "structure")
    x = torch.from_numpy(host).to(dev)
    f = x[4]
    outs = _kernel(x[0], x[1], x[2], (f & 1) != 0, x[3], (f & 2) != 0,
                   (f & 4) != 0, t_pad)
    packed = torch.cat([o.to(torch.int32) for o in outs]).cpu().numpy()
    res = {}
    for i, k in enumerate(_OUT_KEYS):
        col = packed[i * n_pad: i * n_pad + n]
        res[k] = col.astype(bool) if k in ("on_path", "cyclic") else col
    a0 = len(_OUT_KEYS) * n_pad
    res["anchor"] = packed[a0: a0 + n_traces]
    return res


# ---------------------------------------------------------------------------
# pure-Python oracle — the differential-test / smoke spot-check reference
# ---------------------------------------------------------------------------

def reference_analysis(grp, span_id, parent_id, end_ns, err
                       ) -> dict[str, np.ndarray]:
    """Same contract as `analyze`, resolved span by span in plain
    Python. Every tiebreak matches the kernel: duplicate span ids
    resolve to the LARGEST row index; bounding children / anchors
    maximize (end_ns, row); cycles are chains that never terminate at a
    root or orphan; the error root cause descends latest-finishing
    errored children to a fixed point (cyclic error chains surface via
    `ebc[rc] >= 0` — callers mask them exactly like the kernel path)."""
    n = len(grp)
    grp = np.asarray(grp)
    end_ns = np.asarray(end_ns, np.int64)
    err = np.asarray(err, bool)
    sid = [bytes(span_id[i]) for i in range(n)]
    pid = [bytes(parent_id[i]) for i in range(n)]
    defs: dict[tuple[int, bytes], int] = {}
    for i in range(n):                       # last definition wins
        defs[(int(grp[i]), sid[i])] = i
    parent = np.full(n, ROOT, np.int32)
    for i in range(n):
        if pid[i] == b"\0" * 8:
            continue
        j = defs.get((int(grp[i]), pid[i]))
        parent[i] = ORPHAN if j is None else j
    children: dict[int, list[int]] = {}
    for i in range(n):
        if parent[i] >= 0:
            children.setdefault(int(parent[i]), []).append(i)

    def best(rows):
        return max(rows, key=lambda r: (int(end_ns[r]), r)) if rows else -1

    bc = np.full(n, -1, np.int32)
    ebc = np.full(n, -1, np.int32)
    for p, rows in children.items():
        bc[p] = best(rows)
        ebc[p] = best([r for r in rows if err[r]])
    n_traces = int(grp.max()) + 1 if n else 0
    anchor = np.full(n_traces, -1, np.int32)
    for t in range(n_traces):
        anchor[t] = best([i for i in range(n)
                          if int(grp[i]) == t and parent[i] == ROOT])
    on_path = np.zeros(n, bool)
    cyclic = np.zeros(n, bool)
    for i in range(n):
        path_ok, j, steps = True, i, 0
        while True:
            if steps > n:                    # never terminated: cycle
                cyclic[i] = True
                path_ok = False
                break
            if parent[j] == ORPHAN:
                path_ok = False
                break
            if parent[j] == ROOT:
                path_ok = path_ok and anchor[int(grp[j])] == j
                break
            path_ok = path_ok and bc[int(parent[j])] == j
            j = int(parent[j])
            steps += 1
        # every hop must ALSO be its parent's bounding child incl. i
        if path_ok and parent[i] >= 0:
            path_ok = bc[int(parent[i])] == i
        on_path[i] = path_ok
    rc = np.arange(n, dtype=np.int32)
    for i in range(n):
        j, steps = i, 0
        while ebc[j] >= 0 and steps <= n:
            j = int(ebc[j])
            steps += 1
        rc[i] = j
    return {"parent_row": parent, "on_path": on_path, "bc": bc,
            "ebc": ebc, "rc": rc, "cyclic": cyclic, "anchor": anchor}


def self_times_ns(start_ns, end_ns, res: dict) -> np.ndarray:
    """Per-span critical-path self-time (int64 ns, exact): end minus the
    on-path child's end, clamped at 0; an on-path leaf contributes its
    full duration. Zero off the path. Shared by the kernel path and the
    oracle so the decomposition rule lives in exactly one place."""
    start_ns = np.asarray(start_ns, np.int64)
    end_ns = np.asarray(end_ns, np.int64)
    bc = res["bc"]
    on = res["on_path"]
    child_end = np.where(bc >= 0, end_ns[np.clip(bc, 0, len(bc) - 1)],
                         start_ns)
    return np.where(on, np.maximum(end_ns - child_end, 0), 0)


__all__ = ["analyze", "reference_analysis", "self_times_ns", "id_limbs",
           "ROOT", "ORPHAN"]
