"""The program's own spans in a traced run: where a push's host time goes,
and the device's idle gaps split among the spans open across them.

The port records spans in memory under `tempo_tpu_torch.utils.tracing.
SpanRecorder`. Each carries `name`, `span_id`, `parent_span_id`, its
`thread`, its start and end on `time.perf_counter_ns()` (`t0_ns`,
`t1_ns`), the clock that `core/trace.py`'s marker kernels map onto the
device trace, and its thread's CPU nanoseconds over it (`cpu_ns`). The
functions here read any objects with those attributes.

`split_idle` shares each idle gap by overlap, not by its middle: at each
instant the idle time is shared equally among the threads that have a
span open, and each thread's share goes to its innermost open span.
Harness spans (`core/trace.HostSpans` items, which carry no thread) are
the outermost level of the thread whose program span starts first inside
them, or a thread of their own when none does. Idle time with no span
open on any thread is `no harness span`, as in `core/trace.py`.
"""

from __future__ import annotations

import numpy as np

NO_SPAN = "no harness span"


def summary(spans) -> dict:
    """{name: {"count", "wall_s", "cpu_s", "self_s"}}: wall and thread CPU
    seconds summed over the spans of each name, and self time, the wall
    less what the span's direct children on its own thread cover."""
    child_ns: dict = {}
    for s in spans:
        child_ns.setdefault((s.parent_span_id, s.thread), 0)
        child_ns[(s.parent_span_id, s.thread)] += s.t1_ns - s.t0_ns
    out: dict = {}
    for s in spans:
        wall = s.t1_ns - s.t0_ns
        row = out.setdefault(s.name, {"count": 0, "wall_s": 0.0,
                                      "cpu_s": 0.0, "self_s": 0.0})
        row["count"] += 1
        row["wall_s"] += wall / 1e9
        row["cpu_s"] += s.cpu_ns / 1e9
        row["self_s"] += max(wall - child_ns.get((s.span_id, s.thread), 0),
                             0) / 1e9
    return out


def child_share(spans, name: str) -> float | None:
    """The share of the wall of the spans named `name` that their direct
    children cover, or None without such a span."""
    roots = {s.span_id: s for s in spans if s.name == name}
    wall = sum(s.t1_ns - s.t0_ns for s in roots.values())
    if not wall:
        return None
    covered = sum(s.t1_ns - s.t0_ns for s in spans
                  if s.parent_span_id in roots
                  and s.thread == roots[s.parent_span_id].thread)
    return covered / wall


def _idle_before(gaps: np.ndarray):
    """t -> idle nanoseconds in the gaps before t (gaps sorted, disjoint)."""
    starts = gaps[:, 0]
    lengths = gaps[:, 1] - gaps[:, 0]
    before = np.concatenate([[0], np.cumsum(lengths)])

    def idle(t: np.ndarray) -> np.ndarray:
        if not len(starts):
            return np.zeros(len(t), np.int64)
        k = np.searchsorted(starts, t, side="right") - 1
        j = np.maximum(k, 0)
        return np.where(k >= 0, before[j] + np.minimum(t - starts[j],
                                                       lengths[j]), 0)
    return idle


def gaps_of(busy, lo: int, hi: int) -> np.ndarray:
    """The idle gaps [a, b) of [lo, hi] around merged, sorted busy
    intervals."""
    edges = [lo] + [min(max(x, lo), hi) for iv in busy for x in iv] + [hi]
    return np.array([(a, b) for a, b in zip(edges[0::2], edges[1::2])
                     if b > a], np.int64).reshape(-1, 2)


def split_idle(busy, lo: int, hi: int, shift: int, spans,
               harness=()) -> dict:
    """{span name: idle seconds} of the device between `lo` and `hi`
    (device clock, ns) outside the merged `busy` intervals, shared by
    overlap among the program `spans` and the `harness` items
    ((start, end, name) on the host clock); `shift` takes the host clock
    onto the device's."""
    idle = _idle_before(gaps_of(busy, lo, hi))
    prog = sorted(spans, key=lambda s: s.t0_ns)
    starts = np.array([s.t0_ns for s in prog], np.int64)
    items = []       # (start, end, thread, level, name) on the device clock
    for k, (a, b, name) in enumerate(harness):
        i = int(np.searchsorted(starts, a, side="left"))
        inside = i < len(prog) and prog[i].t0_ns < b
        items.append((a + shift, b + shift,
                      prog[i].thread if inside else ("harness", k), 0, name))
    items += [(s.t0_ns + shift, s.t1_ns + shift, s.thread, 1, s.name)
              for s in prog]
    events = []      # ends before starts at one instant; outer spans first
    for k, (a, b, _th, level, _n) in enumerate(items):
        a, b = max(a, lo), min(b, hi)
        if b > a:
            events.append((a, 1, level, -b, k))
            events.append((b, 0, 0, 0, k))
    events.sort()
    times = np.array([lo] + [e[0] for e in events] + [hi], np.int64)
    between = np.diff(idle(times))
    out: dict = {}
    open_: dict = {}       # thread -> its open items, innermost last
    for j, (_t, start, _lvl, _b, k) in enumerate([(lo, 0, 0, 0, -1)]
                                                 + events):
        if k >= 0:
            th = items[k][2]
            if start:
                open_.setdefault(th, []).append(k)
            else:
                open_[th].remove(k)
                if not open_[th]:
                    del open_[th]
        ns = int(between[j])
        if not ns:
            continue
        if not open_:
            out[NO_SPAN] = out.get(NO_SPAN, 0.0) + ns / 1e9
            continue
        share = ns / len(open_) / 1e9
        for ks in open_.values():
            name = items[ks[-1]][4]
            out[name] = out.get(name, 0.0) + share
    return out


def top(split: dict, n: int = 10) -> list:
    """The `n` names with the most idle time, as [name, seconds] pairs."""
    return [[k, v] for k, v in sorted(split.items(), key=lambda kv: -kv[1])
            [:n]]
