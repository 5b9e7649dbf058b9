"""The device trace of a `--trace 1` run, and the harness's host spans.

`torch.profiler` (CUPTI) records every device operation in a slice of
the measured window, at most `TRACE_SECONDS` long and centred in it, so
that reading the trace stays well inside a run's time. Only device
activity is recorded: host operations of every thread would cost the
run more to record and to read than the window lasts. The harness's
threads record their own spans (`HostSpans`) around each call into the
program on the host's monotonic clock; a short marker kernel launched
on an idle card at each end of the slice maps that clock onto the
trace's. An idle gap on the device is shared equally among the harness
spans that cover its middle, one a client thread.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

TRACE_SECONDS = 8.0
MARK = "spin_kernel"             # torch.cuda._sleep's kernel


class HostSpans:
    """(start ns, end ns, name) of the harness's calls into the program,
    on `time.perf_counter_ns`; records only while `on`."""

    def __init__(self, on: bool) -> None:
        self.on = on
        self.items: list = []

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        a = time.perf_counter_ns()
        try:
            yield
        finally:
            self.items.append((a, time.perf_counter_ns(), name))


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{what}_us")() * 1000)


def _merge(iv: list) -> list:
    iv.sort()
    out = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class DeviceTrace:
    """Profiles the device from `start()` to `stop()`; then `busy_s`,
    `window_s`, `ops` ({name: device seconds}), `gaps` ({host span: idle
    seconds}) and `device_s(prefixes)`."""

    def __init__(self, spans: HostSpans | None = None) -> None:
        self.spans = spans
        self.marks: list = []
        self.prof = None
        self.busy_s = self.window_s = 0.0
        self.ops: dict = {}
        self.gaps: dict = {}
        self.t_start = self.t_stop = 0.0
        self.cost_s: dict = {}

    def warm(self) -> None:
        """Profile one small operation, so that the tracer's own start-up
        (CUPTI's, seconds long the first time) is part of set-up."""
        import torch

        self.start()
        torch.ones(1, device="cuda").add_(1)
        self.stop()
        self.ops, self.gaps, self.marks = {}, {}, []

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.t_start = time.perf_counter()
        self._mark()

    def _mark(self) -> None:
        """A marker kernel on the idle card, and the host time of its
        launch."""
        import torch

        torch.cuda.synchronize()
        self.marks.append(time.perf_counter_ns())
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self._mark()
        self.t_stop = time.perf_counter()
        self.prof.stop()
        t1 = time.perf_counter()
        self._read()
        self.cost_s.update(stop=t1 - self.t_stop,
                           read=time.perf_counter() - t1)
        self.prof = None

    def _read(self) -> None:
        from torch.autograd import DeviceType

        dev, marks = [], []
        for ev in self.prof.profiler.kineto_results.events():
            a = _ns(ev, "start")
            b = a + _ns(ev, "duration")
            if ev.device_type() != DeviceType.CUDA:
                continue
            if MARK in ev.name():
                marks.append(a)
            else:
                dev.append((a, b, ev.name()))
        self.window_s = self.t_stop - self.t_start
        self.cost_s["events"] = len(dev)
        for a, b, name in dev:
            self.ops[name] = self.ops.get(name, 0.0) + (b - a) / 1e9
        busy = _merge([[a, b] for a, b, _ in dev])
        self.busy_s = sum(b - a for a, b in busy) / 1e9
        if len(marks) != 2:
            self.gaps["trace marks missing"] = self.window_s - self.busy_s
            return
        # the host clock on the trace's: the mean offset of the two marks
        marks.sort()
        shift = (marks[0] - self.marks[0] + marks[1] - self.marks[1]) // 2
        lo, hi = marks
        edges = [lo] + [min(max(x, lo), hi) for iv in busy for x in iv] + [hi]
        gaps = np.array([(a, b) for a, b in zip(edges[0::2], edges[1::2])
                         if b > a], np.int64).reshape(-1, 2)
        items = self.spans.items if self.spans is not None else []
        hs = np.array([(a + shift, b + shift) for a, b, _ in items],
                      np.int64).reshape(-1, 2)
        names = sorted({n for _, _, n in items})
        code = np.array([names.index(n) for _, _, n in items], np.int64)
        names.append("no harness span")
        mids = gaps.sum(1) // 2
        length = (gaps[:, 1] - gaps[:, 0]) / 1e9
        idle = np.zeros(len(names))
        for i in range(0, mids.size, 2048):
            m = mids[i:i + 2048, None]
            ln = length[i:i + 2048]
            cover = (hs[None, :, 0] <= m) & (m < hs[None, :, 1])
            k = cover.sum(1)
            share = np.where(k > 0, ln / np.maximum(k, 1), 0.0)
            rows, cols = np.nonzero(cover)
            idle += np.bincount(code[cols], weights=share[rows],
                                minlength=len(names))
            idle[-1] += float(ln[k == 0].sum())
        for j in np.flatnonzero(idle).tolist():
            self.gaps[names[j]] = self.gaps.get(names[j], 0.0) + float(idle[j])

    def device_s(self, prefixes: tuple) -> float:
        """Device seconds of the operations whose (possibly mangled) names
        hold any of `prefixes`."""
        return sum(t for n, t in self.ops.items()
                   if any(p in n for p in prefixes))

    def breakdown(self) -> dict:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1])[:10]
        top = [(n if len(n) <= 160 else n[:157] + "...", t) for n, t in top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, t] for n, t in top],
                "idle_gaps": [[n, t] for n, t in gaps]}


def traced_slice(seconds: float) -> tuple[float, float]:
    """(offset, length) of the traced slice inside a window."""
    length = min(TRACE_SECONDS, seconds)
    return (seconds - length) / 2.0, length
