"""What one run hands to the result line and to the per-layer readers."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Record:
    end_to_end: dict            # end-to-end metric name -> value
    correct: bool
    attempted: int
    failed: int
    checks: dict                # compared number -> (value, limit)
    memory_peak_bytes: int
    trace: object = None        # core.trace.DeviceTrace of a traced run
    data: dict = dataclasses.field(default_factory=dict)  # reader inputs


def p95(values) -> float | None:
    """The 95th percentile of all values (linear between ranks)."""
    v = np.asarray(values, np.float64)
    return float(np.percentile(v, 95)) if v.size else None


def p50(values) -> float | None:
    v = np.asarray(values, np.float64)
    return float(np.percentile(v, 50)) if v.size else None


def judged(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number against its limit (a number is correct at or below
    it); a number with no limit or no reading fails."""
    checks = {k: (numbers.get(k), limits.get(k))
              for k in sorted(set(numbers) | set(limits))}
    ok = all(v is not None and lim is not None and v <= lim
             for v, lim in checks.values())
    return ok, checks
