"""Peaks of the card and the least bytes a piece of work must move.

The peak is NVIDIA's data sheet for one H100 SXM at its 700 W limit;
every roofline share is stated against it, with the card's power limit
beside it in the run's output. A share is the least time the work could
take (its bytes over the peak bandwidth) over the device time it took,
so the byte counts here are lower bounds: what any implementation has to
read and write once, counted from the inputs and never from the kernels.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
CELL_BYTES = 4                   # a float32 state cell
SPAN_ROW_BYTES = 16              # a span's slot, seconds, bytes and weight


def share_pct(nbytes: float, device_s: float) -> float | None:
    """Percent of the bandwidth roofline, or None when nothing ran."""
    if device_s <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / device_s


def k1_bytes(labels: np.ndarray, buckets: np.ndarray) -> int:
    """Least bytes of the span-metrics update of one tenant's spans (a
    frozen form of the smoke's `touched_cells` / `bound_bytes` for dense
    state): every span's row read once; every distinct state cell the
    spans add to read once and written once. The cells are a series'
    calls, latency sum, latency count and size (one each a distinct
    series) and its histogram bucket (one a distinct series and bucket).
    The DDSketch cells are left out, since which series own sketch rows
    is the program's state, so the count stays a lower bound."""
    n = int(labels.size)
    if not n:
        return 0
    series = np.unique(labels).size
    cells = np.unique(labels.astype(np.int64) * 64 + buckets).size
    return n * SPAN_ROW_BYTES + 2 * CELL_BYTES * (4 * series + cells)
