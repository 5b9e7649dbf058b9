"""The least-bytes counts behind the roofline shares, on known shapes."""

import numpy as np
import pytest

from portbench.core import roofline


def test_k1_bytes_counts_distinct_cells_once():
    labels = np.array([5, 5, 5, 9])
    buckets = np.array([1, 1, 2, 0])
    # 4 span rows of 16 B; series {5, 9}: 4 cells each; (series, bucket)
    # {(5,1), (5,2), (9,0)}: 3 cells; every cell read and written (8 B)
    assert roofline.k1_bytes(labels, buckets) == 4 * 16 + 8 * (4 * 2 + 3)
    assert roofline.k1_bytes(np.array([], np.int64), np.array([])) == 0


def test_share():
    assert roofline.share_pct(3.35e9, 1.0) == pytest.approx(0.1)
    assert roofline.share_pct(3.35e12, 1.0) == pytest.approx(100.0)
    assert roofline.share_pct(0, 1.0) is None
    assert roofline.share_pct(100, 0.0) is None
