"""The window's statistics: percentiles and rates over every sample."""

import numpy as np
import pytest

from benchmark import stats


@pytest.mark.parametrize("q", [0, 5, 50, 95, 99, 100])
def test_percentile_is_numpys_linear(q):
    xs = np.random.default_rng(q).exponential(3.0, size=1001)
    assert stats.percentile(list(xs), q) == pytest.approx(np.percentile(xs, q), rel=1e-12)


def test_percentile_takes_the_whole_window():
    # a tail of 6 slow samples in 100 moves the 95th percentile, not the median
    xs = [1.0] * 94 + [10.0] * 6
    assert stats.percentile(xs, 50) == 1.0
    assert stats.percentile(xs, 95) == pytest.approx(10.0)


def test_rate_and_names():
    lat = {"read": [2.0, 4.0, 6.0]}
    counts = {"read": 3 * 64}
    assert stats.end_to_end("read_p50_ms", lat, counts, 2.0) == 4.0
    assert stats.end_to_end("reads_per_s", lat, counts, 2.0) == 96.0
    assert stats.end_to_end("rmw_p95_ms", lat, counts, 2.0) is None
    with pytest.raises(ValueError):
        stats.end_to_end("read_mean", lat, counts, 2.0)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)
