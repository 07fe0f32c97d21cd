"""utils/profiling.synced_time: one warm-up call, then `repeats` timed
ones, and the least of their times.

One test a file on purpose: with `--dist loadfile` pytest-xdist hands files
out in order of their test count, so single-test files go last; a row of
millisecond files before the suite's longest single test lets it start on
a worker that is really free (ROADMAP.md, "Time budget")."""

import time

from fhe_ram_tpu_torch.utils import profiling


def test_synced_time_warms_up_once_and_returns_the_least_time():
    calls = []

    def work(x, y):
        calls.append((x, y))
        if len(calls) == 2:      # the first timed call is the slow one
            time.sleep(0.02)

    secs = profiling.synced_time(work, 1, 2, repeats=3)
    assert calls == [(1, 2)] * 4
    assert 0.0 <= secs < 0.02
