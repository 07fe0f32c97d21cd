"""Statistics over a whole measured window.

A percentile is taken over every sample of the window, by linear
interpolation between the two nearest ranks (numpy's default); a rate is
the work completed over the window's whole length.  An end-to-end metric
name says which statistic it is: `<op>_p<NN>_ms` is the NN-th percentile of
the op's latencies in milliseconds, `<op>s_per_s` the op's completions a
second.
"""

from __future__ import annotations

import re


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) of values, linear between ranks."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: float, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError("a window of no length")
    return count / seconds


_PCT = re.compile(r"^(?P<op>[a-z0-9]+)_p(?P<q>[0-9]{1,2})_ms$")
_RATE = re.compile(r"^(?P<op>[a-z0-9]+)s_per_s$")


def end_to_end(name: str, latencies_ms: dict, counts: dict, window_s: float):
    """The value of end-to-end metric `name` over a window: latencies_ms
    {op: [ms, ...]}, counts {op: completions}.  None where the window has
    no such op."""
    m = _PCT.match(name)
    if m:
        xs = latencies_ms.get(m["op"])
        return percentile(xs, float(m["q"])) if xs else None
    m = _RATE.match(name)
    if m:
        c = counts.get(m["op"])
        return rate(c, window_s) if c else None
    raise ValueError(f"no statistic is named by {name!r}")
