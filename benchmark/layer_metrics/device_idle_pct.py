"""device_idle_pct.<op>: the share of the traced stretch that no device
interval (kernel, copy, set) of the profiler trace covers.  Layer: device."""


def read(r):
    if r.trace is None or not r.is_cuda:
        return None
    busy, window = r.trace.busy_s, r.trace.window_s
    if busy <= 0 or window <= 0:
        return None
    return 100.0 * (1.0 - busy / window)
