"""Timing + noise telemetry.

PyTorch returns from a call before the GPU has finished it, so a host
clock alone times the enqueue: `synced_time` synchronizes the device
around every timed call.  For a breakdown by kernel use `trace_to`
(torch.profiler).
"""

from __future__ import annotations

import contextlib
import time

import torch


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def synced_time(fn, *args, repeats: int = 3):
    """min wall time in seconds of fn(*args), the device synchronized
    before the clock starts and before it stops (one warm-up call first)."""
    fn(*args)
    _sync()
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        ts.append(time.perf_counter() - t0)
    return min(ts)


@contextlib.contextmanager
def trace_to(logdir: str):
    """torch.profiler trace context: host and (where there is one) device
    activity, written to `logdir` as a TensorBoard-compatible Chrome trace
    when the context ends.  Yields the profiler (key_averages() etc.)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof
        _sync()


def noise_report(params, ctx, s_ntt, ct, want: int):
    """Telemetry for one result ciphertext: decoded value + log2 noise."""
    from ..core import glwe

    ph = glwe.phase(params, ctx, s_ntt, ct)
    val, noise = glwe.decode_coeff0(params, ph, want)
    return {"value": int(val), "noise_log2": float(noise),
            "budget_log2": float(-(params.k_pt + 1) - noise)}
