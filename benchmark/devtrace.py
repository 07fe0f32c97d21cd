"""A bounded stretch of server calls under torch.profiler, and what its
trace says: the device intervals, the device's busy time, the port's kernel
launches by name, the longest idle gaps by what the host was doing.

The trace is exported as a Chrome trace into a temporary file (under
TMPDIR), read and deleted.  Kernel names are reduced to the bare function
name ("void fold_kernel<2>(int const*, ...)" -> "fold_kernel").
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile

# The port's own kernels (the __global__ functions of its csrc/): the launch
# check counts these in the trace against the program's launch counters.
PORT_KERNELS = frozenset((
    "ntt_fwd_kernel", "ntt_inv_kernel", "fold_kernel", "external_kernel",
    "trace_kernel", "pack_merge_kernel", "split_kernel", "split_tree_kernel",
    "pack_tree_kernel", "blind_rotate_kernel", "dp_chain_kernel", "bitwise_kernel",
    "ring_all_gather_kernel", "exchange_kernel"))

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "python_function", "cuda_runtime",
             "cuda_driver")
STRETCH = "bench_stretch"


def bare_name(name: str) -> str:
    """The function name of a demangled kernel signature."""
    s = name.strip().replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    s = re.split(r"[<(]", s, maxsplit=1)[0].strip()
    return s.rsplit("::", 1)[-1] if s else name.strip()[:80]


class Trace:
    """The events of one traced stretch, in microseconds of one clock."""

    def __init__(self, events):
        marks = [e for e in events if e.get("name") == STRETCH
                 and e.get("cat") == "user_annotation"]
        if not marks:
            raise ValueError("the trace holds no stretch annotation")
        m = marks[0]
        self.t0 = float(m["ts"])
        self.t1 = self.t0 + float(m["dur"])
        self.device = []   # (start, end, bare name, cat)
        self.host = []     # (start, end, name)
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a, d = float(e["ts"]), float(e["dur"])
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                if a < self.t1 and a + d > self.t0:
                    self.device.append((max(a, self.t0), min(a + d, self.t1),
                                        bare_name(e.get("name", "")), cat))
            elif cat in HOST_CATS and e.get("name") != STRETCH:
                if a < self.t1 and a + d > self.t0:
                    self.host.append((a, a + d, e.get("name", "")))
        self.device.sort()

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self):
        """The union of the device intervals, merged."""
        out = []
        for a, b, _, _ in self.device:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def kernel_seconds(self, names) -> float:
        """Device seconds of the kernels named (bare names)."""
        return sum(b - a for a, b, n, c in self.device if c == "kernel" and n in names) * 1e-6

    def port_launches(self) -> int:
        return sum(1 for _, _, n, c in self.device if c == "kernel" and n in PORT_KERNELS)

    def device_ops(self, top: int = 10):
        """[name, seconds] of the device operations that took most time."""
        acc = {}
        for a, b, n, _ in self.device:
            acc[n] = acc.get(n, 0.0) + (b - a) * 1e-6
        return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10):
        """[what the host was doing, seconds] over the device's idle gaps
        in the stretch (the 2000 longest): each gap named by the innermost
        host operation at its middle (runtime calls only where no operation
        covers it), the seconds summed by name."""
        gaps, t = [], self.t0
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            gaps.append((t, self.t1))
        acc = {}
        if gaps:
            import numpy as np

            sem = [h for h in self.host if not h[2].startswith(("cuda", "cu"))] or self.host
            hs = np.array([h[0] for h in sem] or [0.0])
            he = np.array([h[1] for h in sem] or [-1.0])
            for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:2000]:
                mid = 0.5 * (a + b)
                hit = np.nonzero((hs <= mid) & (he >= mid))[0]
                name = (sem[hit[np.argmin(he[hit] - hs[hit])]][2] if hit.size
                        else "host: outside any traced call")
                acc[name] = acc.get(name, 0.0) + (b - a) * 1e-6
        return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:top]]


@contextlib.contextmanager
def profiled(device_is_cuda: bool, sync):
    """Profile the body as one stretch; yields a holder whose `trace` is set
    once the body has run (its last device work synchronized inside)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device_is_cuda else [])
    holder = type("TraceHolder", (), {"trace": None})()
    with profile(activities=acts) as prof:
        with record_function(STRETCH):
            yield holder
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    holder.trace = Trace(events)
