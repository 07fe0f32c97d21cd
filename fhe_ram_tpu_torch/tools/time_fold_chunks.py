#!/usr/bin/env python3
"""Time the two launch choices of the kernels built on fold_row
(csrc/fhe_core.cuh) on the GPU.

    python3 fhe_ram_tpu_torch/tools/time_fold_chunks.py

For each (mc, cs) -- output polys per inverse-transform pass, blocks per
row (1, or a thread block cluster of 3 or 6) -- it times, at the shapes of
one read at PARAMS_2_18_TURBO_READOPT: the 12-step trace at B = 4 and a
merge level at nb = 128 ... 4, both as fold_row runs them, in the
predecessors of kernels 3 and 4 (tools/trace_predecessor.cu,
tools/pack_merge_predecessor.cu; kernels 7-11 still run fold_row).  Every
setting's outputs are held bit-equal to the first setting's.  Times are
medians of 9 launches by CUDA events, the L2 cache overwritten before
each.  One JSON line per setting; the first and last settings repeat so
that drift within the run shows.  The thresholds `_ROWS_CLUSTER_6/_3` and
`mc = 3` in ops/ntt_cuda.py were read off this script's output (the fold,
csrc/fold.cu, and the kernels on its body have their own launch shape:
tools/time_fold_predecessor.py, time_merge_ring_predecessors.py and
time_trace_split_predecessors.py time them).
"""

import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import time_merge_ring_predecessors as merge_tool  # noqa: E402
import time_trace_split_predecessors as trace_tool  # noqa: E402

from fhe_ram_tpu_torch.params import PARAMS_2_18_TURBO_READOPT as PAR  # noqa: E402
from fhe_ram_tpu_torch.ops import ntt_cuda  # noqa: E402
from fhe_ram_tpu_torch.ops.ntt import get_ntt_context  # noqa: E402

SETTINGS = ((3, 1), (1, 1), (6, 1), (3, 3), (3, 6), (1, 6), (3, 1), (3, 6))


def main():
    if not torch.cuda.is_available():
        sys.exit("time_fold_chunks: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    n = PAR.n
    ctx = get_ntt_context(n, PAR.primes)
    gen = torch.Generator().manual_seed(0)
    flush = torch.zeros(64 << 20, dtype=torch.int32, device=dev)

    def limbs(shape, bits=16):
        return torch.randint(-(1 << bits), 1 << bits, shape, generator=gen,
                             dtype=torch.int32).to(dev)

    def t_ms(fn, reps=9):
        fn()
        fn()
        ts = []
        for _ in range(reps):
            flush.add_(1)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ts.append(a.elapsed_time(b))
        return statistics.median(ts)

    gals = PAR.trace_gal_els
    keys_tr = ntt_cuda.ntt_fwd_cuda(ctx, limbs((12, 2, 6, n))).permute(
        1, 0, 2, 3, 4).contiguous()
    ct4 = limbs((4, 2, 3, n))
    key_pm = ntt_cuda.ntt_fwd_cuda(ctx, limbs((2, 6, n)))
    pairs = {nb: (limbs((nb, 2, 3, n), 17), limbs((nb, 2, 3, n), 17))
             for nb in (128, 64, 32, 16, 8, 4)}

    ntt_cuda.ensure_built()
    trace_fn = trace_tool.build()["trace"]
    merge_fn = merge_tool.build()["merge"]

    first = {}
    for mc, cs in SETTINGS:
        ntt_cuda.SHAPE_OVERRIDE = (mc, cs)
        # the launch shapes are read when a launch is made
        calls = {"trace": trace_tool.trace_predecessor(trace_fn, ctx, ct4, keys_tr, gals)}
        for nb, (A, B) in pairs.items():
            calls[f"merge{nb}"] = merge_tool.merge_predecessor(merge_fn, ctx, A, B, 32,
                                                               129, key_pm)
        rec = {"mc": mc, "cs": cs}
        for name, fn in calls.items():
            out = fn()
            if name not in first:
                first[name] = out
            elif not torch.equal(first[name], out):
                sys.exit(f"time_fold_chunks: {name} differs at mc={mc} cs={cs}")
            rec[name] = t_ms(fn)
        print(json.dumps(rec), flush=True)
    ntt_cuda.SHAPE_OVERRIDE = None


if __name__ == "__main__":
    main()
