#!/usr/bin/env python3
"""Time the trace chain (csrc/trace.cu, kernel 3) and the split level
(csrc/split.cu, kernel 6) against their predecessors on the GPU,
alternately, and the fold (kernel 2), whose device functions both now
share (csrc/fold_body.cuh), at one shape before and after.

    python3 fhe_ram_tpu_torch/tools/time_trace_split_predecessors.py [--reps N]

The predecessors: tools/trace_predecessor.cu and tools/split_predecessor.cu
(fold_row over TraceStepGlue, and split_row, csrc/fhe_core.cuh: radix-2
stages, a residue scratch in device memory; launched as ops/ntt_cuda.py
used to launch them).  At each shape the new kernel, its predecessor and
the plain version give the same integers (checked once); then each is
timed new, old, old, new: medians of --reps launches by CUDA events, the
L2 cache overwritten before each.  Trace shapes, at
PARAMS_2_18_TURBO_READOPT's widths, all twelve steps: B = 4 (a read's
subrams) and B = 64 (a batch of 16), each with the read's key (T = 2,
M = 6) and the untruncated one (T = 3, M = 8), and the VM cycle's byte
repack (vm/cycle.py word_to_ram_bytes: 32 rows, untruncated).  Split
shapes, with the full gadget (T = 3, M = 8): the write's six levels (nb =
4 .. 128, t = 2^l), the batched read-modify-write's last level (nb = 2048,
t = 32) and the widest level of the 2^24 sharded RMW's split tree (a
shard's residue subtree: nb = 2048, t = 2048, half the coefficients
wrap).  The fold: B = 256, T = 4, M = 6, first and last.  One JSON line a
shape; the card's name and power limit first.
"""

import argparse
import ctypes
import json
import statistics
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from time_fold_predecessor import build_tools, card, time_ms  # noqa: E402

from fhe_ram_tpu_torch.ops import ntt_cuda, poly  # noqa: E402
from fhe_ram_tpu_torch.ops.modular import I32  # noqa: E402
from fhe_ram_tpu_torch.ops.ntt import get_ntt_context  # noqa: E402
from fhe_ram_tpu_torch.params import PARAMS_2_18_TURBO_READOPT as PAR  # noqa: E402
from fhe_ram_tpu_torch.params import PARAMS_2_24_READOPT as BPAR  # noqa: E402

NB_RMW = 16      # chip_smoke.py's batch
VM_ROWS = 32     # the VM cycle's byte repack: one row a bit of the word
SHARDS = 4       # chip_smoke.py's rows shards of the 2^24 RMW


def build():
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return build_tools({
        "trace": ("trace_predecessor.cu", "fhe_trace_predecessor",
                  [vp, vp, vp, vp, vp, ci, ntt_cuda._TraceSteps, ci,
                   ntt_cuda._FoldShape, ntt_cuda._Consts, ntt_cuda._Tables, vp], []),
        "split": ("split_predecessor.cu", "fhe_split_predecessor",
                  [vp, vp, vp, vp, vp, ci, ci, ci, ntt_cuda._FoldShape,
                   ntt_cuda._Consts, ntt_cuda._Tables, vp], [])})


def trace_predecessor(fn, ctx, ct, keys, gals):
    """The predecessor launched as ops/ntt_cuda.fused_trace used to."""
    B, C2, L, n = ct.shape
    S, P, T, M, _ = keys.shape
    out, tmp = torch.empty_like(ct), torch.empty_like(ct)
    scratch = torch.empty((B, P, M, n), dtype=I32, device=ct.device)
    steps = ntt_cuda._TraceSteps()
    steps.count = S
    for s, g in enumerate(gals):
        steps.ginv[s] = poly.auto_inverse(n, g)

    def launch():
        sh = ntt_cuda._fold_shape(B, T, M, C2, L, -1, n)
        err = fn(ct.data_ptr(), keys.data_ptr(), out.data_ptr(), tmp.data_ptr(),
                 scratch.data_ptr(), B, steps, T // (C2 - 1), sh, ntt_cuda._consts(ctx),
                 ntt_cuda._tables(ctx, ct.device), ntt_cuda._stream())
        ntt_cuda._check(err, "trace_predecessor")
        return out
    return launch


def split_predecessor(fn, ctx, ct, t_rot, g, key):
    """The predecessor launched as ops/ntt_cuda.fused_split used to."""
    nb, C2, L, n = ct.shape
    P, T, M, _ = key.shape
    out0, out1 = torch.empty_like(ct), torch.empty_like(ct)
    scratch = torch.empty((nb, P, M, n), dtype=I32, device=ct.device)

    def launch():
        sh = ntt_cuda._fold_shape(nb, T, M, C2, L, -1, n)
        err = fn(ct.data_ptr(), key.data_ptr(), out0.data_ptr(), out1.data_ptr(),
                 scratch.data_ptr(), nb, -t_rot % (2 * n), poly.auto_inverse(n, g), sh,
                 ntt_cuda._consts(ctx), ntt_cuda._tables(ctx, ct.device),
                 ntt_cuda._stream())
        ntt_cuda._check(err, "split_predecessor")
        return out0, out1
    return launch


def trace_shapes(limbs, spectra):
    """(note, ct, keys) of every trace shape the tool times."""
    n, W, S = PAR.n, PAR.word_size, PAR.log_n
    C, L, rank = PAR.rank + 1, PAR.limbs_ct, PAR.rank
    keys = {"": spectra((S, rank * PAR.read_ks_trunc[0], C * PAR.read_ks_trunc[1], n)),
            ", untruncated": spectra((S, rank * L, C * PAR.limbs_evk_trace, n))}
    keys = {k: v.permute(1, 0, 2, 3, 4).contiguous() for k, v in keys.items()}
    for B, what in ((W, "a read"), (NB_RMW * W, f"a batch of {NB_RMW}")):
        ct = limbs((B, C, L, n))
        for sfx, k in keys.items():
            yield f"B={B} S={S} T={k.shape[2]} M={k.shape[3]} ({what}{sfx})", ct, k
    yield (f"B={VM_ROWS} S={S} T={rank * L} M={C * PAR.limbs_evk_trace} (the VM "
           "cycle's byte repack, untruncated)", limbs((VM_ROWS, C, L, n)),
           keys[", untruncated"])


def split_shapes(limbs, spectra):
    """(note, ct, t, g, key) of every split shape the tool times."""
    n, W, R = PAR.n, PAR.word_size, PAR.num_rows
    C, L, rank = PAR.rank + 1, PAR.limbs_ct, PAR.rank
    gals = PAR.trace_gal_els
    key = spectra((rank * L, C * PAR.limbs_evk_trace, n))
    levels = (R.bit_length() - 1)
    for l in range(levels):
        yield f"nb={W << l} t={1 << l} (the write's level {l})", limbs((W << l, C, L, n)), \
            1 << l, gals[l], key
    nb = NB_RMW * W << (levels - 1)
    yield (f"nb={nb} t={1 << (levels - 1)} (rmw_batch's last level)",
           limbs((nb, C, L, n)), 1 << (levels - 1), gals[levels - 1], key)
    blv = BPAR.num_rows.bit_length() - 1
    nb = BPAR.word_size * BPAR.num_rows // SHARDS // 2
    yield (f"nb={nb} t={1 << (blv - 1)} (the 2^24 sharded RMW's widest level)",
           limbs((nb, C, L, n)), 1 << (blv - 1), gals[blv - 1], key)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_trace_split_predecessors: no CUDA device")
    print(card(), flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ctx = get_ntt_context(PAR.n, PAR.primes)
    gen = torch.Generator().manual_seed(0)
    flush = torch.zeros(64 << 20, dtype=torch.int32, device=dev)
    ntt_cuda.ensure_built()
    pred = build()
    n = PAR.n

    def limbs(shape, bits=16):
        return torch.randint(-(1 << bits), 1 << bits, shape, generator=gen,
                             dtype=torch.int32).to(dev)

    def spectra(shape):
        return ntt_cuda.ntt_fwd_cuda(ctx, limbs(shape))

    def same(a, b):
        a = a if isinstance(a, (list, tuple)) else [a]
        b = b if isinstance(b, (list, tuple)) else [b]
        return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))

    def compare(kernel, note, calls, rows, T, Lk):
        """One JSON line: new == old == plain, then new, old, old, new."""
        want = calls["new"]()
        with ntt_cuda.plain_versions():
            plain = calls["new"]()
        equal = {"predecessor": same(want, calls["old"]()), "plain": same(want, plain)}
        del plain, want
        cs = ntt_cuda._fold_cs(rows, PAR.rank + 1)
        ms = {k: [] for k in calls}
        for k in ("new", "old", "old", "new"):
            ms[k].append(time_ms(calls[k], args.reps, flush))
        print(json.dumps({
            "kernel": kernel, "shape": note, "equal": equal, "cs": cs,
            "blocks": ntt_cuda._fold_blocks(min(rows, ntt_cuda._MAX_ROW_GROUPS) * cs, T,
                                            max(Lk, 3), dev),
            **{f"{k}_ms": statistics.mean(v) for k, v in ms.items()}, "runs_ms": ms}),
            flush=True)
        return all(equal.values())

    # kernel 2 (csrc/fold.cu on fold_body.cuh) at the read's level 0, first
    # and last: a guard that the store hook left it as it was
    C, L = PAR.rank + 1, PAR.limbs_ct
    T_ep, M_ep = C * PAR.read_ep_trunc[0], C * PAR.read_ep_trunc[1]
    keys_ep = spectra((1, T_ep, M_ep, n)).reshape(3, 1, T_ep, M_ep, n)
    x_ep = limbs((PAR.word_size * PAR.num_rows, T_ep, n))
    fold_ms = []

    def time_fold():
        fold_ms.append(time_ms(lambda: ntt_cuda.fused_external_fold(ctx, x_ep, keys_ep, L, C),
                               args.reps, flush))
    time_fold()

    ok = True
    for note, ct, keys in trace_shapes(limbs, spectra):
        gals = PAR.trace_gal_els[:keys.shape[0]]
        calls = {"new": lambda: ntt_cuda.fused_trace(ctx, ct, keys, gals),
                 "old": trace_predecessor(pred["trace"], ctx, ct, keys, gals)}
        ok = compare("fused_trace", note, calls, ct.shape[0], keys.shape[2],
                     keys.shape[3] // C) and ok
        del calls
    for note, ct, t_rot, g, key in split_shapes(limbs, spectra):
        calls = {"new": lambda: ntt_cuda.fused_split(ctx, ct, t_rot, g, key),
                 "old": split_predecessor(pred["split"], ctx, ct, t_rot, g, key)}
        ok = compare("fused_split", note, calls, ct.shape[0], key.shape[1],
                     key.shape[2] // C) and ok
        del calls, ct

    time_fold()
    print(json.dumps({"kernel": "fused_external_fold",
                      "shape": f"x[{x_ep.shape[0]},{T_ep},4096] keys[3,1,{T_ep},{M_ep},4096]",
                      "new_ms": statistics.mean(fold_ms), "runs_ms": fold_ms}), flush=True)
    if not ok:
        sys.exit("time_trace_split_predecessors: a kernel differs from its "
                 "predecessor or its plain version")


if __name__ == "__main__":
    main()
