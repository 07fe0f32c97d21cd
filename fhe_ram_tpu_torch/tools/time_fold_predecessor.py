#!/usr/bin/env python3
"""Time the fold kernel (csrc/fold.cu, kernels 2 and 5) against its
predecessor on the GPU, alternately, at every fold shape that
chip_smoke.py's kernel checks hold and at the 2^24 read's level 0.

    python3 fhe_ram_tpu_torch/tools/time_fold_predecessor.py [--reps N]

The predecessor is the fold before its redesign: fold_row over FoldGlue
(tools/fold_predecessor.cu, csrc/fhe_core.cuh), built here twice, with the
radix-2 body and with the two-pass 64 x 64 body (-DFHE_NTT_TWO_PASS), and
launched as ops/ntt_cuda.py used to launch it (one block or a cluster of 3 or 6
a row, a residue scratch in device memory).  At each shape the three give
the same integers (checked once), then each is timed twice in the order
new, radix-2, two-pass, two-pass, radix-2, new: medians of --reps launches
by CUDA events, the L2 cache overwritten before each.  Then the new kernel
at the other launch shapes its wrapper's rules (ntt_cuda._fold_cs,
_fold_blocks) could pick, launched through csrc/fold.cu's entry point
here: clusters of 3 and 6 where the rows are few enough for 6, and both
instantiations (128 registers and two blocks an SM, 255 and one) where two
blocks fit an SM, each timed twice, alternately.  One JSON line a shape;
the card's name and power limit first.
"""

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from fhe_ram_tpu_torch.ops import ntt_cuda  # noqa: E402
from fhe_ram_tpu_torch.ops.modular import I32  # noqa: E402
from fhe_ram_tpu_torch.ops.ntt import get_ntt_context  # noqa: E402
from fhe_ram_tpu_torch.params import PARAMS_2_18_TURBO_READOPT as PAR  # noqa: E402
from fhe_ram_tpu_torch.params import PARAMS_2_24_READOPT as BPAR  # noqa: E402

HERE = Path(__file__).resolve().parent
NB_RMW, NA = 16, 8   # chip_smoke.py's batches
keys_of = {}         # shape note -> (T, Lk)


def build_tools(specs):
    """{key: ctypes function}: for each key, (source in tools/, entry point,
    argtypes, nvcc flags), built into build/ by ops/ntt_cuda.start_build (the
    tag hashes the source, the headers it includes and the flags), every
    nvcc started before the first is awaited."""
    jobs = {key: ntt_cuda.start_build(HERE / src, f"{Path(src).stem}_{key}", flags)
            for key, (src, _, _, flags) in specs.items()}
    fns = {}
    for key, (so, job) in jobs.items():
        src, entry, argtypes, _ = specs[key]
        ntt_cuda.finish_build(f"tools/{src} ({key})", so, job)
        fns[key] = getattr(ctypes.CDLL(str(so)), entry)
        fns[key].argtypes = argtypes
        fns[key].restype = ctypes.c_int
    return fns


def build_predecessor():
    """{body: ctypes function fhe_fold_predecessor}, built into build/."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    args = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ntt_cuda._FoldShape,
            ntt_cuda._Consts, ntt_cuda._Tables, vp]
    return build_tools({
        body: ("fold_predecessor.cu", "fhe_fold_predecessor", args, flags)
        for body, flags in (("radix2", []), ("two_pass", ["-DFHE_NTT_TWO_PASS"]))})


def time_ms(fn, reps, flush):
    """Median of `reps` calls of fn in ms by CUDA events, after one warm
    call; the L2 cache overwritten (flush) before each."""
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


def card():
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def _rows(x, keys, x_is_ntt, batched):
    """(A, B, digits, T, M, n) of a fold call's operands."""
    A = keys.shape[0] if batched else 1
    _, digits, T, M, n = keys.shape[-5:]
    B = x.shape[1] if x_is_ntt else x.shape[-3]
    return A, B, digits, T, M, n


def predecessor_call(fn, ctx, x, keys, out_limbs, c2, base=None, sign=1,
                     x_is_ntt=False, batched=False):
    """The predecessor launched as ops/ntt_cuda.py used to launch it."""
    A, B, digits, T, M, n = _rows(x, keys, x_is_ntt, batched)
    rows = A * B
    out = torch.empty((rows, c2, out_limbs, n), dtype=I32, device=x.device)
    groups = min(rows, ntt_cuda._MAX_ROW_GROUPS)
    scratch = torch.empty((groups, len(ctx.primes), M, n), dtype=I32, device=x.device)
    sh = ntt_cuda._fold_shape(rows, T, M, c2, out_limbs, sign, n)

    def launch():
        err = fn(x.data_ptr(), keys.data_ptr(), None if base is None else base.data_ptr(),
                 out.data_ptr(), scratch.data_ptr(), rows, B, groups, int(x_is_ntt),
                 digits, sh, ntt_cuda._consts(ctx), ntt_cuda._tables(ctx, x.device),
                 ntt_cuda._stream())
        ntt_cuda._check(err, "fold_predecessor")
        return out.reshape((A, B) + out.shape[1:]) if batched else out
    return launch


def new_call_at(cs, blocks, ctx, x, keys, out_limbs, c2, base=None, sign=1,
                x_is_ntt=False, batched=False):
    """The new kernel at cluster width `cs` and instantiation `blocks`,
    launched as ntt_cuda._launch_fold launches it at the ones its rules
    pick (the operands made here are contiguous and 16-byte aligned)."""
    A, B, digits, T, M, n = _rows(x, keys, x_is_ntt, batched)
    rows = A * B
    out = torch.empty((rows, c2, out_limbs, n), dtype=I32, device=x.device)
    clusters = min(rows, ntt_cuda._MAX_ROW_GROUPS)
    sh = ntt_cuda._FoldShape(T, M, M // c2, out_limbs, c2, -1 if sign < 0 else 1, 0, cs)

    def launch():
        err = ntt_cuda._lib("fold").fhe_fold(
            x.data_ptr(), keys.data_ptr(), None if base is None else base.data_ptr(),
            out.data_ptr(), rows, B, clusters, int(x_is_ntt), digits, blocks, sh,
            ntt_cuda._consts(ctx), ntt_cuda._fold_tables(ctx, x.device),
            ntt_cuda._stream())
        ntt_cuda._check(err, "fold")
        return out.reshape((A, B) + out.shape[1:]) if batched else out
    return launch


def shapes(ctx, limbs, dev):
    """(note, rows, c2, new call, predecessor maker, maker of the new kernel
    at a given (cs, blocks)) of every fold shape of chip_smoke.py's kernel
    checks, and the 2^24 read's level 0."""
    n, P = PAR.n, PAR.num_primes
    W, R, C, L, rank = PAR.word_size, PAR.num_rows, PAR.rank + 1, PAR.limbs_ct, PAR.rank
    De, Lge = PAR.read_ep_trunc
    T_ep, M_ep = C * De, C * Lge
    T_ef, M_ef = C * PAR.dnum_ct, C * PAR.limbs_ggsw
    Lg, Lgk, D_ = PAR.limbs_ggsw, PAR.limbs_evk_ggsw, PAR.dnum_ggsw

    def spectra(shape):
        return ntt_cuda.ntt_fwd_cuda(ctx, limbs(shape))

    out = []

    def add(note, rows, c2, call_args, kw=None, batched=False):
        kw = kw or {}
        T_, M_ = call_args[1].shape[-3:-1]
        keys_of[note] = (T_, M_ // c2)
        wrapper = (ntt_cuda.fused_external_fold_batched if batched
                   else ntt_cuda.fused_external_fold)
        out.append((note, rows, c2, lambda: wrapper(ctx, *call_args, **kw),
                    lambda fn: predecessor_call(fn, ctx, *call_args, batched=batched,
                                                **kw),
                    lambda cs, blocks: new_call_at(cs, blocks, ctx, *call_args,
                                                   batched=batched, **kw)))

    keys_ep = spectra((1, T_ep, M_ep, n)).reshape(P, 1, T_ep, M_ep, n)
    x0, base0 = limbs((W * R, T_ep, n)), limbs((W * R, C, L, n), 17)
    add(f"x[{W*R},{T_ep}] (read level 0)", W * R, C, (x0, keys_ep, L, C))
    add(f"x[{W*R},{T_ep}] with base, sign=-1", W * R, C, (x0, keys_ep, L, C),
        dict(base=base0, sign=-1))
    add(f"x[{W},{T_ep}] (level 1)", W, C, (limbs((W, T_ep, n)), keys_ep, L, C))
    keys_ch = spectra((2, C * L, C * Lge, n)).reshape(P, 2, C * L, C * Lge, n)
    xch = limbs((W, C * L, n))
    add(f"x[{W},{C*L}] two chained digits", W, C, (xch, keys_ch, L, C))
    s0 = ntt_cuda.ntt_fwd_cuda(ctx, x0)
    add(f"x_is_ntt x[3,{W*R},{T_ep}]", W * R, C, (s0, keys_ep, L, C), dict(x_is_ntt=True))
    add(f"x_is_ntt x[3,{W},{C*L}] two chained digits", W, C,
        (ntt_cuda.ntt_fwd_cuda(ctx, xch), keys_ch, L, C), dict(x_is_ntt=True))
    keys_ef = spectra((1, T_ef, M_ef, n)).reshape(P, 1, T_ef, M_ef, n)
    for B_ in (W * R, W):
        add(f"x[{B_},{T_ef}] (full gadget)", B_, C, (limbs((B_, T_ef, n)), keys_ef, L, C))
    keys_ak = spectra((1, rank * D_, C * Lgk, n)).reshape(P, 1, rank * D_, C * Lgk, n)
    keys_ts = spectra((1, C * D_, C * Lgk, n)).reshape(P, 1, C * D_, C * Lgk, n)
    for nb in (D_, NB_RMW * D_):
        add(f"x[{nb},{rank*D_}] M={C*Lgk} base, sign=-1 (inversion keyswitch)", nb, C,
            (limbs((nb, rank * D_, n)), keys_ak, Lg, C),
            dict(base=limbs((nb, C, Lg, n), 17), sign=-1))
        add(f"x[{nb},{C*D_}] M={C*Lgk} out_limbs={Lg} (tensor key)", nb, C,
            (limbs((nb, C * D_, n)), keys_ts, Lg, C))
    keys_b = spectra((NA, 1, T_ep, M_ep, n)).permute(1, 0, 2, 3, 4, 5).contiguous()
    add(f"batched x_is_ntt x[3,{W*R},{T_ep}] A={NA} (level 0)", NA * W * R, C,
        (s0, keys_b, L, C), dict(x_is_ntt=True), batched=True)
    xb1 = limbs((NA, W, T_ep, n))
    add(f"batched x[{NA},{W},{T_ep}] (level 1)", NA * W, C, (xb1, keys_b, L, C),
        batched=True)
    add(f"batched x[{NA},{W},{T_ep}] with base, sign=-1", NA * W, C, (xb1, keys_b, L, C),
        dict(base=limbs((NA, W, C, L, n), 17), sign=-1), batched=True)
    keys_bf = spectra((NB_RMW, 1, T_ef, M_ef, n)).permute(1, 0, 2, 3, 4, 5).contiguous()
    add(f"batched x_is_ntt x[3,{W*R},{T_ef}] A={NB_RMW} (rmw_batch level 0)",
        NB_RMW * W * R, C, (ntt_cuda.ntt_fwd_cuda(ctx, limbs((W * R, T_ef, n))), keys_bf,
                            L, C), dict(x_is_ntt=True), batched=True)
    add(f"batched x[{NB_RMW},{W},{T_ef}] (rmw_batch level 1, d_lo)", NB_RMW * W, C,
        (limbs((NB_RMW, W, T_ef, n)), keys_bf, L, C), batched=True)
    add(f"batched x[{NB_RMW},{W*R},{T_ef}] (rmw_batch upd)", NB_RMW * W * R, C,
        (limbs((NB_RMW, W * R, T_ef, n)), keys_bf, L, C), batched=True)
    BR = BPAR.num_rows * BPAR.word_size
    xbig = torch.randint(-(1 << 16), 1 << 16, (BR, T_ep, n), dtype=torch.int32,
                         device=dev, generator=torch.Generator(device=dev).manual_seed(2))
    add(f"x[{BR},{T_ep}] (2^24 read level 0)", BR, C, (xbig, keys_ep, L, C))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_fold_predecessor: no CUDA device")
    print(card(), flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ctx = get_ntt_context(PAR.n, PAR.primes)
    gen = torch.Generator().manual_seed(0)
    flush = torch.zeros(64 << 20, dtype=torch.int32, device=dev)
    ntt_cuda.ensure_built()
    pred = build_predecessor()

    def limbs(shape, bits=16):
        return torch.randint(-(1 << bits), 1 << bits, shape, generator=gen,
                             dtype=torch.int32).to(dev)

    def t_ms(fn):
        return time_ms(fn, args.reps, flush)

    for note, rows, c2, new, make_pred, make_new_at in shapes(ctx, limbs, dev):
        calls = {"new": new, "radix2": make_pred(pred["radix2"]),
                 "two_pass": make_pred(pred["two_pass"])}
        want = calls["new"]()
        equal = {k: bool(torch.equal(want, f())) for k, f in calls.items() if k != "new"}
        torch.cuda.synchronize()
        ms = {k: [] for k in calls}
        for k in ("new", "radix2", "two_pass", "two_pass", "radix2", "new"):
            ms[k].append(t_ms(calls[k]))
        cs = ntt_cuda._fold_cs(rows, c2)
        T, Lk = keys_of[note]
        blocks = ntt_cuda._fold_blocks(min(rows, ntt_cuda._MAX_ROW_GROUPS) * cs, T, Lk, dev)
        rec = {"shape": note, "rows": rows, "cs": cs, "blocks": blocks,
               "equal_to_predecessor": equal,
               **{f"{k}_ms": statistics.mean(v) for k, v in ms.items()},
               "runs_ms": ms}
        # the other launch shapes the wrapper could have picked
        others = {(cs, blocks)}
        if rows <= ntt_cuda._FOLD_ROWS_6 and c2 % 2 == 0:
            others |= {(3, blocks), (6, blocks)}
        if 2 * ((T + Lk) * 4 * PAR.n + 1024) <= ntt_cuda._SM_SMEM:
            others |= {(cs, 1), (cs, 2)}
        if len(others) > 1:
            at = {o: make_new_at(*o) for o in sorted(others)}
            by = {o: [] for o in at}
            for o in list(at) + list(at)[::-1]:
                if not torch.equal(want, at[o]()):
                    sys.exit(f"time_fold_predecessor: {note} differs at {o}")
                by[o].append(t_ms(at[o]))
            rec["new_ms_by_cs_blocks"] = {f"cs={a},blocks={b}": v for (a, b), v in by.items()}
        print(json.dumps(rec), flush=True)
        del calls, want
        if not all(equal.values()):
            sys.exit(f"time_fold_predecessor: {note}: the predecessor differs")


if __name__ == "__main__":
    main()
