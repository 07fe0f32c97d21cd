#!/usr/bin/env python3
"""Time the blind rotation (csrc/blind_rotate.cu, kernel 10) and the
carry-DP chain (csrc/dp_chain.cu, kernel 11) against their predecessors
on the GPU, alternately, and the four kernels that share their device
functions (csrc/fold_body.cuh: the fold, the merge, the trace, the split)
at one shape each, first and last.

    python3 fhe_ram_tpu_torch/tools/time_chain_predecessors.py [--reps N]

The predecessors: tools/blind_rotate_predecessor.cu and
tools/dp_chain_predecessor.cu (fold_row over RotateCmuxGlue, and over
DpLeafGlue and CmuxGlue in UnitSlot groups, csrc/fhe_core.cuh: radix-2
stages, a residue scratch in device memory; launched as ops/ntt_cuda.py
used to launch them).  The shapes are those the VM cycle gives the two
kernels at PARAMS_2_18_READOPT (chip_smoke.vm_shapes): kernel 10 at
select_rd, select_store and the pointer conversion's two digits, kernel 11
at the RV32I enum's 7 carry ops, and at one op (G = 1).  At each shape
the new kernel, its predecessor and the plain version give the same
integers (checked once); then each is timed new, old, old, new: medians of
--reps launches by CUDA events, the L2 cache overwritten before each.
Then kernel 11's other layouts at G = 7 (clusters of 6 and of 3 blocks,
the 128- and the 255-register instantiation), each bit-equal to the
wrapper's choice and timed twice, in the order given and back.  One JSON
line a shape; the card's name and power limit first.
"""

import argparse
import ctypes
import json
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from time_fold_predecessor import card, time_ms  # noqa: E402

from chip_smoke import vm_shapes  # noqa: E402
from fhe_ram_tpu_torch.ops import ntt_cuda  # noqa: E402
from fhe_ram_tpu_torch.ops.modular import I32  # noqa: E402
from fhe_ram_tpu_torch.ops.ntt import get_ntt_context  # noqa: E402
from fhe_ram_tpu_torch.params import PARAMS_2_18_READOPT as VPAR  # noqa: E402
from fhe_ram_tpu_torch.params import PARAMS_2_18_TURBO_READOPT as PAR  # noqa: E402

HERE = Path(__file__).resolve().parent
DP_LAYOUTS = ((6, 2), (6, 1), (3, 2), (3, 1))   # (blocks a cluster, instantiation)


def guard_calls(limbs):
    """{name and shape: call} of the four kernels on fold_body.cuh that the
    chains do not run, one shape each (the read's level-0 fold, the read's
    widest merge level, the read's trace, the write's last split level),
    on random limbs(shape) at PARAMS_2_18_TURBO_READOPT: timed first and
    last beside kernels that share their device functions."""
    ctx = get_ntt_context(PAR.n, PAR.primes)
    n, C, L, rank = PAR.n, PAR.rank + 1, PAR.limbs_ct, PAR.rank
    W, R = PAR.word_size, PAR.num_rows

    def spectra(shape):
        return ntt_cuda.ntt_fwd_cuda(ctx, limbs(shape))

    T_ep, M_ep = C * PAR.read_ep_trunc[0], C * PAR.read_ep_trunc[1]
    T_ks, M_ks = rank * PAR.read_ks_trunc[0], C * PAR.read_ks_trunc[1]
    T_kf, M_kf = rank * L, C * PAR.limbs_evk_trace
    keys_ep = spectra((1, T_ep, M_ep, n)).reshape(3, 1, T_ep, M_ep, n)
    key_ks = spectra((T_ks, M_ks, n))
    keys_tr = spectra((PAR.log_n, T_ks, M_ks, n)).permute(1, 0, 2, 3, 4).contiguous()
    key_kf = spectra((T_kf, M_kf, n))
    x_ep = limbs((W * R, T_ep, n))
    A_m, B_m = limbs((W * R // 2, C, L, n)), limbs((W * R // 2, C, L, n))
    ct_tr, ct_sp = limbs((W, C, L, n)), limbs((W * R // 2, C, L, n))
    lv = R.bit_length() - 2
    return {
        f"fused_external_fold x[{W * R},{T_ep},4096] keys[3,1,{T_ep},{M_ep},4096]":
            lambda: ntt_cuda.fused_external_fold(ctx, x_ep, keys_ep, L, C),
        f"fused_pack_merge nb={W * R // 2} T={T_ks} M={M_ks}":
            lambda: ntt_cuda.fused_pack_merge(ctx, A_m, B_m, 1, n + 1, key_ks),
        f"fused_trace B={W} S={PAR.log_n} T={T_ks} M={M_ks}":
            lambda: ntt_cuda.fused_trace(ctx, ct_tr, keys_tr, PAR.trace_gal_els),
        f"fused_split nb={W * R // 2} t={1 << lv} T={T_kf} M={M_kf}":
            lambda: ntt_cuda.fused_split(ctx, ct_sp, 1 << lv, PAR.trace_gal_els[lv], key_kf)}


def build():
    """{name: ctypes library} of the two predecessors, built into build/."""
    vp, ci, cip = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    srcs = {"rotate": "blind_rotate_predecessor.cu", "dp": "dp_chain_predecessor.cu"}
    jobs = {k: ntt_cuda.start_build(HERE / src, Path(src).stem) for k, src in srcs.items()}
    libs = {}
    for k, (so, job) in jobs.items():
        ntt_cuda.finish_build(f"tools/{srcs[k]}", so, job)
        libs[k] = ctypes.CDLL(str(so))
    sigs = {("rotate", "fhe_blind_rotate_predecessor"):
            [vp, vp, vp, vp, vp, ci, ci, ntt_cuda._RotSteps, ci, ntt_cuda._FoldShape,
             ntt_cuda._Consts, ntt_cuda._Tables, vp],
            ("dp", "fhe_dp_chain_predecessor_blocks"): [ntt_cuda._FoldShape, ci, cip],
            ("dp", "fhe_dp_chain_predecessor"):
            [vp, vp, vp, vp, vp, vp, vp, ci, ntt_cuda._DpTables, ci, ci, ci,
             ntt_cuda._FoldShape, ntt_cuda._Consts, ntt_cuda._Tables, vp]}
    for (k, fn), argtypes in sigs.items():
        getattr(libs[k], fn).argtypes = argtypes
        getattr(libs[k], fn).restype = ci
    return libs


def rotate_predecessor(lib, ctx, rows, keys, amounts):
    """The predecessor launched as ops/ntt_cuda.fused_blind_rotate used to."""
    B, C2, L, n = rows.shape
    S, P, T, M, _ = keys.shape
    out, tmp = torch.empty_like(rows), torch.empty_like(rows)
    groups = min(B, ntt_cuda._MAX_ROW_GROUPS)
    scratch = torch.empty((groups, P, M, n), dtype=I32, device=rows.device)
    steps = ntt_cuda._RotSteps()
    steps.count = S
    for s, t in enumerate(amounts):
        steps.rot[s] = int(t) % (2 * n)

    def launch():
        sh = ntt_cuda._fold_shape(B, T, M, C2, L, 1, n)
        err = lib.fhe_blind_rotate_predecessor(
            rows.data_ptr(), keys.data_ptr(), out.data_ptr(), tmp.data_ptr(),
            scratch.data_ptr(), B, groups, steps, T // C2, sh, ntt_cuda._consts(ctx),
            ntt_cuda._tables(ctx, rows.device), ntt_cuda._stream())
        ntt_cuda._check(err, "blind_rotate_predecessor")
        return out
    return launch


def dp_predecessor(lib, ctx, F0, keys, deltas, op_tables, groups):
    """The predecessor launched as ops/ntt_cuda.fused_dp_chain used to: a
    cooperative launch of as many UnitSlot groups as the card holds."""
    G, _, C2, L, n = F0.shape
    bits, NG1, P, T, M, _ = keys.shape
    tab = ntt_cuda._dp_tables(op_tables, ntt_cuda._op_groups(groups, G))
    mc = max(1, min(3, M, ntt_cuda._MAX_SMEM // (4 * n) - T))
    sh = ntt_cuda._FoldShape(T, M, M // C2, L, C2, 1, mc, 1)
    resident = ctypes.c_int(0)
    ntt_cuda._check(lib.fhe_dp_chain_predecessor_blocks(sh, ctx.log_n,
                                                        ctypes.byref(resident)),
                    "the predecessor's occupancy query")
    cs = next(c for c in (ntt_cuda._row_blocks(4 * G, M), 3, 1) if 4 * c <= resident.value)
    units = min(G, resident.value // (4 * cs))
    sh.cs = cs
    blocks = units * 4 * cs
    out = torch.empty_like(F0)
    inner = torch.empty((G, 4, C2, L, n), dtype=I32, device=F0.device)
    scratch = torch.empty((blocks // cs, P, M, n), dtype=I32, device=F0.device)

    def launch():
        arrived = torch.zeros((units, 5), dtype=I32, device=F0.device)
        err = lib.fhe_dp_chain_predecessor(
            F0.data_ptr(), keys.data_ptr(), deltas.data_ptr(), out.data_ptr(),
            inner.data_ptr(), scratch.data_ptr(), arrived.data_ptr(), blocks, tab, bits,
            NG1 - 1, T // C2, sh, ntt_cuda._consts(ctx), ntt_cuda._tables(ctx, F0.device),
            ntt_cuda._stream())
        ntt_cuda._check(err, "dp_chain_predecessor")
        return out
    return launch


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_chain_predecessors: no CUDA device")
    print(card(), flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator().manual_seed(0)
    flush = torch.zeros(64 << 20, dtype=torch.int32, device=dev)
    ntt_cuda.ensure_built()
    pred = build()

    def limbs(shape, bits=16):
        return torch.randint(-(1 << bits), 1 << bits, shape, generator=gen,
                             dtype=torch.int32).to(dev)

    def line(obj):
        print(json.dumps(obj), flush=True)

    def compare(kernel, note, calls):
        """One JSON line: new == old == plain, then new, old, old, new."""
        want = calls["new"]()
        with ntt_cuda.plain_versions():
            plain = calls["new"]()
        equal = {"predecessor": torch.equal(want, calls["old"]()),
                 "plain": torch.equal(want, plain)}
        del plain, want
        ms = {k: [] for k in calls}
        for k in ("new", "old", "old", "new"):
            ms[k].append(time_ms(calls[k], args.reps, flush))
        line({"kernel": kernel, "shape": note, "equal": equal,
              **{f"{k}_ms": statistics.mean(v) for k, v in ms.items()}, "runs_ms": ms})
        return all(equal.values())

    guards = guard_calls(limbs)
    guard_ms = {k: [] for k in guards}

    def time_guards():
        for k, fn in guards.items():
            guard_ms[k].append(time_ms(fn, args.reps, flush))
    time_guards()

    vctx = get_ntt_context(VPAR.n, VPAR.primes)
    ok = True
    dp_args = None
    for name, note, a, _ in vm_shapes(VPAR, vctx, limbs):
        if name == "fused_blind_rotate":
            rows, keys, amounts = a
            calls = {"new": lambda: ntt_cuda.fused_blind_rotate(vctx, rows, keys, amounts),
                     "old": rotate_predecessor(pred["rotate"], vctx, rows, keys, amounts)}
            ok = compare(name, note, calls) and ok
        elif name == "fused_dp_chain":
            dp_args = a
    F0, keys, deltas, tabs, groups = dp_args
    # one op: the first of the enum, against its own source group's keys
    g0 = next(si for si, g in enumerate(groups) if 0 in g)
    one = (F0[:1].contiguous(), keys[:, [g0, len(groups)]].contiguous(), deltas, tabs[:1],
           ((0,),))
    for what, (F0_, keys_, deltas_, tabs_, groups_) in (("G=7", dp_args), ("G=1", one)):
        note = (f"{what}: F0{list(F0_.shape)} keys{list(keys_.shape)} "
                f"groups={[list(g) for g in groups_]}")
        calls = {"new": lambda: ntt_cuda.fused_dp_chain(vctx, F0_, keys_, deltas_, tabs_,
                                                        groups_),
                 "old": dp_predecessor(pred["dp"], vctx, F0_, keys_, deltas_, tabs_,
                                       groups_)}
        ok = compare("fused_dp_chain", note, calls) and ok

    # kernel 11's layouts at G = 7, launched through its entry point
    G = F0.shape[0]
    tab = ntt_cuda._dp_tables(tabs, ntt_cuda._op_groups(groups, G))
    want = ntt_cuda.fused_dp_chain(vctx, F0, keys, deltas, tabs, groups)
    layouts = {lay: (lambda lay=lay: ntt_cuda._launch_dp_chain(
        vctx, F0, keys, deltas, tab, cs=lay[0], blocks=lay[1])) for lay in DP_LAYOUTS}
    equal = {f"cs={cs} blocks={b}": torch.equal(want, fn())
             for (cs, b), fn in layouts.items()}
    ms = {k: [] for k in layouts}
    for lay in DP_LAYOUTS + DP_LAYOUTS[::-1]:
        ms[lay].append(time_ms(layouts[lay], args.reps, flush))
    cs = ntt_cuda._fold_cs(4 * G, F0.shape[2])
    T, Lk = keys.shape[3], keys.shape[4] // F0.shape[2]
    line({"kernel": "fused_dp_chain", "shape": "G=7 layouts", "equal": equal,
          "chosen": {"cs": cs, "blocks": ntt_cuda._fold_blocks(4 * G * cs, T, max(Lk, 3), dev)},
          "ms": {f"cs={cs} blocks={b}": statistics.mean(v) for (cs, b), v in ms.items()},
          "runs_ms": {f"cs={cs} blocks={b}": v for (cs, b), v in ms.items()}})
    ok = ok and all(equal.values())

    time_guards()
    for k, v in guard_ms.items():
        line({"kernel": k.split()[0], "shape": k.split(" ", 1)[1], "first_ms": v[0],
              "last_ms": v[1]})
    if not ok:
        sys.exit("time_chain_predecessors: a kernel differs from its predecessor, its "
                 "plain version or another of its layouts")


if __name__ == "__main__":
    main()
