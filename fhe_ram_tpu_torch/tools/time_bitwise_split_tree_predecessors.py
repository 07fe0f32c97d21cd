#!/usr/bin/env python3
"""Time the bitwise group (csrc/bitwise.cu, kernel 9) and the split tree
(csrc/split_tree.cu, kernel 7) against their predecessors on the GPU,
alternately, and the six kernels that share their device functions
(csrc/fold_body.cuh: the fold, the merge, the trace, the split, the blind
rotation, the carry chain) at one shape each, first and last.

    python3 fhe_ram_tpu_torch/tools/time_bitwise_split_tree_predecessors.py [--reps N]

The predecessors: tools/bitwise_predecessor.cu and
tools/split_tree_predecessor.cu (fold_row over CmuxGlue in UnitSlot
groups, and split_row over GridRow groups, csrc/fhe_core.cuh: radix-2
stages, a residue scratch in device memory; launched as ops/ntt_cuda.py
used to launch them; chip_smoke.py holds both kernels against them too,
through start() and finish() here).  Shapes: kernel 9 at the one the VM
cycle gives it at PARAMS_2_18_READOPT (chip_smoke.vm_shapes: the 6 bitwise
ops of the RV32I enum, 32 bits, 2 source groups); kernel 7 at chip_smoke's
three, PARAMS_2_18_TURBO_READOPT's full gadget (T = 3, M = 8): a single
write's tree (nb = 4, S = 6), a batched read-modify-write's of 16 (nb = 64,
S = 6) and nb = 3, S = 1.  At each shape the new kernel, its predecessor
and the plain version give the same integers (checked once; the tree also
equals six fused_split launches, timed beside it as per_level_ms); then
each is timed new, old, old, new: medians of --reps launches by CUDA
events, the L2 cache overwritten before each.  Then the other layouts of
kernel 9 at its shape and of kernel 7 at nb = 4 and 64 (clusters of 6 and
of 3 blocks, the 128- and the 255-register instantiation), each bit-equal
to the wrapper's choice and timed twice, in the order given and back.  One
JSON line a shape; the card's name and power limit first.
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

from time_chain_predecessors import guard_calls  # noqa: E402
from time_fold_predecessor import card, time_ms  # noqa: E402

from chip_smoke import vm_shapes  # noqa: E402
from fhe_ram_tpu_torch.ops import ntt_cuda, poly  # noqa: E402
from fhe_ram_tpu_torch.ops.modular import I32  # noqa: E402
from fhe_ram_tpu_torch.ops.ntt import get_ntt_context  # noqa: E402
from fhe_ram_tpu_torch.params import PARAMS_2_18_READOPT as VPAR  # noqa: E402
from fhe_ram_tpu_torch.params import PARAMS_2_18_TURBO_READOPT as PAR  # noqa: E402

HERE = Path(__file__).resolve().parent
LAYOUTS = ((6, 2), (6, 1), (3, 2), (3, 1))   # (blocks a cluster, instantiation)
TREES = ((4, 6), (64, 6), (3, 1))            # (roots nb, levels S)

_vp, _ci, _cip = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
SPECS = {
    "bitwise": ("bitwise_predecessor.cu", {
        "fhe_bitwise_predecessor_blocks": [ntt_cuda._FoldShape, _ci, _cip],
        "fhe_bitwise_predecessor": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _ci,
                                    ntt_cuda._OpGroups, _ci, _ci, _ci, ntt_cuda._FoldShape,
                                    ntt_cuda._Consts, ntt_cuda._Tables, _vp]}),
    "split_tree": ("split_tree_predecessor.cu", {
        "fhe_split_tree_predecessor_blocks": [ntt_cuda._FoldShape, _ci, _cip],
        "fhe_split_tree_predecessor": [_vp, _vp, _vp, _vp, _vp, _vp, _ci, _ci,
                                       ntt_cuda._TreeLevels, ntt_cuda._FoldShape,
                                       ntt_cuda._Consts, ntt_cuda._Tables, _vp]})}


def start():
    """Start nvcc on both predecessors (ops/ntt_cuda.start_build, into
    build/); finish() awaits them."""
    return {k: ntt_cuda.start_build(HERE / src, Path(src).stem)
            for k, (src, _) in SPECS.items()}


def finish(jobs):
    """{name: ctypes library} of the predecessors started by start()."""
    libs = {}
    for k, (so, job) in jobs.items():
        src, fns = SPECS[k]
        ntt_cuda.finish_build(f"tools/{src}", so, job)
        libs[k] = ctypes.CDLL(str(so))
        for fn, argtypes in fns.items():
            getattr(libs[k], fn).argtypes = argtypes
            getattr(libs[k], fn).restype = _ci
    return libs


def _resident(lib, source, sh, log_n):
    """Blocks of the predecessor the card holds at once (its cooperative
    launch's largest grid)."""
    blocks = ctypes.c_int(0)
    ntt_cuda._check(getattr(lib, f"fhe_{source}_predecessor_blocks")(
        sh, log_n, ctypes.byref(blocks)), f"the occupancy query of {source}_predecessor")
    return blocks.value


def _shape(T, M, C2, L, sign, n):
    mc = max(1, min(3, M, ntt_cuda._MAX_SMEM // (4 * n) - T))
    return ntt_cuda._FoldShape(T, M, M // C2, L, C2, sign, mc, 1)


def bitwise_predecessor(lib, ctx, hi, lo, keys, groups):
    """The predecessor launched as ops/ntt_cuda.fused_bitwise used to: a
    cooperative launch of as many UnitSlot groups (a bit each) as the card
    holds."""
    G, _, C2, L, n = hi.shape
    W, NG1, P, T, M, _ = keys.shape
    of = ntt_cuda._op_groups(groups, G)
    ops = ntt_cuda._OpGroups()
    ops.count = G
    for g in range(G):
        ops.group[g] = of[g]
    slots = 2 * G
    sh = _shape(T, M, C2, L, 1, n)
    resident = _resident(lib, "bitwise", sh, ctx.log_n)
    cs = next(c for c in (ntt_cuda._row_blocks(W * slots, M), 3, 1)
              if slots * c <= resident)
    groups_ = min(W, resident // (slots * cs))
    sh.cs = cs
    blocks = groups_ * slots * cs
    out = torch.empty((W, G, C2, L, n), dtype=I32, device=hi.device)
    inner = torch.empty((W, G, 2, C2, L, n), dtype=I32, device=hi.device)
    scratch = torch.empty((blocks // cs, P, M, n), dtype=I32, device=hi.device)

    def launch():
        arrived = torch.zeros((groups_, slots + 1), dtype=I32, device=hi.device)
        err = lib.fhe_bitwise_predecessor(
            hi.data_ptr(), lo.data_ptr(), keys.data_ptr(), out.data_ptr(), inner.data_ptr(),
            scratch.data_ptr(), arrived.data_ptr(), blocks, ops, W, NG1 - 1, T // C2, sh,
            ntt_cuda._consts(ctx), ntt_cuda._tables(ctx, hi.device), ntt_cuda._stream())
        ntt_cuda._check(err, "bitwise_predecessor")
        return out
    return launch


def split_tree_predecessor(lib, ctx, ct, gal_els, keys):
    """The predecessor launched as ops/ntt_cuda.fused_split_tree used to:
    one cooperative launch, each level's rows over GridRow groups of 6, 3 or
    1 blocks by the level's rows (ntt_cuda._row_blocks)."""
    nb, C2, L, n = ct.shape
    S, P, T, M, _ = keys.shape
    sh = _shape(T, M, C2, L, -1, n)
    resident = _resident(lib, "split_tree", sh, ctx.log_n)
    lv = ntt_cuda._TreeLevels()
    lv.count = S
    want = 0
    for l in range(S):
        lv.cs[l] = ntt_cuda._row_blocks(nb << l, M)
        lv.ginv[l] = poly.auto_inverse(n, gal_els[l])
        lv.rot[l] = -(1 << l) % (2 * n)
        want = max(want, (nb << l) * lv.cs[l])
    blocks = min(want, resident)
    out = torch.empty((nb, 1 << S, C2, L, n), dtype=I32, device=ct.device)
    tmp = torch.empty((nb, 1 << (S - 1), C2, L, n), dtype=I32, device=ct.device)
    scratch = torch.empty((blocks, P, M, n), dtype=I32, device=ct.device)

    def launch():
        arrived = torch.zeros((S, blocks), dtype=I32, device=ct.device)
        err = lib.fhe_split_tree_predecessor(
            ct.data_ptr(), keys.data_ptr(), out.data_ptr(), tmp.data_ptr(),
            scratch.data_ptr(), arrived.data_ptr(), nb, blocks, lv, sh, ntt_cuda._consts(ctx),
            ntt_cuda._tables(ctx, ct.device), ntt_cuda._stream())
        ntt_cuda._check(err, "split_tree_predecessor")
        return out
    return launch


def split_levels(ctx, ct, gal_els, keys):
    """The tree as S fused_split launches, children concatenated."""
    nodes = ct[:, None]
    for l, g in enumerate(gal_els):
        c0, c1 = ntt_cuda.fused_split(ctx, nodes.reshape((-1,) + tuple(ct.shape[1:])),
                                      1 << l, g, keys[l])
        nodes = torch.cat([c0.reshape((ct.shape[0], -1) + tuple(ct.shape[1:])),
                           c1.reshape((ct.shape[0], -1) + tuple(ct.shape[1:]))], dim=1)
    return nodes


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_bitwise_split_tree_predecessors: no CUDA device")
    print(card(), flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator().manual_seed(0)
    flush = torch.zeros(64 << 20, dtype=torch.int32, device=dev)
    jobs = start()
    ntt_cuda.ensure_built()
    pred = finish(jobs)

    def limbs(shape, bits=16):
        return torch.randint(-(1 << bits), 1 << bits, shape, generator=gen,
                             dtype=torch.int32).to(dev)

    def line(obj):
        print(json.dumps(obj), flush=True)

    def compare(kernel, note, calls):
        """One JSON line: new == old == plain (== per_level), then new, old,
        old, new (and the per-level launches twice)."""
        want = calls["new"]()
        with ntt_cuda.plain_versions():
            plain = calls["new"]()
        equal = {"predecessor": torch.equal(want, calls["old"]()),
                 "plain": torch.equal(want, plain)}
        if "per_level" in calls:
            equal["per_level"] = torch.equal(want, calls["per_level"]())
        del plain, want
        ms = {k: [] for k in calls}
        for k in ("new", "old", "old", "new") + (("per_level",) * 2 if "per_level" in calls
                                                 else ()):
            ms[k].append(time_ms(calls[k], args.reps, flush))
        line({"kernel": kernel, "shape": note, "equal": equal,
              **{f"{k}_ms": statistics.mean(v) for k, v in ms.items()}, "runs_ms": ms})
        return all(equal.values())

    def layouts(kernel, note, launch, want):
        """The layouts of LAYOUTS through launch(cs, blocks), bit-equal to
        the wrapper's output `want`, each timed in the order given and back."""
        fns = {lay: (lambda lay=lay: launch(*lay)) for lay in LAYOUTS}
        equal = {f"cs={cs} blocks={b}": torch.equal(want, fn()) for (cs, b), fn in fns.items()}
        ms = {lay: [] for lay in LAYOUTS}
        for lay in LAYOUTS + LAYOUTS[::-1]:
            ms[lay].append(time_ms(fns[lay], args.reps, flush))
        line({"kernel": kernel, "shape": f"{note} layouts", "equal": equal,
              "ms": {f"cs={cs} blocks={b}": statistics.mean(v) for (cs, b), v in ms.items()},
              "runs_ms": {f"cs={cs} blocks={b}": v for (cs, b), v in ms.items()}})
        return all(equal.values())

    # the guard: the six kernels on fold_body.cuh beside the two, first and
    # last: the read's fold, merge, trace and the write's split level
    # (time_chain_predecessors.guard_calls), kernel 10 at select_rd and
    # kernel 11 at the RV32I enum's 7 carry ops
    guards = guard_calls(limbs)
    vctx = get_ntt_context(VPAR.n, VPAR.primes)
    bitwise_args = None
    for name, note, a, _ in vm_shapes(VPAR, vctx, limbs):
        if name == "fused_bitwise":
            bitwise_args = a
        elif not any(k.startswith(name) for k in guards):   # the first rotation: select_rd's
            guards[f"{name} {note}"] = lambda name=name, a=a: getattr(ntt_cuda, name)(vctx, *a)
    guard_ms = {k: [] for k in guards}

    def time_guards():
        for k, fn in guards.items():
            guard_ms[k].append(time_ms(fn, args.reps, flush))
    time_guards()

    # kernel 9 at the VM cycle's shape, then its layouts
    hi, lo, keys9, groups = bitwise_args
    note9 = (f"leaves{list(hi.shape)} keys{list(keys9.shape)} "
             f"groups={[list(g) for g in groups]}")
    ok = compare("fused_bitwise", note9, {
        "new": lambda: ntt_cuda.fused_bitwise(vctx, hi, lo, keys9, groups),
        "old": bitwise_predecessor(pred["bitwise"], vctx, hi, lo, keys9, groups)})
    of = ntt_cuda._op_groups(groups, hi.shape[0])
    ok = layouts("fused_bitwise", note9,
                 lambda cs, b: ntt_cuda._launch_bitwise(vctx, hi, lo, keys9, of, cs, b),
                 ntt_cuda.fused_bitwise(vctx, hi, lo, keys9, groups)) and ok
    del hi, lo, keys9

    # kernel 7 at chip_smoke's three shapes, then its layouts at nb = 4, 64
    ctx = get_ntt_context(PAR.n, PAR.primes)
    n, C, L, rank = PAR.n, PAR.rank + 1, PAR.limbs_ct, PAR.rank
    T_kf, M_kf = rank * L, C * PAR.limbs_evk_trace
    gals = PAR.trace_gal_els
    keys7 = ntt_cuda.ntt_fwd_cuda(ctx, limbs((6, T_kf, M_kf, n))).permute(
        1, 0, 2, 3, 4).contiguous()
    for nb, S in TREES:
        ct = limbs((nb, C, L, n))
        ks, gs = keys7[:S].contiguous(), gals[:S]
        note7 = f"ct[{nb},{C},{L},4096] keys[{S},3,{T_kf},{M_kf},4096]"
        ok = compare("fused_split_tree", note7, {
            "new": lambda: ntt_cuda.fused_split_tree(ctx, ct, gs, ks),
            "old": split_tree_predecessor(pred["split_tree"], ctx, ct, gs, ks),
            "per_level": lambda: split_levels(ctx, ct, gs, ks)}) and ok
        if S == 6:
            sh, blocks, clusters = ntt_cuda._split_tree_layout(nb, S, T_kf, M_kf, C, L, dev)
            line({"kernel": "fused_split_tree", "shape": note7,
                  "chosen": {"cs": sh.cs, "blocks": blocks, "clusters": clusters}})
            ok = layouts("fused_split_tree", note7,
                         lambda cs, b: ntt_cuda._launch_split_tree(ctx, ct, gs, ks, cs, b),
                         ntt_cuda.fused_split_tree(ctx, ct, gs, ks)) and ok
        del ct

    time_guards()
    for k, v in guard_ms.items():
        line({"kernel": k.split()[0], "shape": k.split(" ", 1)[1], "first_ms": v[0],
              "last_ms": v[1]})
    if not ok:
        sys.exit("time_bitwise_split_tree_predecessors: a kernel differs from its "
                 "predecessor, its plain version, the per-level launches or another of "
                 "its layouts")


if __name__ == "__main__":
    main()
