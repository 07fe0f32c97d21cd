#!/usr/bin/env python3
"""Time the pack tree (csrc/pack_tree.cu, kernel 8) and the NTT
(csrc/ntt.cu, kernel 1) against their predecessors on the GPU,
alternately; kernel 8's other deal and its cluster layouts, kernel 1's
instantiations, the exchange (kernel 14) against torch.stack, and the
eight kernels that share their device functions (csrc/fold_body.cuh) at
one shape each, first and last.

    python3 fhe_ram_tpu_torch/tools/time_pack_tree_ntt_predecessors.py [--reps N] [--pairs N]

The predecessors: tools/pack_tree_predecessor.cu (merge_row over GridRow
groups, csrc/fhe_core.cuh: radix-2 stages, a residue scratch in device
memory) and tools/ntt_predecessor.cu, built once with each of
fhe_core.cuh's transform bodies (radix-2, two-pass), launched as
ops/ntt_cuda.py used to launch them; chip_smoke.py holds both kernels
against them too, through start() and finish() here.  Shapes: kernel 8 at
chip_smoke's three, PARAMS_2_18_TURBO_READOPT's full gadget (T = 3, Mk =
8): a read_prepare_write's tree (32 leaves, nb = 4), a batched
read-modify-write's of 16 (nb = 64) and 2 leaves at nb = 3; kernel 1 at an
address coordinate's GGSW (x[36,4096], its inverse x[3,36,4096]) and the
batched read's level-0 digits (x[1024,4096], x[3,1024,4096]).  At each
shape the kernel, its predecessor(s) and the plain version give the same
integers (checked once; the tree also equals five fused_pack_merge
launches, timed beside it as per_level_ms; kernel 1 under the two-pass
context also equals the radix-2 context's call); then each is timed new,
old, old, new (kernel 1: new, radix-2, two-pass, two-pass, radix-2, new):
medians of --reps launches by CUDA events, the L2 cache overwritten before
each.  Then, each bit-equal to the wrapper's output and timed in the order
given and back: kernel 8's per-row counters against the barrier between
levels of tools/pack_tree_barrier.cu at the three shapes (four times);
its four
layouts at nb = 4 and 64 (clusters of 6 and of 3 blocks, the 128- and the
255-register instantiation); kernel 1's instantiations (4 and 2 blocks an
SM).
Then --pairs alternating pairs of the exchange and the one torch.stack
that makes every shard's output (chip_smoke's library call) at n = 4 and 8.
One JSON line a shape; the card's name and power limit first.
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
from fhe_ram_tpu_torch.parallel import collective  # noqa: E402
from fhe_ram_tpu_torch.params import PARAMS_2_18_READOPT as VPAR  # noqa: E402
from fhe_ram_tpu_torch.params import PARAMS_2_18_TURBO_READOPT as PAR  # noqa: E402
from fhe_ram_tpu_torch.params import PARAMS_2_24_READOPT as BPAR  # noqa: E402

HERE = Path(__file__).resolve().parent
LAYOUTS = ((6, 2), (6, 1), (3, 2), (3, 1))   # (blocks a cluster, instantiation)
TREES = ((32, 4), (32, 64), (2, 3))          # (leaves M, columns nb)
NTT_ROWS = (36, 1024)                        # polys of kernel 1's shapes

_vp, _ci, _cip = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
_NTT_FNS = {f"fhe_ntt_{d}_predecessor": [_vp, _vp, _ci, ntt_cuda._Consts, ntt_cuda._Tables,
                                          _vp] for d in ("fwd", "inv")}
# name: (source, flags, {function: argtypes})
SPECS = {
    "pack_tree": ("pack_tree_predecessor.cu", [], {
        "fhe_pack_tree_predecessor_blocks": [ntt_cuda._FoldShape, _ci, _cip],
        "fhe_pack_tree_predecessor": [_vp, _vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci,
                                      ntt_cuda._TreeLevels, ntt_cuda._FoldShape,
                                      ntt_cuda._Consts, ntt_cuda._Tables, _vp]}),
    "pack_tree_barrier": ("pack_tree_barrier.cu", [], {
        "fhe_pack_tree_barrier_clusters": [ntt_cuda._FoldShape, _ci, _cip],
        "fhe_pack_tree_barrier": [_vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci,
                                  ntt_cuda._PackLevels, _ci, ntt_cuda._FoldShape,
                                  ntt_cuda._Consts, ntt_cuda._FoldTables, _vp]}),
    "ntt_radix2": ("ntt_predecessor.cu", [], _NTT_FNS),
    "ntt_two_pass": ("ntt_predecessor.cu", ["-DFHE_NTT_TWO_PASS"], _NTT_FNS)}


def start():
    """Start nvcc on the predecessors and kernel 8's other deal
    (ops/ntt_cuda.start_build, into build/, a library a source and body);
    finish() awaits them."""
    return {k: ntt_cuda.start_build(HERE / src, f"{Path(src).stem}_{k}", flags)
            for k, (src, flags, _) in SPECS.items()}


def finish(jobs):
    """{name: ctypes library} of the sources started by start()."""
    libs = {}
    for k, (so, job) in jobs.items():
        src, _, fns = SPECS[k]
        ntt_cuda.finish_build(f"tools/{src} ({k})", so, job)
        libs[k] = ctypes.CDLL(str(so))
        for fn, argtypes in fns.items():
            getattr(libs[k], fn).argtypes = argtypes
            getattr(libs[k], fn).restype = _ci
    return libs


def pack_tree_predecessor(lib, ctx, cts, keys):
    """The predecessor launched as ops/ntt_cuda.fused_pack_tree used to:
    one cooperative launch, each level's row pairs over GridRow groups of
    6, 3 or 1 blocks by the level's rows (ntt_cuda._row_blocks), as many
    blocks as the widest level can use, at most what the card holds."""
    M, nb, C2, L, n = cts.shape
    levels, P, T, Mk, _ = keys.shape
    mc = max(1, min(3, Mk, ntt_cuda._MAX_SMEM // (4 * n) - T))
    sh = ntt_cuda._FoldShape(T, Mk, Mk // C2, L, C2, -1, mc, 1)
    resident = ctypes.c_int(0)
    ntt_cuda._check(lib.fhe_pack_tree_predecessor_blocks(sh, ctx.log_n, ctypes.byref(resident)),
                    "the occupancy query of pack_tree_predecessor")
    lv = ntt_cuda._TreeLevels()
    lv.count = levels
    want = 0
    for s in range(levels):
        rows, l = (M >> (s + 1)) * nb, levels - 1 - s
        lv.cs[s] = ntt_cuda._row_blocks(rows, Mk)
        lv.ginv[s] = poly.auto_inverse(n, (n >> l) + 1)
        lv.rot[s] = (1 << l) % (2 * n)
        want = max(want, rows * lv.cs[s])
    blocks = min(want, resident.value)
    out = torch.empty((nb, C2, L, n), dtype=I32, device=cts.device)
    tmp = torch.empty((max(1, M // 2 + M // 4), nb, C2, L, n), dtype=I32, device=cts.device)
    scratch = torch.empty((blocks, P, Mk, n), dtype=I32, device=cts.device)

    def launch():
        arrived = torch.zeros((levels, blocks), dtype=I32, device=cts.device)
        err = lib.fhe_pack_tree_predecessor(
            cts.data_ptr(), keys.data_ptr(), out.data_ptr(), tmp.data_ptr(), scratch.data_ptr(),
            arrived.data_ptr(), M, nb, blocks, lv, sh, ntt_cuda._consts(ctx),
            ntt_cuda._tables(ctx, cts.device), ntt_cuda._stream())
        ntt_cuda._check(err, "pack_tree_predecessor")
        return out
    return launch


def pack_tree_barrier(lib, ctx, cts, keys):
    """tools/pack_tree_barrier.cu in the layout (cluster size,
    instantiation) ops/ntt_cuda._tree_layout gives csrc/pack_tree.cu, as
    many clusters as the card holds of it."""
    M, nb, C2, L, n = cts.shape
    levels, P, T, Mk, _ = keys.shape
    level_rows = [(M >> (s + 1)) * nb for s in range(levels)]
    sh, blocks, _ = ntt_cuda._tree_layout("pack_tree", level_rows, T, Mk, C2, L, cts.device)
    clusters = ctypes.c_int(0)
    ntt_cuda._check(lib.fhe_pack_tree_barrier_clusters(sh, blocks, ctypes.byref(clusters)),
                    "the occupancy query of pack_tree_barrier")
    clusters = min(clusters.value, max(level_rows))
    out = torch.empty((nb, C2, L, n), dtype=I32, device=cts.device)
    tmp = torch.empty((max(1, M // 2 + M // 4), nb, C2, L, n), dtype=I32, device=cts.device)

    def launch():
        arrived = torch.zeros((1,), dtype=I32, device=cts.device)
        err = lib.fhe_pack_tree_barrier(
            cts.data_ptr(), keys.data_ptr(), out.data_ptr(), tmp.data_ptr(), arrived.data_ptr(),
            M, nb, clusters, T // (C2 - 1), ntt_cuda._pack_levels(levels, n), blocks, sh,
            ntt_cuda._consts(ctx), ntt_cuda._fold_tables(ctx, cts.device), ntt_cuda._stream())
        ntt_cuda._check(err, "pack_tree_barrier")
        return out
    return launch


def ntt_predecessor(lib, ctx, direction, x):
    """The predecessor (one body's build) launched as
    ops/ntt_cuda.ntt_fwd_cuda / ntt_inv_cuda used to: a block of 512
    threads a (polynomial, prime).  x: int32[B, N] ("fwd") or [P, B, N]
    ("inv"); returns int32[P, B, N]."""
    n, P = ctx.n, len(ctx.primes)
    B = x.shape[-2]
    out = torch.empty((P, B, n), dtype=I32, device=x.device)
    fn = getattr(lib, f"fhe_ntt_{direction}_predecessor")

    def launch():
        err = fn(x.data_ptr(), out.data_ptr(), B, ntt_cuda._consts(ctx),
                 ntt_cuda._tables(ctx, x.device), ntt_cuda._stream())
        ntt_cuda._check(err, f"ntt_{direction}_predecessor")
        return out
    return launch


def merge_levels(ctx, cts, keys):
    """The tree as log2(M) fused_pack_merge launches."""
    M, nb, n = cts.shape[0], cts.shape[1], cts.shape[-1]
    levels = M.bit_length() - 1
    for s in range(levels):
        l, R = levels - 1 - s, M >> (s + 1)
        out = ntt_cuda.fused_pack_merge(
            ctx, cts[:R].reshape((-1,) + tuple(cts.shape[2:])),
            cts[R: 2 * R].reshape((-1,) + tuple(cts.shape[2:])), 1 << l, (n >> l) + 1, keys[s])
        cts = out.reshape((R, nb) + tuple(cts.shape[2:]))
    return cts[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--pairs", type=int, default=24)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_pack_tree_ntt_predecessors: no CUDA device")
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

    def compare(kernel, note, calls, order, extra=None):
        """One JSON line: every call of `calls` (and `extra`, checked only)
        == calls["new"] == its plain version, then calls timed in `order`."""
        want = calls["new"]()
        with ntt_cuda.plain_versions():
            plain = calls["new"]()
        equal = {k: torch.equal(want, fn()) for k, fn in {**calls, **(extra or {})}.items()
                 if k != "new"}
        equal["plain"] = torch.equal(want, plain)
        del plain, want
        ms = {k: [] for k in calls}
        for k in order:
            ms[k].append(time_ms(calls[k], args.reps, flush))
        line({"kernel": kernel, "shape": note, "equal": equal,
              **{f"{k}_ms": statistics.mean(v) for k, v in ms.items()}, "runs_ms": ms})
        return all(equal.values())

    def variants(kernel, note, fns, want, rounds=1):
        """fns {name: call}, each bit-equal to the wrapper's output `want`,
        each timed in the order given and back, `rounds` times."""
        equal = {k: torch.equal(want, fn()) for k, fn in fns.items()}
        ms = {k: [] for k in fns}
        for k in (list(fns) + list(fns)[::-1]) * rounds:
            ms[k].append(time_ms(fns[k], args.reps, flush))
        line({"kernel": kernel, "shape": note, "equal": equal,
              "ms": {k: statistics.mean(v) for k, v in ms.items()}, "runs_ms": ms})
        return all(equal.values())

    # the guard: the eight kernels on fold_body.cuh beside the two, first
    # and last: the read's fold, merge, trace, the write's split level
    # (time_chain_predecessors.guard_calls), the split tree of a batched
    # RMW of 16, the bitwise group, kernel 10 at select_rd and kernel 11 at
    # the RV32I enum's 7 carry ops (chip_smoke.vm_shapes)
    ctx = get_ntt_context(PAR.n, PAR.primes)
    tctx = get_ntt_context(PAR.n, PAR.primes, "two_pass")
    n, C, L, rank = PAR.n, PAR.rank + 1, PAR.limbs_ct, PAR.rank
    T_kf, M_kf = rank * L, C * PAR.limbs_evk_trace
    guards = guard_calls(limbs)
    keys_st = ntt_cuda.ntt_fwd_cuda(ctx, limbs((6, T_kf, M_kf, n))).permute(
        1, 0, 2, 3, 4).contiguous()
    ct_st = limbs((64, C, L, n))
    guards[f"fused_split_tree nb=64 S=6 T={T_kf} M={M_kf}"] = (
        lambda: ntt_cuda.fused_split_tree(ctx, ct_st, PAR.trace_gal_els[:6], keys_st))
    vctx = get_ntt_context(VPAR.n, VPAR.primes)
    for name, note, a, _ in vm_shapes(VPAR, vctx, limbs):
        if not any(k.startswith(name) for k in guards):   # the first rotation: select_rd's
            guards[f"{name} {note}"] = lambda name=name, a=a: getattr(ntt_cuda, name)(vctx, *a)
    guard_ms = {k: [] for k in guards}

    def time_guards():
        for k, fn in guards.items():
            guard_ms[k].append(time_ms(fn, args.reps, flush))
    time_guards()

    # kernel 8 at chip_smoke's three shapes: the predecessor, the per-level
    # merges, the other deal; then its layouts at nb = 4, 64
    keys8 = ntt_cuda.ntt_fwd_cuda(ctx, limbs((5, T_kf, M_kf, n))).permute(
        1, 0, 2, 3, 4).contiguous()
    ok = True
    for M, nb in TREES:
        lv = M.bit_length() - 1
        cts = limbs((M, nb, C, L, n), bits=17)
        ks = keys8[5 - lv:].contiguous()
        note8 = f"cts[{M},{nb},{C},{L},4096] keys[{lv},3,{T_kf},{M_kf},4096]"
        new = (lambda: ntt_cuda.fused_pack_tree(ctx, cts, ks))
        barrier = pack_tree_barrier(pred["pack_tree_barrier"], ctx, cts, ks)
        ok = compare("fused_pack_tree", note8, {
            "new": new, "old": pack_tree_predecessor(pred["pack_tree"], ctx, cts, ks),
            "per_level": lambda: merge_levels(ctx, cts, ks)},
            ("new", "old", "old", "new", "per_level", "per_level")) and ok
        ok = variants("fused_pack_tree", f"{note8} per-row counters vs barrier",
                      {"per_row_counters": new, "barrier": barrier}, new(), rounds=4) and ok
        if nb > 3:
            sh, blocks, clusters = ntt_cuda._tree_layout(
                "pack_tree", [(M >> (s + 1)) * nb for s in range(lv)], T_kf, M_kf, C, L, dev)
            line({"kernel": "fused_pack_tree", "shape": note8,
                  "chosen": {"cs": sh.cs, "blocks": blocks, "clusters": clusters}})
            ok = variants("fused_pack_tree", f"{note8} layouts", {
                f"cs={cs} blocks={b}": (lambda cs=cs, b=b: ntt_cuda._launch_pack_tree(
                    ctx, cts, ks, cs, b)) for cs, b in LAYOUTS}, new()) and ok
        del cts, barrier

    # kernel 1 in both directions at both shapes against the predecessor's
    # two bodies; the two-pass context's call equal to the radix-2 one's;
    # then its two instantiations
    for B in NTT_ROWS:
        x = limbs((B, n), bits=21)
        for direction, arg in (("fwd", x), ("inv", ntt_cuda.ntt_fwd_cuda(ctx, x))):
            wrap = getattr(ntt_cuda, f"ntt_{direction}_cuda")
            note1 = f"x{list(arg.shape)}"
            ok = compare(f"ntt_{direction}", note1, {
                "new": lambda wrap=wrap, arg=arg: wrap(ctx, arg),
                "radix2": ntt_predecessor(pred["ntt_radix2"], ctx, direction, arg),
                "two_pass": ntt_predecessor(pred["ntt_two_pass"], ctx, direction, arg)},
                ("new", "radix2", "two_pass", "two_pass", "radix2", "new"),
                extra={"two_pass_context": lambda wrap=wrap, arg=arg: wrap(tctx, arg)}) and ok
            flat = arg.reshape(-1, n) if direction == "fwd" else arg
            ok = variants(f"ntt_{direction}", f"{note1} instantiations", {
                f"blocks={b}": (lambda b=b, flat=flat, d=direction: ntt_cuda._launch_ntt(
                    ctx, d, flat, b)) for b in (4, 2)}, wrap(ctx, arg).reshape(3, B, n)) and ok
        del x

    # kernel 14 against torch.stack: alternating pairs at the row-sharded
    # paths' chunk (one pack root a shard at PARAMS_2_24_READOPT)
    BW, BC, BL = BPAR.word_size, BPAR.rank + 1, BPAR.limbs_ct
    for n_sh, stride in ((4, 1), (4, 2), (8, 1)):
        chunks = [limbs((BW, BC, BL, n)) for _ in range(n_sh)]
        kernel = (lambda: tuple(collective.exchange(chunks, stride)))
        library = (lambda: torch.stack([chunks[k ^ stride] for k in range(n_sh)]))
        same = all(torch.equal(a, b) for a, b in zip(kernel(), library()))
        ms = {"exchange": [], "torch_stack": []}
        for i in range(args.pairs):
            for k in (("exchange", "torch_stack") if i % 2 == 0 else ("torch_stack", "exchange")):
                ms[k].append(time_ms(kernel if k == "exchange" else library, args.reps, flush))
        ratio = [a / b for a, b in zip(ms["exchange"], ms["torch_stack"])]
        line({"kernel": "exchange", "shape": f"n={n_sh} chunk{list(chunks[0].shape)} "
              f"stride={stride}", "equal": {"torch_stack": same}, "pairs": args.pairs,
              **{f"{k}_ms": statistics.median(v) for k, v in ms.items()},
              "ratio_median": statistics.median(ratio), "ratio_min": min(ratio),
              "ratio_max": max(ratio), "runs_ms": ms})
        ok = ok and same

    time_guards()
    for k, v in guard_ms.items():
        line({"kernel": k.split()[0], "shape": k.split(" ", 1)[1], "first_ms": v[0],
              "last_ms": v[1]})
    if not ok:
        sys.exit("time_pack_tree_ntt_predecessors: a kernel differs from its predecessor, "
                 "its plain version, the per-level launches, the other context or another "
                 "of its variants")


if __name__ == "__main__":
    main()
