#!/usr/bin/env python3
"""Time the pack merge (csrc/pack_merge.cu, kernel 4) and the all-gather
(csrc/collective.cu, kernel 13) against their predecessors on the GPU,
alternately, and the fold (kernel 2), whose device functions the merge now
shares (csrc/fold_body.cuh), at two shapes.

    python3 fhe_ram_tpu_torch/tools/time_merge_ring_predecessors.py [--reps N]

The predecessors: tools/pack_merge_predecessor.cu (fold_row over
MergeGlue, radix-2 stages, a residue scratch in device memory; launched as
ops/ntt_cuda.py used to launch it) and tools/collective_predecessor.cu (the
ring: n - 1 hops in one cooperative launch).  At each shape the new kernel,
its predecessor and the plain version give the same integers (checked
once); then the merge is timed new, old, old, new and the all-gather new,
old, library, library, old, new (the library: one torch.stack that makes
every shard's output, as chip_smoke.py times it): medians of --reps
launches by CUDA events, the L2 cache overwritten before each.  Merge
shapes, at PARAMS_2_18_TURBO_READOPT's widths: nb = 128 (t = 32) and nb = 4
(t = 1) with the read's key (T = 2, M = 6) and the untruncated one (T = 3,
M = 8); a batch of 16's first level (nb = 2048) with both; and the 12
levels of the 2^24 read (PARAMS_2_24_READOPT, nb = 8192 .. 4).  All-gather:
every chip_smoke.py COLLECTIVE_SHAPES["ring_all_gather"] entry.  The fold:
B = 256 and the 2^24 read's level 0 (16,384 rows), timed before and after
the rest.  One JSON line a shape; the card's name and power limit first.
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

from chip_smoke import COLLECTIVE_SHAPES  # noqa: E402
from time_fold_predecessor import build_tools, card, time_ms  # noqa: E402

from fhe_ram_tpu_torch.ops import ntt_cuda, poly  # noqa: E402
from fhe_ram_tpu_torch.ops.modular import I32  # noqa: E402
from fhe_ram_tpu_torch.ops.ntt import get_ntt_context  # noqa: E402
from fhe_ram_tpu_torch.parallel import collective as coll  # noqa: E402
from fhe_ram_tpu_torch.params import PARAMS_2_18_TURBO_READOPT as PAR  # noqa: E402
from fhe_ram_tpu_torch.params import PARAMS_2_24_READOPT as BPAR  # noqa: E402

NB_RMW = 16   # chip_smoke.py's batch


def build():
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return build_tools({
        "merge": ("pack_merge_predecessor.cu", "fhe_pack_merge_predecessor",
                  [vp, vp, vp, vp, vp, ci, ci, ci, ci, ntt_cuda._FoldShape,
                   ntt_cuda._Consts, ntt_cuda._Tables, vp], []),
        "ring": ("collective_predecessor.cu", "fhe_ring_all_gather_predecessor",
                 [ntt_cuda.ShardPtrs, ci, ctypes.c_longlong, vp], [])})


def merge_predecessor(fn, ctx, A, B, t_rot, g, key):
    """The predecessor launched as ops/ntt_cuda.fused_pack_merge used to."""
    nb, C2, L, n = A.shape
    P, T, M, _ = key.shape
    out = torch.empty_like(A)
    scratch = torch.empty((nb, P, M, n), dtype=I32, device=A.device)
    sh = ntt_cuda._fold_shape(nb, T, M, C2, L, -1, n)

    def launch():
        err = fn(A.data_ptr(), B.data_ptr(), key.data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), nb, t_rot % (2 * n), poly.auto_inverse(n, g),
                 T // (C2 - 1), sh, ntt_cuda._consts(ctx),
                 ntt_cuda._tables(ctx, A.device), ntt_cuda._stream())
        ntt_cuda._check(err, "pack_merge_predecessor")
        return out
    return launch


def ring_predecessor(fn, chunks):
    """The predecessor launched as parallel/collective.ring_all_gather used to."""
    n = len(chunks)
    outs = [torch.empty((n,) + tuple(c.shape), dtype=I32, device=c.device)
            for c in chunks]
    table = coll._table(chunks, outs)

    def launch():
        ntt_cuda._check(fn(table, n, chunks[0].numel(), ntt_cuda._stream()),
                        "ring_all_gather_predecessor")
        return outs
    return launch


def merge_shapes(limbs, spectra):
    """(note, A, B, t, g, key) of every merge shape the tool times."""
    n, W, R = PAR.n, PAR.word_size, PAR.num_rows
    C, L, rank = PAR.rank + 1, PAR.limbs_ct, PAR.rank
    keys = {"": spectra((rank * PAR.read_ks_trunc[0], C * PAR.read_ks_trunc[1], n)),
            " (untruncated)": spectra((rank * L, C * PAR.limbs_evk_trace, n))}
    for nb, l in ((W * R // 2, 5), (W, 0), (NB_RMW * W * R // 2, 5)):
        A, B = limbs((nb, C, L, n), 17), limbs((nb, C, L, n), 17)
        for sfx, key in keys.items():
            yield (f"nb={nb} t={1 << l} T={key.shape[1]} M={key.shape[2]}{sfx}",
                   A, B, 1 << l, (n >> l) + 1, key)
    BW, BR = BPAR.word_size, BPAR.num_rows
    levels = BR.bit_length() - 1
    bkey = spectra((BPAR.rank * BPAR.read_ks_trunc[0],
                    (BPAR.rank + 1) * BPAR.read_ks_trunc[1], n))
    for s in range(levels):
        nb, l = BW * (BR >> (s + 1)), levels - 1 - s
        A = limbs((nb, BPAR.rank + 1, BPAR.limbs_ct, n), 17)
        B = limbs((nb, BPAR.rank + 1, BPAR.limbs_ct, n), 17)
        yield (f"2^24 read level {s}: nb={nb} t={1 << l}", A, B, 1 << l,
               (n >> l) + 1, bkey)
        del A, B


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_merge_ring_predecessors: no CUDA device")
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

    def t_ms(fn):
        return time_ms(fn, args.reps, flush)

    def same(a, b):
        a = a if isinstance(a, (list, tuple)) else [a]
        b = b if isinstance(b, (list, tuple)) else [b]
        return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))

    def timed(calls, order):
        ms = {k: [] for k in calls}
        for k in order:
            ms[k].append(t_ms(calls[k]))
        return {**{f"{k}_ms": statistics.mean(v) for k, v in ms.items()}, "runs_ms": ms}

    # kernel 2 (csrc/fold.cu on fold_body.cuh) at the read's level 0 and the
    # 2^24 read's, first and last
    C, L = PAR.rank + 1, PAR.limbs_ct
    T_ep, M_ep = C * PAR.read_ep_trunc[0], C * PAR.read_ep_trunc[1]
    keys_ep = spectra((1, T_ep, M_ep, n)).reshape(3, 1, T_ep, M_ep, n)
    BRW = BPAR.num_rows * BPAR.word_size
    folds = {f"fused_external_fold x[{B_},{T_ep}]": limbs((B_, T_ep, n))
             for B_ in (PAR.word_size * PAR.num_rows, BRW)}
    fold_ms = {k: [] for k in folds}

    def time_folds():
        for note, x in folds.items():
            fold_ms[note].append(t_ms(
                lambda: ntt_cuda.fused_external_fold(ctx, x, keys_ep, L, C)))
    time_folds()

    ok = True
    for note, A, B, t_rot, g, key in merge_shapes(limbs, spectra):
        calls = {"new": lambda: ntt_cuda.fused_pack_merge(ctx, A, B, t_rot, g, key),
                 "old": merge_predecessor(pred["merge"], ctx, A, B, t_rot, g, key)}
        want = calls["new"]()
        with ntt_cuda.plain_versions():
            plain = calls["new"]()
        equal = {"predecessor": same(want, calls["old"]()), "plain": same(want, plain)}
        del plain
        nb, C2, _, _ = A.shape
        T, M = key.shape[1:3]
        cs = ntt_cuda._fold_cs(nb, C2)
        rec = {"kernel": "fused_pack_merge", "shape": note, "equal": equal,
               "cs": cs, "blocks": ntt_cuda._fold_blocks(
                   min(nb, ntt_cuda._MAX_ROW_GROUPS) * cs, T, max(M // C2, 3), dev),
               **timed(calls, ("new", "old", "old", "new"))}
        print(json.dumps(rec), flush=True)
        ok = ok and all(equal.values())
        del calls, want

    BW, BC, BL = BPAR.word_size, BPAR.rank + 1, BPAR.limbs_ct
    for n_sh, roots in COLLECTIVE_SHAPES["ring_all_gather"]:
        chunks = [limbs((roots * BW, BC, BL, n)) for _ in range(n_sh)]
        calls = {"new": lambda: coll.ring_all_gather(chunks),
                 "old": ring_predecessor(pred["ring"], chunks),
                 "library": lambda: torch.stack(chunks * n_sh).view(
                     (n_sh, n_sh) + tuple(chunks[0].shape))}
        want = calls["new"]()
        equal = {"predecessor": same(want, calls["old"]()),
                 "plain": same(want, coll.ring_all_gather_plain(chunks))}
        rec = {"kernel": "ring_all_gather", "shape": f"n={n_sh} chunk{list(chunks[0].shape)}",
               "equal": equal,
               **timed(calls, ("new", "old", "library", "library", "old", "new"))}
        print(json.dumps(rec), flush=True)
        ok = ok and all(equal.values())

    time_folds()
    for note, v in fold_ms.items():
        print(json.dumps({"kernel": "fused_external_fold", "shape": note,
                          "new_ms": statistics.mean(v), "runs_ms": v}), flush=True)
    if not ok:
        sys.exit("time_merge_ring_predecessors: a kernel differs from its "
                 "predecessor or its plain version")


if __name__ == "__main__":
    main()
