#!/usr/bin/env python3
"""Time the external product without the fold (csrc/external.cu, kernel 12)
and the exchange (csrc/collective.cu, kernel 14) against their predecessors
on the GPU, alternately; kernel 12's launch choices, kernel 14's grid and
its dependent launch, the card's launch floor, and the fold (kernel 2) at
the read's level 0, first and last.

    python3 fhe_ram_tpu_torch/tools/time_external_exchange_predecessors.py [--reps N] [--pairs N]

The predecessors: tools/external_predecessor.cu (prime_residues of
csrc/fhe_core.cuh, one block of 512 threads a (row, prime)), built once
with each of fhe_core.cuh's transform bodies (radix-2, two-pass), and
tools/exchange_predecessor.cu (one 16-byte unit a thread, a plain launch),
each launched as the wrappers used to launch them; chip_smoke.py holds
both kernels against them too, through start() and finish() here.

Kernel 12 at B=2, T=3, M=2 and at the read's level-0 shape (B=256, T=4,
M=6, PARAMS_2_18_TURBO_READOPT): the kernel, both predecessors, the
two-pass context's call and the plain version give the same integers
(checked once), then each is timed new, radix-2, two-pass, two-pass,
radix-2, new: medians of --reps launches by CUDA events, the L2 cache
overwritten before each; then its launch choices (split of a unit's output
polys, instantiation), each bit-equal to the wrapper's output, in the
order given and back.  Kernel 14 at every shape of chip_smoke's
COLLECTIVE_SHAPES["exchange"] (the read's pack root, PARAMS_2_24_READOPT):
bit-equal to the predecessor, the plain version and torch.stack, then
--pairs rounds of the kernel, the predecessor and the one torch.stack that
makes every shard's output, in alternating order; then the same kernel
launched without the dependent launch (tools/exchange_no_pdl.cu) and with
the grids of 4, 2 and 1 units a thread, alternately.  The dependent
launch where it can act: four fused_pack_merge launches (one a shard, the
read's tail rows) then the exchange, with and without it, --pairs
alternating pairs by events and five of each under torch.profiler (device
time by kernel); then on the exchange read itself, at the RAM cell
(PARAMS_2_18_TURBO_READOPT, the port's own client from seed 0, a mesh of
rows 4 on the card): bit-equal to the unsharded read either way, 2 x
--pairs reads by host clock alternately, and device time a read under
torch.profiler (pdl, no_pdl, no_pdl, pdl).  The launch floor: an empty
kernel (tools/launch_floor.cu) between two events, median of --reps,
beside kernels 1 (x[36,4096]), 13 and 14 at the read's shapes.  One JSON line a measurement; the card's
name and power limit first.
"""

import argparse
import ctypes
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from time_fold_predecessor import card, time_ms  # noqa: E402

from chip_smoke import COLLECTIVE_SHAPES  # noqa: E402
from fhe_ram_tpu_torch.core import glwe, rng  # noqa: E402
from fhe_ram_tpu_torch.core import keys as keys_mod  # noqa: E402
from fhe_ram_tpu_torch.ops import ntt_cuda  # noqa: E402
from fhe_ram_tpu_torch.ops.modular import I32  # noqa: E402
from fhe_ram_tpu_torch.ops.ntt import get_ntt_context  # noqa: E402
from fhe_ram_tpu_torch.parallel import collective  # noqa: E402
from fhe_ram_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from fhe_ram_tpu_torch.params import PARAMS_2_18_TURBO_READOPT as PAR  # noqa: E402
from fhe_ram_tpu_torch.params import PARAMS_2_24_READOPT as BPAR  # noqa: E402
from fhe_ram_tpu_torch.ram import address as address_mod  # noqa: E402
from fhe_ram_tpu_torch.ram import ram as ram_mod  # noqa: E402

HERE = Path(__file__).resolve().parent

_vp, _ci, _cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_EXT_FNS = {"fhe_external_predecessor": [_vp, _vp, _vp, _ci, ntt_cuda._FoldShape,
                                         ntt_cuda._Consts, ntt_cuda._Tables, _vp]}
# name: (source, flags, {function: argtypes})
SPECS = {
    "external_radix2": ("external_predecessor.cu", [], _EXT_FNS),
    "external_two_pass": ("external_predecessor.cu", ["-DFHE_NTT_TWO_PASS"], _EXT_FNS),
    "exchange": ("exchange_predecessor.cu", [], {
        "fhe_exchange_predecessor": [ntt_cuda.ShardPtrs, _ci, _ci, _cll, _vp]}),
    "exchange_no_pdl": ("exchange_no_pdl.cu", [], {
        "fhe_exchange_no_pdl": [ntt_cuda.ShardPtrs, _ci, _ci, _cll, _ci, _vp]}),
    "launch_floor": ("launch_floor.cu", [], {"fhe_empty": [_vp]})}


def start():
    """Start nvcc on the predecessors and the tool's two other sources
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


def external_predecessor(lib, ctx, x, keys):
    """The predecessor (one body's build) launched as
    ops/ntt_cuda.fused_external used to: a block of 512 threads a (row,
    prime), mc output polys an inverse pass.  x: int32[B, T, N], keys:
    int32[P, T, M, N]; returns int32[P, B, M, N]."""
    B, T, n = x.shape
    P, _, M, _ = keys.shape
    mc = max(1, min(3, M, ntt_cuda._MAX_SMEM // (4 * n) - T))
    sh = ntt_cuda._FoldShape(T, M, M, 1, 1, 1, mc, 1)
    out = torch.empty((P, B, M, n), dtype=I32, device=x.device)

    def launch():
        err = lib.fhe_external_predecessor(
            x.data_ptr(), keys.data_ptr(), out.data_ptr(), B, sh, ntt_cuda._consts(ctx),
            ntt_cuda._tables(ctx, x.device), ntt_cuda._stream())
        ntt_cuda._check(err, "external_predecessor")
        return out
    return launch


def exchange_predecessor(lib, chunks, stride):
    """The predecessor launched as parallel/collective.exchange used to:
    one 16-byte unit a thread, a group of blocks a shard; returns the
    shards' outputs as a tuple."""
    outs = [torch.empty_like(c) for c in chunks]
    table = collective._table(chunks, outs)

    def launch():
        err = lib.fhe_exchange_predecessor(table, len(chunks), stride, chunks[0].numel(),
                                           ntt_cuda._stream())
        ntt_cuda._check(err, "exchange_predecessor")
        return tuple(outs)
    return launch


def exchange_variant(chunks, stride, entry=None, per=None):
    """Kernel 14 through another entry point (entry, e.g. the launch
    without the dependent launch) or grid (per blocks a shard); returns
    the shards' outputs as a tuple."""
    outs = [torch.empty_like(c) for c in chunks]

    def launch():
        collective._launch_exchange(chunks, stride, outs, entry, per)
        return tuple(outs)
    return launch


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--pairs", type=int, default=24)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_external_exchange_predecessors: no CUDA device")
    print(card(), flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator().manual_seed(0)
    flush = torch.zeros(64 << 20, dtype=torch.int32, device=dev)
    jobs = start()
    ntt_cuda.ensure_built()
    pred = finish(jobs)
    sms = ntt_cuda._sms(dev)

    def limbs(shape, bits=16):
        return torch.randint(-(1 << bits), 1 << bits, shape, generator=gen,
                             dtype=torch.int32).to(dev)

    def line(obj):
        print(json.dumps(obj), flush=True)

    def same(a, b):
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))

    ctx = get_ntt_context(PAR.n, PAR.primes)
    tctx = get_ntt_context(PAR.n, PAR.primes, "two_pass")
    n, P = PAR.n, len(PAR.primes)
    C, L = PAR.rank + 1, PAR.limbs_ct
    W, R = PAR.word_size, PAR.num_rows
    T_ep, M_ep = C * PAR.read_ep_trunc[0], C * PAR.read_ep_trunc[1]

    # the yardstick, first and last: kernel 2 at the read's level 0
    x_f = limbs((W * R, T_ep, n))
    keys_f = ntt_cuda.ntt_fwd_cuda(ctx, limbs((T_ep, M_ep, n)))
    fold = (lambda: ntt_cuda.fused_external_fold(ctx, x_f, keys_f[:, None], L, C))
    fold_ms = [time_ms(fold, args.reps, flush)]
    ok = True

    # kernel 12 against both predecessors, then its launch choices
    for B, T, M in ((2, 3, 2), (W * R, T_ep, M_ep)):
        x = limbs((B, T, n))
        keys = ntt_cuda.ntt_fwd_cuda(ctx, limbs((T, M, n)))
        calls = {"new": lambda: ntt_cuda.fused_external(ctx, x, keys),
                 "radix2": external_predecessor(pred["external_radix2"], ctx, x, keys),
                 "two_pass": external_predecessor(pred["external_two_pass"], tctx, x, keys)}
        want = calls["new"]()
        with ntt_cuda.plain_versions():
            plain = calls["new"]()
        equal = {k: same(want, fn()) for k, fn in calls.items() if k != "new"}
        equal["plain"] = same(want, plain)
        equal["two_pass_context"] = same(want, ntt_cuda.fused_external(tctx, x, keys))
        ms = {k: [] for k in calls}
        for k in ("new", "radix2", "two_pass", "two_pass", "radix2", "new"):
            ms[k].append(time_ms(calls[k], args.reps, flush))
        split, total, blocks = ntt_cuda._external_launch(B, T, M, sms)
        note = f"x[{B},{T},4096] keys[3,{T},{M},4096]"
        line({"kernel": "fused_external", "shape": note, "equal": equal,
              "chosen": {"split": split, "blocks_total": total, "blocks": blocks},
              **{f"{k}_ms": statistics.mean(v) for k, v in ms.items()}, "runs_ms": ms})
        ok = ok and all(equal.values())
        choices = {f"split={s} blocks={b}": (
            lambda s=s, b=b: ntt_cuda._launch_external(ctx, x, keys, s, b))
            for s in sorted({1, split, M}) for b in (2, 1)}
        vequal = {k: same(want, fn()) for k, fn in choices.items()}
        vms = {k: [] for k in choices}
        for k in list(choices) + list(choices)[::-1]:
            vms[k].append(time_ms(choices[k], args.reps, flush))
        line({"kernel": "fused_external", "shape": f"{note} launch choices",
              "equal": vequal, "ms": {k: statistics.mean(v) for k, v in vms.items()},
              "runs_ms": vms})
        ok = ok and all(vequal.values())
        del x, keys, want, plain

    # kernel 14 against its predecessor and torch.stack, alternating, then
    # its variants
    BW, BC, BL = BPAR.word_size, BPAR.rank + 1, BPAR.limbs_ct
    for n_sh, roots, stride in COLLECTIVE_SHAPES["exchange"]:
        chunks = [limbs((roots * BW, BC, BL, n)) for _ in range(n_sh)]
        calls = {"exchange": lambda: tuple(collective.exchange(chunks, stride)),
                 "predecessor": exchange_predecessor(pred["exchange"], chunks, stride),
                 "torch_stack": lambda: torch.stack([chunks[k ^ stride]
                                                     for k in range(n_sh)])}
        want = calls["exchange"]()
        with ntt_cuda.plain_versions():
            plain = tuple(collective.exchange(chunks, stride))
        equal = {"predecessor": same(want, calls["predecessor"]()),
                 "plain": same(want, plain),
                 "torch_stack": same(want, tuple(calls["torch_stack"]().unbind(0)))}
        ms = {k: [] for k in calls}
        order = list(calls)
        for i in range(args.pairs):
            for k in (order if i % 2 == 0 else order[::-1]):
                ms[k].append(time_ms(calls[k], args.reps, flush))
        wins = {k: sum(a < b for a, b in zip(ms["exchange"], ms[k]))
                for k in ("predecessor", "torch_stack")}
        per = collective._exchange_blocks(n_sh, chunks[0].numel() // 4, sms)
        note = f"n={n_sh} chunk{list(chunks[0].shape)} stride={stride}"
        line({"kernel": "exchange", "shape": note, "equal": equal, "pairs": args.pairs,
              "blocks_a_shard": per,
              **{f"{k}_ms": statistics.median(v) for k, v in ms.items()},
              "exchange_faster_in_pairs": wins, "runs_ms": ms})
        ok = ok and all(equal.values())
        # the wrapper's launch, the same without the dependent launch, and
        # the grids of 4, 2 and 1 units a thread (no block-stride loop)
        units = chunks[0].numel() // 4
        variants = {"pdl": calls["exchange"],
                    "no_pdl": exchange_variant(chunks, stride,
                                               pred["exchange_no_pdl"].fhe_exchange_no_pdl)}
        for u in (4, 2, 1):
            variants[f"{u}_units_a_thread"] = exchange_variant(
                chunks, stride, per=-(-units // (u * collective.COLL_THREADS)))
        vequal = {k: same(want, fn()) for k, fn in variants.items()}
        vms = {k: [] for k in variants}
        for k in (list(variants) + list(variants)[::-1]) * 2:
            vms[k].append(time_ms(variants[k], args.reps, flush))
        line({"kernel": "exchange", "shape": f"{note} variants", "equal": vequal,
              "ms": {k: statistics.median(v) for k, v in vms.items()}, "runs_ms": vms})
        ok = ok and all(vequal.values())
        del chunks, want, plain

    # the dependent launch where a kernel precedes the exchange: the read's
    # tail at rows 4, one merge a shard, then the exchange of the roots
    n4, stride = 4, 2
    T_ks, M_ks = BPAR.rank * BPAR.read_ks_trunc[0], C * BPAR.read_ks_trunc[1]
    bctx = get_ntt_context(BPAR.n, BPAR.primes)
    key = ntt_cuda.ntt_fwd_cuda(bctx, limbs((T_ks, M_ks, n)))
    A = [limbs((BW, BC, BL, n), bits=17) for _ in range(n4)]
    Bm = [limbs((BW, BC, BL, n), bits=17) for _ in range(n4)]
    outs = [torch.empty((BW, BC, BL, n), dtype=I32, device=dev) for _ in range(n4)]

    def tail(entry):
        def run():
            roots = [ntt_cuda.fused_pack_merge(bctx, A[k], Bm[k], 1, n + 1, key)
                     for k in range(n4)]
            collective._launch_exchange(roots, stride, outs, entry)
            return tuple(outs)
        return run
    seqs = {"pdl": tail(None),
            "no_pdl": tail(pred["exchange_no_pdl"].fhe_exchange_no_pdl)}
    want = tuple(o.clone() for o in seqs["no_pdl"]())
    equal = {"pdl": same(want, seqs["pdl"]())}
    ms = {k: [] for k in seqs}
    for i in range(args.pairs):
        for k in (("pdl", "no_pdl") if i % 2 == 0 else ("no_pdl", "pdl")):
            ms[k].append(time_ms(seqs[k], args.reps, flush))
    profiled = {}
    for k in ("pdl", "no_pdl", "no_pdl", "pdl"):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                seqs[k]()
            torch.cuda.synchronize()
        rows = {e.key[:40]: e.device_time_total / 1e3 / 5 for e in prof.key_averages()
                if e.device_time_total > 0
                and e.device_type == torch.autograd.DeviceType.CUDA}
        profiled.setdefault(k, []).append(
            {"device_ms_a_run": sum(rows.values()), "by_kernel_ms": rows})
    line({"kernel": "exchange", "shape": f"after {n4} fused_pack_merge launches "
          f"(nb={BW}, T={T_ks}, M={M_ks}), n={n4} stride={stride}", "equal": equal,
          "pairs": args.pairs, **{f"{k}_ms": statistics.median(v) for k, v in ms.items()},
          "pdl_faster_in_pairs": sum(a < b for a, b in zip(ms["pdl"], ms["no_pdl"])),
          "profiled": profiled, "runs_ms": ms})
    ok = ok and all(equal.values())

    # the exchange read on the RAM cell (24 MiB, rows 4): with the dependent
    # launch and without it (the same kernel through the other entry
    # point), each bit-equal to the unsharded read; host clock of a read,
    # alternately, and device time of a read under torch.profiler
    src = rng.Source(0)
    sk = rng.ternary_secret(src.split(), PAR.rank, n, PAR.xs_density, device=dev)
    s_ntt = glwe.secret_prepare(ctx, sk)
    ekp = keys_mod.prepare(PAR, keys_mod.keygen(PAR, sk, src))
    data = np.random.default_rng(0).integers(0, 256, size=PAR.max_addr * W).astype(np.uint8)
    server = ram_mod.FheRam(PAR, ekp, device=dev)
    state = server.init_state(ram_mod.encrypt_ram(PAR, ctx, s_ntt, data, src))
    rmesh = mesh_mod.make_mesh(n4, rows=n4, devices=[dev] * n4)
    shards = mesh_mod.shard_data_rows(rmesh, state.data)
    ap = address_mod.prepare(ctx, address_mod.encrypt(PAR, ctx, s_ntt, 12345, src))
    xread = mesh_mod.sharded_read_fn(PAR, rmesh, "exchange")
    real_launch = collective._launch_exchange

    def reader(entry):
        def run():
            collective._launch_exchange = (
                lambda c, s_, o, e=None, per=None: real_launch(c, s_, o, entry, per))
            try:
                return tuple(xread(shards, ap.coordinates, ekp.atk_glwe))
            finally:
                collective._launch_exchange = real_launch
        return run
    reads = {"pdl": reader(None),
             "no_pdl": reader(pred["exchange_no_pdl"].fhe_exchange_no_pdl)}
    want = server.read(state, ap)
    equal = {k: all(torch.equal(o, want) for o in fn()) for k, fn in reads.items()}
    ms = {k: [] for k in reads}
    for i in range(2 * args.pairs):
        for k in (("pdl", "no_pdl") if i % 2 == 0 else ("no_pdl", "pdl")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reads[k]()
            torch.cuda.synchronize()
            ms[k].append((time.perf_counter() - t0) * 1e3)
    profiled = {}
    for k in ("pdl", "no_pdl", "no_pdl", "pdl"):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                reads[k]()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if e.device_time_total > 0
                and e.device_type == torch.autograd.DeviceType.CUDA]
        profiled.setdefault(k, []).append({
            "device_ms_a_read": sum(e.device_time_total for e in rows) / 1e3 / 3,
            "exchange_ms_a_read": sum(e.device_time_total for e in rows
                                      if e.key.startswith("exchange_kernel")) / 1e3 / 3})
    line({"kernel": "exchange", "shape": f"sharded read, PARAMS_2_18_TURBO_READOPT, "
          f"rows {n4}", "equal_to_unsharded_read": equal, "reads": 2 * args.pairs,
          **{f"{k}_ms": statistics.median(v) for k, v in ms.items()},
          "pdl_faster_in_pairs": sum(a < b for a, b in zip(ms["pdl"], ms["no_pdl"])),
          "profiled": profiled, "runs_ms": ms})
    ok = ok and all(equal.values())
    del shards, state, server, ekp

    # the launch floor beside the kernels that sit at it
    floor_lib = pred["launch_floor"]

    def empty():
        ntt_cuda._check(floor_lib.fhe_empty(ntt_cuda._stream()), "empty kernel")
    x36 = limbs((36, n), bits=21)
    s36 = ntt_cuda.ntt_fwd_cuda(ctx, x36)
    roots4 = [limbs((BW, BC, BL, n)) for _ in range(4)]
    at_floor = {"empty_kernel": empty,
                "ntt_fwd x[36,4096]": lambda: ntt_cuda.ntt_fwd_cuda(ctx, x36),
                "ntt_inv x[3,36,4096]": lambda: ntt_cuda.ntt_inv_cuda(ctx, s36),
                "ring_all_gather n=4": lambda: collective.ring_all_gather(roots4),
                "exchange n=4 stride=1": lambda: collective.exchange(roots4, 1),
                "exchange n=4 stride=2": lambda: collective.exchange(roots4, 2)}
    fms = {k: [] for k in at_floor}
    for k in list(at_floor) + list(at_floor)[::-1]:
        fms[k].append(time_ms(at_floor[k], args.reps, flush))
    line({"kernel": "launch_floor", "ms": {k: statistics.mean(v) for k, v in fms.items()},
          "runs_ms": fms})

    fold_ms.append(time_ms(fold, args.reps, flush))
    line({"kernel": "fused_external_fold",
          "shape": f"x[{W * R},{T_ep},4096] keys[3,1,{T_ep},{M_ep},4096]",
          "first_ms": fold_ms[0], "last_ms": fold_ms[1]})
    if not ok:
        sys.exit("time_external_exchange_predecessors: a kernel differs from its "
                 "predecessor, its plain version, the other context or another of "
                 "its variants")


if __name__ == "__main__":
    main()
