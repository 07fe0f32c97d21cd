#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's encrypted RAM once on one NVIDIA GPU: reads,
read-modify-write cycles, batched reads, batched read-modify-writes,
encrypted VM instruction cycles, the VM LOAD (a word read from the RAM
decomposed into its encrypted bits), the 2^24 RAM unsharded and
row-sharded over a mesh whose shards all lie on the card, and the batched
read and read-modify-write over two processes that share the card; the
RAM server, the VM, the LOAD, the mesh and the two processes also on their
composed routes (a two-pass context, the counterpart of the JAX package's
FHERAM_MXU=0); the upstream's README parameterization through reads and
read-modify-write cycles, and the port's fhe_ram_demo at the upstream's
committed-code default.

    python3 chip_smoke.py [--seed N] [--reads N] [--profile] [--kernels-only]
                          [--verbose-build]

Phases (each prints one JSON line; any failure exits non-zero):

  device         the card (nvidia-smi name and power limit), torch and CUDA
  build          compiles the CUDA kernels from fhe_ram_tpu_torch/csrc
  kernel checks  each kernel against its plain PyTorch version on the card,
                 at the shapes the paths below give it at
                 PARAMS_2_18_TURBO_READOPT, the VM's kernels at the
                 cycle's shapes at PARAMS_2_18_READOPT, the collectives at
                 the row-sharded paths' shapes at PARAMS_2_24_READOPT
                 (torch.equal: integer arithmetic, tolerance 0), with times
                 (the collectives also beside one torch.stack that makes
                 every shard's output); kernels 1, 2, 5 and 12 (one build
                 for both bodies) under both contexts, the two-pass
                 context's call bit-equal to the radix-2 one's, kernel 2
                 also timed at the 2^24 read's level 0, as kernel 4 (on
                 the same body) is; kernels 3 and 6 (on that body too) at a
                 read's, a write's and a batch's shapes, the split up to the
                 per-level batched RMW's last level (2048 rows); kernel 12
                 (on no path) also folded and held against kernel 2;
                 kernels 1, 7, 8, 9, 12 and 14 also bit-equal to their
                 predecessors (fhe_ram_tpu_torch/tools/; kernels 1's and
                 12's in both bodies), timed beside; kernels 5, 1, 3 and 2
                 also at every shape the LOAD gives them, on both contexts
                 (the two-pass one's trace a fold a step); kernels 2 and 1
                 at the shapes PARAMS_README_2_18's read and write cycle
                 add (four and two chained digits, the full gadget, its
                 GGSW inversion)
  read           the port's own client from --seed: keygen, 2^18 x 4 random
                 bytes encrypted, then --reads reads at distinct addresses;
                 each decrypts to the plaintext word under the noise bound;
                 launch counters are set to 0 before and read after
  read_vs_plain  one of those reads again through the plain versions on the
                 card, bit-equal to the kernels' read
  rmw            4 read_prepare_write + write cycles at distinct
                 addresses: the old word comes out, the new word reads back,
                 two other addresses are unchanged, launches per cycle
  rmw_vs_plain   one cycle again through the plain versions on the card:
                 the read-out and the whole new RAM bit-equal
  read_batch     16 addresses in one read_batch call, with the spectral
                 cache and without: every word decodes and equals the single
                 read's ciphertext bit for bit; then 64 addresses
  rmw_batch      a server with tree_kernels=True: two chained rmw_batch calls
                 of 16 distinct addresses (the pre-write words come out, the
                 new ones read back, 16 other addresses are unchanged), launches
                 per call, then times of both servers, bit-equal
  rmw_batch_vs_plain  a batch of 4 and the timed batch of 16 again through
                 the plain versions on the card: outs and the whole new
                 RAM bit-equal
  tree_kernels_cycle  the single cycle with tree_kernels=True beside the
                 default's, bit-equal
  composed_read  FheRam(composed=True), the composed configuration (the
                 two-pass transform body; each pack merge, trace step and
                 split level one fold launch): the read phase's addresses,
                 each bit-equal to the fused server's read and decoded;
                 every launch of the window a fold (kernels 2, 5), a
                 transform (kernel 1: one build for both bodies) or a
                 two-pass variant (none of kernels 3, 4, 6-11);
                 composed_read_ms beside read_ms
  composed_rmw   4 chained composed cycles at fresh addresses: old words out,
                 new words back, each cycle bit-equal to the fused server's
                 (read-out and all of the new RAM); rpw_ms, write_ms
  composed_batch read_batch of 16 (with and without the cache) and rmw_batch
                 of 4, bit-equal to the fused server's, decoded
  composed_vs_plain  a composed read and cycle through the plain versions
  composed_chained_batch  the port's own client at PARAMS_README_2_18 (4 + 2
                 chained CMux digits of 3 bits; keygen, RAM, 8 addresses from
                 --seed): FheRam(composed=True).read_batch of 8, whose level
                 0 chains every address's digits from the RAM's
                 coefficients, bit-equal to the fused server's (which chains
                 from the shared spectra) and to the same call through the
                 plain versions; decoded; launches a call as counted from
                 the code
  readme_rmw     on that client: 8 fused FheRam.reads at distinct addresses,
                 then 4 read_prepare_write + write cycles at fresh ones
                 (words from --seed), each cycle's new RAM read back at its
                 address and at an untouched neighbour; every byte decodes
                 under the bound; launches a call as counted from the code;
                 the first read and cycle (read-out and new RAM) bit-equal
                 through the plain versions and through the composed
                 server, and every shape the kernels' run of it launched
                 one that the plain run launched too; read, rpw and write
                 times (host clock, no shape recording in the timed calls)
  demo           fhe_ram_tpu_torch/examples/fhe_ram_demo.py's run at
                 PARAMS_CODE_2_14 (keygen, 2^14 x 4 bytes, read,
                 read_prepare_write, write, read-back, neighbour): fused,
                 composed, and fused again through the plain versions, one
                 seed: every step decodes; the read, the rpw read-out and
                 pending state, the new RAM and both reads after the write
                 bit-equal across the three; launches a step as counted
                 from the code
  vm_cycle       the port's own client at PARAMS_2_18_READOPT (keygen, RAM,
                 operands from --seed), then 6 chained vm_cycle calls, each
                 selecting another ALU op by its encrypted id and storing
                 another width at another offset at its own encrypted
                 pointer: rd, the fetched word, every stored word read back
                 and two untouched addresses decode under the noise bound;
                 launches per cycle; the VM kernels' launched shapes are the
                 checked ones; the four parts timed apart
  vm_cycle_vs_plain  the last cycle again through the plain versions on the
                 card: rd, fetched and the whole new RAM bit-equal
  composed_vm_cycle  5 chained vm_cycle calls on a two-pass context (the
                 composed routes: loops of keyed CMuxes, one fold a trace
                 step, merge and split level) at fresh pointers on the
                 vm_cycle phase's RAM: fetched and the new RAM bit-equal to
                 a fused cycle on the same inputs, rd decodes (full-gadget
                 select_rd); only kernels 1, 2 and 5, at the launches a
                 cycle counted from the code; composed_vm_cycle_ms beside
                 vm_cycle_ms
  composed_vm_vs_plain  the last composed cycle through the plain versions
  load           the port's own client makes the bootstrapping key of the
                 read phase's secret (8192 GGSWs, gadget of 5 limbs, flat
                 coefficient form: 7.5 GiB); a word FheRam.read fetches from
                 the RAM cell is decomposed by vm.bitdecomp.load_word into 32
                 bits (2 phases x 4096 keyed CMux steps): the word decodes,
                 its bit noise and selects of an encrypted 3 by lifted bits
                 0, 7, 13, 31 decode under the bound; launches a load as
                 counted from the code and the launched shapes the checked
                 ones; load_ms; then the key prepared once (22.5 GiB) and a
                 load on it, bit-equal
  load_vs_plain  the first 64 chain steps of that word on the production key
                 and amounts, then the trace, the affine and the lift of the
                 result, through the kernels and the plain versions: bit-equal
  composed_load  one load_word of the same fetched word on a two-pass
                 context (the coefficient key: no second prepared key): the
                 word and the prepared bits bit-equal to the fused load's;
                 only kernels 1, 2 and 5, at the launches counted from the
                 code and at checked shapes; then timed as the fused load
                 is (3 loads, host clock and CUDA events, each bit-equal)
  read_2_24      the port's own client at PARAMS_2_24_READOPT (keygen, 2^24 x
                 4 random bytes encrypted: 1.5 GiB of ciphertext), 4 reads at
                 distinct addresses through FheRam.read; each decodes
  sharded_read   the same 4 reads on a mesh of rows = 4 (parallel/mesh.py),
                 with collective="ring" and "exchange": every shard's output
                 equals the unsharded read bit for bit; launches per read
  sharded_batch  batched_read_fn at dp 1 x rows 4, a batch of 8, with and
                 without the cache, equal to 8 single reads; batched_rmw_fn at
                 dp 2 x rows 2, 4 distinct addresses, equal to FheRam.rmw_batch
                 on the read-outs and the whole new RAM
  sharded_rmw_batch_vs_plain  that batched_rmw_fn call again through the
                 plain versions on the card, collectives included: the
                 read-outs and every new data shard bit-equal
  dist           parallel/dist.py: two processes on this card joined by gloo
                 (fhe_ram_tpu_torch/examples/multihost_dryrun.py's workers,
                 the port only, under a time limit), each a dp 1 x rows 2
                 mesh of the read phase's RAM (global dp 2 x rows 2): one
                 batched read of 8 addresses and one batched RMW of 8 others
                 (words from --seed), launches counted and call shapes
                 recorded in the workers, 3 timed calls each; the reads equal
                 read_batch, the RMW's read-outs and every process's whole new
                 RAM equal the single-process batched_rmw_fn on a dp 2 x rows
                 2 mesh (held against the plain versions at every shape the
                 workers launched) and FheRam.rmw_batch; the words decode and
                 the new words read back; dist_read_ms, dist_rmw_batch_ms (max
                 over the processes, median of 3) beside the single process's,
                 and the RMW's int32 all_reduce alone (dist_all_reduce_ms);
                 the same workers run both paths again with composed=True:
                 bit-equal to their fused outputs and to the single-process
                 composed factories' (held against the plain versions at
                 every shape the workers launched), only kernels 1, 2, 5
                 and 13, at the launches counted from the code
  sharded_rmw    2 chained sharded_rmw_fn cycles, then a sharded_rpw_fn +
                 sharded_write_fn pair: each new RAM, un-permuted, equals the
                 unsharded read_prepare_write + write; old words out, new words
                 and 2 untouched addresses read back
  sharded_rmw_vs_plain  the first sharded_rmw_fn cycle again through the
                 plain versions on the card: every shard's read-out and
                 every new data shard bit-equal
  sharded_vs_plain  one sharded read again through the plain versions on the
                 card, collectives included: every shard's output bit-equal
  composed_sharded  every mesh factory with composed=True at the 2^24 cell:
                 the read at rows 4 (ring, exchange), one sharded_rmw_fn
                 cycle, an rpw + write pair, batched_read_fn of 8 (dp 1 x
                 rows 4) without and with the spectral cache, batched_rmw_fn
                 of 4 (dp 2 x rows 2): every output bit-equal to the fused
                 factory's; only kernels 1, 2, 5, 13, 14 at the counts
                 written in the code; times beside the fused calls'
  kernels        one line for all kernels: launches over the twenty-six paths,
                 error, time, the plain version's time, the card's bound, and
                 for the collectives the library call's time

The last line is {"ok": true, "device": {...}}.  Needs one CUDA device and
nvcc; imports fhe_ram_tpu_torch only.
"""

import argparse
import collections
import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

# The plain versions held against the 2^24 paths allocate single int64
# blocks of several GB with ~60 GB of the card in use; expandable segments
# keep the allocator's cache from fragmenting into pieces too small for
# them (a caller's own setting stands).
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402

# Peak rates of one H100 SXM at its full 700 W limit (NVIDIA's data sheet):
# device memory, and 32-bit arithmetic outside the tensor cores.  The
# kernels' arithmetic is 32-bit integer work on those units; the float32
# rate is the data sheet's figure for them (the integer rate is no higher),
# so a bound taken from it is a floor.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

CYCLES = 4       # read-modify-write cycles
BATCH = 16       # addresses of the batched read held against single reads
BIG_BATCH = 64   # addresses of one more, larger batched read
NB_RMW = 16      # addresses of the batched read-modify-write


_last_phase_end = [time.time()]


def emit(obj):
    """One JSON line; a phase's line also gets the seconds since the line
    before it (the phase's own wall time, its set-up included)."""
    if "phase" in obj:
        now = time.time()
        obj = {**obj, "phase_seconds": round(now - _last_phase_end[0], 2)}
        _last_phase_end[0] = now
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps, warm, flush):
    """Median time of one call in ms, by CUDA events; the L2 cache is
    overwritten before every timed call, as the read path would leave it."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        flush.add_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# -- the least time the card could take --------------------------------------
# Operations are counted in the ring Z_p: one modular multiply, add or
# subtract is one operation.  An n-point transform is (n/2) log2 n
# butterflies of 3 operations plus n twist multiplies; a fold's product is
# one multiply and one add per (digit poly, output poly, coefficient); the
# Garner step, the digit split and the carry are ~40 operations a
# reconstructed coefficient.

def ntt_ops(n):
    return 3 * (n // 2) * int(math.log2(n)) + n


def fold_ops(rows, T, M, n, P=3, spectral=False):
    """spectral: the digits come transformed, no forward transforms."""
    fwd = 0 if spectral else T * ntt_ops(n)
    return rows * (P * (fwd + M * (2 * T * n + ntt_ops(n))) + 40 * M * n)


def bound(bytes_moved, ops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- the VM cycle's kernels (9, 10, 11) --------------------------------------

VM_KERNELS = ("fused_bitwise", "fused_blind_rotate", "fused_dp_chain")
# chained cycles: the ALU op whose result rd must decode (the carry chain,
# the bitwise group, a compare, and the three shift kinds, one of them by
# the immediate), the store width and the byte offset of the store at the
# cycle's own pointer
VM_PLAN = (("add", "sb", 1), ("xor", "sh", 2), ("sltu", "sw", 0), ("sll", "sb", 3),
           ("srai", "sh", 0), ("srl", "none", 1))
# launches of one cycle, counted from the code: the carry chain and the
# bitwise group one each; blind rotations: select_rd, select_store and the
# pointer's two address digits; the shift group's word_from_bits and five
# barrel levels (batched folds); traces: the shift extraction, select_rd,
# select_store's two extractions and its clean-up, rpw, the byte repack,
# the write; folds, merges, splits and transforms of rpw and write, and the
# two transforms of the converted address
VM_CYCLE_LAUNCHES = dict(fused_dp_chain=1, fused_bitwise=1, fused_blind_rotate=4,
                         fused_external_fold_batched=6, fused_trace=8,
                         fused_external_fold=8, fused_pack_merge=6, fused_split=6,
                         ntt_fwd=4)


# the composed VM cycles (a two-pass context): the bitwise group, the carry
# chain, shifts by the immediate and by a register, every store width
COMPOSED_VM_PLAN = (("xor", "sw", 0), ("add", "sb", 3), ("srai", "sh", 2),
                    ("sltu", "none", 1), ("sll", "sw", 0))


def composed_vm_launches(par, bits, n_ops):
    """Launches of one composed vm_cycle (RVI32_OPS: both source groups in
    the bitwise and shift groups), counted from the code: keyed and batched
    folds -- the carry DP two a bit, the bitwise group a level a source group
    and one, word_from_bits and a barrel level a shift bit, select_rd one a
    op-id bit, select_store 4, the pointer one a bit; folds -- a trace step
    each (the shift extraction, select_rd's partial trace, select_store's
    two extractions and its clean-up, the byte repack), rpw (2 products, a
    merge a level, a trace) and write (a trace, 2 x 2 inversions, a split a
    level and the extraction's trace tail -- none where the rows' slots fill
    the ring, as at 2^18 --, 2 products); transforms -- the converted
    address's coordinates and the write's inverted ones."""
    lg, keep = par.log_n, bits.bit_length() - 1
    levels = par.num_rows.bit_length() - 1
    tail = 0 if par.num_rows << levels <= par.n else lg - levels
    n2 = len(par.base2d().rows)
    return dict(
        fused_external_fold_batched=(2 * bits + 3 + 1 + keep + (n_ops - 1).bit_length()
                                     + 4 + par.max_addr.bit_length() - 1),
        fused_external_fold=(lg + (lg - keep) + 2 * lg + (lg - keep) + (2 + levels + lg)
                             + lg + (lg + 2 * n2 + levels + tail + 2)),
        ntt_fwd=2 * n2)


# -- the row-sharded paths at PARAMS_2_24_READOPT (kernels 13, 14) ----------

BIG_READS = 4      # reads at 2^24, unsharded and on each mesh
SHARDS = 4         # rows shards of the single read, the RMW and the batched read
BIG_BATCH_READ = 8  # addresses of the sharded batched read (dp 1 x rows 4)
DP_RMW, ROWS_RMW, NB_BIG_RMW = 2, 2, 4  # the sharded batched RMW's mesh and batch

# -- the dist path (parallel/dist.py) at PARAMS_2_18_TURBO_READOPT ------------

DIST_PROCS = 2      # processes on the one card, joined by gloo
DIST_ROWS = 2       # rows shards a process (dp 1 a process: global dp 2 x rows 2)
DIST_BATCH = 8      # addresses of the dist batched read, and of the batched RMW
DIST_REPS = 3       # timed calls of each path in every worker
DIST_TIMEOUT_S = 300

# -- the composed chained-digit batched read at PARAMS_README_2_18 ------------

CHAINED_BATCH = 8   # addresses of the batched read (4 + 2 CMux digits of 3 bits)
DEMO_CONFIG = "2_14"   # fhe_ram_demo's --config: PARAMS_CODE_2_14
# (shards, pack roots a chunk[, stride]) of every collective launch on those
# paths, each held against its plain version: the single read's root at rows
# 4 (driven) and 2 and 8, a batch of 8 roots at rows 4, the batched RMW's 2
# roots a replica at rows 2; the exchange's two rounds at rows 4 (driven) and
# three at rows 8
COLLECTIVE_SHAPES = {
    "ring_all_gather": ((2, 1), (4, 1), (8, 1), (SHARDS, BIG_BATCH_READ),
                        (ROWS_RMW, NB_BIG_RMW // DP_RMW)),
    "exchange": ((4, 1, 1), (4, 1, 2), (8, 1, 1), (8, 1, 2), (8, 1, 4))}
COLLECTIVES = tuple(COLLECTIVE_SHAPES)


def collective_note(n_shards, chunk, stride=None):
    """The shape note of one collective call, the same for a check and for
    a recorded launch."""
    note = f"n={n_shards} chunk{list(chunk.shape)}"
    return note if stride is None else f"{note} stride={stride}"


def chunk_bytes(t):
    return t.numel() * t.element_size()


def alu_model(op, a, b, imm):
    """What rd must decode to, for the ops of VM_PLAN."""
    m = (1 << 32) - 1
    signed = a - (1 << 32) if a >> 31 else a
    return {"add": (a + b) & m, "xor": a ^ b, "sltu": int(a < b),
            "sll": (a << (b & 31)) & m, "srl": a >> (b & 31),
            "srai": (signed >> (imm & 31)) & m}[op]


def store_model(sop, offset, loaded, x):
    """The word a store of width sop at byte `offset` leaves: the loaded
    word with that field replaced by x's low bytes."""
    if sop == "none":
        return loaded
    field = ((1 << (8 * {"sb": 1, "sh": 2, "sw": 4}[sop])) - 1) << (8 * offset)
    return (loaded & ~field & ((1 << 32) - 1)) | ((x << (8 * offset)) & field)


def vm_note(name, *args):
    """The shape note of one call of a VM kernel's wrapper (its arguments
    after the context), the same for a check and for a recorded launch."""
    if name == "fused_blind_rotate":
        rows, keys, amounts = args
        return (f"rows{list(rows.shape)} keys{list(keys.shape)} "
                f"amounts={[int(a) for a in amounts]}")
    if name == "fused_dp_chain":
        F0, keys, deltas, op_tables, groups = args
        return (f"F0{list(F0.shape)} keys{list(keys.shape)} "
                f"groups={[list(g) for g in groups]}")
    hi, lo, keys, groups = args
    return (f"leaves{list(hi.shape)} keys{list(keys.shape)} "
            f"groups={[list(g) for g in groups]}")


def vm_shapes(par, vctx, limbs):
    """(name, note, arguments, (bytes, operations)) of every shape the VM
    cycle gives kernels 9-11 at `par`, random inputs of those shapes."""
    from fhe_ram_tpu_torch.ops import ntt_cuda
    from fhe_ram_tpu_torch.vm import arithmetic

    n, P, C2, L = par.n, par.num_primes, par.rank + 1, par.limbs_ct
    poly_b, bits = 4 * n, 8 * par.word_size
    Td, Lk = arithmetic._vm_trunc(par, bits)[0]
    T, M = C2 * Td, C2 * Lk

    def keys_of(lead, T_, M_):
        k = ntt_cuda.ntt_fwd_cuda(vctx, limbs(tuple(lead) + (T_, M_, n)))
        return k.permute(tuple(range(1, len(lead) + 1)) + (0,)
                         + tuple(range(len(lead) + 1, len(lead) + 4))).contiguous()

    out = []
    for kind, table in (("fused_bitwise", arithmetic._BITWISE_TABLES),
                        ("fused_dp_chain", arithmetic._DP_SPECS)):
        ops = [op for op in arithmetic.RVI32_OPS if op in table]
        _, groups = arithmetic._sources(ops, None, None)
        G, NG = len(ops), len(groups)
        keys = keys_of((bits, NG + 1), T, M)
        key_bytes = poly_b * bits * (NG + 1) * P * T * M
        if kind == "fused_bitwise":
            # the 2G leaf rows' digits are transformed once for all bits
            args = (limbs((G, 2, C2, L, n)), limbs((G, 2, C2, L, n)), keys, groups)
            work = (key_bytes + poly_b * (4 * G + bits * G) * C2 * L,
                    fold_ops(bits * G, T, M, n) + 2 * G * P * T * ntt_ops(n)
                    + fold_ops(2 * bits * G, T, M, n, spectral=True))
        else:
            tabs = tuple(arithmetic._DP_SPECS[op][:3] for op in ops)
            args = (limbs((G, 2, C2, L, n)), keys, limbs((bits, C2, L, n)), tabs,
                    groups)
            work = (key_bytes + poly_b * (4 * G + bits) * C2 * L,
                    bits * fold_ops(6 * G, T, M, n))
        out.append((kind, vm_note(kind, *args), args, work))
    # kernel 10: select_rd (the op id's 5 bits, truncated), select_store
    # (offset << 2 then op, full gadget), the pointer conversion's two
    # address digits (D*C rows of Lg limbs, the GGSW-apply bits)
    log_ops = (len(arithmetic.RVI32_OPS) - 1).bit_length()
    D, C = par.dnum_ct, par.rank + 1
    brots = [(1, L, T, M, [-(1 << k) for k in range(log_ops)]),
             (1, L, C * par.dnum_ct, C2 * par.limbs_ggsw, [-4, -8, -1, -2])]
    for width in [b for row in par.base2d().rows for b in row.bases]:
        brots.append((D * C, par.limbs_ggsw, C * par.dnum_ggsw,
                      C2 * par.limbs_evk_ggsw, [-(1 << j) for j in range(width)]))
    for B, Lc, T_, M_, amounts in brots:
        S = len(amounts)
        args = (limbs((B, C2, Lc, n)), keys_of((S,), T_, M_), amounts)
        out.append(("fused_blind_rotate", vm_note("fused_blind_rotate", *args),
                    args, (poly_b * (2 * B * C2 * Lc + S * P * T_ * M_),
                           S * fold_ops(B, T_, M_, n))))
    return out


# -- the VM LOAD's kernels (5, 1, 3, 2) at PARAMS_2_18_TURBO_READOPT -------

# the reference's production LOAD (scripts/bitdecomp_probe.py): 8-bit bytes
# in phases of 4 bits (load_word's, the default chunk of bytes_to_bits), a
# bootstrapping key with a gadget of 5 limbs in the flat coefficient form
# (7.5 GiB at N = 4096)
LOAD_BYTE_BITS, LOAD_CHUNK, LOAD_KEY_LIMBS = 8, 4, 5
LOAD_KEY_CHUNK = 512     # indicator GGSWs the client encrypts together
LOAD_TIMED = 3           # timed loads (host clock, median)
LOAD_PREFIX = 64         # chain steps held against the plain versions
LOAD_SELECT_BITS = (0, 7, 13, 31)
LOAD_TWO_PASS = " (two-pass context)"   # the note suffix of the composed LOAD's calls
# the wrappers on the LOAD's path (module attribute -> launch counter)
LOAD_WRAPPERS = {"fused_external_fold_batched": "fused_external_fold_batched",
                 "ntt_fwd_cuda": "ntt_fwd", "fused_trace": "fused_trace",
                 "fused_external_fold": "fused_external_fold"}


def load_note(*args, **kw):
    """The shape note of one call of a wrapper on the LOAD's path (its
    arguments after the context), the same for a check and for a recorded
    launch."""
    def one(a):
        return (f"[{','.join(map(str, a.shape))}]" if isinstance(a, torch.Tensor)
                else repr(a))
    return "LOAD " + " ".join([one(a) for a in args] + [
        f"{k}={one(v)}" for k, v in sorted(kw.items()) if v is not None])


def load_shapes(par, ctx, limbs):
    """(counter name, note, call, (bytes, operations)) of every shape the
    LOAD gives kernels 5, 1, 3 and 2 at `par` on ctx's route, random inputs
    of those shapes: a chain step's keyed product (the row's two GGSWs
    against the 2 x K rotated accumulators) and its key pair's transform, a
    phase's trace of K accumulators (on a two-pass context one fold a
    step: the composed route), and the lift (every bit's row against the
    tensor key, then the transform of the lifted stack).  A two-pass
    context's notes end in LOAD_TWO_PASS."""
    from fhe_ram_tpu_torch.ops import ntt_cuda
    from fhe_ram_tpu_torch.vm import bitdecomp

    n, P, C, L, rank = par.n, par.num_primes, par.rank + 1, par.limbs_ct, par.rank
    D, Dg, Lgk, Lk, S = par.dnum_ct, par.dnum_ggsw, par.limbs_evk_ggsw, par.limbs_evk_trace, par.log_n
    poly_b, bits = 4 * n, LOAD_BYTE_BITS * par.word_size
    K = par.word_size * LOAD_CHUNK * bitdecomp._LIFT_ROWS   # tests a phase
    body = LOAD_TWO_PASS if ctx.body == "two_pass" else ""

    def spectra(shape):
        return ntt_cuda.ntt_fwd_cuda(ctx, limbs(shape))

    out = []
    T5, M5 = C * D, C * LOAD_KEY_LIMBS
    x5 = limbs((2, K, T5, n))
    k5 = spectra((2, 1, T5, M5, n)).permute(1, 0, 2, 3, 4, 5).contiguous()
    out.append(("fused_external_fold_batched",
                load_note(x5, k5, L, C, base=None, sign=1) + body,
                lambda: ntt_cuda.fused_external_fold_batched(ctx, x5, k5, L, C,
                                                             base=None, sign=1),
                (poly_b * (2 * K * T5 + 2 * P * T5 * M5 + 2 * K * C * L),
                 fold_ops(2 * K, T5, M5, n))))
    for shape in ((2, D, C, C, LOAD_KEY_LIMBS, n), (bits, bitdecomp._LIFT_ROWS, C, C,
                                                    par.limbs_ggsw, n)):
        x1 = limbs(shape)
        polys = x1.numel() // n
        out.append(("ntt_fwd", load_note(x1) + body,
                    lambda x1=x1: ntt_cuda.ntt_fwd_cuda(ctx, x1),
                    (polys * poly_b * (1 + P), polys * P * ntt_ops(n))))
    T3, M3 = rank * D, C * Lk
    ct3 = limbs((K, C, L, n))
    if body:
        # a trace step: the automorphed mask's digits against one key, the
        # row and the automorphed body as the base
        x3, b3 = limbs((K, T3, n)), limbs((K, C, L, n), bits=17)
        k3 = spectra((1, T3, M3, n))
        out.append(("fused_external_fold",
                    load_note(x3, k3, L, C, base=b3, sign=-1) + body,
                    lambda: ntt_cuda.fused_external_fold(ctx, x3, k3, L, C, base=b3,
                                                         sign=-1),
                    (poly_b * (K * T3 + P * T3 * M3 + 2 * K * C * L),
                     fold_ops(K, T3, M3, n))))
    else:
        k3 = spectra((S, T3, M3, n)).permute(1, 0, 2, 3, 4).contiguous()
        gals = tuple(par.trace_gal_els[:S])
        out.append(("fused_trace", load_note(ct3, k3, gals),
                    lambda: ntt_cuda.fused_trace(ctx, ct3, k3, gals),
                    (poly_b * (2 * K * C * L + S * P * T3 * M3),
                     S * fold_ops(K, T3, M3, n))))
    T2, M2, Lg = C * Dg, C * Lgk, par.limbs_ggsw
    x2 = limbs((bits, T2, n))
    k2 = spectra((1, T2, M2, n))
    out.append(("fused_external_fold", load_note(x2, k2, Lg, C) + body,
                lambda: ntt_cuda.fused_external_fold(ctx, x2, k2, Lg, C),
                (poly_b * (bits * T2 + P * T2 * M2 + bits * C * Lg), fold_ops(bits, T2, M2, n))))
    return out


# -- PARAMS_README_2_18's read and write cycle (kernels 2 and 1) -------------

README_READS = 8     # fused reads at distinct addresses


def readme_shapes(par, ctx, limbs):
    """(counter name, note, call, (bytes, operations)) of the shapes of
    kernels 2 and 1 a read and a write cycle at `par` (chained CMux digits
    of the full gadget, no truncation) launch and the other presets' paths
    do not: each level's digit chain (the read's and rpw's, the write's
    delta and update), the GGSW inversion's keyswitch and tensor-key
    product (one GGSW digit's rows), and the transform of an inverted
    coordinate; random inputs of those shapes."""
    from fhe_ram_tpu_torch.ops import ntt_cuda

    n, P, C, L, rank = par.n, par.num_primes, par.rank + 1, par.limbs_ct, par.rank
    D, Lg, Lgk = par.dnum_ct, par.limbs_ggsw, par.limbs_evk_ggsw
    poly_b = 4 * n
    out = []
    T, M = C * L, C * Lg
    for rows, row in zip((par.word_size * par.num_rows, par.word_size),
                         par.base2d().rows):
        dig = len(row.bases)
        x = limbs((rows, T, n))
        k = ntt_cuda.ntt_fwd_cuda(ctx, limbs((dig, T, M, n)))
        out.append(("fused_external_fold",
                    f"x[{rows},{T},{n}] keys[{P},{dig},{T},{M},{n}] ({dig} chained "
                    "digits, full gadget)",
                    lambda x=x, k=k: ntt_cuda.fused_external_fold(ctx, x, k, L, C),
                    (poly_b * (rows * T + P * dig * T * M + rows * C * L),
                     dig * fold_ops(rows, T, M, n))))
    # the inversion of one digit's GGSW: its D b-rows keyswitched (Lg input
    # digits, Lgk key limbs, out Lg limbs, base and sign -1), then the
    # tensor-key product of the result
    T_ks, T_tk, M_i = rank * Lg, C * Lg, C * Lgk
    x_ks, b_ks = limbs((D, T_ks, n)), limbs((D, C, Lg, n), bits=17)
    k_ks = ntt_cuda.ntt_fwd_cuda(ctx, limbs((1, T_ks, M_i, n)))
    out.append(("fused_external_fold",
                f"x[{D},{T_ks},{n}] keys[{P},1,{T_ks},{M_i},{n}] out_limbs={Lg} base, "
                "sign=-1 (GGSW inversion keyswitch, full gadget)",
                lambda: ntt_cuda.fused_external_fold(ctx, x_ks, k_ks, Lg, C, base=b_ks,
                                                     sign=-1),
                (poly_b * (D * T_ks + P * T_ks * M_i + 2 * D * C * Lg),
                 fold_ops(D, T_ks, M_i, n))))
    x_tk = limbs((D, T_tk, n))
    k_tk = ntt_cuda.ntt_fwd_cuda(ctx, limbs((1, T_tk, M_i, n)))
    out.append(("fused_external_fold",
                f"x[{D},{T_tk},{n}] keys[{P},1,{T_tk},{M_i},{n}] out_limbs={Lg} "
                "(GGSW inversion tensor key, full gadget)",
                lambda: ntt_cuda.fused_external_fold(ctx, x_tk, k_tk, Lg, C),
                (poly_b * (D * T_tk + P * T_tk * M_i + D * C * Lg),
                 fold_ops(D, T_tk, M_i, n))))
    for row in par.base2d().rows:
        x1 = limbs((len(row.bases), D, C, C, Lg, n))
        polys = x1.numel() // n
        out.append(("ntt_fwd", f"x{list(x1.shape)} (an inverted coordinate)",
                    lambda x1=x1: ntt_cuda.ntt_fwd_cuda(ctx, x1),
                    (polys * poly_b * (1 + P), polys * P * ntt_ops(n))))
    return out


def rmw_cycle_launches(par, composed=False):
    """Launches of one FheRam.read (read_prepare_write the same) and of one
    write at `par` (two address levels, the rows in one pack chunk),
    counted from the code.  Fused: a fold a level (its digit chain in the
    launch), a merge a pack level, a trace; the write a trace, the delta's
    and the update's products, 1 + rank folds a digit of either coordinate
    (its GGSW inversion: the keyswitch, the tensor-key products), a
    transform a coordinate, a split a level.  Composed: each merge, trace
    step and split level one fold instead of its kernel."""
    levels = (par.num_rows - 1).bit_length()
    inv = (1 + par.rank) * sum(len(r.bases) for r in par.base2d().rows)
    if composed:
        return (dict(fused_external_fold=par.n2 + levels + par.log_n),
                dict(fused_external_fold=par.log_n + inv + levels + 2, ntt_fwd=par.n2))
    return (dict(fused_external_fold=par.n2, fused_pack_merge=levels, fused_trace=1),
            dict(fused_trace=1, fused_external_fold=2 + inv, ntt_fwd=par.n2,
                 fused_split=levels))


def word_noise(par, ctx, s_ntt, out, want_bytes, what):
    """The worst log2 noise of the word `out` [W, C, L, N], every byte of
    which must decode to want_bytes' under the bound; fails otherwise."""
    from fhe_ram_tpu_torch.core import glwe

    ph = glwe.phase(par, ctx, s_ntt, out)
    worst = -1e9
    for i in range(par.word_size):
        want = glwe.cast_u8_signed(int(want_bytes[i]), par.k_pt)
        val, noise = glwe.decode_coeff0(par, ph[i], want)
        if int(val) != want or not noise < -(par.k_pt + 1):
            fail(f"{what}, byte {i}: decoded {int(val)} (noise 2^{float(noise):.2f}), "
                 f"stored {want}")
        worst = max(worst, float(noise))
    return worst


def vm_call(ctx, name, args):
    from fhe_ram_tpu_torch.ops import ntt_cuda

    fn = getattr(ntt_cuda, name)
    return lambda: fn(ctx, *args)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reads", type=int, default=8)
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (a first look at new kernels)")
    ap.add_argument("--profile", action="store_true",
                    help="trace one more read, write cycle, batched read, "
                         "batched read-modify-write, VM cycle, LOAD, 2^24 read, "
                         "sharded reads (ring, exchange) and sharded RMW with "
                         "torch.profiler: device time by kernel and the "
                         "device's idle share")
    ap.add_argument("--verbose-build", action="store_true",
                    help="print what ptxas says of each kernel (registers, spills)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script runs on the GPU only",
              file=sys.stderr)
        sys.exit(2)

    from fhe_ram_tpu_torch.params import PARAMS_2_18_TURBO_READOPT as PAR
    from fhe_ram_tpu_torch.params import PARAMS_2_18_READOPT as VPAR
    from fhe_ram_tpu_torch.params import PARAMS_2_24_READOPT as BPAR
    from fhe_ram_tpu_torch.params import PARAMS_README_2_18 as CPAR
    from fhe_ram_tpu_torch.examples import fhe_ram_demo
    from fhe_ram_tpu_torch.examples import multihost_dryrun as dryrun
    from fhe_ram_tpu_torch.parallel import collective as coll_mod
    from fhe_ram_tpu_torch.parallel import mesh as mesh_mod
    from fhe_ram_tpu_torch.ops import limb as limb_ops
    from fhe_ram_tpu_torch.ops import ntt_cuda
    from fhe_ram_tpu_torch.ops.crt import crt_fold
    from fhe_ram_tpu_torch.ops.ntt import get_ntt_context
    from fhe_ram_tpu_torch.core import glwe, keys as keys_mod, rng
    from fhe_ram_tpu_torch.ram import address as address_mod
    from fhe_ram_tpu_torch.ram import ram as ram_mod
    from fhe_ram_tpu_torch.convert import stack_addresses

    t_start = time.time()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- device ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ---- build -------------------------------------------------------------
    # the predecessors of kernels 1, 7, 8, 9, 12 and 14
    # (fhe_ram_tpu_torch/tools/), held bit-equal to them below, build beside
    # the kernels (one nvcc a source: none is built twice), each nvcc
    # started before the first is awaited
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "fhe_ram_tpu_torch", "tools"))
    import time_bitwise_split_tree_predecessors as preds
    import time_external_exchange_predecessors as preds13
    import time_pack_tree_ntt_predecessors as preds12
    t0 = time.time()
    pred_jobs, pred12_jobs, pred13_jobs = preds.start(), preds12.start(), preds13.start()
    ntt_cuda.ensure_built(verbose=args.verbose_build)
    pred, pred12 = preds.finish(pred_jobs), preds12.finish(pred12_jobs)
    pred13 = preds13.finish(pred13_jobs)
    emit({"phase": "build", "ok": True, "seconds": round(time.time() - t0, 2),
          "sources": [f"fhe_ram_tpu_torch/csrc/{s}.cu" for s in ntt_cuda.SOURCES],
          "predecessors": sorted({f"fhe_ram_tpu_torch/tools/{spec[0]}" for spec in
                                  (*preds.SPECS.values(), *preds12.SPECS.values(),
                                   *preds13.SPECS.values())}),
          "target": "sm_90a"})

    # ---- each kernel against its plain version, at the read's shapes -------
    n, P = PAR.n, PAR.num_primes
    W, R, C, L = PAR.word_size, PAR.num_rows, PAR.rank + 1, PAR.limbs_ct
    rank = PAR.rank
    Dk, Lkk = PAR.read_ks_trunc        # keyswitch: 2 digits, 3 key limbs
    De, Lge = PAR.read_ep_trunc        # external product: 2 digits, 3 limbs
    T_ep, M_ep = C * De, C * Lge       # 4, 6
    T_ks, M_ks = rank * Dk, C * Lkk    # 2, 6
    S = PAR.log_n
    ctx = get_ntt_context(n, PAR.primes)
    tctx = get_ntt_context(n, PAR.primes, "two_pass")   # the composed routes' body
    gen = torch.Generator(device="cpu").manual_seed(args.seed)
    flush = torch.zeros(64 << 20, dtype=torch.int32, device=dev)  # 256 MB

    def limbs(shape, bits=16):
        return torch.randint(-(1 << bits), 1 << bits, shape, generator=gen,
                             dtype=torch.int32).to(dev)

    def spectra(shape):
        """Prepared key rows: the transform of random normalized limbs."""
        return ntt_cuda.ntt_fwd_cuda(ctx, limbs(shape))

    checks = {}
    poly_b = 4 * n  # bytes of one int32 polynomial

    def check(name, shape_note, kernel_fn, reps=7, plain_reps=3,
              per_level_fn=None, work=None, library_fn=None, same_as=None,
              predecessor_fn=None):
        """Run kernel and plain version on the same tensors; compare; time.
        kernel_fn returns one tensor or a tuple of them.  per_level_fn: the
        same function as a sequence of per-level kernel launches (a tree
        kernel's yardstick); held bit-equal and timed as well.  work: (bytes
        moved, operations) of this shape, for its bound beside its time.
        library_fn: one PyTorch call that computes the same function, timed
        beside it (never used by the port).  same_as: the same call in the
        other transform body, held bit-equal (spectra included).
        predecessor_fn: the same call through the kernel's predecessor
        (fhe_ram_tpu_torch/tools/), held bit-equal and timed."""
        def outputs(fn):
            out = fn()
            torch.cuda.synchronize()
            return out if isinstance(out, tuple) else (out,)
        got = outputs(kernel_fn)
        with ntt_cuda.plain_versions():
            want = outputs(kernel_fn)
        err, ok = 0, len(got) == len(want)
        for g_, w_ in zip(got, want):
            if g_.shape != w_.shape or g_.dtype != w_.dtype:
                fail(f"{name} {shape_note}: shape/dtype {g_.shape} {g_.dtype}")
            err = max(err, int((g_.to(torch.int64) - w_.to(torch.int64)).abs().max()))
            ok = ok and torch.equal(g_, w_)
        del want
        ms = time_ms(kernel_fn, reps, 2, flush)
        with ntt_cuda.plain_versions():
            plain_ms = time_ms(kernel_fn, plain_reps, 1, flush)
        rec = {"shape": shape_note, "ok": ok, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms}
        if work is not None:
            rec["bound_ms"], rec["bound_by"] = bound(*work)
        if library_fn is not None:
            rec["library_ms"] = time_ms(library_fn, reps, 2, flush)
        if per_level_fn is not None:
            levels = outputs(per_level_fn)
            ok = ok and all(torch.equal(a, b) for a, b in zip(got, levels))
            del levels
            rec.update(ok=ok, per_level_ms=time_ms(per_level_fn, reps, 2, flush))
        if predecessor_fn is not None:
            rec["equal_to_predecessor"] = all(
                torch.equal(a, b) for a, b in zip(got, outputs(predecessor_fn)))
            ok = rec["ok"] = ok and rec["equal_to_predecessor"]
            rec["predecessor_ms"] = time_ms(predecessor_fn, reps, 2, flush)
        if same_as is not None:
            rec["equal_to_radix2"] = all(
                torch.equal(a, b) for a, b in zip(got, outputs(same_as)))
            ok = rec["ok"] = ok and rec["equal_to_radix2"]
        checks.setdefault(name, []).append(rec)
        if not ok:
            emit({"phase": "kernel_check", "name": name, **rec})
            fail(f"{name} {shape_note} disagrees with its plain version "
                 f"(max abs err {err})")
        return rec

    # kernel 1 (one build for both contexts): both directions at B = 36 (one
    # address coordinate's GGSW) and at the batched read's level-0 digits
    # (x0, the 1024 digit polys of kernel 2's level 0 below), each under
    # both contexts, the two-pass context's call bit-equal to the radix-2
    # one's; beside each, the predecessor in that context's body
    def check_ntt(direction, x_):
        B_ = x_.shape[-2]
        wrap = getattr(ntt_cuda, f"ntt_{direction}_cuda")
        note = f"x{list(x_.shape)}"
        for c_, body in ((ctx, "radix2"), (tctx, "two_pass")):
            check(f"ntt_{direction}", note if c_ is ctx else f"{note} (two-pass context)",
                  lambda: wrap(c_, x_),
                  same_as=(lambda: wrap(ctx, x_)) if c_ is tctx else None,
                  plain_reps=1 if B_ > 36 else 3,
                  work=(B_ * poly_b * (1 + P), B_ * P * ntt_ops(n)) if direction == "fwd"
                  else (B_ * poly_b * 2 * P, B_ * P * ntt_ops(n)),
                  predecessor_fn=preds12.ntt_predecessor(pred12[f"ntt_{body}"], c_,
                                                         direction, x_))

    x36 = limbs((36, n), bits=21)
    x0 = limbs((W * R, T_ep, n))
    for x_ in (x36, x0.reshape(-1, n)):
        check_ntt("fwd", x_)
        check_ntt("inv", ntt_cuda.ntt_fwd_cuda(ctx, x_))

    # kernel 2: level 0 (B = W*R = 256) without and with base, level 1 (B = 4)
    keys_ep = spectra((1, T_ep, M_ep, n)).reshape(P, 1, T_ep, M_ep, n)
    base0 = limbs((W * R, C, L, n), bits=17)
    check("fused_external_fold", f"x[{W*R},{T_ep},4096] keys[3,1,{T_ep},{M_ep},4096]",
          lambda: ntt_cuda.fused_external_fold(ctx, x0, keys_ep, L, C))
    check("fused_external_fold", f"x[{W*R},{T_ep},4096] with base, sign=-1",
          lambda: ntt_cuda.fused_external_fold(ctx, x0, keys_ep, L, C,
                                               base=base0, sign=-1))
    x1 = limbs((W, T_ep, n))
    check("fused_external_fold", f"x[{W},{T_ep},4096] (level 1)",
          lambda: ntt_cuda.fused_external_fold(ctx, x1, keys_ep, L, C))
    # two chained digits (T == C*L), a shape the narrow-digit presets use
    keys_ch = spectra((2, C * L, C * Lge, n)).reshape(P, 2, C * L, C * Lge, n)
    xch = limbs((W, C * L, n))
    check("fused_external_fold", f"x[{W},{C*L},4096] two chained digits",
          lambda: ntt_cuda.fused_external_fold(ctx, xch, keys_ch, L, C))

    # kernel 3: the 12-step trace of W = 4 rows
    gals = PAR.trace_gal_els
    keys_tr = spectra((S, T_ks, M_ks, n)).permute(1, 0, 2, 3, 4).contiguous()
    ct4 = limbs((W, C, L, n))
    check("fused_trace", f"ct[{W},{C},{L},4096] keys[{S},3,{T_ks},{M_ks},4096]",
          lambda: ntt_cuda.fused_trace(ctx, ct4, keys_tr, gals), plain_reps=2)

    # kernel 4: first (nb = 128, unnormalized inputs) and last (nb = 4) level
    key_pm = spectra((T_ks, M_ks, n))
    for nb, l in ((W * R // 2, 5), (W, 0)):
        A, Bc = limbs((nb, C, L, n), bits=17), limbs((nb, C, L, n), bits=17)
        t_rot, g = 1 << l, (n >> l) + 1
        check("fused_pack_merge", f"A,B[{nb},{C},{L},4096] t={t_rot} g={g}",
              lambda: ntt_cuda.fused_pack_merge(ctx, A, Bc, t_rot, g, key_pm),
              work=(poly_b * (3 * nb * C * L + P * T_ks * M_ks),
                    fold_ops(nb, T_ks, M_ks, n)))

    # -- the shapes the write cycle and the batched read add ----------------
    Lkf = PAR.limbs_evk_trace          # untruncated keyswitch: 4 key limbs
    T_kf, M_kf = rank * L, C * Lkf     # 3, 8
    T_ef, M_ef = C * PAR.dnum_ct, C * PAR.limbs_ggsw   # full gadget: 6, 6
    Lg, Lgk = PAR.limbs_ggsw, PAR.limbs_evk_ggsw       # 3, 5
    NA = 8                             # addresses of the batched checks

    # kernel 2 with spectral input (what a cached single read launches), the
    # same with two chained digits, the full-gadget shapes of rpw / write,
    # and the two folds of the GGSW inversion (5 key limbs folded to 3)
    s0 = ntt_cuda.ntt_fwd_cuda(ctx, x0)            # [3, 256, 4, N]
    check("fused_external_fold", f"x_is_ntt x[3,{W*R},{T_ep},4096]",
          lambda: ntt_cuda.fused_external_fold(ctx, s0, keys_ep, L, C,
                                               x_is_ntt=True))
    sch = ntt_cuda.ntt_fwd_cuda(ctx, xch)
    check("fused_external_fold", f"x_is_ntt x[3,{W},{C*L},4096] two chained digits",
          lambda: ntt_cuda.fused_external_fold(ctx, sch, keys_ch, L, C,
                                               x_is_ntt=True))
    keys_ef = spectra((1, T_ef, M_ef, n)).reshape(P, 1, T_ef, M_ef, n)
    for B_ in (W * R, W):
        xf = limbs((B_, T_ef, n))
        check("fused_external_fold", f"x[{B_},{T_ef},4096] keys[3,1,{T_ef},{M_ef},4096] (full gadget)",
              lambda: ntt_cuda.fused_external_fold(ctx, xf, keys_ef, L, C))
    D_ = PAR.dnum_ggsw
    keys_ak = spectra((1, rank * D_, C * Lgk, n)).reshape(P, 1, rank * D_, C * Lgk, n)
    xak, bak = limbs((D_, rank * D_, n)), limbs((D_, C, Lg, n), bits=17)
    check("fused_external_fold", f"x[{D_},{rank*D_},4096] keys[3,1,{rank*D_},{C*Lgk},4096] base, sign=-1 (inversion keyswitch)",
          lambda: ntt_cuda.fused_external_fold(ctx, xak, keys_ak, Lg, C,
                                               base=bak, sign=-1))
    keys_ts = spectra((1, C * D_, C * Lgk, n)).reshape(P, 1, C * D_, C * Lgk, n)
    xts = limbs((D_, C * D_, n))
    check("fused_external_fold", f"x[{D_},{C*D_},4096] keys[3,1,{C*D_},{C*Lgk},4096] out_limbs={Lg} (tensor key)",
          lambda: ntt_cuda.fused_external_fold(ctx, xts, keys_ts, Lg, C))

    # kernel 5: level 0 of a batched read (shared spectra, per-address keys)
    # and level 1 (per-address rows), with base and sign once
    keys_b = spectra((NA, 1, T_ep, M_ep, n)).permute(1, 0, 2, 3, 4, 5).contiguous()
    check("fused_external_fold_batched",
          f"x_is_ntt x[3,{W*R},{T_ep},4096] keys[{NA},3,1,{T_ep},{M_ep},4096] (level 0)",
          lambda: ntt_cuda.fused_external_fold_batched(ctx, s0, keys_b, L, C,
                                                       x_is_ntt=True),
          plain_reps=2)
    xb1 = limbs((NA, W, T_ep, n))
    check("fused_external_fold_batched",
          f"x[{NA},{W},{T_ep},4096] keys[{NA},3,1,{T_ep},{M_ep},4096] (level 1)",
          lambda: ntt_cuda.fused_external_fold_batched(ctx, xb1, keys_b, L, C))
    bb1 = limbs((NA, W, C, L, n), bits=17)
    check("fused_external_fold_batched",
          f"x[{NA},{W},{T_ep},4096] with base, sign=-1",
          lambda: ntt_cuda.fused_external_fold_batched(ctx, xb1, keys_b, L, C,
                                                       base=bb1, sign=-1))

    # kernel 12 (one build for both contexts; on no path: held here alone)
    # at a small shape and the read's level-0 shape, under both contexts,
    # the two-pass context's call bit-equal to the radix-2 one's; beside
    # each, the predecessor in that context's body; and the relation the
    # JAX package's own test pins: normalize(crt_fold(kernel 12)) == kernel
    # 2 without a base
    for B_, T_, M_ in ((2, 3, 2), (W * R, T_ep, M_ep)):
        x12 = limbs((B_, T_, n))
        k12 = spectra((T_, M_, n))
        note = f"x[{B_},{T_},4096] keys[3,{T_},{M_},4096]"
        for c_, body in ((ctx, "radix2"), (tctx, "two_pass")):
            check("fused_external", note if c_ is ctx else f"{note} (two-pass context)",
                  lambda: ntt_cuda.fused_external(c_, x12, k12),
                  same_as=(lambda: ntt_cuda.fused_external(ctx, x12, k12))
                  if c_ is tctx else None,
                  plain_reps=2 if B_ > 2 else 3,
                  work=(poly_b * (B_ * T_ + P * T_ * M_ + P * B_ * M_),
                        B_ * P * (T_ * ntt_ops(n) + M_ * (2 * T_ * n + ntt_ops(n)))),
                  predecessor_fn=preds13.external_predecessor(
                      pred13[f"external_{body}"], c_, x12, k12))
    for c_ in (ctx, tctx):
        folded = limb_ops.normalize(crt_fold(
            PAR.primes, ntt_cuda.fused_external(c_, x12, k12).reshape(P, W * R, C, Lge, n),
            17, L))
        if not torch.equal(folded, ntt_cuda.fused_external_fold(c_, x12, k12[:, None], L, C)):
            fail(f"fused_external ({c_.body}): crt_fold + normalize differs from "
                 "fused_external_fold")
    del x12, k12, folded

    # kernels 3 and 4 with the untruncated keyswitch key (rpw / write)
    keys_trf = spectra((S, T_kf, M_kf, n)).permute(1, 0, 2, 3, 4).contiguous()
    check("fused_trace", f"ct[{W},{C},{L},4096] keys[{S},3,{T_kf},{M_kf},4096] (untruncated)",
          lambda: ntt_cuda.fused_trace(ctx, ct4, keys_trf, gals), plain_reps=2)
    key_kf = spectra((T_kf, M_kf, n))
    for nb, l in ((W * R // 2, 5), (W, 0)):
        A, Bc = limbs((nb, C, L, n), bits=17), limbs((nb, C, L, n), bits=17)
        t_rot, g = 1 << l, (n >> l) + 1
        check("fused_pack_merge", f"A,B[{nb},{C},{L},4096] t={t_rot} g={g} key[3,{T_kf},{M_kf},4096] (untruncated)",
              lambda: ntt_cuda.fused_pack_merge(ctx, A, Bc, t_rot, g, key_kf),
              work=(poly_b * (3 * nb * C * L + P * T_kf * M_kf),
                    fold_ops(nb, T_kf, M_kf, n)))

    # -- the shapes a batch of NB_RMW addresses gives the same wrappers -------
    # kernel 5 with the full gadget and one key an address, as the batched
    # read-modify-write launches it: level 0 (shared spectra, NB_RMW x 256
    # rows, so each row group walks several rows), level 1 and d_lo (W rows
    # an address), upd (256 rows an address with their own transforms)
    keys_bf = spectra((NB_RMW, 1, T_ef, M_ef, n)).permute(
        1, 0, 2, 3, 4, 5).contiguous()
    sf0 = ntt_cuda.ntt_fwd_cuda(ctx, limbs((W * R, T_ef, n)))
    key_polys = NB_RMW * P * T_ef * M_ef
    check("fused_external_fold_batched",
          f"x_is_ntt x[3,{W*R},{T_ef},4096] keys[{NB_RMW},3,1,{T_ef},{M_ef},4096] (rmw_batch level 0)",
          lambda: ntt_cuda.fused_external_fold_batched(ctx, sf0, keys_bf, L, C,
                                                       x_is_ntt=True),
          plain_reps=1,
          work=(poly_b * (P * W * R * T_ef + key_polys + NB_RMW * W * R * C * L),
                fold_ops(NB_RMW * W * R, T_ef, M_ef, n, spectral=True)))
    del sf0
    xbf1 = limbs((NB_RMW, W, T_ef, n))
    check("fused_external_fold_batched",
          f"x[{NB_RMW},{W},{T_ef},4096] keys[{NB_RMW},3,1,{T_ef},{M_ef},4096] (rmw_batch level 1, d_lo)",
          lambda: ntt_cuda.fused_external_fold_batched(ctx, xbf1, keys_bf, L, C),
          work=(poly_b * (NB_RMW * W * (T_ef + C * L) + key_polys),
                fold_ops(NB_RMW * W, T_ef, M_ef, n)))
    xbu = limbs((NB_RMW, W * R, T_ef, n))
    check("fused_external_fold_batched",
          f"x[{NB_RMW},{W*R},{T_ef},4096] keys[{NB_RMW},3,1,{T_ef},{M_ef},4096] (rmw_batch upd)",
          lambda: ntt_cuda.fused_external_fold_batched(ctx, xbu, keys_bf, L, C),
          plain_reps=1,
          work=(poly_b * (NB_RMW * W * R * (T_ef + C * L) + key_polys),
                fold_ops(NB_RMW * W * R, T_ef, M_ef, n)))
    del xbu, keys_bf
    # kernel 2: the two folds of the GGSW inversion over all NB_RMW addresses
    nbi = NB_RMW * D_
    xak, bak = limbs((nbi, rank * D_, n)), limbs((nbi, C, Lg, n), bits=17)
    check("fused_external_fold", f"x[{nbi},{rank*D_},4096] keys[3,1,{rank*D_},{C*Lgk},4096] base, sign=-1 (batched inversion keyswitch)",
          lambda: ntt_cuda.fused_external_fold(ctx, xak, keys_ak, Lg, C,
                                               base=bak, sign=-1),
          work=(poly_b * (nbi * (rank * D_ + 2 * C * Lg) + P * rank * D_ * C * Lgk),
                fold_ops(nbi, rank * D_, C * Lgk, n)))
    xts = limbs((nbi, C * D_, n))
    check("fused_external_fold", f"x[{nbi},{C*D_},4096] keys[3,1,{C*D_},{C*Lgk},4096] out_limbs={Lg} (batched tensor key)",
          lambda: ntt_cuda.fused_external_fold(ctx, xts, keys_ts, Lg, C),
          work=(poly_b * (nbi * (C * D_ + C * Lg) + P * C * D_ * C * Lgk),
                fold_ops(nbi, C * D_, C * Lgk, n)))
    # kernel 2 at the 2^24 read's level 0 (16,384 rows, the read truncation
    # of PARAMS_2_24_READOPT: the same T and M), timed only: the read_2_24
    # phase holds that launch against the sharded read, and sharded_vs_plain
    # the sharded read against the plain versions
    BR = BPAR.num_rows * BPAR.word_size
    xbig = torch.randint(-(1 << 16), 1 << 16, (BR, T_ep, n), dtype=torch.int32,
                         device=dev, generator=torch.Generator(device=dev).manual_seed(
                             args.seed + 2))
    fbig = (lambda: ntt_cuda.fused_external_fold(ctx, xbig, keys_ep, L, C))
    big_bound = bound(poly_b * (BR * T_ep + P * T_ep * M_ep + BR * C * L),
                      fold_ops(BR, T_ep, M_ep, n))
    timed_only = {"fused_external_fold": [{
        "shape": f"x[{BR},{T_ep},4096] keys[3,1,{T_ep},{M_ep},4096] (2^24 read level 0)",
        "ms": time_ms(fbig, 5, 1, flush), "bound_ms": big_bound[0],
        "bound_by": big_bound[1],
        "held_by": "read_2_24 == sharded_read == sharded_vs_plain"}]}
    del xbig, fbig
    # kernel 4 at the 2^24 read's first merge level (8192 row pairs, t =
    # 2^11, g = 3, the read's key), timed only, held as the fold above is
    bgen = torch.Generator(device=dev).manual_seed(args.seed + 3)
    Abig, Bbig = (torch.randint(-(1 << 17), 1 << 17, (BR // 2, C, L, n), dtype=torch.int32,
                                device=dev, generator=bgen) for _ in range(2))
    mbig = (lambda: ntt_cuda.fused_pack_merge(ctx, Abig, Bbig, 1 << 11, (n >> 11) + 1, key_pm))
    mbig_bound = bound(poly_b * (3 * (BR // 2) * C * L + P * T_ks * M_ks),
                       fold_ops(BR // 2, T_ks, M_ks, n))
    timed_only["fused_pack_merge"] = [{
        "shape": f"A,B[{BR // 2},{C},{L},4096] t=2048 g={(n >> 11) + 1} (2^24 read level 0)",
        "ms": time_ms(mbig, 5, 1, flush), "bound_ms": mbig_bound[0],
        "bound_by": mbig_bound[1],
        "held_by": "read_2_24 == sharded_read == sharded_vs_plain"}]
    del Abig, Bbig, mbig

    # kernels 3 and 4 with the batch folded into the row axis: the trace of
    # NB_RMW x W roots and the first merge level of NB_RMW x W x 32 pairs,
    # untruncated (rmw_batch) and truncated (read_batch)
    ctb = limbs((NB_RMW * W, C, L, n))
    check("fused_trace", f"ct[{NB_RMW*W},{C},{L},4096] keys[{S},3,{T_kf},{M_kf},4096] (untruncated, batch of {NB_RMW})",
          lambda: ntt_cuda.fused_trace(ctx, ctb, keys_trf, gals), plain_reps=1,
          work=(poly_b * (2 * NB_RMW * W * C * L + S * P * T_kf * M_kf),
                S * fold_ops(NB_RMW * W, T_kf, M_kf, n)))
    check("fused_trace", f"ct[{NB_RMW*W},{C},{L},4096] keys[{S},3,{T_ks},{M_ks},4096] (batch of {NB_RMW})",
          lambda: ntt_cuda.fused_trace(ctx, ctb, keys_tr, gals), plain_reps=1,
          work=(poly_b * (2 * NB_RMW * W * C * L + S * P * T_ks * M_ks),
                S * fold_ops(NB_RMW * W, T_ks, M_ks, n)))
    nbm = NB_RMW * W * R // 2
    A, Bc = limbs((nbm, C, L, n), bits=17), limbs((nbm, C, L, n), bits=17)
    check("fused_pack_merge", f"A,B[{nbm},{C},{L},4096] t=32 g={(n >> 5) + 1} key[3,{T_kf},{M_kf},4096] (untruncated, batch of {NB_RMW})",
          lambda: ntt_cuda.fused_pack_merge(ctx, A, Bc, 32, (n >> 5) + 1, key_kf),
          plain_reps=1,
          work=(poly_b * (3 * nbm * C * L + P * T_kf * M_kf),
                fold_ops(nbm, T_kf, M_kf, n)))
    check("fused_pack_merge", f"A,B[{nbm},{C},{L},4096] t=32 g={(n >> 5) + 1} (batch of {NB_RMW})",
          lambda: ntt_cuda.fused_pack_merge(ctx, A, Bc, 32, (n >> 5) + 1, key_pm),
          plain_reps=1,
          work=(poly_b * (3 * nbm * C * L + P * T_ks * M_ks),
                fold_ops(nbm, T_ks, M_ks, n)))
    del A, Bc, ctb

    # kernel 6: last (nb = 128) and first (nb = 4) level of the write's
    # slot extraction, and the last level of the per-level batched
    # read-modify-write's (nb = NB_RMW * 128)
    for nb, l in ((W * R // 2, 5), (W, 0), (NB_RMW * W * R // 2, 5)):
        cts = limbs((nb, C, L, n))
        t_rot, g = 1 << l, gals[l]
        check("fused_split", f"ct[{nb},{C},{L},4096] t={t_rot} g={g} key[3,{T_kf},{M_kf},4096]",
              lambda: ntt_cuda.fused_split(ctx, cts, t_rot, g, key_kf),
              plain_reps=1 if nb > W * R else 3,
              work=(poly_b * (3 * nb * C * L + P * T_kf * M_kf),
                    fold_ops(nb, T_kf, M_kf, n) + 4 * nb * C * L * n))
    del cts

    # kernels 7 and 8: the one-launch trees at the shapes of a single write
    # (nb = W = 4 roots) and of a batched read-modify-write of 16 (nb = 64),
    # each also against the per-level launches that do the same work, and
    # one small odd shape each
    def split_levels(ct_, keys_, S_):
        nodes = ct_[:, None]
        for l in range(S_):
            c0, c1 = ntt_cuda.fused_split(
                ctx, nodes.reshape((-1,) + tuple(ct_.shape[1:])), 1 << l,
                gals[l], keys_[l])
            nodes = torch.cat([c0.reshape((ct_.shape[0], -1) + tuple(ct_.shape[1:])),
                               c1.reshape((ct_.shape[0], -1) + tuple(ct_.shape[1:]))],
                              dim=1)
        return nodes

    def merge_levels(cts_, keys_):
        M_, nb_ = cts_.shape[0], cts_.shape[1]
        levels_ = M_.bit_length() - 1
        for s_ in range(levels_):
            l = levels_ - 1 - s_
            R_ = M_ >> (s_ + 1)
            out = ntt_cuda.fused_pack_merge(
                ctx, cts_[:R_].reshape((-1,) + tuple(cts_.shape[2:])),
                cts_[R_: 2 * R_].reshape((-1,) + tuple(cts_.shape[2:])),
                1 << l, (n >> l) + 1, keys_[s_])
            cts_ = out.reshape((R_, nb_) + tuple(cts_.shape[2:]))
        return cts_[0]

    S_ST, M_PT = 6, 32        # 64 slots a root; 32 leaves a pack tree
    keys_st = spectra((S_ST, T_kf, M_kf, n)).permute(1, 0, 2, 3, 4).contiguous()
    for nb, S_ in ((W, S_ST), (NB_RMW * W, S_ST), (3, 1)):
        ct_s = limbs((nb, C, L, n))
        check("fused_split_tree",
              f"ct[{nb},{C},{L},4096] keys[{S_},3,{T_kf},{M_kf},4096]",
              lambda: ntt_cuda.fused_split_tree(ctx, ct_s, gals[:S_], keys_st[:S_]),
              plain_reps=1,
              per_level_fn=lambda: split_levels(ct_s, keys_st, S_),
              predecessor_fn=preds.split_tree_predecessor(
                  pred["split_tree"], ctx, ct_s, gals[:S_], keys_st[:S_].contiguous()))
    del ct_s
    keys_pt = spectra((5, T_kf, M_kf, n)).permute(1, 0, 2, 3, 4).contiguous()
    for nb, M_ in ((W, M_PT), (NB_RMW * W, M_PT), (3, 2)):
        lv_ = M_.bit_length() - 1
        cts_p = limbs((M_, nb, C, L, n), bits=17)
        check("fused_pack_tree",
              f"cts[{M_},{nb},{C},{L},4096] keys[{lv_},3,{T_kf},{M_kf},4096]",
              lambda: ntt_cuda.fused_pack_tree(ctx, cts_p, keys_pt[5 - lv_:]),
              plain_reps=1,
              per_level_fn=lambda: merge_levels(cts_p, keys_pt[5 - lv_:]),
              predecessor_fn=preds12.pack_tree_predecessor(
                  pred12["pack_tree"], ctx, cts_p, keys_pt[5 - lv_:].contiguous()))
    del cts_p

    # kernels 9-11: every shape the VM cycle gives them at PARAMS_2_18_READOPT
    # (vm_shapes); the cycle's phase below records what it really launches
    # and fails on a shape not checked here
    vctx = get_ntt_context(VPAR.n, VPAR.primes)
    for name, shape, inputs, work in vm_shapes(VPAR, vctx, limbs):
        fn = vm_call(vctx, name, inputs)
        check(name, shape, fn, plain_reps=1, work=work,
              predecessor_fn=preds.bitwise_predecessor(pred["bitwise"], vctx, *inputs)
              if name == "fused_bitwise" else None)
        del fn
    del inputs

    # kernels 13 and 14: the collectives at the shapes of the row-sharded
    # paths at PARAMS_2_24_READOPT (one pack root a shard, or a batch's)
    BW, BC, BL = BPAR.word_size, BPAR.rank + 1, BPAR.limbs_ct
    # The library call computes every shard's output in one call, as the
    # kernel does: the ring's n x n chunks (torch.stack of every shard's n
    # chunks; the view is free), the exchange's n partner chunks.
    for n_sh, roots in COLLECTIVE_SHAPES["ring_all_gather"]:
        chunks = [limbs((roots * BW, BC, BL, n)) for _ in range(n_sh)]
        check("ring_all_gather", collective_note(n_sh, chunks[0]),
              lambda: tuple(coll_mod.ring_all_gather(chunks)),
              work=(chunk_bytes(chunks[0]) * (n_sh + n_sh * n_sh), 0),
              library_fn=lambda: torch.stack(chunks * n_sh).view(
                  (n_sh, n_sh) + tuple(chunks[0].shape)))
    for n_sh, roots, stride in COLLECTIVE_SHAPES["exchange"]:
        chunks = [limbs((roots * BW, BC, BL, n)) for _ in range(n_sh)]
        check("exchange", collective_note(n_sh, chunks[0], stride),
              lambda: tuple(coll_mod.exchange(chunks, stride)),
              work=(chunk_bytes(chunks[0]) * 2 * n_sh, 0),
              library_fn=lambda: torch.stack([chunks[k ^ stride] for k in range(n_sh)]),
              predecessor_fn=preds13.exchange_predecessor(pred13["exchange"], chunks,
                                                          stride))
    del chunks

    # kernels 5, 1, 3 and 2 at every shape the VM LOAD gives them at this
    # preset (load_shapes); the load phase below records what it launches
    # and fails on a shape not checked here
    # and under the two-pass context, as the composed LOAD gives them
    for c_ in (ctx, tctx):
        for name, shape, fn, work in load_shapes(PAR, c_, limbs):
            check(name, shape, fn, plain_reps=1, work=work)
            del fn
    # kernels 2 and 1 at the shapes PARAMS_README_2_18's read and write cycle
    # add (readme_shapes: four chained digits over 256 rows and two over 4,
    # the full gadget, the GGSW inversion of its 68-bit digits); the
    # readme_rmw phase holds every shape it launches against the plain
    # versions through its first read and cycle
    for name, shape, fn, work in readme_shapes(CPAR, ctx, limbs):
        check(name, shape, fn, plain_reps=1, work=work)
        del fn
    emit({"phase": "kernel_checks", "ok": True, "tolerance": 0, "checks": checks,
          "timed_only": timed_only})
    if args.kernels_only:
        return

    # ---- the read, through the entry points a user calls -------------------
    ntt_cuda.reset_launches()
    t0 = time.time()
    src = rng.Source(args.seed)
    sk = rng.ternary_secret(src.split(), PAR.rank, n, PAR.xs_density, device=dev)
    s_ntt = glwe.secret_prepare(ctx, sk)
    ekp = keys_mod.prepare(PAR, keys_mod.keygen(PAR, sk, src))
    data = np.random.default_rng(args.seed).integers(
        0, 256, size=PAR.max_addr * W).astype(np.uint8)
    server = ram_mod.FheRam(PAR, ekp, device=dev)
    state = server.init_state(ram_mod.encrypt_ram(PAR, ctx, s_ntt, data, src))
    torch.cuda.synchronize()
    setup_s = time.time() - t0

    def prepared(idx):
        return address_mod.prepare(ctx, address_mod.encrypt(PAR, ctx, s_ntt, idx, src))

    def decode(out, idx, what, plain=data, dctx=ctx):
        """Every byte of the word read at idx equals `plain`'s, under the
        noise bound; returns the worst log2 noise.  dctx: the context of
        the decryption's transforms."""
        if tuple(out.shape) != (W, C, L, n) or out.dtype != torch.int32:
            fail(f"{what} at {idx}: output {tuple(out.shape)} {out.dtype}")
        worst = -1e9
        ph = glwe.phase(PAR, dctx, s_ntt, out)
        for i in range(W):
            want = glwe.cast_u8_signed(int(plain[idx * W + i]), PAR.k_pt)
            val, noise = glwe.decode_coeff0(PAR, ph[i], want)
            if int(val) != want:
                fail(f"{what} at {idx}, byte {i}: decoded {int(val)}, stored {want}")
            if not noise < -(PAR.k_pt + 1):
                fail(f"{what} at {idx}, byte {i}: noise 2^{noise:.2f} over the bound")
            worst = max(worst, float(noise))
        return worst

    def timed(fn):
        """(result, ms by the host clock around fn + synchronize)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def traced(what, fn, unprofiled_ms, top=14):
        """One call of fn under torch.profiler: device time by kernel and
        the device's idle share against the unprofiled median time."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, span_ms = timed(fn)
        rows = [(e.key, e.device_time_total / 1e3, e.count)
                for e in prof.key_averages() if e.device_time_total > 0
                and e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(r[1] for r in rows)
        rows.sort(key=lambda r: -r[1])
        # the profiler slows the host, so the idle share is taken against
        # the unprofiled median time, not against the traced span
        emit({"phase": "profile", "of": what,
              "span_ms_under_profiler": span_ms,
              "unprofiled_ms_median": unprofiled_ms,
              "device_busy_ms": busy_ms if rows else None,
              "device_idle_share_of_unprofiled_median":
                  1 - busy_ms / unprofiled_ms if rows else None,
              "by_kernel": [{"name": k[:60], "ms": ms, "count": c}
                            for k, ms, c in rows[:top]]})

    def launches_of(fn):
        """(result, ms, launches by kernel) of one call."""
        before = dict(ntt_cuda.LAUNCHES)
        out, ms = timed(fn)
        return out, ms, {k: ntt_cuda.LAUNCHES[k] - before[k] for k in before}

    def expect_launches(what, got, **want):
        want = {k: want.get(k, 0) for k in ntt_cuda.LAUNCHES}
        if got != want:
            fail(f"{what}: launches {got}, expected {want}")

    # distinct addresses for all phases: reads, cycles (each with two
    # neighbours that must stay unchanged), batched reads
    n_reads = max(args.reads, 8) - 2
    picks = [int(a) for a in np.random.default_rng(args.seed + 1).choice(
        np.arange(1, PAR.max_addr - 1),
        size=n_reads + 3 * CYCLES + BATCH + BIG_BATCH,
        replace=False)]
    addrs = [0, PAR.max_addr - 1] + picks[:n_reads]
    rest = picks[n_reads:]
    read_ms, worst_noise, per_read, outs = [], -1e9, None, {}
    read_want, write_want = rmw_cycle_launches(PAR)
    pc_read_want, pc_write_want = rmw_cycle_launches(PAR, composed=True)
    for idx in addrs:
        ap_ = prepared(idx)
        out, ms, delta = launches_of(lambda: server.read(state, ap_))
        read_ms.append(ms)
        if per_read is None:
            per_read = delta
        expect_launches(f"read at {idx}", delta, **read_want)
        worst_noise = max(worst_noise, decode(out, idx, "read"))
        outs[idx] = (ap_, out)
    path_launches = dict(ntt_cuda.LAUNCHES)
    for k in ("ntt_fwd", "ntt_inv", "fused_external_fold", "fused_trace",
              "fused_pack_merge"):
        if path_launches[k] == 0:
            fail(f"kernel {k} was not launched on the read path")
    emit({"phase": "read", "ok": True, "preset": "PARAMS_2_18_TURBO_READOPT",
          "max_addr": PAR.max_addr, "word_size": W, "n": n, "seed": args.seed,
          "reads": len(addrs), "addresses": addrs,
          "read_ms_median": statistics.median(read_ms), "read_ms": read_ms,
          "worst_noise_log2": worst_noise, "noise_bound_log2": -(PAR.k_pt + 1),
          "launches_per_read": per_read, "setup_seconds": round(setup_s, 2),
          "ram_ciphertext_bytes": state.data.numel() * 4})

    # ---- one read again through the plain versions, on the card ------------
    idx = addrs[-1]
    ap_, out = outs[idx]
    t0 = time.perf_counter()
    with ntt_cuda.plain_versions():
        plain_out = server.read(state, ap_)
    torch.cuda.synchronize()
    plain_read_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(plain_out, out):
        fail(f"read at {idx}: kernels and plain versions disagree")
    emit({"phase": "read_vs_plain", "ok": True, "address": idx,
          "plain_read_ms": plain_read_ms})

    # ---- read-modify-write cycles ------------------------------------------
    ntt_cuda.reset_launches()
    rpw_ms, write_ms, cycle_launches, worst_rmw = [], [], None, -1e9
    cycle_addrs, last_cycle = [], None
    for k in range(CYCLES):
        idx = rest[3 * k]
        addr = address_mod.encrypt(PAR, ctx, s_ntt, idx, src)
        ap_ = address_mod.prepare(ctx, addr)
        new_word = np.random.default_rng(args.seed + 2 + k).integers(
            0, 256, size=W).astype(np.uint8)
        w_ct = ram_mod.encrypt_write_word(PAR, ctx, s_ntt, new_word, src)
        (out, pending), t_rpw, l_rpw = launches_of(
            lambda: server.read_prepare_write(state, ap_))
        new_state, t_wr, l_wr = launches_of(
            lambda: server.write(pending, w_ct, addr))
        expect_launches(f"read_prepare_write at {idx}", l_rpw, **read_want)
        expect_launches(f"write at {idx}", l_wr, **write_want)
        if cycle_launches is None:
            cycle_launches = {"read_prepare_write": l_rpw, "write": l_wr}
        rpw_ms.append(t_rpw)
        write_ms.append(t_wr)
        worst_rmw = max(worst_rmw, decode(out, idx, "read_prepare_write"))
        last_cycle = (state, ap_, addr, w_ct, out, new_state)
        state = new_state
        data[idx * W: (idx + 1) * W] = new_word
        cycle_addrs.append(idx)
    rmw_launches = dict(ntt_cuda.LAUNCHES)
    for k in ("fused_split", "fused_external_fold", "fused_trace",
              "fused_pack_merge", "ntt_fwd"):
        if rmw_launches[k] == 0:
            fail(f"kernel {k} was not launched on the write cycle's path")
    # read back (outside the counted window): every written word, after all
    # the writes, and the two neighbours of each cycle
    for k, idx in enumerate(cycle_addrs):
        worst_rmw = max(worst_rmw, decode(server.read(state, prepared(idx)), idx,
                                          "read-back"))
        for other in rest[3 * k + 1: 3 * k + 3]:
            worst_rmw = max(worst_rmw, decode(server.read(state, prepared(other)),
                                              other, "read of an unwritten address"))
    emit({"phase": "rmw", "ok": True, "cycles": CYCLES,
          "addresses": cycle_addrs,
          "rpw_ms": statistics.median(rpw_ms),
          "write_ms": statistics.median(write_ms),
          "rpw_plus_write_ms": statistics.median(
              [a + b for a, b in zip(rpw_ms, write_ms)]),
          "rpw_ms_all": rpw_ms, "write_ms_all": write_ms,
          "worst_noise_log2": worst_rmw, "noise_bound_log2": -(PAR.k_pt + 1),
          "launches_per_cycle": cycle_launches})

    # ---- the last cycle again through the plain versions, on the card ------
    st0, ap_, addr, w_ct, out, st1 = last_cycle
    with ntt_cuda.plain_versions():
        (p_out, p_pending), p_rpw_ms = timed(
            lambda: server.read_prepare_write(st0, ap_))
        p_state, p_write_ms = timed(lambda: server.write(p_pending, w_ct, addr))
    if not torch.equal(p_out, out):
        fail("read_prepare_write: kernels and plain versions disagree")
    if not torch.equal(p_state.data, st1.data):
        fail("write: kernels and plain versions disagree on the new RAM")
    emit({"phase": "rmw_vs_plain", "ok": True, "address": cycle_addrs[-1],
          "compared": "read-out and all of the new RAM "
                      f"int32{list(st1.data.shape)}",
          "plain_rpw_ms": p_rpw_ms, "plain_write_ms": p_write_ms})

    # ---- batched reads -------------------------------------------------------
    rest = rest[3 * CYCLES:]
    batch_idx = rest[:BATCH]
    batch_aps = [prepared(i) for i in batch_idx]
    coords_b = stack_addresses(batch_aps)
    ntt_cuda.reset_launches()
    got_b, batch_ms, l_b = launches_of(lambda: server.read_batch(state, coords_b))
    cache, cache_ms, l_c = launches_of(lambda: server.spectral_cache(state))
    got_c, cached_ms, l_bc = launches_of(
        lambda: server.read_batch(state, coords_b, cache=cache))
    batch_launches = dict(ntt_cuda.LAUNCHES)
    expect_launches("read_batch", l_b, fused_external_fold_batched=2, ntt_fwd=1,
                    fused_pack_merge=6, fused_trace=1)
    expect_launches("spectral_cache", l_c, ntt_fwd=1)
    expect_launches("read_batch with the cache", l_bc,
                    fused_external_fold_batched=2, fused_pack_merge=6,
                    fused_trace=1)
    # steady times: three more calls of each, the median
    batch_all = [batch_ms] + [timed(lambda: server.read_batch(state, coords_b))[1]
                              for _ in range(3)]
    cached_all = [cached_ms] + [
        timed(lambda: server.read_batch(state, coords_b, cache=cache))[1]
        for _ in range(3)]
    worst_b = -1e9
    for k, idx in enumerate(batch_idx):
        single = server.read(state, batch_aps[k])
        if not (torch.equal(got_b[k], single) and torch.equal(got_c[k], single)):
            fail(f"read_batch at {idx}: differs from the single read")
        worst_b = max(worst_b, decode(got_b[k], idx, "read_batch"))
    one_cached = server.read(state, batch_aps[0], cache=cache)
    if not torch.equal(one_cached, got_b[0]):
        fail("read(cache=) differs from the single read")
    rec = {"phase": "read_batch", "ok": True, "batch": BATCH,
           "addresses": batch_idx,
           "equal_to_single_reads": True,
           "batch_ms": statistics.median(batch_all), "batch_ms_all": batch_all,
           "reads_per_s": BATCH / statistics.median(batch_all) * 1e3,
           "cached_batch_ms": statistics.median(cached_all),
           "cached_batch_ms_all": cached_all,
           "cached_reads_per_s": BATCH / statistics.median(cached_all) * 1e3,
           "spectral_cache_ms": cache_ms,
           "spectral_cache_bytes": cache.numel() * 4,
           "worst_noise_log2": worst_b,
           "launches": {"read_batch": l_b, "spectral_cache": l_c,
                        "read_batch_cached": l_bc}}
    # one larger batch, with the cache, in one slice
    big_idx = rest[BATCH: BATCH + BIG_BATCH]
    big_coords = stack_addresses([prepared(i) for i in big_idx])
    torch.cuda.reset_peak_memory_stats()
    big_all = []
    for _ in range(3):
        got_big, ms = timed(lambda: server.read_batch(
            state, big_coords, cache=cache, batch_slice=BIG_BATCH))
        big_all.append(ms)
    for k, idx in enumerate(big_idx):
        worst_b = max(worst_b, decode(got_big[k], idx, "big read_batch"))
    rec.update(big_batch=BIG_BATCH, big_batch_cached_ms_all=big_all,
               big_batch_cached_ms=statistics.median(big_all),
               big_batch_cached_reads_per_s=
                   BIG_BATCH / statistics.median(big_all) * 1e3,
               big_batch_peak_device_bytes=torch.cuda.max_memory_allocated(),
               worst_noise_log2=worst_b)
    del got_big, big_coords
    emit(rec)

    # ---- the batched read-modify-write, with the one-launch tree kernels -----
    tree_server = ram_mod.FheRam(PAR, ekp, device=dev, tree_kernels=True)
    used = set(addrs) | set(picks)
    more = [int(a) for a in np.random.default_rng(args.seed + 100).permutation(
        PAR.max_addr) if int(a) not in used][:2 * NB_RMW + 4]
    rmw_idx, quiet_idx, small_idx = (more[:NB_RMW], more[NB_RMW: 2 * NB_RMW],
                                     more[2 * NB_RMW:])

    def address_batch(idxs):
        """(prepared addresses, their stacking, the coefficient-domain
        stacking) of a list of addresses."""
        coeff = [address_mod.encrypt(PAR, ctx, s_ntt, i, src) for i in idxs]
        preps = [address_mod.prepare(ctx, a) for a in coeff]
        return preps, stack_addresses(preps), stack_addresses(coeff)

    def word_batch(seed, count):
        words = np.random.default_rng(seed).integers(
            0, 256, size=(count, W)).astype(np.uint8)
        return words, torch.stack([
            ram_mod.encrypt_write_word(PAR, ctx, s_ntt, w, src) for w in words])

    rmw_preps, rmw_prep_b, rmw_coeff_b = address_batch(rmw_idx)
    quiet_b = address_batch(quiet_idx)[1]
    # the client's part first (encrypting words launches transforms), so that
    # the counted window holds the server's two calls and nothing else
    call_words = [word_batch(args.seed + 200 + call, NB_RMW) for call in range(2)]
    call_outs = []
    ntt_cuda.reset_launches()
    for call, (_, w_b) in enumerate(call_words):   # the second call runs on
        (outs_b, state), ms, l_rb = launches_of(   # the first one's new RAM
            lambda: tree_server.rmw_batch(state, rmw_prep_b, rmw_coeff_b, w_b))
        expect_launches(f"rmw_batch call {call}", l_rb,
                        fused_external_fold_batched=4, fused_external_fold=4,
                        ntt_fwd=3, fused_pack_merge=1, fused_pack_tree=1,
                        fused_trace=1, fused_split_tree=1)
        call_outs.append(outs_b)
    rmw_batch_launches = dict(ntt_cuda.LAUNCHES)
    rb_launches_per_call = l_rb
    for k in ("fused_split_tree", "fused_pack_tree", "fused_external_fold_batched",
              "fused_external_fold", "fused_pack_merge", "fused_trace", "ntt_fwd"):
        if rmw_batch_launches[k] == 0:
            fail(f"kernel {k} was not launched on the batched read-modify-write's path")
    worst_rb = -1e9
    for (words, _), outs_b in zip(call_words, call_outs):
        for k, idx in enumerate(rmw_idx):   # the PRE-write words come out
            worst_rb = max(worst_rb, decode(outs_b[k], idx, "rmw_batch read-out"))
            data[idx * W: (idx + 1) * W] = words[k]
    del call_outs, outs_b
    # outside the counted window: the new words read back, 16 other addresses
    # are unchanged
    back = server.read_batch(state, rmw_prep_b)
    quiet = server.read_batch(state, quiet_b)
    for k in range(NB_RMW):
        worst_rb = max(worst_rb, decode(back[k], rmw_idx[k], "rmw_batch read-back"))
        worst_rb = max(worst_rb, decode(quiet[k], quiet_idx[k],
                                        "read of an address rmw_batch left alone"))
    # steady times, both servers on the same state and words, bit-equal
    words, w_b = word_batch(args.seed + 202, NB_RMW)
    torch.cuda.reset_peak_memory_stats()
    tree_ms, level_ms, l_levels = [], [], None
    level_launches = dict.fromkeys(ntt_cuda.LAUNCHES, 0)   # the per-level server's calls
    for _ in range(4):
        (outs_t, st_t), ms = timed(
            lambda: tree_server.rmw_batch(state, rmw_prep_b, rmw_coeff_b, w_b))
        tree_ms.append(ms)
        (outs_l, st_l), ms, l_levels = launches_of(
            lambda: server.rmw_batch(state, rmw_prep_b, rmw_coeff_b, w_b))
        level_ms.append(ms)
        for k, v in l_levels.items():
            level_launches[k] += v
    rmw_batch_peak = torch.cuda.max_memory_allocated()
    expect_launches("rmw_batch with the per-level kernels", l_levels,
                    fused_external_fold_batched=4, fused_external_fold=4,
                    ntt_fwd=3, fused_pack_merge=6, fused_trace=1, fused_split=6)
    if not (torch.equal(outs_t, outs_l) and torch.equal(st_t.data, st_l.data)):
        fail("rmw_batch: tree_kernels=True and False disagree")
    del outs_l, st_l, back, quiet
    seq_ms = statistics.median([a + b for a, b in zip(rpw_ms, write_ms)])
    emit({"phase": "rmw_batch", "ok": True, "batch": NB_RMW, "chained_calls": 2,
          "addresses": rmw_idx, "unchanged_addresses": quiet_idx,
          "rmw_batch_ms": statistics.median(tree_ms), "rmw_batch_ms_all": tree_ms,
          "rmws_per_s": NB_RMW / statistics.median(tree_ms) * 1e3,
          "per_level_rmw_batch_ms": statistics.median(level_ms),
          "per_level_rmw_batch_ms_all": level_ms,
          "per_level_rmws_per_s": NB_RMW / statistics.median(level_ms) * 1e3,
          "tree_kernels_equal_per_level": True,
          "sequential_rpw_plus_write_ms": seq_ms,
          "sequential_rmws_per_s": 1e3 / seq_ms,
          "peak_device_bytes": rmw_batch_peak,
          "worst_noise_log2": worst_rb, "noise_bound_log2": -(PAR.k_pt + 1),
          "launches_per_call": rb_launches_per_call,
          "launches_per_call_per_level": l_levels})

    # ---- a batched read-modify-write of 4 through the plain versions ---------
    _, small_prep_b, small_coeff_b = address_batch(small_idx)
    _, w_small = word_batch(args.seed + 203, len(small_idx))
    outs_k, st_k = tree_server.rmw_batch(state, small_prep_b, small_coeff_b, w_small)
    with ntt_cuda.plain_versions():
        (outs_p, st_p), plain_rb_ms = timed(lambda: tree_server.rmw_batch(
            state, small_prep_b, small_coeff_b, w_small))
    if not (torch.equal(outs_k, outs_p) and torch.equal(st_k.data, st_p.data)):
        fail("rmw_batch: kernels and plain versions disagree")
    del outs_k, st_k
    # and the timed batch of NB_RMW itself, where the folds, the first merge
    # and the trace run at their widest
    with ntt_cuda.plain_versions():
        (outs_p, st_p), plain_rb_full_ms = timed(lambda: tree_server.rmw_batch(
            state, rmw_prep_b, rmw_coeff_b, w_b))
    if not (torch.equal(outs_t, outs_p) and torch.equal(st_t.data, st_p.data)):
        fail(f"rmw_batch of {NB_RMW}: kernels and plain versions disagree")
    emit({"phase": "rmw_batch_vs_plain", "ok": True,
          "batches": [len(small_idx), NB_RMW],
          "compared": "outs and all of the new RAM "
                      f"int32{list(st_p.data.shape)}",
          "plain_rmw_batch_ms": plain_rb_ms,
          f"plain_rmw_batch_{NB_RMW}_ms": plain_rb_full_ms})
    del outs_p, st_p, outs_t, st_t

    # ---- the single cycle and the batched read with the tree kernels ---------
    st0, cap_, addr, w_ct, out, st1 = last_cycle
    cyc = {"rpw": [], "write": [], "tree_rpw": [], "tree_write": []}
    for _ in range(4):
        (out_l, pend_l), ms = timed(lambda: server.read_prepare_write(st0, cap_))
        cyc["rpw"].append(ms)
        new_l, ms = timed(lambda: server.write(pend_l, w_ct, addr))
        cyc["write"].append(ms)
        (out_t, pend_t), ms, l_trpw = launches_of(
            lambda: tree_server.read_prepare_write(st0, cap_))
        cyc["tree_rpw"].append(ms)
        new_t, ms, l_twr = launches_of(lambda: tree_server.write(pend_t, w_ct, addr))
        cyc["tree_write"].append(ms)
    expect_launches("read_prepare_write with the tree kernels", l_trpw,
                    fused_external_fold=2, fused_pack_merge=1, fused_pack_tree=1,
                    fused_trace=1)
    expect_launches("write with the tree kernels", l_twr, fused_trace=1,
                    fused_external_fold=6, ntt_fwd=2, fused_split_tree=1)
    if not (torch.equal(out_t, out) and torch.equal(new_t.data, st1.data)
            and torch.equal(out_l, out) and torch.equal(new_l.data, st1.data)):
        fail("the cycle with tree_kernels=True differs from the default's")
    emit({"phase": "tree_kernels_cycle", "ok": True,
          "equal_to_default": True,
          "rpw_ms": statistics.median(cyc["rpw"]),
          "write_ms": statistics.median(cyc["write"]),
          "tree_rpw_ms": statistics.median(cyc["tree_rpw"]),
          "tree_write_ms": statistics.median(cyc["tree_write"]),
          "ms_all": cyc,
          "launches": {"read_prepare_write": l_trpw, "write": l_twr}})
    del out_l, pend_l, new_l, out_t, pend_t, new_t

    # ---- the composed configuration: FheRam(composed=True) --------------------
    # The two-pass transform body and the composed routes: each pack merge,
    # trace step and split level is torch glue around one launch of the fold
    # kernel.  The client's work inside the counted windows (preparing
    # addresses, decrypting) runs under the same context, so every launch
    # there must be a fold (one build serves both bodies) or a two-pass
    # variant: kernels 3, 4 and 6-11 and the radix-2 transforms are not
    # launched at all.  Launches a call, counted
    # from the code: a read or an rpw 20 folds (2 products, 6 merges, 12
    # trace steps); a write 24 (12 trace steps, 2 x 2 inversion folds, 6
    # split levels, the delta's and the update's products) and 2 transforms;
    # a read_batch 2 batched folds, 18 folds and its one transform (none
    # with the cache); an rmw_batch 4 batched folds, 28 folds, 3 transforms.
    cserver = ram_mod.FheRam(PAR, ekp, device=dev, composed=True)
    cctx = cserver.ctx

    # a composed window launches the transform (kernel 1) and the fold
    # (kernels 2 and 5), one build for both bodies, and nothing else
    composed_ok = ("ntt_fwd", "ntt_inv", "fused_external_fold",
                   "fused_external_fold_batched")

    def only_composed(what, counts, also=()):
        """Every launch of a composed window one of composed_ok (or also)."""
        off = {k: v for k, v in counts.items()
               if v and k not in composed_ok + tuple(also)}
        if off:
            fail(f"{what}: launches off the composed routes: {off}")

    # composed_read: the read phase's addresses on the RAM as it is now, each
    # bit-equal to the fused server's read (taken first, outside the window)
    c_coeff = {idx: address_mod.encrypt(PAR, ctx, s_ntt, idx, src) for idx in addrs}
    fused_out = {idx: server.read(state, address_mod.prepare(ctx, c_coeff[idx]))
                 for idx in addrs}
    ntt_cuda.reset_launches()
    c_read_ms, worst_c, c_per_read = [], -1e9, None
    for idx in addrs:
        ap_ = address_mod.prepare(cctx, c_coeff[idx])
        out, ms, c_per_read = launches_of(lambda: cserver.read(state, ap_))
        expect_launches(f"composed read at {idx}", c_per_read, **pc_read_want)
        c_read_ms.append(ms)
        if not torch.equal(out, fused_out[idx]):
            fail(f"composed read at {idx}: differs from the fused server's read")
        worst_c = max(worst_c, decode(out, idx, "composed read", dctx=cctx))
    c_read_launches = dict(ntt_cuda.LAUNCHES)
    only_composed("composed_read", c_read_launches)
    del fused_out
    emit({"phase": "composed_read", "ok": True, "reads": len(addrs),
          "addresses": addrs, "equal_to_fused_server": True,
          "composed_read_ms_median": statistics.median(c_read_ms),
          "composed_read_ms": c_read_ms,
          "read_ms_median": statistics.median(read_ms),
          "worst_noise_log2": worst_c, "noise_bound_log2": -(PAR.k_pt + 1),
          "launches_per_read": c_per_read})

    # composed_rmw: 4 chained cycles at fresh addresses (inputs encrypted
    # before the window), then every cycle again through the fused server
    used |= set(more)
    fresh = [int(a) for a in np.random.default_rng(args.seed + 300).permutation(
        PAR.max_addr) if int(a) not in used][:CYCLES + 4]
    c_cycle_idx, c_rb_idx = fresh[:CYCLES], fresh[CYCLES:]
    c_in = []
    for k, idx in enumerate(c_cycle_idx):
        new_word = np.random.default_rng(args.seed + 400 + k).integers(
            0, 256, size=W).astype(np.uint8)
        c_in.append((idx, address_mod.encrypt(PAR, ctx, s_ntt, idx, src), new_word,
                     ram_mod.encrypt_write_word(PAR, ctx, s_ntt, new_word, src)))
    ntt_cuda.reset_launches()
    c_rpw_ms, c_write_ms, worst_cr, c_cycles, c_cycle_l = [], [], -1e9, [], None
    for idx, addr, new_word, w_ct in c_in:
        ap_ = address_mod.prepare(cctx, addr)
        (out, pending), t_rpw, l_rpw = launches_of(
            lambda: cserver.read_prepare_write(state, ap_))
        new_state, t_wr, l_wr = launches_of(lambda: cserver.write(pending, w_ct, addr))
        expect_launches(f"composed read_prepare_write at {idx}", l_rpw, **pc_read_want)
        expect_launches(f"composed write at {idx}", l_wr, **pc_write_want)
        c_cycle_l = {"read_prepare_write": l_rpw, "write": l_wr}
        c_rpw_ms.append(t_rpw)
        c_write_ms.append(t_wr)
        worst_cr = max(worst_cr, decode(out, idx, "composed read_prepare_write",
                                        dctx=cctx))
        c_cycles.append((state, ap_, addr, w_ct, out, new_state))
        state = new_state
        data[idx * W: (idx + 1) * W] = new_word
    c_rmw_launches = dict(ntt_cuda.LAUNCHES)
    only_composed("composed_rmw", c_rmw_launches)
    for idx, addr, _, _ in c_in:   # read back after all the writes
        worst_cr = max(worst_cr, decode(
            cserver.read(state, address_mod.prepare(cctx, addr)), idx,
            "composed read-back", dctx=cctx))
    for st0, ap_, addr, w_ct, out, st1 in c_cycles:
        f_out, f_pending = server.read_prepare_write(st0, ap_)
        if not (torch.equal(f_out, out)
                and torch.equal(server.write(f_pending, w_ct, addr).data, st1.data)):
            fail("composed cycle: the read-out or the new RAM differs from the "
                 "fused server's")
    emit({"phase": "composed_rmw", "ok": True, "cycles": CYCLES,
          "addresses": c_cycle_idx,
          "equal_to_fused_server": "read-outs and all of each new RAM",
          "rpw_ms": statistics.median(c_rpw_ms), "write_ms": statistics.median(c_write_ms),
          "rpw_plus_write_ms": statistics.median(
              [a + b for a, b in zip(c_rpw_ms, c_write_ms)]),
          "rpw_ms_all": c_rpw_ms, "write_ms_all": c_write_ms,
          "fused_rpw_ms": statistics.median(rpw_ms),
          "fused_write_ms": statistics.median(write_ms),
          "worst_noise_log2": worst_cr, "noise_bound_log2": -(PAR.k_pt + 1),
          "launches_per_cycle": c_cycle_l})

    # composed_batch: read_batch of 16 (without and with the spectral cache)
    # and rmw_batch of 4 fresh addresses, against the fused server's
    rb_preps, rb_prep_b, rb_coeff_b = address_batch(c_rb_idx)
    rb_words, rb_w = word_batch(args.seed + 500, len(c_rb_idx))
    f_batch = server.read_batch(state, coords_b)
    f_outs, f_new = server.rmw_batch(state, rb_prep_b, rb_coeff_b, rb_w)
    ntt_cuda.reset_launches()
    c_got, cb_ms, l_cb = launches_of(lambda: cserver.read_batch(state, coords_b))
    c_cache, _, l_cc = launches_of(lambda: cserver.spectral_cache(state))
    c_got_c, cbc_ms, l_cbc = launches_of(
        lambda: cserver.read_batch(state, coords_b, cache=c_cache))
    (c_outs, c_new), crb_ms, l_crb = launches_of(
        lambda: cserver.rmw_batch(state, rb_prep_b, rb_coeff_b, rb_w))
    c_batch_launches = dict(ntt_cuda.LAUNCHES)
    only_composed("composed_batch", c_batch_launches)
    expect_launches("composed read_batch", l_cb, fused_external_fold_batched=2,
                    ntt_fwd=1, fused_external_fold=18)
    expect_launches("composed spectral_cache", l_cc, ntt_fwd=1)
    expect_launches("composed read_batch with the cache", l_cbc,
                    fused_external_fold_batched=2, fused_external_fold=18)
    expect_launches("composed rmw_batch", l_crb, fused_external_fold_batched=4,
                    fused_external_fold=28, ntt_fwd=3)
    if not (torch.equal(c_got, f_batch) and torch.equal(c_got_c, f_batch)):
        fail("composed read_batch: differs from the fused server's")
    if not (torch.equal(c_outs, f_outs) and torch.equal(c_new.data, f_new.data)):
        fail("composed rmw_batch: outs or the new RAM differ from the fused server's")
    del f_batch, f_outs, f_new, c_cache
    worst_cb = -1e9
    for k, idx in enumerate(batch_idx):
        worst_cb = max(worst_cb, decode(c_got[k], idx, "composed read_batch", dctx=cctx))
    for k, idx in enumerate(c_rb_idx):
        worst_cb = max(worst_cb, decode(c_outs[k], idx, "composed rmw_batch read-out",
                                        dctx=cctx))
        data[idx * W: (idx + 1) * W] = rb_words[k]
    state = c_new
    back = cserver.read_batch(state, rb_prep_b)
    for k, idx in enumerate(c_rb_idx):
        worst_cb = max(worst_cb, decode(back[k], idx, "composed rmw_batch read-back",
                                        dctx=cctx))
    del c_got, c_got_c, c_outs, back
    emit({"phase": "composed_batch", "ok": True, "batch": BATCH,
          "rmw_batch": len(c_rb_idx), "rmw_addresses": c_rb_idx,
          "equal_to_fused_server": "read_batch (cached and not), rmw_batch outs "
                                   "and all of the new RAM",
          "batch_ms": cb_ms, "cached_batch_ms": cbc_ms, "rmw_batch_ms": crb_ms,
          "fused_batch_ms": statistics.median(batch_all),
          "worst_noise_log2": worst_cb, "noise_bound_log2": -(PAR.k_pt + 1),
          "launches": {"read_batch": l_cb, "spectral_cache": l_cc,
                       "read_batch_cached": l_cbc, "rmw_batch": l_crb}})

    # composed_vs_plain: one read and one cycle through plain_versions()
    c_ap0 = address_mod.prepare(cctx, c_coeff[addrs[-1]])
    k_out = cserver.read(state, c_ap0)
    st0, cap_, addr, w_ct, out, st1 = c_cycles[-1]
    with ntt_cuda.plain_versions():
        p_out, p_read_ms = timed(lambda: cserver.read(state, c_ap0))
        (p_rpw, p_pend), p_rpw_ms = timed(lambda: cserver.read_prepare_write(st0, cap_))
        p_new, p_write_ms = timed(lambda: cserver.write(p_pend, w_ct, addr))
    if not torch.equal(p_out, k_out):
        fail("composed read: kernels and plain versions disagree")
    if not (torch.equal(p_rpw, out) and torch.equal(p_new.data, st1.data)):
        fail("composed cycle: kernels and plain versions disagree")
    emit({"phase": "composed_vs_plain", "ok": True, "address": addrs[-1],
          "cycle_address": c_cycle_idx[-1],
          "compared": "a read; a cycle's read-out and all of its new RAM",
          "plain_read_ms": p_read_ms, "plain_rpw_ms": p_rpw_ms,
          "plain_write_ms": p_write_ms})
    del k_out, p_out, p_rpw, p_new, c_coeff

    # ---- composed_chained_batch: the composed route's chained digits ---------
    # ram/address.py coordinate_product_batched's composed branch: at
    # PARAMS_README_2_18 (the README's 2^18 parameterization: 4 + 2 CMux
    # digits of 3 bits, no truncation) every address's digit chain starts
    # from the RAM's coefficients, the digit rows copied once an address
    # (~200 MB at 8), where the fused route chains on the shared spectra.
    # The port's own client from --seed (keygen, 2^18 x 4 random bytes, the
    # addresses); FheRam(composed=True).read_batch of CHAINED_BATCH against
    # the fused server's.  Launches a call, counted from the code: 2 batched
    # folds (level 0, level 1), a merge a level and a trace step one fold
    # each, no transform.
    t_phase = time.time()
    rctx = get_ntt_context(CPAR.n, CPAR.primes)
    rsrc = rng.Source(args.seed + 40)
    rsk = rng.ternary_secret(rsrc.split(), CPAR.rank, CPAR.n, CPAR.xs_density,
                             device=dev)
    rs_ntt = glwe.secret_prepare(rctx, rsk)
    rkeys = keys_mod.prepare(CPAR, keys_mod.keygen(CPAR, rsk, rsrc))
    rdata = np.random.default_rng(args.seed + 41).integers(
        0, 256, size=CPAR.max_addr * CPAR.word_size).astype(np.uint8)
    rserver = ram_mod.FheRam(CPAR, rkeys, device=dev)
    rcserver = ram_mod.FheRam(CPAR, rkeys, device=dev, composed=True)
    rstate = rserver.init_state(ram_mod.encrypt_ram(CPAR, rctx, rs_ntt, rdata, rsrc))
    r_idx = [int(a) for a in np.random.default_rng(args.seed + 42).choice(
        CPAR.max_addr, size=CHAINED_BATCH, replace=False)]
    r_b = stack_addresses([address_mod.prepare(rctx, address_mod.encrypt(
        CPAR, rctx, rs_ntt, i, rsrc)) for i in r_idx])
    torch.cuda.synchronize()
    r_setup_s = time.time() - t_phase
    r_digits = [c.shape[2] for c in r_b]
    if r_digits[0] < 2:
        fail(f"composed_chained_batch: {r_digits} digits, no chain at level 0")
    r_fused, r_fused_ms = timed(lambda: rserver.read_batch(rstate, r_b))
    ntt_cuda.reset_launches()
    r_ms = []
    for _ in range(3):
        r_got, ms, l_rb = launches_of(lambda: rcserver.read_batch(rstate, r_b))
        expect_launches("composed chained read_batch", l_rb,
                        fused_external_fold_batched=2,
                        fused_external_fold=CPAR.num_rows.bit_length() - 1 + CPAR.log_n)
        r_ms.append(ms)
    chained_launches = dict(ntt_cuda.LAUNCHES)
    only_composed("composed_chained_batch", chained_launches)
    r_fused_all = [r_fused_ms] + [timed(lambda: rserver.read_batch(rstate, r_b))[1]
                                  for _ in range(2)]
    if not torch.equal(r_got, r_fused):
        fail("composed chained read_batch: differs from the fused server's")
    # the chained digits through the plain versions: both kernel modes (the
    # chain from coefficients here, from the shared spectra in the fused
    # server's call) held against the plain fold at this phase's shapes
    with ntt_cuda.plain_versions():
        r_plain, r_plain_ms = timed(lambda: rcserver.read_batch(rstate, r_b))
    if not torch.equal(r_plain, r_got):
        fail("composed chained read_batch: kernels and plain versions disagree")
    del r_plain
    CW = CPAR.word_size
    worst_rb = max(word_noise(CPAR, rctx, rs_ntt, r_got[k], rdata[idx * CW: (idx + 1) * CW],
                              f"composed chained read_batch at {idx}")
                   for k, idx in enumerate(r_idx))
    emit({"phase": "composed_chained_batch", "ok": True, "preset": "PARAMS_README_2_18",
          "batch": CHAINED_BATCH, "addresses": r_idx, "digits": r_digits,
          "equal_to_fused_server": True, "equal_to_plain_versions": True,
          "plain_composed_read_batch_ms": r_plain_ms,
          "composed_read_batch_ms": statistics.median(r_ms),
          "composed_read_batch_ms_all": r_ms,
          "fused_read_batch_ms": statistics.median(r_fused_all),
          "fused_read_batch_ms_all": r_fused_all,
          "worst_noise_log2": worst_rb, "noise_bound_log2": -(CPAR.k_pt + 1),
          "launches_per_call": l_rb, "setup_seconds": round(r_setup_s, 2)})
    del r_b, r_got, r_fused

    # ---- readme_rmw: the README parameterization's read and RMW cycle -------
    # On that client (PARAMS_README_2_18: 4 + 2 chained CMux digits of 3
    # bits, no truncation anywhere, k_ggsw = 68): README_READS fused reads at
    # distinct addresses, then CYCLES read_prepare_write + write cycles at
    # fresh addresses (words from --seed), launches a call as counted from
    # the code (rmw_cycle_launches).  Outside the counted windows: every
    # read-out decodes, each cycle's new RAM is read at its address and at
    # an untouched neighbour; the first read and the first cycle run again
    # on the kernels, through the plain versions and through the composed
    # server, bit-equal (read-out and all of the new RAM), and every shape
    # the kernels' rerun launched (every address gives the same shapes) is
    # one the plain run launched too (the shape notes of
    # multihost_dryrun.recording_shapes, kept out of the timed calls).
    c_read_want, c_write_want = rmw_cycle_launches(CPAR)
    cc_read_want, cc_write_want = rmw_cycle_launches(CPAR, composed=True)
    rfresh = [int(a) for a in np.random.default_rng(args.seed + 43).permutation(
        CPAR.max_addr) if int(a) not in set(r_idx)][:README_READS + 2 * CYCLES]
    rr_idx, rc_idx = rfresh[:README_READS], rfresh[README_READS:]
    rcoeff = {i: address_mod.encrypt(CPAR, rctx, rs_ntt, i, rsrc) for i in rfresh}
    rprep = {i: address_mod.prepare(rctx, a) for i, a in rcoeff.items()}
    rwords = np.random.default_rng(args.seed + 44).integers(
        0, 256, size=(CYCLES, CW)).astype(np.uint8)
    rw_cts = [ram_mod.encrypt_write_word(CPAR, rctx, rs_ntt, w_, rsrc) for w_ in rwords]
    rseen, rplain_seen = {}, {}
    ntt_cuda.reset_launches()
    rread_ms, rread_out, rcycles = [], {}, []
    for i in rr_idx:
        out, ms, delta = launches_of(lambda: rserver.read(rstate, rprep[i]))
        expect_launches(f"README read at {i}", delta, **c_read_want)
        rread_ms.append(ms)
        rread_out[i] = out
    st = rstate
    for k in range(CYCLES):
        i = rc_idx[2 * k]
        (out, pend), t_rpw, l_rpw = launches_of(
            lambda: rserver.read_prepare_write(st, rprep[i]))
        new, t_wr, l_wr = launches_of(lambda: rserver.write(pend, rw_cts[k], rcoeff[i]))
        expect_launches(f"README read_prepare_write at {i}", l_rpw, **c_read_want)
        expect_launches(f"README write at {i}", l_wr, **c_write_want)
        rcycles.append({"state": st, "address": i, "out": out, "new": new,
                        "rpw_ms": t_rpw, "write_ms": t_wr})
        st = new
    readme_launches = dict(ntt_cuda.LAUNCHES)
    worst_r = -1e9
    for i in rr_idx:
        worst_r = max(worst_r, word_noise(CPAR, rctx, rs_ntt, rread_out[i],
                                          rdata[i * CW: (i + 1) * CW], f"README read at {i}"))
    r_plain = rdata.copy()
    for k, rcyc in enumerate(rcycles):
        i, nb = rcyc["address"], rc_idx[2 * k + 1]
        worst_r = max(worst_r, word_noise(CPAR, rctx, rs_ntt, rcyc["out"],
                                          r_plain[i * CW: (i + 1) * CW],
                                          f"README read_prepare_write at {i}"))
        r_plain[i * CW: (i + 1) * CW] = rwords[k]
        for j, what in ((i, "README read-back"), (nb, "README untouched neighbour")):
            back = rserver.read(rcyc["new"], rprep[j])
            worst_r = max(worst_r, word_noise(CPAR, rctx, rs_ntt, back,
                                              r_plain[j * CW: (j + 1) * CW],
                                              f"{what} at {j} after cycle {k}"))
    # the first read and the first cycle again: on the kernels with the
    # shapes recorded (apart from the timed calls, which the recording's
    # notes would slow), through the plain versions, then through the
    # composed server
    i0, c0 = rr_idx[0], rcycles[0]

    def readme_first(srv):
        out_ = srv.read(rstate, rprep[i0])
        rpw_, pend_ = srv.read_prepare_write(c0["state"], rprep[c0["address"]])
        return out_, rpw_, srv.write(pend_, rw_cts[0], rcoeff[c0["address"]])

    with dryrun.recording_shapes(rseen):
        s_out, s_rpw, s_new = readme_first(rserver)
    with ntt_cuda.plain_versions(), dryrun.recording_shapes(rplain_seen):
        (p_out, p_rpw, p_new), rplain_ms = timed(lambda: readme_first(rserver))
    ntt_cuda.reset_launches()
    (cr_out, cr_rpw, cr_new), rcomposed_ms = timed(lambda: readme_first(rcserver))
    only_composed("readme_rmw (composed server)", ntt_cuda.LAUNCHES)
    expect_launches("README composed read, rpw and write", dict(ntt_cuda.LAUNCHES),
                    fused_external_fold=2 * cc_read_want["fused_external_fold"]
                    + cc_write_want["fused_external_fold"],
                    ntt_fwd=cc_write_want["ntt_fwd"])
    for what, (a_, b_) in {"recorded read": (s_out, rread_out[i0]),
                           "recorded rpw": (s_rpw, c0["out"]),
                           "recorded write": (s_new.data, c0["new"].data),
                           "plain read": (p_out, rread_out[i0]),
                           "plain rpw": (p_rpw, c0["out"]),
                           "plain write": (p_new.data, c0["new"].data),
                           "composed read": (cr_out, rread_out[i0]),
                           "composed rpw": (cr_rpw, c0["out"]),
                           "composed write": (cr_new.data, c0["new"].data)}.items():
        if not torch.equal(a_, b_):
            fail(f"readme_rmw: the {what} differs from the kernels' fused call")
    unchecked = set(rseen) - set(rplain_seen)
    if unchecked:
        fail(f"readme_rmw: shapes {sorted(unchecked)} launched, not held against the "
             "plain versions")
    if args.profile:
        traced("README read", lambda: rserver.read(rstate, rprep[i0]),
               statistics.median(rread_ms))
        pend = []
        traced("README read_prepare_write", lambda: pend.append(rserver.read_prepare_write(
            c0["state"], rprep[c0["address"]])[1]),
            statistics.median(c["rpw_ms"] for c in rcycles))
        traced("README write", lambda: rserver.write(pend[0], rw_cts[0], rcoeff[c0["address"]]),
               statistics.median(c["write_ms"] for c in rcycles))
    emit({"phase": "readme_rmw", "ok": True, "preset": "PARAMS_README_2_18",
          "card": card, "digits": r_digits, "reads": README_READS,
          "read_addresses": rr_idx, "cycles": CYCLES,
          "cycle_addresses": rc_idx[0::2], "neighbours": rc_idx[1::2],
          "readme_read_ms": statistics.median(rread_ms), "readme_read_ms_all": rread_ms,
          "readme_rpw_ms": statistics.median(c["rpw_ms"] for c in rcycles),
          "readme_write_ms": statistics.median(c["write_ms"] for c in rcycles),
          "readme_rpw_ms_all": [c["rpw_ms"] for c in rcycles],
          "readme_write_ms_all": [c["write_ms"] for c in rcycles],
          "plain_first_read_and_cycle_ms": rplain_ms,
          "composed_first_read_and_cycle_ms": rcomposed_ms,
          "equal_to": "the first read, rpw read-out and new RAM == the plain "
                      "versions' == the composed server's",
          "shapes_launched": sorted(rseen),
          "worst_noise_log2": worst_r, "noise_bound_log2": -(CPAR.k_pt + 1),
          "launches_per_call": {"read": c_read_want, "write": c_write_want,
                                "composed_read": cc_read_want,
                                "composed_write": cc_write_want}})
    del rserver, rcserver, rstate, rkeys, rcycles, rread_out, p_new, cr_new, s_new

    # ---- demo: fhe_ram_tpu_torch/examples/fhe_ram_demo.py at PARAMS_CODE_2_14 --
    # The port's demo as a user runs it (its own client from --seed: keygen,
    # 2^14 x 4 bytes, an address, a word): fused, composed, and fused again
    # through the plain versions.  Every step decodes (run raises
    # otherwise); the read, the rpw read-out and pending state, the new RAM
    # and both reads after the write are the same integers in the three
    # runs; the counts are set to 0 before each run and read after it (its
    # client's transforms included), and each timed server step launches
    # what rmw_cycle_launches counts.
    from fhe_ram_tpu_torch.params import PARAMS_CODE_2_14 as DPAR

    d_read_want, d_write_want = rmw_cycle_launches(DPAR)
    dc_read_want, dc_write_want = rmw_cycle_launches(DPAR, composed=True)
    demo_runs, demo_launches = {}, {}
    for route, composed in (("fused", False), ("composed", True), ("plain", False)):
        ntt_cuda.reset_launches()
        with (ntt_cuda.plain_versions() if route == "plain" else contextlib.nullcontext(),
              contextlib.redirect_stdout(io.StringIO())):
            try:
                demo_runs[route] = fhe_ram_demo.run(DEMO_CONFIG, dev, seed=args.seed,
                                                    composed=composed)
            except RuntimeError as e:
                fail(f"demo ({route}): {e}")
        demo_launches[route] = dict(ntt_cuda.LAUNCHES)
    for route, (rd_, wr_) in (("fused", (d_read_want, d_write_want)),
                              ("composed", (dc_read_want, dc_write_want))):
        steps = demo_runs[route]["launches"]
        for step, want in (("read", rd_), ("read_prepare_write", rd_), ("write", wr_)):
            expect_launches(f"demo ({route}) {step}", {k: steps[step].get(k, 0)
                                                        for k in ntt_cuda.LAUNCHES}, **want)
    only_composed("demo (composed)", demo_launches["composed"])
    if any(demo_launches["plain"].values()):
        fail(f"demo (plain): launches {demo_launches['plain']}")
    want_t = demo_runs["fused"]["tensors"]
    for route in ("composed", "plain"):
        for name, t in demo_runs[route]["tensors"].items():
            same = (len(t) == len(want_t[name]) and all(
                torch.equal(a, b) for a, b in zip(t, want_t[name]))
                if name == "rpw_tree" else torch.equal(t, want_t[name]))
            if not same:
                fail(f"demo: {route} {name} differs from the fused run's")
        if demo_runs[route]["values"] != demo_runs["fused"]["values"]:
            fail(f"demo: {route} decoded other values")
    emit({"phase": "demo", "ok": True, "preset": demo_runs["fused"]["preset"],
          "config": DEMO_CONFIG, "card": card, "seed": args.seed,
          "address": demo_runs["fused"]["address"],
          "equal_across": ["fused", "composed", "plain"],
          "compared": sorted(want_t), "values": demo_runs["fused"]["values"],
          "worst_noise_log2": {r: max(d["worst_noise_log2"].values())
                               for r, d in demo_runs.items()},
          "noise_bound_log2": demo_runs["fused"]["noise_bound_log2"],
          "ms": {r: {k: v * 1e3 for k, v in d["seconds"].items()}
                 for r, d in demo_runs.items()},
          "launches_per_step": {r: demo_runs[r]["launches"] for r in ("fused", "composed")},
          "launches_per_run": {r: {k: v for k, v in c_.items() if v}
                               for r, c_ in demo_launches.items()}})
    del demo_runs, want_t

    # ---- the VM instruction cycle at PARAMS_2_18_READOPT -----------------------
    from fhe_ram_tpu_torch.vm import arithmetic, conversion, fheuint, store
    from fhe_ram_tpu_torch.vm.cycle import vm_cycle

    VW, vbits = VPAR.word_size, 8 * VPAR.word_size
    t0 = time.time()
    vsrc = rng.Source(args.seed + 7)
    vsk = rng.ternary_secret(vsrc.split(), VPAR.rank, VPAR.n, VPAR.xs_density,
                              device=dev)
    vs_ntt = glwe.secret_prepare(vctx, vsk)
    vkeys = keys_mod.prepare(VPAR, keys_mod.keygen(VPAR, vsk, vsrc))
    vdata = np.random.default_rng(args.seed + 8).integers(
        0, 256, size=VPAR.max_addr * VW).astype(np.uint8)
    vram = ram_mod.encrypt_ram(VPAR, vctx, vs_ntt, vdata, vsrc)
    vserver = ram_mod.FheRam(VPAR, vkeys, device=dev)
    ops = arithmetic.RVI32_OPS
    log_ops = (len(ops) - 1).bit_length()
    vpicks = [int(a) for a in np.random.default_rng(args.seed + 9).choice(
        VPAR.max_addr, size=len(VM_PLAN) + 2, replace=False)]
    vrnd = np.random.default_rng(args.seed + 10)

    def u32(idx, plain):
        return int.from_bytes(bytes(plain[idx * VW: (idx + 1) * VW]), "little")

    def operands(op, sop, offset, ptr, plain):
        """The client's operands of one cycle and what it must give."""
        a, b, imm = (int(x) for x in vrnd.integers(0, 1 << 32, size=3))
        loaded = u32(ptr, plain)
        enc = dict(
            rs1p=fheuint.encrypt_prepared(VPAR, vctx, vs_ntt, a, vsrc, vbits),
            rs2p=fheuint.encrypt_prepared(VPAR, vctx, vs_ntt, b, vsrc, vbits),
            immp=fheuint.encrypt_prepared(VPAR, vctx, vs_ntt, imm, vsrc, vbits),
            op_id_prep=fheuint.encrypt_prepared(VPAR, vctx, vs_ntt, ops.index(op),
                                                vsrc, log_ops),
            rs2_word=fheuint.encrypt_word(VPAR, vctx, vs_ntt, b, vsrc, vbits),
            loaded_word=fheuint.encrypt_word(VPAR, vctx, vs_ntt, loaded, vsrc, vbits),
            offset_prep=fheuint.encrypt_prepared(VPAR, vctx, vs_ntt, offset, vsrc, 2),
            storeop_prep=fheuint.encrypt_prepared(
                VPAR, vctx, vs_ntt, store.STORE_OPS.index(sop), vsrc, 2),
            ptr_prep=fheuint.encrypt_prepared(
                VPAR, vctx, vs_ntt, ptr, vsrc, VPAR.max_addr.bit_length() - 1,
                dnum=VPAR.dnum_ggsw, limbs=VPAR.limbs_evk_ggsw))
        return enc, alu_model(op, a, b, imm), store_model(sop, offset, loaded, b)

    def vdecode(out, idx, what, plain):
        """Every byte of the RAM word read at idx equals `plain`'s, under the
        noise bound; returns the worst log2 noise."""
        if tuple(out.shape) != (VW, C, VPAR.limbs_ct, VPAR.n):
            fail(f"{what} at {idx}: output {tuple(out.shape)}")
        worst = -1e9
        ph = glwe.phase(VPAR, vctx, vs_ntt, out)
        for i in range(VW):
            want = glwe.cast_u8_signed(int(plain[idx * VW + i]), VPAR.k_pt)
            val, noise = glwe.decode_coeff0(VPAR, ph[i], want)
            if int(val) != want or not noise < -(VPAR.k_pt + 1):
                fail(f"{what} at {idx}, byte {i}: decoded {int(val)} (noise "
                     f"2^{float(noise):.2f}), stored {want}")
            worst = max(worst, float(noise))
        return worst

    plan = [(op, sop, off, vpicks[k]) for k, (op, sop, off) in enumerate(VM_PLAN)]
    quiet_v = vpicks[len(VM_PLAN):]
    expected = [operands(op, sop, off, ptr, vdata) for op, sop, off, ptr in plan]
    torch.cuda.synchronize()
    vm_setup_s = time.time() - t0
    seen = {k: collections.Counter() for k in VM_KERNELS}   # shape -> launches, cycle 0
    real = {k: getattr(ntt_cuda, k) for k in VM_KERNELS}

    def recording(name):
        def call(ctx_, *a):
            seen[name][vm_note(name, *a)] += 1
            return real[name](ctx_, *a)
        return call

    ntt_cuda.reset_launches()
    vstate, vm_ms, per_cycle, vm_rd, vm_fetched = vram, [], [], [], []
    vm_inputs = []
    for k, (enc, _, _) in enumerate(expected):
        if k == 0:
            for name in VM_KERNELS:
                setattr(ntt_cuda, name, recording(name))
        try:
            (rd, fetched, new_vstate), ms, l_c = launches_of(
                lambda: vm_cycle(VPAR, vctx, vkeys, data=vstate, **enc))
        finally:
            for name in VM_KERNELS:
                setattr(ntt_cuda, name, real[name])
        expect_launches(f"vm_cycle {k}", l_c, **VM_CYCLE_LAUNCHES)
        vm_inputs.append((vstate, enc))
        vm_ms.append(ms)
        per_cycle.append(l_c)
        vm_rd.append(rd)
        vm_fetched.append(fetched)
        vstate = new_vstate
    vm_launches = dict(ntt_cuda.LAUNCHES)
    for name in VM_KERNELS + ("fused_external_fold_batched", "fused_trace",
                              "fused_external_fold", "fused_split"):
        if vm_launches[name] == 0:
            fail(f"kernel {name} was not launched on the VM cycle's path")
    for name, notes in seen.items():
        checked = {r["shape"] for r in checks.get(name, [])}
        if not notes or not set(notes) <= checked:
            fail(f"{name}: the cycle launched shapes {sorted(set(notes) - checked)} "
                 "that no kernel check held against the plain version")
    # decode (outside the counted window): rd, the fetched word, and after
    # all cycles the stored words and two addresses no cycle touched
    worst_rd, worst_ram = -1e9, -1e9
    written = vdata.copy()
    for k, ((op, sop, off, ptr), (_, rd_want, st_want)) in enumerate(
            zip(plan, expected)):
        got = fheuint.decrypt_word(VPAR, vctx, vs_ntt, vm_rd[k], vbits)
        if got != rd_want:
            fail(f"vm_cycle {k} ({op}): rd decodes to {got:#x}, expected {rd_want:#x}")
        worst_rd = max(worst_rd, fheuint.word_noise_log2(VPAR, vctx, vs_ntt, vm_rd[k],
                                                         rd_want, vbits))
        worst_ram = max(worst_ram, vdecode(vm_fetched[k], ptr, "vm_cycle fetch",
                                           written))
        written[ptr * VW: (ptr + 1) * VW] = list(st_want.to_bytes(VW, "little"))
    final = vserver.init_state(vstate)

    def vread(idx):
        return vserver.read(final, address_mod.prepare(
            vctx, address_mod.encrypt(VPAR, vctx, vs_ntt, idx, vsrc)))

    for _, _, _, ptr in plan:
        worst_ram = max(worst_ram, vdecode(vread(ptr), ptr, "store read-back", written))
    for idx in quiet_v:
        worst_ram = max(worst_ram, vdecode(vread(idx), idx,
                                           "read of an address no cycle stored to",
                                           written))
    if not max(worst_rd, worst_ram) < -(VPAR.k_pt + 1):
        fail(f"vm_cycle: worst noise 2^{max(worst_rd, worst_ram):.2f}")
    # the parts, timed apart on the last cycle's inputs (three calls each)
    st_l, enc_l = vm_inputs[-1]
    atk_v = vkeys.atk_glwe
    packed = arithmetic.eval_ops(VPAR, vctx, enc_l["rs1p"], enc_l["rs2p"],
                                 enc_l["immp"], atk_v, ops, vbits)
    parts = {
        "eval_ops_ms": lambda: arithmetic.eval_ops(
            VPAR, vctx, enc_l["rs1p"], enc_l["rs2p"], enc_l["immp"], atk_v, ops, vbits),
        "select_rd_ms": lambda: arithmetic.select_rd(
            VPAR, vctx, packed, enc_l["op_id_prep"], len(ops), atk_v, vbits),
        "select_store_ms": lambda: store.select_store(
            VPAR, vctx, enc_l["rs2_word"], enc_l["loaded_word"], enc_l["offset_prep"],
            enc_l["storeop_prep"], atk_v, vbits),
        "fheuint_to_address_ms": lambda: conversion.fheuint_to_address(
            VPAR, vctx, enc_l["ptr_prep"]),
    }
    part_ms = {k: statistics.median([timed(f)[1] for _ in range(3)])
               for k, f in parts.items()}
    del packed
    emit({"phase": "vm_cycle", "ok": True, "preset": "PARAMS_2_18_READOPT",
          "max_addr": VPAR.max_addr, "word_bits": vbits, "ops": len(ops),
          "cycles": [{"op": op, "store": sop, "offset": off, "pointer": ptr}
                     for op, sop, off, ptr in plan],
          "unchanged_addresses": quiet_v,
          "vm_cycle_ms": statistics.median(vm_ms), "vm_cycle_ms_all": vm_ms,
          **part_ms,
          "worst_noise_log2": max(worst_rd, worst_ram),
          "worst_rd_noise_log2": worst_rd, "worst_ram_noise_log2": worst_ram,
          "noise_bound_log2": -(VPAR.k_pt + 1),
          "launches_per_cycle": per_cycle[0],
          "vm_kernel_shapes": {k: dict(sorted(v.items())) for k, v in seen.items()},
          "setup_seconds": round(vm_setup_s, 2)})

    # ---- the last cycle again through the plain versions, on the card ------
    with ntt_cuda.plain_versions():
        (p_rd, p_fetched, p_state), plain_vm_ms = timed(
            lambda: vm_cycle(VPAR, vctx, vkeys, data=st_l, **enc_l))
    if not (torch.equal(p_rd, vm_rd[-1]) and torch.equal(p_fetched, vm_fetched[-1])
            and torch.equal(p_state, vstate)):
        fail("vm_cycle: kernels and plain versions disagree")
    emit({"phase": "vm_cycle_vs_plain", "ok": True, "pointer": plan[-1][3],
          "compared": "rd, fetched and all of the new RAM "
                      f"int32{list(vstate.shape)}",
          "plain_vm_cycle_ms": plain_vm_ms})
    del p_rd, p_fetched, p_state, vm_inputs, final

    # ---- composed_vm_cycle: the VM's composed routes (a two-pass context) ----
    # The JAX package's FHERAM_MXU=0 branches: the carry DP and the bitwise
    # group as loops of keyed CMuxes (kernel 5), the blind rotations one CMux
    # a bit, every trace step, merge and split level one fold (kernel 2) and
    # torch glue.  COMPOSED_VM_PLAN's cycles chain on the RAM the fused cycles
    # left, at pointers no cycle used, on the vm_cycle phase's client and
    # keys; after the counted window each cycle runs again fused on the same
    # inputs: fetched and the new RAM bit-equal.  rd decodes: select_rd
    # rotates with the full gadget here (the reference's composed branch),
    # where the fused route truncates, so rd is not the fused integers.
    vtctx = get_ntt_context(VPAR.n, VPAR.primes, "two_pass")
    c_ptrs = [int(a) for a in np.random.default_rng(args.seed + 11).choice(
        VPAR.max_addr, size=len(COMPOSED_VM_PLAN) + len(vpicks), replace=False)
        if int(a) not in vpicks][:len(COMPOSED_VM_PLAN)]
    c_plan = [(op, sop, off, c_ptrs[k])
              for k, (op, sop, off) in enumerate(COMPOSED_VM_PLAN)]
    c_expected = [operands(op, sop, off, ptr, written) for op, sop, off, ptr in c_plan]
    c_want_launches = composed_vm_launches(VPAR, vbits, len(ops))
    ntt_cuda.reset_launches()
    cstate, c_vm_ms, c_runs = vstate, [], []
    for (op, _, _, ptr), (enc, _, _) in zip(c_plan, c_expected):
        (rd, fetched, new_c), ms, l_c = launches_of(
            lambda: vm_cycle(VPAR, vtctx, vkeys, data=cstate, **enc))
        expect_launches(f"composed vm_cycle ({op}) at {ptr}", l_c, **c_want_launches)
        c_runs.append((cstate, enc, rd, fetched, new_c))
        c_vm_ms.append(ms)
        cstate = new_c
    c_vm_launches = dict(ntt_cuda.LAUNCHES)
    only_composed("composed_vm_cycle", c_vm_launches)
    worst_crd, worst_cram, worst_frd, rd_equal = -1e9, -1e9, -1e9, []
    for (op, sop, off, ptr), (_, rd_want, _), (st0, enc, rd, fetched, new_c) in zip(
            c_plan, c_expected, c_runs):
        f_rd, f_fetched, f_new = vm_cycle(VPAR, vctx, vkeys, data=st0, **enc)
        if not (torch.equal(fetched, f_fetched) and torch.equal(new_c, f_new)):
            fail(f"composed vm_cycle ({op}) at {ptr}: fetched or the new RAM differs "
                 "from the fused cycle's")
        got = fheuint.decrypt_word(VPAR, vctx, vs_ntt, rd, vbits)
        if got != rd_want:
            fail(f"composed vm_cycle ({op}): rd decodes to {got:#x}, "
                 f"expected {rd_want:#x}")
        worst_crd = max(worst_crd, fheuint.word_noise_log2(VPAR, vctx, vs_ntt, rd,
                                                           rd_want, vbits))
        worst_frd = max(worst_frd, fheuint.word_noise_log2(VPAR, vctx, vs_ntt, f_rd,
                                                           rd_want, vbits))
        worst_cram = max(worst_cram, vdecode(fetched, ptr, "composed vm_cycle fetch",
                                             written))
        rd_equal.append(bool(torch.equal(rd, f_rd)))
        del f_rd, f_fetched, f_new
    if not max(worst_crd, worst_cram) < -(VPAR.k_pt + 1):
        fail(f"composed vm_cycle: worst noise 2^{max(worst_crd, worst_cram):.2f}")
    emit({"phase": "composed_vm_cycle", "ok": True, "preset": "PARAMS_2_18_READOPT",
          "cycles": [{"op": op, "store": sop, "offset": off, "pointer": ptr}
                     for op, sop, off, ptr in c_plan],
          "equal_to_fused_cycle": "fetched and all of each new RAM",
          "rd_bit_equal_to_fused": rd_equal,
          "composed_vm_cycle_ms": statistics.median(c_vm_ms),
          "composed_vm_cycle_ms_all": c_vm_ms, "vm_cycle_ms": statistics.median(vm_ms),
          "worst_rd_noise_log2": worst_crd, "fused_worst_rd_noise_log2": worst_frd,
          "worst_fetch_noise_log2": worst_cram, "noise_bound_log2": -(VPAR.k_pt + 1),
          "launches_per_cycle": l_c})

    # ---- composed_vm_vs_plain: the last composed cycle through the plain ------
    # versions on the card: rd, fetched and the whole new RAM bit-equal
    c_vm_last = c_runs[-1][:2]
    st0, enc, rd, fetched, new_c = c_runs[-1]
    with ntt_cuda.plain_versions():
        (p_rd, p_fetched, p_state), plain_cvm_ms = timed(
            lambda: vm_cycle(VPAR, vtctx, vkeys, data=st0, **enc))
    if not (torch.equal(p_rd, rd) and torch.equal(p_fetched, fetched)
            and torch.equal(p_state, new_c)):
        fail("composed vm_cycle: kernels and plain versions disagree")
    emit({"phase": "composed_vm_vs_plain", "ok": True, "pointer": c_plan[-1][3],
          "compared": "rd, fetched and all of the new RAM",
          "plain_composed_vm_cycle_ms": plain_cvm_ms})
    del p_rd, p_fetched, p_state, c_runs, rd, fetched, new_c, cstate

    # ---- the VM LOAD at PARAMS_2_18_TURBO_READOPT (vm/bitdecomp.py) ---------
    # The port's own client makes the bootstrapping key of the read phase's
    # secret (flat coefficient form, gadget of LOAD_KEY_LIMBS limbs); a word
    # read from the RAM cell's server is decomposed into its 32 bits: the
    # word form and the prepared (lifted) GGSW bits
    from fhe_ram_tpu_torch.core import ggsw, keyswitch
    from fhe_ram_tpu_torch.vm import bitdecomp

    LB = LOAD_BYTE_BITS * W
    phases = -(-LOAD_BYTE_BITS // LOAD_CHUNK)
    steps = PAR.rank * n
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    t0 = time.time()
    bsk_key = bitdecomp.bootstrap_key_fast(PAR, ctx, sk, s_ntt, src, limbs=LOAD_KEY_LIMBS,
                                           chunk=LOAD_KEY_CHUNK)
    torch.cuda.synchronize()
    key_s = time.time() - t0
    key_peak = torch.cuda.max_memory_allocated() - base_bytes
    lidx = int(np.random.default_rng(args.seed + 30).integers(0, PAR.max_addr))
    fetched = server.read(state, prepared(lidx))
    decode(fetched, lidx, "the LOAD's read")
    lwant = sum(int(data[lidx * W + i]) << (LOAD_BYTE_BITS * i) for i in range(W))
    # the shapes the wrappers of the LOAD's path are called at, and how often
    load_seen = {k: collections.Counter() for k in LOAD_WRAPPERS.values()}
    real_load = {a: getattr(ntt_cuda, a) for a in LOAD_WRAPPERS}

    def record_load(on, seen=load_seen):
        for attr, name in LOAD_WRAPPERS.items():
            if not on:
                setattr(ntt_cuda, attr, real_load[attr])
                continue

            def call(ctx_, *a, _attr=attr, _name=name, **kw):
                body = LOAD_TWO_PASS if ctx_.body == "two_pass" else ""
                seen[_name][load_note(*a, **kw) + body] += 1
                return real_load[_attr](ctx_, *a, **kw)
            setattr(ntt_cuda, attr, call)

    def load(key, lctx=ctx):
        return bitdecomp.load_word(PAR, lctx, fetched, key, ekp, LB)

    def counted_load(key, what, lctx=ctx, seen=load_seen, **want):
        record_load(True, seen)
        try:
            out, ms, delta = launches_of(lambda: load(key, lctx))
        finally:
            record_load(False)
        expect_launches(what, delta, **want)
        return out, ms, delta

    # launches of a load, from the code: a chain step is one keyed product
    # (kernel 5) and, with the key in a coefficient form, the transform of
    # its GGSW pair; a phase is rank*N steps and one trace; the lift folds
    # each digit row against each mask component's tensor key and
    # transforms the lifted stack once
    lift_folds = bitdecomp._LIFT_ROWS * PAR.rank
    (lword, lprep), first_ms, load_launches = counted_load(
        bsk_key, "load", fused_external_fold_batched=phases * steps,
        ntt_fwd=phases * steps + 1, fused_trace=phases, fused_external_fold=lift_folds)
    per_load = {k: dict(v) for k, v in load_seen.items()}   # shape -> launches a load

    def timed_loads(lctx, what):
        """LOAD_TIMED loads on bsk_key after the counted one, the wrappers
        unrecorded: (host-clock ms, CUDA-event ms) of each; each bit-equal
        to the fused load's word and prepared bits."""
        host_ms, event_ms = [], []
        for _ in range(LOAD_TIMED):
            ev0, ev1 = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev0.record()
            again = load(bsk_key, lctx)
            ev1.record()
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            event_ms.append(ev0.elapsed_time(ev1))
            if not (torch.equal(again[0], lword) and torch.equal(again[1], lprep)):
                fail(f"{what}: a timed load differs from the fused counted load")
        return host_ms, event_ms

    load_ms, load_event_ms = timed_loads(ctx, "load")
    # decode (outside the counted window): the word, then a select of an
    # encrypted m by each of some lifted bits
    got = fheuint.decrypt_word(PAR, ctx, s_ntt, lword, LB)
    if got != lwant:
        fail(f"load at {lidx}: the word decodes to {got:#x}, stored {lwant:#x}")
    bit_noise = fheuint.word_noise_log2(PAR, ctx, s_ntt, lword, lwant, LB)
    if not bit_noise < -(PAR.k_pt + 1):
        fail(f"load at {lidx}: bit noise 2^{bit_noise:.2f} over the bound")
    m_sel = 3
    mv = np.zeros(n, dtype=np.int64)
    mv[0] = m_sel
    ct_m = glwe.encrypt(PAR, ctx, s_ntt, glwe.encode_vec(PAR, mv, device=dev), src)
    select_noise = {}
    for j in LOAD_SELECT_BITS:
        b = (lwant >> j) & 1
        sel = ggsw.external_product(PAR, ctx, ct_m, lprep[:, j])
        val, noise = glwe.decode_coeff0(PAR, glwe.phase(PAR, ctx, s_ntt, sel), b * m_sel)
        if int(val) != b * m_sel or not noise < -(PAR.k_pt + 1):
            fail(f"load: the select by lifted bit {j} decodes to {int(val)} (noise "
                 f"2^{float(noise):.2f}), expected {b * m_sel}")
        select_noise[j] = float(noise)
    load_rec = {"phase": "load", "ok": True, "preset": "PARAMS_2_18_TURBO_READOPT",
                "address": lidx, "word": f"{lwant:#010x}", "bits": LB,
                "byte_bits": LOAD_BYTE_BITS, "chunk": LOAD_CHUNK,
                "key_limbs": LOAD_KEY_LIMBS, "key_shape": list(bsk_key.shape),
                "key_bytes": bsk_key.numel() * 4, "key_setup_seconds": round(key_s, 2),
                "key_setup_peak_device_bytes": key_peak,
                "load_ms_median": statistics.median(load_ms), "load_ms": load_ms,
                "load_event_ms": load_event_ms, "first_load_ms": first_ms,
                "launches_per_load": {k: v for k, v in load_launches.items() if v},
                "worst_bit_noise_log2": bit_noise,
                "select_noise_log2": select_noise,
                "worst_select_noise_log2": max(select_noise.values()),
                "noise_bound_log2": -(PAR.k_pt + 1)}

    # ---- the first LOAD_PREFIX chain steps of that word through the plain
    # versions: the first phase's accumulators, then its trace, its affine
    # and the lift of its rows, each bit-equal
    R_lift = bitdecomp._LIFT_ROWS
    ks0 = list(range(min(LOAD_CHUNK, LOAD_BYTE_BITS)))
    cts0 = torch.repeat_interleave(bitdecomp.unsigned_bytes(PAR, fetched, LOAD_BYTE_BITS),
                                   len(ks0) * R_lift, dim=0)
    acc0, amounts0 = bitdecomp.chain_start(
        PAR, cts0, *bitdecomp.phase_tests(PAR, W, ks0, R_lift, 1))

    def load_prefix():
        acc = bitdecomp.chain(PAR, ctx, acc0, bsk_key, range(LOAD_PREFIX),
                              amounts0[:, :LOAD_PREFIX])
        tr = keyswitch.trace(PAR, ctx, acc, ekp.atk_glwe)
        rk, bk = bitdecomp.phase_bits(PAR, tr, W, len(ks0), R_lift)
        return acc, tr, rk, bk, bitdecomp.bits_to_prepared(
            PAR, ctx, rk.reshape((-1,) + tuple(rk.shape[2:])), ekp)

    k_pre, k_pre_ms = timed(load_prefix)
    with ntt_cuda.plain_versions():
        p_pre, p_pre_ms = timed(load_prefix)
    for what, a_, b_ in zip(("chain", "trace", "digit rows", "bits", "lift"), k_pre, p_pre):
        if not torch.equal(a_, b_):
            fail(f"load_vs_plain: {what} after {LOAD_PREFIX} steps, kernels and plain "
                 "versions disagree")
    del k_pre, p_pre, acc0, amounts0, cts0

    # ---- the key prepared once, and one load on it: bit-equal -----------------
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    ev0.record()
    bsk_prep = ggsw.prepare(ctx, bsk_key.view((steps, 2, PAR.dnum_ct, C, C,
                                               LOAD_KEY_LIMBS, n)))
    ev1.record()
    torch.cuda.synchronize()
    key_prep_ms = ev0.elapsed_time(ev1)
    prep_peak = torch.cuda.max_memory_allocated() - base_bytes
    key_polys = bsk_key.numel() // n
    k_bound = bound(key_polys * poly_b * (1 + P), key_polys * P * ntt_ops(n))
    timed_only.setdefault("ntt_fwd", []).append({
        "shape": f"x{list(bsk_prep.shape[1:])} (the LOAD's key, prepared once)",
        "ms": key_prep_ms, "bound_ms": k_bound[0], "bound_by": k_bound[1],
        "held_by": "the load on the prepared key == the load on the coefficient key"})
    (pword, pprep), prep_load_ms, prep_launches = counted_load(
        bsk_prep, "load on the prepared key", fused_external_fold_batched=phases * steps,
        ntt_fwd=1, fused_trace=phases, fused_external_fold=lift_folds)
    if not (torch.equal(pword, lword) and torch.equal(pprep, lprep)):
        fail("load: the prepared key's load differs from the coefficient key's")
    for name, notes in load_seen.items():
        checked = {r["shape"] for r in checks.get(name, [])}
        if not notes or not set(notes) <= checked:
            fail(f"{name}: the LOAD launched shapes {sorted(set(notes) - checked)} "
                 "that no kernel check held against the plain version")
    load_rec.update({
        "prepared_key_bytes": bsk_prep.numel() * 4, "key_prepare_ms": key_prep_ms,
        "prepared_peak_device_bytes": prep_peak, "prepared_load_ms": prep_load_ms,
        "prepared_launches_per_load": {k: v for k, v in prep_launches.items() if v},
        "prepared_equal_to_coefficient": True,
        "launches_per_load_by_shape": per_load})
    emit(load_rec)
    emit({"phase": "load_vs_plain", "ok": True, "address": lidx, "steps": LOAD_PREFIX,
          "tests": len(ks0) * R_lift * W,
          "compared": "accumulators, trace, digit rows, value bits, prepared lift",
          "kernel_ms": k_pre_ms, "plain_ms": p_pre_ms})
    if args.profile:
        traced("load_word (coefficient key)", lambda: load(bsk_key),
               statistics.median(load_ms), top=24)
    del bsk_prep, pword, pprep
    torch.cuda.empty_cache()

    # ---- composed_load: the same word's LOAD on the two-pass context ---------
    # The composed routes (the JAX package's LOAD reaches them through
    # fused_path_active): the chain as on the fused route (kernel 5 a step,
    # the pair's transform), each trace step one fold, the lift's folds; on
    # the coefficient key of the load phase, so no second prepared key.
    # Counted once, every launch kernel 1, 2 or 5 at a shape the kernel
    # checks held under the two-pass context; then timed as the fused load
    # is (LOAD_TIMED loads, unrecorded), so the two medians compare, as do
    # the two counted first loads.
    load_seen_c = {k: collections.Counter() for k in LOAD_WRAPPERS.values()}
    (cword, cprep), c_first_ms, c_load_launches = counted_load(
        bsk_key, "composed load", lctx=tctx, seen=load_seen_c,
        fused_external_fold_batched=phases * steps, ntt_fwd=phases * steps + 1,
        fused_external_fold=phases * PAR.log_n + lift_folds)
    only_composed("composed_load", c_load_launches)
    if not (torch.equal(cword, lword) and torch.equal(cprep, lprep)):
        fail("composed load: the word or the prepared bits differ from the fused load's")
    for name, notes in load_seen_c.items():
        checked = {r["shape"] for r in checks.get(name, [])}
        if not set(notes) <= checked:
            fail(f"{name}: the composed LOAD launched shapes "
                 f"{sorted(set(notes) - checked)} that no kernel check held")
    c_load_ms, c_load_event_ms = timed_loads(tctx, "composed load")
    emit({"phase": "composed_load", "ok": True, "preset": "PARAMS_2_18_TURBO_READOPT",
          "card": card, "address": lidx, "context": "two_pass",
          "equal_to_fused_load": "word and prepared bits",
          "composed_load_ms_median": statistics.median(c_load_ms),
          "composed_load_ms": c_load_ms, "composed_load_event_ms": c_load_event_ms,
          "composed_first_load_ms": c_first_ms,
          "fused_load_ms_median": statistics.median(load_ms), "fused_load_ms": load_ms,
          "fused_load_event_ms": load_event_ms, "fused_first_load_ms": first_ms,
          "launches_per_load": {k: v for k, v in c_load_launches.items() if v},
          "launches_per_load_by_shape": {k: dict(v) for k, v in load_seen_c.items() if v}})
    del cword, cprep, bsk_key, lword, lprep, fetched
    torch.cuda.empty_cache()

    # ---- the 2^24 configuration: the unsharded read, then the row-sharded ----
    # paths on a mesh whose shards all lie on this card (kernels 13 and 14)
    bctx = get_ntt_context(BPAR.n, BPAR.primes)
    BW, BC, BL = BPAR.word_size, BPAR.rank + 1, BPAR.limbs_ct
    LV = BPAR.num_rows.bit_length() - 1   # merge levels of the pack: 12
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    bsrc = rng.Source(args.seed + 24)
    bsk = rng.ternary_secret(bsrc.split(), BPAR.rank, BPAR.n, BPAR.xs_density,
                             device=dev)
    bs_ntt = glwe.secret_prepare(bctx, bsk)
    bkeys = keys_mod.prepare(BPAR, keys_mod.keygen(BPAR, bsk, bsrc))
    bdata = np.random.default_rng(args.seed + 25).integers(
        0, 256, size=BPAR.max_addr * BW).astype(np.uint8)
    bserver = ram_mod.FheRam(BPAR, bkeys, device=dev)
    bstate = bserver.init_state(ram_mod.encrypt_ram(BPAR, bctx, bs_ntt, bdata, bsrc))
    torch.cuda.synchronize()
    big_setup_s = time.time() - t0
    big_setup_peak = torch.cuda.max_memory_allocated()
    batk = bkeys.atk_glwe
    # distinct addresses: reads (also the batch's first half), the batch's
    # second half, three write cycles, the batched RMW
    bpicks = [int(a) for a in np.random.default_rng(args.seed + 26).choice(
        BPAR.max_addr, size=2 * BIG_READS + 3 + NB_BIG_RMW, replace=False)]
    big_reads, big_more = bpicks[:BIG_READS], bpicks[BIG_READS: 2 * BIG_READS]
    big_cycles = bpicks[2 * BIG_READS: 2 * BIG_READS + 3]
    big_rmw = bpicks[2 * BIG_READS + 3:]

    def baddress(idx):
        coeff = address_mod.encrypt(BPAR, bctx, bs_ntt, idx, bsrc)
        return coeff, address_mod.prepare(bctx, coeff)

    def bdecode(out, idx, what, plain):
        """Every byte of the word at idx equals `plain`'s, under the noise
        bound; returns the worst log2 noise."""
        if tuple(out.shape) != (BW, BC, BL, BPAR.n) or out.dtype != torch.int32:
            fail(f"{what} at {idx}: output {tuple(out.shape)} {out.dtype}")
        worst = -1e9
        ph = glwe.phase(BPAR, bctx, bs_ntt, out)
        for i in range(BW):
            want = glwe.cast_u8_signed(int(plain[idx * BW + i]), BPAR.k_pt)
            val, noise = glwe.decode_coeff0(BPAR, ph[i], want)
            if int(val) != want or not noise < -(BPAR.k_pt + 1):
                fail(f"{what} at {idx}, byte {i}: decoded {int(val)} (noise "
                     f"2^{float(noise):.2f}), stored {want}")
            worst = max(worst, float(noise))
        return worst

    def same_on_every_shard(outs, want, what):
        """Every shard's copy of a replicated output equals `want`."""
        for k, o in enumerate(outs):
            if not torch.equal(o, want):
                fail(f"{what}: shard {k}'s output differs from the unsharded one")

    def equal_to_plain(kernel_out, fn, what):
        """fn() again through the plain versions on the card, collectives
        included: every tensor of its (nested) output bit-equal to
        kernel_out; returns the plain run's ms.  Not counted: outside
        `counted`, and the plain versions launch nothing."""
        with ntt_cuda.plain_versions():
            plain_out, plain_ms = timed(fn)

        def walk(a, b, where):
            if isinstance(a, torch.Tensor):
                if not (isinstance(b, torch.Tensor) and torch.equal(a, b)):
                    fail(f"{what}: {where or 'the output'}, kernels and plain "
                         "versions disagree")
                return
            if len(a) != len(b):
                fail(f"{what}: {where}: {len(a)} parts against {len(b)}")
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{where}[{i}]")
        walk(kernel_out, plain_out, "")
        return plain_ms

    def same_outputs(a, b, what):
        """Every tensor of a (nested list) output bit-equal to b's."""
        if isinstance(a, torch.Tensor):
            if not torch.equal(a, b):
                fail(f"composed {what}: differs from the fused factory's output")
            return
        if len(a) != len(b):
            fail(f"composed {what}: {len(a)} parts against {len(b)}")
        for x, y in zip(a, b):
            same_outputs(x, y, what)

    # the collectives' launched shapes, recorded on the counted paths
    seen_coll = {k: set() for k in COLLECTIVES}
    real_coll = {k: getattr(coll_mod, k) for k in COLLECTIVES}

    def record_collectives(on):
        for name in COLLECTIVES:
            if not on:
                setattr(coll_mod, name, real_coll[name])
                continue

            def call(chunks, *a, _name=name):
                seen_coll[_name].add(collective_note(len(chunks), chunks[0], *a))
                return real_coll[_name](chunks, *a)
            setattr(coll_mod, name, call)

    def counted(fn, total):
        """launches_of(fn) with the collectives' shapes recorded, its
        launches added to `total` (a path's count: only the calls of the
        path itself, no comparison, read-back or client work)."""
        record_collectives(True)
        try:
            out, ms, delta = launches_of(fn)
        finally:
            record_collectives(False)
        for k_, v_ in delta.items():
            total[k_] += v_
        return out, ms, delta

    # ---- read_2_24: the unsharded read -----------------------------------------
    baddrs = {idx: baddress(idx) for idx in big_reads + big_more}
    read24_launches = dict.fromkeys(ntt_cuda.LAUNCHES, 0)
    big_ms, big_out, worst_big = [], {}, -1e9
    for idx in big_reads:
        out, ms, delta = counted(lambda: bserver.read(bstate, baddrs[idx][1]),
                                 read24_launches)
        expect_launches(f"2^24 read at {idx}", delta, **rmw_cycle_launches(BPAR)[0])
        big_ms.append(ms)
        big_out[idx] = out
    big_read_peak = torch.cuda.max_memory_allocated()
    for idx in big_reads:
        worst_big = max(worst_big, bdecode(big_out[idx], idx, "2^24 read", bdata))
    emit({"phase": "read_2_24", "ok": True, "preset": "PARAMS_2_24_READOPT",
          "max_addr": BPAR.max_addr, "word_size": BW, "rows": BPAR.num_rows,
          "addresses": big_reads, "read_2_24_ms": statistics.median(big_ms),
          "read_2_24_ms_all": big_ms, "worst_noise_log2": worst_big,
          "noise_bound_log2": -(BPAR.k_pt + 1), "launches_per_read": delta,
          "setup_seconds": round(big_setup_s, 2),
          "ram_ciphertext_bytes": bstate.data.numel() * 4,
          "peak_device_bytes_setup": big_setup_peak,
          "peak_device_bytes": big_read_peak})

    # ---- sharded_read: rows = 4 on this card, both collectives -------------
    n4 = SHARDS
    bmesh = mesh_mod.make_mesh(n4, rows=n4, devices=[dev] * n4)
    bshards = mesh_mod.shard_data_rows(bmesh, bstate.data)
    if not torch.equal(mesh_mod.unshard_rows(bshards), bstate.data):
        fail("unshard_rows does not invert shard_data_rows")
    shread_launches = dict.fromkeys(ntt_cuda.LAUNCHES, 0)
    sh_ms, sh_launches = {}, {}
    for col, tail in (("ring", {"ring_all_gather": 1}),
                      ("exchange", {"exchange": n4.bit_length() - 1})):
        fn = mesh_mod.sharded_read_fn(BPAR, bmesh, col)
        sh_ms[col] = []
        for idx in big_reads:
            outs, ms, delta = counted(lambda: fn(bshards, baddrs[idx][1].coordinates,
                                                 batk), shread_launches)
            expect_launches(f"sharded read ({col}) at {idx}", delta,
                            fused_external_fold=2 * n4,
                            fused_pack_merge=LV * n4, fused_trace=n4, **tail)
            same_on_every_shard(outs, big_out[idx], f"sharded read ({col}) at {idx}")
            sh_ms[col].append(ms)
        sh_launches[col] = delta
    emit({"phase": "sharded_read", "ok": True, "mesh": bmesh.shape,
          "devices": "one card", "addresses": big_reads,
          "equal_to_unsharded_read_on_every_shard": True,
          "sharded_read_ms": {c: statistics.median(v) for c, v in sh_ms.items()},
          "sharded_read_ms_all": sh_ms, "launches_per_read": sh_launches})

    # ---- sharded_batch: batched reads (dp 1 x rows 4) and the batched RMW --
    # (dp 2 x rows 2), against the unsharded reads and rmw_batch
    batch8 = big_reads + big_more
    for idx in big_more:
        big_out[idx] = bserver.read(bstate, baddrs[idx][1])
    coords8 = stack_addresses([baddrs[i][1] for i in batch8])
    want8 = torch.stack([big_out[i] for i in batch8])
    bcache = mesh_mod.sharded_spectral_cache_fn(BPAR, bmesh)(bshards)
    shbatch_launches = dict.fromkeys(ntt_cuda.LAUNCHES, 0)
    torch.cuda.reset_peak_memory_stats()
    sb_ms, sb_launches = {}, {}
    for with_cache in (False, True):
        fn = mesh_mod.batched_read_fn(BPAR, bmesh, with_cache=with_cache)
        key = "cached" if with_cache else "uncached"
        sb_ms[key] = []
        for _ in range(2):
            outs, ms, delta = counted(lambda: fn(
                bshards, mesh_mod.shard_addr_batch(bmesh, coords8), batk,
                bcache if with_cache else None), shbatch_launches)
            expect_launches(f"sharded batched read ({key})", delta,
                            fused_external_fold_batched=2 * n4,
                            ntt_fwd=0 if with_cache else n4,
                            fused_pack_merge=LV * n4, fused_trace=n4,
                            ring_all_gather=1)
            same_on_every_shard(outs[0], want8, f"sharded batched read ({key})")
            sb_ms[key].append(ms)
            del outs
        sb_launches[key] = delta
    batch_read_peak = torch.cuda.max_memory_allocated()
    del bcache
    mesh22 = mesh_mod.make_mesh(DP_RMW * ROWS_RMW, rows=ROWS_RMW,
                                devices=[dev] * (DP_RMW * ROWS_RMW))
    shards22 = mesh_mod.shard_data_rows(mesh22, bstate.data)
    rb_addrs = [baddress(i) for i in big_rmw]
    rb_coeff = stack_addresses([a for a, _ in rb_addrs])
    rb_prep = stack_addresses([p_ for _, p_ in rb_addrs])
    rb_words = np.random.default_rng(args.seed + 27).integers(
        0, 256, size=(NB_BIG_RMW, BW)).astype(np.uint8)
    rb_w = torch.stack([ram_mod.encrypt_write_word(BPAR, bctx, bs_ntt, w_, bsrc)
                        for w_ in rb_words])
    rmw22 = mesh_mod.batched_rmw_fn(BPAR, mesh22)

    def rmw22_call():
        return rmw22(shards22, mesh_mod.shard_addr_batch(mesh22, rb_prep),
                     mesh_mod.shard_addr_batch(mesh22, rb_coeff),
                     mesh_mod.shard_addr_batch(mesh22, rb_w), bkeys)
    (rb_outs, rb_new), rb_ms, rb_l = counted(rmw22_call, shbatch_launches)
    cells = DP_RMW * ROWS_RMW
    expect_launches("sharded batched RMW", rb_l,
                    fused_external_fold_batched=4 * cells,
                    fused_external_fold=4 * cells, ntt_fwd=3 * cells,
                    fused_pack_merge=LV * cells, fused_trace=cells,
                    fused_split=LV * cells, ring_all_gather=DP_RMW)
    rb_peak = torch.cuda.max_memory_allocated()
    (u_outs, u_state), u_rb_ms = timed(
        lambda: bserver.rmw_batch(bstate, rb_prep, rb_coeff, rb_w))
    for k in range(ROWS_RMW):
        if not torch.equal(torch.cat([o[k] for o in rb_outs]), u_outs):
            fail(f"sharded batched RMW: shard {k}'s read-outs differ from rmw_batch")
    if not torch.equal(mesh_mod.unshard_rows(rb_new), u_state.data):
        fail("sharded batched RMW: the new RAM differs from rmw_batch's")
    worst_sb = -1e9
    rb_plain = bdata.copy()
    for k, idx in enumerate(big_rmw):
        worst_sb = max(worst_sb, bdecode(u_outs[k], idx, "sharded batched RMW read-out",
                                         bdata))
        rb_plain[idx * BW: (idx + 1) * BW] = rb_words[k]
    back = bserver.read_batch(u_state, rb_prep)
    for k, idx in enumerate(big_rmw):
        worst_sb = max(worst_sb, bdecode(back[k], idx, "sharded batched RMW read-back",
                                         rb_plain))
    del u_outs, u_state, back
    # the same call through the plain versions: holds every kernel of the
    # path at its shapes here (split over thousands of pairs a level, the
    # batched fold over 2048-row shards at 2 items, the write's folds and
    # transforms); the unsharded rmw_batch equals it by the check above
    plain_rb_ms = equal_to_plain((rb_outs, rb_new), rmw22_call,
                                 "sharded batched RMW")
    del rb_outs, rb_new, shards22
    emit({"phase": "sharded_batch", "ok": True,
          "batched_read": {"mesh": bmesh.shape, "batch": BIG_BATCH_READ,
                           "addresses": batch8, "equal_to_single_reads": True},
          "sharded_batch_ms": {k: statistics.median(v) for k, v in sb_ms.items()},
          "sharded_batch_ms_all": sb_ms,
          "batched_rmw": {"mesh": mesh22.shape, "batch": NB_BIG_RMW,
                          "addresses": big_rmw,
                          "equal_to_rmw_batch": "read-outs and all of the new RAM"},
          "sharded_rmw_batch_ms": rb_ms, "unsharded_rmw_batch_ms": u_rb_ms,
          "worst_noise_log2": worst_sb,
          "peak_device_bytes_batched_read": batch_read_peak,
          "peak_device_bytes_batched_rmw": rb_peak,
          "launches": {"batched_read": sb_launches, "batched_rmw": rb_l}})
    emit({"phase": "sharded_rmw_batch_vs_plain", "ok": True, "mesh": mesh22.shape,
          "batch": NB_BIG_RMW, "addresses": big_rmw,
          "compared": "every dp replica's read-outs on every rows shard and every "
                      "new data shard",
          "plain_sharded_rmw_batch_ms": plain_rb_ms})

    # ---- dist: the batched read and RMW across two processes on this card ---
    # parallel/dist.py at the RAM cell: DIST_PROCS processes joined by gloo
    # (NCCL refuses two ranks on one GPU), each a dp 1 x rows 2 mesh, so the
    # global mesh is dp 2 x rows 2 and the RMW's delta sums cross processes
    # in one int32 all_reduce a rows shard.  The workers
    # (fhe_ram_tpu_torch/examples/multihost_dryrun.py, the port only) load
    # this process's CPU copies of the RAM, the batches, the words and the
    # keys, count their launches and record the shapes their wrappers were
    # called at; here they are held against read_batch, the single-process
    # batched_rmw_fn on a dp 2 x rows 2 mesh (itself held against the plain
    # versions: every shape the workers launched is one it launched) and
    # rmw_batch.  Two processes share one card: the times are no scaling
    # number.
    dpicks = [int(a) for a in np.random.default_rng(args.seed + 30).choice(
        PAR.max_addr, size=2 * DIST_BATCH, replace=False)]
    d_read, d_rmw = dpicks[:DIST_BATCH], dpicks[DIST_BATCH:]
    d_read_b = stack_addresses([prepared(i) for i in d_read])
    _, d_prep_b, d_coeff_b = address_batch(d_rmw)
    d_words, d_w_b = word_batch(args.seed + 31, DIST_BATCH)
    with tempfile.TemporaryDirectory() as ddir:
        dryrun.save_inputs(ddir, "PARAMS_2_18_TURBO_READOPT", state.data, d_read_b,
                           d_prep_b, d_coeff_b, d_w_b, ekp)
        # this process's allocator caches what the 2^24 phases freed (most of
        # the card): hand it back, or the workers find no memory
        torch.cuda.empty_cache()
        parent_bytes = torch.cuda.memory_reserved()
        t0 = time.time()
        results = dryrun.run_workers(DIST_PROCS, "cuda", inputs=ddir, seed=args.seed,
                                     reps=DIST_REPS, timeout_s=DIST_TIMEOUT_S)
        dist_s = time.time() - t0
        for rank, (rc, log) in enumerate(results):
            if rc != 0:
                fail(f"dist: worker {rank} "
                     f"{'hung and was killed' if rc is None else f'exited {rc}'}:\n"
                     f"{log[-4000:]}")
        workers = [torch.load(os.path.join(ddir, f"out_{r}.pt"))
                   for r in range(DIST_PROCS)]
    d_mesh = mesh_mod.make_mesh(DIST_PROCS * DIST_ROWS, rows=DIST_ROWS,
                                devices=[dev] * (DIST_PROCS * DIST_ROWS))
    d_shards = mesh_mod.shard_data_rows(d_mesh, state.data)
    sp_read, sp_rmw = mesh_mod.batched_read_fn(PAR, d_mesh), mesh_mod.batched_rmw_fn(PAR, d_mesh)

    def sp_read_call():
        return sp_read(d_shards, mesh_mod.shard_addr_batch(d_mesh, d_read_b), ekp.atk_glwe)

    def sp_rmw_call():
        return sp_rmw(d_shards, mesh_mod.shard_addr_batch(d_mesh, d_prep_b),
                      mesh_mod.shard_addr_batch(d_mesh, d_coeff_b),
                      mesh_mod.shard_addr_batch(d_mesh, d_w_b), ekp)
    sp_seen = {}
    with dryrun.recording_shapes(sp_seen):
        sp_r = sp_read_call()
        sp_o, sp_new = sp_rmw_call()
    sp_ms = {"read": [timed(sp_read_call)[1] for _ in range(DIST_REPS)],
             "rmw_batch": [timed(sp_rmw_call)[1] for _ in range(DIST_REPS)]}
    plain_sp_ms = {"read": equal_to_plain(sp_r, sp_read_call, "dist: single-process read"),
                   "rmw_batch": equal_to_plain((sp_o, sp_new), sp_rmw_call,
                                               "dist: single-process batched RMW")}
    # the same single-process calls on the composed routes: their shapes
    # recorded, held against the plain versions and equal to the fused ones
    spc_read = mesh_mod.batched_read_fn(PAR, d_mesh, composed=True)
    spc_rmw = mesh_mod.batched_rmw_fn(PAR, d_mesh, composed=True)

    def spc_read_call():
        return spc_read(d_shards, mesh_mod.shard_addr_batch(d_mesh, d_read_b), ekp.atk_glwe)

    def spc_rmw_call():
        return spc_rmw(d_shards, mesh_mod.shard_addr_batch(d_mesh, d_prep_b),
                       mesh_mod.shard_addr_batch(d_mesh, d_coeff_b),
                       mesh_mod.shard_addr_batch(d_mesh, d_w_b), ekp)
    spc_seen = {}
    with dryrun.recording_shapes(spc_seen):
        spc_r = spc_read_call()
        spc_o, spc_new = spc_rmw_call()
    plain_sp_ms.update({
        "composed_read": equal_to_plain(spc_r, spc_read_call,
                                        "dist: single-process composed read"),
        "composed_rmw_batch": equal_to_plain((spc_o, spc_new), spc_rmw_call,
                                             "dist: single-process composed batched RMW")})
    same_outputs((spc_r, spc_o, spc_new), (sp_r, sp_o, sp_new), "dist single-process calls")
    want_read = server.read_batch(state, d_read_b)
    u_outs, u_state = server.rmw_batch(state, d_prep_b, d_coeff_b, d_w_b)
    sp_new = mesh_mod.unshard_rows(sp_new)
    if not torch.equal(sp_new, u_state.data):
        fail("dist: the single-process batched_rmw_fn's new RAM differs from rmw_batch's")
    b_loc = DIST_BATCH // DIST_PROCS
    DIST_PATHS = ("read", "rmw_batch", "composed_read", "composed_rmw_batch")
    dist_launches = {p_: dict.fromkeys(ntt_cuda.LAUNCHES, 0) for p_ in DIST_PATHS}
    DLV = PAR.num_rows.bit_length() - 1   # merge levels a rows shard's pack
    # a worker's launches, counted from the code; composed (as
    # composed_sharded counts them): each merge, trace step and split level
    # one fold
    want_per_worker = {
        "read": dict(fused_external_fold_batched=2 * DIST_ROWS, ntt_fwd=DIST_ROWS,
                     fused_pack_merge=DLV * DIST_ROWS,
                     fused_trace=DIST_ROWS, ring_all_gather=1),
        "rmw_batch": dict(fused_external_fold_batched=4 * DIST_ROWS,
                          fused_external_fold=4 * DIST_ROWS, ntt_fwd=3 * DIST_ROWS,
                          fused_pack_merge=DLV * DIST_ROWS,
                          fused_trace=DIST_ROWS,
                          fused_split=DLV * DIST_ROWS,
                          ring_all_gather=1),
        "composed_read": dict(fused_external_fold_batched=2 * DIST_ROWS, ntt_fwd=DIST_ROWS,
                              fused_external_fold=(DLV + PAR.log_n) * DIST_ROWS,
                              ring_all_gather=1),
        "composed_rmw_batch": dict(fused_external_fold_batched=4 * DIST_ROWS,
                                   fused_external_fold=(4 + PAR.log_n + 2 * DLV) * DIST_ROWS,
                                   ntt_fwd=3 * DIST_ROWS, ring_all_gather=1)}
    for r, wk in enumerate(workers):
        if wk["mesh"] != {"dp": DIST_PROCS, "rows": DIST_ROWS} or wk["backend"] != "gloo":
            fail(f"dist: worker {r} ran mesh {wk['mesh']} over {wk['backend']}")
        if wk["foreign_modules"]:
            fail(f"dist: worker {r} imported {wk['foreign_modules']}")
        if not wk["int32_sum_wraps"]:
            fail("dist: the cross-process int32 sum does not wrap")
        mine = slice(r * b_loc, (r + 1) * b_loc)
        for route in ("", "composed_"):
            for k in range(DIST_ROWS):
                if not (torch.equal(wk[route + "read"][0][k].to(dev), want_read[mine])
                        and torch.equal(wk[route + "read"][0][k].to(dev), sp_r[r][k])):
                    fail(f"dist: worker {r}'s {route}read on rows shard {k} differs "
                         "from read_batch or the single-process mesh's")
                if not (torch.equal(wk[route + "rmw_outs"][0][k].to(dev), sp_o[r][k])
                        and torch.equal(wk[route + "rmw_outs"][0][k].to(dev),
                                        u_outs[mine])):
                    fail(f"dist: worker {r}'s {route}RMW read-outs on rows shard {k} "
                         "differ from the single-process mesh's or rmw_batch's")
            if not torch.equal(mesh_mod.unshard_rows(wk[route + "new"]).to(dev), sp_new):
                fail(f"dist: worker {r}'s {route}new RAM differs from the "
                     "single-process mesh's")
        for p_ in DIST_PATHS:
            got = {k_: wk["launches"][p_].get(k_, 0) for k_ in ntt_cuda.LAUNCHES}
            expect_launches(f"dist {p_} in worker {r}", got, **want_per_worker[p_])
            for k_, v_ in got.items():
                dist_launches[p_][k_] += v_
            composed = p_.startswith("composed_")
            if composed:
                only_composed(f"dist {p_} in worker {r}", got, also=("ring_all_gather",))
            unchecked = set(wk["shapes"][p_]) - set(spc_seen if composed else sp_seen)
            if unchecked:
                fail(f"dist {p_}: worker {r} launched at {sorted(unchecked)}, which no "
                     "call held against the plain versions did")
    worst_d = -1e9
    d_plain = data.copy()
    for k, idx in enumerate(d_read):
        worst_d = max(worst_d, decode(want_read[k], idx, "dist read"))
    for k, idx in enumerate(d_rmw):
        worst_d = max(worst_d, decode(u_outs[k], idx, "dist RMW read-out"))
        d_plain[idx * W: (idx + 1) * W] = d_words[k]
    back = server.read_batch(u_state, d_prep_b)
    for k, idx in enumerate(d_rmw):
        worst_d = max(worst_d, decode(back[k], idx, "dist RMW read-back", plain=d_plain))
    del d_shards, sp_r, sp_o, sp_new, u_outs, u_state, back, want_read, spc_r, spc_o, spc_new
    d_ms = {p_: [max(wk["ms"][p_][i] for wk in workers) for i in range(DIST_REPS)]
            for p_ in DIST_PATHS + ("all_reduce",)}
    emit({"phase": "dist", "ok": True, "preset": "PARAMS_2_18_TURBO_READOPT",
          "processes": DIST_PROCS, "backend": "gloo", "devices": "one card, shared",
          "global_mesh": {"dp": DIST_PROCS, "rows": DIST_ROWS},
          "mesh_a_process": {"dp": 1, "rows": DIST_ROWS},
          "read_addresses": d_read, "rmw_addresses": d_rmw,
          "equal_to": "read: read_batch and the single-process batched_read_fn on "
                      "every rows shard; RMW: read-outs on every rows shard and every "
                      "process's whole new RAM == the single-process batched_rmw_fn "
                      "(dp 2 x rows 2) == rmw_batch",
          "int32_sum_wraps": True,
          "card": card, "composed_equal_to_fused": "read-outs on every rows shard and "
                                                    "every process's whole new RAM",
          "dist_read_ms": statistics.median(d_ms["read"]),
          "dist_rmw_batch_ms": statistics.median(d_ms["rmw_batch"]),
          "dist_composed_read_ms": statistics.median(d_ms["composed_read"]),
          "dist_composed_rmw_batch_ms": statistics.median(d_ms["composed_rmw_batch"]),
          "dist_all_reduce_ms": statistics.median(d_ms["all_reduce"]),
          "dist_ms_all_max_over_processes": d_ms,
          "dist_ms_by_process": [wk["ms"] for wk in workers],
          "single_process_read_ms": statistics.median(sp_ms["read"]),
          "single_process_rmw_batch_ms": statistics.median(sp_ms["rmw_batch"]),
          "single_process_ms_all": sp_ms, "plain_single_process_ms": plain_sp_ms,
          "workers_seconds": round(dist_s, 2),
          "parent_device_bytes_reserved_beside_the_workers": parent_bytes,
          "worst_noise_log2": worst_d, "noise_bound_log2": -(PAR.k_pt + 1),
          "launches_per_worker": {p_: [wk["launches"][p_] for wk in workers]
                                  for p_ in DIST_PATHS},
          "shapes_launched": {p_: sorted(set().union(*(wk["shapes"][p_] for wk in workers)))
                              for p_ in DIST_PATHS}})
    del workers

    # ---- sharded_rmw: 2 chained sharded_rmw_fn cycles, then one ------------
    # sharded_rpw_fn + sharded_write_fn pair, each against the unsharded cycle
    rmw_fn = mesh_mod.sharded_rmw_fn(BPAR, bmesh)
    rpw_fn = mesh_mod.sharded_rpw_fn(BPAR, bmesh)
    write_fn = mesh_mod.sharded_write_fn(BPAR, bmesh)
    cyc_words = np.random.default_rng(args.seed + 28).integers(
        0, 256, size=(3, BW)).astype(np.uint8)
    cyc_in = [(baddress(idx), ram_mod.encrypt_write_word(BPAR, bctx, bs_ntt, cyc_words[k],
                                                         bsrc))
              for k, idx in enumerate(big_cycles)]
    shards, ustate, plain = bshards, bstate, bdata.copy()
    srmw_launches = dict.fromkeys(ntt_cuda.LAUNCHES, 0)
    srmw_ms, worst_sr, pair, rmw_l, first = [], -1e9, {}, None, None
    for k, idx in enumerate(big_cycles):
        (coeff, prep), w_ct = cyc_in[k]
        if k < 2:
            (outs, new_sh), ms, delta = counted(lambda: rmw_fn(
                shards, prep.coordinates, coeff.coordinates, w_ct, bkeys),
                srmw_launches)
            expect_launches(f"sharded RMW at {idx}", delta,
                            fused_external_fold=8 * n4, fused_pack_merge=LV * n4,
                            fused_trace=n4, ntt_fwd=2 * n4, fused_split=LV * n4,
                            ring_all_gather=1)
            srmw_ms.append(ms)
            rmw_l = delta
            if k == 0:
                first = (outs, new_sh)
            if any(not torch.equal(o, outs[0]) for o in outs):
                fail(f"sharded RMW at {idx}: the shards' read-outs differ")
        else:
            (outs, roots), pair["rpw_ms"], l_rpw = counted(
                lambda: rpw_fn(shards, prep.coordinates, batk), srmw_launches)
            new_sh, pair["write_ms"], l_wr = counted(
                lambda: write_fn(shards, roots, w_ct, coeff.coordinates, bkeys),
                srmw_launches)
            expect_launches(f"sharded rpw at {idx}", l_rpw,
                            fused_external_fold=2 * n4, fused_pack_merge=LV * n4,
                            fused_trace=n4, ring_all_gather=1)
            expect_launches(f"sharded write at {idx}", l_wr, fused_trace=n4,
                            fused_external_fold=6 * n4, ntt_fwd=2 * n4,
                            fused_split=LV * n4)
            pair["launches"] = {"rpw": l_rpw, "write": l_wr}
        (u_out, u_pending), u_rpw = timed(lambda: bserver.read_prepare_write(ustate, prep))
        u_next, u_wr = timed(lambda: bserver.write(u_pending, w_ct, coeff))
        if k == 2:
            same_on_every_shard(outs, u_out, f"sharded rpw at {idx}")
            pair["unsharded_rpw_plus_write_ms"] = u_rpw + u_wr
        if not torch.equal(mesh_mod.unshard_rows(new_sh), u_next.data):
            fail(f"sharded {'RMW' if k < 2 else 'rpw + write'} at {idx}: the new "
                 "RAM differs from the unsharded rpw + write")
        worst_sr = max(worst_sr, bdecode(outs[0], idx, "sharded RMW read-out", plain))
        plain[idx * BW: (idx + 1) * BW] = cyc_words[k]
        shards, ustate = new_sh, u_next
        del outs, u_out, u_pending
    # read back through the sharded read: the three new words, and two of
    # the read phase's addresses, which no cycle wrote
    back_fn = mesh_mod.sharded_read_fn(BPAR, bmesh)
    preps = {idx: cyc_in[k][0][1] for k, idx in enumerate(big_cycles)}
    for idx in big_cycles + big_reads[:2]:
        prep = preps[idx] if idx in preps else baddrs[idx][1]
        outs = back_fn(shards, prep.coordinates, batk)
        worst_sr = max(worst_sr, bdecode(outs[0], idx, "sharded RMW read-back", plain))
    del shards, ustate, outs
    emit({"phase": "sharded_rmw", "ok": True, "mesh": bmesh.shape,
          "addresses": big_cycles, "unchanged_addresses": big_reads[:2],
          "equal_to_unsharded_rpw_plus_write": "all of the new RAM, every cycle",
          "sharded_rmw_ms": statistics.median(srmw_ms), "sharded_rmw_ms_all": srmw_ms,
          "rpw_write_pair": pair, "worst_noise_log2": worst_sr,
          "noise_bound_log2": -(BPAR.k_pt + 1), "launches_per_rmw": rmw_l})

    # ---- sharded_rmw_vs_plain: the first cycle through the plain versions ---
    # (the full-gadget folds over 4096-row shards, the split over thousands
    # of pairs a level, the transforms of the write); the unsharded rpw +
    # write equals the kernels' cycle by the check above
    (coeff, prep), w_ct = cyc_in[0]
    plain_sr_ms = equal_to_plain(first, lambda: rmw_fn(
        bshards, prep.coordinates, coeff.coordinates, w_ct, bkeys), "sharded RMW")
    emit({"phase": "sharded_rmw_vs_plain", "ok": True, "address": big_cycles[0],
          "compared": f"every shard's read-out and all {n4} new data shards",
          "plain_sharded_rmw_ms": plain_sr_ms})
    del first

    # ---- sharded_vs_plain: one sharded read, kernels against plain versions --
    idx = big_reads[0]
    sread = mesh_mod.sharded_read_fn(BPAR, bmesh, "ring")
    k_outs = sread(bshards, baddrs[idx][1].coordinates, batk)
    with ntt_cuda.plain_versions():
        p_outs, plain_sh_ms = timed(lambda: sread(bshards, baddrs[idx][1].coordinates,
                                                  batk))
    for k, (a, b) in enumerate(zip(k_outs, p_outs)):
        if not torch.equal(a, b):
            fail(f"sharded read: shard {k}'s output, kernels and plain versions disagree")
    emit({"phase": "sharded_vs_plain", "ok": True, "address": idx,
          "compared": f"every shard's read, collectives included ({n4} shards)",
          "plain_sharded_read_ms": plain_sh_ms})
    del k_outs, p_outs

    # ---- composed_sharded: every mesh factory with composed=True -------------
    # (the two-pass context: each merge, trace step and split level one fold
    # and torch glue, the batched read's level 0 the RAM's batched product
    # as on the fused routes) on the 2^24 shards; every output -- read-outs,
    # roots, every new data shard -- bit-equal to the fused factory's on the same inputs
    # in this phase (outside the counted windows; two calls of each, in
    # turns with the fused factory's).  Launches a call, counted
    # from the code (n4 shards, LV merge levels, TS = log_n trace steps a
    # full trace, B addresses a replica, cells = dp x rows):
    #   read:         fold (2 + LV + TS) n4, the collective
    #   rmw:          fold (8 + 2 LV + TS) n4, ntt_fwd 2 n4, ring 1
    #   rpw / write:  fold (2 + LV + TS) n4, ring 1 / fold (6 + TS + LV) n4,
    #                 ntt_fwd 2 n4
    #   batched read: fold (LV + TS) n4, fold_batched 2 n4, ntt_fwd n4 (none
    #                 with the cache, whose build is ntt_fwd n4), ring 1
    #   batched rmw:  fold (4 + TS + 2 LV) a cell, fold_batched 4 a cell,
    #                 ntt_fwd 3 a cell, ring dp
    # The 2^24 phases before have filled the allocator's cache: hand it back.
    torch.cuda.empty_cache()
    TS = BPAR.log_n
    csh_launches = dict.fromkeys(ntt_cuda.LAUNCHES, 0)
    csh_ms, fsh_ms, csh_l = {}, {}, {}

    def composed_call(what, fused_fn, composed_fn, **want):
        """fused_fn() and composed_fn() in turns (fused, composed, composed,
        fused), each composed call counted: the same integers; returns the
        composed output."""
        f_out, f_ms = timed(fused_fn)
        c_out, c_ms, csh_l[what] = counted(composed_fn, csh_launches)
        same_outputs(c_out, f_out, what)
        del f_out
        c_ms2, l2 = counted(composed_fn, csh_launches)[1:]
        for l_ in (csh_l[what], l2):
            expect_launches(f"composed {what}", l_, **want)
        csh_ms[what], fsh_ms[what] = [c_ms, c_ms2], [f_ms, timed(fused_fn)[1]]
        return c_out

    sidx = big_reads[0]
    sprep = baddrs[sidx][1]
    for col, tail in (("ring", {"ring_all_gather": 1}),
                      ("exchange", {"exchange": n4.bit_length() - 1})):
        f_fn = mesh_mod.sharded_read_fn(BPAR, bmesh, col)
        c_fn = mesh_mod.sharded_read_fn(BPAR, bmesh, col, composed=True)
        outs = composed_call(f"read_{col}", lambda: f_fn(bshards, sprep.coordinates, batk),
                             lambda: c_fn(bshards, sprep.coordinates, batk),
                             fused_external_fold=(2 + LV + TS) * n4, **tail)
        same_on_every_shard(outs, big_out[sidx], f"composed sharded read ({col})")
    (coeff, prep), w_ct = cyc_in[0]
    c_rmw = mesh_mod.sharded_rmw_fn(BPAR, bmesh, composed=True)
    composed_call("rmw", lambda: rmw_fn(bshards, prep.coordinates, coeff.coordinates,
                                        w_ct, bkeys),
                  lambda: c_rmw(bshards, prep.coordinates, coeff.coordinates, w_ct, bkeys),
                  fused_external_fold=(8 + 2 * LV + TS) * n4, ntt_fwd=2 * n4,
                  ring_all_gather=1)
    c_rpw = mesh_mod.sharded_rpw_fn(BPAR, bmesh, composed=True)
    c_write = mesh_mod.sharded_write_fn(BPAR, bmesh, composed=True)
    _, roots = composed_call("rpw", lambda: rpw_fn(bshards, prep.coordinates, batk),
                             lambda: c_rpw(bshards, prep.coordinates, batk),
                             fused_external_fold=(2 + LV + TS) * n4, ring_all_gather=1)
    composed_call("write",
                  lambda: write_fn(bshards, roots, w_ct, coeff.coordinates, bkeys),
                  lambda: c_write(bshards, roots, w_ct, coeff.coordinates, bkeys),
                  fused_external_fold=(6 + TS + LV) * n4, ntt_fwd=2 * n4)
    del roots
    f_br = mesh_mod.batched_read_fn(BPAR, bmesh)
    c_br = mesh_mod.batched_read_fn(BPAR, bmesh, composed=True)
    torch.cuda.reset_peak_memory_stats()
    outs = composed_call(
        f"batched_read_{BIG_BATCH_READ}",
        lambda: f_br(bshards, mesh_mod.shard_addr_batch(bmesh, coords8), batk),
        lambda: c_br(bshards, mesh_mod.shard_addr_batch(bmesh, coords8), batk),
        fused_external_fold=(LV + TS) * n4, fused_external_fold_batched=2 * n4,
        ntt_fwd=n4, ring_all_gather=1)
    same_on_every_shard(outs[0], want8, "composed sharded batched read")
    del outs
    cbatch_peak = torch.cuda.max_memory_allocated()
    # the cache (one digit at this preset: the composed routes take it); one
    # cache serves both factories, the spectra being the same integers
    c_cache, _, csh_l["spectral_cache"] = counted(
        lambda: mesh_mod.sharded_spectral_cache_fn(BPAR, bmesh, composed=True)(bshards),
        csh_launches)
    expect_launches("composed spectral cache", csh_l["spectral_cache"], ntt_fwd=n4)
    f_brc = mesh_mod.batched_read_fn(BPAR, bmesh, with_cache=True)
    c_brc = mesh_mod.batched_read_fn(BPAR, bmesh, with_cache=True, composed=True)
    outs = composed_call(
        f"batched_read_{BIG_BATCH_READ}_cached",
        lambda: f_brc(bshards, mesh_mod.shard_addr_batch(bmesh, coords8), batk, c_cache),
        lambda: c_brc(bshards, mesh_mod.shard_addr_batch(bmesh, coords8), batk, c_cache),
        fused_external_fold=(LV + TS) * n4, fused_external_fold_batched=2 * n4,
        ring_all_gather=1)
    same_on_every_shard(outs[0], want8, "composed sharded batched read (cached)")
    del outs, c_cache
    shards22 = mesh_mod.shard_data_rows(mesh22, bstate.data)
    c_rmw22 = mesh_mod.batched_rmw_fn(BPAR, mesh22, composed=True)

    def rmw22_args():
        return (shards22, mesh_mod.shard_addr_batch(mesh22, rb_prep),
                mesh_mod.shard_addr_batch(mesh22, rb_coeff),
                mesh_mod.shard_addr_batch(mesh22, rb_w), bkeys)
    composed_call(f"batched_rmw_{NB_BIG_RMW}", lambda: rmw22(*rmw22_args()),
                  lambda: c_rmw22(*rmw22_args()),
                  fused_external_fold=(4 + TS + 2 * LV) * cells,
                  fused_external_fold_batched=4 * cells, ntt_fwd=3 * cells,
                  ring_all_gather=DP_RMW)
    del shards22
    only_composed("composed_sharded", csh_launches, also=COLLECTIVES)
    emit({"phase": "composed_sharded", "ok": True, "preset": "PARAMS_2_24_READOPT",
          "meshes": {"read, rmw, rpw, write, batched read": bmesh.shape,
                     "batched rmw": mesh22.shape},
          "equal_to_fused_factory": "read-outs on every shard, rpw roots, every new "
                                    "data shard",
          "composed_ms": {k: statistics.median(v) for k, v in csh_ms.items()},
          "fused_ms": {k: statistics.median(v) for k, v in fsh_ms.items()},
          "composed_ms_all": csh_ms, "fused_ms_all": fsh_ms,
          "launches": csh_l, "peak_device_bytes_batched_read": cbatch_peak})

    for name, notes in seen_coll.items():
        checked = {r["shape"] for r in checks.get(name, [])}
        if not notes or not notes <= checked:
            fail(f"{name}: the paths launched shapes {sorted(notes - checked)} "
                 "that no kernel check held against the plain version")

    # ---- optional: where the time of one call of each path goes -------------
    if args.profile:
        ap_ = batch_aps[0]
        traced("read", lambda: server.read(state, ap_), statistics.median(read_ms))
        st0, cap_, addr, w_ct, _, _ = last_cycle
        pend = []
        traced("read_prepare_write",
               lambda: pend.append(server.read_prepare_write(st0, cap_)[1]),
               statistics.median(rpw_ms))
        traced("write", lambda: server.write(pend[0], w_ct, addr),
               statistics.median(write_ms))
        traced(f"read_batch of {BATCH}",
               lambda: server.read_batch(state, coords_b),
               statistics.median(batch_all))
        traced(f"rmw_batch of {NB_RMW}, tree kernels",
               lambda: tree_server.rmw_batch(state, rmw_prep_b, rmw_coeff_b, w_b),
               statistics.median(tree_ms))
        traced(f"rmw_batch of {NB_RMW}, per-level kernels",
               lambda: server.rmw_batch(state, rmw_prep_b, rmw_coeff_b, w_b),
               statistics.median(level_ms))
        pend = []
        traced("read_prepare_write, tree kernels",
               lambda: pend.append(tree_server.read_prepare_write(st0, cap_)[1]),
               statistics.median(cyc["tree_rpw"]))
        traced("write, tree kernels",
               lambda: tree_server.write(pend[0], w_ct, addr),
               statistics.median(cyc["tree_write"]))
        traced("composed read", lambda: cserver.read(state, c_ap0),
               statistics.median(c_read_ms))
        st0, cap_, addr, w_ct, _, _ = c_cycles[-1]
        pend = []
        traced("composed read_prepare_write",
               lambda: pend.append(cserver.read_prepare_write(st0, cap_)[1]),
               statistics.median(c_rpw_ms))
        traced("composed write", lambda: cserver.write(pend[0], w_ct, addr),
               statistics.median(c_write_ms))
        traced("vm_cycle", lambda: vm_cycle(VPAR, vctx, vkeys, data=st_l, **enc_l),
               statistics.median(vm_ms))
        c_st, c_enc = c_vm_last
        traced("composed vm_cycle",
               lambda: vm_cycle(VPAR, vtctx, vkeys, data=c_st, **c_enc),
               statistics.median(c_vm_ms))
        bap = baddrs[big_reads[0]][1]
        traced("read at 2^24", lambda: bserver.read(bstate, bap),
               statistics.median(big_ms))
        traced(f"sharded read at 2^24, rows {n4}, ring",
               lambda: sread(bshards, bap.coordinates, batk),
               statistics.median(sh_ms["ring"]))
        xread = mesh_mod.sharded_read_fn(BPAR, bmesh, "exchange")
        traced(f"sharded read at 2^24, rows {n4}, exchange",
               lambda: xread(bshards, bap.coordinates, batk),
               statistics.median(sh_ms["exchange"]))
        (coeff, prep), w_ct = cyc_in[0]
        traced(f"sharded RMW at 2^24, rows {n4}",
               lambda: rmw_fn(bshards, prep.coordinates, coeff.coordinates, w_ct,
                              bkeys),
               statistics.median(srmw_ms))

    # ---- the kernels' line --------------------------------------------------
    # launches over the twenty-six paths (the dist paths' in the workers),
    # each counted from 0 just before it
    # was driven to just after (comparisons and read-backs are outside; the
    # per-level batched RMW: its four timed calls).  Kernel 12 lies on no
    # path of either package: its checks above are all it gets.
    by_path = {"read": path_launches, "rmw": rmw_launches,
               "read_batch": batch_launches, "rmw_batch": rmw_batch_launches,
               "rmw_batch_per_level": level_launches,
               "composed_read": c_read_launches, "composed_rmw": c_rmw_launches,
               "composed_batch": c_batch_launches,
               "composed_chained_batch": chained_launches,
               "readme_rmw": readme_launches, "demo": demo_launches["fused"],
               "composed_demo": demo_launches["composed"],
               "vm_cycle": vm_launches, "composed_vm_cycle": c_vm_launches,
               "read_2_24": read24_launches,
               "sharded_read": shread_launches, "sharded_batch": shbatch_launches,
               "sharded_rmw": srmw_launches, "load": load_launches,
               "load_prepared": prep_launches, "composed_load": c_load_launches,
               "dist_read": dist_launches["read"],
               "dist_rmw_batch": dist_launches["rmw_batch"],
               "composed_dist_read": dist_launches["composed_read"],
               "composed_dist_rmw_batch": dist_launches["composed_rmw_batch"],
               "composed_sharded": csh_launches}
    COMPOSED_PATHS = tuple(p_ for p_ in by_path if p_.startswith("composed_"))
    on_no_path = ("fused_external",)
    total_launches = {k: sum(p_[k] for p_ in by_path.values()) for k in path_launches}
    for k, v in total_launches.items():
        if v == 0 and k not in on_no_path:
            fail(f"kernel {k} was launched on none of the paths")

    def entry(name, source, replaces, shape_idx, bytes_moved=None, ops=None):
        """The kernel's line at one of its checked shapes; the bound from
        the work given here, else from the check's own.  replaces: a line of
        ops/ntt_pallas.py, or file:line of the JAX package."""
        rec = checks[name][shape_idx]
        if bytes_moved is None:
            b_ms, b_by = rec["bound_ms"], rec["bound_by"]
        else:
            b_ms, b_by = bound(bytes_moved, ops)
        if isinstance(replaces, int):
            replaces = f"ops/ntt_pallas.py:{replaces}"
        out = {"name": name, "route": "cuda",
               "source": f"fhe_ram_tpu_torch/csrc/{source}",
               "replaces": f"fhe_ram_tpu/{replaces}",
               "shape": rec["shape"], "launches": total_launches[name],
               "launches_by_path": {p_: c_[name] for p_, c_ in by_path.items()},
               "max_abs_err": max(r["max_abs_err"] for r in checks[name]),
               "ms": rec["ms"], "plain_ms": rec["plain_ms"],
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": rec.get("library_ms"),
               # what a redesign could win at most, the order of ROADMAP's
               # redesign queue: launches x (ms - bound_ms), for kernels 9-11
               # summed over the shapes the first VM cycle launched (every
               # cycle launches the same; the cycle is their only path),
               # else at this shape, the LOAD's launches at the shapes it
               # launched; the composed paths' launches (rows of every
               # count, at no one checked shape) are left out
               "launches_x_excess_ms": (
                   total_launches[name] / sum(seen[name].values())
                   * sum(c_ * (r["ms"] - r["bound_ms"]) for r in checks[name]
                         for s_, c_ in seen[name].items() if r["shape"] == s_)
                   if name in VM_KERNELS else
                   (total_launches[name] - sum(load_seen.get(name, {}).values())
                    - sum(c_[name] for p_, c_ in by_path.items()
                          if p_ in COMPOSED_PATHS))
                   * (rec["ms"] - b_ms)
                   + sum(c_ * (r["ms"] - r["bound_ms"]) for r in checks[name]
                         for s_, c_ in load_seen.get(name, {}).items()
                         if r["shape"] == s_))}
        if name not in VM_KERNELS:
            out["launches_x_excess_leaves_out"] = list(COMPOSED_PATHS)
        for k_ in ("per_level_ms", "predecessor_ms"):
            if k_ in rec:
                out[k_] = rec[k_]
        return out

    B0 = W * R
    nb0 = W * R // 2
    nbr = NB_RMW * W
    kernels = []
    # kernel 1: one build for both bodies (it replaces both of the JAX
    # package's, the MXU one and the FHERAM_MXU=0 kernels _fwd_kernel,
    # _inv_kernel, :416, :429), at B = 36; every checked shape in per_shape
    kernels += [entry("ntt_fwd", "ntt.cu", 454, 0), entry("ntt_inv", "ntt.cu", 499, 0)]
    # kernels 2 and 5: one build for both bodies (it replaces the MXU and
    # the FHERAM_MXU=0 branches of _fold_kernel_factory alike); every
    # checked shape, the timed-only 2^24 level 0 too, in per_shape
    kernels += [
        entry("fused_external_fold", "fold.cu", 1158, 0,
              poly_b * (B0 * T_ep + P * T_ep * M_ep + B0 * C * L),
              fold_ops(B0, T_ep, M_ep, n)),
        # level 0 of a batched read of NA addresses: the shared spectra
        # and NA keys in, NA x (W*R) rows out; no forward transforms
        entry("fused_external_fold_batched", "fold.cu", 1263, 0,
              poly_b * (P * B0 * T_ep + NA * P * T_ep * M_ep + NA * B0 * C * L),
              fold_ops(NA * B0, T_ep, M_ep, n, spectral=True))]
    # kernel 12 at the read's level-0 shape: one build for both bodies (it
    # replaces the MXU one and the non-MXU `kernel` of _fused_kernel_factory,
    # :572, alike); every checked shape in per_shape
    kernels += [entry("fused_external", "external.cu", 601, 2)]
    kernels += [
        entry("fused_trace", "trace.cu", 1463, 0,
              poly_b * (2 * W * C * L + S * P * T_ks * M_ks),
              S * fold_ops(W, T_ks, M_ks, n)),
        entry("fused_pack_merge", "pack_merge.cu", 1582, 0,
              poly_b * (3 * nb0 * C * L + P * T_ks * M_ks),
              fold_ops(nb0, T_ks, M_ks, n)),
        # the last split level: nb0 rows in, two children out; the second
        # child is ~4 operations a coefficient on top of one trace step
        entry("fused_split", "split.cu", 1699, 0,
              poly_b * (3 * nb0 * C * L + P * T_kf * M_kf),
              fold_ops(nb0, T_kf, M_kf, n) + 4 * nb0 * C * L * n),
        # the batched read-modify-write's extraction: nbr = 16 * W roots in,
        # 64 leaves a root out, six keys; level l is a split of nbr * 2^l rows
        entry("fused_split_tree", "split_tree.cu", 1821, 1,
              poly_b * (nbr * C * L * (1 + (1 << S_ST)) + S_ST * P * T_kf * M_kf),
              sum(fold_ops(nbr << l, T_kf, M_kf, n) + 4 * (nbr << l) * C * L * n
                  for l in range(S_ST))),
        # its pack below 32 leaves: 32 * nbr rows in, nbr out, five keys;
        # level s merges (32 >> (s + 1)) * nbr row pairs
        entry("fused_pack_tree", "pack_tree.cu", 1939, 1,
              poly_b * (nbr * C * L * (M_PT + 1) + 5 * P * T_kf * M_kf),
              sum(fold_ops((M_PT >> (s_ + 1)) * nbr, T_kf, M_kf, n)
                  for s_ in range(5))),
        # the VM's kernels at their cycle shapes (bounds as vm_shapes prices
        # them): the bitwise group, select_rd's rotation, the carry chain
        entry("fused_bitwise", "bitwise.cu", 2221, 0),
        entry("fused_blind_rotate", "blind_rotate.cu", 2320, 0),
        entry("fused_dp_chain", "dp_chain.cu", 2377, 0),
        # the collectives at the single read's root on the driven mesh
        # (rows 4); every checked shape in per_shape
        entry("ring_all_gather", "collective.cu", "parallel/collective.py:77", 1),
        entry("exchange", "collective.cu", "parallel/collective.py:132", 0),
    ]
    for k in kernels:
        if k["name"] in COLLECTIVES:
            k["per_shape"] = [{f: r.get(f) for f in ("shape", "ms", "plain_ms",
                                                    "library_ms", "bound_ms",
                                                    "predecessor_ms")}
                              for r in checks[k["name"]]]
        if k["name"] in ("ntt_fwd", "ntt_inv", "fused_external", "fused_external_fold",
                         "fused_external_fold_batched", "fused_pack_merge", "fused_trace",
                         "fused_split"):
            k["per_shape"] = [{**{f: r.get(f) for f in ("shape", "ms", "plain_ms", "bound_ms",
                                                        "bound_by", "predecessor_ms")},
                               "launches_per_load": per_load.get(k["name"], {}).get(r["shape"])}
                              for r in checks[k["name"]] + timed_only.get(k["name"], [])]
        if k["name"] in VM_KERNELS:
            k["per_shape"] = [{f: r[f] for f in ("shape", "ms", "plain_ms",
                                                "bound_ms", "bound_by")}
                              for r in checks[k["name"]]]
    emit({"kernels": kernels})
    emit({"phase": "done", "seconds": round(time.time() - t_start, 2)})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
