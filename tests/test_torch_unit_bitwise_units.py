"""The items of the bitwise group on the fold body (csrc/bitwise.cu
BitwiseRow, unit_arrive, unit_wait; kernel 9): item s < 2G transforms the
digits of leaf row s = 2g + r, hi[g, r] - lo[g, r] (BitwiseRow of index s,
bit 0's level-1 row), once for every bit; item 2G + 2u + r (unit u = j * G + g) is level-1 row r of
bit j and op g, the fold half only on leaf row s's spectra, base lo[g, r],
bit j's key of the op's source group, stored at inner row 2u + r; item 2G
+ 2WG + u is the unit's level-2 row, digits inner[2u] - inner[2u + 1],
base inner[2u + 1], bit j's rs1 key (group NG), stored at out row u.  Each
block stages digit poly tt (component tt / Td, limb tt % Td) from 16-byte
units t + 256 q.  Emulated at N = 4096 against the rows that
ops/ntt_cuda.fused_bitwise_plain hands its folds, bit for bit, for the
VM's bitwise ops (vm/arithmetic._BITWISE_TABLES in the RV32I enum) in the
source groups the VM deals them into; every inner and out row is written
once.  Then the deal: persistent clusters take items k, k + clusters, ...
in order, a level-1 row waiting until the cs blocks of its leaf row's
spectra have arrived, a level-2 row until the 2 cs blocks of its unit's
level-1 rows have; stepped round by round with every cluster resident,
every wait ends, at the cycle's shape in 9 rounds over 79 clusters (what
the H100 holds): one in which the level-1 rows wait for the leaf rows'
spectra, then 8 of rows.  The CPU tests never launch the kernel; this is its only
check here.

One test a file on purpose: with `--dist loadfile` pytest-xdist hands files
out in order of their test count, so single-test files go last; a row of
millisecond files before the suite's longest single test lets it start on
a worker that is really free (ROADMAP.md, "Time budget")."""

import re
from pathlib import Path

import numpy as np
import torch

from fhe_ram_tpu_torch.ops import ntt_cuda
from fhe_ram_tpu_torch.vm import arithmetic

SRC = (Path(ntt_cuda.__file__).resolve().parent.parent / "csrc" / "fold_body.cuh").read_text()
THREADS = int(re.search(r"#define FOLD_THREADS (\d+)", SRC).group(1))
N = int(re.search(r"#define FOLD_N (\d+)", SRC).group(1))
C2, L, TD, W, P = 2, 3, 2, 2, 3


def _deal(W, G, clusters, cs):
    """Rounds the kernel's deal takes, stepped: each cluster runs its next
    item when what it waits for has arrived."""
    units = W * G
    items = (3 * W + 2) * G
    queue = [list(range(k, items, clusters)) for k in range(clusters)]
    done = np.zeros(units + 2 * G, dtype=np.int64)   # blocks arrived a counter

    def ready(i):
        it = i - 2 * G
        if it < 0:
            return True
        if it < 2 * units:
            return done[units + (it >> 1) % G * 2 + (it & 1)] == cs
        return done[it - 2 * units] == 2 * cs

    rounds = 0
    while any(queue):
        ran = [q.pop(0) for q in queue if q and ready(q[0])]
        assert ran, "every cluster waits: the deal deadlocks"
        for i in ran:
            it = i - 2 * G
            if it < 0:
                done[units + i] += cs
            elif it < 2 * units:
                done[it >> 1] += cs
        rounds += 1
    return rounds


def test_bitwise_unit_rows_match_the_plain_group(monkeypatch):
    rng = np.random.default_rng(9)
    ops = [op for op in arithmetic.RVI32_OPS if op in arithmetic._BITWISE_TABLES]
    _, groups = arithmetic._sources(ops, None, None)
    G, NG = len(ops), len(groups)
    assert G == 6 and NG == 2
    of = ntt_cuda._op_groups(groups, G)
    calls = []

    def fold(ctx, x, keys, out_limbs, c2, base=None):
        out = rng.integers(-(1 << 16), 1 << 16, size=base.shape).astype(np.int32)
        calls.append((x.numpy().astype(np.int64), keys.numpy(),
                      base.numpy().astype(np.int64), out))
        return torch.from_numpy(out)

    monkeypatch.setattr(ntt_cuda, "fused_external_fold_batched_plain", fold)
    hi = rng.integers(-(1 << 16), 1 << 16, size=(G, 2, C2, L, N)).astype(np.int32)
    lo = rng.integers(-(1 << 16), 1 << 16, size=(G, 2, C2, L, N)).astype(np.int32)
    # key (j, grp) holds its own code, so each fold's keys name themselves
    code = np.arange(W * (NG + 1)).reshape(W, NG + 1)
    keys = np.broadcast_to(code[:, :, None, None, None, None],
                           (W, NG + 1, P, C2 * TD, C2, N)).astype(np.int32)
    want = ntt_cuda.fused_bitwise_plain(None, torch.from_numpy(hi), torch.from_numpy(lo),
                                        torch.from_numpy(keys), groups)
    assert len(calls) == NG + 1
    # the plain group's rows by (bit, op, r): digits, base, key code; and
    # its level-1 results, the inner rows the kernel's level 2 reads
    rows1, inner_want = {}, np.zeros((W, G, 2, C2, L, N), dtype=np.int64)
    for si, gis in enumerate(groups):
        x, k, base, out = calls[si]
        for j in range(W):
            for kk, g in enumerate(gis):
                for r in range(2):
                    rows1[j, g, r] = (x[j, 2 * kk + r], base[j, 2 * kk + r], k[j, 0, 0, 0, 0, 0])
                    inner_want[j, g, r] = out[j, 2 * kk + r]
    x2, k2, base2, _ = calls[NG]

    t = np.arange(THREADS)[:, None]
    units = t + THREADS * np.arange(N // 4 // THREADS)          # thread t's int4 loads
    words = (4 * units[..., None] + np.arange(4)).reshape(-1)
    assert np.array_equal(np.bincount(words, minlength=N), np.ones(N))

    def staged(hi_row, lo_row, tt):
        at = ((tt // TD) * L + tt % TD) * N
        v = np.full(N, 1 << 40)
        v[words] = hi_row.reshape(-1)[at + words] - lo_row.reshape(-1)[at + words]
        return v

    units_ = W * G
    for sp in range(2 * G):                        # the leaf rows' spectra items
        g, r = divmod(sp, 2)
        for j in range(W):
            for tt in range(C2 * TD):
                assert np.array_equal(staged(hi[g, r], lo[g, r], tt), rows1[j, g, r][0][tt])
    inner = np.full((2 * units_, C2, L, N), 1 << 40)
    writes = np.zeros(3 * units_, dtype=np.int64)   # inner rows, then out rows
    for i in range(2 * G, (3 * W + 2) * G):                      # BitwiseRow
        it = i - 2 * G
        level1 = it < 2 * units_
        u = it >> 1 if level1 else it - 2 * units_
        j, g = divmod(u, G)
        if level1:
            assert (it >> 1) % G * 2 + (it & 1) == 2 * g + (it & 1)   # its leaf row
            arm_lo = lo[g, it & 1]
            _, bw, kw = rows1[j, g, it & 1]
            grp = of[g]
        else:
            arm_lo = inner[2 * u + 1]
            xw, bw, kw = x2[j, g], base2[j, g], k2[j, 0, 0, 0, 0, 0]
            for tt in range(C2 * TD):
                assert np.array_equal(staged(inner[2 * u], arm_lo, tt), xw[tt]), (i, tt)
            grp = NG
        assert np.array_equal(arm_lo, bw), i
        assert code[j, grp] == kw, i
        # the store: inner row it, or out row it - 2WG; the wrapper's out is
        # [W, G, ...], so out row u must be (j, g)
        writes[it] += 1
        if level1:
            assert it >> 1 == j * G + g
            inner[it] = inner_want[j, g, it & 1]
        else:
            assert it - 2 * units_ == j * G + g
    assert (writes == 1).all()
    assert tuple(want.shape) == (W, G, C2, L, N)
    # the deal at the test's shape and at the cycle's (32 bits, 6 ops)
    items = (3 * W + 2) * G
    for clusters in (1, 2, 5, 7, items):
        assert _deal(W, G, clusters, 3) <= -(-items // clusters) + 2
    assert _deal(32, G, 79, 3) == 9
