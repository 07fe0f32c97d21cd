"""The digit loads and the base of the carry-DP chain's b-phase on the fold
body (csrc/dp_chain.cu DpLeafDigits, DpLeafBase, which kernel 11 runs):
leaf row r of op g at step d takes the code tab.leaf[(g * 2 + first) * 4 +
r] = co0 | co1 << 1 | ob0 << 2 | ob1 << 3 (ops/ntt_cuda._dp_tables), each
block stages digit poly tt, F[co1] - F[co0] + (ob1 - ob0) * delta_d at
(component tt / Td, limb tt % Td), from 16-byte units t + 256 q, and
forward() reads it at i; the base is F[co0] + ob0 * delta_d.
Emulated at N = 4096 against the rows that ops/ntt_cuda.fused_dp_chain_plain
hands each b-phase fold (its `his` minus `los`, cut to Td limbs, and its
`los`), bit for bit, for every op of vm/arithmetic._DP_SPECS in the source
groups the VM deals them into, at the first step (slt's flip) and a later
one; every staged word is written once.  The CPU tests never launch the
kernel; this is its only check here.

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
C2, L, TD, BITS = 2, 3, 2, 2


def test_dp_leaf_digits_and_bases_match_the_plain_chain(monkeypatch):
    rng = np.random.default_rng(11)
    ops = [op for op in arithmetic.RVI32_OPS if op in arithmetic._DP_SPECS]
    _, groups = arithmetic._sources(ops, None, None)
    tabs = tuple(arithmetic._DP_SPECS[op][:3] for op in ops)
    assert any(flip for _, _, flip in tabs) and len(groups) > 1
    G, NG = len(ops), len(groups)
    seen = []

    def cmux(ctx, hi, lo, key, Td):
        out = torch.from_numpy(rng.integers(-(1 << 16), 1 << 16, size=lo.shape)
                               .astype(np.int32))
        seen.append((hi.numpy().astype(np.int64), lo.numpy().astype(np.int64), Td,
                     out.numpy()))
        return out

    monkeypatch.setattr(ntt_cuda, "_cmux_rows_plain", cmux)
    F0 = rng.integers(-(1 << 16), 1 << 16, size=(G, 2, C2, L, N)).astype(np.int32)
    deltas = rng.integers(-(1 << 16), 1 << 16, size=(BITS, C2, L, N)).astype(np.int32)
    keys = torch.zeros((BITS, NG + 1, 3, C2 * TD, C2, 1), dtype=torch.int32)
    ntt_cuda.fused_dp_chain_plain(None, torch.from_numpy(F0), keys,
                                  torch.from_numpy(deltas), tabs, groups)
    assert len(seen) == BITS * (NG + 1)
    tab = ntt_cuda._dp_tables(tabs, ntt_cuda._op_groups(groups, G))
    t = np.arange(THREADS)[:, None]
    units = t + THREADS * np.arange(N // 4 // THREADS)          # thread t's int4 loads
    words = (4 * units[..., None] + np.arange(4)).reshape(-1)
    assert np.array_equal(np.bincount(words, minlength=N), np.ones(N))
    F = F0.astype(np.int64)
    for d in range(BITS):
        delta = deltas[d].astype(np.int64)
        for si, gis in enumerate(groups):
            hi, lo, Td, _ = seen[d * (NG + 1) + si]
            assert Td == TD
            for k, g in enumerate(gis):
                for r in range(4):
                    e = tab.leaf[(g * 2 + (d == 0)) * 4 + r]
                    co0, co1, ob0, ob1 = e & 1, (e >> 1) & 1, (e >> 2) & 1, (e >> 3) & 1
                    for tt in range(C2 * TD):
                        at = (tt // TD, tt % TD)
                        staged = np.full(N, 1 << 40)
                        staged[words] = (F[g, co1][at] - F[g, co0][at]
                                         + (ob1 - ob0) * delta[at])[words]
                        want = hi[4 * k + r][at] - lo[4 * k + r][at]
                        assert np.array_equal(staged, want), (ops[g], d, r, tt)
                    base = F[g, co0] + ob0 * delta
                    assert np.array_equal(base, lo[4 * k + r]), (ops[g], d, r)
        # the a-phase's output is the next step's state
        F = seen[d * (NG + 1) + NG][3].reshape(G, 2, C2, L, N).astype(np.int64)
