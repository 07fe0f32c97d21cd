"""The digit loads and the base of a blind-rotation step on the fold body
(csrc/blind_rotate.cu RotDigits, fold_body.cuh cmux_step, which kernel 10
runs): each block stages the source limb ct[tt / Td, tt % Td] of digit
poly tt in shared memory, thread t loading the 16-byte units t + 256 q,
and forward() reads +-V[(i - t_rot) mod n] - V[i] for its coefficients
i = t | r << 8 (layout L0), the sign flipped where the index wraps XOR
t_rot >= n; the base is the step's input.
Emulated at N = 4096 against the digits (X^t ct - ct)[:, :, :Td] and the
base that ops/ntt_cuda.fused_blind_rotate_plain hands its fold, bit for
bit, at the VM cycle's rotation amounts (select_rd, select_store, the
pointer conversion) and at positive amounts below and above n; every
staged word is written once, and a warp's 32 reads of each kind hit 32
distinct banks.  The CPU tests never launch the kernel; this is its only
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

SRC = (Path(ntt_cuda.__file__).resolve().parent.parent / "csrc" / "fold_body.cuh").read_text()
THREADS = int(re.search(r"#define FOLD_THREADS (\d+)", SRC).group(1))
N = int(re.search(r"#define FOLD_N (\d+)", SRC).group(1))
# (C2, L, Td, amounts): select_rd (the op id's 5 bits, truncated),
# select_store (full gadget), the conversion's digits; then amounts that
# wrap with and without t >= n
SHAPES = ((2, 3, 2, [-(1 << k) for k in range(5)]),
          (2, 3, 3, [-4, -8, -1, -2]),
          (2, 4, 4, [-(1 << j) for j in range(12)]),
          (2, 3, 2, [1, 3000, N + 5, 2 * N - 1, 0]))


def test_blind_rotate_staging_reads_and_base_match_the_plain_chain(monkeypatch):
    rng = np.random.default_rng(10)
    seen = []

    def fold(ctx, x, keys, out_limbs, c2, base=None, sign=1):
        out = torch.from_numpy(rng.integers(-(1 << 16), 1 << 16, size=base.shape)
                               .astype(np.int32))
        seen.append((x.numpy(), base.numpy(), sign, out.numpy()))
        return out

    monkeypatch.setattr(ntt_cuda, "fused_external_fold_plain", fold)
    t = np.arange(THREADS)[:, None]
    units = t + THREADS * np.arange(N // 4 // THREADS)          # thread t's int4 loads
    words = (4 * units[..., None] + np.arange(4)).reshape(-1)
    assert np.array_equal(np.bincount(words, minlength=N), np.ones(N))
    i = t | (np.arange(16) << 8)                                # forward()'s layout L0
    for C2, L, Td, amounts in SHAPES:
        rows = torch.from_numpy(rng.integers(-(1 << 16), 1 << 16, size=(1, C2, L, N))
                                .astype(np.int32))
        keys = torch.zeros((len(amounts), 3, C2 * Td, C2, 1), dtype=torch.int32)
        seen.clear()
        ntt_cuda.fused_blind_rotate_plain(None, rows, keys, amounts)
        assert len(seen) == len(amounts)
        for s, ((x, base, sign, _), amount) in enumerate(zip(seen, amounts)):
            assert sign == 1
            # the base is the step's input: the rows, then the step before's output
            ct = (rows.numpy() if s == 0 else seen[s - 1][3])[0].astype(np.int64)
            assert np.array_equal(base[0], ct)
            rot = amount % (2 * N)
            kk = rot & (N - 1)
            src = np.where(i < kk, N - kk + i, i - kk)
            neg = (i < kk) != (rot >= N)
            banks = np.sort((src % 32).reshape(THREADS // 32, 32, 16), axis=1)
            assert (banks == np.arange(32)[None, :, None]).all(), amount
            for tt in range(C2 * Td):
                staged = np.full(N, 1 << 40)
                staged[words] = ct[tt // Td, tt % Td][words]
                got = np.where(neg, -staged[src], staged[src]) - staged[i]
                assert np.array_equal(got, x[0, tt][i]), (C2, L, Td, amount, tt)
