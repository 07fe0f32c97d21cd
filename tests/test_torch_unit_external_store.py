"""Kernel 12's unit walk and store (csrc/external.cu on the fold body),
emulated on index arrays with the launch its wrapper picks
(ops/ntt_cuda._external_launch):

* the persistent blocks walk the units u = blockIdx.x, + gridDim.x, ...;
  unit u is part u % split of the output polys of prime (u / split) % P of
  row u / (split * P), and its part takes polys [part * M / split,
  (part + 1) * M / split): every (prime, row, output poly) is computed by
  exactly one unit, with the few-row split (split > 1) and without;
* the store: `inverse` leaves coefficient i = t | r << 8 (thread t,
  register r, layout L0) at word swz(i) of the buffer; thread t reads
  register r of layout L2 back from word swz(t << 4) ^ swz(r) and writes it
  at word (t << 4) | r of the output poly, four 16-byte stores: that word
  holds exactly the coefficient stored there, every coefficient is written
  once, a warp's 32 reads of one register hit 32 banks, and a warp's stores
  cover 2 KB back to back;
* the shared memory of the instantiation picked fits the blocks an SM it
  budgets for.

The CPU tests never launch the kernel; this is its only check here.

One test a file on purpose: with `--dist loadfile` pytest-xdist hands files
out in order of their test count, so single-test files go last; a row of
millisecond files before the suite's longest single test lets it start on
a worker that is really free (ROADMAP.md, "Time budget")."""

import re
from pathlib import Path

import numpy as np

from fhe_ram_tpu_torch.ops import ntt_cuda

CSRC = Path(ntt_cuda.__file__).resolve().parent.parent / "csrc"
TEXT = (CSRC / "fold_body.cuh").read_text() + (CSRC / "fhe_core.cuh").read_text()
THREADS = int(re.search(r"#define FOLD_THREADS (\d+)", TEXT).group(1))
N = int(re.search(r"#define FOLD_N (\d+)", TEXT).group(1))
P = int(re.search(r"#define FHE_P (\d+)", TEXT).group(1))


def swz(i):
    return i ^ ((i >> 5) & 15) ^ ((i >> 4) & 16)


def test_external_unit_walk_and_store_write_every_output_word_once():
    t = np.arange(THREADS)[:, None]
    r = np.arange(16)[None, :]
    # where inverse leaves each coefficient: word swz(t | r << 8) holds t | r << 8
    held = np.empty(N, dtype=np.int64)
    held[swz(t | (r << 8))] = t | (r << 8)
    # the store: thread t, register r (= 4k + j of store k) reads word
    # swz(t << 4) ^ swz(r) and writes word (t << 4) | r of the output poly
    read = swz(t << 4) ^ swz(r)
    dest = (t << 4) | r
    assert np.array_equal(held[read], dest)
    assert np.array_equal(np.sort(dest.ravel()), np.arange(N))
    for w in range(THREADS // 32):
        for reg in range(16):
            assert len(set(read[32 * w: 32 * (w + 1), reg] % 32)) == 32
        rows = dest[32 * w: 32 * (w + 1)]
        assert np.array_equal(np.sort(rows.ravel()), 512 * w + np.arange(512))
    assert (dest[:, ::4] % 4 == 0).all()   # 16-byte aligned stores

    # (B, T, M, SMs): the read's level 0, a few rows (split), a small card
    # that makes every block walk several units, an uneven split
    for B, T, M, sms in ((256, 4, 6, 132), (2, 3, 2, 132), (64, 4, 6, 16),
                         (3, 2, 5, 132), (1, 6, 3, 8), (40, 12, 1, 132)):
        split, total, blocks = ntt_cuda._external_launch(B, T, M, sms)
        units = B * P * split
        assert 1 <= split <= M and total == min(units, blocks * sms)
        assert split == 1 or units <= sms
        smem = (T + 2) * 4 * N
        assert smem <= ntt_cuda._MAX_SMEM
        assert blocks * (smem + 1024) <= ntt_cuda._SM_SMEM
        hits = np.zeros((P, B, M), dtype=np.int64)
        walked = np.zeros(units, dtype=np.int64)
        for blk in range(total):
            for u in range(blk, units, total):
                walked[u] += 1
                part, pi, b = u % split, (u // split) % P, u // (split * P)
                hits[pi, b, part * M // split: (part + 1) * M // split] += 1
        assert (walked == 1).all(), (B, T, M, sms)
        assert (hits == 1).all(), (B, T, M, sms)
