"""The second child of a split level on the fold body (csrc/split.cu
SplitStore, called in the Garner step of fold_body.cuh's garner_fold):
every block of the cluster walks its share of the coefficients of its
components (garner_fold's i_per cut, its threads' stride), carries
d_l = +-(2 x - child0) of each coefficient from l = L - 1 down to 0 and
stores it at its word of child1 rotated by X^t_back.  Emulated at
N = 4096 for clusters of 3 and 6 blocks: the walk writes every word of
child1 exactly once, and for random x and child0 the result equals the
child1 of ops/ntt_cuda.split_level (limb_ops.normalize(poly.rotate(2x -
child0, -t))), bit for bit, at t = 1, 32 and 2048 (half the coefficients
wrap).  The CPU tests never launch the kernel; this is its only check
here.

One test a file on purpose: with `--dist loadfile` pytest-xdist hands files
out in order of their test count, so single-test files go last; a row of
millisecond files before the suite's longest single test lets it start on
a worker that is really free (ROADMAP.md, "Time budget")."""

import re
from pathlib import Path

import numpy as np
import torch

from fhe_ram_tpu_torch.ops import ntt_cuda
from fhe_ram_tpu_torch.params import PARAMS_2_18_TURBO_READOPT as PAR

CSRC = Path(ntt_cuda.__file__).resolve().parent.parent / "csrc"
TEXT = (CSRC / "fold_body.cuh").read_text() + (CSRC / "fhe_core.cuh").read_text()
THREADS = int(re.search(r"#define FOLD_THREADS (\d+)", TEXT).group(1))
N = int(re.search(r"#define FOLD_N (\d+)", TEXT).group(1))
P = int(re.search(r"#define FHE_P (\d+)", TEXT).group(1))


def test_split_store_walk_writes_child1_once_and_matches_split_level():
    C2, L = PAR.rank + 1, PAR.limbs_ct
    rnd = np.random.default_rng(7)
    i_per = (N // P + 31) & ~31                       # garner_fold's cut
    for t_rot in (1, 32, 2048):
        x, c0 = (rnd.integers(-(1 << 16), 1 << 16, size=(C2, L, N)) for _ in range(2))
        _, want = ntt_cuda.split_level(
            None, torch.from_numpy(x[None].astype(np.int32)), t_rot, 3,
            torch.zeros((P, (C2 - 1) * L, C2, 1), dtype=torch.int32),
            lambda *a, **k: torch.from_numpy(c0[None].astype(np.int32)))
        t_back = -t_rot % (2 * N)                     # as fused_split passes it
        kk = t_back & (N - 1)
        xf, c0f = x.reshape(-1), c0.reshape(-1)
        for cs in (3, 6):
            c1 = np.full(C2 * L * N, 1 << 40)
            writes = np.zeros(C2 * L * N, dtype=np.int64)
            for rank in range(cs):
                pi, grp = rank % P, rank // P
                c2_per = C2 // (cs // P)
                i = pi * i_per + np.arange(THREADS)[:, None] + THREADS * np.arange(
                    -(-i_per // THREADS))
                i = i[i < min(N, (pi + 1) * i_per)]
                for c2 in range(grp * c2_per, (grp + 1) * c2_per):
                    carry = 0
                    for l in range(L - 1, -1, -1):
                        at = (c2 * L + l) * N + i
                        wrap = i + kk >= N
                        v = 2 * xf[at] - c0f[at]
                        v = np.where(wrap != (t_back >= N), -v, v) + carry
                        d = ((v + 65536) & 131071) - 65536
                        carry = (v - d) >> 17
                        dest = at + np.where(wrap, kk - N, kk)
                        c1[dest] = d
                        np.add.at(writes, dest, 1)
            assert (writes == 1).all(), (t_rot, cs)
            assert np.array_equal(c1.reshape(C2, L, N), want[0].numpy()), (t_rot, cs)
