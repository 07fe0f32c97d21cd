"""ggsw_key_rows: bit j of prepared bits [P, W, D, C, C2, Lg, N] as the
kernels' key rows [P, C*D, C2*Lg, N] -- row t = c*D + d (component-major),
column m = c2*Lg + limb -- keeping the top in_digits gadget rows and top
key_limbs limbs, the same integers as the JAX package's on the same array.

One test a file on purpose: with `--dist loadfile` pytest-xdist hands files
out in order of their test count, so single-test files go last; a row of
millisecond files before the suite's longest single test lets it start on
a worker that is really free (ROADMAP.md, "Time budget")."""

import numpy as np
import torch

from fhe_ram_tpu.vm import circuits as jcirc
from fhe_ram_tpu_torch.vm import circuits as tcirc


def test_key_rows_layout_and_truncation():
    P, W, D, C, C2, Lg, n = 3, 4, 3, 2, 2, 4, 8
    prep = np.arange(P * W * D * C * C2 * Lg * n, dtype=np.int32).reshape(
        P, W, D, C, C2, Lg, n)
    for trunc in ((None, None), (2, 3), (1, None)):
        for j in (0, W - 1):
            got = tcirc.ggsw_key_rows(torch.from_numpy(prep), j, trunc).numpy()
            Dt = trunc[0] or D
            Lt = trunc[1] or Lg
            assert got.shape == (P, C * Dt, C2 * Lt, n)
            for c in range(C):
                for d in range(Dt):
                    for c2 in range(C2):
                        for lg in range(Lt):
                            assert np.array_equal(got[:, c * Dt + d, c2 * Lt + lg],
                                                  prep[:, j, d, c, c2, lg])
            assert np.array_equal(got, np.asarray(jcirc.ggsw_key_rows(prep, j, trunc)))
