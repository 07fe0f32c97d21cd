"""The LOAD chain's rotation (vm/bitdecomp._rot_dyn) on the port alone: one
gather over [x, -x, x] at device-side positions j + 2N - a equals
poly.rotate, the static rotation, for every amount in [0, 2N) at
N = 16, the amounts batched over leading axes as a chain step gives them
(two signs x tests, over components and limbs).

One test a file on purpose: with `--dist loadfile` pytest-xdist hands files
out in order of their test count, so single-test files go last; a row of
millisecond files before the suite's longest single test lets it start on
a worker that is really free (ROADMAP.md, "Time budget")."""

import numpy as np
import torch

from fhe_ram_tpu_torch.ops import poly
from fhe_ram_tpu_torch.vm.bitdecomp import _rot_dyn


def test_gather_rotation_equals_poly_rotate_for_every_amount():
    n = 16
    rnd = np.random.default_rng(16)
    amounts = torch.arange(2 * n, dtype=torch.int32).reshape(2, n)   # [2, K]
    x = torch.from_numpy(rnd.integers(-(1 << 16), 1 << 16,
                                      size=(2, n, 2, 3, n)).astype(np.int32))
    got = _rot_dyn(x, amounts, n)
    assert got.dtype == torch.int32 and got.shape == x.shape
    for s in range(2):
        for k in range(n):
            assert torch.equal(got[s, k], poly.rotate(x[s, k], int(amounts[s, k])))
    # one amount a row of a 2-D stack (the chain's first accumulator)
    flat = x[0, :, 0]                                                # [K, L, N]
    assert torch.equal(_rot_dyn(flat, amounts[1], n)[3],
                       poly.rotate(flat[3], int(amounts[1, 3])))
