"""The LOAD's float32 mod-switch (vm/bitdecomp._torus_f32, _msw) on the
port alone, against numpy float32 in the same order of operations: exact
ties round half to even (both in frac and in the slot rounding), negative
phases wrap mod 2N, and the top-two-limb torus value of random limbs is
numpy's.

One test a file on purpose: with `--dist loadfile` pytest-xdist hands files
out in order of their test count, so single-test files go last; a row of
millisecond files before the suite's longest single test lets it start on
a worker that is really free (ROADMAP.md, "Time budget")."""

import numpy as np
import torch

from fhe_ram_tpu_torch.vm.bitdecomp import _msw, _torus_f32


def _msw_numpy(t, scale, two_n, offset):
    v = t * np.float32(scale)
    v = v - np.round(v)
    s = np.round(v * np.float32(two_n)).astype(np.int32) + np.int32(offset)
    return np.mod(s, np.int32(two_n))


def test_mod_switch_rounds_ties_to_even_as_numpy_float32():
    two_n, scale = 32, 8
    k = np.arange(-40, 40, dtype=np.float32)
    # v * 2N = k + 1/2 (ties of the slot rounding), t * scale = k + 1/2
    # (ties of frac), and points between
    t = np.concatenate([(k + 0.5) / (two_n * scale), (k + 0.5) / scale,
                        (k + 0.25) / (two_n * scale)]).astype(np.float32)
    for offset in (0, 3):
        got = _msw(torch.from_numpy(t), scale, two_n, offset)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), _msw_numpy(t, scale, two_n, offset))
    # half to even, not half away from zero: 0.5 -> 0, 1.5 -> 2, -2.5 -> -2
    ties = torch.tensor([0.5, 1.5, -2.5], dtype=torch.float32) / (two_n * scale)
    assert _msw(ties, scale, two_n, 0).tolist() == [0, 2, two_n - 2]

    rnd = np.random.default_rng(17)
    limbs = rnd.integers(-(1 << 16), 1 << 16, size=(5, 3, 16)).astype(np.int32)
    want = (limbs[:, 0].astype(np.float32) * np.float32(2.0 ** -17)
            + limbs[:, 1].astype(np.float32) * np.float32(2.0 ** -34))
    assert np.array_equal(_torus_f32(torch.from_numpy(limbs)).numpy(), want)
