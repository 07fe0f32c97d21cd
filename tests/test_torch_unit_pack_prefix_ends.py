"""The ends of core/packer.pack_prefix and pack_tree, where no merge runs
and so no key is read: a prefix that stops at all its leaves is the full
pre-scale alone, a tree of one leaf is the pre-scale by its dilation alone,
and neither takes a leaf count that is no power of two.

One test a file on purpose: with `--dist loadfile` pytest-xdist hands files
out in order of their test count, so single-test files go last; a row of
millisecond files before the suite's longest single test lets it start on
a worker that is really free (ROADMAP.md, "Time budget")."""

import numpy as np
import pytest
import torch

from fhe_ram_tpu_torch.params import PARAMS_TEST_SMALL_WIDE as PAR
from fhe_ram_tpu_torch.ops import limb
from fhe_ram_tpu_torch.ops.ntt import get_ntt_context
from fhe_ram_tpu_torch.core import packer


def test_pack_prefix_and_pack_tree_without_a_merge():
    ctx = get_ntt_context(PAR.n, PAR.primes)
    rnd = np.random.default_rng(8)
    cts = torch.from_numpy(rnd.integers(
        -(1 << 16), 1 << 16, size=(8, 2, PAR.rank + 1, PAR.limbs_ct, PAR.n)
    ).astype(np.int32))
    assert torch.equal(packer.pack_prefix(PAR, ctx, cts, {}, 8),
                       limb.shift_right(cts, 3))
    one = cts[:1]
    assert torch.equal(packer.pack_tree(PAR, ctx, one, {}, dilate=4),
                       limb.shift_right(one, 2)[0])
    assert torch.equal(packer.pack_tree(PAR, ctx, one, {}, prescale=False), one[0])
    with pytest.raises(AssertionError):
        packer.pack_prefix(PAR, ctx, cts[:6], {}, 2)
    with pytest.raises(AssertionError):
        packer.pack_prefix(PAR, ctx, cts, {}, 3)
    with pytest.raises(AssertionError):
        packer.pack_tree(PAR, ctx, cts[:3], {})
    with pytest.raises(AssertionError):   # more levels than the ring has
        packer.pack_tree(PAR, ctx, cts, {}, dilate=PAR.n)
