"""What the one-launch tree wrappers of ops/ntt_cuda.py refuse before they
reach a kernel or a plain version: levels that do not fit the keys, a
truncated key, keys on another device, too many levels, a leaf count that
is no power of two.
One test a file on purpose: with `--dist loadfile` pytest-xdist hands files
out in order of their test count, so single-test files go last; a row of
millisecond files before the suite's longest single test lets it start on
a worker that is really free (ROADMAP.md, "Time budget")."""

import pytest
import torch

from fhe_ram_tpu_torch.params import PARAMS_TEST_SMALL_WIDE as TWIDE
from fhe_ram_tpu_torch.ops.ntt import get_ntt_context
from fhe_ram_tpu_torch.ops import ntt_cuda

TCTX = get_ntt_context(TWIDE.n, TWIDE.primes)


def test_tree_wrappers_refuse_what_the_kernels_do_not_take():
    ct = torch.zeros((1, 2, 3, 64), dtype=torch.int32)
    keys = torch.zeros((2, 3, 3, 8, 64), dtype=torch.int32)
    gals = TWIDE.trace_gal_els[:2]
    assert ntt_cuda.fused_split_tree(TCTX, ct, gals, keys).shape == (1, 4, 2, 3, 64)
    with pytest.raises(ValueError):  # levels and galois elements differ
        ntt_cuda.fused_split_tree(TCTX, ct, gals[:1], keys)
    with pytest.raises(ValueError):  # a truncated key
        ntt_cuda.fused_split_tree(TCTX, ct, gals, keys[:, :, :2])
    with pytest.raises(ValueError):  # keys on another device
        ntt_cuda.fused_split_tree(TCTX, ct, gals, keys.to("meta"))
    with pytest.raises(ValueError):  # more levels than one launch walks
        ntt_cuda.fused_split_tree(TCTX, ct, (3,) * 17, keys[:1].expand(17, -1, -1, -1, -1))
    cts = torch.zeros((4, 1, 2, 3, 64), dtype=torch.int32)
    assert ntt_cuda.fused_pack_tree(TCTX, cts, keys).shape == (1, 2, 3, 64)
    with pytest.raises(ValueError):  # 4 leaves need 2 levels of keys
        ntt_cuda.fused_pack_tree(TCTX, cts, keys[:1])
    with pytest.raises(ValueError):  # not a power of two
        ntt_cuda.fused_pack_tree(TCTX, cts[:3], keys)
    with pytest.raises(ValueError):  # one leaf is no tree
        ntt_cuda.fused_pack_tree(TCTX, cts[:1], keys[:0])
    with pytest.raises(ValueError):  # a truncated key
        ntt_cuda.fused_pack_tree(TCTX, cts, keys[:, :, :2])
    with pytest.raises(ValueError):  # keys on another device
        ntt_cuda.fused_pack_tree(TCTX, cts, keys.to("meta"))
