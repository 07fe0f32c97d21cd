"""core/keyswitch.extract_slots at its smallest: one slot with bounded
support needs no split level and no trace step, so no key is read, on
either route; and a residue class of one slot is that slot.

One test a file on purpose: with `--dist loadfile` pytest-xdist hands files
out in order of their test count, so single-test files go last; a row of
millisecond files before the suite's longest single test lets it start on
a worker that is really free (ROADMAP.md, "Time budget")."""

import numpy as np
import torch

from fhe_ram_tpu_torch.params import PARAMS_TEST_SMALL_WIDE as PAR
from fhe_ram_tpu_torch.ops import limb
from fhe_ram_tpu_torch.ops.ntt import get_ntt_context
from fhe_ram_tpu_torch.core import keyswitch


def test_extracting_one_slot_is_the_normalized_input():
    ctx = get_ntt_context(PAR.n, PAR.primes)
    rnd = np.random.default_rng(9)
    ct = torch.from_numpy(rnd.integers(
        -(1 << 17), 1 << 17, size=(3, PAR.rank + 1, PAR.limbs_ct, PAR.n)
    ).astype(np.int32))
    want = limb.normalize(ct)[:, None]
    for tree in (False, True):
        got = keyswitch.extract_slots(PAR, ctx, ct, 1, {}, bounded_support=True,
                                      tree=tree)
        assert got.shape == (3, 1, PAR.rank + 1, PAR.limbs_ct, PAR.n)
        assert torch.equal(got, want)
    assert torch.equal(keyswitch.extract_slots(
        PAR, ctx, ct, 1, {}, bounded_support=True, dilate=1, residue=0), want)
    assert keyswitch._SPLIT_TREE_MAX == 64
