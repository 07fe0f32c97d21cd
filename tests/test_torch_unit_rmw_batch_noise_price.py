"""The analytic price of a batched read-modify-write (core/noise.py): every
row of the new RAM receives one inverse-product term per address, so B
addresses add B times the variance and the deterministic part of one write
cycle.  At the 2^18 preset a batch of 16 stays far inside the decoding
bound 2^-(k_pt+1).

One test a file on purpose: with `--dist loadfile` pytest-xdist hands files
out in order of their test count, so single-test files go last; a row of
millisecond files before the suite's longest single test lets it start on
a worker that is really free (ROADMAP.md, "Time budget")."""

import math

from fhe_ram_tpu_torch.params import PARAMS_2_18_TURBO_READOPT as PAR
from fhe_ram_tpu_torch.core import noise


def test_a_batch_of_16_writes_is_priced_far_inside_the_bound():
    var, det = noise.write_cycle_added_var(PAR)
    assert var > 0.0 and det >= 0.0
    one = noise.bound_log2(var, det)
    batch = noise.bound_log2(16 * var, 16 * det)
    assert one < batch <= one + 4.0          # at most 16 x the amplitude
    assert batch >= one + 2.0                # at least sqrt(16) x
    budget = -(PAR.k_pt + 1)
    assert budget == -10
    assert batch < budget - 8                # ~2^-21 against 2^-10
    # how many such batches the RAM takes before a refresh, by this model
    assert math.floor(4.0 ** (budget - batch)) > 1000
