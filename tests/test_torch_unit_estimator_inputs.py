"""The port's production presets and its secret sampler give the security
estimator the inputs that tests/test_security.py pins for the JAX package
(SECURITY.md): n = 2^12, q = 2^85 = 2^(17 * 5), sigma = 3.2, a sparse
ternary secret of exact weight n/2.  Runs no estimator.

One test a file on purpose: with `--dist loadfile` pytest-xdist hands files
out in order of their test count, so single-test files go last; a row of
millisecond files before the suite's longest single test lets it start on
a worker that is really free (ROADMAP.md, "Time budget")."""

import torch

from fhe_ram_tpu_torch import params as tparams
from fhe_ram_tpu_torch.core import rng
from tests import test_security as ref


def test_presets_and_secret_sampler_give_the_estimator_inputs():
    for name in ref.PRODUCTION_PRESETS:
        par = getattr(tparams, f"PARAMS_{name}")
        assert (par.log_n, par.sigma, par.xs_density) == (
            ref.EST_LOG_N, ref.EST_SIGMA, ref.EST_DENSITY), name
        assert max(par.k_ct, par.k_ggsw, par.k_evk_trace, par.k_evk_ggsw) <= ref.EST_LOG_Q
        assert par.k_evk_ggsw == ref.EST_LOG_Q == par.base2k * par.limbs_evk_ggsw, name
        assert par.base2k == 17 and par.k_ct == par.base2k * par.limbs_ct, name
        assert par.k_ggsw <= par.base2k * par.limbs_ggsw < par.k_ggsw + par.base2k, name
        assert par.k_evk_trace <= par.base2k * par.limbs_evk_trace, name
    n = 1 << ref.EST_LOG_N
    for rank in (1, 2):
        sk = rng.ternary_secret(rng.Source(7).split(), rank, n, ref.EST_DENSITY,
                                device="cpu")
        assert sk.shape == (rank, n) and sk.dtype == torch.int32
        for c in range(rank):
            assert int((sk[c] == 1).sum()) == int((sk[c] == -1).sum()) == n // 4
            assert int((sk[c] == 0).sum()) == n // 2
