"""The port's whole read against the JAX package's read_impl at the other
geometries: single level (PARAMS_TEST_FLAT) and single-GGSW coordinates
with the read-path gadget truncation (PARAMS_TEST_SMALL_WIDE truncated,
the shape of the production preset; its untruncated operations are
compared one by one in tests/test_torch_kernels.py).

The read is a deterministic integer function of its arrays, so here the
RAM, the address coordinates and the trace keys are random int32 arrays
of the presets' shapes, made from a seed with numpy and prepared by each
side's own `prepare`; the outputs are compared bit for bit.  (The JAX
client's real ciphertexts go through tests/test_torch_read.py; making
them at every preset costs more JAX compiles than the suite's time
allows.)"""

import functools
from dataclasses import replace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fhe_ram_tpu import params as jparams
from fhe_ram_tpu.ops.ntt import get_ntt_context as jget_ctx
from fhe_ram_tpu.core import keyswitch as jks
from fhe_ram_tpu.ram import address as jaddress
from fhe_ram_tpu.ram import ram as jram

from fhe_ram_tpu_torch import params as tparams
from fhe_ram_tpu_torch.convert import from_reference
from fhe_ram_tpu_torch.ops.ntt import get_ntt_context as tget_ctx
from fhe_ram_tpu_torch.core import keys as tkeys
from fhe_ram_tpu_torch.core import keyswitch as tks
from fhe_ram_tpu_torch.ram import address as taddress
from fhe_ram_tpu_torch.ram import ram as tram

# one intra-op thread: the suite runs several workers side by side, and
# these sizes gain nothing from more
torch.set_num_threads(1)

# The JAX reference is compiled without XLA's optimisation passes and in one
# piece: the integers are the same, these sizes run in no time either way,
# and the compile takes a third less CPU time (the suite's workers share
# their cores, so CPU time is what the whole run pays for).
_jit = functools.partial(jax.jit, compiler_options={
    "xla_backend_optimization_level": 0,
    "xla_cpu_parallel_codegen_split_count": 1})


TRUNC = dict(read_ks_digits=2, read_ks_limbs=3,
             read_ep_digits=2, read_ep_limbs=3)
PRESETS = {
    "flat": ("PARAMS_TEST_FLAT", {}),
    "wide_trunc": ("PARAMS_TEST_SMALL_WIDE", TRUNC),
}


def _limbs(rnd, shape):
    return rnd.integers(-(1 << 16), 1 << 16, size=shape).astype(np.int32)


@pytest.mark.parametrize("name", list(PRESETS))
def test_read_matches_jax_bit_for_bit(name):
    base_name, trunc = PRESETS[name]
    jpar = replace(getattr(jparams, base_name), **trunc)
    tpar = replace(getattr(tparams, base_name), **trunc)
    rnd = np.random.default_rng(len(name))
    C, n = jpar.rank + 1, jpar.n
    ram_ct = _limbs(rnd, (jpar.word_size, jpar.num_rows, C, jpar.limbs_ct, n))
    atk = {g: _limbs(rnd, (jpar.dnum_ct, jpar.rank, C, jpar.limbs_evk_trace, n))
           for g in jpar.trace_gal_els}
    addrs = [tuple(_limbs(rnd, (len(row.bases), jpar.dnum_ct, C, C,
                                jpar.limbs_ggsw, n))
                   for row in jpar.base2d().rows) for _ in range(2)]

    jctx = jget_ctx(n, jpar.primes)
    jread = _jit(lambda d, a, ks: jram.read_impl(
        jpar, jctx, d, jaddress.prepare(jctx, jaddress.Address(a)).coordinates,
        {g: jks.key_prepare(jctx, k) for g, k in ks.items()}))

    tctx = tget_ctx(n, tpar.primes)
    carried = from_reference(ram=ram_ct, device="cpu")
    tatk = {g: tks.key_prepare(tctx, torch.from_numpy(k)) for g, k in atk.items()}
    server = tram.FheRam(
        tpar, tkeys.EvaluationKeysPrepared(atk_glwe=tatk, atk_ggsw={}, tsk=None),
        device="cpu")
    state = server.init_state(carried.data)
    for coords in addrs:
        want = np.asarray(jread(jnp.asarray(ram_ct),
                                tuple(jnp.asarray(c) for c in coords),
                                {g: jnp.asarray(k) for g, k in atk.items()}))
        taddr = from_reference(address=coords, device="cpu").address
        got = server.read(state, taddress.prepare(tctx, taddr))
        assert got.dtype == torch.int32 and got.shape == want.shape
        assert np.array_equal(got.numpy(), want), name
