"""The batched read's modules of the PyTorch port held against the JAX
package on the same inputs, on the CPU: the batched and keyed external
products, and the batched coordinate products with and without the
spectral cache (the plain versions of the batched fold kernel and of the
fold kernel's spectral input).

The JAX side runs its composed path under jax.jit (per-item loops; it
ignores the spectral cache and recomputes); the port runs on CPU tensors,
where each wrapper takes its kernel's plain version.  Inputs are random
int32 arrays of the presets' shapes, made from a seed with numpy and
prepared by each side's own `prepare`; outputs are compared bit for bit
(np.array_equal, tolerance 0: integer arithmetic).  The whole batched
read on the JAX client's ciphertexts is in tests/test_torch_read.py."""

import functools
from dataclasses import replace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fhe_ram_tpu.params import PARAMS_TEST_SMALL as JSMALL
from fhe_ram_tpu.params import PARAMS_TEST_SMALL_WIDE as JWIDE
from fhe_ram_tpu.ops.ntt import get_ntt_context as jget_ctx
from fhe_ram_tpu.core import ggsw as jggsw
from fhe_ram_tpu.ram import address as jaddress

from fhe_ram_tpu_torch.params import PARAMS_TEST_SMALL as TSMALL
from fhe_ram_tpu_torch.params import PARAMS_TEST_SMALL_WIDE as TWIDE
from fhe_ram_tpu_torch.ops.ntt import get_ntt_context as tget_ctx
from fhe_ram_tpu_torch.ops.ntt import ntt_fwd_plain
from fhe_ram_tpu_torch.ops import ntt_cuda
from fhe_ram_tpu_torch.core import ggsw as tggsw
from fhe_ram_tpu_torch.ram import address as taddress

# one intra-op thread: the suite runs several workers side by side, and
# these sizes gain nothing from more
torch.set_num_threads(1)

# The JAX reference is compiled without XLA's optimisation passes, in one
# piece and with XLA:CPU's loop emitters (its fusion emitters compile on
# several threads): the integers are the same, these sizes run in no time
# either way, and the compile takes less CPU time (the suite's workers
# share their cores, so CPU time is what the whole run pays for).
_jit = functools.partial(jax.jit, compiler_options={
    "xla_backend_optimization_level": 0,
    "xla_cpu_parallel_codegen_split_count": 1,
    "xla_cpu_use_fusion_emitters": False})

TRUNC = dict(read_ks_digits=2, read_ks_limbs=3,
             read_ep_digits=2, read_ep_limbs=3)
JCTX = jget_ctx(JWIDE.n, JWIDE.primes)
TCTX = tget_ctx(TWIDE.n, TWIDE.primes)
C, L, N = JWIDE.rank + 1, JWIDE.limbs_ct, JWIDE.n


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _limbs(rnd, shape, bits=16):
    return rnd.integers(-(1 << bits), 1 << bits, size=shape).astype(np.int32)


def _jprep_each(coords):
    """jggsw.prepare of every item of a leading batch axis."""
    return jax.vmap(lambda g: jggsw.prepare(JCTX, g))(coords)


def test_external_product_batched_matches_jax():
    """One GGSW per item, unnormalized digits (a CMux's high - low), with
    base and sign = -1."""
    rnd = np.random.default_rng(31)
    B = 3
    gg = _limbs(rnd, (B, L, C, C, JWIDE.limbs_ggsw, N))
    ct = _limbs(rnd, (B, C, L, N), bits=17)
    base = _limbs(rnd, (B, C, L, N), bits=17)
    want = np.asarray(_jit(lambda c, g, b: jggsw.external_product_batched(
        JWIDE, JCTX, c, jnp.moveaxis(_jprep_each(g), 0, 1), base=b, sign=-1))(
            jnp.asarray(ct), jnp.asarray(gg), jnp.asarray(base)))
    tg = torch.stack([tggsw.prepare(TCTX, _t(g)) for g in gg], dim=1)
    got = tggsw.external_product_batched(TWIDE, TCTX, _t(ct), tg,
                                         base=_t(base), sign=-1)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_external_product_keyed_matches_jax():
    """K GGSWs for B rows each, with gadget truncation (2 digits, 3 key
    limbs) and the output at the untruncated limb count."""
    rnd = np.random.default_rng(32)
    K, B = 2, 3
    gg = _limbs(rnd, (K, L, C, C, JWIDE.limbs_ggsw, N))
    ct = _limbs(rnd, (K, B, C, L, N))
    want = np.asarray(_jit(lambda c, g: jggsw.external_product_keyed(
        JWIDE, JCTX, c, jnp.moveaxis(_jprep_each(g), 0, 1), trunc=(2, 3)))(
            jnp.asarray(ct), jnp.asarray(gg)))
    tg = torch.stack([tggsw.prepare(TCTX, _t(g)) for g in gg], dim=1)
    got = tggsw.external_product_keyed(TWIDE, TCTX, _t(ct), tg, trunc=(2, 3))
    assert got.shape == (K, B, C, L, N) and np.array_equal(got.numpy(), want)


# (JAX params, port params): two chained CMux digits with the full gadget
# (digit 0 consumes the shared spectra, digit 1 transforms the carry), and
# one wide digit with the read truncation (the cache is sliced to D < L)
BATCH_CASES = {
    "two_digit_chain": (JSMALL, TSMALL),
    "wide_trunc": (replace(JWIDE, **TRUNC), replace(TWIDE, **TRUNC)),
}


@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_coordinate_product_batched_matches_jax_with_and_without_cache(case):
    jpar, tpar = BATCH_CASES[case]
    rnd = np.random.default_rng(33)
    A = 3
    dig = len(jpar.base2d().rows[0].bases)
    coords = _limbs(rnd, (A, dig, jpar.dnum_ct, C, C, jpar.limbs_ggsw, N))
    ct = _limbs(rnd, (2, 2, C, L, N))
    trunc = jpar.read_ep_trunc
    want = np.asarray(_jit(lambda c, g: jaddress.coordinate_product_batched(
        jpar, JCTX, c, _jprep_each(g), trunc=trunc))(
            jnp.asarray(ct), jnp.asarray(coords)))
    tcoords = torch.stack([tggsw.prepare(TCTX, _t(g)) for g in coords], dim=0)
    got = taddress.coordinate_product_batched(tpar, TCTX, _t(ct), tcoords,
                                              trunc=trunc)
    assert got.shape == (A, 2, 2, C, L, N) and np.array_equal(got.numpy(), want)
    cache = taddress.spectral_cache(tpar, TCTX, _t(ct))
    assert cache.shape == (3, 4, C * L, N)
    cached = taddress.coordinate_product_batched(tpar, TCTX, _t(ct), tcoords,
                                                 cache, trunc=trunc)
    assert torch.equal(cached, got)
    # and each item equals the unbatched coordinate product
    for a in range(A):
        one = taddress.coordinate_product(tpar, TCTX, _t(ct), tcoords[a],
                                          trunc=trunc)
        assert torch.equal(one, got[a])


def test_coordinate_product_perbatch_matches_jax():
    jpar, tpar = JSMALL, TSMALL
    rnd = np.random.default_rng(34)
    A = 3
    coords = _limbs(rnd, (A, 2, jpar.dnum_ct, C, C, jpar.limbs_ggsw, N))
    ct_b = _limbs(rnd, (A, 2, C, L, N))
    want = np.asarray(_jit(lambda c, g: jaddress.coordinate_product_perbatch(
        jpar, JCTX, c, _jprep_each(g)))(jnp.asarray(ct_b), jnp.asarray(coords)))
    tcoords = torch.stack([tggsw.prepare(TCTX, _t(g)) for g in coords], dim=0)
    got = taddress.coordinate_product_perbatch(tpar, TCTX, _t(ct_b), tcoords)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_spectral_input_takes_any_representative():
    """The fold's spectral input is reduced on load: spectra shifted by
    multiples of their prime give the same result as canonical ones, and
    as the coefficient-domain call."""
    rnd = np.random.default_rng(35)
    B, T, M = 2, C * L, C * 3
    x = _t(_limbs(rnd, (B, T, N)))
    keys = ntt_fwd_plain(TCTX, _t(_limbs(rnd, (2, T, M, N)))).reshape(3, 2, T, M, N)
    want = ntt_cuda.fused_external_fold(TCTX, x, keys, L, C)
    spec = ntt_fwd_plain(TCTX, x)
    p = torch.tensor(TCTX.primes, dtype=torch.int32).reshape(3, 1, 1, 1)
    shift = _t(rnd.integers(-3, 4, size=spec.shape).astype(np.int32))
    for s in (spec, spec + shift * p):
        got = ntt_cuda.fused_external_fold(TCTX, s, keys, L, C, x_is_ntt=True)
        assert torch.equal(got, want)
    batched = ntt_cuda.fused_external_fold_batched(
        TCTX, spec + shift * p, torch.stack([keys, keys]), L, C, x_is_ntt=True)
    assert torch.equal(batched[0], want) and torch.equal(batched[1], want)


@pytest.mark.parametrize("with_base", [False, True], ids=["plain", "base_sign"])
def test_batched_fold_equals_the_fold_of_each_item(with_base):
    """fused_external_fold_batched against fused_external_fold item by
    item, on the port alone: own rows per item, and M of 5 key limbs folded
    to 3 output limbs (the GGSW inversion's shape)."""
    rnd = np.random.default_rng(36)
    A, B, T, Lk = 3, 2, 4, 5
    x = _t(_limbs(rnd, (A, B, T, N), bits=18))
    keys = torch.stack([
        ntt_fwd_plain(TCTX, _t(_limbs(rnd, (1, T, C * Lk, N)))).reshape(3, 1, T, C * Lk, N)
        for _ in range(A)])
    base = _t(_limbs(rnd, (A, B, C, L, N), bits=17)) if with_base else None
    sign = -1 if with_base else 1
    got = ntt_cuda.fused_external_fold_batched(TCTX, x, keys, L, C, base=base,
                                               sign=sign)
    assert got.shape == (A, B, C, L, N) and got.dtype == torch.int32
    for a in range(A):
        one = ntt_cuda.fused_external_fold(
            TCTX, x[a], keys[a], L, C, base=None if base is None else base[a],
            sign=sign)
        assert torch.equal(got[a], one)
