"""The plain PyTorch version of each of the port's four CUDA kernels held
against the JAX package's function on the same inputs, on the CPU.

The JAX side runs its composed path (the `butterfly` backend, which is
the Pallas kernels' own plain reference); the port runs on CPU tensors,
where each wrapper takes its kernel's plain version.  Keys are small
random polynomials prepared by each side's own `prepare`: spectra are
never compared, coefficient-domain outputs are, bit for bit
(np.array_equal, tolerance 0 -- all of it is integer arithmetic)."""

from dataclasses import replace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fhe_ram_tpu.params import PARAMS_TEST_SMALL_WIDE as JWIDE
from fhe_ram_tpu.params import PARAMS_TEST_SMALL as JSMALL
from fhe_ram_tpu.params import PARAMS_2_18_TURBO_READOPT as JFULL
from fhe_ram_tpu.ops.ntt import get_ntt_context as jget_ctx
from fhe_ram_tpu.core import ggsw as jggsw
from fhe_ram_tpu.core import keyswitch as jks
from fhe_ram_tpu.core import packer as jpacker
from fhe_ram_tpu.ram import address as jaddress

from fhe_ram_tpu_torch.params import PARAMS_TEST_SMALL_WIDE as TWIDE
from fhe_ram_tpu_torch.params import PARAMS_TEST_SMALL as TSMALL
from fhe_ram_tpu_torch.params import PARAMS_2_18_TURBO_READOPT as TFULL
from fhe_ram_tpu_torch.ops.ntt import get_ntt_context as tget_ctx
from fhe_ram_tpu_torch.ops import ntt_cuda
from fhe_ram_tpu_torch.core import ggsw as tggsw
from fhe_ram_tpu_torch.core import keyswitch as tks
from fhe_ram_tpu_torch.core import packer as tpacker
from fhe_ram_tpu_torch.ram import address as taddress

# one intra-op thread: the suite runs several workers side by side, and
# these sizes gain nothing from more
torch.set_num_threads(1)


TRUNC = dict(read_ks_digits=2, read_ks_limbs=3,
             read_ep_digits=2, read_ep_limbs=3)
# (JAX params, port params, batch): log_n = 6 with the full gadget and with
# the truncated one, and one case at the full ring degree with B <= 2
CASES = {
    "n64_full": (JWIDE, TWIDE, 3),
    "n64_trunc": (replace(JWIDE, **TRUNC), replace(TWIDE, **TRUNC), 3),
    "n4096_trunc": (JFULL, TFULL, 2),
}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ct(rnd, par, lead, bits=16):
    shape = tuple(lead) + (par.rank + 1, par.limbs_ct, par.n)
    return rnd.integers(-(1 << bits), 1 << bits, size=shape).astype(np.int32)


def _both_ctx(par):
    return jget_ctx(par.n, par.primes), tget_ctx(par.n, par.primes)


def _atk(rnd, par, gals):
    """{g: small random automorphism-key polys [D, rank, C2, Lk, N]}."""
    shape = (par.dnum_ct, par.rank, par.rank + 1, par.limbs_evk_trace, par.n)
    return {g: rnd.integers(-(1 << 16), 1 << 16, size=shape).astype(np.int32)
            for g in gals}


def _prepare_both(jctx, tctx, atk):
    jprep = jax.jit(lambda k: jks.key_prepare(jctx, k))
    return ({g: jprep(jnp.asarray(k)) for g, k in atk.items()},
            {g: tks.key_prepare(tctx, _t(k)) for g, k in atk.items()})


@pytest.mark.parametrize("case", list(CASES))
def test_external_product_matches_jax(case):
    jpar, tpar, B = CASES[case]
    rnd = np.random.default_rng(1)
    jctx, tctx = _both_ctx(jpar)
    C = jpar.rank + 1
    gg = rnd.integers(-(1 << 16), 1 << 16, size=(
        jpar.dnum_ct, C, C, jpar.limbs_ggsw, jpar.n)).astype(np.int32)
    ct = _ct(rnd, jpar, (B,))
    D, Lg = jpar.read_ep_trunc
    jg = jax.jit(lambda k: jggsw.prepare(jctx, k))(jnp.asarray(gg))[:, :D][..., :Lg, :]
    tg = tggsw.prepare(tctx, _t(gg))[:, :D][..., :Lg, :]
    want = np.asarray(jax.jit(
        lambda c, k: jggsw.external_product(jpar, jctx, c, k))(jnp.asarray(ct), jg))
    got = tggsw.external_product(tpar, tctx, _t(ct), tg).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want)


@pytest.mark.parametrize("out_limbs", [2])
def test_external_product_out_limbs_matches_jax(out_limbs):
    jpar, tpar, B = CASES["n64_full"]
    rnd = np.random.default_rng(2)
    jctx, tctx = _both_ctx(jpar)
    gg = rnd.integers(-(1 << 16), 1 << 16, size=(
        jpar.dnum_ct, 2, 2, jpar.limbs_ggsw, jpar.n)).astype(np.int32)
    ct = _ct(rnd, jpar, (2, B))
    want = np.asarray(jax.jit(lambda c, k: jggsw.external_product(
        jpar, jctx, c, jggsw.prepare(jctx, k), out_limbs=out_limbs))(
            jnp.asarray(ct), jnp.asarray(gg)))
    got = tggsw.external_product(tpar, tctx, _t(ct), tggsw.prepare(tctx, _t(gg)),
                                 out_limbs=out_limbs).numpy()
    assert np.array_equal(got, want)


def test_coordinate_product_digit_chain_matches_jax():
    """Two chained CMux digits (decomp_n = (3, 3)): the fold's digits > 1
    loop against the JAX package's per-digit external products."""
    jpar, tpar = JSMALL, TSMALL
    rnd = np.random.default_rng(3)
    jctx, tctx = _both_ctx(jpar)
    coord = rnd.integers(-(1 << 16), 1 << 16, size=(
        2, jpar.dnum_ct, 2, 2, jpar.limbs_ggsw, jpar.n)).astype(np.int32)
    ct = _ct(rnd, jpar, (2, 4))
    want = np.asarray(jax.jit(lambda c, k: jaddress.coordinate_product(
        jpar, jctx, c, jggsw.prepare(jctx, k)))(jnp.asarray(ct), jnp.asarray(coord)))
    got = taddress.coordinate_product(
        tpar, tctx, _t(ct), tggsw.prepare(tctx, _t(coord))).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("case", list(CASES))
def test_keyswitch_with_base_add_matches_jax(case):
    jpar, tpar, B = CASES[case]
    rnd = np.random.default_rng(4)
    jctx, tctx = _both_ctx(jpar)
    atk = _atk(rnd, jpar, (3,))
    jk, tk = _prepare_both(jctx, tctx, atk)
    ct, base = _ct(rnd, jpar, (B,)), _ct(rnd, jpar, (B,), bits=17)
    D, Lk = jpar.read_ks_trunc
    want = np.asarray(jax.jit(lambda c, k, b: jks.keyswitch(
        jpar, jctx, c, k, base_add=b, in_digits=D, key_limbs=Lk))(
            jnp.asarray(ct), jk[3], jnp.asarray(base)))
    got = tks.keyswitch(tpar, tctx, _t(ct), tk[3], base_add=_t(base),
                        in_digits=D, key_limbs=Lk).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("case", list(CASES))
def test_merge_level_matches_jax(case):
    """Unnormalized inputs up to 2^17, as the first merge level gets them
    from the pre-shift (u, v reach 2^18)."""
    jpar, tpar, B = CASES[case]
    rnd = np.random.default_rng(5)
    jctx, tctx = _both_ctx(jpar)
    l = 3
    t, g = 1 << l, (jpar.n >> l) + 1
    atk = _atk(rnd, jpar, (g,))
    jk, tk = _prepare_both(jctx, tctx, atk)
    A, Bc = _ct(rnd, jpar, (B,), bits=17), _ct(rnd, jpar, (B,), bits=17)
    trunc = jpar.read_ks_trunc
    want = np.asarray(jax.jit(lambda a, b, k: jpacker._merge_level(
        jpar, jctx, a, b, t, g, k, trunc=trunc))(
            jnp.asarray(A), jnp.asarray(Bc), jk[g]))
    got = tpacker._merge_level(tpar, tctx, _t(A), _t(Bc), t, g, tk[g],
                               trunc=trunc).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("case,steps", [("n64_full", 3), ("n64_trunc", 3),
                                        ("n4096_trunc", 2)])
def test_trace_steps_matches_jax(case, steps):
    jpar, tpar, B = CASES[case]
    rnd = np.random.default_rng(6)
    jctx, tctx = _both_ctx(jpar)
    gals = jpar.trace_gal_els[:steps]
    jk, tk = _prepare_both(jctx, tctx, _atk(rnd, jpar, gals))
    ct = _ct(rnd, jpar, (B,))
    trunc = jpar.read_ks_trunc
    want = np.asarray(jax.jit(lambda c, k: jks.trace_steps(
        jpar, jctx, c, k, gals, trunc=trunc))(jnp.asarray(ct), jk))
    got = tks.trace_steps(tpar, tctx, _t(ct), tk, gals, trunc=trunc).numpy()
    assert np.array_equal(got, want)


def test_pack_and_full_trace_match_jax():
    """pack() over 8 leaves (three merge levels, pre-shift without
    normalize) and the full trace (pre-scale in steps, then log_n steps)."""
    jpar, tpar, _ = CASES["n64_trunc"]
    rnd = np.random.default_rng(7)
    jctx, tctx = _both_ctx(jpar)
    jk, tk = _prepare_both(jctx, tctx, _atk(rnd, jpar, jpar.trace_gal_els))
    cts = _ct(rnd, jpar, (8, 2))
    trunc = jpar.read_ks_trunc
    want = np.asarray(jax.jit(lambda c, k: jpacker.pack(
        jpar, jctx, c, k, trunc=trunc))(jnp.asarray(cts), jk))
    got = tpacker.pack(tpar, tctx, _t(cts), tk, trunc=trunc)
    assert np.array_equal(got.numpy(), want)
    want = np.asarray(jax.jit(lambda c, k: jks.trace(
        jpar, jctx, c, k, trunc=trunc))(jnp.asarray(want), jk))
    assert np.array_equal(tks.trace(tpar, tctx, got, tk, trunc=trunc).numpy(), want)


def test_fold_sign_and_base_against_composed_pieces():
    """fused_external_fold's plain version: out = normalize(base + sign *
    fold) against the fold assembled from the ops layer."""
    from fhe_ram_tpu_torch.ops import limb as tlimb
    from fhe_ram_tpu_torch.ops.crt import crt_fold
    from fhe_ram_tpu_torch.ops.ntt import ntt_fwd, ntt_inv

    rnd = np.random.default_rng(8)
    n, B, T, C2, Lk, Lout = 64, 2, 4, 2, 3, 3
    tctx = tget_ctx(n, TWIDE.primes)
    x = _t(rnd.integers(-(1 << 18), 1 << 18, size=(B, T, n)).astype(np.int32))
    kc = _t(rnd.integers(-(1 << 16), 1 << 16, size=(T, C2 * Lk, n)).astype(np.int32))
    base = _t(rnd.integers(-(1 << 17), 1 << 17, size=(B, C2, Lout, n)).astype(np.int32))
    keys = ntt_fwd(tctx, kc)[:, None]
    spec = ntt_fwd(tctx, x).to(torch.int64)
    acc = (spec[:, :, :, None, :] * keys[:, 0][:, None].to(torch.int64)).sum(2)
    conv = ntt_inv(tctx, torch.remainder(acc, tctx.consts(4)).to(torch.int32))
    fold = crt_fold(tctx.primes, conv.reshape(3, B, C2, Lk, n), 17, Lout)
    for sign in (1, -1):
        got = ntt_cuda.fused_external_fold(tctx, x, keys, Lout, C2, base=base,
                                           sign=sign)
        assert torch.equal(got, tlimb.normalize(base + sign * fold))
    assert torch.equal(ntt_cuda.fused_external_fold(tctx, x, keys, Lout, C2),
                       tlimb.normalize(fold))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    tctx = tget_ctx(64, TWIDE.primes)
    x = torch.zeros((1, 4, 64), dtype=torch.int32)
    keys = torch.zeros((3, 2, 4, 6, 64), dtype=torch.int32)
    with pytest.raises(ValueError):  # chained digits need T == c2*out_limbs
        ntt_cuda.fused_external_fold(tctx, x, keys, 3, 2)
    with pytest.raises(ValueError):  # shape mismatch
        ntt_cuda.fused_external_fold(tctx, x[:, :3], keys[:, :1], 3, 2)
    ct = torch.zeros((1, 2, 3, 64), dtype=torch.int32)
    with pytest.raises(ValueError):  # more steps than keys
        ntt_cuda.fused_trace(tctx, ct, keys[:, 0][None, :, :2], (3, 5))
