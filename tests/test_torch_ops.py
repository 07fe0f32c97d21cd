"""The PyTorch port's ops layer held against the JAX package and against
Python bignums, on the CPU.  All arithmetic is exact integer arithmetic,
so every comparison is np.array_equal (tolerance 0)."""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import fhe_ram_tpu.params as jparams
from fhe_ram_tpu.ops import crt as jcrt
from fhe_ram_tpu.ops import limb as jlimb
from fhe_ram_tpu.ops import ntt as jntt
from fhe_ram_tpu.ops import poly as jpoly
from fhe_ram_tpu.ops.modular import to_canonical as jto_canonical

import fhe_ram_tpu_torch.params as tparams
from fhe_ram_tpu_torch.ops import crt as tcrt
from fhe_ram_tpu_torch.ops import limb as tlimb
from fhe_ram_tpu_torch.ops import ntt as tntt
from fhe_ram_tpu_torch.ops import poly as tpoly

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


PRIMES = tparams.DEFAULT_PRIMES
PRESETS = sorted(k for k in dir(jparams) if k.startswith("PARAMS_"))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("name", PRESETS)
def test_params_presets_equal(name):
    a, b = getattr(jparams, name), getattr(tparams, name)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.base2d().rows[0].bases == b.base2d().rows[0].bases
    assert a.trace_gal_els == b.trace_gal_els and a.tree_shape() == b.tree_shape()


def test_params_cover_every_reference_preset():
    assert PRESETS == sorted(k for k in dir(tparams) if k.startswith("PARAMS_"))
    assert tparams.DEFAULT_PRIMES == jparams.DEFAULT_PRIMES


def _negacyclic_bignum(a, b):
    n = len(a)
    out = [0] * n
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            k = i + j
            if k < n:
                out[k] += int(ai) * int(bj)
            else:
                out[k - n] -= int(ai) * int(bj)
    return out


@pytest.mark.parametrize("n", [64, 4096])
def test_ntt_round_trip_and_range(n):
    rnd = np.random.default_rng(n)
    ctx = tntt.get_ntt_context(n, PRIMES)
    x = rnd.integers(-(1 << 21), 1 << 21, size=(2, n)).astype(np.int32)
    spec = tntt.ntt_fwd(ctx, _t(x))
    assert spec.shape == (3, 2, n) and spec.dtype == torch.int32
    for pi, p in enumerate(PRIMES):
        assert int(spec[pi].min()) >= 0 and int(spec[pi].max()) < p
    back = tntt.ntt_inv(ctx, spec).numpy()
    for pi, p in enumerate(PRIMES):
        want = np.mod(x.astype(np.int64), p)
        want = np.where(want > p // 2, want - p, want)
        assert np.array_equal(back[pi], want)


def test_ntt_convolution_matches_bignums_n64():
    n = 64
    rnd = np.random.default_rng(3)
    ctx = tntt.get_ntt_context(n, PRIMES)
    a = rnd.integers(-(1 << 16), 1 << 16, size=n).astype(np.int32)
    b = rnd.integers(-(1 << 16), 1 << 16, size=n).astype(np.int32)
    sa = tntt.ntt_fwd(ctx, _t(a)).to(torch.int64)
    sb = tntt.ntt_fwd(ctx, _t(b)).to(torch.int64)
    p = ctx.consts(2)
    conv = tntt.ntt_inv(ctx, torch.remainder(sa * sb, p).to(torch.int32)).numpy()
    want = _negacyclic_bignum(a, b)
    for pi, q in enumerate(PRIMES):
        w = np.array([v % q for v in want], dtype=np.int64)
        w = np.where(w > q // 2, w - q, w)
        assert np.array_equal(conv[pi], w)


def test_ntt_convolution_matches_jax_n4096():
    """Per-prime convolution residues are in coefficient order, so they
    can be compared across the two packages (after to_canonical); the
    spectra cannot."""
    n = 4096
    rnd = np.random.default_rng(5)
    a = rnd.integers(-(1 << 16), 1 << 16, size=n).astype(np.int32)
    b = rnd.integers(-(1 << 16), 1 << 16, size=n).astype(np.int32)
    tctx = tntt.get_ntt_context(n, PRIMES)
    sa = tntt.ntt_fwd(tctx, _t(a)).to(torch.int64)
    sb = tntt.ntt_fwd(tctx, _t(b)).to(torch.int64)
    got = tntt.ntt_inv(
        tctx, torch.remainder(sa * sb, tctx.consts(2)).to(torch.int32)).numpy()

    from fhe_ram_tpu.ops.modular import mul_mod
    jctx = jntt.get_ntt_context(n, PRIMES)
    pj, ipj = jctx.consts(2)
    conv = _jit(lambda u, v: jto_canonical(jntt.ntt_inv(jctx, mul_mod(
        jntt.ntt_fwd(jctx, u), jntt.ntt_fwd(jctx, v), pj, ipj)), pj))
    want = np.asarray(conv(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(got, want)


def _edge_integers(rnd, count):
    """Integers that sit on the balanced base-2^9 digit-drop edges: sums
    of +-256 / 255 digits at every position, plus random ones."""
    vals = []
    for k in range(6):
        for d in (-256, 255, 256, -257, 1, -1):
            vals.append(d * (1 << (9 * k)))
            vals.append(d * (1 << (9 * k)) + 255 * ((1 << (9 * k)) - 1) // 511)
    vals += [int(v) for v in rnd.integers(-(1 << 47), 1 << 47, size=count - len(vals))]
    return vals[:count]


@pytest.mark.parametrize("lk,lout", [(4, 3), (3, 3), (3, 2), (5, 4), (2, 3)])
def test_crt_fold_matches_jax_and_bignums(lk, lout):
    n = 32
    rnd = np.random.default_rng(lk * 10 + lout)
    xs = np.array(_edge_integers(rnd, 2 * lk * n), dtype=object).reshape(2, lk, n)
    conv = np.zeros((3, 2, lk, n), dtype=np.int32)
    for pi, p in enumerate(PRIMES):
        r = np.vectorize(lambda v: ((v % p) + p // 2) % p - p // 2)(xs)
        conv[pi] = r.astype(np.int32)
    got = tcrt.crt_fold(PRIMES, _t(conv), 17, lout).numpy()

    jctx = jntt.get_ntt_context(n, PRIMES)
    pj, ipj = jctx.consts(4)
    want = np.asarray(_jit(lambda c: jcrt.crt_fold(PRIMES, c, 17, lout, pj, ipj))(
        jnp.asarray(conv)))
    assert np.array_equal(got, want)

    # against bignums: balanced 9-bit digits of x, whole digits below the
    # last output limb dropped per key limb
    ref = np.zeros((2, lout, n), dtype=np.int64)
    for b in range(2):
        for l in range(lk):
            for i in range(n):
                t = int(xs[b, l, i])
                for k in range(8):
                    d = ((t + 256) & 511) - 256
                    t = (t - d) >> 9
                    e = 9 * k - 17 * (l + 1)
                    if e >= 0:
                        continue
                    tl = (-e - 1) // 17
                    if tl < lout:
                        ref[b, tl, i] += d << (e + 17 * (tl + 1))
    assert np.array_equal(got.astype(np.int64), ref)


def test_garner_reconstructs_bignums():
    rnd = np.random.default_rng(8)
    xs = [int(v) for v in rnd.integers(-(1 << 56), 1 << 56, size=256)]
    r = np.array([[x % p for x in xs] for p in PRIMES], dtype=np.int32)
    v1, v2, v3 = tcrt.garner_digits(PRIMES, _t(r))
    p1, p2, _ = PRIMES
    got = [int(a) + p1 * int(b) + p1 * p2 * int(c) for a, b, c in zip(v1, v2, v3)]
    assert got == xs
    digs = tcrt.int_digits9(PRIMES, v1, v2, v3)
    assert [sum(int(d[i]) << (9 * k) for k, d in enumerate(digs))
            for i in range(len(xs))] == xs
    assert all(int(d.min()) >= -256 and int(d.max()) <= 255 for d in digs)


def _limbs(rnd, shape, bits):
    return rnd.integers(-(1 << bits), 1 << bits, size=shape).astype(np.int32)


@pytest.mark.parametrize("bits", [16, 24, 29])
def test_normalize_matches_jax(bits):
    x = _limbs(np.random.default_rng(bits), (3, 2, 4, 64), bits)
    got = tlimb.normalize(_t(x)).numpy()
    assert np.array_equal(got, np.asarray(jlimb.normalize(jnp.asarray(x))))
    assert got.min() >= -(1 << 16) and got.max() < (1 << 16)


@pytest.mark.parametrize("shift", [1, 6, 12, 16])
def test_shift_right_matches_jax(shift):
    x = _limbs(np.random.default_rng(shift), (2, 2, 3, 64), 16)
    assert (x < 0).any()
    got = tlimb.shift_right(_t(x), shift).numpy()
    assert np.array_equal(got, np.asarray(jlimb.shift_right(jnp.asarray(x), shift)))


@pytest.mark.parametrize("new_l", [2, 3, 5])
def test_resize_limbs_matches_jax(new_l):
    x = _limbs(np.random.default_rng(1), (2, 3, 64), 16)
    got = tlimb.resize_limbs(_t(x), new_l).numpy()
    assert np.array_equal(got, np.asarray(jlimb.resize_limbs(jnp.asarray(x), new_l)))


@pytest.mark.parametrize("k", [0, 1, 17, 63, 64, 65, 100, 127, -1, -40])
def test_rotate_matches_jax(k):
    x = _limbs(np.random.default_rng(abs(k)), (2, 3, 64), 16)
    assert np.array_equal(tpoly.rotate(_t(x), k).numpy(),
                          np.asarray(jpoly.rotate(jnp.asarray(x), k)))


@pytest.mark.parametrize("g", [3, 5, 33, 65, 127, -1, 2 * 64 + 3])
def test_automorphism_matches_jax_and_index_formula(g):
    n = 64
    x = _limbs(np.random.default_rng(abs(g)), (2, 3, n), 16)
    got = tpoly.automorphism(_t(x), g).numpy()
    assert np.array_equal(got, np.asarray(jpoly.automorphism(jnp.asarray(x), g)))
    # the index arithmetic the CUDA kernels use in place of a table
    ginv = tpoly.auto_inverse(n, g)
    j = np.arange(n)
    i0 = (ginv * j) % (2 * n)
    want = np.where(i0 < n, 1, -1) * x[..., i0 % n]
    assert np.array_equal(got, want)


def test_decode_helpers_match_jax():
    x = _limbs(np.random.default_rng(2), (3, 64), 16)
    assert tlimb.decode_coeff(x, 9, index=5) == jlimb.decode_coeff(x, 9, index=5)
    assert np.array_equal(tlimb.torus_float(x), jlimb.torus_float(x))
