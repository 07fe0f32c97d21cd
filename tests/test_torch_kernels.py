"""The plain PyTorch version of each of the read path's four CUDA kernels
held against the JAX package's function on the same inputs, on the CPU
(the write cycle's and the batched read's kernels: tests/test_torch_write.py
and tests/test_torch_batch.py).

The JAX side runs its composed path (the `butterfly` backend, which is
the Pallas kernels' own plain reference); the port runs on CPU tensors,
where each wrapper takes its kernel's plain version.  Keys are small
random polynomials prepared by each side's own `prepare`: spectra are
never compared, coefficient-domain outputs are, bit for bit
(np.array_equal, tolerance 0 -- all of it is integer arithmetic)."""

import functools
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

# The JAX reference is compiled without XLA's optimisation passes and in one
# piece: the integers are the same, these sizes run in no time either way,
# and the compile takes a third less CPU time (the suite's workers share
# their cores, so CPU time is what the whole run pays for).
_jit = functools.partial(jax.jit, compiler_options={
    "xla_backend_optimization_level": 0,
    "xla_cpu_parallel_codegen_split_count": 1})


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
    """(the JAX side's keys, still to be prepared by `_jprep` inside the
    test's jitted function, so that a test compiles one JAX function; the
    port's prepared keys)."""
    return ({g: jnp.asarray(k) for g, k in atk.items()},
            {g: tks.key_prepare(tctx, _t(k)) for g, k in atk.items()})


def _jprep(jctx, ks):
    return {g: jks.key_prepare(jctx, k) for g, k in ks.items()}


_ALL_CASES = {}


def _jax_at_every_case(name, inputs, jax_fn):
    """A parametrised test's JAX outputs at every CASES entry, from ONE
    jitted function (one compile instead of one a case), computed once a
    module.  inputs(case) -> the case's arrays (numpy, in jax_fn's order);
    jax_fn(jpar, jctx, *arrays) -> the JAX output."""
    if name not in _ALL_CASES:
        # the contexts are made (and cached) outside the trace
        ctxs = {case: _both_ctx(CASES[case][0])[0] for case in CASES}

        def every(args):
            return {case: jax_fn(CASES[case][0], ctxs[case], *a)
                    for case, a in args.items()}

        args = {case: tuple(jnp.asarray(x) for x in inputs(case)) for case in CASES}
        _ALL_CASES[name] = {case: np.asarray(out)
                            for case, out in _jit(every)(args).items()}
    return _ALL_CASES[name]


def _external_product_inputs(case):
    jpar, _, B = CASES[case]
    rnd = np.random.default_rng(1)
    C = jpar.rank + 1
    gg = rnd.integers(-(1 << 16), 1 << 16, size=(
        jpar.dnum_ct, C, C, jpar.limbs_ggsw, jpar.n)).astype(np.int32)
    return _ct(rnd, jpar, (B,)), gg


def _external_product_jax(jpar, jctx, c, k):
    D, Lg = jpar.read_ep_trunc
    return jggsw.external_product(jpar, jctx, c,
                                  jggsw.prepare(jctx, k)[:, :D][..., :Lg, :])


@pytest.mark.parametrize("case", list(CASES))
def test_external_product_matches_jax(case):
    jpar, tpar, B = CASES[case]
    _, tctx = _both_ctx(jpar)
    ct, gg = _external_product_inputs(case)
    D, Lg = jpar.read_ep_trunc
    tg = tggsw.prepare(tctx, _t(gg))[:, :D][..., :Lg, :]
    want = _jax_at_every_case("external_product", _external_product_inputs,
                              _external_product_jax)[case]
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
    want = np.asarray(_jit(lambda c, k: jggsw.external_product(
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
    want = np.asarray(_jit(lambda c, k: jaddress.coordinate_product(
        jpar, jctx, c, jggsw.prepare(jctx, k)))(
            jnp.asarray(ct), jnp.asarray(coord)))
    got = taddress.coordinate_product(
        tpar, tctx, _t(ct), tggsw.prepare(tctx, _t(coord))).numpy()
    assert np.array_equal(got, want)


def _keyswitch_inputs(case):
    jpar, _, B = CASES[case]
    rnd = np.random.default_rng(4)
    key = _atk(rnd, jpar, (3,))[3]
    return _ct(rnd, jpar, (B,)), key, _ct(rnd, jpar, (B,), bits=17)


def _keyswitch_jax(jpar, jctx, c, k, b):
    D, Lk = jpar.read_ks_trunc
    return jks.keyswitch(jpar, jctx, c, jks.key_prepare(jctx, k), base_add=b,
                         in_digits=D, key_limbs=Lk)


@pytest.mark.parametrize("case", list(CASES))
def test_keyswitch_with_base_add_matches_jax(case):
    jpar, tpar, B = CASES[case]
    _, tctx = _both_ctx(jpar)
    ct, key, base = _keyswitch_inputs(case)
    D, Lk = jpar.read_ks_trunc
    want = _jax_at_every_case("keyswitch", _keyswitch_inputs, _keyswitch_jax)[case]
    got = tks.keyswitch(tpar, tctx, _t(ct), tks.key_prepare(tctx, _t(key)),
                        base_add=_t(base), in_digits=D, key_limbs=Lk).numpy()
    assert np.array_equal(got, want)


def _merge_level_inputs(case):
    jpar, _, B = CASES[case]
    rnd = np.random.default_rng(5)
    g = (jpar.n >> 3) + 1
    key = _atk(rnd, jpar, (g,))[g]
    return (_ct(rnd, jpar, (B,), bits=17), _ct(rnd, jpar, (B,), bits=17), key)


def _merge_level_jax(jpar, jctx, a, b, k):
    t, g = 1 << 3, (jpar.n >> 3) + 1
    return jpacker._merge_level(jpar, jctx, a, b, t, g, jks.key_prepare(jctx, k),
                                trunc=jpar.read_ks_trunc)


@pytest.mark.parametrize("case", list(CASES))
def test_merge_level_matches_jax(case):
    """Unnormalized inputs up to 2^17, as the first merge level gets them
    from the pre-shift (u, v reach 2^18); level 3: t = 8."""
    jpar, tpar, B = CASES[case]
    _, tctx = _both_ctx(jpar)
    A, Bc, key = _merge_level_inputs(case)
    t, g = 1 << 3, (jpar.n >> 3) + 1
    want = _jax_at_every_case("merge_level", _merge_level_inputs,
                              _merge_level_jax)[case]
    got = tpacker._merge_level(tpar, tctx, _t(A), _t(Bc), t, g,
                               tks.key_prepare(tctx, _t(key)),
                               trunc=jpar.read_ks_trunc).numpy()
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
    want = np.asarray(_jit(lambda c, k: jks.trace_steps(
        jpar, jctx, c, _jprep(jctx, k), gals, trunc=trunc))(
            jnp.asarray(ct), jk))
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

    def pack_then_trace(c, k):   # one compile: the two share the keys
        kp = _jprep(jctx, k)
        packed = jpacker.pack(jpar, jctx, c, kp, trunc=trunc)
        return packed, jks.trace(jpar, jctx, packed, kp, trunc=trunc)

    want_pack, want_trace = (np.asarray(a) for a in _jit(pack_then_trace)(
        jnp.asarray(cts), jk))
    got = tpacker.pack(tpar, tctx, _t(cts), tk, trunc=trunc)
    assert np.array_equal(got.numpy(), want_pack)
    assert np.array_equal(tks.trace(tpar, tctx, got, tk, trunc=trunc).numpy(),
                          want_trace)


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
    with pytest.raises(ValueError):  # spectra need the prime axis
        ntt_cuda.fused_external_fold(tctx, x, keys[:, :1], 3, 2, x_is_ntt=True)
    ct = torch.zeros((1, 2, 3, 64), dtype=torch.int32)
    with pytest.raises(ValueError):  # more steps than keys
        ntt_cuda.fused_trace(tctx, ct, keys[:, 0][None, :, :2], (3, 5))

    # the batched fold: x [A, B, T, N] or shared spectra [P, B, T, N];
    # keys [A, P, digits, T, M, N]; base [A, B, c2, out_limbs, N]
    xb = torch.zeros((2, 1, 6, 64), dtype=torch.int32)
    kb = torch.zeros((2, 3, 2, 6, 6, 64), dtype=torch.int32)
    bb = torch.zeros((2, 1, 2, 3, 64), dtype=torch.int32)
    assert ntt_cuda.fused_external_fold_batched(tctx, xb, kb, 3, 2).shape == (2, 1, 2, 3, 64)
    with pytest.raises(ValueError):  # digits > 1 with a base
        ntt_cuda.fused_external_fold_batched(tctx, xb, kb, 3, 2, base=bb)
    with pytest.raises(ValueError):  # items of x and of keys differ
        ntt_cuda.fused_external_fold_batched(tctx, xb[:1], kb, 3, 2)
    with pytest.raises(ValueError):  # keys without the item axis
        ntt_cuda.fused_external_fold_batched(tctx, xb, kb[0], 3, 2)
    with pytest.raises(ValueError):  # shared spectra of the wrong prime count
        ntt_cuda.fused_external_fold_batched(tctx, xb, kb, 3, 2, x_is_ntt=True)
    with pytest.raises(ValueError):  # base of the wrong shape
        ntt_cuda.fused_external_fold_batched(tctx, xb, kb[:, :, :1], 3, 2,
                                             base=bb[:, :, :, :2])
    with pytest.raises(ValueError):  # keys on another device than x
        ntt_cuda.fused_external_fold_batched(tctx, xb, kb.to("meta"), 3, 2)
    with pytest.raises(ValueError):  # more output limbs than the kernels fold
        ntt_cuda.fused_external_fold_batched(tctx, xb, kb[:, :, :1], 9, 2)

    # the split: the full gadget only (T == rank * L), M a multiple of C2
    key = torch.zeros((3, 3, 8, 64), dtype=torch.int32)
    c0, c1 = ntt_cuda.fused_split(tctx, ct, 4, 17, key)
    assert c0.shape == c1.shape == ct.shape
    with pytest.raises(ValueError):  # a truncated key
        ntt_cuda.fused_split(tctx, ct, 4, 17, key[:, :2])
    with pytest.raises(ValueError):
        ntt_cuda.fused_split(tctx, ct, 4, 17, key[:, :, :7])
    with pytest.raises(ValueError):  # another ring degree than the context's
        ntt_cuda.fused_split(tctx, ct[..., :32], 4, 17, key[..., :32])
    with pytest.raises(AssertionError):  # a residue class needs its residue
        tks.extract_slots(TWIDE, tctx, ct, 2, {}, dilate=2)
    with pytest.raises(AssertionError):  # the count a multiple of dilate
        tks.extract_slots(TWIDE, tctx, ct, 3, {}, dilate=2, residue=0)


# ---------------------------------------------------------------------------
# kernel 12 and the JAX package's FHERAM_MXU=0 bodies
# ---------------------------------------------------------------------------

PRIMES = JFULL.primes


def test_fused_external_matches_jax_interpret():
    """Kernel 12's plain version (any transform body: the spectra are the
    same) against the JAX package's fused_external_pallas in interpret mode
    at B=2, T=3, M=2: each side prepares the keys with its own transform;
    the residues are compared centered (the JAX kernel's are lazily
    balanced until to_canonical)."""
    from fhe_ram_tpu.ops.modular import to_canonical
    from fhe_ram_tpu.ops.ntt_pallas import (fused_external_pallas,
                                            get_pallas_context, ntt_fwd_pallas)

    rnd = np.random.default_rng(12)
    B, T, M, n = 2, 3, 2, 4096
    x = rnd.integers(-(1 << 16), 1 << 16, size=(B, T, n)).astype(np.int32)
    kc = rnd.integers(-(1 << 16), 1 << 16, size=(T, M, n)).astype(np.int32)
    pctx = get_pallas_context(n, PRIMES)
    p = jnp.asarray(PRIMES, jnp.int32).reshape(-1, 1, 1, 1)
    want = np.asarray(_jit(lambda x_, k_: to_canonical(fused_external_pallas(
        pctx, x_, ntt_fwd_pallas(pctx, k_, interpret=True), interpret=True), p))(
            jnp.asarray(x), jnp.asarray(kc)))
    for body in ("radix2", "two_pass"):
        tctx = tget_ctx(n, PRIMES, body)
        got = ntt_cuda.fused_external(tctx, _t(x), ntt_cuda.ntt_fwd_cuda(tctx, _t(kc)))
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want), body
    with pytest.raises(ValueError):  # T of the digits and of the keys differ
        ntt_cuda.fused_external(tctx, _t(x[:, :2]), torch.zeros((3, T, M, n), dtype=torch.int32))


# The JAX package fixes its transform body when ntt_pallas is imported
# (FHERAM_MXU), so its MXU=0 bodies run in a process of their own: kernel 1's
# round trip and a convolution, kernel 12 and kernel 2 (B=1, T=2, M=2), all
# in interpret mode under one jit, the residues made centered.
_MXU0_SCRIPT = """
import functools, sys
import numpy as np
import jax
import jax.numpy as jnp
from fhe_ram_tpu.ops import ntt_pallas as npl
from fhe_ram_tpu.ops.modular import mul_mod, prime_consts, reduce_once, to_canonical

assert not npl._USE_MXU
inp = dict(np.load(sys.argv[1]))
primes = tuple(int(q) for q in inp.pop("primes"))
pctx = npl.get_pallas_context(4096, primes)

def canon(a):
    return to_canonical(a, jnp.asarray(primes, jnp.int32).reshape((-1,) + (1,) * (a.ndim - 1)))

def run(a, b, x, keys):
    fa = npl.ntt_fwd_pallas(pctx, a, interpret=True)
    fb = npl.ntt_fwd_pallas(pctx, b, interpret=True)
    p, ip = prime_consts(primes, 3)
    k = npl.ntt_fwd_pallas(pctx, keys, interpret=True)
    return dict(
        round_trip=canon(npl.ntt_inv_pallas(pctx, fa, interpret=True)),
        conv=canon(npl.ntt_inv_pallas(pctx, reduce_once(mul_mod(fa, fb, p, ip), p, ip),
                                      interpret=True)),
        external=canon(npl.fused_external_pallas(pctx, x, k, interpret=True)),
        fold=npl.fused_external_fold_pallas(pctx, x[:1, :2], k[:, None, :2, :2], 2, 2,
                                            interpret=True))

jit = functools.partial(jax.jit, compiler_options={
    "xla_backend_optimization_level": 0, "xla_cpu_parallel_codegen_split_count": 1})
out = jit(run)(**{k: jnp.asarray(v) for k, v in inp.items()})
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


def test_plain_versions_match_the_jax_mxu0_bodies(tmp_path):
    """Kernels 1, 12 and 2 of the JAX package with their FHERAM_MXU=0 bodies
    (the two-pass 64 x 64 form the port's two-pass body stands for) against
    the port's plain versions under a two-pass context, bit for bit after
    to_canonical: the round trip and the convolution residues of kernel 1,
    kernel 12's residues, kernel 2's normalized limbs."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from fhe_ram_tpu_torch.ops.ntt import ntt_fwd_plain, ntt_inv_plain

    rnd = np.random.default_rng(6)
    n = 4096
    inp = dict(a=rnd.integers(-(1 << 20), 1 << 20, size=(2, n)),
               b=rnd.integers(-(1 << 20), 1 << 20, size=(2, n)),
               x=rnd.integers(-(1 << 16), 1 << 16, size=(2, 3, n)),
               keys=rnd.integers(-(1 << 16), 1 << 16, size=(3, 2, n)))
    inp = {k: v.astype(np.int32) for k, v in inp.items()}
    np.savez(tmp_path / "in.npz", primes=np.asarray(PRIMES), **inp)
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, FHERAM_MXU="0", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(filter(None, [str(root),
                                                        os.environ.get("PYTHONPATH")])))
    subprocess.run([sys.executable, "-c", _MXU0_SCRIPT, str(tmp_path / "in.npz"),
                    str(tmp_path / "out.npz")], check=True, cwd=root, env=env,
                   timeout=300)
    want = np.load(tmp_path / "out.npz")

    tctx = tget_ctx(n, PRIMES, "two_pass")
    fa, fb = ntt_fwd_plain(tctx, _t(inp["a"])), ntt_fwd_plain(tctx, _t(inp["b"]))
    p = torch.tensor(PRIMES, dtype=torch.int64).reshape(-1, 1, 1)
    keys = ntt_fwd_plain(tctx, _t(inp["keys"]))
    got = dict(
        round_trip=ntt_inv_plain(tctx, fa),
        conv=ntt_inv_plain(tctx, (fa.to(torch.int64) * fb.to(torch.int64) % p).to(torch.int32)),
        external=ntt_cuda.fused_external(tctx, _t(inp["x"]), keys),
        fold=ntt_cuda.fused_external_fold(tctx, _t(inp["x"][:1, :2]),
                                          keys[:, None, :2, :2].contiguous(), 2, 2))
    for k, v in got.items():
        assert v.dtype == torch.int32 and np.array_equal(v.numpy(), want[k]), k
