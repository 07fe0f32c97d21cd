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
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

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
    "xla_backend_optimization_level": 0, "xla_cpu_parallel_codegen_split_count": 1,
    "xla_cpu_use_fusion_emitters": False})
out = jit(run)(**{k: jnp.asarray(v) for k, v in inp.items()})
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


@pytest.fixture(scope="module", autouse=True)
def mxu0_refs(tmp_path_factory):
    """The inputs of test_plain_versions_match_the_jax_mxu0_bodies and the
    process that computes their JAX references (_MXU0_SCRIPT), started with
    the module's first test so that it runs beside the others; the test
    waits for it."""
    rnd = np.random.default_rng(6)
    n = 4096
    inp = dict(a=rnd.integers(-(1 << 20), 1 << 20, size=(2, n)),
               b=rnd.integers(-(1 << 20), 1 << 20, size=(2, n)),
               x=rnd.integers(-(1 << 16), 1 << 16, size=(2, 3, n)),
               keys=rnd.integers(-(1 << 16), 1 << 16, size=(3, 2, n)))
    inp = {k: v.astype(np.int32) for k, v in inp.items()}
    tmp = tmp_path_factory.mktemp("mxu0")
    np.savez(tmp / "in.npz", primes=np.asarray(PRIMES), **inp)
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, FHERAM_MXU="0", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(filter(None, [str(root),
                                                        os.environ.get("PYTHONPATH")])))
    proc = subprocess.Popen([sys.executable, "-c", _MXU0_SCRIPT, str(tmp / "in.npz"),
                             str(tmp / "out.npz")], cwd=root, env=env)
    yield inp, proc, tmp / "out.npz"
    if proc.poll() is None:
        proc.kill()
    proc.wait()


def test_plain_versions_match_the_jax_mxu0_bodies(mxu0_refs):
    """Kernels 1, 12 and 2 of the JAX package with their FHERAM_MXU=0 bodies
    (the two-pass 64 x 64 form the port's two-pass body stands for) against
    the port's plain versions under a two-pass context, bit for bit after
    to_canonical: the round trip and the convolution residues of kernel 1,
    kernel 12's residues, kernel 2's normalized limbs."""
    from fhe_ram_tpu_torch.ops.ntt import ntt_fwd_plain, ntt_inv_plain

    inp, proc, out = mxu0_refs
    n = 4096
    assert proc.wait(timeout=300) == 0
    want = np.load(out)

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


# ---------------------------------------------------------------------------
# csrc/fold.cu (kernels 2 and 5): its index arithmetic and constants
# ---------------------------------------------------------------------------
# The fold kernel runs only on the card, so its data movement is emulated
# here in int64 exactly as csrc/fold.cu writes it: which coefficient thread
# t holds in register r in each layout, the swizzled exchange-buffer words,
# the table word of every butterfly's twiddle, the Shoup products with
# 32-bit wrap-around, the lazy ranges, the Garner step.  Names follow the
# CUDA source.

_FOLD_THREADS, _FOLD_N, _M32 = 256, 4096, (1 << 32) - 1


def _lay_t(L, t):
    return t if L == 0 else (t & 15) | ((t >> 4) << 8) if L == 1 else t << 4


def _lay_r(L, r):
    return r << 8 if L == 0 else r << 4 if L == 1 else r


def _lay(L, t, r):
    return _lay_t(L, t) | _lay_r(L, r)


def _swz(i):
    return i ^ ((i >> 5) & 15) ^ ((i >> 4) & 16)


def _umulhi(x, y):
    """__umulhi of uint32 tensors (int64, < 2^32), exact in int64."""
    return (((x >> 16) * y) + (((x & 0xFFFF) * y) >> 16)) >> 16


class _FoldEmu:
    """csrc/fold.cu's per-block arithmetic for the three primes at once:
    values int64[P, 256 threads, 16 registers], uint32 semantics."""

    def __init__(self, ctx):
        self.tab, self.off = ctx.shoup_tables("cpu")
        self.tab = self.tab.to(torch.int64) & _M32
        self.p = torch.tensor(ctx.primes, dtype=torch.int64).reshape(3, 1, 1)
        self.t = torch.arange(_FOLD_THREADS).reshape(1, -1, 1)
        self.r = torch.arange(16).reshape(1, 1, -1)

    def pair(self, name, size, idx):
        """Shoup pair (w, w') of table `name` at idx (int64[P or 1, ...])."""
        pi = torch.arange(3).reshape((3,) + (1,) * (idx.dim() - 1))
        word = self.off[name] + 2 * (pi * size + idx)
        return self.tab[word], self.tab[word + 1]

    def shoup(self, x, w):
        assert bool((x >= 0).all() and (x <= _M32).all())
        out = (x * w[0] - _umulhi(x, w[1]) * self.p) & _M32
        assert bool((out < 2 * self.p).all()), "Shoup product outside [0, 2p)"
        return out

    def dif16(self, v, mul):
        """fold.cu dif16: mul(x, s, rl) multiplies by the pair's twiddle."""
        p2 = 2 * self.p[..., 0]
        for s in range(4):
            hb = 8 >> s
            for r in (r for r in range(16) if not r & hb):
                a, b = v[..., r].clone(), v[..., r + hb].clone()
                assert bool((a < p2).all() and (b < p2).all()), "DIF input outside [0, 2p)"
                s_ = (a + b) & _M32
                v[..., r] = torch.minimum(s_, (s_ - p2) & _M32)
                v[..., r + hb] = mul((a - b + p2) & _M32, s, r & (hb - 1))
        return v

    def dit16(self, v, mul):
        p2 = 2 * self.p[..., 0]
        for s in range(4):
            hb = 1 << s
            for r in (r for r in range(16) if not r & hb):
                assert bool((v[..., r] < 2 * p2).all() and (v[..., r + hb] < 2 * p2).all())
                a = torch.minimum(v[..., r], (v[..., r] - p2) & _M32)   # a copy
                b = mul(v[..., r + hb].clone(), s, r & (hb - 1))
                v[..., r] = (a + b) & _M32
                v[..., r + hb] = (a - b + p2) & _M32
        return v

    def mul(self, x, pair):
        """shoup() of a [P, 256] operand and a pair of [P or 1, 256 or 1]."""
        return self.shoup(x[..., None], tuple(w[..., None] for w in pair))[..., 0]

    def lazy(self, x, m):
        out = torch.minimum(x, (x - m) & _M32)
        assert bool((out < m).all())
        return out

    def exchange(self, v, la, lb):
        buf = torch.full((3, _FOLD_N), -1, dtype=torch.int64)
        buf[:, _swz(_lay(la, self.t, self.r)).reshape(-1)] = v.reshape(3, -1)
        assert bool((buf >= 0).all()), "an exchange left a word unwritten"
        return buf[:, _swz(_lay(lb, self.t, self.r)).reshape(-1)].reshape(v.shape), buf

    def forward(self, x):
        """fold.cu forward(): int32 digit poly x[N] -> spectrum in layout L2."""
        t, r, p = self.t[..., 0], self.r[0, 0], self.p[..., 0]
        lift = ((0x80000000 + p - 1) // p) * p
        xv = x[_lay(0, self.t, self.r)].to(torch.int64).expand(3, -1, -1)
        u = torch.where(xv < 0, (xv + (1 << 32) + lift[..., None]) & _M32, xv)
        v = self.shoup(self.shoup(u, self.pair("psi_hi", 16, r.reshape(1, 1, -1))),
                       self.pair("psi_lo", 256, self.t.expand(1, -1, 1)))
        own0 = [self.pair("fwd", 4096, 4096 - (4096 >> s) + t) for s in range(4)]
        const = lambda tab, at: self.pair(tab, 4096, torch.full((1, 1), at))  # noqa: E731

        def pass0(x_, s, rl):
            if rl:
                x_ = self.mul(x_, const("fwd", 4096 - (4096 >> s) + (rl << 8)))
            return self.mul(x_, own0[s])
        v = self.dif16(v, pass0)
        v, _ = self.exchange(v, 0, 1)
        j0 = t & 15
        v = self.dif16(v, lambda x_, s, rl: self.mul(
            x_, self.pair("fwd", 4096, 4096 - (256 >> s) + (j0 | (rl << 4)))))
        v, _ = self.exchange(v, 1, 2)
        return self.dif16(v, lambda x_, s, rl: self.mul(
            x_, const("fwd", 4096 - (16 >> s) + rl)) if rl else self.lazy(x_, 2 * p))

    def inverse(self, v):
        """fold.cu inverse(): layout L2 in [0, 4p) -> canonical residues in
        natural order (read from the swizzled words, as the Garner does)."""
        t, p = self.t[..., 0], self.p[..., 0]
        const = lambda at: self.pair("inv", 4096, torch.full((1, 1), at))  # noqa: E731
        v = self.dit16(v, lambda x_, s, rl: self.mul(x_, const((1 << s) - 1 + rl))
                       if rl else self.lazy(x_, 2 * p))
        v, _ = self.exchange(v, 2, 1)
        j0 = t & 15
        v = self.dit16(v, lambda x_, s, rl: self.mul(
            x_, self.pair("inv", 4096, (16 << s) - 1 + (j0 | (rl << 4)))))
        v, _ = self.exchange(v, 1, 0)
        own2 = [self.pair("inv", 4096, (256 << s) - 1 + t) for s in range(4)]

        def pass2(x_, s, rl):
            if rl:
                x_ = self.mul(x_, const((256 << s) - 1 + (rl << 8)))
            return self.mul(x_, own2[s])
        v = self.dit16(v, pass2)
        u = self.shoup(self.shoup(v, self.pair("ipsi_hi", 16, self.r[0, 0].reshape(1, 1, -1))),
                       self.pair("ipsi_lo", 256, self.t.expand(1, -1, 1)))
        u = self.lazy(u, self.p)
        y = torch.empty((3, _FOLD_N), dtype=torch.int64)
        y[:, _swz(_lay(0, self.t, self.r)).reshape(-1)] = u.reshape(3, -1)
        return y[:, _swz(torch.arange(_FOLD_N))]           # the Garner's reads


    # csrc/pack_merge.cu's glue around this body (a, b: int64[N] polys of a
    # row pair; t_rot in [0, 2N); ginv = g^-1 mod 2N)

    @staticmethod
    def rot_at(poly, j, k):
        """fhe_core.cuh rot_at: (X^k poly)[j]."""
        kk = k & (_FOLD_N - 1)
        v = torch.where(j < kk, -poly[(_FOLD_N - kk + j) % _FOLD_N], poly[(j - kk) % _FOLD_N])
        return -v if k >= _FOLD_N else v

    @staticmethod
    def sigma_src(i, ginv):
        """fhe_core.cuh sigma_src: (source word, sign flip) of sigma_g at i."""
        i0 = (ginv * i) & (2 * _FOLD_N - 1)
        return i0 & (_FOLD_N - 1), i0 >= _FOLD_N

    def merge_digit(self, a, b, t_rot, ginv):
        """A digit poly as forward() loads it: v = a - X^t b staged by
        thread t at words t + 256 r (natural order), then read back at
        sigma_src(i) with sigma's sign for this thread's i = t + 256 r
        (layout L0).  Returns int64[256, 16] and the banks of those reads,
        [8 warps, 32 lanes, 16]."""
        j = _lay(0, self.t, self.r)[0]
        staged = torch.full((_FOLD_N,), 1 << 40, dtype=torch.int64)
        staged[j.reshape(-1)] = (a[j] - self.rot_at(b, j, t_rot)).reshape(-1)
        assert bool((staged < (1 << 40)).all()), "a staged word left unwritten"
        src, neg = self.sigma_src(j, ginv)
        v = staged[src]
        return torch.where(neg, -v, v), (src % 32).reshape(8, 32, 16)

    def merge_base(self, a, b, t_rot, ginv, b_comp):
        """MergeBase: a + X^t b at every coefficient, plus sigma_g(a - X^t b)
        gathered from the inputs at the b component."""
        i = torch.arange(_FOLD_N)
        u = a + self.rot_at(b, i, t_rot)
        if b_comp:
            src, neg = self.sigma_src(i, ginv)
            v = a[src] - self.rot_at(b, src, t_rot)
            u = u + torch.where(neg, -v, v)
        return u

def test_fold_kernel_index_arithmetic_matches_the_plain_transforms():
    """csrc/fold.cu emulated at N = 4096 for the three DEFAULT_PRIMES: two
    digit polys through the forward transform (int32 extremes included),
    their spectra against ntt_fwd_plain; the key products and the inverse
    against ntt_inv_plain; the Shoup Garner against the plain Garner digits;
    every Shoup quotient of the host tables against Python integers; every
    exchange and Garner read free of bank conflicts; all bit for bit."""
    from fhe_ram_tpu_torch.ops.crt import garner_consts, garner_digits
    from fhe_ram_tpu_torch.ops.ntt import ntt_fwd_plain, ntt_inv_plain
    from fhe_ram_tpu_torch.params import DEFAULT_PRIMES

    ctx = tget_ctx(_FOLD_N, DEFAULT_PRIMES)
    emu = _FoldEmu(ctx)
    primes = list(DEFAULT_PRIMES)

    # the host tables: each pair (w, floor(w 2^32 / p)) with the w the kernel
    # expects, checked with Python integers
    tab = emu.tab.tolist()
    for pi, p in enumerate(primes):
        psi = int(ctx.psi[pi, 1])
        ipsi, inv_n = pow(psi, p - 2, p), pow(_FOLD_N, p - 2, p)
        want = {"fwd": ctx.fwd_tw[pi].tolist(), "inv": ctx.inv_tw[pi].tolist(),
                "psi_lo": [pow(psi, j, p) for j in range(256)],
                "psi_hi": [pow(psi, 256 * r, p) for r in range(16)],
                "ipsi_lo": [pow(ipsi, j, p) * inv_n % p for j in range(256)],
                "ipsi_hi": [pow(ipsi, 256 * r, p) for r in range(16)]}
        for name, size in ctx.SHOUP_TABLES:
            at = emu.off[name] + 2 * pi * size
            got = tab[at: at + 2 * size]
            assert got[0::2] == want[name], name
            assert all(q == (w << 32) // p and w < p for w, q in zip(got[0::2], got[1::2])), name
    g = garner_consts(tuple(primes))
    got = tab[emu.off["garner"]: emu.off["garner"] + 6]
    assert got[0::2] == [g["c12"], g["p1_mod_p3"], g["c123"]]
    assert all(q == (w << 32) // p for w, q, p in zip(got[0::2], got[1::2], primes[1:] + primes[2:]))

    # the layouts are permutations of the coefficients, and the kernel's word
    # swz(lay_t) ^ swz(lay_r) is swz(lay); bank conflicts: in every layout
    # each warp's 32 lanes hit 32 banks for each register; the Garner's
    # warps read 32 aligned coefficients
    t, r = emu.t, emu.r
    for L in range(3):
        assert torch.equal(_lay(L, t, r).reshape(-1).sort().values, torch.arange(_FOLD_N))
        assert torch.equal(_swz(_lay_t(L, t)) ^ _swz(_lay_r(L, r)), _swz(_lay(L, t, r)))
        banks = (_swz(_lay(L, t, r)) % 32).reshape(8, 32, 16).sort(dim=1).values
        assert torch.equal(banks, torch.arange(32).reshape(1, 32, 1).expand(8, 32, 16)), L
    i_per = (_FOLD_N // 3 + 31) & ~31
    for pi in range(3):
        i = torch.arange(pi * i_per, min(_FOLD_N, (pi + 1) * i_per))
        assert i.numel() % 32 == 0
        banks = (_swz(i) % 32).reshape(-1, 32).sort(dim=1).values
        assert torch.equal(banks, torch.arange(32).expand_as(banks))

    # forward: digits of two polys, int32 extremes included
    rnd = np.random.default_rng(7)
    T = 2
    x = rnd.integers(-(1 << 31), 1 << 31, size=(T, _FOLD_N), dtype=np.int64)
    x[0, :4] = [-(1 << 31), (1 << 31) - 1, 0, -1]
    x[1] = rnd.integers(-(1 << 17), 1 << 17, size=_FOLD_N)
    x = torch.from_numpy(x.astype(np.int32))
    p3 = emu.p.reshape(3, 1)
    pos2 = _lay(2, t, r).reshape(-1)
    specs = []
    for tt in range(T):
        v = emu.forward(x[tt])
        spec = torch.empty((3, _FOLD_N), dtype=torch.int64)
        spec[:, pos2] = v.reshape(3, -1)
        assert torch.equal(spec % p3, ntt_fwd_plain(ctx, x[tt]).to(torch.int64))
        specs.append(v)

    # the key products (64-bit sums, one Barrett step) and the inverse
    keys = torch.from_numpy(np.stack([rnd.integers(0, q, size=(T, _FOLD_N)) for q in primes]))
    acc = sum(specs[tt] * keys[:, tt, pos2].reshape(3, _FOLD_THREADS, 16) for tt in range(T))
    mu = [(1 << 64) // q for q in primes]
    q64 = torch.tensor([[(a * mu[pi]) >> 64 for a in acc[pi].reshape(-1).tolist()]
                        for pi in range(3)]).reshape(acc.shape)
    v = (acc - q64 * emu.p) & _M32
    assert bool((v < 2 * emu.p).all())
    res = emu.inverse(v)
    prod = sum(ntt_fwd_plain(ctx, x[tt]).to(torch.int64) * keys[:, tt] for tt in range(T)) % p3
    want = ntt_inv_plain(ctx, prod.to(torch.int32)).to(torch.int64)
    assert torch.equal(torch.where(res > p3 // 2, res - p3, res), want)

    # the Garner step with Shoup pairs against the plain Garner digits
    p1, p2, p3_ = primes
    gp = [tuple(got[2 * k: 2 * k + 2]) for k in range(3)]
    m32 = _M32

    def shoup1(x_, w, q):
        return (x_ * w[0] - _umulhi(x_, w[1]) * q) & m32

    def center(u, q):
        return torch.where(u > q // 2, u - q, u)

    r1, r2, r3 = res
    v1 = center(r1, p1)
    u2 = shoup1((r2 + 2 * p2 - v1) & m32, gp[0], p2)
    v2 = center(torch.minimum(u2, (u2 - p2) & m32), p2)
    tt_ = shoup1(v2 + 2 * p3_, gp[1], p3_)
    u3 = shoup1((r3 + 4 * p3_ - v1 - tt_) & m32, gp[2], p3_)
    v3 = center(torch.minimum(u3, (u3 - p3_) & m32), p3_)
    w1, w2, w3 = garner_digits(primes, res)
    assert torch.equal(v1, w1) and torch.equal(v2, w2) and torch.equal(v3, w3)


def test_ntt_kernel_words_match_the_plain_transforms():
    """csrc/ntt.cu's loads and stores around the fold body's transforms,
    emulated at N = 4096 for the three DEFAULT_PRIMES: the forward loads
    its int32 poly in layout L0 (thread t the words t + 256 r: each warp
    128 consecutive bytes a register), stores its 16 canonical words of
    layout L2 at (t << 4) | r as four 16-byte units (every word once), and
    equals ntt_fwd_plain; the inverse loads the same words of residues in
    any int32 representative (negative, shifted by multiples of p, the
    int32 extremes), reduces them to [0, 2p) by a lift and a Shoup product
    by (1, mu40 >> 8) (= floor(2^32 / p)), and reads its swizzled buffer
    back in natural order (thread t the coefficients t + 256 k: 32 banks a
    warp), centered: equal to ntt_inv_plain; all bit for bit."""
    from fhe_ram_tpu_torch.ops.ntt import ntt_fwd_plain, ntt_inv_plain
    from fhe_ram_tpu_torch.params import DEFAULT_PRIMES

    ctx = tget_ctx(_FOLD_N, DEFAULT_PRIMES)
    emu = _FoldEmu(ctx)
    t, r, p = emu.t, emu.r, emu.p[..., 0]
    rnd = np.random.default_rng(5)
    x = rnd.integers(-(1 << 31), 1 << 31, size=_FOLD_N, dtype=np.int64)
    x[:4] = [-(1 << 31), (1 << 31) - 1, 0, -1]
    x = torch.from_numpy(x.astype(np.int32))

    # forward: the loads of layout L0 coalesced, the stores of layout L2
    load = _lay(0, t, r)[0]                                  # [256 threads, 16]
    assert torch.equal(load.transpose(0, 1).reshape(16, 8, 32),
                       torch.arange(_FOLD_N).reshape(16, 8, 32))
    store = (t[0] << 4) | r[0]                               # word of (t, r)
    units = store.reshape(_FOLD_THREADS, 4, 4)               # (t, k): words 16 t + 4 k + j
    assert torch.equal(units, (16 * t[0, :, :, None] + 4 * torch.arange(4).reshape(1, 4, 1)
                               + torch.arange(4)))
    assert torch.equal(store.reshape(-1).sort().values, torch.arange(_FOLD_N))
    spec = torch.empty((3, _FOLD_N), dtype=torch.int64)
    spec[:, store.reshape(-1)] = emu.lazy(emu.forward(x), emu.p).reshape(3, -1)
    assert torch.equal(spec, ntt_fwd_plain(ctx, x).to(torch.int64))

    # inverse: any representative in, the Shoup reduction by 1, centered out
    any_rep = spec + p * torch.from_numpy(rnd.integers(-2000, 2000, size=(3, _FOLD_N)))
    any_rep[:, :2] = torch.tensor([-(1 << 31), (1 << 31) - 1])
    any_rep = torch.where(any_rep >= 1 << 31, spec, torch.where(any_rep < -(1 << 31), spec,
                                                                    any_rep))
    mu40 = torch.tensor([(1 << 40) // q for q in DEFAULT_PRIMES]).reshape(3, 1, 1)
    one = (torch.ones_like(mu40), mu40 >> 8)
    assert torch.equal(one[1][:, 0, 0], torch.tensor([(1 << 32) // q for q in DEFAULT_PRIMES]))
    lift = ((0x80000000 + p - 1) // p) * p
    e = any_rep[:, store]                                    # [3, 256, 16]
    u = torch.where(e < 0, (e + (1 << 32) + lift[..., None]) & _M32, e)
    v = emu.shoup(u, one)
    res = emu.inverse(v)                                     # read back at swz(i), i natural
    read = t[0] + _FOLD_THREADS * r[0]                       # thread t, k: i = t + 256 k
    banks = (_swz(read) % 32).reshape(8, 32, 16).sort(dim=1).values
    assert torch.equal(banks, torch.arange(32).reshape(1, 32, 1).expand(8, 32, 16))
    p3 = emu.p.reshape(3, 1)
    out = torch.where(res > p3 // 2, res - p3, res)
    assert torch.equal(out, ntt_inv_plain(ctx, any_rep.to(torch.int32)).to(torch.int64))


def test_merge_kernel_glue_matches_pack_merge_level():
    """csrc/pack_merge.cu's digit loads (v = A - X^t B staged in shared
    memory, gathered at sigma_g's source words) and its base (u plus
    sigma_g(v) at the b component), emulated at N = 4096, against the x and
    base that pack_merge_level hands its fold, bit for bit, at the six
    (t, g) of the read's merge levels and at one t >= N; every gather of a
    warp hits 32 distinct banks."""
    from fhe_ram_tpu_torch.ops import poly
    from fhe_ram_tpu_torch.params import DEFAULT_PRIMES

    emu = _FoldEmu(tget_ctx(_FOLD_N, DEFAULT_PRIMES))
    C2, L, Td = 2, 3, 2
    rnd = np.random.default_rng(11)
    A, B = (torch.from_numpy(rnd.integers(-(1 << 17), 1 << 17, size=(1, C2, L, _FOLD_N),
                                          dtype=np.int64).astype(np.int32)) for _ in range(2))
    key = torch.zeros((3, (C2 - 1) * Td, C2 * 3, 1), dtype=torch.int32)
    seen = {}

    def fold(ctx, x, keys, out_limbs, c2, base=None, sign=1):
        seen.update(x=x.to(torch.int64), base=base.to(torch.int64), sign=sign)

    a64, b64 = A[0].to(torch.int64), B[0].to(torch.int64)
    pos0 = _lay(0, emu.t, emu.r)[0]
    for t_rot, g in [(1 << l, (_FOLD_N >> l) + 1) for l in range(6)] + [(_FOLD_N + 3, 5)]:
        ntt_cuda.pack_merge_level(None, A, B, t_rot, g, key, fold)
        assert seen["sign"] == -1
        ginv = poly.auto_inverse(_FOLD_N, g)
        for tt in range((C2 - 1) * Td):
            c, l = divmod(tt, Td)
            got, banks = emu.merge_digit(a64[c, l], b64[c, l], t_rot % (2 * _FOLD_N), ginv)
            assert torch.equal(got, seen["x"][0, tt][pos0]), (t_rot, g, tt)
            assert torch.equal(banks.sort(dim=1).values,
                               torch.arange(32).reshape(1, 32, 1).expand(8, 32, 16))
        for c2 in range(C2):
            for l in range(L):
                got = emu.merge_base(a64[c2, l], b64[c2, l], t_rot % (2 * _FOLD_N), ginv,
                                     c2 == C2 - 1)
                assert torch.equal(got, seen["base"][0, c2, l]), (t_rot, g, c2, l)
