"""The VM LOAD (vm/bitdecomp.py) of the PyTorch port, on the CPU, at the
toy ring of tests/test_bitdecomp.py: N = 64, k_pt = 4, 4-bit bytes, 2-byte
words, chunk 2 (two sign-bootstrap phases of 64 CMux steps each).

* Against the JAX package, on random arrays: ONE jitted JAX function
  (no JAX keygen or encryption) runs bytes_to_bits(with_rows=True),
  bits_to_word and bits_to_prepared on random normalized limbs -- a flat
  coefficient bootstrapping key, trace keys, a tensor key and two byte
  ciphertexts -- and the port runs the same on the same arrays, the key
  carried across by from_reference(bsk=...).  Each side prepares its own
  spectra; the lift is compared in the coefficient domain (the JAX
  prepared stack brought back by its inverse transform: the residues of
  limbs below 2^16 are the limbs).  Every comparison is np.array_equal.
* With the port's own client: a word of two encrypted bytes decodes
  through bootstrap_key_fast and load_word, every lifted bit drives a
  select that decodes b * m, and the loaded word feeds the ALU's add
  (arithmetic._dp_group), as tests/test_bitdecomp.py does for the JAX
  package.
"""

import functools
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import jax
import pytest
import torch

from fhe_ram_tpu.params import Params as JParams
from fhe_ram_tpu.ops import ntt as jntt
from fhe_ram_tpu.core import ggsw as jggsw
from fhe_ram_tpu.core import keys as jkeys
from fhe_ram_tpu.core import keyswitch as jks
from fhe_ram_tpu.vm import bitdecomp as jbd

from fhe_ram_tpu_torch.convert import from_reference
from fhe_ram_tpu_torch.params import Params as TParams
from fhe_ram_tpu_torch.ops.ntt import get_ntt_context as tget_ctx
from fhe_ram_tpu_torch.core import ggsw as tggsw
from fhe_ram_tpu_torch.core import glwe as tglwe
from fhe_ram_tpu_torch.core import keys as tkeys
from fhe_ram_tpu_torch.core import keyswitch as tks
from fhe_ram_tpu_torch.core import rng as trng
from fhe_ram_tpu_torch.vm import arithmetic as tar
from fhe_ram_tpu_torch.vm import bitdecomp as tbd
from fhe_ram_tpu_torch.vm import fheuint as tfu

torch.set_num_threads(1)

# the JAX reference compiled without XLA's optimisation passes, with the
# loop emitters (the same integers, less of the compile's CPU time)
_jit = functools.partial(jax.jit, compiler_options={
    "xla_backend_optimization_level": 0,
    "xla_cpu_parallel_codegen_split_count": 1,
    "xla_cpu_use_fusion_emitters": False})

TOY = dict(log_n=6, k_pt=4, decomp_n=(3, 3), word_size=2, max_addr=1 << 8)
JPAR, TPAR = JParams(**TOY), TParams(**TOY)
P_BITS, CHUNK = 4, 2
BITS = 2 * P_BITS


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want):
    return got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(want))


def _inputs(seed=14):
    """Random normalized limbs of the shapes LOAD takes at the toy ring."""
    rnd = np.random.default_rng(seed)
    p, C, n = TPAR, TPAR.rank + 1, TPAR.n

    def limbs(shape):
        return rnd.integers(-(1 << 16), 1 << 16, size=shape).astype(np.int32)

    D, Lg = p.dnum_ct, p.limbs_ggsw
    return dict(
        bytes=limbs((2, C, p.limbs_ct, n)),
        bsk=limbs((p.rank * n, 2 * D * C * C * Lg, n)),
        atk={g: limbs((D, p.rank, C, p.limbs_evk_trace, n)) for g in p.trace_gal_els},
        tsk=limbs((p.rank, p.dnum_ggsw, C, C, p.limbs_evk_ggsw, n)))


def _jax_refs(x):
    """The JAX package's bytes_to_bits(with_rows=True), bits_to_word and
    lift on the arrays x, in ONE jitted function; the lift comes back in
    the coefficient domain (its prepared stack through the inverse
    transform).  The two phases' traces are one nested jit of the JAX
    package's trace: traced and compiled once for both (the same
    integers)."""
    jctx = jntt.get_ntt_context(JPAR.n, JPAR.primes)

    def jax_load(byte_cts, bsk, atk, tsk):
        keys = jkeys.EvaluationKeysPrepared(
            atk_glwe={g: jks.key_prepare(jctx, k) for g, k in atk.items()},
            atk_ggsw={}, tsk=jggsw.prepare(jctx, tsk))
        bits, rows = jbd.bytes_to_bits(JPAR, jctx, byte_cts, bsk, keys.atk_glwe,
                                       P_BITS, chunk=CHUNK, with_rows=True)
        word = jbd.bits_to_word(JPAR, bits.reshape((BITS,) + byte_cts.shape[1:]), BITS)
        lifted = jbd.bits_to_prepared(JPAR, jctx,
                                      rows.reshape((BITS,) + rows.shape[2:]), keys)
        return bits, rows, word, jntt.ntt_inv(jctx, lifted)[0]

    args = (x["bytes"], x["bsk"], x["atk"], x["tsk"])
    with mock.patch.object(jbd.keyswitch, "trace",
                           jax.jit(jks.trace, static_argnums=(0, 1))):
        compiled = _jit(jax_load).lower(*args).compile()
    return [np.asarray(a) for a in compiled(*args)]


@pytest.fixture(scope="module", autouse=True)
def jax_future():
    """The JAX references, started with the module's first test in a
    thread of their own (XLA compiles outside the interpreter lock) while
    the port's tests run; the tests that compare wait for them."""
    pool = ThreadPoolExecutor(1)
    future = pool.submit(_jax_refs, _inputs())
    pool.shutdown(wait=False)
    return future


@pytest.fixture(scope="module")
def world(jax_future):
    """The port's outputs on the arrays the JAX references ran on."""
    x = _inputs()
    tctx = tget_ctx(TPAR.n, TPAR.primes)
    ref = from_reference(keys=dict(atk_glwe=x["atk"], atk_ggsw={}, tsk=x["tsk"]),
                         bsk=x["bsk"], device="cpu")
    keys = tkeys.EvaluationKeysPrepared(
        atk_glwe={g: tks.key_prepare(tctx, k) for g, k in ref.keys.atk_glwe.items()},
        atk_ggsw={}, tsk=tggsw.prepare(tctx, ref.keys.tsk))
    bits, rows = tbd.bytes_to_bits(TPAR, tctx, _t(x["bytes"]), ref.bsk, keys.atk_glwe,
                                   P_BITS, chunk=CHUNK, with_rows=True)
    word = tbd.bits_to_word(TPAR, bits.reshape((BITS,) + tuple(bits.shape[2:])), BITS)
    lifted = tbd.lift_rows(TPAR, tctx, rows.reshape((BITS,) + tuple(rows.shape[2:])), keys)
    return dict(x=x, ref=ref, tctx=tctx, got=[bits, rows, word, lifted])


def test_key_forms_and_carried_key_give_the_same_integers(world):
    """from_reference keeps the JAX client's flat key as it is, and the
    7-D coefficient form of the same key gives the same chain."""
    x, tctx, ref = world["x"], world["tctx"], world["ref"]
    assert _eq(ref.bsk, x["bsk"])
    D, C, n = TPAR.dnum_ct, TPAR.rank + 1, TPAR.n
    bsk7 = x["bsk"].reshape(TPAR.rank * n, 2, D, C, C, TPAR.limbs_ggsw, n)
    assert from_reference(bsk=bsk7, device="cpu").bsk.shape == bsk7.shape
    acc, amounts = tbd.chain_start(TPAR, _t(x["bytes"][0]),
                                   *tbd.phase_tests(TPAR, 1, [0, 1], 2, 1))
    got = [tbd.chain(TPAR, tctx, acc, k, range(5, 13), amounts[:, 5:13])
           for k in (ref.bsk, _t(bsk7))]
    assert torch.equal(got[0], got[1]) and not torch.equal(got[0], acc)


def test_load_decodes_with_the_ports_client():
    """The port's own client end to end: keygen, bootstrap_key_fast, two
    encrypted bytes -> load_word; the word decodes to the unsigned bytes,
    each lifted bit selects b * m under the noise bound, and the loaded
    word feeds the ALU's add.  On a two-pass context (the composed routes'
    traces) load_word gives the same integers, and so does the carry DP's
    composed loop with the lifted bits (2 gadget rows) beside 3-row ones in
    one keyed CMux.  The prepared key of bootstrap_key (one GGSW
    encryption a bit) decomposes a byte as the reference's test does."""
    ctx = tget_ctx(TPAR.n, TPAR.primes)
    src = trng.Source(91)
    sk = trng.ternary_secret(src.split(), TPAR.rank, TPAR.n, TPAR.xs_density,
                             device="cpu")
    s_ntt = tglwe.secret_prepare(ctx, sk)
    ekp = tkeys.prepare(TPAR, tkeys.keygen(TPAR, sk, src))
    bsk = tbd.bootstrap_key_fast(TPAR, ctx, sk, s_ntt, src, chunk=64)
    assert tuple(bsk.shape) == (TPAR.n, 2 * 3 * 2 * 2 * TPAR.limbs_ggsw, TPAR.n)

    def enc(x):
        vals = np.zeros(TPAR.n, dtype=np.int64)
        vals[0] = x
        return tglwe.encrypt(TPAR, ctx, s_ntt,
                             tglwe.encode_vec(TPAR, vals, device="cpu"), src)

    signed = [5, -3]
    cts = torch.stack([enc(x) for x in signed])
    word, prepared = tbd.load_word(TPAR, ctx, cts, bsk, ekp, bits=BITS)
    us = [x & ((1 << P_BITS) - 1) for x in signed]
    want = us[0] | (us[1] << P_BITS)
    assert tfu.decrypt_word(TPAR, ctx, s_ntt, word, BITS) == want
    assert tfu.word_noise_log2(TPAR, ctx, s_ntt, word, want, BITS) < -(TPAR.k_pt + 1)
    two = tget_ctx(TPAR.n, TPAR.primes, "two_pass")
    for got, ref in zip(tbd.load_word(TPAR, two, cts, bsk, ekp, bits=BITS),
                        (word, prepared)):
        assert torch.equal(got, ref)

    # the GGSW-by-GGSW key, prepared: byte_to_bits of one byte decodes
    slow = tbd.bootstrap_key(TPAR, ctx, sk, s_ntt, src)
    assert tuple(slow.shape) == (TPAR.num_primes, TPAR.n, 2, 3, 2, 2, TPAR.limbs_ggsw, TPAR.n)
    bits = tbd.byte_to_bits(TPAR, ctx, enc(-3), slow, ekp.atk_glwe, P_BITS, chunk=2)
    for k in range(P_BITS):
        val, noise = tglwe.decode_coeff0(TPAR, tglwe.phase(TPAR, ctx, s_ntt, bits[k]),
                                         (13 >> k) & 1)
        assert int(val) == (13 >> k) & 1 and noise < -(TPAR.k_pt + 1), (k, val, noise)

    m, ct_m = 3, enc(3)
    for j in range(BITS):
        b = (want >> j) & 1
        sel = tggsw.external_product(TPAR, ctx, ct_m, prepared[:, j])
        val, noise = tglwe.decode_coeff0(TPAR, tglwe.phase(TPAR, ctx, s_ntt, sel), b * m)
        assert int(val) == b * m, (j, val)
        assert noise < -(TPAR.k_pt + 1), (j, noise)

    rhs = tfu.encrypt_prepared(TPAR, ctx, s_ntt, 0x33, src, BITS)
    words = tar._dp_group(TPAR, ctx, ("add",), prepared, rhs, rhs, BITS)
    assert tfu.decrypt_word(TPAR, ctx, s_ntt, words["add"], BITS) == (want + 0x33) & 0xFF
    mixed = ("add", "addi")           # rs2: the lifted bits, imm: 3-row bits
    fused = tar._dp_group(TPAR, ctx, mixed, rhs, prepared, rhs, BITS)
    composed = tar._dp_group(TPAR, two, mixed, rhs, prepared, rhs, BITS)
    assert all(torch.equal(composed[op], fused[op]) for op in mixed)
    assert (tfu.decrypt_word(TPAR, ctx, s_ntt, composed["add"], BITS)
            == (want + 0x33) & 0xFF)


@pytest.mark.parametrize("what, i", [("bytes_to_bits bits", 0),
                                     ("bytes_to_bits rows", 1),
                                     ("bits_to_word", 2),
                                     ("bits_to_prepared's digit rows", 3)])
def test_load_matches_jax_bit_for_bit(world, jax_future, what, i):
    got, want = world["got"][i], jax_future.result()[i]
    assert tuple(got.shape) == want.shape, (what, got.shape, want.shape)
    assert _eq(got, want), what
