"""The VM chain kernels' plain versions against the composed loops, in the
PyTorch port alone, on the CPU at log_n = 6.

The composed loops are the package's composed routes (a two-pass context:
circuits.carry_chain_composed, truth_table_composed), written as the JAX
package's composed path writes them: one keyed CMux (the batched fold's
plain version) per step and source group, the smaller source group
zero-padded to a rectangular row count.  The kernels' plain versions do
without the padding and take the step's tables from
`ntt_cuda.dp_leaf_rows`; the zero rows must stay inert.  The blind
rotation runs a batch of 5 rows (a multiple of no row blocking) with
amounts of both signs and past N.  The per-op circuits
(`circuits.add` ...) are the group circuits with one op, select_store's
test vector is the JAX package's case-by-case loop, the shift group
decodes on real encryptions (sll, srl and sra, an immediate group padded),
and ggsw_not's GGSW decrypts to the complement.  Every comparison is torch.equal (integer
arithmetic, tolerance 0)."""

import numpy as np
import pytest
import torch

from fhe_ram_tpu_torch.params import PARAMS_TEST_SMALL, Params
from fhe_ram_tpu_torch.ops.ntt import get_ntt_context, ntt_inv
from fhe_ram_tpu_torch.ops import limb, ntt_cuda, poly
from fhe_ram_tpu_torch.core import ggsw, glwe, keys, keyswitch, noise, rng
from fhe_ram_tpu_torch.vm import arithmetic, circuits, fheuint, store

# one intra-op thread: the suite runs several workers side by side, and
# these sizes gain nothing from more
torch.set_num_threads(1)

BITS = 4
TRUNCATED = Params(log_n=6, k_pt=3, decomp_n=(6,), word_size=2, max_addr=1 << 8,
                   read_ks_digits=2, read_ks_limbs=3, read_ep_digits=2,
                   read_ep_limbs=3)
RINGS = {"untruncated": PARAMS_TEST_SMALL, "truncated": TRUNCATED}


def _two_pass(par):
    """The composed routes' context."""
    return get_ntt_context(par.n, par.primes, "two_pass")


def _operands(par, seed, count=3, bits=BITS):
    rnd = np.random.default_rng(seed)
    ctx = get_ntt_context(par.n, par.primes)
    C = par.rank + 1

    def prep():
        x = rnd.integers(-(1 << 16), 1 << 16, size=(
            bits, par.dnum_ct, C, C, par.limbs_ggsw, par.n)).astype(np.int32)
        return ggsw.prepare(ctx, torch.from_numpy(x))

    return ctx, [prep() for _ in range(count)], rnd


@pytest.mark.parametrize("ring", RINGS)
def test_dp_chain_plain_equals_the_zero_padded_composed_loop(ring):
    """One immediate op against three register ops (padded 4 -> 12 rows
    on the composed side); every DP variant: emit, subtract, MSB flip."""
    par = RINGS[ring]
    ctx, (rs1p, rs2p, immp), _ = _operands(par, 61)
    ops = ("addi", "sub", "slt", "sltu")
    got = arithmetic._dp_group(par, ctx, ops, rs1p, rs2p, immp, BITS)
    want = arithmetic._dp_group(par, _two_pass(par), ops, rs1p, rs2p, immp, BITS)
    for op in ops:
        assert torch.equal(got[op], want[op]), op


@pytest.mark.parametrize("ring", RINGS)
def test_bitwise_plain_equals_the_composed_loop(ring):
    par = RINGS[ring]
    ctx, (rs1p, rs2p, immp), _ = _operands(par, 62)
    ops = ("xor", "ori", "and", "andi", "or")
    got = arithmetic._bitwise_group(par, ctx, ops, rs1p, rs2p, immp, BITS)
    want = arithmetic._bitwise_group(par, _two_pass(par), ops, rs1p, rs2p, immp, BITS)
    for op in ops:
        assert torch.equal(got[op], want[op]), op


@pytest.mark.parametrize("ring", RINGS)
def test_blind_rotate_plain_equals_the_cmux_loop(ring):
    """Five rows, rotations of both signs and past N, the ring's VM
    truncation."""
    par = RINGS[ring]
    ctx, (bits_p,), rnd = _operands(par, 63, count=1)
    rows = torch.from_numpy(rnd.integers(-(1 << 16), 1 << 16, size=(
        5, par.rank + 1, par.limbs_ct, par.n)).astype(np.int32))
    amounts = (-3, 5, 70, -130)
    trunc = arithmetic._vm_trunc(par)[0]
    got = circuits.blind_rotate_fused(par, ctx, rows, bits_p, range(4), amounts,
                                      trunc=trunc)
    want = rows
    for s, t in enumerate(amounts):
        want = circuits.cmux_keyed(par, ctx, bits_p[:, s: s + 1],
                                   poly.rotate(want, t)[None], want[None],
                                   trunc=trunc)[0]
    assert torch.equal(got, want)


@pytest.mark.parametrize("op", ("add", "sub", "sltu", "slt", "xor", "and", "or"))
def test_per_op_circuits_are_the_group_circuits_of_one_op(op):
    par = PARAMS_TEST_SMALL
    ctx, (a, b), _ = _operands(par, 64, count=2)
    if op in arithmetic._DP_SPECS:
        got = getattr(circuits, op)(par, ctx, a, b, BITS)
        want = arithmetic._dp_group(par, ctx, (op,), a, b, b, BITS)[op]
    else:
        got = circuits.bitwise(par, ctx, op, a, b, BITS)
        want = arithmetic._bitwise_group(par, ctx, (op,), a, b, b, BITS)[op]
    assert torch.equal(got, want)


def test_shift_circuit_is_the_shift_group_of_one_op():
    par = PARAMS_TEST_SMALL
    ctx, (a, sh), rnd = _operands(par, 65, count=2)
    C = par.rank + 1
    atk = {g: keyswitch.key_prepare(ctx, torch.from_numpy(rnd.integers(
        -(1 << 16), 1 << 16, size=(par.dnum_ct, par.rank, C, par.limbs_evk_trace,
                                   par.n)).astype(np.int32)))
           for g in par.trace_gal_els}
    word = circuits.word_from_bits(par, ctx, a, BITS)
    for kind in ("sll", "sra"):
        got = circuits.shift(par, ctx, word, sh, atk, kind, BITS)
        want = arithmetic._shift_group(par, ctx, (kind,), a, sh, sh, atk, BITS)[kind]
        assert torch.equal(got, want), kind


SHIFT_OPS = ("slli", "sll", "srl", "sra")


@pytest.fixture(scope="module")
def shifted():
    """The shift group of SHIFT_OPS on real encryptions at the truncated
    ring, 8-bit words: a = 0xB4 (sign bit set), shift amounts 5 (register)
    and 3 (immediate); the immediate group of one op is zero-padded to the
    register group's three."""
    par, bits = TRUNCATED, 8
    ctx = get_ntt_context(par.n, par.primes)
    src = rng.Source(69)
    sk = rng.ternary_secret(src.split(), par.rank, par.n, par.xs_density, device="cpu")
    s_ntt = glwe.secret_prepare(ctx, sk)
    atk = keys.prepare(par, keys.keygen(par, sk, src)).atk_glwe
    a, b, imm = 0xB4, 0x05, 0x03
    enc = [fheuint.encrypt_prepared(par, ctx, s_ntt, v, src, bits) for v in (a, b, imm)]
    words = arithmetic._shift_group(par, ctx, SHIFT_OPS, *enc, atk, bits)
    return par, ctx, s_ntt, words, a, b, imm, bits


@pytest.mark.parametrize("op", SHIFT_OPS)
def test_shift_group_decodes(shifted, op):
    par, ctx, s_ntt, words, a, b, imm, bits = shifted
    m = (1 << bits) - 1
    sh = (imm if op in arithmetic._IMM_OPS else b) % bits
    signed = a - (1 << bits) if a >> (bits - 1) else a
    want = {"sll": (a << sh) & m, "srl": a >> sh,
            "sra": (signed >> sh) & m}[arithmetic._SHIFT_KINDS[op]]
    assert fheuint.decrypt_word(par, ctx, s_ntt, words[op], bits) == want
    assert fheuint.word_noise_log2(par, ctx, s_ntt, words[op], want,
                                   bits) < -(par.k_pt + 1)


def test_chain_wrappers_count_no_launch_on_the_cpu():
    """On CPU tensors the wrappers run their plain versions and count
    nothing: a count is a kernel launch."""
    ntt_cuda.reset_launches()
    par = PARAMS_TEST_SMALL
    ctx, (a, b), _ = _operands(par, 66, count=2)
    circuits.add(par, ctx, a, b, 2)
    circuits.bitwise(par, ctx, "xor", a, b, 2)
    assert all(v == 0 for v in ntt_cuda.LAUNCHES.values())


def test_store_test_vector_equals_the_reference_loop():
    """construct_store_test_vector places case c at X^c in one gather and
    normalizes once; the JAX package adds, normalizes and rotates case by
    case.  Same limbs (balanced limbs of a torus value are unique)."""
    par = PARAMS_TEST_SMALL
    ctx, _, rnd = _operands(par, 67, count=0)
    C = par.rank + 1

    def limbs(*shape):
        return torch.from_numpy(rnd.integers(-(1 << 16), 1 << 16, size=shape)
                                .astype(np.int32))

    atk = {g: keyswitch.key_prepare(ctx, limbs(par.dnum_ct, par.rank, C,
                                               par.limbs_evk_trace, par.n))
           for g in par.trace_gal_els}
    rs2, loaded = limbs(C, par.limbs_ct, par.n), limbs(C, par.limbs_ct, par.n)
    got = store.construct_store_test_vector(par, ctx, rs2, loaded, atk, 32)
    x = circuits.extract_slots(par, ctx, rs2, atk, 32)
    y = circuits.extract_slots(par, ctx, loaded, atk, 32)

    def sp(b, w):
        return store._splice(par, y, x, b, w, 32)

    res = torch.zeros_like(loaded)
    for case in (loaded, sp(0, 1), sp(0, 2), rs2, loaded, sp(1, 1), None, None,
                 loaded, sp(2, 1), sp(2, 2), None, loaded, sp(3, 1)):
        if case is not None:
            res = limb.normalize(res + case)
        res = poly.rotate(res, -1)
    assert torch.equal(got, limb.normalize(poly.rotate(res, 14)))


@pytest.mark.parametrize("bit", (0, 1))
def test_ggsw_not_encrypts_the_complement(bit):
    """ggsw_not of a fresh bit GGSW is GGSW(1 - bit): every row's phase is
    (1 - bit) times its gadget value, under fresh-encryption noise."""
    par = PARAMS_TEST_SMALL
    ctx = get_ntt_context(par.n, par.primes)
    src = rng.Source(68)
    sk = rng.ternary_secret(src.split(), par.rank, par.n, par.xs_density, device="cpu")
    s_ntt = glwe.secret_prepare(ctx, sk)
    prep = fheuint.encrypt_prepared(par, ctx, s_ntt, bit, src, 1)
    # the first prime's centered residues are the (small) coefficients
    not_ggsw = ntt_inv(ctx, circuits.ggsw_not(par, ctx, prep)[:, 0])[0]
    mono = torch.zeros(par.n, dtype=torch.int32)
    mono[0] = 1 - bit
    assert (noise.ggsw_noise_log2(par, ctx, sk, s_ntt, not_ggsw, mono) < -40).all()
