"""The write path's modules of the PyTorch port held against the JAX
package on the same inputs, on the CPU, and the port's write cycle on its
own: extract_slots, one split level (the plain version of the split
kernel), the GGSW inversion, the pending-write protocol, and whole cycles
at the single-level and the three-level geometry.

The JAX side runs its composed path under jax.jit; the port runs on CPU
tensors, where each wrapper takes its kernel's plain version.  Keys and
ciphertexts are random int32 arrays of the presets' shapes, made from a
seed with numpy and prepared by each side's own `prepare`; outputs are
compared bit for bit (np.array_equal, tolerance 0: integer arithmetic).
The whole cycle on the JAX client's ciphertexts is in
tests/test_torch_read.py."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fhe_ram_tpu.params import PARAMS_TEST_SMALL_WIDE as JWIDE
from fhe_ram_tpu.ops.ntt import get_ntt_context as jget_ctx
from fhe_ram_tpu.ops import limb as jlimb
from fhe_ram_tpu.ops import poly as jpoly
from fhe_ram_tpu.core import ggsw as jggsw
from fhe_ram_tpu.core import keys as jkeys
from fhe_ram_tpu.core import keyswitch as jks

from fhe_ram_tpu_torch import params as tparams
from fhe_ram_tpu_torch.params import PARAMS_TEST_SMALL_WIDE as TWIDE
from fhe_ram_tpu_torch.convert import stack_addresses
from fhe_ram_tpu_torch.ops.ntt import get_ntt_context as tget_ctx
from fhe_ram_tpu_torch.ops import ntt_cuda
from fhe_ram_tpu_torch.core import ggsw as tggsw
from fhe_ram_tpu_torch.core import glwe as tglwe
from fhe_ram_tpu_torch.core import keys as tkeys
from fhe_ram_tpu_torch.core import keyswitch as tks
from fhe_ram_tpu_torch.core import rng as trng
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

JCTX = jget_ctx(JWIDE.n, JWIDE.primes)
TCTX = tget_ctx(TWIDE.n, TWIDE.primes)
C = JWIDE.rank + 1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _limbs(rnd, shape, bits=16):
    return rnd.integers(-(1 << bits), 1 << bits, size=shape).astype(np.int32)


def _atk(rnd, gals):
    """({g: key polys for jax}, {g: the port's prepared key})."""
    shape = (JWIDE.dnum_ct, JWIDE.rank, C, JWIDE.limbs_evk_trace, JWIDE.n)
    atk = {g: _limbs(rnd, shape) for g in gals}
    return ({g: jnp.asarray(k) for g, k in atk.items()},
            {g: tks.key_prepare(TCTX, _t(k)) for g, k in atk.items()})


def _jprep(ks):
    return {g: jks.key_prepare(JCTX, k) for g, k in ks.items()}


@pytest.mark.parametrize("count,bounded", [(4, True), (3, False)],
                         ids=["bounded_4", "unbounded_3"])
def test_extract_slots_matches_jax(count, bounded):
    """Two split levels; bounded support skips the tail (count << s <= N),
    without it every leaf runs the remaining log_n - 2 trace steps; a
    count that is not a power of two drops the last leaf."""
    rnd = np.random.default_rng(20 + count)
    jk, tk = _atk(rnd, JWIDE.trace_gal_els[:2 if bounded else None])
    ct = _limbs(rnd, (2, C, JWIDE.limbs_ct, JWIDE.n))
    want = np.asarray(_jit(lambda c, k: jks.extract_slots(
        JWIDE, JCTX, c, count, _jprep(k), bounded_support=bounded))(
            jnp.asarray(ct), jk))
    got = tks.extract_slots(TWIDE, TCTX, _t(ct), count, tk,
                            bounded_support=bounded)
    assert got.shape == (2, count, C, JWIDE.limbs_ct, JWIDE.n)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("count,bounded", [(1, True), (16, True), (5, False)],
                         ids=["one_slot", "bounded_but_tail_kept", "unbounded_5"])
def test_extract_slots_is_the_trace_of_each_rotation(count, bounded):
    """The definition, on the port alone: out[m] == trace(X^-m ct).  The
    split tree shares one keyswitch between two children and orders its
    operations otherwise than a rotate-and-trace does, so the two agree
    as torus values up to the keyswitch rounding, not bit for bit: with
    zero keys (keyswitch = 0) they agree exactly.  count = 16 with bounded
    support keeps its tail (16 << 4 > N)."""
    from fhe_ram_tpu_torch.ops import poly as tpoly

    rnd = np.random.default_rng(40 + count)
    zero = torch.zeros((3, TWIDE.dnum_ct, TWIDE.rank, C, TWIDE.limbs_evk_trace,
                        TWIDE.n), dtype=torch.int32)
    tk = {g: zero for g in TWIDE.trace_gal_els}
    # a-part zero: the ciphertext is its own phase and every step is exact
    ct = _limbs(rnd, (2, C, TWIDE.limbs_ct, TWIDE.n))
    ct[:, :TWIDE.rank] = 0
    ct[..., 1:, :] = 0  # one limb, low bits clear: the 1/N pre-scale is exact
    ct[..., 0, :] &= ~0x3F
    got = tks.extract_slots(TWIDE, TCTX, _t(ct), count, tk,
                            bounded_support=bounded)
    assert got.shape == (2, count, C, TWIDE.limbs_ct, TWIDE.n)
    for m in range(count):
        want = tks.trace(TWIDE, TCTX, tpoly.rotate(_t(ct), -m), tk)
        if bounded and count << max(count - 1, 0).bit_length() <= TWIDE.n:
            # the tail is skipped: only coefficient 0 is the slot
            assert torch.equal(got[:, m, ..., 0], want[..., 0]), m
        else:
            assert torch.equal(got[:, m], want), m


def test_split_level_matches_the_composed_form_in_jax():
    """fused_split (its plain version) against the JAX package's composed
    split level: child0 = trace step, child1 = normalize(X^-t (2x - child0))."""
    rnd = np.random.default_rng(23)
    l = 2
    t, g = 1 << l, JWIDE.trace_gal_els[l]
    jk, tk = _atk(rnd, (g,))
    ct = _limbs(rnd, (3, C, JWIDE.limbs_ct, JWIDE.n))

    def composed(nodes, k):
        child0 = jks.trace_steps(JWIDE, JCTX, nodes, _jprep(k), (g,))
        return child0, jlimb.normalize(jpoly.rotate(2 * nodes - child0, -t))

    want0, want1 = _jit(composed)(jnp.asarray(ct), jk)
    got0, got1 = ntt_cuda.fused_split(TCTX, _t(ct), t, g,
                                      tks.kernel_key_rows(tk[g]))
    assert np.array_equal(got0.numpy(), np.asarray(want0))
    assert np.array_equal(got1.numpy(), np.asarray(want1))


def test_ggsw_automorphism_inv_matches_jax():
    """The keyswitch of the b-rows under atk_ggsw[-1] (5 key limbs folded
    to the GGSW's 4) and the tensor-key products."""
    rnd = np.random.default_rng(24)
    D, Lg, n = JWIDE.dnum_ggsw, JWIDE.limbs_evk_ggsw, JWIDE.n
    gg = _limbs(rnd, (JWIDE.dnum_ct, C, C, JWIDE.limbs_ggsw, n))
    akey = _limbs(rnd, (D, JWIDE.rank, C, Lg, n))
    tsk = _limbs(rnd, (JWIDE.rank, D, C, C, Lg, n))
    want = np.asarray(_jit(lambda x, a, t: jkeys.ggsw_automorphism_inv(
        JWIDE, JCTX, x, jkeys.EvaluationKeysPrepared(
            atk_glwe={}, atk_ggsw={-1: jks.key_prepare(JCTX, a)},
            tsk=jggsw.prepare(JCTX, t))))(
                jnp.asarray(gg), jnp.asarray(akey), jnp.asarray(tsk)))
    tkp = tkeys.EvaluationKeysPrepared(
        atk_glwe={}, atk_ggsw={-1: tks.key_prepare(TCTX, _t(akey))},
        tsk=tggsw.prepare(TCTX, _t(tsk)))
    got = tkeys.ggsw_automorphism_inv(TWIDE, TCTX, _t(gg), tkp)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    with pytest.raises(AssertionError):  # no key for that galois element
        tkeys.ggsw_automorphism(TWIDE, TCTX, _t(gg), 3, tkp)


# --------------------------------------------------------------------------
# the port alone: its own client, no JAX
# --------------------------------------------------------------------------

def _own_client(par, seed):
    ctx = tget_ctx(par.n, par.primes)
    src = trng.Source(seed)
    sk = trng.ternary_secret(src.split(), par.rank, par.n, par.xs_density,
                             device="cpu")
    s_ntt = tglwe.secret_prepare(ctx, sk)
    ekp = tkeys.prepare(par, tkeys.keygen(par, sk, src))
    server = tram.FheRam(par, ekp, device="cpu")
    rnd = np.random.default_rng(seed + 1)
    data = rnd.integers(0, 256, size=par.max_addr * par.word_size).astype(np.uint8)
    state = server.init_state(tram.encrypt_ram(par, ctx, s_ntt, data, src))
    return ctx, src, s_ntt, server, rnd, data, state


def _check_word(par, ctx, s_ntt, out, data, idx, note):
    W = par.word_size
    assert tuple(out.shape) == (W, par.rank + 1, par.limbs_ct, par.n), note
    for i in range(W):
        want = tglwe.cast_u8_signed(int(data[idx * W + i]), par.k_pt)
        val, noise = tglwe.decode_coeff0(
            par, tglwe.phase(par, ctx, s_ntt, out[i]), want)
        assert int(val) == want, f"{note} subram {i}: {val} != {want}"
        assert noise < -(par.k_pt + 1), f"{note} noise {noise}"


@pytest.mark.parametrize("name", ["PARAMS_TEST_FLAT", "PARAMS_TEST_3LVL"],
                         ids=["flat_n2_1", "tree_n2_3"])
def test_write_cycle_decodes(name):
    """Single level: the rotated base is the root and no slot is
    extracted.  Three levels: the mid loop of the write runs, with a
    two-chunk level-0 pack.  Then a batched read of the new state."""
    par = getattr(tparams, name)
    ctx, src, s_ntt, server, rnd, data, state = _own_client(par, 8)
    idx = int(rnd.integers(0, par.max_addr))
    addr = taddress.encrypt(par, ctx, s_ntt, idx, src)
    ap = taddress.prepare(ctx, addr)
    new_word = rnd.integers(0, 256, size=par.word_size).astype(np.uint8)
    w_ct = tram.encrypt_write_word(par, ctx, s_ntt, new_word, src)

    out, pending = server.read_prepare_write(state, ap)
    _check_word(par, ctx, s_ntt, out, data, idx, "rpw")
    assert pending.data is state.data and len(pending.tree) == max(len(ap.coordinates) - 1, 1)
    before = state.data.clone()
    state2 = server.write(pending, w_ct, addr)
    assert torch.equal(state.data, before), "write must not touch the old tensor"
    data[idx * par.word_size: (idx + 1) * par.word_size] = new_word
    _check_word(par, ctx, s_ntt, server.read(state2, ap), data, idx, "read-back")
    singles = [server.read(state2, ap)]
    preps = [ap]
    for other in [(idx + 1) % par.max_addr, (idx + par.max_addr // 2) % par.max_addr]:
        a2 = taddress.prepare(ctx, taddress.encrypt(par, ctx, s_ntt, other, src))
        singles.append(server.read(state2, a2))
        preps.append(a2)
        _check_word(par, ctx, s_ntt, singles[-1], data, other, f"other idx={other}")
    # and at these geometries too the batched read gives the single reads'
    # integers, with the spectral cache of the NEW state and without
    for cache in (None, server.spectral_cache(state2)):
        got = server.read_batch(state2, stack_addresses(preps), cache=cache)
        assert torch.equal(got, torch.stack(singles))


def test_pending_write_protocol_refuses():
    """write without read_prepare_write refuses; read, read_prepare_write,
    read_batch and spectral_cache refuse while a write is pending."""
    par = tparams.PARAMS_TEST_FLAT
    ctx, src, s_ntt, server, rnd, data, state = _own_client(par, 5)
    addr = taddress.encrypt(par, ctx, s_ntt, 3, src)
    ap = taddress.prepare(ctx, addr)
    w_ct = tram.encrypt_write_word(par, ctx, s_ntt, [1, 2], src)
    with pytest.raises(AssertionError):
        server.write(state, w_ct, addr)
    _, pending = server.read_prepare_write(state, ap)
    with pytest.raises(AssertionError):
        server.read(pending, ap)
    with pytest.raises(AssertionError):
        server.read_prepare_write(pending, ap)
    with pytest.raises(AssertionError):
        server.read_batch(pending, stack_addresses([ap]))
    with pytest.raises(AssertionError):
        server.spectral_cache(pending)
    done = server.write(pending, w_ct, addr)
    assert not done.pending and done.tree == ()
    with pytest.raises(AssertionError):  # the cycle is over: no second write
        server.write(done, w_ct, addr)


def test_client_and_server_refuse_bad_arguments():
    par = tparams.PARAMS_TEST_FLAT
    ctx, src, s_ntt, server, rnd, data, state = _own_client(par, 6)
    with pytest.raises(ValueError):  # a word of the wrong size
        tram.encrypt_write_word(par, ctx, s_ntt, [1, 2, 3], src)
    ap = taddress.prepare(ctx, taddress.encrypt(par, ctx, s_ntt, 1, src))
    with pytest.raises(ValueError):
        server.read_batch(state, tuple(c[None] for c in ap.coordinates),
                          batch_slice=0)
    # tensors on another device than the server's: the same shapes on
    # PyTorch's `meta` device stand in for a second real device
    far_address = taddress.AddressPrepared(
        tuple(c.to("meta") for c in ap.coordinates))
    far_data = state.data.to("meta")
    with pytest.raises(ValueError):
        server.read(state, far_address)
    with pytest.raises(ValueError):
        server.init_state(far_data)
    with pytest.raises(ValueError):
        server.read(state, ap, cache=far_data)
    _, pending = server.read_prepare_write(state, ap)
    with pytest.raises(ValueError):
        server.write(pending, far_data, taddress.Address(ap.coordinates))
