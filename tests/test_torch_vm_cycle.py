"""The VM instruction cycle on the PyTorch port alone, on the CPU, decoded
with the port's own client.

At the ring of tests/test_vm_cycle.py with u32 words (log_n = 9, gap 16
>= the 14 store cases and the 3 ops): keygen, a RAM of 512 random words,
the operands.  One `vm_cycle` selecting "add" out of ("none", "add", "xor"),
storing a halfword at byte offset 2 at an encrypted pointer: rd decodes to
a + b mod 2^32, the fetched word is the RAM's word at the pointer, the
stored word reads back at the pointer, a neighbour is unchanged, all under
the 2^-(k_pt+1) noise bound.  Then select_store's selection over six more
(offset, op) pairs, on one test vector.  The same cycle on a two-pass
context (the composed routes, the JAX package's FHERAM_MXU=0) gives rd, the
fetched word and the new RAM bit for bit: this ring truncates no read path,
so even select_rd's full-gadget rotation equals the fused one.  The cycle's
parts are held against the JAX package bit for bit in
tests/test_torch_vm.py."""

import numpy as np
import pytest
import torch

from fhe_ram_tpu_torch.params import Params
from fhe_ram_tpu_torch.ops.ntt import get_ntt_context
from fhe_ram_tpu_torch.core import glwe, keys as keys_mod, keyswitch, rng
from fhe_ram_tpu_torch.ram import address, ram
from fhe_ram_tpu_torch.vm import fheuint, store
from fhe_ram_tpu_torch.vm.cycle import vm_cycle

# one intra-op thread: the suite runs several workers side by side, and
# these sizes gain nothing from more
torch.set_num_threads(1)

PAR = Params(log_n=9, k_pt=3, decomp_n=(3, 3, 3), word_size=4, max_addr=1 << 9)
BITS = 32
OPS = ("none", "add", "xor")
MASK = (1 << 32) - 1


@pytest.fixture(scope="module")
def client():
    ctx = get_ntt_context(PAR.n, PAR.primes)
    src = rng.Source(5)
    sk = rng.ternary_secret(src.split(), PAR.rank, PAR.n, PAR.xs_density,
                            device="cpu")
    s_ntt = glwe.secret_prepare(ctx, sk)
    keys = keys_mod.prepare(PAR, keys_mod.keygen(PAR, sk, src))
    data = np.random.default_rng(6).integers(
        0, 256, size=PAR.max_addr * PAR.word_size).astype(np.uint8)
    ram_ct = ram.encrypt_ram(PAR, ctx, s_ntt, data, src)
    return ctx, src, s_ntt, keys, data, ram_ct


def _word(data, idx):
    w = PAR.word_size
    return int.from_bytes(bytes(data[idx * w: (idx + 1) * w]), "little")


def _check_ram_word(ctx, s_ntt, out, plain, idx):
    ph = glwe.phase(PAR, ctx, s_ntt, out)
    for i in range(PAR.word_size):
        want = glwe.cast_u8_signed(int(plain[idx * PAR.word_size + i]), PAR.k_pt)
        val, noise = glwe.decode_coeff0(PAR, ph[i], want)
        assert int(val) == want, (idx, i)
        assert noise < -(PAR.k_pt + 1), (idx, i, noise)


A, B = 0x89ABCDEF, 0x7654F321
PTR, NEIGHBOUR, OFFSET = 300, 301, 2


@pytest.fixture(scope="module")
def cycle(client):
    """One fused vm_cycle: its encrypted operands and its outputs."""
    ctx, src, s_ntt, keys, data, ram_ct = client
    a, b, ptr, offset = A, B, PTR, OFFSET
    loaded = _word(data, ptr)
    enc = dict(
        rs1p=fheuint.encrypt_prepared(PAR, ctx, s_ntt, a, src, BITS),
        rs2p=fheuint.encrypt_prepared(PAR, ctx, s_ntt, b, src, BITS),
        op_id_prep=fheuint.encrypt_prepared(PAR, ctx, s_ntt, OPS.index("add"), src, 2),
        rs2_word=fheuint.encrypt_word(PAR, ctx, s_ntt, b, src, BITS),
        loaded_word=fheuint.encrypt_word(PAR, ctx, s_ntt, loaded, src, BITS),
        offset_prep=fheuint.encrypt_prepared(PAR, ctx, s_ntt, offset, src, 2),
        storeop_prep=fheuint.encrypt_prepared(PAR, ctx, s_ntt,
                                              store.STORE_OPS.index("sh"), src, 2),
        ptr_prep=fheuint.encrypt_prepared(PAR, ctx, s_ntt, ptr, src, 9,
                                          dnum=PAR.dnum_ggsw,
                                          limbs=PAR.limbs_evk_ggsw))
    # no op of OPS reads the immediate: rs2's bits stand in for it
    enc["immp"] = enc["rs2p"]
    return enc, vm_cycle(PAR, ctx, keys, data=ram_ct, ops=OPS, bits=BITS, **enc)


def test_vm_cycle_decodes(client, cycle):
    ctx, src, s_ntt, keys, data, ram_ct = client
    a, b, ptr, neighbour = A, B, PTR, NEIGHBOUR
    loaded = _word(data, ptr)
    _, (rd, fetched, new_data) = cycle
    assert fheuint.decrypt_word(PAR, ctx, s_ntt, rd, BITS) == (a + b) & MASK
    assert fheuint.word_noise_log2(PAR, ctx, s_ntt, rd, (a + b) & MASK,
                                   BITS) < -(PAR.k_pt + 1)
    _check_ram_word(ctx, s_ntt, fetched, data, ptr)
    # the halfword at bytes 2-3 is rs2's low halfword, the rest the old word
    stored = (loaded & 0x0000FFFF) | ((b & 0xFFFF) << 16)
    after = data.copy()
    after[ptr * 4: ptr * 4 + 4] = list(stored.to_bytes(4, "little"))
    server = ram.FheRam(PAR, keys, device="cpu")
    state = server.init_state(new_data)
    for idx in (ptr, neighbour):
        out = server.read(state, address.prepare(
            ctx, address.encrypt(PAR, ctx, s_ntt, idx, src)))
        _check_ram_word(ctx, s_ntt, out, after, idx)


def test_composed_vm_cycle_equals_the_fused_one(client, cycle):
    """vm_cycle on a two-pass context, the same operands and RAM: rd,
    fetched and the whole new RAM bit-equal to the fused cycle's."""
    ctx, src, s_ntt, keys, data, ram_ct = client
    enc, fused = cycle
    two_pass = get_ntt_context(PAR.n, PAR.primes, "two_pass")
    composed = vm_cycle(PAR, two_pass, keys, data=ram_ct, ops=OPS, bits=BITS, **enc)
    for name, got, want in zip(("rd", "fetched", "new_data"), composed, fused):
        assert torch.equal(got, want), name


@pytest.fixture(scope="module")
def store_vector(client):
    """select_store's test vector of two words: the same for every (offset,
    op), so it is built once."""
    ctx, src, s_ntt, keys, data, ram_ct = client
    y, x = 0xA1B2C3D4, 0x5E6F7081
    tv = store.construct_store_test_vector(
        PAR, ctx, fheuint.encrypt_word(PAR, ctx, s_ntt, x, src, BITS),
        fheuint.encrypt_word(PAR, ctx, s_ntt, y, src, BITS), keys.atk_glwe, BITS)
    return tv, y, x


@pytest.mark.parametrize("offset,op", [(0, "sw"), (0, "sb"), (1, "sb"), (2, "sh"),
                                       (2, "sb"), (3, "none")])
def test_store_selection_decodes(client, store_vector, offset, op):
    """select_store's selection -- the 4-step rotation by offset << 2 and
    op, then the partial trace -- over six (offset, op) pairs."""
    ctx, src, s_ntt, keys, data, ram_ct = client
    tv, y, x = store_vector
    res = store.store_rotation(
        PAR, ctx, tv, fheuint.encrypt_prepared(PAR, ctx, s_ntt, offset, src, 2),
        fheuint.encrypt_prepared(PAR, ctx, s_ntt, store.STORE_OPS.index(op), src, 2))
    got = keyswitch.trace(PAR, ctx, res, keys.atk_glwe, keep_log=BITS.bit_length() - 1)
    width = {"none": 0, "sb": 1, "sh": 2, "sw": 4}[op]
    field = ((1 << (8 * width)) - 1) << (8 * offset)
    want = (y & ~field & MASK) | ((x << (8 * offset)) & field)
    assert fheuint.decrypt_word(PAR, ctx, s_ntt, got, BITS) == want
