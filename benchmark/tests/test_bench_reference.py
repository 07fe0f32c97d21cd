"""The plain reference against the port's own client on the CPU, at the
port's PARAMS_TEST_SMALL: the same phases, the same decoded bytes; and the
reference's verdicts on answers that are right, altered and truncated."""

import numpy as np
import pytest
import torch

from benchmark.reference import ram_reference as ref
from fhe_ram_tpu_torch.core import glwe, keys as keys_mod, rng
from fhe_ram_tpu_torch.ops.ntt import get_ntt_context
from fhe_ram_tpu_torch.params import PARAMS_TEST_SMALL as P
from fhe_ram_tpu_torch.ram import address as address_mod
from fhe_ram_tpu_torch.ram import ram as ram_mod


@pytest.fixture(scope="module")
def client():
    src = rng.Source(7)
    sk = rng.ternary_secret(src.split(), P.rank, P.n, P.xs_density, device="cpu")
    ctx = get_ntt_context(P.n, P.primes)
    s_ntt = glwe.secret_prepare(ctx, sk)
    data = np.random.default_rng(3).integers(0, 256, P.max_addr * P.word_size).astype(np.uint8)
    keys = keys_mod.prepare(P, keys_mod.keygen(P, sk, src))
    server = ram_mod.FheRam(P, keys, device="cpu")
    state = server.init_state(ram_mod.encrypt_ram(P, ctx, s_ntt, data, src))
    return dict(src=src, sk=sk, ctx=ctx, s_ntt=s_ntt, data=data, server=server, state=state)


def torus_ints(limbs):
    """The port's normalized phase limbs as torus integers mod 2^(17 L)."""
    x = np.asarray(limbs, dtype=np.int64)
    L = x.shape[-2]
    v = sum(x[..., j, :] << (17 * (L - 1 - j)) for j in range(L))
    return np.mod(v, 1 << (17 * L))


def test_phase_of_the_whole_ram_equals_the_ports(client):
    c = client
    ph_port = glwe.phase(P, c["ctx"], c["s_ntt"], c["state"].data)   # [W, R, L, N]
    ph_ref = ref.phase_rows(c["state"].data.numpy(), c["sk"].numpy())  # [W, R, N]
    assert np.array_equal(torus_ints(ph_port.numpy()), ph_ref)
    wrong, words, share = ref.judge_ram(c["state"].data.numpy(),
                                        c["data"].reshape(-1, P.word_size), c["sk"].numpy(), P.k_pt)
    assert (wrong, words) == (0, 0) and 0 < share < 1e-6


@pytest.mark.parametrize("addr", [0, 77, 255])
def test_reads_decode_as_the_ports_client_decodes(client, addr):
    c = client
    a = address_mod.prepare(c["ctx"], address_mod.encrypt(P, c["ctx"], c["s_ntt"], addr, c["src"]))
    out = c["server"].read(c["state"], a)  # [W, C, L, N]
    ph = glwe.phase(P, c["ctx"], c["s_ntt"], out)
    want = c["data"].reshape(-1, P.word_size)[addr]
    ph_ref = ref.phase_coeff0(out.numpy(), c["sk"].numpy())
    assert np.array_equal(torus_ints(ph.numpy())[:, 0], ph_ref)
    for j in range(P.word_size):
        val, _ = glwe.decode_coeff0(P, ph[j], int(ref.expected_decode(want[j], P.k_pt)))
        assert int(val) == int(ref.expected_decode(want[j], P.k_pt))
    wrong, bad, share = ref.judge_answers(out.numpy()[None], want[None], c["sk"].numpy(), P.k_pt)
    assert (wrong, bad) == (0, 0) and share < 1e-6
    # one plaintext step added to byte 0 where it is produced: a wrong byte
    alt = out.clone()
    alt[0, P.rank, 0, 0] += 1 << (17 - P.k_pt)
    wrong, bad, _ = ref.judge_answers(alt.numpy()[None], want[None], c["sk"].numpy(), P.k_pt)
    assert (wrong, bad) == (1, 1)
    # an answer cut to its top limb: right bytes, the noise of 2^-17
    cut = out.clone()
    cut[..., 1:, :] = 0
    _, _, share_cut = ref.judge_answers(cut.numpy()[None], want[None], c["sk"].numpy(), P.k_pt)
    assert share_cut > 100 * share


def test_expected_decode_is_the_signed_byte_modulo_2_k():
    assert list(ref.expected_decode(np.array([0, 1, 127, 128, 255]), 9)) == [0, 1, 127, -128, -1]
    assert list(ref.expected_decode(np.array([3, 4, 5, 255]), 3)) == [3, -4, -3, -1]
    assert list(ref.expected_decode(np.arange(256), 3)) == [
        int(glwe.cast_u8_signed(v, 3)) for v in range(256)]


def test_the_reference_imports_nothing_of_the_program():
    import ast
    from pathlib import Path

    tree = ast.parse((Path(ref.__file__)).read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert names == {"__future__", "numpy"}
    assert torch.__name__  # the test itself may import the program and torch
