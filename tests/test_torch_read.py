"""The slice as a whole: the PyTorch port's encrypted read against the
JAX package's, on the CPU, on the JAX client's own ciphertexts.

JAX keygen, encrypt_ram and address.encrypt at PARAMS_TEST_SMALL (two
address levels, two chained CMux digits a coordinate, a pack tree and
the full trace); convert.from_reference carries secret, keys, RAM and
addresses across; the port's FheRam.read equals read_impl bit for bit
(np.array_equal; integer arithmetic, tolerance 0), and the port's own
decrypt recovers the JAX client's plaintext under the noise bound.  The
other geometries are compared in tests/test_torch_read_presets.py."""

import numpy as np
import jax
import torch

from fhe_ram_tpu import params as jparams
from fhe_ram_tpu.ops.ntt import get_ntt_context as jget_ctx
from fhe_ram_tpu.core import glwe as jglwe
from fhe_ram_tpu.core import keys as jkeys
from fhe_ram_tpu.core import keyswitch as jks
from fhe_ram_tpu.core import rng as jrng
from fhe_ram_tpu.ram import address as jaddress
from fhe_ram_tpu.ram import ram as jram

from fhe_ram_tpu_torch import params as tparams
from fhe_ram_tpu_torch.convert import from_reference
from fhe_ram_tpu_torch.ops.ntt import get_ntt_context as tget_ctx
from fhe_ram_tpu_torch.core import glwe as tglwe
from fhe_ram_tpu_torch.core import keys as tkeys
from fhe_ram_tpu_torch.ram import address as taddress
from fhe_ram_tpu_torch.ram import ram as tram

# one intra-op thread: the suite runs several workers side by side, and
# these sizes gain nothing from more
torch.set_num_threads(1)



def _addresses(par):
    return [0, 1, par.max_addr // 2 + 3, par.max_addr - 1]


def test_read_matches_jax_on_the_jax_clients_ciphertexts():
    jpar, tpar = jparams.PARAMS_TEST_SMALL, tparams.PARAMS_TEST_SMALL
    jctx = jget_ctx(jpar.n, jpar.primes)
    src = jrng.Source(7)
    sk = jrng.ternary_secret(src.split(), jpar.rank, jpar.n, jpar.xs_density)
    js_ntt = jax.jit(lambda s: jglwe.secret_prepare(jctx, s))(sk)
    ek = jkeys.keygen(jpar, sk, src, ggsw_gal_els=())  # the read needs no GGSW key
    data = np.random.default_rng(11).integers(
        0, 256, size=jpar.max_addr * jpar.word_size).astype(np.uint8)
    ram_ct = jram.encrypt_ram(jpar, jctx, js_ntt, data, src)
    jatk = jax.jit(lambda ks: {g: jks.key_prepare(jctx, k) for g, k in ks.items()})(
        ek.atk_glwe)
    jread = jax.jit(lambda d, a, k: jram.read_impl(
        jpar, jctx, d, jaddress.prepare(jctx, a).coordinates, k))

    tctx = tget_ctx(tpar.n, tpar.primes)
    carried = from_reference(sk=np.asarray(sk), keys=ek, ram=ram_ct, device="cpu")
    assert sorted(carried.keys.atk_glwe) == sorted(ek.atk_glwe)
    assert carried.keys.tsk.shape == ek.tsk.shape
    server = tram.FheRam(tpar, tkeys.prepare(tpar, carried.keys), device="cpu")
    state = server.init_state(carried.data)
    s_ntt = tglwe.secret_prepare(tctx, carried.sk)

    W = tpar.word_size
    for idx in _addresses(jpar):
        addr = jaddress.encrypt(jpar, jctx, js_ntt, idx, src)
        want = np.asarray(jread(ram_ct, addr, jatk))
        taddr = from_reference(address=addr, device="cpu").address
        got = server.read(state, taddress.prepare(tctx, taddr))
        assert got.dtype == torch.int32 and got.shape == want.shape
        assert np.array_equal(got.numpy(), want), f"idx={idx}"
        # and the port's own decrypt reads the JAX client's plaintext
        for i in range(W):
            word = tglwe.cast_u8_signed(int(data[idx * W + i]), tpar.k_pt)
            val, noise = tglwe.decode_coeff0(
                tpar, tglwe.phase(tpar, tctx, s_ntt, got[i]), word)
            assert int(val) == word and noise < -(tpar.k_pt + 1)
