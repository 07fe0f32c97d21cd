"""The PyTorch port's own client (its rng, keygen, encrypt_ram,
address.encrypt) through the port's read, on the CPU.  Its random
streams differ from the JAX package's by design, so the check is the
decrypted word and the noise bound, as tests/test_ram.py checks the JAX
package.  Plus the guards of the entry points, and the port's fhe_ram_demo
(examples/fhe_ram_demo.py) at PARAMS_TEST_SMALL on both routes from one
seed: every step decodes, and the read, the rpw read-out and pending
state, the new RAM and both reads after the write are the same integers
(the read, rpw and write at this preset are held against the JAX package
in tests/test_torch_read.py and tests/test_torch_write.py)."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from fhe_ram_tpu_torch import params as tparams
from fhe_ram_tpu_torch.convert import from_reference
from fhe_ram_tpu_torch.ops.ntt import get_ntt_context as tget_ctx
from fhe_ram_tpu_torch.core import glwe as tglwe
from fhe_ram_tpu_torch.core import keys as tkeys
from fhe_ram_tpu_torch.core import rng as trng
from fhe_ram_tpu_torch.examples import fhe_ram_demo
from fhe_ram_tpu_torch.ram import address as taddress
from fhe_ram_tpu_torch.ram import ram as tram

# one intra-op thread: the suite runs several workers side by side, and
# these sizes gain nothing from more
torch.set_num_threads(1)


TRUNC = dict(read_ks_digits=2, read_ks_limbs=3,
             read_ep_digits=2, read_ep_limbs=3)
PRESETS = {
    "flat": ("PARAMS_TEST_FLAT", {}),
    "small": ("PARAMS_TEST_SMALL", {}),
    "wide": ("PARAMS_TEST_SMALL_WIDE", {}),
    "wide_trunc": ("PARAMS_TEST_SMALL_WIDE", TRUNC),
    "three_level": ("PARAMS_TEST_3LVL", {}),
}


def _addresses(par):
    return [0, 1, par.max_addr // 2 + 3, par.max_addr - 1]


def _own_client(par, seed=7):
    ctx = tget_ctx(par.n, par.primes)
    src = trng.Source(seed)
    sk = trng.ternary_secret(src.split(), par.rank, par.n, par.xs_density,
                             device="cpu")
    s_ntt = tglwe.secret_prepare(ctx, sk)
    ekp = tkeys.prepare(par, tkeys.keygen(par, sk, src))
    return ctx, src, s_ntt, tram.FheRam(par, ekp, device="cpu")


@pytest.mark.parametrize("name", list(PRESETS))
def test_own_client_read_decrypts(name):
    base_name, trunc = PRESETS[name]
    par = replace(getattr(tparams, base_name), **trunc)
    ctx, src, s_ntt, server = _own_client(par)
    data = np.random.default_rng(11).integers(
        0, 256, size=par.max_addr * par.word_size).astype(np.uint8)
    state = server.init_state(tram.encrypt_ram(par, ctx, s_ntt, data, src))
    W = par.word_size
    for idx in _addresses(par):
        ap = taddress.prepare(ctx, taddress.encrypt(par, ctx, s_ntt, idx, src))
        out = server.read(state, ap)
        assert out.shape == (W, par.rank + 1, par.limbs_ct, par.n)
        for i in range(W):
            want = tglwe.cast_u8_signed(int(data[idx * W + i]), par.k_pt)
            val, noise = tglwe.decode_coeff0(
                par, tglwe.phase(par, ctx, s_ntt, out[i]), want)
            assert int(val) == want, f"{name} idx={idx} subram {i}"
            assert noise < -(par.k_pt + 1), f"{name} idx={idx} noise {noise}"


def test_own_client_rank2_read_decrypts():
    """The generic-rank paths (two mask components)."""
    par = tparams.PARAMS_TEST_RANK2
    ctx, src, s_ntt, server = _own_client(par, seed=3)
    data = np.random.default_rng(5).integers(
        0, 256, size=par.max_addr * par.word_size).astype(np.uint8)
    state = server.init_state(tram.encrypt_ram(par, ctx, s_ntt, data, src))
    idx = par.max_addr - 2
    out = server.read(state, taddress.prepare(
        ctx, taddress.encrypt(par, ctx, s_ntt, idx, src)))
    for i in range(par.word_size):
        want = tglwe.cast_u8_signed(int(data[idx * par.word_size + i]), par.k_pt)
        val, noise = tglwe.decode_coeff0(
            par, tglwe.phase(par, ctx, s_ntt, out[i]), want)
        assert int(val) == want and noise < -(par.k_pt + 1)


def test_source_is_deterministic_and_streams_differ():
    a, b, c = trng.Source(5), trng.Source(5), trng.Source(6)
    ua = trng.uniform_limbs(a.split(), (4, 64), device="cpu")
    assert torch.equal(ua, trng.uniform_limbs(b.split(), (4, 64), device="cpu"))
    assert not torch.equal(ua, trng.uniform_limbs(c.split(), (4, 64), device="cpu"))
    assert not torch.equal(ua, trng.uniform_limbs(a.split(), (4, 64), device="cpu"))
    assert int(ua.min()) >= 0 and int(ua.max()) < (1 << 17)
    sk = trng.ternary_secret(a.split(), 2, 64, 0.5, device="cpu")
    assert [int((sk[r] == v).sum()) for r in range(2) for v in (1, -1)] == [16] * 4
    e = trng.gaussian_int(a.split(), (20000,), 3.2, device="cpu").double()
    assert abs(float(e.mean())) < 0.1 and abs(float(e.std()) - 3.2) < 0.15
    with pytest.raises(ValueError):
        trng.Source(b"short")


def test_read_refuses_a_pending_state():
    par = tparams.PARAMS_TEST_FLAT
    ctx, src, s_ntt, server = _own_client(par)
    data = np.zeros(par.max_addr * par.word_size, dtype=np.uint8)
    state = server.init_state(tram.encrypt_ram(par, ctx, s_ntt, data, src))
    ap = taddress.prepare(ctx, taddress.encrypt(par, ctx, s_ntt, 0, src))
    pending = tram.RamState(data=state.data, tree=(), pending=True)
    with pytest.raises(AssertionError, match="pending write"):
        server.read(pending, ap)


def test_client_refuses_bad_inputs():
    par = tparams.PARAMS_TEST_FLAT
    ctx, src, s_ntt, _ = _own_client(par)
    for bad in (par.max_addr, -1):
        with pytest.raises(ValueError, match="address"):
            taddress.encrypt(par, ctx, s_ntt, bad, src)
    with pytest.raises(ValueError, match="payload"):
        tram.encrypt_ram(par, ctx, s_ntt, np.zeros(3, dtype=np.uint8), src)
    payload = bytes(range(par.max_addr * par.word_size))  # bytes are taken too
    assert tram.encrypt_ram(par, ctx, s_ntt, payload, src).shape[:2] == (
        par.word_size, par.num_rows)


def test_cuda_entry_points_raise_without_a_card():
    """Asked for the GPU where there is none, an entry point raises; it
    does not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    par = tparams.PARAMS_TEST_FLAT
    ctx, src, s_ntt, server = _own_client(par)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tram.FheRam(par, server.keys)  # device defaults to the GPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trng.ternary_secret(src.split(), par.rank, par.n)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tglwe.encode_vec(par, np.zeros((1, par.n), dtype=np.int32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_reference(sk=np.zeros((1, par.n), dtype=np.int32))
    from fhe_ram_tpu_torch.ops import ntt_cuda
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ntt_cuda.build_kernels()


def test_demo_decodes_on_both_routes_bit_equal():
    fused = fhe_ram_demo.run("small", device="cpu", seed=3)
    composed = fhe_ram_demo.run("small", device="cpu", seed=3, composed=True)
    assert fused["preset"] == "PARAMS_TEST_SMALL" and composed["composed"]
    steps = ["read", "read_prepare_write", "read-back after write", "untouched neighbor"]
    assert list(fused["values"]) == steps
    assert fused["values"] == composed["values"]
    assert fused["values"]["read"] == fused["values"]["read_prepare_write"]
    assert all(v < fused["noise_bound_log2"] for v in fused["worst_noise_log2"].values())
    for name, t in fused["tensors"].items():
        other = composed["tensors"][name]
        if name == "rpw_tree":
            assert len(t) == len(other) >= 1
            assert all(torch.equal(a, b) for a, b in zip(t, other)), name
        else:
            assert t.dtype == torch.int32 and torch.equal(t, other), name
    assert not torch.equal(fused["tensors"]["new_data"], fused["tensors"]["rpw_data"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fhe_ram_demo.run("small")
