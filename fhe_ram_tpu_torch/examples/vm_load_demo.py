"""Encrypted VM LOAD demo on the PyTorch/CUDA port.

Every value stays encrypted; the server learns nothing:

    encrypt RAM  ->  encrypted READ at an encrypted address
                 ->  homomorphic BIT DECOMPOSITION of the fetched bytes
                     (vm/bitdecomp.py: sign bootstrapping)
                 ->  the loaded word as a bit-sliced FheUint and prepared
                     GGSW bits
                 ->  the prepared bits consumed: selects of an encrypted
                     value, and (on the toy ring) an ALU op, ADD

    python3 fhe_ram_tpu_torch/examples/vm_load_demo.py               # the GPU
    python3 fhe_ram_tpu_torch/examples/vm_load_demo.py --device cpu  # CPU

On the GPU it runs at PARAMS_2_18_TURBO_READOPT (2^18 words of 4 bytes,
N = 4096; the bootstrapping key is 8192 GGSWs with a gadget of 5 limbs,
7.5 GiB on the card, made in about a minute by the client): 32-bit words,
and a select of an encrypted 3 by lifted bits 0, 7, 13 and 31, as the
reference's production check does.  On the CPU it runs the plain versions at a toy
ring (N = 64, 4-bit bytes, 2-byte words: 8-bit words) in seconds, and
feeds the loaded word to the ALU's ADD.  The CUDA kernels take N = 4096
only, so the toy ring runs on the CPU only.  At N = 4096 the ADD is
attempted too and its result and noise are printed, not checked: a lifted
bit's select already sits near the 2^-(k_pt+1) bound (its truncated
2-digit gadget), and the carry chain runs a 32-step chain of such CMuxes.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

from fhe_ram_tpu_torch.params import Params, PARAMS_2_18_TURBO_READOPT  # noqa: E402
from fhe_ram_tpu_torch.ops.ntt import get_ntt_context  # noqa: E402
from fhe_ram_tpu_torch.ops.ntt_cuda import require_device  # noqa: E402
from fhe_ram_tpu_torch.core import ggsw, glwe, keys, rng  # noqa: E402
from fhe_ram_tpu_torch.ram import address as address_mod, ram as ram_mod  # noqa: E402
from fhe_ram_tpu_torch.vm import arithmetic, bitdecomp, fheuint  # noqa: E402

TOY = Params(log_n=6, k_pt=4, decomp_n=(3, 3), word_size=2, max_addr=1 << 8)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; N = 4096) or cpu (a toy ring)")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    dev = require_device(args.device)
    if dev.type == "cuda":
        par, byte_bits, key_limbs, idx = PARAMS_2_18_TURBO_READOPT, 8, 5, 4242
        select_bits = (0, 7, 13, 31)
    else:
        par, byte_bits, key_limbs, idx = TOY, 4, None, 42
        select_bits = range(byte_bits * par.word_size)
    bits = byte_bits * par.word_size
    mask = (1 << bits) - 1

    t0 = time.time()
    ctx = get_ntt_context(par.n, par.primes)
    src = rng.Source(args.seed)
    sk = rng.ternary_secret(src.split(), par.rank, par.n, par.xs_density, device=dev)
    s_ntt = glwe.secret_prepare(ctx, sk)
    ekp = keys.prepare(par, keys.keygen(par, sk, src))
    bsk = bitdecomp.bootstrap_key_fast(par, ctx, sk, s_ntt, src, limbs=key_limbs)
    print(f"[{time.time() - t0:6.1f}s] keys + bootstrapping key "
          f"({bsk.numel() * 4 / 2**30:.2f} GiB) ready")

    # a RAM whose word at idx holds `value` (bytes stored as the RAM stores
    # them: signed at the byte width, decomposed back to the unsigned bits)
    rnd = np.random.default_rng(args.seed)
    data = rnd.integers(0, 1 << byte_bits, size=par.max_addr * par.word_size).astype(np.uint8)
    value = int(rnd.integers(0, 1 << bits))
    for i in range(par.word_size):
        data[idx * par.word_size + i] = (value >> (byte_bits * i)) & ((1 << byte_bits) - 1)
    server = ram_mod.FheRam(par, ekp, device=dev)
    state = server.init_state(ram_mod.encrypt_ram(par, ctx, s_ntt, data, src))
    print(f"[{time.time() - t0:6.1f}s] RAM encrypted "
          f"({par.max_addr} x {par.word_size} bytes)")

    ap_ = address_mod.prepare(ctx, address_mod.encrypt(par, ctx, s_ntt, idx, src))
    fetched = server.read(state, ap_)
    print(f"[{time.time() - t0:6.1f}s] encrypted read done")

    word, prepared = bitdecomp.load_word(par, ctx, fetched, bsk, ekp, bits=bits)
    got = fheuint.decrypt_word(par, ctx, s_ntt, word, bits)
    print(f"[{time.time() - t0:6.1f}s] LOAD: decrypt_word = {got:#x} "
          f"(expected {value:#x})")
    assert got == value

    # the prepared bits select an encrypted m: b * m
    m = 3
    mv = np.zeros(par.n, dtype=np.int64)
    mv[0] = m
    ct_m = glwe.encrypt(par, ctx, s_ntt, glwe.encode_vec(par, mv, device=dev), src)
    worst = -1e9
    for j in select_bits:
        b = (value >> j) & 1
        sel = ggsw.external_product(par, ctx, ct_m, prepared[:, j])
        val, noise = glwe.decode_coeff0(par, glwe.phase(par, ctx, s_ntt, sel), b * m)
        assert int(val) == b * m and noise < -(par.k_pt + 1), (j, int(val), noise)
        worst = max(worst, float(noise))
    print(f"[{time.time() - t0:6.1f}s] selects by lifted bits {list(select_bits)} decode, "
          f"worst noise 2^{worst:.2f} (bound 2^{-(par.k_pt + 1)})")

    # the loaded word into the ALU: loaded + rhs
    rhs_val = int(rnd.integers(0, 1 << bits))
    rhs = fheuint.encrypt_prepared(par, ctx, s_ntt, rhs_val, src, bits)
    words = arithmetic._dp_group(par, ctx, ("add",), prepared, rhs, rhs, bits)
    s = fheuint.decrypt_word(par, ctx, s_ntt, words["add"], bits)
    want = (value + rhs_val) & mask
    noise = fheuint.word_noise_log2(par, ctx, s_ntt, words["add"], want, bits)
    print(f"[{time.time() - t0:6.1f}s] ALU on the loaded word: "
          f"{value:#x} + {rhs_val:#x} = {s:#x} (expected {want:#x}; worst bit "
          f"noise 2^{noise:.2f})")
    if dev.type == "cpu":
        assert s == want
    print("VM LOAD DEMO OK")


if __name__ == "__main__":
    main()
