"""End-to-end FHE-RAM demo of the port: keygen -> encrypt RAM -> encrypted
read -> read_prepare_write -> write -> read-back -> an untouched
neighbour, with wall timers, decode checks and the worst noise; the
counterpart of the JAX package's examples/fhe_ram_demo.py.

    python -m fhe_ram_tpu_torch.examples.fhe_ram_demo --config 2_14              # the card
    python -m fhe_ram_tpu_torch.examples.fhe_ram_demo --config 2_14 --composed   # composed routes
    python -m fhe_ram_tpu_torch.examples.fhe_ram_demo --device cpu --config small

--config small / 2_14 / 2_18 / 2_18r runs PARAMS_TEST_SMALL /
PARAMS_CODE_2_14 (the upstream's committed-code default: 2^14 words of 4
bytes, k_pt = 3, chained CMux digits) / PARAMS_2_18_TURBO_READOPT /
PARAMS_2_18_READOPT.  The device is the card unless --device cpu is given:
a missing card raises, and nothing moves to the CPU on its own (the CUDA
kernels take N = 4096 only, so `small`, N = 64, runs with --device cpu).
--composed is the counterpart of running the JAX demo under FHERAM_MXU=0:
client and server on a two-pass context (FheRam(composed=True)), the same
integers as the default route.

Wall timers are the host clock around each call, synchronized on the card;
the kernels are built before the first timer starts.  `run` returns the
decoded values, the worst noise, the times, and the ciphertexts it decoded
(read-outs, the pending state after read_prepare_write, the new RAM), so a
caller can hold two runs bit for bit.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from fhe_ram_tpu_torch import params as params_mod  # noqa: E402
from fhe_ram_tpu_torch.core import glwe, keys as keys_mod, rng  # noqa: E402
from fhe_ram_tpu_torch.ops import ntt_cuda  # noqa: E402
from fhe_ram_tpu_torch.ops.ntt import get_ntt_context  # noqa: E402
from fhe_ram_tpu_torch.ram import address as address_mod  # noqa: E402
from fhe_ram_tpu_torch.ram import ram as ram_mod  # noqa: E402

CONFIGS = {"small": "PARAMS_TEST_SMALL", "2_14": "PARAMS_CODE_2_14",
           "2_18": "PARAMS_2_18_TURBO_READOPT", "2_18r": "PARAMS_2_18_READOPT"}


def run(config: str, device="cuda", seed: int = 0, composed: bool = False) -> dict:
    """The demo's flow at CONFIGS[config] on `device`, the client's
    randomness from `seed` (the same seed gives the same keys, RAM, address
    and words on either route and device).  Raises where a byte decodes
    wrong or its noise is over 2^-(k_pt+1).  Returns a dict: "values"
    (each step's decoded bytes), "worst_noise_log2" (by step), "seconds"
    and "launches" (kernel launches by wrapper, ops.ntt_cuda.LAUNCHES) of
    each timed step, "tensors" (read, rpw_out, rpw_data, rpw_tree,
    new_data, read_back, neighbour) and the run's settings."""
    dev = ntt_cuda.require_device(device)
    par = getattr(params_mod, CONFIGS[config])
    W = par.word_size
    print(f"config: {config}  (max_addr=2^{par.max_addr.bit_length() - 1}, "
        f"word={W} bytes, N={par.n}{', composed' if composed else ''})")
    print("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    seconds, launches = {}, {}

    def timed(what, fn):
        """fn() with its wall time and its kernel launches by wrapper."""
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        before = dict(ntt_cuda.LAUNCHES)
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds[what] = time.perf_counter() - t0
        launches[what] = {k: v - before[k] for k, v in ntt_cuda.LAUNCHES.items()
                          if v != before[k]}
        return out

    if dev.type == "cuda":
        timed("build", ntt_cuda.ensure_built)
        print(f"build: {seconds['build']:.1f}s")

    # --- client side: keys + data
    ctx = get_ntt_context(par.n, par.primes, "two_pass" if composed else "radix2")
    src = rng.Source(seed)
    sk = rng.ternary_secret(src.split(), par.rank, par.n, par.xs_density, device=dev)
    s_ntt = glwe.secret_prepare(ctx, sk)
    ekp = timed("keygen", lambda: keys_mod.prepare(par, keys_mod.keygen(par, sk, src)))
    print(f"keygen: {seconds['keygen']:.1f}s")
    rnd = np.random.default_rng(seed + 7)
    data = rnd.integers(0, 256, size=par.max_addr * W).astype(np.uint8)
    ram_ct = timed("encrypt_ram", lambda: ram_mod.encrypt_ram(par, ctx, s_ntt, data, src))
    print(f"encrypt RAM ({par.max_addr * W} bytes): {seconds['encrypt_ram']:.1f}s")
    idx = int(rnd.integers(0, par.max_addr))
    addr = address_mod.encrypt(par, ctx, s_ntt, idx, src)
    ap_ = address_mod.prepare(ctx, addr)
    values, noise = {}, {}

    def decode_word(out, want_bytes, tag):
        ph = glwe.phase(par, ctx, s_ntt, out)
        got, worst = [], -1e9
        for i in range(W):
            want = glwe.cast_u8_signed(int(want_bytes[i]), par.k_pt)
            val, nz = glwe.decode_coeff0(par, ph[i], want)
            if int(val) != want or not nz < -(par.k_pt + 1):
                raise RuntimeError(f"{tag}: byte {i} decoded {int(val)} (noise "
                                   f"2^{float(nz):.2f}), stored {want}")
            got.append(int(val))
            worst = max(worst, float(nz))
        values[tag], noise[tag] = got, worst
        print(f"{tag}: CORRECT (worst noise 2^{worst:.1f})")

    # --- server side
    server = ram_mod.FheRam(par, ekp, device=dev, composed=composed)
    state = server.init_state(ram_ct)
    old = data[idx * W: (idx + 1) * W]

    out = timed("read", lambda: server.read(state, ap_))
    print(f"read (wall): {seconds['read'] * 1e3:.1f}ms")
    decode_word(out, old, "read")

    out2, pending = timed("read_prepare_write", lambda: server.read_prepare_write(state, ap_))
    print(f"read_prepare_write (wall): {seconds['read_prepare_write'] * 1e3:.1f}ms")
    decode_word(out2, old, "read_prepare_write")

    new_word = rnd.integers(0, 256, size=W).astype(np.uint8)
    w_ct = ram_mod.encrypt_write_word(par, ctx, s_ntt, new_word, src)
    state = timed("write", lambda: server.write(pending, w_ct, addr))
    print(f"write (wall): {seconds['write'] * 1e3:.1f}ms")

    out3 = server.read(state, ap_)
    decode_word(out3, new_word, "read-back after write")

    other = (idx + 1) % par.max_addr
    ap2 = address_mod.prepare(ctx, address_mod.encrypt(par, ctx, s_ntt, other, src))
    out4 = server.read(state, ap2)
    decode_word(out4, data[other * W: (other + 1) * W], "untouched neighbor")
    print("DEMO OK")
    return {"config": config, "preset": CONFIGS[config], "device": str(dev),
            "composed": composed, "seed": seed, "address": idx, "neighbour": other,
            "written": [int(b) for b in new_word], "values": values,
            "worst_noise_log2": noise, "noise_bound_log2": -(par.k_pt + 1),
            "seconds": seconds, "launches": launches,
            "tensors": {"read": out, "rpw_out": out2, "rpw_data": pending.data,
                        "rpw_tree": pending.tree, "new_data": state.data,
                        "read_back": out3, "neighbour": out4}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="2_14", choices=sorted(CONFIGS))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default: a missing card raises) or cpu "
                         "(the plain versions)")
    ap.add_argument("--composed", action="store_true",
                    help="the composed routes (a two-pass context), the "
                         "counterpart of the JAX demo under FHERAM_MXU=0")
    args = ap.parse_args()
    run(args.config, args.device, composed=args.composed)


if __name__ == "__main__":
    main()
