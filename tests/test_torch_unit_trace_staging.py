"""The digit loads and the base of a trace step on the fold body
(csrc/fold_body.cuh trace_step and TraceBase, which kernels 3 and 6
run): each block stages digit poly tt = (mask component tt / Td,
limb tt % Td) of the step's input in shared memory, thread t loading the
16-byte units t + 256 q, and forward() gathers the staged word
sigma_src(i) with sigma's sign for its coefficients i = t | r << 8
(layout L0); the base is the input plus sigma_g(input) at the b
component.
Emulated at N = 4096 against the digits and the base that
ops/ntt_cuda.trace_step hands its fold, bit for bit, at the twelve
galois elements of the trace with the read's truncated gadget and with
the full one; every staged word is written once, and a warp's 32
gathers hit 32 distinct banks.  The CPU tests never launch the kernel;
this is its only check here.

One test a file on purpose: with `--dist loadfile` pytest-xdist hands files
out in order of their test count, so single-test files go last; a row of
millisecond files before the suite's longest single test lets it start on
a worker that is really free (ROADMAP.md, "Time budget")."""

import re
from pathlib import Path

import numpy as np
import torch

from fhe_ram_tpu_torch.ops import ntt_cuda, poly
from fhe_ram_tpu_torch.params import PARAMS_2_18_TURBO_READOPT as PAR

SRC = (Path(ntt_cuda.__file__).resolve().parent.parent / "csrc" / "fold_body.cuh").read_text()
THREADS = int(re.search(r"#define FOLD_THREADS (\d+)", SRC).group(1))
N = int(re.search(r"#define FOLD_N (\d+)", SRC).group(1))


def sigma_src(i, ginv):
    """fhe_core.cuh sigma_src: (source word, sign flip) of sigma_g at i."""
    i0 = (ginv * i) & (2 * N - 1)
    return i0 & (N - 1), i0 >= N


def test_trace_step_staging_gather_and_base_match_trace_step():
    C2, L = PAR.rank + 1, PAR.limbs_ct
    ct = torch.from_numpy(np.random.default_rng(5).integers(
        -(1 << 16), 1 << 16, size=(1, C2, L, N)).astype(np.int32))
    polys = ct[0].numpy().astype(np.int64)
    t = np.arange(THREADS)[:, None]
    units = t + THREADS * np.arange(N // 4 // THREADS)          # thread t's int4 loads
    words = (4 * units[..., None] + np.arange(4)).reshape(-1)
    assert np.array_equal(np.bincount(words, minlength=N), np.ones(N))
    i = t | (np.arange(16) << 8)                                # forward()'s layout L0
    i_all = np.arange(N)
    seen = {}

    def fold(ctx, x, keys, out_limbs, c2, base=None, sign=1):
        seen.update(x=x[0].numpy(), base=base[0].numpy(), sign=sign)

    for Td in (PAR.read_ks_trunc[0], L):
        key = torch.zeros((3, (C2 - 1) * Td, C2 * PAR.limbs_evk_trace, 1), dtype=torch.int32)
        for g in PAR.trace_gal_els:
            ntt_cuda.trace_step(None, ct, key, g, Td, fold)
            assert seen["sign"] == -1
            ginv = poly.auto_inverse(N, g)
            src, neg = sigma_src(i, ginv)
            banks = np.sort((src % 32).reshape(THREADS // 32, 32, 16), axis=1)
            assert (banks == np.arange(32)[None, :, None]).all(), g
            for tt in range((C2 - 1) * Td):
                staged = np.full(N, 1 << 40)
                staged[words] = polys[tt // Td, tt % Td][words]
                got = np.where(neg, -staged[src], staged[src])
                assert np.array_equal(got, seen["x"][tt][i]), (Td, g, tt)
            s_all, n_all = sigma_src(i_all, ginv)
            for c2 in range(C2):
                for l in range(L):
                    a = polys[c2, l]
                    want = a + (np.where(n_all, -a[s_all], a[s_all]) if c2 == C2 - 1 else 0)
                    assert np.array_equal(want, seen["base"][c2, l]), (Td, g, c2, l)
