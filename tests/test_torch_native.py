"""The PyTorch port's arithmetic held against the C++ golden model
(fhe_ram_tpu_torch/utils/native.py over fhe_ram_tpu_torch/native/, exact
__int128 arithmetic), on the CPU: the convolution through the port's NTT
and its Garner fold at N = 4096, at the worst case of the fold's bound,
|conv| = 2^47 (8 digit rows, |digit|, |key limb| <= 2^16); the RAM's byte
(de)interleaving against numpy; the source copy against the repository's
native/ file; a build that fails raises."""

from pathlib import Path

import numpy as np
import pytest
import torch

from fhe_ram_tpu_torch.params import DEFAULT_PRIMES
from fhe_ram_tpu_torch.ops import crt, ntt as tntt
from fhe_ram_tpu_torch.ops.modular import I64, prime_consts
from fhe_ram_tpu_torch.utils import native

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
N, T = 4096, 8


def test_convolution_and_garner_fold_equal_the_golden_model():
    assert native.available()
    ctx = tntt.get_ntt_context(N, DEFAULT_PRIMES)
    p = prime_consts(DEFAULT_PRIMES, 3)
    rnd = np.random.default_rng(47)
    # T digit rows against T key rows: all at +2^16, the bound's worst case
    # (coefficient N - 1 is T * N * 2^32 = 2^47), then random in [-2^16, 2^16]
    cases = [np.full((2, T, N), 1 << 16, dtype=np.int64),
             rnd.integers(-(1 << 16), (1 << 16) + 1, size=(2, T, N))]
    for case, (a, b) in enumerate(cases):
        want = sum(native.negacyclic_conv(a[t], b[t]) for t in range(T))
        if case == 0:
            assert int(want[N - 1]) == 1 << 47 == int(np.abs(want).max())
        A = tntt.ntt_fwd(ctx, torch.from_numpy(a.astype(np.int32)))    # [P, T, N]
        B = tntt.ntt_fwd(ctx, torch.from_numpy(b.astype(np.int32)))
        spec = torch.remainder((A.to(I64) * B.to(I64)).sum(dim=1), p[:, 0])
        res = tntt.ntt_inv(ctx, spec.to(torch.int32))                    # [P, N]
        for pi, q in enumerate(DEFAULT_PRIMES):
            assert np.array_equal((res[pi].numpy().astype(np.int64) - want) % q,
                                  np.zeros(N, np.int64)), q
        digits = crt.int_digits9(DEFAULT_PRIMES, *crt.garner_digits(DEFAULT_PRIMES, res))
        got = torch.stack(digits, dim=-1).numpy()                          # [N, 8]
        r = res.numpy()
        assert np.array_equal(got, native.garner3_digits(r[0], r[1], r[2], DEFAULT_PRIMES,
                                                         9, 8))
        back = sum(got[:, k].astype(object) << (9 * k) for k in range(8))
        assert [int(v) for v in back] == [int(v) for v in want]


def test_interleave_source_copy_and_failed_build(tmp_path):
    rnd = np.random.default_rng(2)
    data = rnd.integers(0, 256, size=64 * 4).astype(np.uint8)
    got = native.deinterleave_i8(data, 64, 4)
    assert np.array_equal(got, data.reshape(64, 4).astype(np.int8).astype(np.int32).T)
    assert np.array_equal(native.interleave_u8(got, 64, 4), data)
    with pytest.raises(ValueError):
        native.deinterleave_i8(data[:-1], 64, 4)
    assert native.SOURCE.read_bytes() == (ROOT / "native" / "fheram_native.cpp").read_bytes()
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" int f( {")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build(bad)
