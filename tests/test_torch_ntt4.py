"""The PyTorch port's four-step NTT (ops/ntt4.py) on the CPU, held by its
round trip, against the port's ops/ntt.py and against the JAX package's
ops/ntt4.py (called directly, jitted without XLA's optimisation passes; the
global backend switch of the JAX package is never touched).  Integer
arithmetic: np.array_equal."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

from fhe_ram_tpu.ops import ntt4 as jntt4
from fhe_ram_tpu.ops.modular import mul_mod as jmul_mod

from fhe_ram_tpu_torch.params import DEFAULT_PRIMES
from fhe_ram_tpu_torch.ops import ntt4, ntt as tntt
from fhe_ram_tpu_torch.ops.modular import I64, prime_consts, to_canonical

torch.set_num_threads(1)

# XLA without its optimisation passes, in one piece, with the loop emitters:
# the same integers for less compile time (the suite's workers share cores)
_jit = functools.partial(jax.jit, compiler_options={
    "xla_backend_optimization_level": 0,
    "xla_cpu_parallel_codegen_split_count": 1,
    "xla_cpu_use_fusion_emitters": False})

N = 4096


def _mul(ctx, a, b):
    p = prime_consts(ctx.primes, a.dim())
    return torch.remainder(a.to(I64) * b.to(I64), p).to(torch.int32)


def test_ntt4_round_trip_convolution_and_the_reference():
    rnd = np.random.default_rng(4)
    for n in (64, 256, N):                           # the round trip, any int32
        ctx = ntt4.get_ntt4_context(n, DEFAULT_PRIMES)
        x = torch.from_numpy(rnd.integers(-(2 ** 31), 2 ** 31, size=(3, n)).astype(np.int32))
        back = ntt4.ntt4_inv(ctx, ntt4.ntt4_fwd(ctx, x))
        for pi, p in enumerate(DEFAULT_PRIMES):
            assert torch.equal(back[pi], to_canonical(x, p).to(torch.int32)), (n, p)

    a = rnd.integers(-(2 ** 16), 2 ** 16, size=(2, N)).astype(np.int32)
    b = rnd.integers(-(2 ** 16), 2 ** 16, size=(2, N)).astype(np.int32)
    jctx = jntt4.get_ntt4_context(N, DEFAULT_PRIMES)

    @_jit
    def reference(a_, b_):
        A, B = jntt4.ntt4_fwd(jctx, a_), jntt4.ntt4_fwd(jctx, b_)
        p, ip = jctx.consts(A.ndim)
        return A, jntt4.ntt4_inv(jctx, jmul_mod(A, B, p, ip))
    j_spec, j_conv = (np.array(v) for v in reference(jnp.asarray(a), jnp.asarray(b)))

    ctx = ntt4.get_ntt4_context(N, DEFAULT_PRIMES)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    A = ntt4.ntt4_fwd(ctx, ta)
    conv4 = ntt4.ntt4_inv(ctx, _mul(ctx, A, ntt4.ntt4_fwd(ctx, tb)))
    nctx = tntt.get_ntt_context(N, DEFAULT_PRIMES)
    conv = tntt.ntt_inv(nctx, _mul(nctx, tntt.ntt_fwd(nctx, ta), tntt.ntt_fwd(nctx, tb)))
    assert conv4.shape == conv.shape == (3, 2, N)
    p = prime_consts(DEFAULT_PRIMES, 3)
    assert torch.equal(conv4, conv)                  # both centered: the residues
    assert np.array_equal(conv4.numpy(), to_canonical(torch.from_numpy(j_conv), p).numpy())
    # the spectra themselves, in the reference's (k1, k2) order
    assert np.array_equal(A.numpy(), to_canonical(torch.from_numpy(j_spec), p).numpy())
