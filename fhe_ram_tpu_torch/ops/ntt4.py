"""Four-step negacyclic NTT: N = R1 x R2 (64 x 64 for N = 4096).

Counterpart of fhe_ram_tpu/ops/ntt4.py, the JAX package's fourstep
backend.  After the psi twist, the cyclic DFT factors into

    Z[k1, j]  = sum_i y[i, j] * w1^(i k1)        (a matmul over the rows)
    Z'[k1, j] = Z[k1, j] * omega^(j k1)          (the twiddle)
    F[k1, k2] = sum_j Z'[k1, j] * w2^(j k2)      (a matmul over the columns)

with w1 = omega^R2 and w2 = omega^R1, primitive R1-th and R2-th roots.
The spectrum comes out in (k1, k2) order, the reference's.

The reference splits both operands of its matmuls into signed 7-bit digits
so that the MXU's float32 products are exact: a TPU workaround the port
does not copy.  Here a modular matmul is one float64 matmul of canonical
residues: every product is below p^2 < 2^40 and a sum of at most 128 of
them below 2^47 < 2^53, so every partial sum is an integer that float64
holds exactly, in any order of summation, on the CPU and on the card
(which has no int64 matmul); the sums are then reduced in int64.

This is not a backend of ops/ntt.py, as the reference's FHERAM_NTT is of
its ntt.py: the port's kernels take spectra in ntt_fwd_plain's
(bit-reversed) order, so keys prepared in this order would feed them
wrong products.  A spectrum of this module is multiplied only with another
of this module and brought back by ntt4_inv; the convolution residues that
come back, in coefficient order, are ops/ntt's.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .modular import I32, I64, prime_consts, to_canonical
from .ntt import _primitive_root

F64 = torch.float64


class NTT4Context:
    """The four-step tables for degree n over a fixed prime set, canonical
    residues, on the CPU; `tables(device)` keeps one copy a device."""

    def __init__(self, n: int, primes: tuple[int, ...]):
        self.n = n
        self.primes = tuple(int(p) for p in primes)
        log_n = n.bit_length() - 1
        self.r1 = 1 << (log_n // 2)      # rows (i, k1)
        self.r2 = n // self.r1           # columns (j, k2)
        r1, r2 = self.r1, self.r2
        if r1 * r2 != n or max(r1, r2) > 128:
            raise ValueError(f"n = {n}: a power of two up to 2^14")
        P = len(self.primes)
        tabs = {k: np.zeros(s, dtype=np.int64) for k, s in (
            ("twist", (P, n)), ("inv_twist", (P, n)), ("W1", (P, r1, r1)),
            ("W1i", (P, r1, r1)), ("W2", (P, r2, r2)), ("W2i", (P, r2, r2)),
            ("TW", (P, r1, r2)), ("TWi", (P, r1, r2)))}
        a1, a2 = np.arange(r1), np.arange(r2)
        for pi, p in enumerate(self.primes):
            psi = pow(_primitive_root(p), (p - 1) // (2 * n), p)
            if pow(psi, n, p) != p - 1:
                raise ValueError(f"no 2N-th root of -1 mod {p}")
            om = psi * psi % p
            iom, ipsi, inv_n = pow(om, p - 2, p), pow(psi, p - 2, p), pow(n, p - 2, p)

            def powers(base, exps, scale=1):
                return np.array([pow(base, int(e), p) * scale % p for e in exps.ravel()],
                                dtype=np.int64).reshape(exps.shape)
            tabs["twist"][pi] = powers(psi, np.arange(n))
            tabs["inv_twist"][pi] = powers(ipsi, np.arange(n), inv_n)
            tabs["W1"][pi] = powers(pow(om, r2, p), np.outer(a1, a1))
            tabs["W1i"][pi] = powers(pow(iom, r2, p), np.outer(a1, a1))
            tabs["W2"][pi] = powers(pow(om, r1, p), np.outer(a2, a2))
            tabs["W2i"][pi] = powers(pow(iom, r1, p), np.outer(a2, a2))
            tabs["TW"][pi] = powers(om, np.outer(a1, a2))
            tabs["TWi"][pi] = powers(iom, np.outer(a1, a2))
        self._host = {k: torch.from_numpy(v) for k, v in tabs.items()}
        self._device = {}

    def tables(self, device) -> dict:
        """{name: table} on `device`: the twists int64, the matmul
        operands W1, W1i, W2, W2i float64, the twiddles TW, TWi int64."""
        key = torch.device(device)
        if key not in self._device:
            self._device[key] = {
                k: v.to(device=device, dtype=F64 if k[0] == "W" else I64)
                for k, v in self._host.items()}
        return self._device[key]


@lru_cache(maxsize=8)
def get_ntt4_context(n: int, primes: tuple[int, ...]) -> NTT4Context:
    return NTT4Context(n, tuple(primes))


def _matmul_mod(x, w, p):
    """x int64[P, B, m, k] canonical, w float64[P, k, r] canonical ->
    (x @ w) mod p, int64[P, B, m, r] canonical, exactly (module
    docstring)."""
    return torch.remainder(torch.matmul(x.to(F64), w[:, None]).to(I64), p)


def ntt4_fwd(ctx: NTT4Context, x):
    """x: int32[..., N] (any value) -> int32[P, ..., N] centered residues,
    (k1, k2) order."""
    n, r1, r2, P = ctx.n, ctx.r1, ctx.r2, len(ctx.primes)
    lead = x.shape[:-1]
    t = ctx.tables(x.device)
    p3, p4 = prime_consts(ctx.primes, 3, x.device), prime_consts(ctx.primes, 4, x.device)
    y = torch.remainder(x.reshape(1, -1, n).to(I64), p3)
    y = torch.remainder(y * t["twist"][:, None], p3).reshape(P, -1, r1, r2)
    z = _matmul_mod(y.transpose(-1, -2), t["W1"], p4).transpose(-1, -2)  # [P, B, k1, j]
    z = torch.remainder(z * t["TW"][:, None], p4)
    f = _matmul_mod(z, t["W2"], p4)                                        # [P, B, k1, k2]
    return to_canonical(f, p4).to(I32).reshape((P,) + lead + (n,))


def ntt4_inv(ctx: NTT4Context, x):
    """Inverse of ntt4_fwd, its order included: int32[P, ..., N] residues
    (any representative) -> the convolution's coefficients mod each prime,
    int32[P, ..., N] centered."""
    n, r1, r2, P = ctx.n, ctx.r1, ctx.r2, len(ctx.primes)
    lead = x.shape[1:-1]
    t = ctx.tables(x.device)
    p3, p4 = prime_consts(ctx.primes, 3, x.device), prime_consts(ctx.primes, 4, x.device)
    u = torch.remainder(x.reshape(P, -1, r1, r2).to(I64), p4)
    u = _matmul_mod(u, t["W2i"], p4)                                       # [P, B, k1, j]
    u = torch.remainder(u * t["TWi"][:, None], p4)
    y = _matmul_mod(u.transpose(-1, -2), t["W1i"], p4).transpose(-1, -2)  # [P, B, i, j]
    y = to_canonical(y.reshape(P, -1, n) * t["inv_twist"][:, None], p3)
    return y.to(I32).reshape((P,) + lead + (n,))
