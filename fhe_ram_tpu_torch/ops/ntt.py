"""Negacyclic NTT over CRT primes, batched, exact.

Forward: DIF (natural order in, bit-reversed out); inverse: DIT
(bit-reversed in, natural out).  No bit-reversal permutation is ever
materialized: pointwise products are order-agnostic as long as data and
prepared keys share the same forward transform.

The negacyclic wrap (X^N = -1) is handled by twisting with powers of a
2N-th root of unity psi, folded into the first multiply; 1/N * psi^-k is
folded into the last.

Layout: NTT-domain tensors carry the prime axis FIRST: int32[P, ..., N].

The spectral contract of this package: `ntt_fwd_plain` fixes the spectrum
order (bit-reversed) and the residue range (canonical, [0, p)).  The CUDA
transform (ops/ntt_cuda.py, csrc/ntt.cu) matches it bit for bit, and the
fused kernels consume keys prepared by either.  `ntt_inv` returns centered
residues in [-(p-1)/2, (p-1)/2].
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .modular import I32, I64, prime_consts, to_canonical


def _primitive_root(p: int) -> int:
    """Smallest primitive root mod prime p (python ints)."""
    fac = []
    m = p - 1
    d = 2
    while d * d <= m:
        if m % d == 0:
            fac.append(d)
            while m % d == 0:
                m //= d
        d += 1
    if m > 1:
        fac.append(m)
    for g in range(2, p):
        if all(pow(g, (p - 1) // q, p) != 1 for q in fac):
            return g
    raise ValueError(f"no primitive root for {p}")


def _powers(base: int, count: int, p: int, scale: int = 1) -> np.ndarray:
    out = np.empty(count, dtype=np.int64)
    v = scale % p
    for k in range(count):
        out[k] = v
        v = v * base % p
    return out


class NTTContext:
    """Twiddle tables for degree n over a fixed 3-prime set.

    Tables are canonical residues.  Per prime:
      psi[k]      = psi^k                         (forward twist)
      inv_psi[k]  = psi^-k / n                    (inverse twist and scale)
      fwd_tw      = the DIF stages' twiddles, stage after stage: stage s
                    (half h = n >> (s+1)) holds omega^(j * n/(2h)), j < h
      inv_tw      = the DIT stages' twiddles likewise (h = 1 << s) over
                    omega^-1
    The stage tables are concatenated ([P, n], last entry unused) so a
    kernel reads each stage contiguously at offset `stage_offsets[s]`.
    Tables live on the CPU; `tables(device)` keeps one int32 copy per
    device."""

    def __init__(self, n: int, primes: tuple[int, ...]):
        self.n = n
        self.log_n = n.bit_length() - 1
        assert 1 << self.log_n == n
        self.primes = tuple(int(p) for p in primes)
        P = len(self.primes)

        psi_tab = np.zeros((P, n), dtype=np.int64)
        inv_psi_tab = np.zeros((P, n), dtype=np.int64)
        fwd_tw = np.zeros((P, n), dtype=np.int64)
        inv_tw = np.zeros((P, n), dtype=np.int64)
        self.fwd_offsets = []
        self.inv_offsets = []
        off = 0
        for h in self._fwd_halves():
            self.fwd_offsets.append(off)
            off += h
        off = 0
        for h in self._inv_halves():
            self.inv_offsets.append(off)
            off += h

        for pi, p in enumerate(self.primes):
            g = _primitive_root(p)
            psi = pow(g, (p - 1) // (2 * n), p)
            assert pow(psi, n, p) == p - 1, "psi must be a 2N-th root with psi^N=-1"
            omega = psi * psi % p
            inv_psi = pow(psi, p - 2, p)
            inv_omega = pow(omega, p - 2, p)
            inv_n = pow(n, p - 2, p)
            psi_tab[pi] = _powers(psi, n, p)
            inv_psi_tab[pi] = _powers(inv_psi, n, p, scale=inv_n)
            w = _powers(omega, n // 2, p) if n > 1 else np.ones(1, np.int64)
            wi = _powers(inv_omega, n // 2, p) if n > 1 else np.ones(1, np.int64)
            for off, h in zip(self.fwd_offsets, self._fwd_halves()):
                fwd_tw[pi, off:off + h] = w[:: n // (2 * h)][:h]
            for off, h in zip(self.inv_offsets, self._inv_halves()):
                inv_tw[pi, off:off + h] = wi[:: n // (2 * h)][:h]

        self.psi = torch.from_numpy(psi_tab)
        self.inv_psi = torch.from_numpy(inv_psi_tab)
        self.fwd_tw = torch.from_numpy(fwd_tw)
        self.inv_tw = torch.from_numpy(inv_tw)
        self._device_tables = {}

    def _fwd_halves(self):
        return [self.n >> (s + 1) for s in range(self.log_n)]

    def _inv_halves(self):
        return [1 << s for s in range(self.log_n)]

    def tables(self, device, dtype=I64):
        """(psi, inv_psi, fwd_tw, inv_tw) on `device`, each [P, n]."""
        key = (torch.device(device), dtype)
        if key not in self._device_tables:
            self._device_tables[key] = tuple(
                t.to(device=device, dtype=dtype).contiguous()
                for t in (self.psi, self.inv_psi, self.fwd_tw, self.inv_tw))
        return self._device_tables[key]

    def consts(self, ndim: int, device="cpu"):
        return prime_consts(self.primes, ndim, device)


@lru_cache(maxsize=8)
def get_ntt_context(n: int, primes: tuple[int, ...]) -> NTTContext:
    return NTTContext(n, tuple(primes))


def ntt_fwd_plain(ctx: NTTContext, x):
    """Forward negacyclic NTT in plain PyTorch (any device, any n).

    x: int32[..., N] coefficients (any int32 value; reduced first).
    Returns int32[P, ..., N] canonical residues, bit-reversed order."""
    n = ctx.n
    P = len(ctx.primes)
    lead = x.shape[:-1]
    psi, _, fwd_tw, _ = ctx.tables(x.device)
    p = ctx.consts(3, x.device)
    x = torch.remainder(x.reshape(1, -1, n).to(I64), p)  # [P, B, N]
    x = torch.remainder(x * psi[:, None, :], p)
    p4 = ctx.consts(4, x.device)
    for off, h in zip(ctx.fwd_offsets, ctx._fwd_halves()):
        nb = n // (2 * h)
        x = x.reshape(P, -1, nb, 2, h)
        u = x[..., 0, :]
        v = x[..., 1, :]
        tw = fwd_tw[:, off:off + h].reshape(P, 1, 1, h)
        s = torch.remainder(u + v, p4)
        d = torch.remainder((u - v) * tw, p4)
        x = torch.stack([s, d], dim=-2).reshape(P, -1, n)
    return x.to(I32).reshape((P,) + lead + (n,))


def ntt_inv_plain(ctx: NTTContext, x):
    """Inverse negacyclic NTT in plain PyTorch.

    x: int32[P, ..., N] residues in the forward transform's order (any
    representative).  Returns int32[P, ..., N]: the convolution result's
    coefficients mod each prime, centered."""
    n = ctx.n
    P = len(ctx.primes)
    lead = x.shape[1:-1]
    _, inv_psi, _, inv_tw = ctx.tables(x.device)
    p = ctx.consts(3, x.device)
    p4 = ctx.consts(4, x.device)
    x = torch.remainder(x.reshape(P, -1, n).to(I64), p)
    for off, h in zip(ctx.inv_offsets, ctx._inv_halves()):
        nb = n // (2 * h)
        x = x.reshape(P, -1, nb, 2, h)
        u = x[..., 0, :]
        v = x[..., 1, :]
        tw = inv_tw[:, off:off + h].reshape(P, 1, 1, h)
        t = torch.remainder(v * tw, p4)
        s = torch.remainder(u + t, p4)
        d = torch.remainder(u - t, p4)
        x = torch.stack([s, d], dim=-2).reshape(P, -1, n)
    x = to_canonical(x * inv_psi[:, None, :], p)
    return x.to(I32).reshape((P,) + lead + (n,))


def ntt_fwd(ctx: NTTContext, x):
    """Forward negacyclic NTT: int32[..., N] -> int32[P, ..., N].

    A CUDA tensor goes through the hand-written transform kernel; a CPU
    tensor through the plain version."""
    from . import ntt_cuda

    return ntt_cuda.ntt_fwd_cuda(ctx, x)


def ntt_inv(ctx: NTTContext, x):
    """Inverse negacyclic NTT: int32[P, ..., N] -> centered residues
    int32[P, ..., N].  Device dispatch as in `ntt_fwd`."""
    from . import ntt_cuda

    return ntt_cuda.ntt_inv_cuda(ctx, x)
