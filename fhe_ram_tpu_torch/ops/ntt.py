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

Two transform bodies (csrc/fhe_core.cuh) give the same integers, spectra
included, so keys prepared under one serve the other; kernel 12
(external.cu) is built in both, and the transform and fold kernels run
the fold body's radix-16 transforms (csrc/fold_body.cuh), one build for
both.  A context names its body, and with it the RAM's routes:

  "radix2"    the RAM routes each pack merge, trace and split level
              through its fused kernel (fused_path_active(ctx) is True).
  "two_pass"  the 64 x 64 block in two passes, columns then rows (the
              counterpart of the JAX package's FHERAM_MXU=0 body): the RAM
              takes its composed routes, a merge, a trace step or a split
              level torch glue around one fold launch.  The counterpart of
              FHERAM_MXU=0, which fixes body and routing together too.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .modular import I32, I64, prime_consts, to_canonical

BODIES = ("radix2", "two_pass")


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


def _shoup_pairs(ws, p: int) -> list[int]:
    """[w0, w0', w1, w1', ...], w' = floor(w * 2^32 / p): x * w mod p is then
    x * w - floor(x * w' / 2^32) * p, in [0, 2p) for any x < 2^32."""
    out = []
    for w in ws:
        out += [int(w), (int(w) << 32) // p]
    return out


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
    device.  `body`: the kernels' transform body (module docstring); the
    tables do not depend on it."""

    def __init__(self, n: int, primes: tuple[int, ...], body: str = "radix2"):
        if body not in BODIES:
            raise ValueError(f"transform body {body!r}: one of {BODIES}")
        self.body = body
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
        self._shoup = {}

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

    # the fold kernel's tables (csrc/fold.cu FoldTables), in this order;
    # pairs per prime
    SHOUP_TABLES = (("fwd", 4096), ("inv", 4096), ("psi_lo", 256),
                    ("psi_hi", 16), ("ipsi_lo", 256), ("ipsi_hi", 16))

    def shoup_tables(self, device):
        """The fold kernel's constants as Shoup pairs (w, floor(w * 2^32 /
        p)), w canonical, wired for n = 4096 and three primes.  Returns
        (int32[words] on `device`, the uint32 bit patterns; {name: word
        offset}).  Per prime, back to back: fwd and inv the stage tables
        above, psi_lo[j] = psi^j, psi_hi[r] = psi^(256 r), ipsi_lo[j] =
        psi^-j / n, ipsi_hi[r] = psi^-(256 r) (so psi^i, i = j + 256 r, is
        psi_lo[j] * psi_hi[r]); then "garner", three pairs: p1^-1 mod p2,
        p1 mod p3, (p1 p2)^-1 mod p3, each against its own prime."""
        from .crt import garner_consts

        key = torch.device(device)
        if key not in self._shoup:
            if self.n != 4096 or len(self.primes) != 3:
                raise ValueError("the fold's tables are wired for n = 4096 and 3 primes")
            rows, offsets, at = {}, {}, 0
            for pi, p in enumerate(self.primes):
                psi = int(self.psi[pi, 1])
                ipsi = pow(psi, p - 2, p)
                inv_n = int(self.inv_psi[pi, 0])
                rows.setdefault("fwd", []).append(self.fwd_tw[pi].tolist())
                rows.setdefault("inv", []).append(self.inv_tw[pi].tolist())
                rows.setdefault("psi_lo", []).append(
                    [pow(psi, j, p) for j in range(256)])
                rows.setdefault("psi_hi", []).append(
                    [pow(psi, 256 * r, p) for r in range(16)])
                rows.setdefault("ipsi_lo", []).append(
                    [pow(ipsi, j, p) * inv_n % p for j in range(256)])
                rows.setdefault("ipsi_hi", []).append(
                    [pow(ipsi, 256 * r, p) for r in range(16)])
            words = []
            for name, size in self.SHOUP_TABLES:
                offsets[name] = at
                for pi, p in enumerate(self.primes):
                    words += _shoup_pairs(rows[name][pi], p)
                at += 2 * size * len(self.primes)
            g = garner_consts(self.primes)
            p1, p2, p3 = self.primes
            offsets["garner"] = at
            words += (_shoup_pairs([g["c12"]], p2) + _shoup_pairs([g["p1_mod_p3"]], p3)
                      + _shoup_pairs([g["c123"]], p3))
            w = torch.tensor(words, dtype=I64)
            self._shoup[key] = (torch.where(w >= 1 << 31, w - (1 << 32), w)
                                .to(device=device, dtype=I32), offsets)
        return self._shoup[key]


@lru_cache(maxsize=8)
def get_ntt_context(n: int, primes: tuple[int, ...],
                    body: str = "radix2") -> NTTContext:
    return NTTContext(n, tuple(primes), body)


def fused_path_active(ctx: NTTContext) -> bool:
    """True when the RAM routes through the fused merge, trace and split
    kernels (the radix-2 body), False for its composed routes (the
    two-pass body).  Counterpart of ntt_pallas.fused_path_active."""
    return ctx.body == "radix2"


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
