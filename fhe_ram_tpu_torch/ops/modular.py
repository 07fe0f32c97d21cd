"""Exact modular arithmetic over the NTT primes.

Residues are canonical, in [0, p).  The plain versions widen to int64
for every product (p < 2^20, so a product of two residues is < 2^40 and
a sum of a few of them is far below 2^63) and return int32.  The CUDA
kernels (csrc/fhe_core.cuh) do the same with native 32x32->64 bit
multiplies and an integer Barrett quotient; since a canonical residue is
unique, both give the same bits.

`to_canonical` maps residues to the centered representative in
[-(p-1)/2, (p-1)/2]: the form the CRT (ops/crt.py) consumes and the form
in which convolution residues can be compared across implementations.
"""

from __future__ import annotations

import torch

I32 = torch.int32
I64 = torch.int64


def prime_consts(primes, ndim: int, device="cpu"):
    """The primes as int64[P, 1, 1, ...] for broadcasting against tensors
    whose leading axis is the prime axis and whose rank is `ndim`."""
    shape = (len(primes),) + (1,) * (ndim - 1)
    return torch.tensor(list(primes), dtype=I64, device=device).reshape(shape)


def reduce_mod(x, p):
    """x mod p in [0, p), int64 (any signed x)."""
    return torch.remainder(x.to(I64), p)


def to_canonical(x, p):
    """Centered representative of x mod p, in [-(p-1)/2, (p-1)/2], int64."""
    x = reduce_mod(x, p)
    return torch.where(x > p // 2, x - p, x)
