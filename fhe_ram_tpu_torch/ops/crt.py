"""CRT (Garner) reconstruction of exact integer convolution results and
folding into base-2^17 torus limbs.

After `ntt_inv` we hold, per prime, the centered residues of the true
integer negacyclic-convolution coefficients.  The true integers are
bounded by T * N * 2^16 * 2^16 (T <= 8 accumulated digit convolutions)
~ 2^48 << prod(primes)/2 ~ 2^57.4, so balanced Garner mixed-radix digits
reconstruct them exactly:

    x = v1 + p1*(v2 + p2*v3),   |vi| <= (pi-1)/2.

x fits int64.  It is split into BALANCED base-2^9 digits
(d = ((t+256) & 511) - 256, carry (t-d) >> 9) and the digits are shifted
into the destination base-2^17 limb accumulator; whole digits that fall
below the last output limb are dropped, per key limb, before the limbs
are summed.  The digit split is part of the function: the balanced
digits of an integer are unique, and dropping them is not the same as
rounding the integer to a power of two.
"""

from __future__ import annotations

import math
from functools import lru_cache

import torch

from .modular import I32, I64, to_canonical

_D9 = 9           # digit width of the fold
_NDIG = 8         # base-2^9 digits covering |x| < 2^63


def accumulation_bound_log2(t_rows: int, n: int, base2k: int = 17) -> float:
    """log2 of the worst-case true-integer magnitude of one folded
    convolution accumulation: t_rows digit-row negacyclic convolutions,
    each summing n products of balanced base-2^base2k operands
    (|digit|, |key limb| <= 2^(base2k-1)).  2^47 at the full gadget
    (t_rows = 8, n = 4096).

    The exactness contract of every fold: a basis reconstructs the sums
    exactly when basis_capacity_log2(primes) exceeds this bound.  Two
    primes below 2^19.6 give ~2^37.9, under the bound at any gadget (2^45
    even at t_rows = 2), so the fold keeps three."""
    return math.log2(t_rows) + math.log2(n) + 2.0 * (base2k - 1)


def basis_capacity_log2(primes) -> float:
    """log2 of the largest integer magnitude a CRT basis reconstructs
    exactly from balanced residues: prod(primes) / 2."""
    return math.log2(math.prod(float(p) for p in primes)) - 1.0


@lru_cache(maxsize=8)
def garner_consts(primes: tuple[int, ...]):
    """Precomputed Garner constants for a 3-prime basis."""
    p1, p2, p3 = primes
    return {
        "c12": pow(p1, p2 - 2, p2),
        "c123": pow(p1 * p2 % p3, p3 - 2, p3),
        "p1_mod_p3": p1 % p3,
    }


def garner_digits(primes, r):
    """Balanced mixed-radix digits (v1, v2, v3) from residues r[P, ...]
    (any representative).  Returns three int64[...] arrays with
    |vi| <= (pi-1)/2."""
    assert len(primes) == 3, "garner wired for 3 primes"
    g = garner_consts(tuple(primes))
    p1, p2, p3 = (int(q) for q in primes)
    r1, r2, r3 = r[0].to(I64), r[1].to(I64), r[2].to(I64)
    v1 = to_canonical(r1, p1)
    v2 = to_canonical((r2 - v1) * g["c12"], p2)
    t = torch.remainder(v2 * g["p1_mod_p3"], p3)
    v3 = to_canonical((r3 - v1 - t) * g["c123"], p3)
    return v1, v2, v3


def int_digits9(primes, v1, v2, v3):
    """Expand x = v1 + p1 v2 + p1p2 v3 into balanced base-2^9 digits.

    Returns a list of _NDIG int64[...] arrays with -256 <= d < 256 and
    x == sum_k d[k] * 2^(9k)."""
    p1, p2 = int(primes[0]), int(primes[1])
    t = v1 + p1 * v2 + (p1 * p2) * v3
    half = 1 << (_D9 - 1)
    mask = (1 << _D9) - 1
    digits = []
    for _ in range(_NDIG):
        d = ((t + half) & mask) - half
        t = (t - d) >> _D9
        digits.append(d)
    return digits


def fold_int_to_limbs(digits, key_limb: int, base2k: int, out_limbs: int, acc):
    """Scatter base-2^9 digits of an integer that carries torus weight
    2^-(base2k*(key_limb+1)) into a base-2^17 limb accumulator.

    acc: list of out_limbs int32[..., N] tensors (or None), updated and
    returned.  Contributions with weight >= 1 vanish mod 1; digits finer
    than the last limb are dropped."""
    w = base2k * (key_limb + 1)
    for k, d in enumerate(digits):
        e = _D9 * k - w  # this digit has weight 2^e
        if e >= 0:
            continue
        t = (-e - 1) // base2k  # destination limb index
        if t >= out_limbs:
            continue
        s = e + base2k * (t + 1)  # 0 <= s < base2k
        add = d.to(I32) << s
        acc[t] = add if acc[t] is None else acc[t] + add
    return acc


def crt_fold(primes, conv, base2k: int, out_limbs: int):
    """Per-prime conv residues -> exact limb contributions.

    conv: int32[P, ..., Lk, N] (Lk = key limb axis).
    Returns int32[..., out_limbs, N] -- the unnormalized limb accumulator
    holding sum_l conv_int[..., l, :] * 2^-(base2k*(l+1))."""
    Lk = conv.shape[-2]
    v1, v2, v3 = garner_digits(primes, conv)
    digits = int_digits9(primes, v1, v2, v3)  # each [..., Lk, N]
    acc = [None] * out_limbs
    for l in range(Lk):
        acc = fold_int_to_limbs([d[..., l, :] for d in digits], l, base2k,
                                out_limbs, acc)
    zero = torch.zeros(v1.shape[:-2] + v1.shape[-1:], dtype=I32,
                       device=conv.device)
    return torch.stack([zero if a is None else a for a in acc], dim=-2)
