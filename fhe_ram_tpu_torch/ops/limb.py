"""Base-2^17 signed-limb torus arithmetic (int32, vectorized).

A torus element t in [-1/2, 1/2) is stored as int32[..., L, N] with
t = sum_j limb[..., j, :] * 2^-(17*(j+1)).  After `normalize`, limbs are
balanced: -2^16 <= limb < 2^16.  Gadget decomposition of a normalized
ciphertext is simply its limbs.

Shifts and masks act on signed int32 (arithmetic `>>`, two's-complement
`&`); no division or remainder is used on limbs.
"""

from __future__ import annotations

import numpy as np
import torch

I32 = torch.int32


def normalize(x, base2k: int = 17):
    """Carry-propagate limbs to the balanced range.

    x: int32[..., L, N] with |limb| < ~2^29 (so carries fit).
    The carry out of limb 0 (integer part) is dropped (torus mod 1)."""
    L = x.shape[-2]
    half = 1 << (base2k - 1)
    mask = (1 << base2k) - 1
    out = [None] * L
    carry = None
    for j in range(L - 1, -1, -1):
        t = x[..., j, :] if carry is None else x[..., j, :] + carry
        d = ((t + half) & mask) - half
        carry = (t - d) >> base2k
        out[j] = d
    return torch.stack(out, dim=-2)


def shift_right(x, bits: int, base2k: int = 17):
    """Exact torus division by 2^bits of balanced limbs (bits < base2k).

    The low `bits` of limb j move down to limb j+1; the last limb's low
    bits are truncated.  Used to pre-scale trace/packing inputs by 1/N
    resp. 1/M so the automorphism sums need no mid-loop division."""
    assert 0 < bits < base2k
    L = x.shape[-2]
    mask = (1 << bits) - 1
    out = []
    for j in range(L):
        h = x[..., j, :] >> bits
        if j > 0:
            h = h + ((x[..., j - 1, :] & mask) << (base2k - bits))
        out.append(h)
    return torch.stack(out, dim=-2)


def resize_limbs(x, new_l: int):
    """Truncate or zero-extend the limb axis (precision change)."""
    L = x.shape[-2]
    if new_l <= L:
        return x[..., :new_l, :]
    pad = x.new_zeros(x.shape[:-2] + (new_l - L, x.shape[-1]))
    return torch.cat([x, pad], dim=-2)


def decode_coeff(limbs_arr, k: int, base2k: int = 17, index: int = 0) -> int:
    """Decode coefficient `index` at precision k: round(t * 2^k) as a
    Python int (numpy; client side)."""
    x = np.asarray(limbs_arr)
    val = 0.0
    for j in range(x.shape[-2]):
        val += float(x[j, index]) * 2.0 ** (-base2k * (j + 1))
    return int(np.rint(val * 2.0**k))


def torus_float(limbs_arr, base2k: int = 17):
    """Torus value(s) as a float64 numpy array (client side; for noise
    measurement)."""
    x = np.asarray(limbs_arr, dtype=np.float64)
    L = x.shape[-2]
    w = np.array([2.0 ** (-base2k * (j + 1)) for j in range(L)])
    return np.tensordot(w, x, axes=([0], [x.ndim - 2]))
