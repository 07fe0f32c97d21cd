"""Encrypted addresses: hierarchies of GGSW(X^-a_digit).

An address a < max_addr is split by the Base2D geometry into n2
coordinates (one per ring-degree-sized chunk of address bits); each
coordinate is further split into small digits, one GGSW per digit, so
that every GGSW encrypts a monomial with a tiny exponent.

Layouts:
  Coordinate (coeff domain):  int32[dig, D, C, C2, Lg, N]
  Coordinate (prepared/NTT):  int32[P, dig, D, C, C2, Lg, N]
Digit counts differ per coordinate, so an Address holds a tuple.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..params import Params
from ..ops.ntt import NTTContext
from ..ops import ntt_cuda
from ..core import ggsw, rng


@dataclass
class Address:
    """Client-encrypted address (coefficient domain)."""

    coordinates: tuple  # tuple of int32[dig_i, D, C, C2, Lg, N]


@dataclass
class AddressPrepared:
    """NTT-domain address (server side)."""

    coordinates: tuple  # tuple of int32[P, dig_i, D, C, C2, Lg, N]


def _digit_monomial(n: int, value: int, base: int, tot_base: int, sign: int):
    """The scalar polynomial +-X^chunk encoding one digit."""
    mono = np.zeros(n, dtype=np.int32)
    chunk = (value & ((1 << base) - 1)) << tot_base
    if sign < 0 and chunk != 0:
        mono[n - chunk] = -1  # (X^c)^-1 = -X^(n-c), negacyclic wrap
    else:
        mono[chunk] = 1
    return mono


def coordinate_encrypt(params: Params, ctx: NTTContext, s_ntt, value: int,
                       base1d, source: rng.Source):
    """GGSW digits of X^{value}, |value| < N."""
    n = params.n
    assert abs(value) < n
    sign = 1 if value >= 0 else -1
    remain = abs(value)
    tot_base = 0
    digs = []
    for b in base1d.bases:
        mono = _digit_monomial(n, remain, b, tot_base, sign)
        digs.append(ggsw.encrypt(params, ctx, s_ntt, mono, source))
        remain >>= b
        tot_base += b
    return torch.stack(digs, dim=0)


def encrypt(params: Params, ctx: NTTContext, s_ntt, value: int,
            source: rng.Source) -> Address:
    """Encrypt address `value` on s_ntt's device; digits are negated so
    the read rotates by X^-a.  An out-of-range address is refused."""
    base2d = params.base2d()
    if not 0 <= value < base2d.max():
        raise ValueError(f"address {value} outside [0, {base2d.max()})")
    coords = []
    remain = value
    for base1d in base2d.rows:
        k = remain & (base1d.max() - 1)
        coords.append(coordinate_encrypt(params, ctx, s_ntt, -k, base1d, source))
        remain //= base1d.max()
    return Address(coordinates=tuple(coords))


def prepare(ctx: NTTContext, addr: Address) -> AddressPrepared:
    """Forward-NTT every digit GGSW (server side)."""
    return AddressPrepared(
        coordinates=tuple(ggsw.prepare(ctx, c) for c in addr.coordinates)
    )


def _truncate_coord(coord_prep, trunc, dig: int):
    """Read-path gadget truncation of a prepared coordinate
    [..., dig, D, C, C2, Lg, N]: keep the top in_digits gadget rows / top
    key_limbs GGSW limbs.  Digit truncation needs dig == 1 -- chained CMux
    digits re-decompose the full-limb carry."""
    in_digits, key_limbs = trunc
    if in_digits is not None:
        assert dig == 1, "read_ep_digits needs single-digit coordinates"
        coord_prep = coord_prep[..., :in_digits, :, :, :, :]
    if key_limbs is not None:
        coord_prep = coord_prep[..., :key_limbs, :]
    return coord_prep


def coordinate_product(params: Params, ctx: NTTContext, ct, coord_prep,
                       trunc: tuple = (None, None)):
    """Chained external products of all digit GGSWs of one coordinate
    (the CMux chain).  ct: int32[..., C, L, N] with leading batch dims.

    The whole chain is one launch of ops.ntt_cuda.fused_external_fold:
    each digit's fold+normalize output feeds the next digit's gadget
    decomposition inside the kernel.

    trunc = (in_digits, key_limbs): optional read-path gadget truncation."""
    dig = coord_prep.shape[1]
    coord_prep = _truncate_coord(coord_prep, trunc, dig)
    n = params.n
    P, _, D, C, C2, Lg, _n = coord_prep.shape
    L = ct.shape[-2]
    assert C2 == C and D <= L and (D == L or dig == 1)
    lead_shape = ct.shape[:-3]
    x = ct[..., :D, :].reshape(-1, C * D, n)
    # [P, dig, D, C, C2, Lg, N] -> [P, dig, C*D, C2*Lg, N]
    keys = coord_prep.permute(0, 1, 3, 2, 4, 5, 6).reshape(
        P, dig, C * D, C2 * Lg, n)
    out = ntt_cuda.fused_external_fold(ctx, x, keys, L, C2)
    return out.reshape(lead_shape + (C2, L, n))
