"""Encrypted pointer -> encrypted RAM address, without decryption.

For each address-coordinate digit (widths from the Base2D geometry), a
GGSW blind rotation turns the bits (u >> rsh) & mask of the encrypted
word u into GGSW(X^-((u >> rsh & mask) << lsh)): start from the trivial
gadget GGSW of X^0 (zero mask, zero noise: only row phases matter) and
CMux all D*C rows through the pointer's bit GGSWs -- ONE launch of
kernel 10 a digit (a radix-2 context), or one keyed CMux a bit, one GGSW
for all the rows (a two-pass context: the JAX package's composed branch);
the same integers, the full gadget either way.  The pointer's bits are
prepared at the GGSW-apply parameterization (dnum_ggsw digits,
limbs_evk_ggsw limbs), so their digit count matches the limbs of the rows
they rotate.  The sign is the RAM's:
addresses rotate by X^-a."""

from __future__ import annotations

import torch

from ..params import Params
from ..ops.ntt import NTTContext, fused_path_active
from ..ops.modular import I32
from ..ops import limb as limb_ops
from ..ops import poly
from ..core import ggsw
from ..ram.address import Address, AddressPrepared
from . import circuits


def _trivial_gadget_ggsw(params: Params, tv):
    """Zero-noise GGSW(tv) [D, C, C2, Lg, N]: row (d, c) = tv *
    2^-(17(d+1)) on component c.  tv: int32[N] small integer polynomial."""
    D, Lg, C = params.dnum_ct, params.limbs_ggsw, params.rank + 1
    tv = torch.as_tensor(tv, dtype=I32)
    rows = torch.zeros((D, C, C, Lg, params.n), dtype=I32, device=tv.device)
    for d in range(D):
        for c in range(C):
            rows[d, c, c, d] = tv
    return limb_ops.normalize(rows)


def scalar_to_ggsw_blind_rotation(params: Params, ctx: NTTContext, tv,
                                  fheuint_prep, rsh: int, mask_bits: int,
                                  lsh: int, negate: bool = True):
    """GGSW(tv * X^(+-((u >> rsh) & (2^mask_bits - 1)) << lsh)) from the
    prepared bits of u, coefficient domain [D, C, C2, Lg, N]."""
    g = _trivial_gadget_ggsw(params, tv)
    D, C, C2, Lg, n = g.shape
    if fheuint_prep.shape[2] != Lg:   # one digit a limb of the rows
        raise ValueError(
            "conversion needs bits at the GGSW-apply parameterization: "
            "encrypt_prepared(..., dnum=params.dnum_ggsw, "
            "limbs=params.limbs_evk_ggsw)")
    if mask_bits == 0:
        return g
    sgn = -1 if negate else 1
    rows = g.reshape(D * C, C2, Lg, n)
    amounts = [sgn << (lsh + j) for j in range(mask_bits)]
    if fused_path_active(ctx):
        rows = circuits.blind_rotate_fused(params, ctx, rows, fheuint_prep,
                                           range(rsh, rsh + mask_bits), amounts)
    else:
        for j, t in enumerate(amounts):
            rows = circuits.cmux_keyed(params, ctx, fheuint_prep[:, rsh + j: rsh + j + 1],
                                       poly.rotate(rows, t)[None], rows[None])[0]
    return rows.reshape(D, C, C2, Lg, n)


def fheuint_to_address(params: Params, ctx: NTTContext, fheuint_prep):
    """An Address from an encrypted pointer: returns (Address,
    AddressPrepared), so that one conversion drives both the read (NTT
    domain) and the write (which derives inverse GGSWs from the
    coefficient-domain coordinates)."""
    tv = torch.zeros(params.n, dtype=I32, device=fheuint_prep.device)
    tv[0] = 1
    coords_coeff, coords_prep = [], []
    bit_rsh = 0
    for base1d in params.base2d().rows:
        digs = []
        bit_lsh = 0
        for bmask in base1d.bases:
            digs.append(scalar_to_ggsw_blind_rotation(
                params, ctx, tv, fheuint_prep, bit_rsh, bmask, bit_lsh))
            bit_lsh += bmask
            bit_rsh += bmask
        stack = torch.stack(digs, dim=0)
        coords_coeff.append(stack)
        coords_prep.append(ggsw.prepare(ctx, stack))
    return (Address(coordinates=tuple(coords_coeff)),
            AddressPrepared(coordinates=tuple(coords_prep)))
