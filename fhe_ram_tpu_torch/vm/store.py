"""Encrypted store-width / offset selection.

Builds the 16-slot test vector of every (offset 0-3 x op NONE/SB/SH/SW)
store outcome -- byte and halfword splices of the loaded word y and the
stored word x -- then blind-rotates it by the encrypted offset (stride 4)
and op id, and partial-traces to clean.  Both rotations are ONE 4-step
launch of kernel 10 (amounts -4, -8, -1, -2) on a radix-2 context, or two
composed arithmetic.glwe_blind_rotation chains (one CMux a bit) on a
two-pass context; untruncated either way, the same integers: the stored
word persists in the RAM."""

from __future__ import annotations

import torch

from ..params import Params
from ..ops.ntt import NTTContext, fused_path_active
from ..ops.modular import I32
from ..ops import limb as limb_ops
from ..ops import ntt_cuda
from ..ops import poly
from ..core import keyswitch
from . import arithmetic, circuits

STORE_OPS = ("none", "sb", "sh", "sw")


def _splice(params: Params, y_slots, x_slots, byte_dst: int, width: int,
            bits: int):
    """y with its `width`-byte field at byte offset `byte_dst` replaced by
    x's low bytes."""
    lo = byte_dst * 8
    hi = lo + width * 8
    sel = torch.cat([y_slots[:lo], x_slots[0: hi - lo], y_slots[hi:]], dim=0)
    return circuits.assemble_word(params, sel, bits)


def construct_store_test_vector(params: Params, ctx: NTTContext, rs2, loaded,
                                atk, bits: int = 32):
    """The packed test vector: case (offset, op) at coefficient offset*4 +
    op (14 cases; the misaligned SH / SW cases stay zero)."""
    x = circuits.extract_slots(params, ctx, rs2, atk, bits)
    y = circuits.extract_slots(params, ctx, loaded, atk, bits)

    def sp(byte_dst, width):
        return _splice(params, y, x, byte_dst, width, bits)

    cases = [
        loaded, sp(0, 1), sp(0, 2), rs2,         # offset 0
        loaded, sp(1, 1), None, None,            # offset 1 (SH/SW invalid)
        loaded, sp(2, 1), sp(2, 2), None,        # offset 2 (SW invalid)
        loaded, sp(3, 1),                        # offset 3 (SH/SW invalid)
    ]
    # sum of X^c case_c in one gather; one normalize at the end gives the
    # same limbs as normalizing after every add (balanced limbs of a torus
    # value are unique)
    placed = [(c, case) for c, case in enumerate(cases) if case is not None]
    rotated = poly.rotate_each(torch.stack([case for _, case in placed]),
                               [c for c, _ in placed])
    return limb_ops.normalize(torch.sum(rotated, dim=0, dtype=I32))


def store_rotation(params: Params, ctx: NTTContext, res, offset_prep, op_prep):
    """Blind rotation by offset << 2, then by op, the keys' full gadget:
    ONE 4-step chain of kernel 10 with amounts (-4, -8, -1, -2), or (a
    two-pass context) the JAX package's two composed rotations."""
    if not fused_path_active(ctx):
        res = arithmetic.glwe_blind_rotation(params, ctx, res, offset_prep, 0, 2,
                                             lsh=2)
        return arithmetic.glwe_blind_rotation(params, ctx, res, op_prep, 0, 2)
    keys = torch.stack([circuits.ggsw_key_rows(offset_prep, 0),
                        circuits.ggsw_key_rows(offset_prep, 1),
                        circuits.ggsw_key_rows(op_prep, 0),
                        circuits.ggsw_key_rows(op_prep, 1)])
    return ntt_cuda.fused_blind_rotate(ctx, res[None], keys, (-4, -8, -1, -2))[0]


def select_store(params: Params, ctx: NTTContext, rs2, loaded, offset_prep,
                 op_prep, atk, bits: int = 32):
    """The word to store: test vector, blind rotation by offset << 2 then
    op, partial trace keeping the word's slot stride."""
    res = construct_store_test_vector(params, ctx, rs2, loaded, atk, bits)
    res = store_rotation(params, ctx, res, offset_prep, op_prep)
    return keyswitch.trace(params, ctx, res, atk,
                           keep_log=bits.bit_length() - 1)
