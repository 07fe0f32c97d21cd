"""Homomorphic word circuits: the RV32I ALU's building blocks.

Everything is built from CMuxes, res = low + bit (x) (high - low), over
prepared bit GGSWs:

  * one launch of the keyed or batched fold (kernel 5) for a CMux batch;
  * one launch of `ntt_cuda.fused_blind_rotate` (kernel 10) for a whole
    blind-rotation chain rows <- CMux(bit_s; X^t_s rows, rows);
  * one launch of `ntt_cuda.fused_dp_chain` (kernel 11) for the 2-state
    carry DP of adders and comparators, evaluated MSB -> LSB: F_j(c) = "the
    encrypted suffix result given carry-in c at bit j", two CMux phases a
    bit (`carry_chain`);
  * one launch of `ntt_cuda.fused_bitwise` (kernel 9) for the two-level
    truth-table select of xor / or / and over all bits (`truth_table`);
  * slot extraction by one batched trace, for shifts and splices.

Those are the fused routes (a radix-2 context).  Under a two-pass context
(ops.ntt.fused_path_active False: the JAX package's FHERAM_MXU=0) the two
chain circuits take their composed routes, the JAX package's composed
loops: one keyed CMux (kernel 5) a step and source group, the smaller
source group zero-padded to a rectangular row count.

`trunc` = (in_digits, key_limbs) is the gadget truncation of ephemeral
words (arithmetic._vm_trunc): the top in_digits limbs are decomposed
against the top key_limbs limbs of the bit GGSWs.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..params import Params
from ..ops.ntt import NTTContext, fused_path_active, ntt_fwd
from ..ops.modular import I32
from ..ops import limb as limb_ops
from ..ops import ntt_cuda
from ..ops import poly
from ..core import ggsw, keyswitch
from . import fheuint


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------

def cmux(params: Params, ctx: NTTContext, bit_prep, high, low):
    """low + bit (x) (high - low), one GGSW a row: bit_prep [P, B, D, C, C2,
    Lg, N], high / low [B, C, L, N].  high - low goes in unnormalized
    (|limb| <= 2^17, within the fold's digit bound)."""
    return ggsw.external_product_batched(params, ctx, high - low, bit_prep,
                                         base=low)


def cmux_keyed(params: Params, ctx: NTTContext, bit_prep, high, low,
               trunc: tuple = (None, None)):
    """cmux with K bit GGSWs, each selecting B rows: bit_prep [P, K, D, C,
    C2, Lg, N]; high / low [K, B, C, L, N].  Each key is read once for
    its rows."""
    return ggsw.external_product_keyed(params, ctx, high - low, bit_prep,
                                       base=low, trunc=trunc)


def digit_rows(prep, trunc: tuple = (None, None), digits: int | None = None):
    """Prepared bits [P, W, D, C, C2, Lg, N] with the top in_digits gadget
    rows kept and, given `digits`, zero rows added up to that many (see
    operand_digits): operands of unequal depth then share one keyed CMux."""
    p = prep[:, :, :trunc[0]]
    if digits is not None and p.shape[2] < digits:
        p = torch.cat([p, p.new_zeros(p.shape[:2] + (digits - p.shape[2],)
                                      + p.shape[3:])], dim=2)
    return p


def key_rows(prep, trunc: tuple = (None, None), digits: int | None = None):
    """Every bit of prepared bits [P, W, D, C, C2, Lg, N] as the kernels'
    key rows [W, P, C*D, C2*Lg, N] (component-major digit rows, M over (c2,
    limb)), in one copy, keeping the top in_digits gadget rows and the top
    key_limbs limbs.  digits: pad to that many gadget rows with zero rows
    (see digit_rows)."""
    p = digit_rows(prep, trunc, digits)[..., :trunc[1], :]
    P, W, D, C, C2, Lg, n = p.shape
    return p.permute(1, 0, 3, 2, 4, 5, 6).reshape(W, P, C * D, C2 * Lg, n)


def operand_digits(preps, trunc: tuple = (None, None)) -> int:
    """The gadget rows of the widest of several operands' bits after the
    truncation.  An operand with fewer (a LOAD's lifted bits,
    vm/bitdecomp.py: 2 digit rows) is padded with zero rows to it: its
    products then decompose only the top digits of the ciphertext, as an
    external product against it alone does."""
    return max(p[:, :, :trunc[0]].shape[2] for p in preps)


def ggsw_key_rows(prep, j: int, trunc: tuple = (None, None)):
    """Bit j alone as key rows [P, C*D, C2*Lg, N] (see key_rows)."""
    return key_rows(prep[:, j: j + 1], trunc)[0]


def blind_rotate_fused(params: Params, ctx: NTTContext, rows, prep_bits,
                       bit_idxs, amounts, trunc: tuple = (None, None)):
    """A CMux rotation chain rows <- CMux(bit_j; X^a_j rows, rows) as ONE
    launch of kernel 10.  rows: [B, C2, Lc, N]; bit_idxs / amounts: per
    step the bit of prep_bits and the static rotation exponent."""
    keys = key_rows(prep_bits, trunc)[list(bit_idxs)]
    return ntt_cuda.fused_blind_rotate(ctx, rows, keys, tuple(amounts))


def ggsw_not(params: Params, ctx: NTTContext, bit_prep):
    """GGSW(1 - bit) from prepared bits [P, W, D, C, C2, Lg, N]: GGSW is
    linear in its message and GGSW(1) is the noise-free gadget, whose
    transform is subtracted from here.  Residues stay canonical, as the
    kernels take them."""
    P, W, D, C, C2, Lg, n = bit_prep.shape
    one = torch.zeros((D, C, C2, Lg, n), dtype=I32, device=bit_prep.device)
    for d in range(D):
        for c in range(C):
            one[d, c, c, d, 0] = 1
    diff = ntt_fwd(ctx, one)[:, None] - bit_prep
    return torch.remainder(diff, ctx.consts(diff.dim(), diff.device)).to(I32)


def extract_slots(params: Params, ctx: NTTContext, word, atk, bits: int = 32,
                  trunc: tuple = (None, None)):
    """All W slot values of a word moved to coefficient 0: [C, L, N] ->
    [W, C, L, N], by W rotations and ONE batched full trace."""
    g = fheuint.gap(params, bits)
    y = poly.rotate_each(word.expand((bits,) + tuple(word.shape)),
                         [-g * m for m in range(bits)])
    return keyswitch.trace(params, ctx, y, atk, trunc=trunc)


def assemble_word(params: Params, slots, bits: int = 32):
    """Inverse of extract_slots: sum of slot_j * X^(j*gap), slots [W, C, L,
    N] each at coefficient 0."""
    g = fheuint.gap(params, bits)
    rotated = poly.rotate_each(slots, [g * m for m in range(bits)])
    return limb_ops.normalize(torch.sum(rotated, dim=0, dtype=I32))


@lru_cache(maxsize=None)
def _constant_words(params: Params, slot_vals: tuple, bits: int, device):
    """fheuint.trivial_words of constant slot values, made once a device:
    the circuits' leaves and deltas are the same every cycle, and a copy
    from the host would make the host wait for the card.  Shared: never
    written into."""
    return fheuint.trivial_words(params, slot_vals, bits, device)


def _one_hot(j: int, bits: int, value: int = 1):
    vals = [0] * bits
    vals[j] = value
    return tuple(vals)


def _delta_slot(params: Params, j: int, bits: int, value: int = 1,
                device="cuda"):
    """Trivial GLWE with `value` at slot j (scale 2^-k_pt)."""
    return fheuint.trivial_word(params, _one_hot(j, bits, value), bits,
                                device=device)


# --------------------------------------------------------------------------
# the two chain circuits
# --------------------------------------------------------------------------

def _dp_start(params: Params, specs, bits: int, device):
    """The carry DP's initial state F0 [G, 2, C, L, N] (final(c) at slot 0)
    and its step deltas [bits, C, L, N] (a one at slot j, MSB first)."""
    F0 = _constant_words(params, tuple((sp[3](c),) for sp in specs for c in (0, 1)),
                         bits, device)
    deltas = _constant_words(params, tuple(_one_hot(j, bits)
                                           for j in range(bits - 1, -1, -1)),
                             bits, device)
    return F0.reshape((len(specs), 2) + tuple(F0.shape[1:])), deltas


def carry_chain(params: Params, ctx: NTTContext, specs, a_prep, b_preps, groups,
                bits: int, trunc: tuple = (None, None)):
    """G carry-DP ops as ONE launch of kernel 11 (a radix-2 context), or
    as the composed loop (`carry_chain_composed`, a two-pass context).

    specs[g] = (emit, subtab, flip, final) of op g (final(c): the plaintext
    at slot 0 past the MSB given carry c); a_prep: the a operand's
    prepared bits; b_preps[s]: the prepared bits of source group s, whose
    ops are groups[s].  Returns the final state F [G, 2, C, L, N]."""
    if not fused_path_active(ctx):
        return carry_chain_composed(params, ctx, specs, a_prep, b_preps, groups,
                                    bits, trunc)
    F0, deltas = _dp_start(params, specs, bits, a_prep.device)
    msb_first = list(range(bits - 1, -1, -1))
    preps = list(b_preps) + [a_prep]
    D = operand_digits(preps, trunc)
    keys = torch.stack([key_rows(p, trunc, D)[msb_first] for p in preps], dim=1)
    return ntt_cuda.fused_dp_chain(
        ctx, F0, keys, deltas,
        tuple(tuple(sp[:3]) for sp in specs), tuple(tuple(g) for g in groups))


@lru_cache(maxsize=None)
def _dp_leaf_tables(op_tables: tuple, groups: tuple, first: bool, device):
    """Where the composed DP's b-phase rows come from: gather indices into
    the state F [G*2] plus one zero row (index 2G), and the emitted bits,
    each [2 (hi, lo), NG, 4 * the largest group]: source group s holds its
    ops' four rows (a, c) in order, padded with zero rows.  Also the index
    of op g's four result rows in the [NG * rows] output.  Made once a
    device."""
    G, NG = len(op_tables), len(groups)
    rows = 4 * max(len(g) for g in groups)
    idx = np.full((2, NG, rows), 2 * G, dtype=np.int64)
    emit = np.zeros((2, NG, rows), dtype=np.int32)
    back = np.zeros((G, 4), dtype=np.int64)
    for si, gis in enumerate(groups):
        for k, gi in enumerate(gis):
            leaf = ntt_cuda.dp_leaf_rows(*op_tables[gi], first)
            for r, (co0, co1, ob0, ob1) in enumerate(leaf):
                idx[:, si, 4 * k + r] = (2 * gi + co1, 2 * gi + co0)
                emit[:, si, 4 * k + r] = (ob1, ob0)
                back[gi, r] = si * rows + 4 * k + r
    return (torch.from_numpy(idx).to(device), torch.from_numpy(emit).to(device),
            torch.from_numpy(back).to(device))


def carry_chain_composed(params: Params, ctx: NTTContext, specs, a_prep, b_preps,
                         groups, bits: int, trunc: tuple = (None, None)):
    """carry_chain as the JAX package's composed loop (vm/arithmetic.py
    _dp_group under FHERAM_MXU=0), MSB -> LSB, two keyed CMuxes a bit: the
    b-phase one call over all source groups (K = the groups' bits j, the
    smaller group zero-padded to a rectangular row count; zero rows stay
    zero), the a-phase one over every op's two states.  Bits of unequal
    gadget depth (a LOAD's lifted bits) are padded with zero rows to the
    widest, as the fused route pads them (operand_digits).  The same
    integers as kernel 11."""
    G = len(specs)
    device = a_prep.device
    F, deltas = _dp_start(params, specs, bits, device)
    shape = tuple(F.shape[2:])
    D = operand_digits(list(b_preps) + [a_prep], trunc)
    op_tables = tuple(tuple(sp[:3]) for sp in specs)
    groups = tuple(tuple(g) for g in groups)
    zero = F.new_zeros((1,) + shape)
    for d, j in enumerate(range(bits - 1, -1, -1)):
        idx, emit, back = _dp_leaf_tables(op_tables, groups, d == 0, device)
        leaves = (torch.cat([F.reshape((2 * G,) + shape), zero])[idx]
                  + emit[..., None, None, None] * deltas[d])
        keys = torch.cat([digit_rows(p[:, j: j + 1], trunc, D) for p in b_preps],
                         dim=1)
        res = cmux_keyed(params, ctx, keys, leaves[0], leaves[1], trunc=trunc)
        inner = res.reshape((-1,) + shape)[back]              # [G, 4, C, L, N]
        F = cmux_keyed(params, ctx, a_prep[:, j: j + 1],
                       inner[:, 2:].reshape((1, 2 * G) + shape),
                       inner[:, :2].reshape((1, 2 * G) + shape),
                       trunc=trunc)[0].reshape((G, 2) + shape)
    return F


def _truth_leaves(params: Params, tables, bits: int, device):
    """The arms (l11, l01) / (l10, l00) of every op: [G, 2 (hi, lo), 2, C, L,
    N]."""
    return _constant_words(
        params, tuple((t[i],) for t in tables for i in (3, 1, 2, 0)), bits,
        device).reshape((len(tables), 2, 2) + (params.rank + 1, params.limbs_ct,
                                               params.n))


def truth_table(params: Params, ctx: NTTContext, tables, a_prep, b_preps,
                groups, bits: int, trunc: tuple = (None, None)):
    """G bitwise ops as ONE launch of kernel 9 (a radix-2 context), or as
    the composed loop (`truth_table_composed`, a two-pass context):
    out[j, g] = the truth table tables[g] = (t00, t01, t10, t11) at (a_j,
    b_j), each as a slot-0 word.  b_preps[s]: the prepared bits of source
    group s, whose ops are groups[s].  Returns [W, G, C, L, N]."""
    if not fused_path_active(ctx):
        return truth_table_composed(params, ctx, tables, a_prep, b_preps, groups,
                                    bits, trunc)
    leaves = _truth_leaves(params, tables, bits, a_prep.device)
    preps = list(b_preps) + [a_prep]
    D = operand_digits(preps, trunc)
    keys = torch.stack([key_rows(p, trunc, D)[:bits] for p in preps], dim=1)
    return ntt_cuda.fused_bitwise(ctx, leaves[:, 0], leaves[:, 1], keys,
                                  tuple(tuple(g) for g in groups))


def truth_table_composed(params: Params, ctx: NTTContext, tables, a_prep,
                         b_preps, groups, bits: int, trunc: tuple = (None, None)):
    """truth_table as the JAX package's composed path (vm/arithmetic.py
    _bitwise_group under FHERAM_MXU=0): one keyed CMux level a source group
    (bit j of its operand selects both arms of its ops, row j), then one
    over all ops by the a operand's bits.  The same integers as kernel
    9."""
    leaves = _truth_leaves(params, tables, bits, a_prep.device)
    G = len(tables)
    hi, lo = [None] * G, [None] * G
    for b_prep, gis in zip(b_preps, groups):
        gl = list(gis)
        highs = torch.cat([leaves[gl, 0, 0], leaves[gl, 0, 1]])
        lows = torch.cat([leaves[gl, 1, 0], leaves[gl, 1, 1]])
        res = cmux_keyed(params, ctx, b_prep[:, :bits],
                         highs.expand((bits,) + tuple(highs.shape)),
                         lows.expand((bits,) + tuple(lows.shape)), trunc=trunc)
        for k, gi in enumerate(gis):
            hi[gi], lo[gi] = res[:, k], res[:, len(gis) + k]
    return cmux_keyed(params, ctx, a_prep[:, :bits], torch.stack(hi, 1),
                      torch.stack(lo, 1), trunc=trunc)


# --------------------------------------------------------------------------
# per-op circuits (untruncated)
# --------------------------------------------------------------------------

_TABLES = {"xor": (0, 1, 1, 0), "and": (0, 0, 0, 1), "or": (0, 1, 1, 1)}


def bitwise(params: Params, ctx: NTTContext, op: str, a_prep, b_prep,
            bits: int = 32):
    """xor / and / or: out_j = CMux(a_j, CMux(b_j, t11, t10),
    CMux(b_j, t01, t00))."""
    out = truth_table(params, ctx, (_TABLES[op],), a_prep, (b_prep,), ((0,),),
                      bits)
    return assemble_word(params, out[:, 0], bits)


def _carry_op(params, ctx, spec, take, a_prep, b_prep, bits):
    F = carry_chain(params, ctx, (spec,), a_prep, (b_prep,), ((0,),), bits)
    return F[0, take]


def add(params: Params, ctx: NTTContext, a_prep, b_prep, bits: int = 32):
    return _carry_op(params, ctx, (True, False, False, lambda c: 0), 0,
                     a_prep, b_prep, bits)


def sub(params: Params, ctx: NTTContext, a_prep, b_prep, bits: int = 32):
    """a - b = a + ~b + 1: b complemented in the table, carry-in 1."""
    return _carry_op(params, ctx, (True, True, False, lambda c: 0), 1,
                     a_prep, b_prep, bits)


def sltu(params: Params, ctx: NTTContext, a_prep, b_prep, bits: int = 32):
    """a < b unsigned: NOT the carry-out of a + ~b + 1, at slot 0."""
    return _carry_op(params, ctx, (False, True, False, lambda c: 1 - c), 1,
                     a_prep, b_prep, bits)


def slt(params: Params, ctx: NTTContext, a_prep, b_prep, bits: int = 32):
    """Signed a < b: the same with both MSBs complemented."""
    return _carry_op(params, ctx, (False, True, True, lambda c: 1 - c), 1,
                     a_prep, b_prep, bits)


# --------------------------------------------------------------------------
# shifts: slot extraction + keyed barrel CMuxes
# --------------------------------------------------------------------------

def word_from_bits(params: Params, ctx: NTTContext, prep, bits: int = 32):
    """Word-form GLWE from prepared bits: one batched external product."""
    base = _constant_words(params, tuple(_one_hot(j, bits) for j in range(bits)),
                           bits, prep.device)
    slots_sel = cmux(params, ctx, prep, base, torch.zeros_like(base))
    return limb_ops.normalize(torch.sum(slots_sel, dim=0, dtype=I32))


def barrel_roll(slots, kind: str, s: int):
    """The slot stack [W, ...] shifted by s: sll fills low slots with 0,
    srl high slots with 0, sra high slots with the sign slot."""
    if kind == "sll":
        return torch.cat([torch.zeros_like(slots[:s]), slots[:-s]], dim=0)
    if kind == "srl":
        return torch.cat([slots[s:], torch.zeros_like(slots[:s])], dim=0)
    return torch.cat([slots[s:], slots[-1:].expand((s,) + slots.shape[1:])], dim=0)


def shift(params: Params, ctx: NTTContext, word, sh_prep, atk, kind: str,
          bits: int = 32):
    """sll / srl / sra by an encrypted 5-bit amount: one batched slot
    extraction, then log2(bits) keyed CMux barrel levels."""
    slots = extract_slots(params, ctx, word, atk, bits)
    for k in range(bits.bit_length() - 1):
        rolled = barrel_roll(slots, kind, 1 << k)
        slots = cmux_keyed(params, ctx, sh_prep[:, k: k + 1], rolled[None],
                           slots[None])[0]
    return assemble_word(params, slots, bits)
