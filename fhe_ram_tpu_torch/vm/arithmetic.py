"""RV32I ALU over encrypted words.

`eval_ops` evaluates every ALU op on (rs1, rs2, imm) and packs result i
at coefficient offset i of one GLWE; `select_rd` blind-rotates by the
encrypted op id and partial-traces away the other slots.

Ops are grouped by circuit type and each group runs as one circuit: the
7 carry-DP ops (add / sub / compare families) as ONE launch of the carry
chain kernel (11), the 6 bitwise ops as ONE launch of the bitwise kernel
(9), the 6 shifts as one slot extraction and one keyed barrel CMux a
level.  `select_rd`'s rotation is one launch of kernel 10.

Every CMux of the groups and of `select_rd` runs the ephemeral-word gadget
truncation `_vm_trunc`, at every ring degree.  Those are the fused routes
(a radix-2 context).  A two-pass context takes the JAX package's composed
routes (its FHERAM_MXU=0 branches, and what it runs at every ring but N =
4096): the carry-DP and bitwise groups as loops of keyed CMuxes under the
same truncation (circuits.carry_chain_composed, truth_table_composed: the
same integers as kernels 11 and 9), and the blind rotation as a loop of
CMuxes with the full gadget -- so select_rd's rd there is the reference's
composed one, not the fused route's.
"""

from __future__ import annotations

import torch

from ..params import Params
from ..ops.ntt import NTTContext, fused_path_active
from ..ops.modular import I32
from ..ops import limb as limb_ops
from ..ops import poly
from ..core import keyswitch
from ..core import noise as noise_mod
from . import circuits, fheuint

RVI32_OPS = (
    "none", "addi", "slti", "sltiu", "xori", "ori", "andi", "slli",
    "srli", "srai", "add", "sub", "sll", "slt", "sltu", "xor", "srl",
    "sra", "or", "and",
)

# circuit-group classification; "imm" ops read the immediate as operand b
_IMM_OPS = {"addi", "slti", "sltiu", "xori", "ori", "andi",
            "slli", "srli", "srai"}

# carry-DP specs: (emit_bits, use_sub_table, msb_flip, final(c), take_F)
_DP_SPECS = {
    "add": (True, False, False, lambda c: 0, 0),
    "addi": (True, False, False, lambda c: 0, 0),
    "sub": (True, True, False, lambda c: 0, 1),
    "sltu": (False, True, False, lambda c: 1 - c, 1),
    "sltiu": (False, True, False, lambda c: 1 - c, 1),
    "slt": (False, True, True, lambda c: 1 - c, 1),
    "slti": (False, True, True, lambda c: 1 - c, 1),
}

_BITWISE_TABLES = {
    "xor": (0, 1, 1, 0), "xori": (0, 1, 1, 0),
    "and": (0, 0, 0, 1), "andi": (0, 0, 0, 1),
    "or": (0, 1, 1, 1), "ori": (0, 1, 1, 1),
}

_SHIFT_KINDS = {
    "sll": "sll", "slli": "sll", "srl": "srl", "srli": "srl",
    "sra": "sra", "srai": "sra",
}

# bits the truncation's added noise must stay below the bit-decode bound:
# it adds to, and does not replace, the circuit's own noise
_VM_TRUNC_MARGIN = 6.0


def _vm_trunc(params: Params, bits: int = 32):
    """(CMux truncation, keyswitch truncation) of ephemeral VM words: the
    params' read-path fields, whose added noise core/noise prices and this
    asserts under the bit-decode bound (a preset that truncates too far
    fails here rather than decoding wrong)."""
    if (params.read_ep_trunc, params.read_ks_trunc) != ((None, None),
                                                        (None, None)):
        added = noise_mod.vm_trunc_added_log2(params, bits)
        decode = -(params.k_pt + 1)
        assert added < decode - _VM_TRUNC_MARGIN, (
            f"VM gadget truncation adds 2^{added:.1f} noise -- too close to "
            f"the 2^{decode} bit-decode bound for this preset; widen the "
            f"read_* truncation fields")
    return params.read_ep_trunc, params.read_ks_trunc


def _src_groups(ops):
    """{is_imm: [op indices]}: the ops grouped by their b operand, in order
    of first appearance."""
    groups = {}
    for gi, op in enumerate(ops):
        groups.setdefault(op in _IMM_OPS, []).append(gi)
    return groups


def _sources(ops, rs2p, immp):
    """(prepared bits of each source group, the groups' op indices)."""
    items = list(_src_groups(ops).items())
    return ([immp if is_imm else rs2p for is_imm, _ in items],
            [tuple(gis) for _, gis in items])


def glwe_blind_rotation(params: Params, ctx: NTTContext, ct, prep_bits,
                        start: int, end: int, lsh: int = 0,
                        negate: bool = True):
    """Rotate ct by X^(+-(bits[start:end] << lsh)): a CMux chain over the
    prepared bits.  Fused (a radix-2 context): ONE launch of kernel 10,
    under the VM truncation.  Composed (a two-pass context): one CMux (a
    batched fold) a bit with the full gadget, as the JAX package's composed
    branch."""
    if end <= start:
        return ct
    sgn = -1 if negate else 1
    amounts = [sgn << (k - start + lsh) for k in range(start, end)]
    if fused_path_active(ctx):
        return circuits.blind_rotate_fused(
            params, ctx, ct[None], prep_bits, range(start, end), amounts,
            trunc=_vm_trunc(params)[0])[0]
    for k, t in zip(range(start, end), amounts):
        ct = circuits.cmux(params, ctx, prep_bits[:, k: k + 1],
                           poly.rotate(ct, t)[None], ct[None])[0]
    return ct


# --------------------------------------------------------------------------
# group circuits
# --------------------------------------------------------------------------

def _dp_group(params: Params, ctx: NTTContext, ops, rs1p, rs2p, immp,
              bits: int):
    """All carry-DP ops as one 2-state DP, MSB -> LSB: one launch, or the
    composed loop (circuits.carry_chain)."""
    specs = [_DP_SPECS[op] for op in ops]
    b_preps, groups = _sources(ops, rs2p, immp)
    F = circuits.carry_chain(params, ctx, [sp[:4] for sp in specs], rs1p,
                             b_preps, groups, bits, _vm_trunc(params, bits)[0])
    return {op: F[gi, sp[4]] for gi, (op, sp) in enumerate(zip(ops, specs))}


def _bitwise_group(params: Params, ctx: NTTContext, ops, rs1p, rs2p, immp,
                   bits: int):
    """All bitwise ops as one 4-leaf truth-table select: one launch, or
    the composed loop (circuits.truth_table)."""
    b_preps, groups = _sources(ops, rs2p, immp)
    out = circuits.truth_table(params, ctx, [_BITWISE_TABLES[op] for op in ops],
                               rs1p, b_preps, groups, bits,
                               _vm_trunc(params, bits)[0])
    return {op: circuits.assemble_word(params, out[:, gi], bits)
            for gi, op in enumerate(ops)}


def _shift_group(params: Params, ctx: NTTContext, ops, rs1p, rs2p, immp,
                 atk, bits: int):
    """All shifts as one slot extraction and one keyed barrel CMux a level
    (log2(bits) levels): shift bit k of each source group is ONE GGSW for
    all its rows; the smaller group is zero-padded to a rectangular row
    count (zero rows stay zero)."""
    G, W = len(ops), bits
    ept, kst = _vm_trunc(params, bits)
    word = circuits.word_from_bits(params, ctx, rs1p, bits)
    slots0 = circuits.extract_slots(params, ctx, word, atk, bits, trunc=kst)
    slots = slots0.expand((G,) + slots0.shape)          # [G, W, C, L, N]
    items = list(_src_groups(ops).items())
    rows_max = W * max(len(gis) for _, gis in items)
    for k in range(W.bit_length() - 1):
        rolled = torch.stack([circuits.barrel_roll(slots[gi], _SHIFT_KINDS[op], 1 << k)
                              for gi, op in enumerate(ops)])
        hs, ls, bks = [], [], []
        for is_imm, gis in items:
            h = rolled[list(gis)].reshape((len(gis) * W,) + slots0.shape[1:])
            lw = slots[list(gis)].reshape((len(gis) * W,) + slots0.shape[1:])
            pad = rows_max - h.shape[0]
            if pad:
                zpad = h.new_zeros((pad,) + h.shape[1:])
                h, lw = torch.cat([h, zpad]), torch.cat([lw, zpad])
            hs.append(h)
            ls.append(lw)
            bks.append((immp if is_imm else rs2p)[:, k: k + 1])
        res = circuits.cmux_keyed(params, ctx, torch.cat(bks, dim=1),
                                  torch.stack(hs), torch.stack(ls), trunc=ept)
        new = [None] * G
        for si, (_, gis) in enumerate(items):
            r = res[si, : len(gis) * W].reshape((len(gis), W) + slots0.shape[1:])
            for idx, gi in enumerate(gis):
                new[gi] = r[idx]
        slots = torch.stack(new)
    return {op: circuits.assemble_word(params, slots[gi], bits)
            for gi, op in enumerate(ops)}


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

def _zero_word(params: Params, device):
    return torch.zeros((params.rank + 1, params.limbs_ct, params.n), dtype=I32,
                       device=device)


def eval_op(params: Params, ctx: NTTContext, op: str, rs1p, rs2p, immp,
            atk, bits: int = 32):
    """One ALU op -> word-form GLWE (the single-op path)."""
    if op == "none":
        return _zero_word(params, rs1p.device)
    if op in _DP_SPECS:
        return _dp_group(params, ctx, (op,), rs1p, rs2p, immp, bits)[op]
    if op in _BITWISE_TABLES:
        return _bitwise_group(params, ctx, (op,), rs1p, rs2p, immp, bits)[op]
    if op in _SHIFT_KINDS:
        return _shift_group(params, ctx, (op,), rs1p, rs2p, immp, atk, bits)[op]
    raise ValueError(op)


def eval_ops(params: Params, ctx: NTTContext, rs1p, rs2p, immp, atk,
             ops=RVI32_OPS, bits: int = 32):
    """Evaluate all ops, result i packed at coefficient offset i, one
    circuit a group."""
    if len(ops) > fheuint.gap(params, bits):
        raise ValueError(f"{len(ops)} packed ops alias under the bits={bits} "
                         f"slot stride (gap={fheuint.gap(params, bits)}); use a "
                         f"larger ring")
    for op in ops:
        if op != "none" and op not in _DP_SPECS and op not in _BITWISE_TABLES \
                and op not in _SHIFT_KINDS:
            raise ValueError(op)
    words = {}
    dp_ops = tuple(op for op in ops if op in _DP_SPECS)
    bw_ops = tuple(op for op in ops if op in _BITWISE_TABLES)
    sh_ops = tuple(op for op in ops if op in _SHIFT_KINDS)
    if dp_ops:
        words.update(_dp_group(params, ctx, dp_ops, rs1p, rs2p, immp, bits))
    if bw_ops:
        words.update(_bitwise_group(params, ctx, bw_ops, rs1p, rs2p, immp, bits))
    if sh_ops:
        words.update(_shift_group(params, ctx, sh_ops, rs1p, rs2p, immp, atk, bits))
    placed = [(i, op) for i, op in enumerate(ops) if op != "none"]  # zero adds nothing
    if not placed:
        return _zero_word(params, rs1p.device)
    rotated = poly.rotate_each(torch.stack([words[op] for _, op in placed]),
                               [i for i, _ in placed])
    return limb_ops.normalize(torch.sum(rotated, dim=0, dtype=I32))


def select_rd(params: Params, ctx: NTTContext, rd_packed, op_id_prep,
              ops_len: int, atk, bits: int = 32):
    """Blind-rotate by the encrypted op id, then clean with the partial
    trace that keeps the word's slot stride."""
    if ops_len > fheuint.gap(params, bits):
        raise ValueError("packed op offsets alias under the kept slot stride")
    log_size = (ops_len - 1).bit_length()
    rd = glwe_blind_rotation(params, ctx, rd_packed, op_id_prep, 0, log_size,
                             negate=True)
    return keyswitch.trace(params, ctx, rd, atk,
                           keep_log=bits.bit_length() - 1)
