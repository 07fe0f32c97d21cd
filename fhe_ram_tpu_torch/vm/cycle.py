"""One full encrypted VM instruction cycle.

    eval_ops -> select_rd            (ALU and register write-back)
    select_store                     (store-width / offset merge)
    fheuint_to_address               (encrypted pointer -> RAM address)
    rpw_impl -> write_impl           (fetch and store at the pointer)

The one representation bridge it needs is `word_to_ram_bytes`: the word
form carries bit j of the value at coefficient j * gap, while the RAM
stores byte i of a word as a signed-i8 VALUE at slot 0 of subram i.  One
batched trace extracts all `bits` bit slots, then exact +-2^k weighted
sums assemble the signed bytes.  The reverse bridge (RAM bytes back to
bits) is a bootstrapping-class bit decomposition, not part of the cycle.

Nothing is updated in place: the RAM's new state is returned, as
FheRam.write returns it.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..params import Params
from ..ops.ntt import NTTContext
from ..ops.modular import I32
from ..ops import limb as limb_ops
from ..ops import poly
from ..core import keyswitch
from ..core import keys as keys_mod
from ..ram import ram as ram_mod
from . import arithmetic, conversion, fheuint, store
from .arithmetic import RVI32_OPS

_BYTE_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, -128)


def word_to_ram_bytes(params: Params, ctx: NTTContext, word_ct, atk,
                      bits: int = 32):
    """Word-form GLWE -> RAM write word [bits // 8, C, L, N]:
    byte i = sum_{k<7} 2^k bit_{8i+k} - 128 bit_{8i+7}, the RAM's signed-i8
    byte, at slot 0; all `bits` extractions as ONE batched trace."""
    if bits % 8:
        raise ValueError(f"{bits} bits are not whole bytes")
    g = fheuint.gap(params, bits)
    rots = poly.rotate_each(word_ct.expand((bits,) + tuple(word_ct.shape)),
                            [-(j * g) for j in range(bits)])
    ext = keyswitch.trace(params, ctx, rots, atk)        # [bits, C, L, N]
    ext = ext.reshape((bits // 8, 8) + tuple(word_ct.shape))
    w = _byte_weights(word_ct.device)
    return limb_ops.normalize(torch.sum(ext * w[None, :, None, None, None],
                                        dim=1, dtype=I32))


@lru_cache(maxsize=None)
def _byte_weights(device):
    """The weights on the device, made once (a copy from the host each
    cycle would make the host wait for the card)."""
    return torch.tensor(_BYTE_WEIGHTS, dtype=I32, device=device)


def vm_cycle(params: Params, ctx: NTTContext,
             keys: keys_mod.EvaluationKeysPrepared,
             rs1p, rs2p, immp, op_id_prep,
             rs2_word, loaded_word, offset_prep, storeop_prep,
             ptr_prep, data, ops=RVI32_OPS, bits: int = 32):
    """One encrypted instruction cycle; every argument but the keys is a
    ciphertext, and the server learns nothing.

      rs1p / rs2p / immp: the ALU operands, prepared bits
      op_id_prep: the ALU op selector (its bits rotate by 1, 2, 4, ...)
      rs2_word / loaded_word: the store operands, word form
      offset_prep / storeop_prep: the store byte offset and width selectors
      ptr_prep: the store pointer, prepared bits at the GGSW-apply
        parameterization (encrypt_prepared(dnum=params.dnum_ggsw,
        limbs=params.limbs_evk_ggsw))
      data: the RAM state int32[W, R, C, L, N]

    Returns (rd, fetched, new_data): the ALU result (register write-back),
    the RAM word at the pointer before the store, and a NEW RAM state with
    select_store's merged word written at the pointer.

    The context picks the routes (ops.ntt.fused_path_active): a radix-2
    context the fused kernels, a two-pass context the composed routes (the
    JAX package's FHERAM_MXU=0), every CMux chain, merge, trace step and
    split level a fold launch and torch glue.  fetched and new_data are the
    same integers on both; rd too where the params do not truncate the
    read path, else the composed rd is select_rd's full-gadget one (see
    vm.arithmetic)."""
    if bits != 8 * params.word_size:
        raise ValueError(f"the cycle writes {bits // 8} bytes into words of "
                         f"{params.word_size}")
    atk = keys.atk_glwe
    packed = arithmetic.eval_ops(params, ctx, rs1p, rs2p, immp, atk, ops, bits)
    rd = arithmetic.select_rd(params, ctx, packed, op_id_prep, len(ops), atk,
                              bits)
    sw = store.select_store(params, ctx, rs2_word, loaded_word, offset_prep,
                            storeop_prep, atk, bits)
    addr, addr_prep = conversion.fheuint_to_address(params, ctx, ptr_prep)
    fetched, data2, tree = ram_mod.rpw_impl(params, ctx, data,
                                            addr_prep.coordinates, atk)
    wbytes = word_to_ram_bytes(params, ctx, sw, atk, bits)
    data3 = ram_mod.write_impl(params, ctx, data2, tree, wbytes,
                               addr.coordinates, keys)
    return rd, fetched, data3
