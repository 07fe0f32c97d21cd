"""Log-depth batched GLWE packing.

Packing M ciphertexts is a balanced binary tree with log2(M) *batched*
merge levels; every level is one batched automorphism-keyswitch over all
surviving pairs.

Merge rule (merging into level l, stride t = 2^l, galois g = N/2^l + 1):

    C = (A + X^t B) + sigma_g(A - X^t B)        [unnormalized]

sigma_g fixes coefficients at multiples of 2^(l+1) and negates odd
multiples of 2^l, so C inherits A's values at even multiples of 2^l and
B's at odd ones, times 2 per level.  The 1/M normalization is done ONCE
up-front by an exact limb shift of the inputs: mid-loop divisions are
unsound (see core/keyswitch.trace), whereas with pre-scaling every
mid-loop mod-1 wrap is an integer polynomial that the remaining
division-free merges keep integer, i.e. 0 mod 1.

No cleanup levels: the packed result is later passed through a rotation
and a full normalized trace, which only reads coefficients j < M, so
leaves only need a correct coefficient 0 -- which raw external-product
outputs already provide.
"""

from __future__ import annotations

from ..params import Params
from ..ops.ntt import NTTContext
from ..ops import limb as limb_ops
from ..ops import ntt_cuda
from . import keyswitch


def _merge_level(params: Params, ctx: NTTContext, A, B, t: int, g: int,
                 key_ntt, trunc: tuple = (None, None)):
    """One batched merge: normalize(A + X^t B + KS(sigma_g(A - X^t B))).

    The rotate, the u/v combination and the automorphism all run inside
    the keyswitch kernel (ops.ntt_cuda.fused_pack_merge).  trunc =
    (in_digits, key_limbs): optional read-path gadget truncation."""
    in_digits, key_limbs = trunc
    lead = A.shape[:-3]
    A2 = A.reshape((-1,) + A.shape[-3:])
    B2 = B.reshape(A2.shape)
    k2 = keyswitch.kernel_key_rows(
        keyswitch.truncate_key(key_ntt, in_digits, key_limbs))
    out = ntt_cuda.fused_pack_merge(ctx, A2, B2, t, g, k2)
    return out.reshape(lead + out.shape[1:])


def pack(params: Params, ctx: NTTContext, cts, auto_keys_ntt: dict,
         trunc: tuple = (None, None)):
    """Pack cts[M, ..., C, L, N] (slot-0 values v_m) into one ct whose
    coefficient m equals v_m for all m < M.  M must be a power of two
    (pad with zero ciphertexts otherwise -- an all-zero ct is an exact
    encryption of 0).  trunc = (in_digits, key_limbs): optional read-path
    gadget truncation of the merge keyswitches."""
    M = cts.shape[0]
    n = params.n
    assert M & (M - 1) == 0, "pad input count to a power of two"
    levels = M.bit_length() - 1
    if levels == 0:
        return cts[0]
    # pre-scale by 1/M once (exact limb shift).  No normalize: the shifted
    # limbs are bounded by 2^17, so the first merge level's u/v digits stay
    # <= 2^18, which the transforms reduce like any int32; deeper levels
    # consume normalized outputs.
    cts = limb_ops.shift_right(cts, levels)
    for l in range(levels - 1, -1, -1):
        t = 1 << l
        g = (n >> l) + 1
        cts = _merge_level(params, ctx, cts[:t], cts[t: 2 * t], t, g,
                           auto_keys_ntt[g], trunc=trunc)
    return cts[0]
