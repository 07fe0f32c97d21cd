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

import warnings

import torch

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


# most leaves of the one-launch pack tree (the bound the reference routes
# by: a wider pack runs per-level merges until this many remain)
_TREE_MAX = 32

# The one-launch tree kernel takes the full gadget only: with tree=True a
# gadget-truncated pack (the read path of the READOPT presets) keeps the
# per-level merge kernels.  Said once, so that the option's partial
# coverage is visible (the integers are the same either way).
_warned_tree_trunc = False


def _warn_tree_trunc():
    global _warned_tree_trunc
    if not _warned_tree_trunc:
        _warned_tree_trunc = True
        warnings.warn(
            "tree kernels: gadget-truncated packs (the read path of the "
            "READOPT presets) keep the per-level merge kernels; the "
            "one-launch pack tree runs full-gadget packs only",
            stacklevel=3)


def _pack_tree_fused(params: Params, ctx: NTTContext, cts, auto_keys_ntt):
    """All remaining levels in ONE launch (ops.ntt_cuda.fused_pack_tree).
    cts: [M, ..., C, L, N] pre-scaled, M <= _TREE_MAX."""
    M = cts.shape[0]
    n = params.n
    levels = M.bit_length() - 1
    lead = cts.shape[1:-3]
    flat = cts.reshape((M, -1) + cts.shape[-3:])
    keys = torch.stack(
        [keyswitch.kernel_key_rows(auto_keys_ntt[(n >> (levels - 1 - s)) + 1])
         for s in range(levels)], dim=0)  # merge order
    out = ntt_cuda.fused_pack_tree(ctx, flat, keys)
    return out.reshape(lead + cts.shape[-3:])


def pack_tree(params: Params, ctx: NTTContext, cts, auto_keys_ntt: dict,
              dilate: int = 1, prescale: bool = True,
              trunc: tuple = (None, None)):
    """The dilated pack tree: packs cts[M, ..., C, L, N] so that leaf j's
    slot-0 value lands at coefficient j * dilate.

    This is the sub-tree of a (dilate*M)-leaf global pack restricted to
    the leaves congruent to a fixed residue mod `dilate` -- level ll here
    is global level ll + log2(dilate), so merges use stride
    t = dilate * 2^ll and galois g = N/(dilate*2^ll) + 1.  dilate=1,
    prescale=True reproduces pack()'s math.

    For a row-sharded pack (a shard holds the global leaves congruent to
    its index mod the shard count, runs pack_tree(dilate=shards), and the
    gathered roots finish with pack_tree(dilate=1, prescale=False)).
    prescale=True scales by the FULL global leaf count (M * dilate), so
    that the tail merges stay division-free."""
    M = cts.shape[0]
    n = params.n
    assert M & (M - 1) == 0, "pad input count to a power of two"
    assert dilate & (dilate - 1) == 0
    levels = M.bit_length() - 1
    log_d = dilate.bit_length() - 1
    assert levels + log_d <= params.log_n
    if prescale:
        shift = levels + log_d
        while shift > 0:
            s = min(shift, params.base2k - 1)
            cts = limb_ops.shift_right(cts, s)
            shift -= s
        # no normalize needed: see pack() (post-shift limbs <= 2^17)
    for ll in range(levels - 1, -1, -1):
        l = ll + log_d
        g = (n >> l) + 1
        cts = _merge_level(params, ctx, cts[: 1 << ll], cts[1 << ll: 2 << ll],
                           1 << l, g, auto_keys_ntt[g], trunc=trunc)
    return cts[0]


def pack_prefix(params: Params, ctx: NTTContext, cts, auto_keys_ntt: dict,
                stop_nodes: int, trunc: tuple = (None, None)):
    """The SHALLOW levels of pack(): merge cts[M, ...] down to stop_nodes
    surviving nodes and return them [stop_nodes, ..., C, L, N] --
    prescaled by the FULL 1/M up-front, so the caller finishes with
    pack_tree(dilate=1, prescale=False), possibly with other batch
    members folded into the row axis first."""
    M = cts.shape[0]
    n = params.n
    assert M & (M - 1) == 0 and stop_nodes & (stop_nodes - 1) == 0
    assert 1 <= stop_nodes <= M
    levels = M.bit_length() - 1
    stop_log = stop_nodes.bit_length() - 1
    cts = limb_ops.shift_right(cts, levels)  # full prescale (see pack)
    for l in range(levels - 1, stop_log - 1, -1):
        t = 1 << l
        g = (n >> l) + 1
        cts = _merge_level(params, ctx, cts[:t], cts[t: 2 * t], t, g,
                           auto_keys_ntt[g], trunc=trunc)
    return cts


def pack(params: Params, ctx: NTTContext, cts, auto_keys_ntt: dict,
         trunc: tuple = (None, None), tree: bool = False):
    """Pack cts[M, ..., C, L, N] (slot-0 values v_m) into one ct whose
    coefficient m equals v_m for all m < M.  M must be a power of two
    (pad with zero ciphertexts otherwise -- an all-zero ct is an exact
    encryption of 0).  trunc = (in_digits, key_limbs): optional read-path
    gadget truncation of the merge keyswitches.

    tree=True: a full-gadget pack runs per-level merges until at most 32
    leaves remain, then the whole remaining tree in ONE launch
    (ops.ntt_cuda.fused_pack_tree); the same integers."""
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
    if tree and trunc != (None, None):
        _warn_tree_trunc()
    if tree and trunc == (None, None):
        while cts.shape[0] > _TREE_MAX:
            l = cts.shape[0].bit_length() - 2
            g = (n >> l) + 1
            cts = _merge_level(params, ctx, cts[: 1 << l], cts[1 << l: 2 << l],
                               1 << l, g, auto_keys_ntt[g])
        return _pack_tree_fused(params, ctx, cts, auto_keys_ntt)
    for l in range(levels - 1, -1, -1):
        t = 1 << l
        g = (n >> l) + 1
        cts = _merge_level(params, ctx, cts[:t], cts[t: 2 * t], t, g,
                           auto_keys_ntt[g], trunc=trunc)
    return cts[0]
