"""GGLWE key-switching keys, GLWE automorphisms, and the normalized trace.

Automorphism-keyswitch pipeline (generic in rank):
  1. apply sigma_g to every component of the ct (pure index permutation),
  2. key-switch the a-part back to the original secret using the
     automorphism key: a GGLWE whose digit-row d has phase
     sigma_g(s_i) * 2^-(17(d+1)).

Output:  a_out = -sum_d digit_d(a') (*) k_a^(d)
         b_out =  b' - sum_d digit_d(a') (*) k_b^(d)

Normalized trace: T(ct) = [c_0, 0, ..., 0] via log_n sequential steps
ct <- ct + sigma_{g_k}(ct) after one up-front 1/N pre-scale,
g_k = N/2^k + 1 (params.trace_gal_els).
"""

from __future__ import annotations

import torch

from ..params import Params
from ..ops.ntt import NTTContext, fused_path_active, ntt_fwd
from ..ops.modular import I32
from ..ops import limb as limb_ops
from ..ops import ntt_cuda
from ..ops import poly
from . import glwe, rng


def automorphism_key_encrypt(params: Params, ctx: NTTContext, sk, s_ntt, g: int,
                             source: rng.Source, dnum: int, limbs: int):
    """Automorphism key for galois element g: int32[D, rank, C2, Lk, N].

    Row (d, i) has phase sigma_g(s_i) * 2^-(17(d+1))."""
    rank = params.rank
    sk_g = poly.automorphism(sk, g)  # [rank, N]
    zeros = torch.zeros((dnum, rank, limbs, params.n), dtype=I32, device=sk.device)
    rows = glwe.encrypt(params, ctx, s_ntt, zeros, source)
    for d in range(dnum):
        for i in range(rank):
            rows[d, i, rank, d, :] += sk_g[i]
    return limb_ops.normalize(rows)


def key_prepare(ctx: NTTContext, key):
    """NTT-prepare a GGLWE key: [..., Lk, N] -> [P, ..., Lk, N]."""
    return ntt_fwd(ctx, key)


def truncate_key(key_ntt, in_digits: int | None, key_limbs: int | None):
    """Slice a prepared GGLWE key [P, D, rank, C2, Lk, N] to its top
    in_digits gadget rows and top key_limbs limbs.  Valid because limb
    slicing commutes with the per-limb NTT: the top limbs of a prepared
    key ARE the prepared form of the truncated key."""
    if in_digits is not None:
        key_ntt = key_ntt[:, :in_digits]
    if key_limbs is not None:
        key_ntt = key_ntt[..., :key_limbs, :]
    return key_ntt


def kernel_key_rows(key_ntt):
    """A prepared GGLWE key [P, D, rank, C2, Lk, N] as the fused kernels'
    key rows [P, T, M, N]: T component-major over (mask component,
    digit), M over (c2, key limb)."""
    P, D, rank, C2, Lk, n = key_ntt.shape
    return key_ntt.permute(0, 2, 1, 3, 4, 5).reshape(P, rank * D, C2 * Lk, n)


def keyswitch(params: Params, ctx: NTTContext, ct, key_ntt,
              out_limbs: int | None = None, base_add=None,
              in_digits: int | None = None, key_limbs: int | None = None):
    """Key-switch ct (under the key's source secret) to the key's target
    secret.  ct: int32[..., C, L, N] normalized; key_ntt:
    int32[P, D, rank, C2, Lk, N] with D <= L.

    base_add: optional int32[..., C2, Lout, N] added to the result before
    the final normalize -- callers that compute `x + KS(...)` pass x here.

    in_digits / key_limbs: optional gadget truncation (read-path noise
    trade): decompose only the top in_digits input limbs against the top
    key_limbs key limbs."""
    key_ntt = truncate_key(key_ntt, in_digits, key_limbs)
    P, D, rank, C2, Lk, n = key_ntt.shape
    L = ct.shape[-2]
    assert D <= L and ct.shape[-3] == rank + 1
    Lout = out_limbs if out_limbs is not None else L
    lead_shape = ct.shape[:-3]

    # only the mask components' top D digits are decomposed; b keeps all limbs
    x = ct[..., :rank, :D, :].reshape(-1, rank * D, n)
    base = torch.zeros(lead_shape + (C2, Lout, n), dtype=I32, device=ct.device)
    base[..., C2 - 1, :, :] = limb_ops.resize_limbs(ct[..., rank, :, :], Lout)
    if base_add is not None:
        base = base + base_add
    out = ntt_cuda.fused_external_fold(
        ctx, x, kernel_key_rows(key_ntt)[:, None], Lout, C2,
        base=base.reshape(-1, C2, Lout, n), sign=-1)
    return out.reshape(lead_shape + (C2, Lout, n))


def automorphism_ks(params: Params, ctx: NTTContext, ct, g: int, key_ntt,
                    out_limbs: int | None = None, base_add=None,
                    in_digits: int | None = None,
                    key_limbs: int | None = None):
    """sigma_g applied homomorphically: permute + key-switch."""
    ct_g = poly.automorphism(ct, g)
    return keyswitch(params, ctx, ct_g, key_ntt, out_limbs, base_add=base_add,
                     in_digits=in_digits, key_limbs=key_limbs)


def trace(params: Params, ctx: NTTContext, ct, auto_keys_ntt: dict,
          keep_log: int = 0, trunc: tuple = (None, None)):
    """Normalized partial trace: keeps the 2^keep_log coefficients at
    multiples of N/2^keep_log, zeroes the rest.  keep_log=0 is the full
    trace ([c_0, 0, ..., 0]).

    Construction: pre-scale ONCE by 1/N (exact limb shift), then apply
    the unnormalized steps x <- x + sigma_g(x) over the subgroup tower.
    Halving per step would be unsound: homomorphic torus halving is
    2-valued, and offsets injected mid-loop survive the remaining partial
    trace as fractional garbage.  With the division up-front, every
    mid-loop mod-1 wrap is an integer polynomial, which the remaining
    multiplication-free steps keep integer -- identically 0 mod 1."""
    steps = params.log_n - keep_log
    if steps == 0:
        return ct
    shift = steps
    while shift > 0:
        s = min(shift, params.base2k - 1)
        ct = limb_ops.shift_right(ct, s)
        shift -= s
    ct = limb_ops.normalize(ct)
    return trace_steps(params, ctx, ct, auto_keys_ntt,
                       params.trace_gal_els[:steps], trunc=trunc)


def trace_steps(params: Params, ctx: NTTContext, ct, auto_keys_ntt: dict,
                gals, trunc: tuple = (None, None)):
    """The division-free trace iteration ct <- normalize(ct +
    KS(sigma_g(ct))) for each g in gals, WITHOUT the up-front pre-scale
    (callers pre-scale once; see trace()).  The whole chain is one launch
    of ops.ntt_cuda.fused_trace; on the composed routes (a two-pass
    context: ops.ntt.fused_path_active) one fold launch a step, sigma_g
    and the base in torch.

    trunc = (in_digits, key_limbs): optional read-path gadget truncation
    per step."""
    if not gals:
        return ct
    in_digits, key_limbs = trunc
    lead = ct.shape[:-3]
    rows = [kernel_key_rows(truncate_key(auto_keys_ntt[g], in_digits, key_limbs))
            for g in gals]  # [P, T, M, N] a step
    ct2 = ct.reshape((-1,) + ct.shape[-3:])
    if not fused_path_active(ctx):
        Td = rows[0].shape[1] // (ct.shape[-3] - 1)
        for g, key in zip(gals, rows):
            ct2 = ntt_cuda.trace_step(ctx, ct2, key, g, Td,
                                      ntt_cuda.fused_external_fold)
        return ct2.reshape(ct.shape)
    out = ntt_cuda.fused_trace(ctx, ct2, torch.stack(rows, dim=0), tuple(gals))
    return out.reshape(lead + out.shape[1:])


# most leaves of the one-launch split tree (the bound the reference routes
# by; larger extractions take the per-level kernel)
_SPLIT_TREE_MAX = 64


def extract_slots(params: Params, ctx: NTTContext, ct, count: int,
                  auto_keys_ntt: dict, bounded_support: bool = False,
                  dilate: int = 1, residue=None, tree: bool = False):
    """All-slot extraction: out[..., m, :, :, :] = trace(X^-m ct) for
    m in [0, count), i.e. per slot an encryption of [slot_m(ct), 0...].

    A binary split tree: sigma_{g_l} commutes with X^{-2^j} for j > l, so
    trace(X^-m ct) = prod_l (1 + sigma_{g_l}) X^{-m_l 2^l} (ct/N); level l
    branches on bit l of m and the remaining log_n - ceil(log2 count)
    steps run once per leaf.  One keyswitch a parent node feeds both
    children (ops.ntt_cuda.fused_split: one launch a level); the tail is
    one launch of fused_trace.

    tree=True: all levels in ONE launch (ops.ntt_cuda.fused_split_tree)
    when dilate == 1 and the tree has 2 .. 64 leaves; the same integers.
    A two-pass context (the composed routes, ops.ntt.fused_path_active)
    refuses it: there each level is one trace step plus X^-t (2x - child0),
    one fold launch a level (the JAX package ignores its tree there).

    bounded_support=True: the caller guarantees that ct's plaintext is
    exactly zero outside slots [0, count) (the write path's deltas).
    Then, when count * 2^ceil(log2 count) <= N, the tail steps are
    plaintext-exactly unnecessary and are skipped, and the pre-scale
    shrinks to 1/2^s.  Without the flag every leaf passes log_n
    keyswitches after the single 1/N pre-scale.

    dilate / residue (the row-sharded write): return ONLY the slots m
    with m = residue (mod dilate), ordered by m // dilate --
    out[..., j, :, :, :] = trace(X^-(j*dilate+residue) ct).  Split level l
    branches on bit l of m (LSB first), so after the first log2(dilate)
    levels node k holds exactly the residue-k subtree: the caller's node
    is selected there (residue: an int or a 0-dim integer tensor) and the
    remaining levels and the tail run on 1/dilate of the tree.  count must
    be a multiple of dilate; s, tail and pre-scale are the global
    quantities."""
    n = params.n
    if tree and not fused_path_active(ctx):
        raise ValueError("the one-launch split tree has no two-pass body: "
                         "a composed-route context extracts level by level")
    s = max(count - 1, 0).bit_length()  # ceil(log2(count))
    assert (1 << s) <= n
    assert dilate >= 1 and dilate & (dilate - 1) == 0 and dilate <= (1 << s)
    log_d = dilate.bit_length() - 1
    if dilate > 1:
        assert residue is not None and count % dilate == 0
    tail = params.log_n - s
    if bounded_support and count << s <= n:
        tail = 0
    shift = s + tail
    x = ct
    while shift > 0:
        step = min(shift, params.base2k - 1)
        x = limb_ops.shift_right(x, step)
        shift -= step
    nodes = limb_ops.normalize(x)[..., None, :, :, :]
    gals = params.trace_gal_els

    def select(nodes):
        # the caller's subtree: node index == low log_d bits of m
        dim = nodes.dim() - 4
        if torch.is_tensor(residue):
            return nodes.index_select(dim, residue.reshape(1).to(torch.long))
        return nodes.narrow(dim, int(residue), 1)

    if tree and dilate == 1 and s >= 1 and (1 << s) <= _SPLIT_TREE_MAX:
        keys = torch.stack([kernel_key_rows(auto_keys_ntt[gals[l]])
                            for l in range(s)], dim=0)  # [s, P, T, M, N]
        lead = nodes.shape[:-4]
        flat = nodes[..., 0, :, :, :].reshape((-1,) + nodes.shape[-3:])
        leaves = ntt_cuda.fused_split_tree(ctx, flat, tuple(gals[:s]), keys)
        leaves = leaves.reshape(lead + leaves.shape[1:])
        out = trace_steps(params, ctx, leaves, auto_keys_ntt, gals[s: s + tail])
        return out[..., :count, :, :, :]

    for l in range(s):
        if dilate > 1 and l == log_d:
            nodes = select(nodes)
        # level l: A = KS(sigma_g x); child0 = x + A (the 1 + sigma_g
        # branch); child1 = X^-t x + KS(sigma_g(X^-t x)) = X^-t (x - A),
        # since sigma_g(X^-t) = -X^-t for t = 2^l, g = N/2^l + 1
        g = gals[l]
        lead = nodes.shape[:-3]
        flat = nodes.reshape((-1,) + nodes.shape[-3:])
        key = kernel_key_rows(auto_keys_ntt[g])
        if fused_path_active(ctx):
            c0, c1 = ntt_cuda.fused_split(ctx, flat, 1 << l, g, key)
        else:
            c0, c1 = ntt_cuda.split_level(ctx, flat, 1 << l, g, key,
                                          ntt_cuda.fused_external_fold)
        nodes = torch.cat([c0.reshape(lead + c0.shape[1:]),
                           c1.reshape(lead + c1.shape[1:])], dim=-4)
    if dilate > 1 and log_d == s:
        nodes = select(nodes)
    out = trace_steps(params, ctx, nodes, auto_keys_ntt, gals[s: s + tail])
    return out[..., : count // dilate, :, :, :]
