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
from ..ops.ntt import NTTContext, ntt_fwd
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
    of ops.ntt_cuda.fused_trace.

    trunc = (in_digits, key_limbs): optional read-path gadget truncation
    per step."""
    if not gals:
        return ct
    in_digits, key_limbs = trunc
    lead = ct.shape[:-3]
    keys = torch.stack(
        [kernel_key_rows(truncate_key(auto_keys_ntt[g], in_digits, key_limbs))
         for g in gals], dim=0)  # [S, P, T, M, N]
    out = ntt_cuda.fused_trace(ctx, ct.reshape((-1,) + ct.shape[-3:]), keys,
                               tuple(gals))
    return out.reshape(lead + out.shape[1:])
