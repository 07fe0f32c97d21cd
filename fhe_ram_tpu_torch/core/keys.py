"""Evaluation-key generation and preparation.

Key set:
  * atk_glwe: one automorphism key per trace galois element
    (k_evk_trace, dnum_ct digit-rows),
  * atk_ggsw: automorphism keys at the GGSW parameterization
    (k_evk_ggsw, one per galois element used on GGSWs; the RAM write
    needs only g = -1),
  * tsk: the GGLWE->GGSW tensor key -- one GGSW(-s_c) per secret
    component c, stacked [rank, D, C, C2, Lg, N].

`keygen` makes the whole set; the read consumes atk_glwe only, the write
also atk_ggsw[-1] and tsk (ggsw_automorphism_inv).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..params import Params
from ..ops.ntt import get_ntt_context
from . import glwe, ggsw, keyswitch, rng


@dataclass
class EvaluationKeys:
    """Coefficient-domain keys (client-side output of keygen)."""

    atk_glwe: dict       # {g: int32[D, rank, C2, L_trace, N]}
    atk_ggsw: dict       # {g: int32[D_ggsw, rank, C2, L_ggswk, N]}
    tsk: torch.Tensor    # stacked GGSW(-s_c): [rank, D_ggsw, C, C2, L_ggswk, N]

    @property
    def atk_ggsw_inv(self):
        """The p = -1 key (the one the RAM write path consumes)."""
        return self.atk_ggsw[-1]


@dataclass
class EvaluationKeysPrepared:
    """NTT-domain keys (server side)."""

    atk_glwe: dict       # {g: int32[P, D, rank, C2, L_trace, N]}
    atk_ggsw: dict
    tsk: torch.Tensor    # [P, rank, D, C, C2, Lg, N]

    @property
    def atk_ggsw_inv(self):
        return self.atk_ggsw[-1]


def keygen(params: Params, sk, source: rng.Source,
           ggsw_gal_els: tuple[int, ...] = (-1,)) -> EvaluationKeys:
    """Generate all evaluation keys under secret sk (int32[rank, N]), on
    sk's device.  ggsw_gal_els selects the galois elements usable on
    GGSWs (default: only the inversion map p = -1)."""
    ctx = get_ntt_context(params.n, params.primes)
    s_ntt = glwe.secret_prepare(ctx, sk)

    atk = {}
    for g in params.trace_gal_els:
        atk[g] = keyswitch.automorphism_key_encrypt(
            params, ctx, sk, s_ntt, g, source,
            dnum=params.dnum_ct, limbs=params.limbs_evk_trace)

    atk_ggsw = {}
    for g in ggsw_gal_els:
        atk_ggsw[g] = keyswitch.automorphism_key_encrypt(
            params, ctx, sk, s_ntt, g, source,
            dnum=params.dnum_ggsw, limbs=params.limbs_evk_ggsw)

    tsk = torch.stack([
        ggsw.encrypt(params, ctx, s_ntt, -sk[c], source,
                     dnum=params.dnum_ggsw, limbs=params.limbs_evk_ggsw)
        for c in range(params.rank)
    ], dim=0)

    return EvaluationKeys(atk_glwe=atk, atk_ggsw=atk_ggsw, tsk=tsk)


def prepare(params: Params, keys: EvaluationKeys) -> EvaluationKeysPrepared:
    ctx = get_ntt_context(params.n, params.primes)
    return EvaluationKeysPrepared(
        atk_glwe={g: keyswitch.key_prepare(ctx, k) for g, k in keys.atk_glwe.items()},
        atk_ggsw={g: keyswitch.key_prepare(ctx, k) for g, k in keys.atk_ggsw.items()},
        tsk=ggsw.prepare(ctx, keys.tsk),
    )


def ggsw_automorphism(params: Params, ctx, ggsw_ct, g: int,
                      keys: EvaluationKeysPrepared):
    """Map GGSW(mu) (coefficient domain, [..., D, C, C2, Lg, N]) to
    GGSW(sigma_g(mu)) -- for monomials with g = -1:
    GGSW(X^e) -> GGSW(X^-e).  Leading axes are a batch of GGSWs under the
    same keys: all their rows go through each keyswitch launch together,
    and every row's integers are those of a call on its GGSW alone.

    Requires the galois element's GGSW-level key (keygen ggsw_gal_els).
    Generic in rank: the b-rows are keyswitched under sigma_g, then every
    a-row c is rebuilt as b-row x tsk[c]."""
    D, C, C2, Lg, n = ggsw_ct.shape[-5:]
    rank = params.rank
    assert C == rank + 1 and C2 == rank + 1
    assert g in keys.atk_ggsw, f"no GGSW automorphism key for g={g}"
    # b-rows: (d, c=rank) -- GLWEs encrypting mu * g_d.  Batch over d.
    rowb = keyswitch.automorphism_ks(params, ctx, ggsw_ct[..., rank, :, :, :], g,
                                     keys.atk_ggsw[g], out_limbs=Lg)
    # a-rows: encryptions of -s_c * sigma(mu) * g_d via the tensor key.
    rows = [ggsw.external_product(params, ctx, rowb, keys.tsk[:, c],
                                  out_limbs=Lg)
            for c in range(rank)]
    rows.append(rowb)
    return torch.stack(rows, dim=-4)  # [..., D, C(=rank+1), C2, Lg, N]


def ggsw_automorphism_inv(params: Params, ctx, ggsw_ct,
                          keys: EvaluationKeysPrepared):
    """GGSW(X^e) -> GGSW(X^-e): the write path's inversion."""
    return ggsw_automorphism(params, ctx, ggsw_ct, -1, keys)
