"""GGSW ciphertexts and the external product (the hot kernel).

GGSW(mu) layout (coefficient domain): int32[D, C, C2, Lg, N] where
  D  = dnum gadget digit-rows,
  C  = rank+1 input components (which ct component the digit multiplies),
  C2 = rank+1 output components (each row is a GLWE),
  Lg = limbs of the row precision (k_ggsw).
Row (d, c) = Enc(0) + mu * 2^-(17(d+1)) added to component c.

Prepared (NTT-domain) form: int32[P, D, C, C2, Lg, N].

External product: the GLWE's (normalized) limbs are the gadget digits;
forward NTT, multiply-accumulate against the prepared GGSW rows, inverse
NTT, CRT-fold back into limbs -- one launch of ops.ntt_cuda
.fused_external_fold on the GPU, its plain version on the CPU.  The
batched and keyed forms (one GGSW per item, or per group of rows) are one
launch of ops.ntt_cuda.fused_external_fold_batched.
"""

from __future__ import annotations

import torch

from ..params import Params
from ..ops.ntt import NTTContext, ntt_fwd
from ..ops.modular import I32
from ..ops import limb as limb_ops
from ..ops import ntt_cuda
from . import glwe, rng


def encrypt(params: Params, ctx: NTTContext, s_ntt, mu, source: rng.Source,
            dnum: int | None = None, limbs: int | None = None):
    """GGSW(mu) for a small integer polynomial mu (int32[N]), on s_ntt's
    device.  dnum defaults to params.dnum_ct (address GGSW); limbs to
    params.limbs_ggsw."""
    D = dnum if dnum is not None else params.dnum_ct
    Lg = limbs if limbs is not None else params.limbs_ggsw
    C = params.rank + 1
    device = s_ntt.device
    zeros = torch.zeros((D, C, Lg, params.n), dtype=I32, device=device)
    rows = glwe.encrypt(params, ctx, s_ntt, zeros, source)  # [D, C, C2, Lg, N]
    mu = torch.as_tensor(mu, dtype=I32).to(device)
    for d in range(D):
        for c in range(C):
            rows[d, c, c, d, :] += mu
    return limb_ops.normalize(rows)


def prepare(ctx: NTTContext, ggsw):
    """Forward-NTT every row limb: [D, C, C2, Lg, N] -> [P, D, C, C2, Lg, N]."""
    return ntt_fwd(ctx, ggsw)


def external_product(params: Params, ctx: NTTContext, ct, ggsw_ntt,
                     out_limbs: int | None = None):
    """GLWE(m) x GGSW(mu) -> GLWE(mu*m).

    ct: int32[..., C, L, N] normalized (its limbs are the gadget digits).
    ggsw_ntt: int32[P, D, C, C2, Lg, N] with D <= L (D < L = gadget
    truncation: only the top D digits are consumed).
    Returns int32[..., C2, out_limbs, N] normalized (default out = L)."""
    P, D, C, C2, Lg, n = ggsw_ntt.shape
    L = ct.shape[-2]
    assert ct.shape[-3] == C and D <= L, (ct.shape, ggsw_ntt.shape)
    Lout = out_limbs if out_limbs is not None else L
    lead_shape = ct.shape[:-3]
    # T runs component-major over (c, d); M over (c2, key limb)
    x = ct[..., :D, :].reshape(-1, C * D, n)
    keys = ggsw_ntt.permute(0, 2, 1, 3, 4, 5).reshape(P, 1, C * D, C2 * Lg, n)
    out = ntt_cuda.fused_external_fold(ctx, x, keys, Lout, C2)
    return out.reshape(lead_shape + (C2, Lout, n))


def external_product_batched(params: Params, ctx: NTTContext, ct, ggsw_ntt,
                             out_limbs: int | None = None, base=None,
                             sign: int = 1):
    """Batched GLWE x GGSW where each batch element has its own GGSW.

    ct: int32[B, C, L, N]; ggsw_ntt: int32[P, B, D, C, C2, Lg, N], D == L.
    ct's limbs are consumed as the gadget digits directly and may be
    unnormalized (any int32 is reduced on load), so CMux callers pass
    high - low without a normalize pass.
    base: optional int32[B, C2, Lout, N]:
      out = normalize(base + sign * (ct x ggsw))."""
    P, B, D, C, C2, Lg, n = ggsw_ntt.shape
    L = ct.shape[-2]
    assert tuple(ct.shape) == (B, C, L, n) and D == L, (ct.shape, ggsw_ntt.shape)
    Lout = out_limbs if out_limbs is not None else L
    x = ct.reshape(B, 1, C * D, n)
    # [P, B, D, C, C2, Lg, N] -> [B, P, 1, C*D, C2*Lg, N]
    keys = ggsw_ntt.permute(1, 0, 3, 2, 4, 5, 6).reshape(
        B, P, 1, C * D, C2 * Lg, n)
    bb = None if base is None else base.reshape(B, 1, C2, Lout, n)
    out = ntt_cuda.fused_external_fold_batched(ctx, x, keys, Lout, C2,
                                               base=bb, sign=sign)
    return out.reshape(B, C2, Lout, n)


def external_product_keyed(params: Params, ctx: NTTContext, ct, ggsw_ntt,
                           out_limbs: int | None = None, base=None,
                           sign: int = 1, trunc: tuple = (None, None)):
    """GLWE x GGSW with K distinct GGSWs, each applied to B rows:
    ct: int32[K, B, C, L, N]; ggsw_ntt: int32[P, K, D, C, C2, Lg, N];
    base: optional int32[K, B, C2, Lout, N].  Each key is read once for
    its group of rows.

    trunc = (in_digits, key_limbs): optional gadget truncation:
    decompose only the top in_digits ct limbs against GGSW rows sliced to
    key_limbs.  A GGSW with fewer digit rows than ct has limbs truncates
    the same way.  The output keeps the pre-truncation limb count unless
    out_limbs says otherwise."""
    in_digits, key_limbs = trunc
    L_full = ct.shape[-2]
    if in_digits is not None:
        ggsw_ntt = ggsw_ntt[:, :, :in_digits]
        ct = ct[..., :in_digits, :]
    if key_limbs is not None:
        ggsw_ntt = ggsw_ntt[..., :key_limbs, :]
    P, K, D, C, C2, Lg, n = ggsw_ntt.shape
    if D < ct.shape[-2]:
        ct = ct[..., :D, :]
    K2, B, C3, L, n2 = ct.shape
    assert K2 == K and C3 == C and D == L and n2 == n, (ct.shape, ggsw_ntt.shape)
    Lout = out_limbs if out_limbs is not None else L_full
    x = ct.reshape(K, B, C * D, n)
    keys = ggsw_ntt.permute(1, 0, 3, 2, 4, 5, 6).reshape(
        K, P, 1, C * D, C2 * Lg, n)
    return ntt_cuda.fused_external_fold_batched(ctx, x, keys, Lout, C2,
                                                base=base, sign=sign)
