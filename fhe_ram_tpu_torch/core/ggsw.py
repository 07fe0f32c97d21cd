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
.fused_external_fold on the GPU, its plain version on the CPU.
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
