"""FheUint: encrypted machine words for the VM.

Two forms:

  * word form: ONE GLWE with bit j of the value encoded as bit * 2^-k_pt
    at coefficient j * gap, gap = N / bits;
  * prepared form: per-bit GGSW(bit_j) in the NTT domain,
    int32[P, W, D, C, C2, Lg, N] -- what the CMux chains consume.
"""

from __future__ import annotations

import numpy as np
import torch

from ..params import Params
from ..ops.ntt import NTTContext
from ..ops.modular import I32
from ..ops import limb as limb_ops
from ..core import glwe, ggsw, rng


def gap(params: Params, bits: int = 32) -> int:
    """Coefficient stride of the word form; a ring whose degree `bits`
    does not divide is refused (its slots would alias)."""
    if bits < 1 or params.n % bits:
        raise ValueError(f"{bits}-bit words do not tile a ring of degree {params.n}")
    return params.n // bits


def _word_values(params: Params, slot_vals, bits: int):
    g = gap(params, bits)
    vals = np.zeros(params.n, dtype=np.int64)
    for j, v in enumerate(slot_vals):
        vals[j * g] = int(v)
    return vals


def encrypt_word(params: Params, ctx: NTTContext, s_ntt, value: int,
                 source: rng.Source, bits: int = 32):
    """Word-form GLWE of `value`, on s_ntt's device."""
    pt = glwe.encode_vec(params, _word_values(
        params, [(value >> j) & 1 for j in range(bits)], bits), device=s_ntt.device)
    return glwe.encrypt(params, ctx, s_ntt, pt, source)


def encrypt_prepared(params: Params, ctx: NTTContext, s_ntt, value: int,
                     source: rng.Source, bits: int = 32,
                     dnum: int | None = None, limbs: int | None = None):
    """Prepared GGSW(bit_j) of every bit, int32[P, W, D, C, C2, Lg, N].

    dnum / limbs default to the ct-level GGSW layout (dnum_ct, limbs_ggsw);
    the pointer of the address conversion takes (dnum_ggsw, limbs_evk_ggsw):
    its bits must carry one digit per limb of the rows they rotate."""
    D = dnum if dnum is not None else params.dnum_ct
    Lg = limbs if limbs is not None else params.limbs_ggsw
    C = params.rank + 1
    zeros = torch.zeros((bits, D, C, Lg, params.n), dtype=I32, device=s_ntt.device)
    rows = glwe.encrypt(params, ctx, s_ntt, zeros, source)  # [W, D, C, C2, Lg, N]
    for j in range(bits):
        if (value >> j) & 1:
            for d in range(D):
                for c in range(C):
                    rows[j, d, c, c, d, 0] += 1
    return ggsw.prepare(ctx, limb_ops.normalize(rows))


def decrypt_word(params: Params, ctx: NTTContext, s_ntt, ct,
                 bits: int = 32) -> int:
    """Decode a word-form GLWE back to an integer (client side)."""
    g = gap(params, bits)
    t = limb_ops.torus_float(glwe.phase(params, ctx, s_ntt, ct).cpu().numpy())
    out = 0
    for j in range(bits):
        out |= (int(np.rint(t[j * g] * (1 << params.k_pt))) & 1) << j
    return out


def word_noise_log2(params: Params, ctx: NTTContext, s_ntt, ct, value: int,
                    bits: int = 32) -> float:
    """log2 of the worst distance of a word's bit slots from their
    plaintext bits (client side)."""
    g = gap(params, bits)
    t = limb_ops.torus_float(glwe.phase(params, ctx, s_ntt, ct).cpu().numpy())
    worst = 2.0 ** -120
    for j in range(bits):
        frac = t[j * g] - ((value >> j) & 1) * 2.0 ** -params.k_pt
        worst = max(worst, abs(frac - np.rint(frac)))
    return float(np.log2(worst))


def trivial_words(params: Params, slot_vals_list, bits: int = 32,
                  device="cuda"):
    """Noise-free 'encryptions' (zero mask) of K words of per-slot integer
    values placed at coefficients j * gap: int32[K, C, L, N], made in one
    transfer to the device."""
    vals = np.stack([_word_values(params, v, bits) for v in slot_vals_list])
    pt = glwe.encode_vec(params, vals, device=device)
    ct = torch.zeros((len(vals), params.rank + 1, params.limbs_ct, params.n),
                     dtype=I32, device=pt.device)
    ct[:, params.rank] = pt
    return ct


def trivial_word(params: Params, slot_vals, bits: int = 32, device="cuda"):
    """One trivial word, int32[C, L, N] (see trivial_words)."""
    return trivial_words(params, [slot_vals], bits, device)[0]
