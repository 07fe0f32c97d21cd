"""GLWE ciphertexts over the limb torus: encrypt / decrypt / encode.

Layout: ct = int32[..., rank+1, L, N]; components a_0..a_{rank-1}, b last.
Convention: b = sum_i a_i * s_i + m + e, so phase(ct) = b - sum a_i s_i.

The convolutions with the secret go through ops.ntt.ntt_fwd / ntt_inv,
i.e. through the CUDA transform when the tensors are on the GPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..params import Params
from ..ops.ntt import NTTContext, ntt_fwd, ntt_inv
from ..ops.modular import I32, I64
from ..ops.crt import crt_fold
from ..ops import limb as limb_ops
from ..ops import ntt_cuda
from . import rng


def secret_prepare(ctx: NTTContext, sk):
    """NTT-domain secret: int32[P, rank, N]."""
    return ntt_fwd(ctx, sk)


def _conv_with_secret(ctx: NTTContext, a, s_ntt, out_limbs: int):
    """sum_i a_i (*) s_i for a: int32[..., rank, L, N] torus limbs and
    s_ntt: [P, rank, N]. Returns torus limbs int32[..., out_limbs, N]
    (unnormalized)."""
    rank = a.shape[-3]
    a_ntt = ntt_fwd(ctx, a)  # [P, ..., rank, L, N]
    p = ctx.consts(a_ntt.ndim - 1, a.device)
    acc = None
    for r in range(rank):
        s_b = s_ntt[:, r].to(I64)
        s_b = s_b.reshape((s_b.shape[0],) + (1,) * (a_ntt.ndim - 3) + (s_b.shape[-1],))
        t = a_ntt[..., r, :, :].to(I64) * s_b
        acc = t if acc is None else acc + t
    acc = torch.remainder(acc, p).to(I32)
    conv = ntt_inv(ctx, acc)  # [P, ..., L, N] residues of exact int convs
    return crt_fold(ctx.primes, conv, 17, out_limbs)


def encrypt(params: Params, ctx: NTTContext, s_ntt, pt, source: rng.Source):
    """Encrypt pt (torus limbs int32[..., L, N], normalized) under s.

    Returns ct int32[..., rank+1, L, N] on pt's device. Noise sigma at
    the last limb scale (2^-(17L))."""
    ka, ke = source.split(), source.split()
    L, n = pt.shape[-2], pt.shape[-1]
    a_shape = pt.shape[:-2] + (params.rank, L, n)
    a = limb_ops.normalize(rng.uniform_limbs(ka, a_shape, device=pt.device))
    conv = _conv_with_secret(ctx, a, s_ntt, L)
    e = rng.gaussian_int(ke, pt.shape[:-2] + (n,), params.sigma, device=pt.device)
    b = conv + pt
    b[..., L - 1, :] += e
    b = limb_ops.normalize(b)
    return torch.cat([a, b[..., None, :, :]], dim=-3)


def phase(params: Params, ctx: NTTContext, s_ntt, ct):
    """Decrypt to the noisy phase: b - sum a_i s_i (normalized limbs)."""
    rank = params.rank
    a = ct[..., :rank, :, :]
    b = ct[..., rank, :, :]
    conv = _conv_with_secret(ctx, a, s_ntt, ct.shape[-2])
    return limb_ops.normalize(b - conv)


def encode_vec(params: Params, values, limbs: int | None = None,
               device="cuda"):
    """Encode an int vector [..., N] at precision k_pt into ct-limb layout
    (values * 2^-k_pt per coefficient)."""
    k = params.k_pt
    b = params.base2k
    L = limbs if limbs is not None else params.limbs_ct
    assert k <= b, "k_pt beyond one limb not wired"
    x = torch.as_tensor(np.asarray(values), dtype=I32).to(
        ntt_cuda.require_device(device)) << (b - k)
    out = torch.zeros(x.shape[:-1] + (L, x.shape[-1]), dtype=I32, device=x.device)
    out[..., 0, :] = x
    return limb_ops.normalize(out)


def decode_coeff0(params: Params, phase_limbs, want: int | None = None):
    """Decode coefficient 0 at precision k_pt (numpy, client-side) and
    measure the log2 noise.  Returns (value, noise_log2)."""
    if isinstance(phase_limbs, torch.Tensor):
        phase_limbs = phase_limbs.cpu().numpy()
    x = np.asarray(phase_limbs, dtype=np.float64)
    L = x.shape[-2]
    t = 0.0
    for j in range(L):
        t += x[..., j, 0] * 2.0 ** (-17 * (j + 1))
    k = params.k_pt
    val = np.rint(t * 2.0**k).astype(np.int64)
    m = 1 << k
    val = ((val + m // 2) % m) - m // 2  # centered mod 2^k
    if want is None:
        return val, None
    frac = t - np.float64(want) * 2.0**-k
    frac = frac - np.rint(frac)
    with np.errstate(divide="ignore"):
        noise = np.log2(np.maximum(np.abs(frac), 2.0**-120))
    return val, noise


def cast_u8_signed(value: int, bits: int) -> int:
    """Expected decode of a RAM byte at precision `bits`: the byte is
    stored as its signed-i8 value, decoding reduces it centered mod
    2^bits."""
    v8 = value - 256 if value >= 128 else value
    m = 1 << bits
    return ((v8 + m // 2) % m) - m // 2
