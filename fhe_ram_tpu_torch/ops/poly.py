"""Negacyclic polynomial index ops: rotations (X^k) and Galois
automorphisms (X -> X^g).

In R = Z[X]/(X^N+1):
  * rotate_k:  X^i -> X^(i+k), wrapping with sign flip (X^N = -1).
  * automorphism sigma_g: sum a_i X^i -> sum a_i sign(g,i) X^(g*i mod N),
    g odd (g = -1 is the inversion map).

Both are index arithmetic.  `auto_inverse` gives the constant the CUDA
kernels use to evaluate sigma_g at an output index without a table;
`rotate_each` rotates every row of a stack by its own amount in one
gather.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def rotate(x, k: int):
    """Multiply by X^k (static k). x: int32[..., N]."""
    n = x.shape[-1]
    k = k % (2 * n)
    neg = k >= n
    k %= n
    if k == 0:
        return -x if neg else x
    out = torch.cat([-x[..., n - k:], x[..., : n - k]], dim=-1)
    return -out if neg else out


@lru_cache(maxsize=None)
def _rotate_tables(n: int, ks: tuple, device):
    """Gather tables of X^k for each k: out[w, j] = sign[w, j] *
    x[w, src[w, j]], int64[W, N] and int32[W, N] on `device`."""
    j = np.arange(n)
    m = (j[None, :] - np.asarray(ks, dtype=np.int64)[:, None]) % (2 * n)
    return (torch.as_tensor(m % n, device=device),
            torch.as_tensor(np.where(m < n, 1, -1).astype(np.int32), device=device))


def rotate_each(x, ks):
    """Row w of x [W, ..., N] multiplied by X^ks[w] (static ks): one gather
    for all rows, the same integers as W calls of `rotate`."""
    src, sign = _rotate_tables(x.shape[-1], tuple(int(k) for k in ks), x.device)
    view = (src.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
    return torch.gather(x, -1, src.reshape(view).expand(x.shape)) * sign.reshape(view)


@lru_cache(maxsize=None)
def _auto_tables(n: int, g: int):
    """Gather tables for sigma_g: out[j] = sign[j] * in[src[j]]."""
    g = g % (2 * n)
    assert g % 2 == 1, "galois element must be odd"
    j = np.arange(n)
    dst = (g * j) % (2 * n)
    pos = dst % n
    sgn = np.where(dst < n, 1, -1)
    src = np.zeros(n, dtype=np.int64)
    src[pos] = j
    sign = np.zeros(n, dtype=np.int64)
    sign[pos] = sgn
    return src, sign.astype(np.int32)


def auto_inverse(n: int, g: int) -> int:
    """g^-1 mod 2N.  With i0 = (g^-1 * j) mod 2N, sigma_g(x)[j] is
    x[i0] for i0 < N and -x[i0 - N] otherwise."""
    return pow(g % (2 * n), -1, 2 * n)


def automorphism(x, g: int):
    """Apply sigma_g (static galois element g). x: int32[..., N]."""
    n = x.shape[-1]
    src, sign = _auto_tables(n, g)
    src_t = torch.as_tensor(src, device=x.device)
    sign_t = torch.as_tensor(sign, device=x.device).to(x.dtype)
    return torch.index_select(x, -1, src_t) * sign_t
