"""Client-side randomness on `torch.Generator`s.

Determinism comes from fixed seed material; the streams are this
package's own (they differ by design from the JAX package's threefry
streams -- ciphertext-level equality between the two clients is not a
goal, decrypted-plaintext equality is).

Seed entropy: one generator holds 64 bits of seed, so masks drawn from
ONE stream could be recovered by brute-forcing 2^64 seeds no matter how
much entropy is supplied.  `Source` therefore derives FOUR independent
generators from disjoint 64-bit chunks of a 256-bit seed, and every
secret-relevant sample (uniform mask limbs, gaussian noise, the secret's
permutation) combines all four streams (XOR for uniforms, sum of
quarter-variance draws for gaussians), so recovering the randomness
requires guessing the full 256-bit seed material.

SECURITY: PyTorch's generators (mt19937 on the CPU, Philox on CUDA) are
NOT cryptographic generators.  Their output is predictable from a short
run of samples, whatever the seed entropy.  This module fixes the
interface and the four-stream structure; a deployment must put a
cryptographic generator (e.g. ChaCha20 keyed from the 256-bit seed)
behind it.  `Source()` (no argument) seeds from os.urandom(32); small
integer seeds are FOR REPRODUCIBLE TESTS AND BENCHMARKS ONLY.

Samples are drawn on the CPU, so a seed gives the same ciphertexts on
every device, and moved to the device the caller names (default: the
GPU; a missing GPU raises).
"""

from __future__ import annotations

import hashlib
import math
import os

import numpy as np
import torch

from ..ops.ntt_cuda import require_device

I32 = torch.int32
_STREAMS = 4
_SEED_MASK = (1 << 63) - 1


def _seed_bytes(seed) -> bytes:
    """Normalize seed material to exactly 32 bytes."""
    if seed is None:
        return os.urandom(32)
    if isinstance(seed, (bytes, bytearray)):
        if len(seed) < 32:
            raise ValueError("byte seeds must supply >= 32 bytes of entropy")
        return bytes(seed[:32])
    if isinstance(seed, int):
        # deterministic expansion for test/bench reproducibility only
        return hashlib.shake_256(seed.to_bytes(16, "little", signed=True)).digest(32)
    raise TypeError(f"unsupported seed type {type(seed)!r}")


def _generator(seed: int) -> torch.Generator:
    g = torch.Generator(device="cpu")
    g.manual_seed(seed & _SEED_MASK)
    return g


class Source:
    """Stateful split-on-demand generator holder (client-side only).

    seed: None (default) -> os.urandom(32); bytes (>= 32) -> used
    directly; int -> deterministic expansion (tests/benchmarks only).
    """

    def __init__(self, seed=None):
        material = _seed_bytes(seed)
        self._gens = [
            _generator(int.from_bytes(material[8 * i: 8 * (i + 1)], "little"))
            for i in range(_STREAMS)]

    def split(self):
        """Return _STREAMS fresh child generators; advance all streams."""
        return [
            _generator(int(torch.randint(0, _SEED_MASK, (1,), generator=g,
                                         dtype=torch.int64)))
            for g in self._gens]


def uniform_limbs(gens, shape, base2k: int = 17, device="cuda"):
    """Uniform torus elements in canonical digit form [0, 2^base2k).

    XOR of all independent streams: uniform if ANY stream is uniform."""
    out = None
    for g in gens:
        r = torch.randint(0, 1 << base2k, tuple(shape), generator=g, dtype=I32)
        out = r if out is None else out ^ r
    return out.to(require_device(device))


def gaussian_int(gens, shape, sigma: float, device="cuda"):
    """Discrete gaussian (rounded continuous) as int32.

    Sum of per-stream draws at sigma/sqrt(S): N(0, sigma^2) overall, and
    the noise stays unpredictable unless every stream's seed is known."""
    s = sigma / math.sqrt(len(gens))
    acc = None
    for g in gens:
        r = torch.randn(tuple(shape), generator=g, dtype=torch.float64) * s
        acc = r if acc is None else acc + r
    return torch.round(acc).to(I32).to(require_device(device))


def ternary_secret(gens, rank: int, n: int, density: float = 0.5,
                   device="cuda"):
    """Sparse ternary secret with exact hamming weight density*n per
    component, balanced signs.  The permutation is driven by uniform
    scores XORed across all streams, so the secret inherits the full
    seed entropy.  Returns int32[rank, n]."""
    nz = int(round(n * density))
    template = np.zeros(n, dtype=np.int32)
    template[: nz // 2] = 1
    template[nz // 2: nz] = -1
    template = torch.from_numpy(template)
    out = []
    for _ in range(rank):
        scores = None
        for g in gens:
            s = torch.randint(0, 1 << 62, (n,), generator=g, dtype=torch.int64)
            scores = s if scores is None else scores ^ s
        perm = torch.argsort(scores)
        out.append(template[perm])
    return torch.stack(out, dim=0).to(require_device(device))
