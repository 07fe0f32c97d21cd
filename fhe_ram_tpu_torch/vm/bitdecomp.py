"""Homomorphic bit decomposition, the VM LOAD: RAM byte VALUES -> a
bit-sliced FheUint (its word form and its prepared GGSW bits).

A word fetched from the encrypted RAM holds one byte VALUE a ciphertext
(slot 0); the ALU consumes per-bit GGSWs (vm/fheuint.py).  Going from a
value to its bits is a bootstrapping-class operation, built here from
the package's own pieces:

  1. LWE view: slot 0 of a GLWE is an LWE ciphertext under the flattened
     secret, with public coefficients read off the mask polynomials
     (alpha_{c,0} = a_c[0], alpha_{c,j} = -a_c[N-j]).
  2. Per-bit mod-switch: bit k of the unsigned value u is the sign of
     frac(u * 2^-(k+1)), so every bit of a chunk is a sign test of the
     same phase under its own public scale, and all of them run at once.
  3. Batched blind rotation: acc_k = X^(v_k) * T, one CMux a coefficient
     of the ternary secret against GGSWs of its indicator bits s+, s-:
       acc <- acc + s+ (x) (X^(-a) acc - acc) + s- (x) (X^(+a) acc - acc)
     (the two commute: at most one indicator is set), both as ONE keyed
     external product (ops.ntt_cuda.fused_external_fold_batched, kernel 5,
     with two keys).  T = -h * sum_i X^i makes coefficient 0 of X^v T
     read +h for v in (0, N) and -h for v in [N, 2N).
  4. Chunked phases: `chunk` bits a phase, low chunk first; the extracted
     bits' contribution is subtracted exactly before the next phase, and
     a half-gap offset centres every decision.
  5. One batched trace (kernel 3) cleans the non-slot-0 coefficients of
     all accumulators; `bits_to_word` rotates bit k to coefficient
     k * gap; `bits_to_prepared` lifts the bits to GGSWs through the
     tensor key (kernel 2), each digit row from its own sign test whose
     test polynomial is pre-scaled to the gadget level: no ciphertext is
     ever divided.

The rotation amounts of a whole chain are computed once, on the device,
before it starts; each step rotates by a gather over device-side indices,
so the chain never waits for the host.

The bootstrapping key holds 2 * rank * N GGSWs.  It is taken prepared
[P, rank*N, 2, D, C, C2, Lg, N], in the coefficient form
[rank*N, 2, D, C, C2, Lg, N], or in the flat coefficient form
[rank*N, 2*D*C*C2*Lg, N] that `bootstrap_key_fast` writes; the coefficient
forms forward-transform each step's pair (kernel 1) inside the chain.
At N = 4096 with Lg = 5 the flat key is 7.5 GiB, the prepared one 22.5.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..params import Params
from ..ops.ntt import NTTContext
from ..ops.modular import I32
from ..ops import limb as limb_ops
from ..ops import poly
from ..core import ggsw, glwe, keyswitch, rng
from ..core import keys as keys_mod
from . import fheuint


# --------------------------------------------------------------------------
# bootstrapping key (client side)
# --------------------------------------------------------------------------

def _indicator_bits(sk) -> np.ndarray:
    """[2 * rank * N] int32: entry 2i is 1{s_i = +1}, entry 2i+1 is
    1{s_i = -1}, over the flattened secret."""
    s = sk.reshape(-1).cpu().numpy()
    return np.stack([s == 1, s == -1], axis=1).reshape(-1).astype(np.int32)


def bootstrap_key(params: Params, ctx: NTTContext, sk, s_ntt,
                  source: rng.Source, dnum: int | None = None,
                  limbs: int | None = None, prepared: bool = True):
    """GGSW indicator bits of the flattened ternary secret, on s_ntt's
    device: entry (c*N+j, 0) encrypts 1{s_c[j] = +1}, entry (c*N+j, 1)
    encrypts 1{s_c[j] = -1} (bootstrap_key_fast's key, viewed per GGSW).

    prepared=True returns [P, rank*N, 2, D, C, C2, Lg, N]; prepared=False
    the coefficient form [rank*N, 2, D, C, C2, Lg, N].  dnum / limbs set
    the key's gadget apart from the address GGSWs' (N = 4096 needs
    limbs = 5, core/noise.bitdecomp_bit_noise_log2)."""
    flat = bootstrap_key_fast(params, ctx, sk, s_ntt, source, dnum, limbs)
    D = dnum if dnum is not None else params.dnum_ct
    C = params.rank + 1
    stacked = flat.view(flat.shape[0], 2, D, C, C, -1, params.n)
    return ggsw.prepare(ctx, stacked) if prepared else stacked


def bootstrap_key_fast(params: Params, ctx: NTTContext, sk, s_ntt,
                       source: rng.Source, dnum: int | None = None,
                       limbs: int | None = None, chunk: int = 512):
    """`bootstrap_key` in the flat coefficient layout
    [rank*N, 2*D*C*C2*Lg, N], on s_ntt's device, `chunk` indicator GGSWs
    encrypted together.  Each chunk is written into one buffer allocated
    once in that layout: no concatenation and no reshape copy of the key,
    either of which would hold it twice.  The client's working memory
    (its int64 products) grows with `chunk`, not with the key."""
    D = dnum if dnum is not None else params.dnum_ct
    Lg = limbs if limbs is not None else params.limbs_ggsw
    C, n = params.rank + 1, params.n
    if chunk % 2:
        raise ValueError(f"chunk = {chunk}: the key's rows are GGSW pairs")
    bits = torch.as_tensor(_indicator_bits(sk))
    rowsz = 2 * D * C * C * Lg
    buf = torch.empty((params.rank * n, rowsz, n), dtype=I32, device=s_ntt.device)
    for i in range(0, bits.shape[0], chunk):
        b = bits[i: i + chunk].to(s_ntt.device)
        M = b.shape[0]
        zeros = torch.zeros((M, D, C, Lg, n), dtype=I32, device=s_ntt.device)
        rows = glwe.encrypt(params, ctx, s_ntt, zeros, source)  # [M, D, C, C2, Lg, N]
        for d in range(D):
            for c in range(C):
                rows[:, d, c, c, d, 0] += b
        buf[i // 2: (i + M) // 2] = limb_ops.normalize(rows).reshape(M // 2, rowsz, n)
        del rows, zeros   # freed before the next chunk's products
    return buf


# --------------------------------------------------------------------------
# public LWE view + per-bit mod-switch
# --------------------------------------------------------------------------

def _torus_f32(limbs):
    """Top-two-limb float32 torus value (ample for the 2N-slot
    mod-switch: the dropped limbs are below 2^-51 of the scale)."""
    t = limbs[..., 0, :].to(torch.float32) * 2.0 ** -17
    if limbs.shape[-2] > 1:
        t = t + limbs[..., 1, :].to(torch.float32) * 2.0 ** -34
    return t


def _msw(t, scale, two_n: int, offset):
    """round(frac(t * scale) * 2N) + offset (mod 2N), elementwise, in
    float32 and in the reference's order of operations (torch.round rounds
    half to even).  scale: a power of two, or a float32 tensor of them
    that broadcasts against t; offset: an int or an int32 tensor."""
    v = t * scale
    v = v - torch.round(v)  # frac, centred
    s = torch.round(v * float(two_n)).to(I32) + offset
    return torch.remainder(s, two_n)


# --------------------------------------------------------------------------
# batched blind rotation (sign bootstrap)
# --------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _positions(n: int, device) -> torch.Tensor:
    return torch.arange(n, device=device)


def _rot_dyn(x, a, n: int):
    """X^a * x for device-side amounts a in [0, 2N): out[j] = ext[j + 2N - a]
    of ext = [x, -x, x] (X^N = -1), one gather.  x: int32[..., N]; a: an
    integer tensor whose shape is a prefix of x's leading axes (one amount
    a row there)."""
    a = a.to(torch.int64).reshape(tuple(a.shape) + (1,) * (x.dim() - a.dim()))
    ext = torch.cat([x, -x, x], dim=-1)
    return torch.gather(ext, -1, (_positions(n, x.device) + (2 * n - a)).expand(x.shape))


def _h_of(params: Params, level: int) -> tuple[int, int]:
    """(limb index, limb value) of the sign test's amplitude h at `level`:
    level 0 the VALUE scale (h = 2^-(k_pt+1): the bit lands at
    bit * 2^-k_pt); level d >= 1 the GADGET scale (h = 2^-(17d+1): the
    test emits digit row d-1, b * 2^-17d, directly)."""
    if level == 0:
        return 0, 1 << (16 - params.k_pt)
    return level, 1 << 16


def _test_poly_limbs(params: Params, level: int = 0, device="cuda"):
    """T = -h * sum_i X^i at the level's scale (_h_of), as normalized ct
    limbs int32[L, N]."""
    li, hv = _h_of(params, level)
    out = torch.zeros((params.limbs_ct, params.n), dtype=I32, device=device)
    out[li, :] = -hv
    return out


def _h_slot0(params: Params, level: int = 0, device="cuda"):
    """Trivial ct of the level's h at slot 0 (the sign affine),
    int32[C, L, N]."""
    li, hv = _h_of(params, level)
    ct = torch.zeros((params.rank + 1, params.limbs_ct, params.n), dtype=I32,
                     device=device)
    ct[params.rank, li, 0] = hv
    return ct


def chain_start(params: Params, ct, scales, offsets, levels=None):
    """The LWE view, the mod-switch and the first accumulator of K sign
    tests (see sign_bootstrap): returns (acc int32[K, C, L, N], amounts
    int32[K, rank*N]), amounts[k, i] the rotation of step i for test k."""
    n, two_n, rank = params.n, 2 * params.n, params.rank
    K = len(scales)
    levels = [0] * K if levels is None else list(levels)
    cts = ct.expand((K,) + tuple(ct.shape)) if ct.dim() == 3 else ct
    if cts.shape[0] != K or len(levels) != K or len(offsets) != K:
        raise ValueError(f"{cts.shape[0]} ciphertexts for {K} tests")
    dev = cts.device
    a = _torus_f32(cts[:, :rank])                               # [K, rank, N]
    flipped = torch.cat([a[..., :1], -a[..., 1:].flip(-1)], dim=-1)
    t_alpha = flipped.reshape(K, -1)                            # [K, rank*N]
    t_b0 = _torus_f32(cts[:, rank])[:, 0]                       # [K]
    sc = torch.tensor(scales, dtype=torch.float32, device=dev)
    b_t = _msw(t_b0, sc, two_n, torch.tensor(offsets, dtype=I32, device=dev))
    a_t = _msw(t_alpha, sc[:, None], two_n, 0)
    T = torch.stack([_test_poly_limbs(params, lv, dev) for lv in levels])
    acc = torch.zeros((K, rank + 1, params.limbs_ct, n), dtype=I32, device=dev)
    acc[:, rank] = _rot_dyn(T, b_t, n)
    return acc, a_t


def _key_form(params: Params, bsk):
    """(coefficient form?, the step's pair shape or None) of a key."""
    if bsk.dim() == 8:
        return False, None
    if bsk.dim() == 7:
        return True, tuple(bsk.shape[1:])
    if bsk.dim() == 3:
        D, C = params.dnum_ct, params.rank + 1
        Lg = bsk.shape[1] // (2 * D * C * C)
        if bsk.shape[1] != 2 * D * C * C * Lg:
            raise ValueError(f"flat key rows of {bsk.shape[1]} polys are not "
                             f"2*D*C*C2*Lg at D = {D}, C = {C}")
        return True, (2, D, C, C, Lg, bsk.shape[-1])
    raise ValueError(f"bootstrapping key of shape {tuple(bsk.shape)}")


def chain(params: Params, ctx: NTTContext, acc, bsk, rows: range, amounts):
    """The CMux steps of key rows `rows` (a range of flattened secret
    coefficients) on the K accumulators acc int32[K, C, L, N]; step i
    rotates test k by amounts[k, i] (int32[K, len(rows)], on the device).
    Each step: both rotations of acc, one normalize, ONE keyed external
    product over the row's two GGSWs (kernel 5, two keys), the sum.  In
    the coefficient forms the row's pair is transformed first (kernel 1).
    Returns the accumulators after the last step."""
    n, L = params.n, params.limbs_ct
    coeff, pair_shape = _key_form(params, bsk)
    if amounts.shape[-1] != len(rows):
        raise ValueError(f"{amounts.shape[-1]} amounts for {len(rows)} steps")
    # step i's (-a, +a), for all steps at once: int64[2, K, steps]
    pm = torch.stack([torch.remainder(-amounts, 2 * n), amounts]).to(torch.int64)
    for i, r in enumerate(rows):
        if coeff:
            key = ggsw.prepare(ctx, bsk[r].reshape(pair_shape))
        else:
            key = bsk[:, r]                     # [P, 2, D, C, C2, Lg, N]
        rots = _rot_dyn(acc.expand((2,) + tuple(acc.shape)), pm[:, :, i], n)
        d = limb_ops.normalize(rots - acc[None])                 # [2, K, C, L, N]
        upd = ggsw.external_product_keyed(params, ctx, d, key, out_limbs=L)
        acc = limb_ops.normalize(acc + upd[0] + upd[1])
    return acc


def sign_bootstrap(params: Params, ctx: NTTContext, ct, bsk_prep, scales,
                   offsets, levels=None):
    """K sign tests under per-test public scales, one CMux chain for all:
    returns int32[K, C, L, N] with slot 0 of output k equal to
    h_k * (1 - 2 * MSB(frac(phase_0(ct_k) * scales[k]))) (other slots:
    garbage until traced).  ct: one GLWE [C, L, N] shared by every test,
    or [K, C, L, N], test k reading its own; levels[k] picks test k's
    amplitude (_h_of; default 0, the value scale).  bsk_prep: the key in
    any of its three forms (module docstring)."""
    acc, a_t = chain_start(params, ct, scales, offsets, levels)
    steps = bsk_prep.shape[1] if bsk_prep.dim() == 8 else bsk_prep.shape[0]
    return chain(params, ctx, acc, bsk_prep, range(steps), a_t)


# --------------------------------------------------------------------------
# the decomposition pipeline
# --------------------------------------------------------------------------

# digit rows of the lifted GGSW (bits_to_prepared): a truncated 2-digit
# base-2^17 gadget, the READOPT read path's truncation
_LIFT_ROWS = 2


def phase_tests(params: Params, Wb: int, ks, R: int, step: int):
    """(scales, offsets, levels) of one phase's sign tests: per byte, per
    chunk bit k, per gadget level 1..R, test ((i*kc + j)*R + lv-1); the
    offset is the half gap step * 2^-(k+2) of the scaled phase, in slots."""
    scales, offsets, levels = [], [], []
    for _ in range(Wb):
        for k in ks:
            for lv in range(1, R + 1):
                scales.append(1 << (params.k_pt - 1 - k))
                offsets.append(int(round(step * 2.0 ** (-(k + 2)) * 2 * params.n)))
                levels.append(lv)
    return scales, offsets, levels


def phase_bits(params: Params, tr, Wb: int, kc: int, R: int):
    """The sign affine of one phase's traced accumulators tr
    int32[Wb*kc*R, C, L, N]: the digit rows rk int32[Wb, kc, R, C, L, N]
    (row d = bit * 2^-17(d+1)) and the value bits bk int32[Wb, kc, C, L, N]
    (bit * 2^-k_pt: row 0 scaled UP by the exact integer 2^(17-k_pt))."""
    tr = tr.reshape((Wb, kc, R) + tuple(tr.shape[1:]))
    h_stack = torch.stack([_h_slot0(params, lv, tr.device)
                           for lv in range(1, R + 1)])     # [R, C, L, N]
    rk = limb_ops.normalize(h_stack[None, None] - tr)
    bk = limb_ops.normalize(rk[:, :, 0] * (1 << (17 - params.k_pt)))
    return rk, bk


def unsigned_bytes(params: Params, byte_cts, p: int):
    """u = x + 2^(p-1) of signed p-bit byte values x [Wb, C, L, N]: an
    exact trivial add at slot 0 (2^(p-1) at the value scale 2^-k_pt)."""
    off = torch.zeros(tuple(byte_cts.shape[1:]), dtype=I32, device=byte_cts.device)
    off[params.rank, 0, 0] = 1 << (17 - params.k_pt + p - 1)
    return limb_ops.normalize(byte_cts + off[None])


def bytes_to_bits(params: Params, ctx: NTTContext, byte_cts, bsk_prep, atk,
                  p: int, chunk: int = 4, with_rows: bool = False):
    """Wb RAM byte ciphertexts ([Wb, C, L, N], SIGNED p-bit values at
    slot 0, the ram.encrypt_ram convention) -> int32[Wb, p, C, L, N]: bit
    k of the UNSIGNED byte value x mod 2^p, encoded bit * 2^-k_pt, every
    other slot traced to zero.  The tests extract the bits of
    u = x + 2^(p-1); its MSB comes out flipped and is flipped back by an
    exact trivial subtraction.

    with_rows=True also returns int32[Wb, p, _LIFT_ROWS, C, L, N], per bit
    the gadget-scale digit rows (row d = bit * 2^-17(d+1)) for the GGSW
    lift, from the same chains at pre-scaled test polynomials.

    Each phase of `chunk` bits is ONE batched blind rotation
    (K = Wb * chunk * rows accumulators share the chain) and one batched
    trace."""
    if p > params.k_pt:
        raise ValueError(f"{p}-bit values do not fit k_pt = {params.k_pt}")
    n, rank = params.n, params.rank
    Wb = byte_cts.shape[0]
    C, L = rank + 1, params.limbs_ct
    dev = byte_cts.device
    R = _LIFT_ROWS if with_rows else 1
    u_cts = unsigned_bytes(params, byte_cts, p)

    bits, rows = [], []
    step = 1
    for lo in range(0, p, chunk):
        ks = list(range(lo, min(lo + chunk, p)))
        kc = len(ks)
        scales, offsets, levels = phase_tests(params, Wb, ks, R, step)
        cts = torch.repeat_interleave(u_cts, kc * R, dim=0)
        acc = sign_bootstrap(params, ctx, cts, bsk_prep, scales, offsets, levels)
        rk, bk = phase_bits(params, keyswitch.trace(params, ctx, acc, atk), Wb, kc, R)
        if lo + chunk < p:
            # subtract the extracted contribution (exact integer scale):
            # u <- u - sum_k b_k(u) * 2^k, granularity -> 2^(lo+chunk)
            contrib = sum(bk[:, i] * (1 << k) for i, k in enumerate(ks))
            u_cts = limb_ops.normalize(u_cts - contrib)
            step <<= chunk
        if p - 1 in ks:
            # final phase: bit_{p-1}(u) = 1 - bit_{p-1}(byte), flipped back
            i = ks.index(p - 1)
            one = torch.zeros((C, L, n), dtype=I32, device=dev)
            one[rank, 0, 0] = 1 << (17 - params.k_pt)
            bk = bk.clone()
            bk[:, i] = limb_ops.normalize(one[None] - bk[:, i])
            ones_r = torch.zeros((R, C, L, n), dtype=I32, device=dev)
            for lv in range(1, R + 1):
                ones_r[lv - 1, rank, lv - 1, 0] = 1
            rk = rk.clone()
            rk[:, i] = limb_ops.normalize(ones_r[None] - rk[:, i])
        bits.append(bk)
        rows.append(rk)
    bits = torch.cat(bits, dim=1)  # [Wb, p, C, L, N]
    if with_rows:
        return bits, torch.cat(rows, dim=1)
    return bits


def byte_to_bits(params: Params, ctx: NTTContext, byte_ct, bsk_prep, atk,
                 p: int, chunk: int = 4):
    """Single-byte form of bytes_to_bits: [C, L, N] -> [p, C, L, N]."""
    return bytes_to_bits(params, ctx, byte_ct[None], bsk_prep, atk, p,
                         chunk=chunk)[0]


def bits_to_word(params: Params, bit_cts, bits: int):
    """Clean bit GLWEs [p, C, L, N] -> FheUint word form (bit k at
    coefficient k * gap): a rotation sum, exact."""
    g = fheuint.gap(params, bits)
    word = bit_cts[0]
    for k in range(1, bit_cts.shape[0]):
        word = word + poly.rotate(bit_cts[k], k * g)
    return limb_ops.normalize(word)


def lift_rows(params: Params, ctx: NTTContext, bit_rows,
              keys: keys_mod.EvaluationKeysPrepared):
    """Gadget-scale digit rows [p, D, C, L, N] (bytes_to_bits with_rows:
    row d = GLWE(b * 2^-17(d+1))) -> the GGSW stack in the coefficient
    domain, int32[p, D, C(row), C2, Lg, N]: each row resized to Lg limbs
    (zero low limbs appended, no division) is the b-row, and a-row c is
    b-row (x) tsk[c] = GLWE(-s_c * b * 2^-17(d+1)), one fold launch (kernel
    2) a digit row and mask component."""
    Lg = params.limbs_ggsw
    digit_rows = []
    for d in range(bit_rows.shape[1]):
        row_b = limb_ops.resize_limbs(bit_rows[:, d], Lg)  # [p, C, Lg, N]
        rows_a = [ggsw.external_product(params, ctx, row_b, keys.tsk[:, c],
                                        out_limbs=Lg)
                  for c in range(params.rank)]
        digit_rows.append(torch.stack(rows_a + [row_b], dim=1))
    return torch.stack(digit_rows, dim=1)


def bits_to_prepared(params: Params, ctx: NTTContext, bit_rows,
                     keys: keys_mod.EvaluationKeysPrepared):
    """The circuit-bootstrap scheme switch: digit rows [p, D, C, L, N] ->
    FheUintPrepared GGSW stack [P, p, D=_LIFT_ROWS, C, C2, Lg, N] (a
    truncated 2-digit gadget, the read path's truncation; external
    products slice their operand to the key's digit count)."""
    return ggsw.prepare(ctx, lift_rows(params, ctx, bit_rows, keys))


def load_word(params: Params, ctx: NTTContext, fetched_bytes, bsk_prep,
              keys: keys_mod.EvaluationKeysPrepared, bits: int):
    """The VM LOAD: a fetched RAM word (FheRam.read's output,
    [W, C, L, N] byte values) -> (word form, prepared bits), an FheUint of
    `bits` bits (8 * W at the production geometry)."""
    W = fetched_bytes.shape[0]
    bit_cts, rows = bytes_to_bits(params, ctx, fetched_bytes, bsk_prep,
                                  keys.atk_glwe, bits // W, with_rows=True)
    bit_cts = bit_cts.reshape((bits,) + tuple(fetched_bytes.shape[1:]))
    rows = rows.reshape((bits,) + tuple(rows.shape[2:]))  # [bits, D, C, L, N]
    word = bits_to_word(params, bit_cts, bits)
    return word, bits_to_prepared(params, ctx, rows, keys)
