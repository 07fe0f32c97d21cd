"""Analytic noise model: per-operation variance bounds, GGSW noise
assertions, and the RAM refresh budget.

Closed-form variance formulas for every homomorphic operation in the
pipeline.  The analytic part needs only `math`, `numpy` and Params and
is this package's own copy of the JAX package's model, value for value
(tests/test_torch_noise.py holds the two against each other for every
preset); the two measurement helpers at the end work on tensors.

Conventions
-----------
* All noise is absolute torus noise (distance to the nearest exact
  plaintext, as measured by glwe.decode_coeff0 / examples/fhe-ram.rs's
  decrypt_glwe).
* `var_*` functions return the VARIANCE of one output coefficient.
* `bound_log2(var, det=0)` converts to a log2 amplitude bound
  6*sqrt(var) + det: a 6-sigma gaussian tail (p < 2e-9 per
  coefficient) plus deterministic (truncation) terms.

Model
-----
Fresh encryption (glwe._encrypt_impl): gaussian sigma at the last limb
scale: var = (sigma * 2^-(b*L))^2.

External product ct (L limbs = gadget digits) x GGSW (rows at Lg
limbs, row noise var_row):
    out = mu * ct  +  sum_{c,d} digit_{c,d} (*) e_{d,c}
Each negacyclic-convolution coefficient sums N products of a balanced
base-2^b digit (var 2^(2b)/12) with a row-noise coefficient:
    var_added = (rank+1) * D * N * (2^(2b)/12) * var_row
plus the crt_fold truncation (everything below limb Lout is dropped):
deterministic |err| < 2^-(b*Lout).  For monomial mu the mu*ct term
carries var_in through unchanged (|mu| = 1).

Keyswitch: same with rank * D rows (only the a-part is decomposed).

Normalized trace over S halving steps (core/keyswitch.trace): the
output coefficient 0 is a FIXED POINT of every galois map, so noise
there amplifies COHERENTLY (amplitude, not variance, doubles per
step).  Input noise at coefficient 0 passes through unchanged (the
1/2^S pre-scale cancels the 2^S-term coherent sum exactly); the
keyswitch noise of step k is amplified by 2^(S-k):
    var_out = var_in + sum_k 4^(S-k) var_ks  ~  var_in + (4^S/3) var_ks
and the truncations (pre-scale + one crt_fold per step, each
< 2^-(b*L)) are amplified the same way: det ~ 2 * 2^S * 2^-(b*L).
(An incoherent model, variance doubling a step, predicts less than the
JAX package measured at the 2^18 preset; this one bounds it.)

Packer over M = 2^V inputs (core/packer.pack): same coherent structure
at the kept coefficients with V levels:
    var_out = var_in + (M^2/3) var_ks,  det ~ 2 * M * 2^-(b*L).

All formulas are validated against measured noise in
tests/test_noise.py (analytic bound above measurement, within slack).
"""

from __future__ import annotations

import math

import numpy as np

from ..params import Params

_B = 17  # base2k wired across the stack (params asserts this)


def var_digit() -> float:
    """Variance of one balanced base-2^b gadget digit (uniform model)."""
    return 2.0 ** (2 * _B) / 12.0


def var_fresh(params: Params, limbs: int) -> float:
    """Fresh encryption noise variance at an L-limb parameterization."""
    return (params.sigma * 2.0 ** (-_B * limbs)) ** 2


def var_trunc(limbs: int) -> float:
    """Variance of the uniform fold/normalize truncation below limb L."""
    return 2.0 ** (-2 * _B * limbs) / 12.0


def det_trunc(limbs: int) -> float:
    """Deterministic bound of one truncation below limb L."""
    return 2.0 ** (-_B * limbs)


def var_key_trunc(key_limbs_used: int, key_limbs_full: int) -> float:
    """Extra per-row variance from consuming only the top
    key_limbs_used limbs of a key generated at key_limbs_full (read-path
    gadget truncation, params.Params.read_ks_limbs): the dropped limbs
    are uniform base-2^b digits at their torus scale."""
    return sum(var_trunc(l) for l in range(key_limbs_used, key_limbs_full))


def var_digit_trunc(params: Params, digits_used: int, in_limbs: int,
                    decomposed_components: int) -> float:
    """Extra variance from decomposing only the top digits_used of
    in_limbs input limbs (params.Params.read_ks_digits): the dropped
    tail rides through as (tail * message) with |message| = 1, its
    a-part additionally convolved with the sparse-ternary secret
    (decomposed_components = rank for a keyswitch, rank+1 for an
    external product -- the EP also truncates the b digits)."""
    tail = sum(var_trunc(l) for l in range(digits_used, in_limbs))
    conv = params.n * params.xs_density  # E[s^2] per convolution term
    if decomposed_components > params.rank:  # EP: b-tail passes directly
        return tail * (1.0 + params.rank * conv)
    return tail * params.rank * conv


def var_external_product(params: Params, digits: int, var_row: float,
                         out_limbs: int, var_in: float = 0.0,
                         in_limbs: int | None = None) -> float:
    """Added-noise variance of GLWE x GGSW (core/ggsw.external_product).

    digits: gadget rows consumed (== input ct limbs D, or fewer under
    read-path truncation -- then pass the full limb count as in_limbs);
    var_row: per-coefficient noise variance of one GGSW row;
    var_in passes through when the GGSW message is a (signed) monomial.
    """
    c = params.rank + 1
    var = (var_in + c * digits * params.n * var_digit() * var_row
           + var_trunc(out_limbs))
    if in_limbs is not None and digits < in_limbs:
        var += var_digit_trunc(params, digits, in_limbs, c)
    return var


def var_keyswitch(params: Params, digits: int, key_limbs: int,
                  out_limbs: int, var_in: float = 0.0,
                  in_limbs: int | None = None,
                  key_limbs_full: int | None = None) -> float:
    """Added-noise variance of one keyswitch (core/keyswitch.keyswitch).

    Read-path gadget truncation (params.Params.read_ks_digits): pass the
    consumed digit/limb counts as digits/key_limbs and the full counts
    as in_limbs/key_limbs_full."""
    kf = key_limbs_full if key_limbs_full is not None else key_limbs
    var_row = var_fresh(params, kf) + var_key_trunc(key_limbs, kf)
    var = (var_in + params.rank * digits * params.n * var_digit() * var_row
           + var_trunc(out_limbs))
    if in_limbs is not None and digits < in_limbs:
        var += var_digit_trunc(params, digits, in_limbs, params.rank)
    return var


def _ks_var_for(params: Params, ct_limbs: int,
                trunc: tuple = (None, None)) -> float:
    """Per-step keyswitch variance at the evk_trace parameterization,
    optionally under read-path gadget truncation."""
    in_digits, key_limbs = trunc
    d = in_digits if in_digits is not None else ct_limbs
    kl = key_limbs if key_limbs is not None else params.limbs_evk_trace
    return var_keyswitch(params, d, kl, ct_limbs, in_limbs=ct_limbs,
                         key_limbs_full=params.limbs_evk_trace)


def trace_noise(params: Params, var_in: float, ct_limbs: int,
                steps: int | None = None,
                det_in: float = 0.0,
                trunc: tuple = (None, None)) -> tuple[float, float]:
    """(variance, deterministic) noise after the pre-scaled trace.

    Mirrors core/keyswitch.trace: one exact 1/2^S limb shift, then S
    unnormalized x + sigma_g(x) steps, each a keyswitch at the
    evk_trace parameterization (optionally gadget-truncated on the read
    path, params.Params.read_ks_digits)."""
    s = params.log_n if steps is None else steps
    if s == 0:
        return var_in, det_in
    var_ks = _ks_var_for(params, ct_limbs, trunc)
    var = var_in + (4.0 ** s / 3.0) * var_ks
    det = det_in + 2.0 * 2.0 ** s * det_trunc(ct_limbs)
    return var, det


def packer_noise(params: Params, var_in: float, ct_limbs: int,
                 m: int, trunc: tuple = (None, None)) -> tuple[float, float]:
    """(variance, deterministic) noise after packing M ciphertexts."""
    if m <= 1:
        return var_in, 0.0
    var_ks = _ks_var_for(params, ct_limbs, trunc)
    var = var_in + (float(m) ** 2 / 3.0) * var_ks
    det = 2.0 * m * det_trunc(ct_limbs)
    return var, det


def bound_log2(var: float, det: float = 0.0) -> float:
    """log2 amplitude bound: 6 sigma + deterministic terms."""
    return math.log2(6.0 * math.sqrt(max(var, 1e-300)) + det + 1e-300)


# --------------------------------------------------------------------------
# pipeline-level models
# --------------------------------------------------------------------------

def read_noise_log2(params: Params) -> float:
    """Analytic bound for the encrypted-read output noise
    (ram/ram.py read_impl: per-level CMux chains + packs, final trace),
    including the params' read-path gadget truncation when set."""
    L = params.limbs_ct
    ep_d, ep_k = params.read_ep_trunc
    ep_d = ep_d if ep_d is not None else L
    ep_kl = ep_k if ep_k is not None else params.limbs_ggsw
    kst = params.read_ks_trunc
    var_row_addr = (var_fresh(params, params.limbs_ggsw)
                    + var_key_trunc(ep_kl, params.limbs_ggsw))
    var = var_fresh(params, L)
    det = 0.0
    rows = params.num_rows
    for base1d in params.base2d().rows:
        for _ in base1d.bases:
            var = var_external_product(params, ep_d, var_row_addr, L, var,
                                       in_limbs=L)
        if rows > 1:
            m = 1 << max(1, (min(rows, params.n) - 1).bit_length())
            var, d = packer_noise(params, var, L, m, trunc=kst)
            det += d
            rows = -(-rows // params.n)
    var, det = trace_noise(params, var, L, det_in=det, trunc=kst)
    return bound_log2(var, det)


def vm_trunc_added_log2(params: Params, bits: int = 32) -> float:
    """Analytic bound on the EXTRA noise one VM word accumulates when
    its circuit runs under the read-path gadget truncation
    (vm/arithmetic._vm_trunc): the delta between truncated and
    full-gadget per-call noise, summed over the deepest per-word chain.

    Chain counted (worst of the three op groups, vm/arithmetic.py):
    2*bits keyed CMuxes (the carry-DP walks two per bit; the shift
    barrel's extraction + log2(bits) levels is shorter), plus ONE
    extraction trace whose per-step keyswitch-truncation delta
    amplifies coherently like any trace (4^log_n/3).

    This prices the truncation for ANY preset -- _vm_trunc asserts the
    result stays below the bit-decode bound instead of relying on a
    constant-folded ~2^-60 rationale valid only for today's presets."""
    L = params.limbs_ct
    Lg = params.limbs_ggsw
    ep_d, ep_k = params.read_ep_trunc
    ep_d = ep_d if ep_d is not None else L
    ep_kl = ep_k if ep_k is not None else Lg
    c = params.rank + 1
    # per-CMux extra variance: dropped digit tail + dropped key limbs
    d_ep = 0.0
    if ep_d < L:
        d_ep += var_digit_trunc(params, ep_d, L, c)
    d_ep += c * ep_d * params.n * var_digit() * var_key_trunc(ep_kl, Lg)
    # per-trace-step extra keyswitch variance, amplified coherently
    d_ks = (_ks_var_for(params, L, params.read_ks_trunc)
            - _ks_var_for(params, L, (None, None)))
    var = 2 * bits * d_ep + (4.0 ** params.log_n / 3.0) * d_ks
    return bound_log2(var)


def bitdecomp_bit_noise_log2(params: Params, bsk_dnum: int | None = None,
                             bsk_limbs: int | None = None) -> float:
    """Analytic bound on one extracted bit's noise (vm/bitdecomp.py):
    fresh-bootstrap quality, independent of the input ciphertext.

    The accumulator starts trivial (noise 0) and takes 2 * rank * N
    keyed external products at the bsk gadget (every step adds EP
    noise even when its indicator GGSW encrypts 0), then one cleaning
    trace (coherent keyswitch amplification at the kept coefficient);
    the sign affine is a trivial subtraction, and the VALUE bit is the
    gadget-level-1 output scaled UP by the exact integer 2^(17 - k_pt)
    (which scales the noise by the same factor).  Must stay below the
    2^-(k_pt+1) bit-decode bound; the GADGET rows (unscaled bootstrap
    outputs) additionally bound the lifted-GGSW CMux noise -- their
    amplitude must sit well under the per-digit budget, which is why
    the production bsk runs the Lg=5 (k=85-grade) gadget
    (tests/test_noise.py pins the presets;
    scripts/bitdecomp_probe.py measures on-chip)."""
    D = bsk_dnum if bsk_dnum is not None else params.dnum_ct
    Lg = bsk_limbs if bsk_limbs is not None else params.limbs_ggsw
    L = params.limbs_ct
    per_step = var_external_product(params, D, var_fresh(params, Lg), L)
    var_acc = 2.0 * params.rank * params.n * per_step
    var, det = trace_noise(params, var_acc, L)
    up = 4.0 ** (17 - params.k_pt)
    return bound_log2(var * up, det * 2.0 ** (17 - params.k_pt))


def write_cycle_added_var(params: Params) -> tuple[float, float]:
    """(variance, deterministic) noise ADDED to one base-level data row
    by one full read_prepare_write + write cycle (ram/ram.py).

    Exact-data-carry write (ram/ram.py round 4): the carried rows never
    pass an external product -- the state keeps the original data and
    the write adds inv0 (x) t_d, so the per-cycle addition is the delta
    pipeline's noise only: the traced root delta (evk_trace
    parameterization), the mid-level inverse-coordinate CMux chains
    (GGSWs derived homomorphically: keyswitch at evk_ggsw + tensor-key
    product, so their rows are noisier than fresh ones), the split-tree
    extraction, and the final inverse chain applied to the delta rows.

    Validated against a 40-cycle measurement (tests/test_noise.py
    test_write_cycle_variance_slope_empirical; the pre-restructure model
    measured 2.4x above the fitted slope)."""
    L = params.limbs_ct
    n2 = params.base2d().rows

    # inverse-coordinate GGSW rows: automorphism keyswitch of the b-row
    # (digits = limbs_ggsw at the evk_ggsw key) + tensor-key external
    # product on top (a-row) -- take the noisier a-row
    Lg = params.limbs_ggsw
    var_row_b = var_keyswitch(params, Lg, params.limbs_evk_ggsw, Lg,
                              var_in=var_fresh(params, Lg))
    var_row_inv = var_external_product(
        params, Lg, var_fresh(params, params.limbs_evk_ggsw), Lg,
        var_in=var_row_b)

    # root value: the rpw tree pipeline at the RPW truncation
    # (params.rpw_ks_digits ff.; identity when unset) -- EP chains per
    # level, pack keyswitches, ending at the tree root
    ep_d_r, ep_k_r = params.rpw_ep_trunc
    ep_d_r = ep_d_r if ep_d_r is not None else L
    ep_kl_r = ep_k_r if ep_k_r is not None else Lg
    kst_r = params.rpw_ks_trunc
    var_row_addr_r = (var_fresh(params, Lg)
                      + var_key_trunc(ep_kl_r, Lg))
    var_root = var_fresh(params, L)
    det_root = 0.0
    rows = params.num_rows
    for base1d in n2:
        for _ in base1d.bases:
            var_root = var_external_product(params, ep_d_r, var_row_addr_r,
                                            L, var_root, in_limbs=L)
        if rows > 1:
            m = 1 << max(1, (min(rows, params.n) - 1).bit_length())
            var_root, d = packer_noise(params, var_root, L, m, trunc=kst_r)
            det_root += d
            rows = -(-rows // params.n)

    # root delta: delta = w - trace(root); the root trace may run the
    # RPW keyswitch truncation (its noise reaches the RAM only via the
    # delta)
    var_delta, det_delta = trace_noise(
        params, var_root + var_fresh(params, L), L, det_in=det_root,
        trunc=kst_r)
    # each mid level passes the delta through its inverse-coordinate
    # CMux chain and then ONE split-tree extraction (write_impl runs one
    # extract_slots per level of n2[1:], innermost level last)
    for base1d in n2[1:]:
        for _ in base1d.bases:
            var_delta = var_external_product(params, L, var_row_inv, L,
                                             var_delta)
        var_delta, det_delta = trace_noise(params, var_delta, L,
                                           det_in=det_delta)
    # final inverse chain applied to the delta rows
    var = var_delta
    for _ in n2[0].bases:
        var = var_external_product(params, L, var_row_inv, L, var)
    return var, det_delta + 2 * det_trunc(L)


def refresh_budget(params: Params) -> int:
    """Write cycles before a data row's accumulated noise can cross the
    decode bound 2^-(k_pt+1) (reference publishes >= ~40M for the 2^18
    config, README.md:36).

    Independent per-cycle contributions accumulate in variance; the
    budget keeps 6*sqrt(W * var_cycle) + W_det below the bound."""
    var_c, det_c = write_cycle_added_var(params)
    bound = 2.0 ** (-(params.k_pt + 1))
    # solve 6 sqrt(W var) + W det = bound for W (quadratic in sqrt(W))
    a = det_c
    b = 6.0 * math.sqrt(var_c)
    if a <= 0:
        return int((bound / b) ** 2)
    disc = b * b + 4 * a * bound
    sw = (-b + math.sqrt(disc)) / (2 * a)
    return int(sw * sw)


def conversion_ggsw_row_var(params: Params, n_cmux: int) -> float:
    """Row-noise variance of a blind-rotation-derived GGSW
    (vm/conversion.scalar_to_ggsw_blind_rotation): starts from the
    zero-noise trivial gadget and accumulates one CMux (external
    product at the evk_ggsw apply parameterization) per mask bit."""
    Lg = params.limbs_ggsw
    var = 0.0
    for _ in range(n_cmux):
        var = var_external_product(
            params, Lg, var_fresh(params, params.limbs_evk_ggsw), Lg, var)
    return var


# --------------------------------------------------------------------------
# measurement-side helpers (client: require the secret)
# --------------------------------------------------------------------------

def ggsw_noise_log2(params: Params, ctx, sk, s_ntt, ggsw_ct, mu):
    """Measured per-row log2 noise of a GGSW ciphertext.

    Row (d, c) of GGSW(mu) must have phase mu*g_d (c == rank) or
    -mu*g_d*s_c (c < rank), g_d = 2^-(b(d+1)).  ggsw_ct: int32[D, C, C2,
    Lg, N]; sk: int32[rank, N]; mu: an integer polynomial.  Returns
    float[D, rank+1]: max per-coefficient log2 error of each row."""
    import torch

    from ..ops.ntt import ntt_fwd, ntt_inv
    from ..ops import limb as limb_ops
    from . import glwe

    D, C, C2, Lg, n = ggsw_ct.shape
    rank = params.rank
    device = ggsw_ct.device
    ph = glwe.phase(params, ctx, s_ntt, ggsw_ct.reshape(D * C, C2, Lg, n))
    ph = ph.reshape(D, C, Lg, n).cpu().numpy()

    # exact integer products mu*s_c via the NTT (small operands)
    mu = np.asarray(mu.cpu() if torch.is_tensor(mu) else mu, dtype=np.int64)
    fa = ntt_fwd(ctx, torch.as_tensor(mu, dtype=torch.int32).to(device))
    mus = []
    for c in range(rank):
        fb = ntt_fwd(ctx, sk[c].to(torch.int32))
        prod = torch.remainder(fa.to(torch.int64) * fb.to(torch.int64),
                               ctx.consts(2, device))
        conv = ntt_inv(ctx, prod.to(torch.int32))
        # |mu*s| <= N * |mu|_inf: small; the first prime's centered residue
        # is the integer
        mus.append(conv[0].cpu().numpy().astype(np.int64))

    out = np.zeros((D, C), dtype=np.float64)
    for d in range(D):
        for c in range(C):
            expect = -mus[c] if c < rank else mu
            t = limb_ops.torus_float(ph[d, c])
            frac = t - np.asarray(expect, np.float64) * 2.0 ** (-_B * (d + 1))
            frac = frac - np.rint(frac)
            out[d, c] = np.log2(np.max(np.abs(frac)) + 2.0 ** -120)
    return out


def assert_ggsw_noise(params: Params, ctx, sk, s_ntt, ggsw_ct, mu,
                      max_log2: float):
    """Assert every GGSW row's measured noise is below max_log2."""
    measured = ggsw_noise_log2(params, ctx, sk, s_ntt, ggsw_ct, mu)
    assert np.all(measured < max_log2), (
        f"GGSW noise {measured.max():.1f} exceeds bound {max_log2:.1f}\n"
        f"{measured}")
    return measured
