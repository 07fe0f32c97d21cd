"""Plain NumPy reference of the encrypted RAM's semantics.

An encrypted RAM of `max_addr` words of `word_size` bytes answers a read at
address a with an encryption of word a, and a write of word w at a with a
RAM in which word a is w and every other word is as it was.  This module
holds that plaintext RAM and decrypts the ciphertexts the server returns
under the secret key, from the scheme's published definition alone:

* a GLWE ciphertext of rank r is r + 1 polynomials (a_0 .. a_{r-1}, b) of
  Z[X]/(X^N + 1), each written as L signed base-2^17 limbs, limb j of
  weight 2^-(17 (j + 1)) on the torus;
* its phase is b - sum_i a_i s_i; a byte v of a word is stored as its
  signed 8-bit value v8 at precision k_pt, phase = v8 2^-k_pt + noise, so
  it decodes to v8 centred modulo 2^k_pt, and decodes correctly while
  |noise| < 2^-(k_pt + 1);
* a read's answer carries byte j of the word in coefficient 0 of
  ciphertext j; the RAM keeps byte j of word i in ciphertext row
  i // N of subram j, coefficient i % N.

It takes nothing the program made but the ciphertexts it judges: no key,
table or prepared form.  The phase is exact integer arithmetic modulo
2^(17 L): coefficient 0 of a_i s_i is a dot product, a whole row's
product a negacyclic convolution through a float64 FFT whose rounding is
checked.  It imports neither the program nor JAX.
"""

from __future__ import annotations

import numpy as np

BASE2K = 17


def signed_byte(v):
    """A stored byte as the signed 8-bit value the RAM encodes."""
    v = np.asarray(v, dtype=np.int64)
    return np.where(v >= 128, v - 256, v)


def centred(v, bits: int):
    """v centred modulo 2^bits, in [-2^(bits-1), 2^(bits-1))."""
    m = 1 << bits
    return ((np.asarray(v, dtype=np.int64) + m // 2) % m) - m // 2


def expected_decode(byte_values, k_pt: int):
    """What a stored byte decodes to at precision k_pt."""
    return centred(signed_byte(byte_values), k_pt)


def _torus_int(limb_terms, L: int):
    """sum_j term_j 2^(17 (L-1-j)) mod 2^(17 L), exactly, in int64.
    limb_terms: int64[..., L] with |term| < 2^40."""
    if BASE2K * L > 62:
        raise ValueError(f"{L} limbs exceed the int64 phase")
    mod = np.int64(1) << np.int64(BASE2K * L)
    acc = np.zeros(limb_terms.shape[:-1], dtype=np.int64)
    for j in range(L):
        keep = np.int64(1) << np.int64(BASE2K * (j + 1))
        t = np.mod(limb_terms[..., j], keep) << np.int64(BASE2K * (L - 1 - j))
        acc = np.mod(acc + t, mod)
    return acc


def _coeff0_products(a, s):
    """Coefficient 0 of a * s in Z[X]/(X^N + 1): a[..., N], s[N]."""
    # (a s)_0 = a_0 s_0 - sum_{j >= 1} a_j s_{N - j}
    s_rev = np.concatenate([s[:1], -s[:0:-1]]).astype(np.int64)
    return np.tensordot(a.astype(np.int64), s_rev, axes=([-1], [0]))


def _negacyclic(a, s):
    """a * s in Z[X]/(X^N + 1) for a[..., N] (|a| < 2^17) and a small s[N],
    exactly: a float64 FFT of length 2N, each coefficient's rounding checked."""
    n = a.shape[-1]
    fa = np.fft.rfft(a.astype(np.float64), 2 * n)
    fs = np.fft.rfft(s.astype(np.float64), 2 * n)
    full = np.fft.irfft(fa * fs, 2 * n)
    r = np.rint(full)
    if np.max(np.abs(full - r), initial=0.0) > 0.25:
        raise ArithmeticError("float64 convolution lost exactness")
    r = r.astype(np.int64)
    return r[..., :n] - r[..., n:]


def phase_coeff0(ct, sk):
    """Torus integers (mod 2^(17 L)) of coefficient 0 of the phase of
    ciphertexts ct[..., r+1, L, N] under sk[r, N]."""
    ct = np.asarray(ct)
    sk = np.asarray(sk)
    rank, L = sk.shape[0], ct.shape[-2]
    terms = ct[..., rank, :, 0].astype(np.int64)
    for i in range(rank):
        terms = terms - _coeff0_products(ct[..., i, :, :], sk[i])
    return _torus_int(terms, L)


def phase_rows(ct, sk):
    """Torus integers of every coefficient of the phase: ct[..., r+1, L, N]
    -> int64[..., N]."""
    ct = np.asarray(ct)
    sk = np.asarray(sk)
    rank, L = sk.shape[0], ct.shape[-2]
    terms = ct[..., rank, :, :].astype(np.int64)
    for i in range(rank):
        terms = terms - _negacyclic(ct[..., i, :, :], sk[i])
    return _torus_int(np.moveaxis(terms, -2, -1), L)


def judge(phase_ints, want_bytes, k_pt: int, L: int):
    """Decode torus integers at precision k_pt against the stored bytes.
    Returns (mismatch, noise_share): a bool array, True where a byte decodes
    to another value, and the largest |noise| as a share of the decode
    margin 2^-(k_pt + 1) (a byte decodes correctly below 1)."""
    want = expected_decode(want_bytes, k_pt)
    bits = BASE2K * L
    step = np.int64(1) << np.int64(bits - k_pt)
    ph = np.asarray(phase_ints)
    got = centred(np.floor_divide(ph + step // 2, step), k_pt)
    err = centred(ph - want * step, bits)
    worst = int(np.max(np.abs(err), initial=0))
    return got != want, worst / float(np.int64(1) << np.int64(bits - k_pt - 1))


class PlainRam:
    """The plaintext RAM: the words and their writes, in order."""

    def __init__(self, data_bytes, word_size: int):
        self.word_size = int(word_size)
        self.words = np.asarray(data_bytes, dtype=np.uint8).reshape(-1, self.word_size).copy()

    def read(self, addr: int):
        return self.words[int(addr)].copy()

    def write(self, addr: int, word):
        self.words[int(addr)] = np.asarray(word, dtype=np.uint8)


def judge_answers(answers, want_words, sk, k_pt: int):
    """Read answers ct[A, W, r+1, L, N] against want_words uint8[A, W].
    Returns (wrong bytes, wrong answers, noise share)."""
    answers = np.asarray(answers)
    bad, share = judge(phase_coeff0(answers, sk), want_words, k_pt, answers.shape[-2])
    return int(bad.sum()), int(bad.any(axis=-1).sum()), share


def judge_ram(data, want_words, sk, k_pt: int):
    """The whole encrypted RAM data[W, R, r+1, L, N] against the plaintext
    words uint8[max_addr, W]: byte j of word i in row i // N of subram j,
    coefficient i % N.  Rows are decrypted one subram at a time.  Returns
    (wrong bytes, wrong words, noise share)."""
    data = np.asarray(data)
    W, R, n, L = data.shape[0], data.shape[1], data.shape[-1], data.shape[-2]
    want_words = np.asarray(want_words)
    bad_words = np.zeros(want_words.shape[0], dtype=bool)
    wrong, worst = 0, 0.0
    for j in range(W):
        ph = phase_rows(data[j], sk).reshape(R * n)[: want_words.shape[0]]
        bad, share = judge(ph, want_words[:, j], k_pt, L)
        wrong, worst = wrong + int(bad.sum()), max(worst, share)
        bad_words |= bad
    return wrong, int(bad_words.sum()), worst
