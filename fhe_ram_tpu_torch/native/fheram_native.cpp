// fheram_native: exact golden-model kernels + IO helpers (C ABI).
//
// Role in the TPU framework (counterpart of the reference's native
// spqlios-arithmetic layer, SURVEY.md L0): the TPU compute path is
// JAX/XLA/Pallas int32+float32 arithmetic whose exactness rests on
// bound proofs; this library provides independent wide-integer
// (__int128 / uint64) implementations of the same operations so tests
// can cross-validate the TPU kernels bit-for-bit, plus fast host-side
// data marshalling (RAM byte de-interleaving) for the encrypt path.
//
// Build: g++ -O2 -shared -fPIC -o libfheram_native.so fheram_native.cpp

#include <cstdint>
#include <cstring>

extern "C" {

// Exact negacyclic convolution: out[k] = sum_{i+j=k} a_i b_j - wrap terms,
// accumulated in __int128, reported centered mod `modulus` (modulus == 0:
// raw int64, caller guarantees |result| < 2^63).
void negacyclic_conv_i64(const int64_t* a, const int64_t* b, int64_t* out,
                         int n, int64_t modulus) {
  for (int k = 0; k < n; ++k) {
    __int128 acc = 0;
    for (int i = 0; i <= k; ++i) acc += (__int128)a[i] * b[k - i];
    for (int i = k + 1; i < n; ++i) acc -= (__int128)a[i] * b[n + k - i];
    if (modulus > 0) {
      __int128 m = modulus;
      __int128 r = acc % m;
      if (r > m / 2) r -= m;
      if (r < -(m / 2)) r += m;
      out[k] = (int64_t)r;
    } else {
      out[k] = (int64_t)acc;
    }
  }
}

static uint64_t pow_mod(uint64_t b, uint64_t e, uint64_t p) {
  unsigned __int128 acc = 1, cur = b % p;
  while (e) {
    if (e & 1) acc = acc * cur % p;
    cur = cur * cur % p;
    e >>= 1;
  }
  return (uint64_t)acc;
}

// Exact forward negacyclic NTT (reference order: naive O(n^2) evaluation
// at psi^(2k+1) -- golden model, not a fast path).
// out[k] = sum_i a_i psi^{(2k+1) i} mod p, centered.
void negacyclic_ntt_ref(const int64_t* a, int64_t* out, int n, uint64_t p,
                        uint64_t psi) {
  for (int k = 0; k < n; ++k) {
    unsigned __int128 acc = 0;
    uint64_t w = pow_mod(psi, 2 * (uint64_t)k + 1, p);
    uint64_t x = 1;
    for (int i = 0; i < n; ++i) {
      uint64_t ai = (uint64_t)((a[i] % (int64_t)p + (int64_t)p) % (int64_t)p);
      acc += (unsigned __int128)ai * x % p;
      x = (uint64_t)((unsigned __int128)x * w % p);
    }
    int64_t r = (int64_t)(acc % p);
    if (r > (int64_t)(p / 2)) r -= (int64_t)p;
    out[k] = r;
  }
}

// Garner reconstruction of 3-prime CRT residues into centered __int128,
// then base-2^b signed digit expansion (golden model of ops/crt.py).
// digits: out[n][ndig] row-major.
void garner3_digits(const int64_t* r1, const int64_t* r2, const int64_t* r3,
                    int n, int64_t p1, int64_t p2, int64_t p3, int b,
                    int ndig, int64_t* digits) {
  // inverses via Fermat
  uint64_t inv_p1_p2 = pow_mod((uint64_t)(p1 % p2), (uint64_t)p2 - 2, (uint64_t)p2);
  uint64_t p1p2_mod_p3 = (uint64_t)((unsigned __int128)(p1 % p3) * (uint64_t)(p2 % p3) % (uint64_t)p3);
  uint64_t inv_p1p2_p3 = pow_mod(p1p2_mod_p3, (uint64_t)p3 - 2, (uint64_t)p3);

  for (int i = 0; i < n; ++i) {
    int64_t v1 = ((r1[i] % p1) + p1) % p1;
    if (v1 > p1 / 2) v1 -= p1;
    int64_t t2 = ((r2[i] - v1) % p2 + p2) % p2;
    int64_t v2 = (int64_t)((unsigned __int128)t2 * inv_p1_p2 % (uint64_t)p2);
    if (v2 > p2 / 2) v2 -= p2;
    __int128 x12 = (__int128)v1 + (__int128)p1 * v2;
    int64_t x12m = (int64_t)(((x12 % p3) + p3) % p3);
    int64_t t3 = ((r3[i] - x12m) % p3 + p3) % p3;
    int64_t v3 = (int64_t)((unsigned __int128)t3 * inv_p1p2_p3 % (uint64_t)p3);
    if (v3 > p3 / 2) v3 -= p3;
    __int128 x = x12 + (__int128)p1 * (__int128)p2 * v3;
    // balanced base-2^b digits
    for (int d = 0; d < ndig; ++d) {
      int64_t half = (int64_t)1 << (b - 1);
      int64_t mask = ((int64_t)1 << b) - 1;
      int64_t dig = (int64_t)(((x + half) & mask)) - half;
      digits[i * ndig + d] = dig;
      x = (x - dig) >> b;
    }
  }
}

// RAM byte de-interleaving (reference Ram::encrypt_sk inner loop,
// src/ram.rs:160-166): data[addr*W + w] -> out[w][addr], with i8 cast.
void deinterleave_i8(const uint8_t* data, int32_t* out, int64_t max_addr,
                     int word_size) {
  for (int64_t a = 0; a < max_addr; ++a)
    for (int w = 0; w < word_size; ++w)
      out[w * max_addr + a] = (int32_t)(int8_t)data[a * word_size + w];
}

void interleave_u8(const int32_t* in, uint8_t* out, int64_t max_addr,
                   int word_size) {
  for (int64_t a = 0; a < max_addr; ++a)
    for (int w = 0; w < word_size; ++w)
      out[a * word_size + w] = (uint8_t)(in[w * max_addr + a] & 0xFF);
}

}  // extern "C"
