// Shared device code of the Hopper kernels of the encrypted RAM: modular
// arithmetic, the 4096-point negacyclic NTT in shared memory, and the
// "row fold" that every fused kernel is built from.
//
// Replaces (function, not structure): fhe_ram_tpu/ops/ntt_pallas.py
//   _fwd_tile_mxu / _inv_tile_mxu   -> ntt_fwd_smem / ntt_inv_smem
//   _vmp_invntt                     -> the product loop of fold_row
//   _garner_fold_acc                -> the Garner/digit/scatter loop of fold_row
//   _carry_normalize                -> the carry loop of fold_row
//
// What the TPU kernels did with int8 digit-plane matrix products, tile
// permutation matrices and an f32 Barrett quotient is done here with what
// the card has: a native 32x32->64 bit multiply (IMAD.WIDE), an integer
// Barrett quotient, radix-2 butterflies over one polynomial held in 16 KB
// of shared memory, and automorphisms/rotations as index arithmetic.
//
// Residues are canonical (in [0, p)) everywhere between kernels, so the
// plain PyTorch versions (int64 `%`) and these kernels agree bit for bit.
#pragma once
#include <cooperative_groups.h>
#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

#define FHE_P 3            // CRT primes (Garner is wired for three)
#define FHE_THREADS 512    // threads of every block
#define FHE_MAX_L 8        // most output limbs a fold can produce
#define FHE_MAX_STEPS 16   // most steps one trace launch can chain

struct FheConsts {
  unsigned long long mu64[FHE_P];  // floor(2^64 / p)
  unsigned int p[FHE_P];           // the primes, p < 2^20
  unsigned int mu40[FHE_P];        // floor(2^40 / p)
  unsigned int c12;                // p1^-1 mod p2
  unsigned int p1m3;               // p1 mod p3
  unsigned int c123;               // (p1 p2)^-1 mod p3
  int log_n;                       // ring degree n = 1 << log_n
};

// Twiddle tables in device memory, each uint32[FHE_P][n], canonical.
struct FheTables {
  const uint32_t* psi;      // psi^k
  const uint32_t* inv_psi;  // psi^-k / n
  const uint32_t* fwd_tw;   // DIF stages, concatenated (h = n/2, n/4, ..., 1)
  const uint32_t* inv_tw;   // DIT stages, concatenated (h = 1, 2, ..., n/2)
};

struct FoldShape {
  int T;      // digit polys multiplied into every output poly
  int M;      // output polys = C2 * Lk
  int Lk;     // key limbs
  int Lout;   // output limbs
  int C2;     // output components
  int sign;   // out = normalize(base + sign * fold)
  int mc;     // output polys that share one inverse-transform pass
  int cs;     // blocks that share one row: 1, or a cluster of 3 * k
};

// a * b mod p for a, b < p < 2^20 (so a*b < 2^40).  q underestimates the
// quotient by at most 2, hence two conditional subtractions.
__device__ __forceinline__ uint32_t mulmod(uint32_t a, uint32_t b, uint32_t p,
                                           uint32_t mu40) {
  uint64_t x = (uint64_t)a * b;
  uint32_t xh = (uint32_t)(x >> 18);
  uint32_t q = (uint32_t)(((uint64_t)xh * mu40) >> 22);
  uint32_t r = (uint32_t)x - q * p;
  if (r >= p) r -= p;
  if (r >= p) r -= p;
  return r;
}

// x mod p for any x < 2^64.  q underestimates the quotient by at most 1.
__device__ __forceinline__ uint32_t reduce64(uint64_t x, uint32_t p,
                                             uint64_t mu64) {
  uint64_t q = __umul64hi(x, mu64);
  uint32_t r = (uint32_t)x - (uint32_t)q * p;
  if (r >= p) r -= p;
  return r;
}

// Any int32 (or a small signed sum) to its canonical residue: shift it
// positive by a multiple of p (p << 13 > 2^32), then reduce.
__device__ __forceinline__ uint32_t lift(long long v, uint32_t p, uint64_t mu64) {
  return reduce64((uint64_t)(v + ((long long)p << 13)), p, mu64);
}

__device__ __forceinline__ int center(uint32_t r, uint32_t p) {
  return r > (p >> 1) ? (int)r - (int)p : (int)r;
}

// Forward DIF transform of `npoly` polynomials that lie back to back in
// shared memory, in place: natural order in, bit-reversed out.  One barrier
// per stage.  `tw` is this prime's concatenated stage table.
__device__ __forceinline__ void ntt_fwd_smem(uint32_t* a, int npoly, int log_n,
                                             const uint32_t* __restrict__ tw,
                                             uint32_t p, uint32_t mu40) {
  const int n = 1 << log_n;
  const int half_n = n >> 1;
  const int total = npoly * half_n;
  int off = 0;
  for (int s = 0; s < log_n; ++s) {
    const int lh = log_n - 1 - s;
    const int h = 1 << lh;
    __syncthreads();
    for (int k = threadIdx.x; k < total; k += blockDim.x) {
      const int poly = k >> (log_n - 1);
      const int kk = k & (half_n - 1);
      const int j = kk & (h - 1);
      uint32_t* e0 = a + poly * n + ((kk >> lh) << (lh + 1)) + j;
      const uint32_t u = e0[0], v = e0[h];
      uint32_t sum = u + v;
      if (sum >= p) sum -= p;
      uint32_t dif = u - v;
      if ((int)dif < 0) dif += p;
      e0[0] = sum;
      e0[h] = mulmod(dif, __ldg(tw + off + j), p, mu40);
    }
    off += h;
  }
  __syncthreads();
}

// Inverse DIT transform, in place: bit-reversed in, natural out, WITHOUT
// the final psi^-k / n multiply (the caller folds it into its store).
__device__ __forceinline__ void ntt_inv_smem(uint32_t* a, int npoly, int log_n,
                                             const uint32_t* __restrict__ tw,
                                             uint32_t p, uint32_t mu40) {
  const int n = 1 << log_n;
  const int half_n = n >> 1;
  const int total = npoly * half_n;
  int off = 0;
  for (int s = 0; s < log_n; ++s) {
    const int h = 1 << s;
    __syncthreads();
    for (int k = threadIdx.x; k < total; k += blockDim.x) {
      const int poly = k >> (log_n - 1);
      const int kk = k & (half_n - 1);
      const int j = kk & (h - 1);
      uint32_t* e0 = a + poly * n + ((kk >> s) << (s + 1)) + j;
      const uint32_t u = e0[0];
      const uint32_t t = mulmod(e0[h], __ldg(tw + off + j), p, mu40);
      uint32_t sum = u + t;
      if (sum >= p) sum -= p;
      uint32_t dif = u - t;
      if ((int)dif < 0) dif += p;
      e0[0] = sum;
      e0[h] = dif;
    }
    off += h;
  }
  __syncthreads();
}

// sigma_g evaluated at output index j: returns the source index and sets
// `neg` when the coefficient changes sign.  ginv = g^-1 mod 2n.
__device__ __forceinline__ int sigma_src(int j, int ginv, int n, bool& neg) {
  const int i0 = (int)(((unsigned)ginv * (unsigned)j) & (unsigned)(2 * n - 1));
  neg = i0 >= n;
  return i0 & (n - 1);
}

// (X^k * poly)[j] for a polynomial in device memory; 0 <= k < 2n.
__device__ __forceinline__ int rot_at(const int* __restrict__ poly, int j,
                                      int k, int n) {
  const int kk = k & (n - 1);
  int v = j < kk ? -poly[n - kk + j] : poly[j - kk];
  return k >= n ? -v : v;
}

// The blocks that share a row, as the row functions below see them: how
// many (cs), which of them this block is (rank), and a barrier over them
// after which what one block wrote to device memory the others may read
// (through L2: __ldcg).  Two kinds:
//
// ClusterRow: the block itself (cs = 1), or its thread block cluster
// (arrive.release / wait.acquire at cluster scope).  The per-level kernels.
struct ClusterRow {
  int cs;
  __device__ __forceinline__ explicit ClusterRow(int cs_) : cs(cs_) {}
  __device__ __forceinline__ int rank() const {
    return cs > 1 ? (int)cooperative_groups::this_cluster().block_rank() : 0;
  }
  __device__ __forceinline__ void sync() {
    if (cs > 1)
      cooperative_groups::this_cluster().sync();
    else
      __syncthreads();
  }
};

// GridRow: cs consecutive blocks of a cooperative launch (all blocks of the
// grid are resident, so a block may wait for another).  The one-launch tree
// kernels, whose levels differ in rows and so in cs, which a cluster
// dimension fixed at launch cannot follow.  The barrier is a counter in
// device memory, zero at launch and used by this group alone: every block
// adds one and waits until cs more have arrived than at the last barrier.
// Thread 0 spins without a back-off: a __nanosleep(40) in the loop moved no
// tree time on an H100 (two alternating builds, both trees, 4 and 64 columns).
struct GridRow {
  int cs, rank_;
  unsigned* arrived;
  unsigned target;
  __device__ __forceinline__ GridRow(int cs_, int rank, unsigned* counter)
      : cs(cs_), rank_(rank), arrived(counter), target(0) {}
  __device__ __forceinline__ int rank() const { return rank_; }
  __device__ __forceinline__ void sync() {
    __syncthreads();
    if (cs > 1) {
      target += cs;
      if (threadIdx.x == 0) {
        // release: this block's stores (ordered before by the barrier above)
        // are visible to whoever acquires the count afterwards
        cuda::atomic_ref<unsigned, cuda::thread_scope_device> count(*arrived);
        count.fetch_add(1u, cuda::memory_order_release);
        while (count.load(cuda::memory_order_acquire) < target) {
        }
      }
      __syncthreads();
    }
  }
};

// What a Glue whose digits are coefficients says of spectral input.
struct CoefficientDigits {
  __device__ __forceinline__ bool spectral() const { return false; }
  __device__ __forceinline__ int spectrum(int, int, int) const { return 0; }
};

// Glue of one trace step on a row: digits sigma_g(ct)[mask, l < Td], base
// ct + sigma_g(ct) at the b component, so that fold_row with sign -1 gives
// normalize(ct + KS(sigma_g(ct))).  The trace chains it; the split takes
// one step as its first child.
struct TraceStepGlue : CoefficientDigits {
  const int* ct;  // [C2, L, n] of this row, the step's input; read through
                  // L2, since another block of the cluster may have written it
  int n, L, Td, rank, ginv;
  __device__ __forceinline__ int sigma(int c, int l, int i) const {
    bool neg;
    const int src = sigma_src(i, ginv, n, neg);
    const int v = __ldcg(ct + (c * L + l) * n + src);
    return neg ? -v : v;
  }
  // digit poly t = (mask component c, limb l < Td) of sigma_g(ct)
  __device__ __forceinline__ int digit(int t, int i) const {
    return sigma(t / Td, t % Td, i);
  }
  __device__ __forceinline__ int base(int c2, int l, int i) const {
    int b = __ldcg(ct + (c2 * L + l) * n + i);
    if (c2 == rank) b += sigma(rank, l, i);
    return b;
  }
};

// One ciphertext row through: forward NTT of T digit polys, product with
// the prepared key rows summed over T, inverse NTT, exact 3-prime Garner
// CRT, balanced base-2^9 digit split, fold into base-2^17 limbs,
// out = normalize(base + sign * fold).
//
// Glue supplies  int digit(int t, int i)          -- digit poly t at index i
//                int base(int c2, int l, int i)   -- what is added before
//                                                    the carry normalize
//                bool spectral()                  -- the digits come as
//                int spectrum(int pi, int t, int i)  spectra of prime pi
//                                                    (any representative)
// so the fold, trace, pack-merge and split kernels differ only in their
// Glue.  With spectral() the forward transform is skipped: spectrum() is
// reduced to its canonical residue on load.
//
// A row is the work of the row.cs blocks of `row` (ClusterRow or GridRow
// above; sh.cs is not read here).  cs = 1: one block loops over the
// three primes.  cs = 3 * k: a group of blocks; block `rank` takes
// prime rank % 3 and the (rank / 3)-th of k equal ranges of output polys
// (each block transforms the T digit polys of its prime itself), and the
// last phase is split over the coefficients.  A single row on one SM is
// bound by that SM's instruction rate (~0.45 ms at T = 2, M = 6), so the
// launches with few rows (the trace, the deep merge levels) take clusters.
//
// Shared memory holds ONE prime's T spectra plus sh.mc accumulator polys:
// (T + mc) * 4n bytes (112 KB at T = 4, mc = 3, n = 4096).  More polys per
// inverse pass means fewer barriers a row, fewer blocks an SM.  What does
// not fit goes to device memory: the M * 3 residue polys of the row are
// parked in `scratch` (M * 3 * 4n bytes a row, 288 KB at M = 6), written
// once, and read back once for the Garner step (by the thread that wrote
// them when cs = 1, through L2 by any block of the cluster otherwise).
// keys: uint32[.., T, M, n] of one digit/step; prime p starts at
// keys + p * key_pstride.
template <class Row, class Glue>
__device__ __forceinline__ void fold_row(Row& row, const Glue& glue,
                                         const uint32_t* __restrict__ keys,
                                         long long key_pstride,
                                         const FoldShape sh, const FheConsts& c,
                                         const FheTables& tb,
                                         uint32_t* scratch, int* out,
                                         uint32_t* smem) {
  const int log_n = c.log_n;
  const int n = 1 << log_n;
  const int T = sh.T, M = sh.M;
  uint32_t* spec = smem;
  uint32_t* acc = smem + T * n;

  const int cs = row.cs;
  const int rank = row.rank();
  const int ps = cs > 1 ? FHE_P : 1;       // blocks the primes are dealt to
  const int m_per = M / (cs / ps);         // output polys of this block
  const int m_lo = (rank / ps) * m_per, m_hi = m_lo + m_per;

  row.sync();  // a previous row fold may still read scratch / write `out`
  for (int pi = rank % ps; pi < FHE_P; pi += ps) {
    const uint32_t p = c.p[pi];
    const uint32_t mu40 = c.mu40[pi];
    const uint64_t mu64 = c.mu64[pi];
    const uint32_t* psi = tb.psi + pi * n;
    const uint32_t* inv_psi = tb.inv_psi + pi * n;

    if (glue.spectral()) {
      for (int idx = threadIdx.x; idx < T * n; idx += blockDim.x)
        spec[idx] = lift(glue.spectrum(pi, idx >> log_n, idx & (n - 1)), p, mu64);
      __syncthreads();
    } else {
      for (int idx = threadIdx.x; idx < T * n; idx += blockDim.x) {
        const int t = idx >> log_n, i = idx & (n - 1);
        const uint32_t r = lift(glue.digit(t, i), p, mu64);
        spec[idx] = mulmod(r, __ldg(psi + i), p, mu40);
      }
      ntt_fwd_smem(spec, T, log_n, tb.fwd_tw + pi * n, p, mu40);
    }

    // mc output polys at a time: their products, ONE batched inverse pass
    // (twelve barriers for all of them), their stores
    const uint32_t* kp = keys + pi * key_pstride;
    for (int m0 = m_lo; m0 < m_hi; m0 += sh.mc) {
      const int cnt = min(sh.mc, m_hi - m0);
      for (int idx = threadIdx.x; idx < cnt * n; idx += blockDim.x) {
        const int i = idx & (n - 1);
        const uint32_t* km = kp + (long long)(m0 + (idx >> log_n)) * n + i;
        uint64_t s = 0;
        for (int t = 0; t < T; ++t)
          s += (uint64_t)spec[t * n + i] * __ldg(km + (long long)t * M * n);
        acc[idx] = reduce64(s, p, mu64);
      }
      ntt_inv_smem(acc, cnt, log_n, tb.inv_tw + pi * n, p, mu40);
      uint32_t* dst = scratch + ((long long)pi * M + m0) * n;
      for (int idx = threadIdx.x; idx < cnt * n; idx += blockDim.x)
        dst[idx] = mulmod(acc[idx], __ldg(inv_psi + (idx & (n - 1))), p, mu40);
    }
    __syncthreads();  // spectra are overwritten by the next prime
  }
  row.sync();  // all residues of the row are in scratch

  // Garner + digit split + limb fold + normalize, over this block's share
  // of the coefficients.  Residues are read through L2 (__ldcg): another
  // block of the cluster may have written them.
  const uint32_t p1 = c.p[0], p2 = c.p[1], p3 = c.p[2];
  const long long p1p2 = (long long)p1 * p2;
  const int i_per = (n + cs - 1) / cs;
  const int i_hi = min(n, (rank + 1) * i_per);
  for (int i = rank * i_per + threadIdx.x; i < i_hi; i += blockDim.x) {
    for (int c2 = 0; c2 < sh.C2; ++c2) {
      int accl[FHE_MAX_L];
#pragma unroll
      for (int l = 0; l < FHE_MAX_L; ++l) accl[l] = 0;
      for (int lk = 0; lk < sh.Lk; ++lk) {
        const int m = c2 * sh.Lk + lk;
        const uint32_t r1 = __ldcg(scratch + ((long long)0 * M + m) * n + i);
        const uint32_t r2 = __ldcg(scratch + ((long long)1 * M + m) * n + i);
        const uint32_t r3 = __ldcg(scratch + ((long long)2 * M + m) * n + i);
        const int v1 = center(r1, p1);
        const int v2 = center(
            mulmod(lift((long long)r2 - v1, p2, c.mu64[1]), c.c12, p2, c.mu40[1]), p2);
        const uint32_t tt =
            mulmod(lift(v2, p3, c.mu64[2]), c.p1m3, p3, c.mu40[2]);
        const int v3 = center(
            mulmod(lift((long long)r3 - v1 - (long long)tt, p3, c.mu64[2]), c.c123,
                   p3, c.mu40[2]), p3);
        long long x = (long long)v1 + (long long)p1 * v2 + p1p2 * v3;
        const int w = 17 * (lk + 1);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int d = (int)((x + 256) & 511) - 256;
          x = (x - d) >> 9;
          const int e = 9 * k - w;  // this digit has weight 2^e
          if (e < 0) {
            const int tl = (-e - 1) / 17;
            if (tl < sh.Lout) accl[tl] += d * (1 << (e + 17 * (tl + 1)));
          }
        }
      }
      int carry = 0;
      for (int l = sh.Lout - 1; l >= 0; --l) {
        int t = accl[l];
        if (sh.sign < 0) t = -t;
        t += glue.base(c2, l, i);
        t += carry;
        const int d = ((t + 65536) & 131071) - 65536;
        carry = (t - d) >> 17;
        out[((long long)c2 * sh.Lout + l) * n + i] = d;
      }
    }
  }
}

// A load of ciphertext data: through L2 where another block of this launch
// may have written it (the tree kernels' levels), else as the compiler likes.
template <bool kThroughL2>
__device__ __forceinline__ int ct_load(const int* p) {
  return kThroughL2 ? __ldcg(p) : *p;
}

// Glue of one pack-tree merge on a row pair: with u, v = A +- X^t B the
// digits are sigma_g(v)[mask, l < Td] and the base u + sigma_g(v) at the b
// component, so that fold_row with sign -1 gives normalize(u + KS(sigma_g(v))).
// X^t and sigma_g are index arithmetic on the loads: u, v and sigma_g(v) are
// never written anywhere.
template <bool kThroughL2>
struct MergeGlue : CoefficientDigits {
  const int* A;  // [C2, L, n] of this pair
  const int* B;
  int n, L, Td, rank, ginv, t_rot;
  // (X^t_rot * B)[c, l][j]
  __device__ __forceinline__ int xb(int c, int l, int j) const {
    const int* poly = B + (c * L + l) * n;
    const int kk = t_rot & (n - 1);
    const int v = j < kk ? -ct_load<kThroughL2>(poly + n - kk + j)
                         : ct_load<kThroughL2>(poly + j - kk);
    return t_rot >= n ? -v : v;
  }
  __device__ __forceinline__ int sigma_v(int c, int l, int i) const {
    bool neg;
    const int src = sigma_src(i, ginv, n, neg);
    const int v = ct_load<kThroughL2>(A + (c * L + l) * n + src) - xb(c, l, src);
    return neg ? -v : v;
  }
  __device__ __forceinline__ int digit(int t, int i) const {
    return sigma_v(t / Td, t % Td, i);
  }
  __device__ __forceinline__ int base(int c2, int l, int i) const {
    int b = ct_load<kThroughL2>(A + (c2 * L + l) * n + i) + xb(c2, l, i);
    if (c2 == rank) b += sigma_v(rank, l, i);
    return b;
  }
};

// One merge of the pack tree on the row pair (A, B), each [C2, L, n]:
// out = normalize(u + KS(sigma_g(v))), u/v = A +- X^t_rot B.  t_rot in
// [0, 2n); ginv = g^-1 mod 2n; key: uint32[P, T, M, n] with T = rank * Td.
template <bool kThroughL2, class Row>
__device__ __forceinline__ void merge_row(Row& row, const int* A, const int* B,
                                          int* out, const uint32_t* key,
                                          int t_rot, int ginv, int Td,
                                          const FoldShape sh, const FheConsts& c,
                                          const FheTables& tb, uint32_t* scratch,
                                          uint32_t* smem) {
  MergeGlue<kThroughL2> glue;
  glue.A = A;
  glue.B = B;
  glue.n = 1 << c.log_n;
  glue.L = sh.Lout;
  glue.Td = Td;
  glue.rank = sh.C2 - 1;
  glue.ginv = ginv;
  glue.t_rot = t_rot;
  fold_row(row, glue, key, (long long)sh.T * sh.M << c.log_n, sh, c, tb, scratch,
           out, smem);
}

// One split of the slot-extraction tree on the row x [C2, L, n]:
//   c0 = normalize(x + KS(sigma_g(x)))       (one trace step)
//   c1 = normalize(X^t_back (2x - c0))       (t_back = 2n - t: X^-t)
// c1 reads c0 at rotated positions, which another block of the row's group
// may have written: a barrier after the fold, then reads through L2.  The
// rotation is index arithmetic with a sign flip on the wrap; 2x - c0 is at
// most 3 * 2^16 in magnitude and is carried into balanced limbs coefficient
// by coefficient, the coefficients dealt over the blocks of the group as in
// the fold's last phase.  x, c0 and c1 must not overlap.  key: uint32[P, T,
// M, n] with T = rank * L.
template <class Row>
__device__ __forceinline__ void split_row(Row& row, const int* x, int* c0,
                                          int* c1, const uint32_t* key,
                                          int t_back, int ginv,
                                          const FoldShape sh, const FheConsts& c,
                                          const FheTables& tb, uint32_t* scratch,
                                          uint32_t* smem) {
  const int n = 1 << c.log_n;
  const int L = sh.Lout;
  TraceStepGlue glue;
  glue.ct = x;
  glue.n = n;
  glue.L = L;
  glue.Td = L;
  glue.rank = sh.C2 - 1;
  glue.ginv = ginv;
  fold_row(row, glue, key, (long long)sh.T * sh.M * n, sh, c, tb, scratch, c0,
           smem);
  row.sync();  // c0 is complete, whichever block wrote it

  const int cs = row.cs;
  const int rank = row.rank();
  const int i_per = (n + cs - 1) / cs;
  const int i_hi = min(n, (rank + 1) * i_per);
  const int kk = t_back & (n - 1);
  for (int i = rank * i_per + threadIdx.x; i < i_hi; i += blockDim.x) {
    // (X^t_back * d)[i] = +-d[src]
    const bool wrap = i < kk;
    const int src = wrap ? n - kk + i : i - kk;
    const bool neg = wrap != (t_back >= n);
    for (int c2 = 0; c2 < sh.C2; ++c2) {
      int carry = 0;
      for (int l = L - 1; l >= 0; --l) {
        const int at = (c2 * L + l) * n + src;
        int v = 2 * __ldcg(x + at) - __ldcg(c0 + at);
        if (neg) v = -v;
        v += carry;
        const int d = ((v + 65536) & 131071) - 65536;
        carry = (v - d) >> 17;
        c1[(c2 * L + l) * n + i] = d;
      }
    }
  }
}

// Launch `kernel` with `rows` groups of sh.cs blocks (one group a row, or
// fewer groups that each walk over several rows); a group of more than one
// block is a thread block cluster.
template <class... KArgs, class... Args>
static inline int fold_launch(void (*kernel)(KArgs...), int rows,
                              const FoldShape& sh, int log_n, void* stream,
                              Args... args) {
  const size_t smem = (size_t)(sh.T + sh.mc) * sizeof(uint32_t) << log_n;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)rows * sh.cs);
  cfg.blockDim = dim3(FHE_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = sh.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, KArgs(args)...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---- the one-launch tree kernels ------------------------------------------
// A tree kernel walks all levels of a split or pack tree in one cooperative
// launch: every block of the grid is resident, each level's rows are dealt
// over groups of blocks (GridRow), and a grid-wide barrier separates the
// levels.  What a level needs beside its key:
struct TreeLevels {
  int count;
  int cs[FHE_MAX_STEPS];    // blocks that share a row at this level
  int ginv[FHE_MAX_STEPS];  // g^-1 mod 2n of the level's galois element
  int rot[FHE_MAX_STEPS];   // the level's rotation X^rot, rot in [0, 2n)
};

static inline size_t tree_smem(const FoldShape& sh, int log_n) {
  return (size_t)(sh.T + sh.mc) * sizeof(uint32_t) << log_n;
}

// The most blocks of `kernel` the current device holds at once with this
// much dynamic shared memory: the largest grid a cooperative launch takes.
template <class... KArgs>
static inline int tree_blocks(void (*kernel)(KArgs...), size_t smem,
                              int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      FHE_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  *blocks = per_sm * sms;
  return 0;
}

// Cooperative launch of `kernel` with `blocks` blocks (<= tree_blocks).
template <class... KArgs, class... Args>
static inline int tree_launch(void (*kernel)(KArgs...), int blocks, size_t smem,
                              void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(FHE_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, KArgs(args)...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
