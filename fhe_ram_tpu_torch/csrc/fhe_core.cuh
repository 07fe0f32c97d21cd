// Shared device code of the Hopper kernels of the encrypted RAM: modular
// arithmetic, the 4096-point negacyclic NTT in shared memory in two bodies,
// and the "row fold" the first fused kernels were built from.  Kernel 12
// (external.cu) runs the bodies and the row fold's first half
// (prime_residues); the rest serves the predecessors kept for timing in
// fhe_ram_tpu_torch/tools/.  Every other kernel of csrc/ but the
// collectives runs on fold_body.cuh.
//
// Replaces (function, not structure): fhe_ram_tpu/ops/ntt_pallas.py
//   _fwd_tile_mxu / _inv_tile_mxu   -> ntt_fwd_smem / ntt_inv_smem
//   _fwd_kernel / _inv_kernel, built on _dif_stage / _dit_stage (the
//   FHERAM_MXU=0 body)              -> ntt_fwd_smem_2pass / ntt_inv_smem_2pass
//   _vmp_invntt                     -> the product loop of prime_residues
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

// ---- the two-pass body ------------------------------------------------------
// The same twelve stages as ntt_fwd_smem / ntt_inv_smem, in the same order,
// with the same butterflies and twiddles, so the output is the same bit for
// bit, spectra included: only who computes which butterfly, and when,
// differs.  Coefficient k is element (i, j) = (k >> 6, k & 63) of a 64 x 64
// block.  DIF stages 0-5 (h = 2048 .. 64) pair (i, j) with (i + h/64, j) and
// never leave a column; stages 6-11 (h = 32 .. 1) stay within a row.  So a
// pass over the columns runs stages 0-5 and a pass over the rows stages
// 6-11 (the DIT inverse: rows for its stages 0-5, then columns), with a
// barrier between the two passes instead of one a stage.
//
// A line (column or row) of 64 coefficients is held by LT consecutive lanes
// of a warp, 64 / LT coefficients a lane in registers: lane t holds line
// elements e = t + LT * r.  A stage of pair distance d >= LT pairs registers
// r and r + d / LT of one lane; one of d < LT pairs lanes t and t ^ d
// (__shfl_xor_sync: each lane computes its own half of the butterfly).  The
// twiddle of the pair (e, e + d) is the radix-2 body's: stage offset plus
// (e mod d) * es + (the column, in the column pass), es the element stride.
// The column pass takes LT = 4 (8 columns a warp: 4-way bank conflicts on
// its loads and stores; LT = 8 would be 8-way), the row pass LT = 8 (4 rows
// a warp, 4-way as well).  Wired for n = 4096 (the wrappers take no other).

__device__ __forceinline__ uint32_t add_mod(uint32_t u, uint32_t v, uint32_t p) {
  uint32_t s = u + v;
  if (s >= p) s -= p;
  return s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t u, uint32_t v, uint32_t p) {
  uint32_t d = u - v;
  if ((int)d < 0) d += p;
  return d;
}

// One pass of six stages over every line of `npoly` polynomials: kColumns
// the columns (forward stages 0-5, inverse stages 6-11), else the rows.
// The lines of a warp are consecutive and 64 * npoly is a multiple of the
// lines a warp holds, so each warp runs whole loop iterations (full-mask
// shuffles) whenever blockDim.x is a multiple of 32.
template <int LT, bool kColumns, bool kInverse>
__device__ __forceinline__ void ntt_pass(uint32_t* a, int npoly,
                                         const uint32_t* __restrict__ tw,
                                         uint32_t p, uint32_t mu40) {
  constexpr int E = 64 / LT;
  constexpr int es = kColumns ? 64 : 1;
  const int t = threadIdx.x % LT;
  for (int line = threadIdx.x / LT; line < npoly * 64; line += blockDim.x / LT) {
    const int l = line & 63;
    uint32_t* base = a + (line >> 6) * 4096 + (kColumns ? l : l * 64);
    const int tw_line = kColumns ? l : 0;
    uint32_t v[E];
#pragma unroll
    for (int r = 0; r < E; ++r) v[r] = base[(t + LT * r) * es];
#pragma unroll
    for (int sl = 0; sl < 6; ++sl) {
      const int d = kInverse ? 1 << sl : 32 >> sl;       // distance along the line
      const int off = kInverse ? d * es - 1 : 4096 - 2 * d * es;  // stage table
      if (d >= LT) {
        const int dr = d / LT;
#pragma unroll
        for (int r = 0; r < E; ++r) {
          if (r & dr) continue;
          const int e = t + LT * r;
          const uint32_t w = __ldg(tw + off + (e & (d - 1)) * es + tw_line);
          if (kInverse) {
            const uint32_t u = v[r], x = mulmod(v[r + dr], w, p, mu40);
            v[r] = add_mod(u, x, p);
            v[r + dr] = sub_mod(u, x, p);
          } else {
            const uint32_t u = v[r], x = v[r + dr];
            v[r] = add_mod(u, x, p);
            v[r + dr] = mulmod(sub_mod(u, x, p), w, p, mu40);
          }
        }
      } else {
        const bool hi = (t & d) != 0;   // this lane holds the pair's upper half
#pragma unroll
        for (int r = 0; r < E; ++r) {
          const int e = t + LT * r;
          if (kInverse) {
            // the upper lane sends w * v, the lower lane u
            uint32_t mine = v[r];
            if (hi) mine = mulmod(mine, __ldg(tw + off + (e & (d - 1)) * es + tw_line),
                                  p, mu40);
            const uint32_t y = __shfl_xor_sync(0xffffffffu, mine, d);
            v[r] = hi ? sub_mod(y, mine, p) : add_mod(mine, y, p);
          } else {
            const uint32_t y = __shfl_xor_sync(0xffffffffu, v[r], d);
            v[r] = hi ? mulmod(sub_mod(y, v[r], p),
                               __ldg(tw + off + (e & (d - 1)) * es + tw_line), p, mu40)
                      : add_mod(v[r], y, p);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < E; ++r) base[(t + LT * r) * es] = v[r];
  }
}

// ntt_fwd_smem's contract (natural order in, bit-reversed out, canonical,
// npoly polys back to back, opening barrier after the caller's loads) with
// two barriers inside instead of eleven.
__device__ __forceinline__ void ntt_fwd_smem_2pass(uint32_t* a, int npoly,
                                                   const uint32_t* __restrict__ tw,
                                                   uint32_t p, uint32_t mu40) {
  __syncthreads();
  ntt_pass<4, true, false>(a, npoly, tw, p, mu40);    // stages 0-5, columns
  __syncthreads();
  ntt_pass<8, false, false>(a, npoly, tw, p, mu40);   // stages 6-11, rows
  __syncthreads();
}

// ntt_inv_smem's contract, likewise.
__device__ __forceinline__ void ntt_inv_smem_2pass(uint32_t* a, int npoly,
                                                   const uint32_t* __restrict__ tw,
                                                   uint32_t p, uint32_t mu40) {
  __syncthreads();
  ntt_pass<8, false, true>(a, npoly, tw, p, mu40);    // stages 0-5, rows
  __syncthreads();
  ntt_pass<4, true, true>(a, npoly, tw, p, mu40);     // stages 6-11, columns
  __syncthreads();
}

// The body every kernel of a translation unit runs: the two-pass body when
// the unit is built with -DFHE_NTT_TWO_PASS (ops/ntt_cuda.py builds
// external.cu, and tools/ the predecessors of ntt.cu and fold.cu, once with
// it and once without), radix-2 else.
__device__ __forceinline__ void ntt_fwd_body(uint32_t* a, int npoly, int log_n,
                                             const uint32_t* __restrict__ tw,
                                             uint32_t p, uint32_t mu40) {
#ifdef FHE_NTT_TWO_PASS
  ntt_fwd_smem_2pass(a, npoly, tw, p, mu40);
#else
  ntt_fwd_smem(a, npoly, log_n, tw, p, mu40);
#endif
}

__device__ __forceinline__ void ntt_inv_body(uint32_t* a, int npoly, int log_n,
                                             const uint32_t* __restrict__ tw,
                                             uint32_t p, uint32_t mu40) {
#ifdef FHE_NTT_TWO_PASS
  ntt_inv_smem_2pass(a, npoly, tw, p, mu40);
#else
  ntt_inv_smem(a, npoly, log_n, tw, p, mu40);
#endif
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
// grid are resident, so a block may wait for another).  The predecessors
// of the pack tree and the split tree (tools/pack_tree_predecessor.cu,
// tools/split_tree_predecessor.cu), whose levels differ in rows and so in
// cs, which a cluster dimension fixed at launch cannot follow.  The barrier is a counter in
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
// normalize(ct + KS(sigma_g(ct))).  The split tree (split_row) takes one
// step as a level's first child.
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
// fold_row, its Glues, merge_row, split_row, GridRow, UnitSlot and
// TreeLevels serve the predecessors kept for timing in
// fhe_ram_tpu_torch/tools/ only: since the pack tree (kernel 8) moved onto
// csrc/fold_body.cuh, no kernel of csrc/ runs them.
//
// Glue supplies  int digit(int t, int i)          -- digit poly t at index i
//                int base(int c2, int l, int i)   -- what is added before
//                                                    the carry normalize
//                bool spectral()                  -- the digits come as
//                int spectrum(int pi, int t, int i)  spectra of prime pi
//                                                    (any representative)
// so the kernels built on it differ only in their Glue.  With spectral()
// the forward transform is skipped: spectrum() is reduced to its canonical
// residue on load.
//
// A row is the work of the row.cs blocks of `row` (ClusterRow or GridRow
// above; sh.cs is not read here).  cs = 1: one block loops over the
// three primes.  cs = 3 * k: a group of blocks; block `rank` takes
// prime rank % 3 and the (rank / 3)-th of k equal ranges of output polys
// (each block transforms the T digit polys of its prime itself), and the
// last phase is split over the coefficients.  A single row on one SM is
// bound by that SM's instruction rate (~0.45 ms at T = 2, M = 6), so the
// launches with few rows (the trees' deep levels) take clusters.
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
//
// prime_residues is the part of a row fold that one prime takes: the T digit
// polys forward-transformed (or their spectra as given), the products with
// this prime's key rows kp (uint32[T, M, n]) summed over T, and the output
// polys m_lo <= m < m_hi sh.mc at a time through ONE batched inverse pass;
// each residue (canonical, times psi^-i / n) goes to store(m, i, r).  It
// returns with the block synchronised, so shared memory may be overwritten.
template <class Glue, class Store>
__device__ __forceinline__ void prime_residues(const Glue& glue, int pi,
                                               const uint32_t* __restrict__ kp,
                                               int m_lo, int m_hi,
                                               const FoldShape& sh,
                                               const FheConsts& c,
                                               const FheTables& tb,
                                               uint32_t* smem, Store store) {
  const int log_n = c.log_n;
  const int n = 1 << log_n;
  const int T = sh.T, M = sh.M;
  uint32_t* spec = smem;
  uint32_t* acc = smem + T * n;
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
    ntt_fwd_body(spec, T, log_n, tb.fwd_tw + pi * n, p, mu40);
  }

  // mc output polys at a time: their products, ONE batched inverse pass
  // (the body's barriers once for all of them), their stores
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
    ntt_inv_body(acc, cnt, log_n, tb.inv_tw + pi * n, p, mu40);
    for (int idx = threadIdx.x; idx < cnt * n; idx += blockDim.x)
      store(m0 + (idx >> log_n), idx & (n - 1),
            mulmod(acc[idx], __ldg(inv_psi + (idx & (n - 1))), p, mu40));
  }
  __syncthreads();  // the spectra may be overwritten now
}

template <class Row, class Glue>
__device__ __forceinline__ void fold_row(Row& row, const Glue& glue,
                                         const uint32_t* __restrict__ keys,
                                         long long key_pstride,
                                         const FoldShape sh, const FheConsts& c,
                                         const FheTables& tb,
                                         uint32_t* scratch, int* out,
                                         uint32_t* smem) {
  const int n = 1 << c.log_n;
  const int M = sh.M;

  const int cs = row.cs;
  const int rank = row.rank();
  const int ps = cs > 1 ? FHE_P : 1;       // blocks the primes are dealt to
  const int m_per = M / (cs / ps);         // output polys of this block
  const int m_lo = (rank / ps) * m_per, m_hi = m_lo + m_per;

  row.sync();  // a previous row fold may still read scratch / write `out`
  for (int pi = rank % ps; pi < FHE_P; pi += ps) {
    uint32_t* dst = scratch + (long long)pi * M * n;
    prime_residues(glue, pi, keys + pi * key_pstride, m_lo, m_hi, sh, c, tb, smem,
                   [&](int m, int i, uint32_t r) { dst[(long long)m * n + i] = r; });
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

// Glue of one CMux on a row: out = normalize(lo + (hi - lo) x GGSW), the
// digits the top Td limbs of hi - lo (|limb| <= 2^17: no normalize pass),
// the base lo.  hi and lo are [C2, L, n]; read through L2, since the VM
// chain kernels read what another block of the launch wrote.
struct CmuxGlue : CoefficientDigits {
  const int* hi;
  const int* lo;
  int n, L, Td;
  __device__ __forceinline__ int digit(int t, int i) const {
    const int at = ((t / Td) * L + t % Td) * n + i;
    return __ldcg(hi + at) - __ldcg(lo + at);
  }
  __device__ __forceinline__ int base(int c2, int l, int i) const {
    return __ldcg(lo + (c2 * L + l) * n + i);
  }
};

// Glue of one blind-rotation step on a row ct [C2, L, n]: the CMux of
// X^rot * ct against ct, so hi = X^rot ct is index arithmetic on the loads
// (a sign flip where the index wraps) and never written anywhere.
struct RotateCmuxGlue : CoefficientDigits {
  const int* ct;
  int n, L, Td, rot;  // rot in [0, 2n)
  __device__ __forceinline__ int rotated(const int* poly, int j) const {
    const int kk = rot & (n - 1);
    const int v = j < kk ? -__ldcg(poly + n - kk + j) : __ldcg(poly + j - kk);
    return rot >= n ? -v : v;
  }
  __device__ __forceinline__ int digit(int t, int i) const {
    const int* poly = ct + ((t / Td) * L + t % Td) * n;
    return rotated(poly, i) - __ldcg(poly + i);
  }
  __device__ __forceinline__ int base(int c2, int l, int i) const {
    return __ldcg(ct + (c2 * L + l) * n + i);
  }
};

// ---- the predecessors of the VM chain kernels ------------------------------
// (tools/dp_chain_predecessor.cu, tools/bitwise_predecessor.cu; dp_chain.cu
// and bitwise.cu run on fold_body.cuh.)
// A cooperative launch dealt into groups of `slots` x cs consecutive blocks.
// A group walks units (an op of the carry chain, a bit of the bitwise
// group) g, g + groups, ...; slot r of the group folds the r-th row of a
// phase of its unit with the cs blocks of the slot (`row`), and `unit` is
// a barrier over all blocks of the group between two phases.  No barrier
// spans two groups: units are independent.  Counters in `arrived`, zero at
// launch: slots + 1 a group.
struct UnitSlot {
  int groups, group, slot;
  GridRow row, unit;
  __device__ __forceinline__ UnitSlot(int slots, int cs, unsigned* arrived)
      : groups((int)gridDim.x / (slots * cs)),
        group((int)blockIdx.x / (slots * cs)),
        slot(((int)blockIdx.x / cs) % slots),
        row(cs, (int)blockIdx.x % cs,
            arrived + (blockIdx.x / (slots * cs)) * (slots + 1) + ((blockIdx.x / cs) % slots)),
        unit(slots * cs, (int)blockIdx.x % (slots * cs),
             arrived + (blockIdx.x / (slots * cs)) * (slots + 1) + slots) {}
};

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

// ---- the one-launch tree kernels on fold_row -------------------------------
// (tools/pack_tree_predecessor.cu and tools/split_tree_predecessor.cu;
// pack_tree.cu and split_tree.cu run on fold_body.cuh.)
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
