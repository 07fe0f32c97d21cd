// Kernels 2 and 5: the fused external product / keyswitch core, with one
// key for all rows or with one key per item of a leading batch axis.
// Forward NTT of T gadget-digit polys (or their spectra as given), product
// with prepared key rows summed over T, inverse NTT, exact 3-prime Garner
// CRT, fold into base-2^17 limbs, optional base + sign * fold, carry
// normalize; `digits > 1` chains a CMux digit chain (each digit's
// normalized output is the next digit's input).
//
// Replaces fhe_ram_tpu/ops/ntt_pallas.py: fused_external_fold_pallas
// (entry fhe_fold with items = 1) and fused_external_fold_batched (items =
// A: item a of the rows takes keys[a]; with spectral input ONE operand
// x[P, B, T, n] is shared by all items, the batched read's level 0), both
// of the JAX package's bodies (the MXU and the FHERAM_MXU=0 branches of
// _fold_kernel_factory compute the same integers).
//
// Bound on this card: operations.  A row reads T * 16 KB of digits and
// writes C2 * Lout * 16 KB; the key rows (P * T * M * 16 KB an item) are
// shared by an item's rows and stay in L2.  Against that stand 3 * (T + M)
// transforms a row (30 at T = 4, M = 6; 3 * M with spectral input), ~25k
// modular butterflies each.
//
// Design (built once; it serves the fused and the composed routes alike):
//  * A row is a thread block cluster with one block per prime (cs = 3), or
//    two such groups (cs = 6) that share the output components when rows
//    are few.  Block `rank` takes prime rank % 3 and, in group rank / 3,
//    C2 / (cs / 3) output components.  Persistent clusters walk rows r,
//    r + clusters, ...
//  * A block's 256 threads hold 16 coefficients each in registers and run
//    a 4096-point transform as three radix-16 passes (four radix-2 stages
//    each, in registers) with two shared-memory exchanges, so two barriers a
//    transform.  The stages are the radix-2 body's (ntt_fwd_smem /
//    ntt_inv_smem): DIF natural in, bit-reversed out; DIT back, so spectra
//    and prepared keys keep kernel 1's order.  Layout Lq of pass q: thread
//    t, register r holds coefficient
//        L0: t | r << 8      L1: (t & 15) | r << 4 | (t >> 4) << 8
//        L2: r | t << 4
//    and the exchange buffers are XOR-swizzled (swz) so that every pass's
//    reads and writes are free of bank conflicts.
//  * Constants multiply by Shoup's method: each table entry is a pair
//    (w, floor(w * 2^32 / p)) made on the host (ops/ntt.py
//    NTTContext.shoup_tables), and x * w costs a __umulhi, two multiplies
//    and no correction: the result lies in [0, 2p) for any x < 2^32.
//    Butterflies are lazy (Harvey): DIF values in [0, 2p), DIT in [0, 4p),
//    one conditional subtract a butterfly (p < 2^20 leaves 10 bits).  Only
//    the key products multiply two variables: T products summed in 64 bits,
//    one reduction.  The twist psi^i, i = j + 256 r, is psi^j (one pair a
//    thread) times psi^(256 r) (16 pairs shared by all); likewise the
//    inverse's psi^-i / n and the twiddles of the outer passes, whose index
//    j = t | rl << 8 splits the same way: this thread's four pairs (one a
//    stage) stay in registers for a row's transforms, the 15 shared ones
//    come from L1.
//  * The residues stay on chip.  Each block keeps its prime's residues of
//    one component (Lk polys) in shared memory; after one cluster barrier
//    every block runs the Garner, digit and carry step over a third of the
//    coefficients, reading the other two primes' residues over distributed
//    shared memory.  A second cluster barrier (arrive now, wait before the
//    buffers are written again) frees them.
//  * Shared memory: the T spectra (each thread's own 16 coefficients, read
//    back by the same thread) and the Lk residue polys, which double as the
//    transforms' exchange buffers: (T + Lk) * 16 KB, 112 KB at T = 4,
//    Lk = 3, so two blocks fit an SM.
//  * Occupancy by budget, in one build: the kernel is instantiated twice,
//    for two blocks an SM (128 registers a thread) and for one (up to 255),
//    both without spills.  The wrapper (ops/ntt_cuda._fold_blocks) takes
//    the first where the shape's shared memory lets two blocks share an SM
//    and the launch has more blocks than the card has SMs, the second
//    otherwise (few rows, or T + Lk > 7), and a cluster of 6 up to 32 rows
//    (tools/time_fold_predecessor.py times every choice at every shape).
//  * The device functions (transforms, products, Garner step, launch) are
//    in fold_body.cuh, which the pack merge (kernel 4, pack_merge.cu), the
//    trace (kernel 3, trace.cu) and the split (kernel 6, split.cu) share;
//    this file holds the fold's row loop and entry point.
#include "fold_body.cuh"

// rows = A * B ciphertext rows, row r = (item r / B, row r % B of the item).
// x: int32[A, B, T, n] coefficients, or with x_is_ntt int32[P, B, T, n]
// spectra shared by all items; keys: uint32[A, P, digits, T, M, n]; base:
// int32[A, B, C2, Lout, n] or null; out: int32[A, B, C2, Lout, n].  sh.mc
// is not read.  kBlocks: the blocks an SM the instantiation budgets
// registers for (2: 128 a thread; 1: up to 255, for launches whose shared
// memory holds one block an SM anyway, or that have few rows).
template <int kBlocks>
__global__ void __launch_bounds__(FOLD_THREADS, kBlocks)
fold_kernel(const int* __restrict__ x, const uint32_t* __restrict__ keys,
            const int* __restrict__ base, int* out, int rows, int B, int x_is_ntt,
            int digits, FoldShape sh, FheConsts c, FoldTables tb) {
  extern __shared__ uint32_t smem[];
  const int t = threadIdx.x;
  const int rank = (int)cooperative_groups::this_cluster().block_rank();
  const int pi = rank % FHE_P, grp = rank / FHE_P;
  const int c2_per = sh.C2 / (sh.cs / FHE_P);
  const int T = sh.T, Lk = sh.Lk;
  uint32_t* spec = smem;                    // [T][16][256], thread-private words
  uint32_t* R = smem + T * FOLD_N;          // [Lk][n] residues / exchange buffers
  const uint32_t p = prime(c, pi);
  const long long row_polys = (long long)sh.C2 * sh.Lout;
  bool pending = false;   // arrived at "residues read", not yet waited
  for (long long r = blockIdx.x / sh.cs; r < rows; r += gridDim.x / sh.cs) {
    for (int d = 0; d < digits; ++d) {
      // the cluster is done with R, and (d > 0) with writing this row's out
      if (pending) {
        cluster_wait();
        pending = false;
      }
      if (d == 0 && x_is_ntt) {
        const int* xs = x + ((long long)pi * B + r % B) * T * FOLD_N;
        const uint32_t lift = ((0x80000000u + p - 1) / p) * p;
        for (int tt = 0; tt < T; ++tt) {
          const int4* q4 = reinterpret_cast<const int4*>(xs + tt * FOLD_N + (t << 4));
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int4 w = __ldg(q4 + k);
            const int e[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int j = 0; j < 4; ++j)   // any representative, made < 2^32
              spec[(tt * 16 + 4 * k + j) * FOLD_THREADS + t] =
                  e[j] < 0 ? (uint32_t)e[j] + lift : (uint32_t)e[j];
          }
        }
      } else {
        const int* xr = d > 0 ? out + r * row_polys * FOLD_N : x + r * T * FOLD_N;
        uint2 own0[4];   // j = t at stages 0-3
#pragma unroll
        for (int s = 0; s < 4; ++s)
          own0[s] = ldg_pair(tb.fwd + pi * FOLD_N + 4096 - (4096 >> s) + t);
        const uint2 psi_t = ldg_pair(tb.psi_lo + pi * FOLD_THREADS + t);
        for (int tt = 0; tt < T; ++tt) {
          // through L2: a digit d > 0 is what the cluster wrote
          const int* xp = xr + tt * FOLD_N;
          forward<kBlocks>([&](int i) { return __ldcg(xp + i); },
                           spec + tt * 16 * FOLD_THREADS, R, Lk > 1 ? R + FOLD_N : R,
                           own0, psi_t, p, tb, pi);
        }
        __syncthreads();   // the last exchange's reads are done: R is free
      }

      uint2 own2[4];   // j = t at stages 8-11
#pragma unroll
      for (int s = 0; s < 4; ++s)
        own2[s] = ldg_pair(tb.inv + pi * FOLD_N + (256 << s) - 1 + t);
      const uint2 ipsi_t = ldg_pair(tb.ipsi_lo + pi * FOLD_THREADS + t);
      const uint32_t* kp =
          keys + (((r / B) * FHE_P + pi) * digits + d) * T * (long long)sh.M * FOLD_N;
      for (int c2 = grp * c2_per; c2 < (grp + 1) * c2_per; ++c2) {
        for (int lk = 0; lk < Lk; ++lk) {
          uint32_t v[16];
          products(v, spec, kp + (long long)(c2 * Lk + lk) * FOLD_N, T,
                   (long long)sh.M * FOLD_N, p,
                   pi == 0 ? c.mu64[0] : pi == 1 ? c.mu64[1] : c.mu64[2]);
          if (pending) {   // the previous component's residues are read
            cluster_wait();
            pending = false;
          }
          uint32_t* y = R + lk * FOLD_N;
          inverse(v, lk + 1 < Lk ? y + FOLD_N : y, y, own2, ipsi_t, p, tb, pi);
        }
        cluster_arrive();   // every block's residues of component c2 are in
        cluster_wait();
        const int* base_row = base ? base + r * row_polys * FOLD_N : nullptr;
        garner_fold(R, grp, pi, c2,
                    [&](int, int, int, long long at) { return base_row ? base_row[at] : 0; },
                    RowStore{out + r * row_polys * FOLD_N}, sh, c, tb);
        cluster_arrive();   // done reading the cluster's residues
        pending = true;
      }
    }
  }
  if (pending) cluster_wait();   // no block leaves while another reads its R
}

static inline size_t fold_smem(const FoldShape& sh) {
  return (size_t)(sh.T + sh.Lk) * FOLD_N * sizeof(uint32_t);
}

// blocks: 2 or 1, the instantiation (registers a thread) the launch takes.
extern "C" int fhe_fold(const void* x, const void* keys, const void* base,
                        void* out, int rows, int B, int clusters, int x_is_ntt,
                        int digits, int blocks, FoldShape sh, FheConsts c,
                        FoldTables tb, void* stream) {
  return launch_clusters(blocks == 2 ? &fold_kernel<2> : &fold_kernel<1>, clusters, sh.cs,
                         fold_smem(sh), stream, (const int*)x, (const uint32_t*)keys,
                         (const int*)base, (int*)out, rows, B, x_is_ntt, digits, sh, c,
                         tb);
}
