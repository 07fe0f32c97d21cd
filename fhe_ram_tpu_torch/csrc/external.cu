// Kernel 12: the external product core without a fold.  Per prime: the
// forward transform of a row's T gadget-digit polys, the products with the
// prepared key rows summed over T, one inverse transform per output poly;
// out: the centered per-prime residues of the convolutions.  No Garner
// step, no carry: the caller folds them (ops.crt.crt_fold).
//
// Replaces fhe_ram_tpu/ops/ntt_pallas.py: fused_external_pallas, with its
// body _fused_kernel_factory (both of the JAX package's bodies: the MXU one
// and the FHERAM_MXU=0 `kernel` compute the same integers).
//
// Bound on this card: bytes.  A row reads T * 16 KB of digits and writes
// P * M * 16 KB of residues (75.5 MB of the 93.5 MB at B = 256, T = 4,
// M = 6); the key rows (P * T * M * 16 KB) are shared by all rows and stay
// in L2.  Against that stand P * (T + M) transforms a row, ~25k modular
// butterflies each: at 67 Tera-op/s they take less than the bytes.
//
// Design: the fold body's device functions (fold_body.cuh), built once; it
// serves the radix-2 and the two-pass contexts with the same integers, as
// kernels 1, 2 and 5 do.
//  * A unit is one (row, prime), or a part of its M output polys: nothing
//    combines the primes, so a unit needs no cluster and no Garner step.
//    Persistent blocks walk the units u, u + gridDim.x, ...; consecutive
//    units share a row, so its digit loads meet in L2.  With few rows
//    (fewer units than SMs) the wrapper cuts each (row, prime) into
//    `split` parts of its output polys, as the fold's cluster of 6 shares
//    a row's components: each part redoes the T forward transforms.
//  * The T digit polys go through `forward` (three radix-16 passes in
//    registers, two exchanges) into shared-memory spectra, each thread's
//    own 16 words; then per output poly `products` (T products summed in
//    64 bits, one reduction) and `inverse`, which leaves the canonical
//    residues in the second exchange buffer in swizzled order.
//  * The store is what the kernel is bound by: each thread reads back its
//    16 consecutive coefficients (layout L2; under swz a warp's 32 reads
//    of one register hit 32 banks), centers them and writes them as four
//    16-byte stores, a warp 2 KB back to back.
//  * Shared memory: the T spectra and two exchange buffers, (T + 2) * 16
//    KB (96 KB at T = 4), so two blocks fit an SM.  Two instantiations, as
//    the fold's: two blocks an SM at 128 registers, one at up to 255; the
//    wrapper (ops/ntt_cuda._external_launch) takes the first where two
//    blocks fit an SM and there are more units than SMs.
// Its predecessor (fhe_core.cuh's prime_residues, one block of 512
// threads a (row, prime), built once a transform body) is kept for timing
// in fhe_ram_tpu_torch/tools/external_predecessor.cu.
#include "fold_body.cuh"

// x: int32[B, T, n] coefficients; keys: uint32[P, T, M, n] spectra (kernel
// 1's order, canonical), 16-byte aligned; out: int32[P, B, M, n] centered
// residues, natural order.  Unit u < B * P * split: part u % split of the
// output polys of prime (u / split) % P of row u / (split * P).  kBlocks:
// the blocks an SM the instantiation budgets registers for.
template <int kBlocks>
__global__ void __launch_bounds__(FOLD_THREADS, kBlocks)
external_kernel(const int* __restrict__ x, const uint32_t* __restrict__ keys,
                int* __restrict__ out, int B, int T, int M, int split, FheConsts c,
                FoldTables tb) {
  extern __shared__ uint32_t smem[];
  const int t = threadIdx.x;
  uint32_t* spec = smem;                    // [T][16][256], thread-private words
  uint32_t* X = smem + T * FOLD_N;          // the two exchange buffers
  uint32_t* Y = X + FOLD_N;
  const int units = B * FHE_P * split;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int part = u % split, pi = (u / split) % FHE_P, b = u / (split * FHE_P);
    const uint32_t p = prime(c, pi);
    uint2 own0[4];   // j = t at stages 0-3
#pragma unroll
    for (int s = 0; s < 4; ++s)
      own0[s] = ldg_pair(tb.fwd + pi * FOLD_N + 4096 - (4096 >> s) + t);
    const uint2 psi_t = ldg_pair(tb.psi_lo + pi * FOLD_THREADS + t);
    for (int tt = 0; tt < T; ++tt) {
      // every thread is past the previous unit's store reads of Y: they
      // precede the first exchange's barrier
      const int* xp = x + ((long long)b * T + tt) * FOLD_N;
      forward<kBlocks>([&](int i) { return __ldg(xp + i); }, spec + tt * 16 * FOLD_THREADS,
                       X, Y, own0, psi_t, p, tb, pi);
    }

    uint2 own2[4];   // j = t at stages 8-11
#pragma unroll
    for (int s = 0; s < 4; ++s)
      own2[s] = ldg_pair(tb.inv + pi * FOLD_N + (256 << s) - 1 + t);
    const uint2 ipsi_t = ldg_pair(tb.ipsi_lo + pi * FOLD_THREADS + t);
    const int m_hi = (part + 1) * M / split;
    for (int m = part * M / split; m < m_hi; ++m) {
      uint32_t v[16];
      products(v, spec, keys + ((long long)pi * T * M + m) * FOLD_N, T,
               (long long)M * FOLD_N, p,
               pi == 0 ? c.mu64[0] : pi == 1 ? c.mu64[1] : c.mu64[2]);
      // X's last reads (the previous inverse's first exchange) and Y's (the
      // previous store) are behind a barrier of the previous inverse / of
      // this inverse's first exchange
      inverse(v, X, Y, own2, ipsi_t, p, tb, pi);
      __syncthreads();   // every thread's residues are in Y
      const int a = swz_base<2>();
      int4* dst = reinterpret_cast<int4*>(
          out + (((long long)pi * B + b) * M + m) * FOLD_N + (t << 4));
#pragma unroll
      for (int k = 0; k < 4; ++k)
        dst[k] = make_int4(center(Y[a ^ swz(lay_r<2>(4 * k))], p),
                           center(Y[a ^ swz(lay_r<2>(4 * k + 1))], p),
                           center(Y[a ^ swz(lay_r<2>(4 * k + 2))], p),
                           center(Y[a ^ swz(lay_r<2>(4 * k + 3))], p));
    }
  }
}

static inline size_t external_smem(int T) { return (size_t)(T + 2) * FOLD_N * sizeof(uint32_t); }

// blocks_total persistent blocks; blocks: 2 or 1, the instantiation
// (registers a thread) the launch takes.
extern "C" int fhe_external(const void* x, const void* keys, void* out, int B, int T, int M,
                            int split, int blocks_total, int blocks, FheConsts c,
                            FoldTables tb, void* stream) {
  auto kernel = blocks == 2 ? &external_kernel<2> : &external_kernel<1>;
  const size_t smem = external_smem(T);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks_total, FOLD_THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)x, (const uint32_t*)keys, (int*)out, B, T, M, split, c, tb);
  return (int)cudaGetLastError();
}
