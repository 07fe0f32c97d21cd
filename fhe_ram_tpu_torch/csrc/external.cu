// Kernel 12: the external product core without a fold.  Per prime: the
// forward transform of a row's T gadget-digit polys, the products with the
// prepared key rows summed over T, one inverse transform per output poly;
// out: the centered per-prime residues of the convolutions.  No Garner
// step, no carry: the caller folds them (ops.crt.crt_fold).
//
// Replaces fhe_ram_tpu/ops/ntt_pallas.py: fused_external_pallas, with its
// body _fused_kernel_factory (both bodies: built once with the radix-2
// transform and once with -DFHE_NTT_TWO_PASS, the two-pass 64 x 64 body of
// the FHERAM_MXU=0 `kernel`).
//
// Bound on this card: operations.  A row of one prime reads T * 16 KB of
// digits and writes M * 16 KB of residues; the key rows (P * T * M * 16 KB)
// are shared by all rows and stay in L2.  Against that stand T + M
// transforms a row and prime, ~25k modular butterflies each.
// Design: fold_row's first half (prime_residues in fhe_core.cuh) with a
// store that centers each residue into the output, one block per (row,
// prime): the three primes of a row are independent here, since nothing
// combines them.  Shared memory: (T + mc) * 16 KB, as the fold's.
#include "fhe_core.cuh"

struct DigitGlue : CoefficientDigits {
  const int* x;  // [T, n] digit polys of this row
  int n;
  __device__ __forceinline__ int digit(int t, int i) const { return x[t * n + i]; }
};

// x: int32[B, T, n] coefficients; keys: uint32[P, T, M, n]; out: int32[P, B,
// M, n] centered residues.  Grid (B, P).
__global__ void __launch_bounds__(FHE_THREADS)
external_kernel(const int* __restrict__ x, const uint32_t* __restrict__ keys,
                int* __restrict__ out, int B, FoldShape sh, FheConsts c,
                FheTables tb) {
  extern __shared__ uint32_t smem[];
  const int n = 1 << c.log_n;
  const int b = blockIdx.x, pi = blockIdx.y;
  const uint32_t p = c.p[pi];
  DigitGlue glue;
  glue.x = x + (long long)b * sh.T * n;
  glue.n = n;
  int* dst = out + ((long long)pi * B + b) * sh.M * n;
  prime_residues(glue, pi, keys + (long long)pi * sh.T * sh.M * n, 0, sh.M, sh, c,
                 tb, smem, [&](int m, int i, uint32_t r) {
                   dst[(long long)m * n + i] = center(r, p);
                 });
}

extern "C" int fhe_external(const void* x, const void* keys, void* out, int B,
                            FoldShape sh, FheConsts c, FheTables tb, void* stream) {
  const size_t smem = (size_t)(sh.T + sh.mc) * sizeof(uint32_t) << c.log_n;
  cudaError_t err = cudaFuncSetAttribute(
      external_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  external_kernel<<<dim3(B, FHE_P), FHE_THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)x, (const uint32_t*)keys, (int*)out, B, sh, c, tb);
  return (int)cudaGetLastError();
}
