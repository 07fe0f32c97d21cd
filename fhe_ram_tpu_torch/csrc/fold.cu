// Kernel 2: the fused external product / keyswitch core.  Forward NTT of
// T gadget-digit polys, product with prepared key rows summed over T,
// inverse NTT, exact 3-prime Garner CRT, fold into base-2^17 limbs,
// optional base + sign * fold, carry normalize; `digits > 1` chains a
// CMux digit chain (each digit's normalized output is the next digit's
// input).
//
// Replaces fhe_ram_tpu/ops/ntt_pallas.py: fused_external_fold_pallas
// (spectral input, x_is_ntt, is not taken here).
//
// Bound on this card: operations.  A row reads T * 16 KB of digits and
// writes C2 * Lout * 16 KB; the key rows (P * T * M * 16 KB) are shared by
// all rows and stay in L2.  Against that stand 3 * (T + M) transforms a
// row (30 at T = 4, M = 6), ~25k modular butterflies each.
// Design: one block per ciphertext row, looping over primes and output
// polys (fold_row in fhe_core.cuh); with few rows (level 1: B = 4) a
// thread block cluster per row instead.  Shared memory holds one prime's T
// spectra and a few accumulators, (T + mc) * 16 KB, so the shape does not
// depend on P * T spectra fitting on chip (P * T * 16 KB is 192 KB at
// T = 4 and 288 KB at T = 6, against 227 KB a block).  The M * 3 residue
// polys of a row go to a scratch buffer in device memory that the wrapper
// allocates: B * 3 * M * 16 KB, 72 MB at B = 256, M = 6; each is written
// once and read once.
#include "fhe_core.cuh"

struct FoldGlue {
  const int* x;     // [T, n] digit polys of this row
  const int* base_ptr;  // [C2, Lout, n] of this row, or nullptr
  int n, Lout;
  // through L2: for digit d > 0 another block of the cluster wrote it
  __device__ __forceinline__ int digit(int t, int i) const { return __ldcg(x + t * n + i); }
  __device__ __forceinline__ int base(int c2, int l, int i) const {
    return base_ptr ? base_ptr[(c2 * Lout + l) * n + i] : 0;
  }
};

// x: int32[B, T, n]; keys: uint32[P, digits, T, M, n]; base: int32[B, C2,
// Lout, n] or null; out: int32[B, C2, Lout, n]; scratch: uint32[B, P, M, n].
__global__ void __launch_bounds__(FHE_THREADS)
fold_kernel(const int* __restrict__ x, const uint32_t* __restrict__ keys,
            const int* __restrict__ base, int* out,
            uint32_t* scratch, int digits, FoldShape sh,
            FheConsts c, FheTables tb) {
  extern __shared__ uint32_t smem[];
  const int n = 1 << c.log_n;
  const long long b = blockIdx.x / sh.cs;
  int* out_row = out + b * sh.C2 * sh.Lout * n;
  uint32_t* scratch_row = scratch + b * FHE_P * sh.M * n;
  const long long dstride = (long long)sh.T * sh.M * n;
  for (int d = 0; d < digits; ++d) {
    FoldGlue glue;
    // digit d > 0 decomposes the previous digit's output (T == C2 * Lout);
    // fold_row has read all of it before its last phase overwrites it
    glue.x = d == 0 ? x + b * sh.T * n : out_row;
    glue.base_ptr = base ? base + b * sh.C2 * sh.Lout * n : nullptr;
    glue.n = n;
    glue.Lout = sh.Lout;
    fold_row(glue, keys + d * dstride, digits * dstride, sh, c, tb,
             scratch_row, out_row, smem);
  }
}

extern "C" int fhe_fold(const void* x, const void* keys, const void* base,
                        void* out, void* scratch, int B, int digits,
                        FoldShape sh, FheConsts c, FheTables tb, void* stream) {
  return fold_launch(fold_kernel, B, sh, c.log_n, stream, (const int*)x,
                     (const uint32_t*)keys, (const int*)base, (int*)out,
                     (uint32_t*)scratch, digits, sh, c, tb);
}
