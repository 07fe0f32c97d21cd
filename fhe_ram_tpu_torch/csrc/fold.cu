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
// x[P, B, T, n] is shared by all items, the batched read's level 0).
//
// Bound on this card: operations.  A row reads T * 16 KB of digits and
// writes C2 * Lout * 16 KB; the key rows (P * T * M * 16 KB an item) are
// shared by an item's rows and stay in L2.  Against that stand 3 * (T + M)
// transforms a row (30 at T = 4, M = 6; 3 * M with spectral input), ~25k
// modular butterflies each.
// Design: one block per ciphertext row, looping over primes and output
// polys (fold_row in fhe_core.cuh); with few rows (level 1: B = 4) a
// thread block cluster per row instead.  Shared memory holds one prime's T
// spectra and a few accumulators, (T + mc) * 16 KB, so the shape does not
// depend on P * T spectra fitting on chip (P * T * 16 KB is 192 KB at
// T = 4 and 288 KB at T = 6, against 227 KB a block).  The M * 3 residue
// polys of a row go to a scratch buffer in device memory that the wrapper
// allocates, written once and read once.  The grid is `groups` blocks (or
// clusters); group g walks rows g, g + groups, ...  Up to the wrapper's cap
// groups = rows, one row a group; a batched launch of A * 256 rows takes
// fewer groups than rows, so the scratch (groups * 3 * M * 16 KB) does not
// grow with the batch.  Row offsets are 64-bit: A * B * C2 * Lout * n
// passes 2^31 at A = 64.
// Built twice, once a transform body of fhe_core.cuh: radix-2, and with
// -DFHE_NTT_TWO_PASS the two-pass 64 x 64 body, the counterpart of the
// FHERAM_MXU=0 branches of _fold_kernel_factory (the same integers).
#include "fhe_core.cuh"

struct FoldGlue {
  const int* x;         // [T, n] digit polys of this row (coefficients), or
  const int* xs;        // spectra of this row: prime pi at xs + pi * xs_pstride
  long long xs_pstride;
  const int* base_ptr;  // [C2, Lout, n] of this row, or nullptr
  int n, Lout;
  __device__ __forceinline__ bool spectral() const { return xs != nullptr; }
  __device__ __forceinline__ int spectrum(int pi, int t, int i) const {
    return xs[pi * xs_pstride + t * n + i];
  }
  // through L2: for digit d > 0 another block of the cluster wrote it
  __device__ __forceinline__ int digit(int t, int i) const { return __ldcg(x + t * n + i); }
  __device__ __forceinline__ int base(int c2, int l, int i) const {
    return base_ptr ? base_ptr[(c2 * Lout + l) * n + i] : 0;
  }
};

// rows = A * B ciphertext rows, row r = (item r / B, row r % B of the item).
// x: int32[A, B, T, n] coefficients, or with x_is_ntt int32[P, B, T, n]
// spectra shared by all items; keys: uint32[A, P, digits, T, M, n]; base:
// int32[A, B, C2, Lout, n] or null; out: int32[A, B, C2, Lout, n];
// scratch: uint32[groups, P, M, n].
__global__ void __launch_bounds__(FHE_THREADS)
fold_kernel(const int* __restrict__ x, const uint32_t* __restrict__ keys,
            const int* __restrict__ base, int* out,
            uint32_t* scratch, int rows, int B, int x_is_ntt, int digits,
            FoldShape sh, FheConsts c, FheTables tb) {
  extern __shared__ uint32_t smem[];
  const int n = 1 << c.log_n;
  const int groups = gridDim.x / sh.cs;
  const int group = blockIdx.x / sh.cs;
  const long long row_polys = (long long)sh.C2 * sh.Lout;
  uint32_t* scratch_row = scratch + (long long)group * FHE_P * sh.M * n;
  const long long dstride = (long long)sh.T * sh.M * n;
  const long long astride = FHE_P * digits * dstride;
  ClusterRow row(sh.cs);
  for (long long r = group; r < rows; r += groups) {
    const long long a = r / B, b = r % B;
    int* out_row = out + r * row_polys * n;
    for (int d = 0; d < digits; ++d) {
      FoldGlue glue;
      // digit d > 0 decomposes the previous digit's output (T == C2 * Lout);
      // fold_row has read all of it before its last phase overwrites it
      glue.x = d > 0 ? out_row : x_is_ntt ? nullptr : x + r * sh.T * n;
      glue.xs = d == 0 && x_is_ntt ? x + b * sh.T * n : nullptr;
      glue.xs_pstride = (long long)B * sh.T * n;
      glue.base_ptr = base ? base + r * row_polys * n : nullptr;
      glue.n = n;
      glue.Lout = sh.Lout;
      fold_row(row, glue, keys + a * astride + d * dstride, digits * dstride, sh, c,
               tb, scratch_row, out_row, smem);
    }
  }
}

extern "C" int fhe_fold(const void* x, const void* keys, const void* base,
                        void* out, void* scratch, int rows, int B, int groups,
                        int x_is_ntt, int digits, FoldShape sh, FheConsts c,
                        FheTables tb, void* stream) {
  return fold_launch(fold_kernel, groups, sh, c.log_n, stream, (const int*)x,
                     (const uint32_t*)keys, (const int*)base, (int*)out,
                     (uint32_t*)scratch, rows, B, x_is_ntt, digits, sh, c, tb);
}
