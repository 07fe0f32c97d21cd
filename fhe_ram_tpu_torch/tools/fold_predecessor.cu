// The predecessor of csrc/fold.cu (kernels 2 and 5 before their redesign
// for Hopper), kept for tools/time_fold_predecessor.py only: one block per
// ciphertext row (a cluster of 3 or 6 with few rows) looping over primes
// and output polys (fold_row of csrc/fhe_core.cuh), the M * 3 residue
// polys of a row parked in a scratch buffer in device memory.  The tool builds it twice, with the
// radix-2 body and with -DFHE_NTT_TWO_PASS (the two-pass 64 x 64 body), and
// times both against the fold kernel on the same inputs.  Nothing on a
// serving path builds or launches it.
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
fold_predecessor_kernel(const int* __restrict__ x,
                        const uint32_t* __restrict__ keys,
                        const int* __restrict__ base, int* out, uint32_t* scratch,
                        int rows, int B, int x_is_ntt, int digits, FoldShape sh,
                        FheConsts c, FheTables tb) {
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

extern "C" int fhe_fold_predecessor(const void* x, const void* keys, const void* base,
                                    void* out, void* scratch, int rows, int B,
                                    int groups, int x_is_ntt, int digits,
                                    FoldShape sh, FheConsts c, FheTables tb,
                                    void* stream) {
  return fold_launch(fold_predecessor_kernel, groups, sh, c.log_n, stream, (const int*)x,
                     (const uint32_t*)keys, (const int*)base, (int*)out,
                     (uint32_t*)scratch, rows, B, x_is_ntt, digits, sh, c, tb);
}
