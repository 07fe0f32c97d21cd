// Kernel 4: one pack-tree merge level with all glue inside:
//   u, v = A +- X^t B,   out = normalize(u + KS(sigma_g(v))).
//
// Replaces fhe_ram_tpu/ops/ntt_pallas.py: fused_pack_merge_pallas.
//
// Bound on this card: operations, 3 * (T + M) transforms a row pair
// against 2 * C2 * L * 16 KB read and C2 * L * 16 KB written; the deep
// levels (nb = 8, 4) have fewer row pairs than the card has SMs.
// Design: one block per row pair at the wide levels, a thread block cluster
// per row pair at the deep ones (fold_row in fhe_core.cuh; the wrapper
// chooses by nb).  The rotation X^t and sigma_g are index
// arithmetic on the loads (rot_at, sigma_src), so u, v and sigma_g(v) are
// never written anywhere: the digit polys sigma_g(v)[mask, l < Td] are
// formed as they are lifted into shared memory, and the base
// u + sigma_g(v) at the b component as the fold's last phase reads it.
#include "fhe_core.cuh"

struct MergeGlue {
  const int* A;  // [C2, L, n] of this pair
  const int* B;
  int n, L, Td, rank, ginv, t_rot;
  __device__ __forceinline__ int xb(int c, int l, int j) const {
    return rot_at(B + (c * L + l) * n, j, t_rot, n);
  }
  __device__ __forceinline__ int sigma_v(int c, int l, int i) const {
    bool neg;
    const int src = sigma_src(i, ginv, n, neg);
    const int v = A[(c * L + l) * n + src] - xb(c, l, src);
    return neg ? -v : v;
  }
  __device__ __forceinline__ int digit(int t, int i) const {
    return sigma_v(t / Td, t % Td, i);
  }
  __device__ __forceinline__ int base(int c2, int l, int i) const {
    int b = A[(c2 * L + l) * n + i] + xb(c2, l, i);
    if (c2 == rank) b += sigma_v(rank, l, i);
    return b;
  }
};

// A, B, out: int32[nb, C2, L, n]; key: uint32[P, T, M, n]; scratch:
// uint32[nb, P, M, n].  t_rot in [0, 2n); ginv = g^-1 mod 2n.
__global__ void __launch_bounds__(FHE_THREADS)
pack_merge_kernel(const int* __restrict__ A, const int* __restrict__ B,
                  const uint32_t* __restrict__ key, int* out,
                  uint32_t* scratch, int t_rot, int ginv, int Td,
                  FoldShape sh, FheConsts c, FheTables tb) {
  extern __shared__ uint32_t smem[];
  const int n = 1 << c.log_n;
  const long long b = blockIdx.x / sh.cs;
  const long long row = b * sh.C2 * sh.Lout * n;
  MergeGlue glue;
  glue.A = A + row;
  glue.B = B + row;
  glue.n = n;
  glue.L = sh.Lout;
  glue.Td = Td;
  glue.rank = sh.C2 - 1;
  glue.ginv = ginv;
  glue.t_rot = t_rot;
  fold_row(glue, key, (long long)sh.T * sh.M * n, sh, c, tb,
           scratch + b * FHE_P * sh.M * n, out + row, smem);
}

extern "C" int fhe_pack_merge(const void* A, const void* B, const void* key,
                              void* out, void* scratch, int nb, int t_rot,
                              int ginv, int Td, FoldShape sh, FheConsts c,
                              FheTables tb, void* stream) {
  return fold_launch(pack_merge_kernel, nb, sh, c.log_n, stream, (const int*)A,
                     (const int*)B, (const uint32_t*)key, (int*)out,
                     (uint32_t*)scratch, t_rot, ginv, Td, sh, c, tb);
}
