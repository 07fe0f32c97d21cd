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
// u + sigma_g(v) at the b component as the fold's last phase reads it
// (MergeGlue and merge_row in fhe_core.cuh, shared with pack_tree.cu).
#include "fhe_core.cuh"

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
  ClusterRow blocks(sh.cs);
  merge_row<false>(blocks, A + row, B + row, out + row, key, t_rot, ginv, Td, sh,
                   c, tb, scratch + b * FHE_P * sh.M * n, smem);
}

extern "C" int fhe_pack_merge(const void* A, const void* B, const void* key,
                              void* out, void* scratch, int nb, int t_rot,
                              int ginv, int Td, FoldShape sh, FheConsts c,
                              FheTables tb, void* stream) {
  return fold_launch(pack_merge_kernel, nb, sh, c.log_n, stream, (const int*)A,
                     (const int*)B, (const uint32_t*)key, (int*)out,
                     (uint32_t*)scratch, t_rot, ginv, Td, sh, c, tb);
}
