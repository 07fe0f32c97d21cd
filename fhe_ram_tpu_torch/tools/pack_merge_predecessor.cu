// The predecessor of csrc/pack_merge.cu (kernel 4 before its move onto the
// fold body of csrc/fold_body.cuh), kept for
// tools/time_merge_ring_predecessors.py only: one block per row pair (a
// cluster of 3 or 6 with few pairs, ops/ntt_cuda._row_blocks) running
// fold_row over MergeGlue (csrc/fhe_core.cuh, which kernel 8 still runs),
// radix-2 stages with a barrier each, and the M * 3 residue polys of a
// pair parked in a scratch buffer in device memory.  Nothing on a serving
// path builds or launches it.
#include "fhe_core.cuh"

// A, B, out: int32[nb, C2, L, n]; key: uint32[P, T, M, n]; scratch:
// uint32[nb, P, M, n].  t_rot in [0, 2n); ginv = g^-1 mod 2n.
__global__ void __launch_bounds__(FHE_THREADS)
pack_merge_predecessor_kernel(const int* __restrict__ A, const int* __restrict__ B,
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

extern "C" int fhe_pack_merge_predecessor(const void* A, const void* B, const void* key,
                                          void* out, void* scratch, int nb, int t_rot,
                                          int ginv, int Td, FoldShape sh, FheConsts c,
                                          FheTables tb, void* stream) {
  return fold_launch(pack_merge_predecessor_kernel, nb, sh, c.log_n, stream, (const int*)A,
                     (const int*)B, (const uint32_t*)key, (int*)out,
                     (uint32_t*)scratch, t_rot, ginv, Td, sh, c, tb);
}
