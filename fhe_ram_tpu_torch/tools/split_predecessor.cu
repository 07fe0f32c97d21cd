// The predecessor of csrc/split.cu (kernel 6 before its move onto the fold
// body of csrc/fold_body.cuh), kept for tools/time_trace_split_predecessors.py
// only: one block per row (a cluster of 3 or 6 with few rows,
// ops/ntt_cuda._row_blocks) running split_row (csrc/fhe_core.cuh, which
// kernel 7, split_tree.cu, still runs): fold_row over TraceStepGlue with
// radix-2 stages, a barrier each, and the M * 3 residue polys of a row
// parked in a scratch buffer in device memory; then a cluster barrier and
// child1 from x and child0 re-read through L2.  Nothing on a serving path
// builds or launches it.
#include "fhe_core.cuh"

// ct, out0, out1: int32[nb, C2, L, n]; key: uint32[P, T, M, n] with
// T = rank * L; scratch: uint32[nb, P, M, n].  t_back = 2n - t in [0, 2n):
// X^-t = X^t_back; ginv = g^-1 mod 2n.
__global__ void __launch_bounds__(FHE_THREADS)
split_predecessor_kernel(const int* __restrict__ ct, const uint32_t* __restrict__ key,
                         int* out0, int* __restrict__ out1, uint32_t* scratch, int t_back,
                         int ginv, FoldShape sh, FheConsts c, FheTables tb) {
  extern __shared__ uint32_t smem[];
  const int n = 1 << c.log_n;
  const long long b = blockIdx.x / sh.cs;
  const long long row = b * sh.C2 * sh.Lout * n;
  ClusterRow blocks(sh.cs);
  split_row(blocks, ct + row, out0 + row, out1 + row, key, t_back, ginv, sh, c,
            tb, scratch + b * FHE_P * sh.M * n, smem);
}

extern "C" int fhe_split_predecessor(const void* ct, const void* key, void* out0,
                                     void* out1, void* scratch, int nb, int t_back,
                                     int ginv, FoldShape sh, FheConsts c, FheTables tb,
                                     void* stream) {
  return fold_launch(split_predecessor_kernel, nb, sh, c.log_n, stream, (const int*)ct,
                     (const uint32_t*)key, (int*)out0, (int*)out1,
                     (uint32_t*)scratch, t_back, ginv, sh, c, tb);
}
