// The predecessor of csrc/trace.cu (kernel 3 before its move onto the fold
// body of csrc/fold_body.cuh), kept for tools/time_trace_split_predecessors.py
// only: one block per row (a cluster of 3 or 6 with few rows,
// ops/ntt_cuda._row_blocks) running fold_row over TraceStepGlue
// (csrc/fhe_core.cuh, which kernels 7, 9, 10 and 11 still run) once a step,
// radix-2 stages with a barrier each, and the M * 3 residue polys of a row
// parked in a scratch buffer in device memory.  Nothing on a serving path
// builds or launches it.
#include "fhe_core.cuh"

struct TraceSteps {
  int count;
  int ginv[FHE_MAX_STEPS];  // g_s^-1 mod 2n
};

// ct: int32[B, C2, L, n]; keys: uint32[S, P, T, M, n]; out, tmp: int32[B,
// C2, L, n]; scratch: uint32[B, P, M, n].
__global__ void __launch_bounds__(FHE_THREADS)
trace_predecessor_kernel(const int* __restrict__ ct, const uint32_t* __restrict__ keys,
                         int* out, int* tmp,
                         uint32_t* scratch, TraceSteps steps, int Td,
                         FoldShape sh, FheConsts c, FheTables tb) {
  extern __shared__ uint32_t smem[];
  const int n = 1 << c.log_n;
  const long long b = blockIdx.x / sh.cs;
  const long long row = b * sh.C2 * sh.Lout * n;
  uint32_t* scratch_row = scratch + b * FHE_P * sh.M * n;
  const long long pstride = (long long)sh.T * sh.M * n;
  const int S = steps.count;
  const int* cur = ct + row;
  ClusterRow blocks(sh.cs);
  for (int s = 0; s < S; ++s) {
    int* nxt = ((S - 1 - s) & 1) ? tmp + row : out + row;
    TraceStepGlue glue;
    glue.ct = cur;
    glue.n = n;
    glue.L = sh.Lout;
    glue.Td = Td;
    glue.rank = sh.C2 - 1;
    glue.ginv = steps.ginv[s];
    fold_row(blocks, glue, keys + (long long)s * FHE_P * pstride, pstride, sh, c, tb,
             scratch_row, nxt, smem);
    cur = nxt;
  }
}

extern "C" int fhe_trace_predecessor(const void* ct, const void* keys, void* out,
                                     void* tmp, void* scratch, int B, TraceSteps steps,
                                     int Td, FoldShape sh, FheConsts c, FheTables tb,
                                     void* stream) {
  return fold_launch(trace_predecessor_kernel, B, sh, c.log_n, stream, (const int*)ct,
                     (const uint32_t*)keys, (int*)out, (int*)tmp,
                     (uint32_t*)scratch, steps, Td, sh, c, tb);
}
