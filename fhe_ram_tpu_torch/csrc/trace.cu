// Kernel 3: the whole normalized-trace chain in one launch: S sequential
// steps ct <- normalize(ct + KS(sigma_g(ct))), sigma_g applied in the
// kernel, one prepared key per step, optional digit truncation.
//
// Replaces fhe_ram_tpu/ops/ntt_pallas.py: fused_trace_pallas.
//
// Bound on this card: operations, and on the read path latency: B is the
// number of subrams (4), the steps are sequential, and each step is
// 3 * (T + M) transforms a row.  Bytes: the row in and out once, and
// S * P * T * M * 16 KB of keys.
// Design: a row never needs another row, so the S steps are a loop inside
// the kernel.  With so few rows each row is given a thread block cluster
// (fold_row in fhe_core.cuh: one prime and half the output polys a block,
// cluster barriers between a step's phases), which keeps 24 SMs busy
// instead of 4.  sigma_g is index arithmetic (sigma_src) on the loads; the
// step's base, ct + sigma_g(b) at the b component, is formed in the fold's
// last phase (TraceStepGlue in fhe_core.cuh).  A step reads permuted
// positions of the row it replaces, so steps alternate between two buffers
// (`out` and `tmp`), arranged so that the last step writes `out`.
#include "fhe_core.cuh"

struct TraceSteps {
  int count;
  int ginv[FHE_MAX_STEPS];  // g_s^-1 mod 2n
};

// ct: int32[B, C2, L, n]; keys: uint32[S, P, T, M, n]; out, tmp: int32[B,
// C2, L, n]; scratch: uint32[B, P, M, n].
__global__ void __launch_bounds__(FHE_THREADS)
trace_kernel(const int* __restrict__ ct, const uint32_t* __restrict__ keys,
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

extern "C" int fhe_trace(const void* ct, const void* keys, void* out, void* tmp,
                         void* scratch, int B, TraceSteps steps, int Td,
                         FoldShape sh, FheConsts c, FheTables tb, void* stream) {
  return fold_launch(trace_kernel, B, sh, c.log_n, stream, (const int*)ct,
                     (const uint32_t*)keys, (int*)out, (int*)tmp,
                     (uint32_t*)scratch, steps, Td, sh, c, tb);
}
