// The predecessor of csrc/blind_rotate.cu (kernel 10 before its move onto
// the fold body of csrc/fold_body.cuh), kept for
// tools/time_chain_predecessors.py only: the kernel as it was, fold_row
// over RotateCmuxGlue (csrc/fhe_core.cuh) once a step, radix-2 stages with
// a barrier each, and the M * 3 residue polys of a row parked in a scratch
// buffer in device memory.  Nothing on a serving path builds or launches
// it.
//
// Kernel 10: a whole GLWE blind-rotation CMux chain in one launch: S
// sequential steps rows <- normalize(rows + (X^t_s rows - rows) x GGSW_s),
// one prepared bit GGSW and one static rotation per step, optional digit
// truncation (the top Td limbs of the difference are the digits).
//
// Replaces fhe_ram_tpu/ops/ntt_pallas.py: fused_blind_rotate_pallas.
//
// Bound on this card: operations and latency.  The VM launches it with 1
// row (select_rd: S = 5, T = 4, M = 6; select_store: S = 4, T = 6, M = 8)
// and 6 rows (the pointer conversion: S = 12 and 6, T = 8, M = 10), the
// steps sequential, 3 * (T + M) transforms a row a step.  Bytes: the rows
// in and out once, S * P * T * M * 16 KB of keys.
// Design: a row never needs another row, so the S steps are a loop inside
// the kernel, as in trace.cu, and each row gets a thread block cluster
// (fold_row in fhe_core.cuh; 6 blocks while the rows are few): a launch of
// one row is ONE cluster, 6 SMs of 132 -- the shape a later performance
// change would look at.  X^t is index arithmetic with a sign flip on the
// loads (RotateCmuxGlue): no table, no rotated copy.  A step reads rotated
// positions of the row it replaces, so steps alternate between two buffers
// (`out` and `tmp`), arranged so that the last step writes `out`; rows
// that another block of the cluster wrote are read through L2.
#include "fhe_core.cuh"

struct RotSteps {
  int count;
  int rot[FHE_MAX_STEPS];  // t_s mod 2n
};

// rows: int32[B, C2, L, n]; keys: uint32[S, P, T, M, n]; out, tmp:
// int32[B, C2, L, n]; scratch: uint32[groups, P, M, n].
__global__ void __launch_bounds__(FHE_THREADS)
blind_rotate_predecessor_kernel(const int* __restrict__ rows, const uint32_t* __restrict__ keys,
                    int* out, int* tmp, uint32_t* scratch, int B, RotSteps steps,
                    int Td, FoldShape sh, FheConsts c, FheTables tb) {
  extern __shared__ uint32_t smem[];
  const int n = 1 << c.log_n;
  const int groups = gridDim.x / sh.cs;
  const int group = blockIdx.x / sh.cs;
  const long long row_len = (long long)sh.C2 * sh.Lout * n;
  const long long pstride = (long long)sh.T * sh.M * n;
  uint32_t* scratch_row = scratch + (long long)group * FHE_P * sh.M * n;
  const int S = steps.count;
  ClusterRow blocks(sh.cs);
  for (long long b = group; b < B; b += groups) {
    const int* cur = rows + b * row_len;
    for (int s = 0; s < S; ++s) {
      int* nxt = (((S - 1 - s) & 1) ? tmp : out) + b * row_len;
      RotateCmuxGlue glue;
      glue.ct = cur;
      glue.n = n;
      glue.L = sh.Lout;
      glue.Td = Td;
      glue.rot = steps.rot[s];
      fold_row(blocks, glue, keys + (long long)s * FHE_P * pstride, pstride, sh, c,
               tb, scratch_row, nxt, smem);
      cur = nxt;
    }
  }
}

extern "C" int fhe_blind_rotate_predecessor(const void* rows, const void* keys, void* out,
                                void* tmp, void* scratch, int B, int groups,
                                RotSteps steps, int Td, FoldShape sh, FheConsts c,
                                FheTables tb, void* stream) {
  return fold_launch(blind_rotate_predecessor_kernel, groups, sh, c.log_n, stream,
                     (const int*)rows, (const uint32_t*)keys, (int*)out, (int*)tmp,
                     (uint32_t*)scratch, B, steps, Td, sh, c, tb);
}
