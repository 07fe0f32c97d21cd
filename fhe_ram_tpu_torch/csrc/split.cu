// Kernel 6: one level of the slot-extraction split tree, both children
// from one keyswitch:
//   A = KS(sigma_g(x)),  child0 = normalize(x + A),
//   child1 = normalize(X^-t (x - A)) = normalize(X^-t (2x - child0)).
//
// Replaces fhe_ram_tpu/ops/ntt_pallas.py: fused_split_pallas.
//
// Bound on this card: operations, and at the write's shapes latency: the
// six levels of one extraction have 4, 8, ..., 128 rows for 132 SMs, and a
// row is 3 * (T + M) transforms (33 at T = 3, M = 8) against 6 polys read
// and 12 written.
// Design: child0 is one trace step on the row (TraceStepGlue and fold_row
// in fhe_core.cuh: sigma_g as index arithmetic on the loads, the base
// x + sigma_g(b) formed in the fold's last phase), with a thread block
// cluster a row while the rows are few (the wrapper chooses by nb).
// child1 reads child0 at rotated positions, which another block of the
// cluster may have written: a cluster barrier after the fold, then reads
// through L2.  The rotation X^-t is index arithmetic with a sign flip on
// the wrap; 2x - child0 is at most 3 * 2^16 in magnitude and is carried
// into balanced limbs coefficient by coefficient, the coefficients dealt
// over the blocks of the cluster as in the fold's last phase (split_row in
// fhe_core.cuh, shared with split_tree.cu).
#include "fhe_core.cuh"

// ct, out0, out1: int32[nb, C2, L, n]; key: uint32[P, T, M, n] with
// T = rank * L; scratch: uint32[nb, P, M, n].  t_back = 2n - t in [0, 2n):
// X^-t = X^t_back; ginv = g^-1 mod 2n.
__global__ void __launch_bounds__(FHE_THREADS)
split_kernel(const int* __restrict__ ct, const uint32_t* __restrict__ key,
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

extern "C" int fhe_split(const void* ct, const void* key, void* out0,
                         void* out1, void* scratch, int nb, int t_back,
                         int ginv, FoldShape sh, FheConsts c, FheTables tb,
                         void* stream) {
  return fold_launch(split_kernel, nb, sh, c.log_n, stream, (const int*)ct,
                     (const uint32_t*)key, (int*)out0, (int*)out1,
                     (uint32_t*)scratch, t_back, ginv, sh, c, tb);
}
