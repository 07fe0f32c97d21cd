// Kernel 6: one level of the slot-extraction split tree, both children
// from one keyswitch:
//   A = KS(sigma_g(x)),  child0 = normalize(x + A),
//   child1 = normalize(X^-t (x - A)) = normalize(X^-t (2x - child0)).
//
// Replaces fhe_ram_tpu/ops/ntt_pallas.py: fused_split_pallas.
//
// Bound on this card: bytes.  A row reads C2 * L polys and writes 2 * C2 *
// L against 3 * (T + M) transforms (33 at T = 3, M = 8): at nb = 128 11.6
// us of bytes at 3.35 TB/s against 8.7 us of operations at 67 Tera-op/s.
//
// Design: csrc/fold.cu's body (fold_body.cuh).  child0 is one trace step
// on the row (trace_step, shared with kernel 3, trace.cu: a thread block
// cluster a row, one block a prime or two groups of 3, the digit poly
// staged in shared memory and gathered at sigma_g's words, the residues in
// shared memory, the Garner step over distributed shared memory; two
// instantiations, persistent clusters).  child1 is written in the same
// Garner step, with no second pass: the carry normalize runs over the
// limbs of one coefficient only, so the thread that has just carried
// child0[c2, ., i] holds x[c2, ., i] (the base's) and forms d_l = +-(2
// x[c2, l, i] - child0[c2, l, i]), carries it from l = L - 1 down to 0 as
// limb_ops.normalize does, and stores it at (i + t_back) mod n of child1,
// the sign flipped where the index wraps XOR t_back >= n (X^-t = X^t_back
// as index arithmetic).  A warp's stores stay contiguous but at the wrap.
// 2x - child0 is at most 3 * 2^16 in magnitude.  Shared memory: the T
// spectra and max(Lk, 3) residue polys, 112 KB at T = 3, Lk = 4: two
// blocks an SM; nothing in device memory but the rows.  x, child0 and
// child1 must not overlap.
// The store of the Garner step is fold_body.cuh's SplitStore, which kernel
// 7 (split_tree.cu) runs at every level of its tree.
// Its predecessor, split_row (fhe_core.cuh: fold_row, a cluster barrier,
// then child1 from x and child0 re-read through L2) with the residues
// parked in a device scratch, is kept for timing in
// fhe_ram_tpu_torch/tools/split_predecessor.cu.
#include "fold_body.cuh"

// Row r of the level.  Members copied from the kernel's parameters; what is
// derived from them is derived at each use.
struct SplitStep {
  const int* x;
  int* out0;
  int* out1;
  const uint32_t* keys;
  long long row_words, key_words;
  int r, t_back, ginv_;
  __device__ __forceinline__ const int* in() const { return x + fresh(r) * row_words; }
  __device__ __forceinline__ int ginv() const { return ginv_; }
  __device__ __forceinline__ const uint32_t* key(int pi) const {
    return keys + (long long)pi * key_words;
  }
  __device__ __forceinline__ SplitStore store() const {
    const long long row = fresh(r) * row_words;
    return SplitStore{x + row, out0 + row, out1 + row, t_back};
  }
};

// x, out0, out1: int32[nb, C2, L, n]; key: uint32[P, T, M, n] with T = rank
// * L.  t_back = 2n - t in [0, 2n): X^-t = X^t_back; ginv = g^-1 mod 2n.
// sh: fold.cu's shape argument (sign -1, mc not read).  kBlocks as in
// fold.cu.
template <int kBlocks>
__global__ void __launch_bounds__(FOLD_THREADS, kBlocks)
split_kernel(const int* __restrict__ x, const uint32_t* __restrict__ key, int* out0,
             int* out1, int nb, int t_back, int ginv, FoldShape sh, FheConsts c,
             FoldTables tb) {
  extern __shared__ uint32_t smem[];
  const long long row_words = (long long)sh.C2 * sh.Lout * FOLD_N;
  const long long key_words = (long long)sh.T * sh.M * FOLD_N;
  bool pending = false;   // arrived at "residues read", not yet waited
  for (int r = blockIdx.x / sh.cs; r < nb; r += gridDim.x / sh.cs)
    trace_step<kBlocks>(
        SplitStep{x, out0, out1, key, row_words, key_words, r, t_back, ginv}, sh.Lout,
        pending, smem, sh, c, tb);
  if (pending) cluster_wait();   // no block leaves while another reads its R
}

// clusters: persistent clusters (at most nb); blocks: 2 or 1, the
// instantiation (registers a thread) the launch takes.
extern "C" int fhe_split(const void* x, const void* key, void* out0, void* out1, int nb,
                         int clusters, int t_back, int ginv, int blocks, FoldShape sh,
                         FheConsts c, FoldTables tb, void* stream) {
  const size_t smem = (size_t)(sh.T + (sh.Lk > 3 ? sh.Lk : 3)) * FOLD_N * sizeof(uint32_t);
  return launch_clusters(blocks == 2 ? &split_kernel<2> : &split_kernel<1>, clusters,
                         sh.cs, smem, stream, (const int*)x, (const uint32_t*)key,
                         (int*)out0, (int*)out1, nb, t_back, ginv, sh, c, tb);
}
