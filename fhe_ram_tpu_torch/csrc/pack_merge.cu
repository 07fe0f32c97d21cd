// Kernel 4: one pack-tree merge level with all glue inside:
//   u, v = A +- X^t B,   out = normalize(u + KS(sigma_g(v))).
//
// Replaces fhe_ram_tpu/ops/ntt_pallas.py: fused_pack_merge_pallas.
//
// Bound on this card: bytes at the read's shapes.  A row pair reads
// 2 * C2 * L * 16 KB and writes C2 * L * 16 KB against 3 * (T + M)
// transforms; at nb = 128, T = 2, M = 6 that is 11.4 us of bytes at an
// H100's 3.35 TB/s against 6.0 us of operations at 67 Tera-op/s.
//
// Design: csrc/fold.cu's body (fold_body.cuh), with the merge's glue in its
// loads.  A row pair is a thread block cluster, one block a prime (or two
// groups of 3 while the pairs are few); 256 threads, 16 coefficients each,
// three radix-16 passes a transform; the residues of a component stay in
// shared memory and the Garner, digit split, limb fold and carry run over
// distributed shared memory; persistent clusters; two instantiations (two
// blocks an SM at 128 registers, one at up to 255), picked by the wrapper
// (ops/ntt_cuda._fold_cs, _fold_blocks).  The row loop is fold_body.cuh's
// merge_rows, which the pack tree (kernel 8, pack_tree.cu) runs too:
//  * Digit poly tt = (mask component tt / Td, limb tt % Td) is sigma_g(v).
//    Each block first stages v = A - X^t B of that poly in a free 16 KB
//    buffer of its shared memory, in natural order (coalesced loads of A
//    and of the rotated B); forward()'s loads then read v[sigma_src(i)]
//    with sigma's sign: for 32 consecutive i the words ginv * i mod n are
//    32 distinct banks, ginv being odd (tests/test_torch_kernels.py
//    emulates the staging and checks it).
//  * The base u + sigma_g(v) at the b component: in the Garner step each
//    block adds A[i] + (X^t B)[i] of its coefficients (coalesced) and, at
//    the b component only, sigma_g(v)[i], gathered from L2 (MergeBase).
//  * Shared memory: the T spectra and max(Lk, 3) residue polys (the staging
//    buffer is the third, free while the digits are transformed):
//    (T + max(Lk, 3)) * 16 KB, 80 KB at T = 2, Lk = 3.  Nothing goes
//    to device memory but the output.
// Its predecessor, fold_row over MergeGlue (fhe_core.cuh) with the residues
// parked in a device scratch, is kept for timing in
// fhe_ram_tpu_torch/tools/pack_merge_predecessor.cu.
#include "fold_body.cuh"

// Kernel 4's walk of merge_rows: row pair r is row r of A, B and out, with
// the launch's key, t and g (what merge_rows is given, returned as given).
struct PairRows {
  __device__ __forceinline__ int item(int r) const { return r; }
  __device__ __forceinline__ void wait(int) const {}
  __device__ __forceinline__ void arrive(int) const {}
  __device__ __forceinline__ int row(int r) const { return r; }
  __device__ __forceinline__ const int* a(int, const int* A) const { return A; }
  __device__ __forceinline__ const int* b(int, const int* B) const { return B; }
  __device__ __forceinline__ int* dst(int, int* out) const { return out; }
  __device__ __forceinline__ const uint32_t* keys(int, const uint32_t* key) const { return key; }
  __device__ __forceinline__ int t_rot(int, int t) const { return t; }
  __device__ __forceinline__ int ginv(int, int g) const { return g; }
};

// A, B, out: int32[nb, C2, L, n]; key: uint32[P, T, M, n] with T = rank *
// Td; t_rot in [0, 2n); ginv = g^-1 mod 2n.  sh: fold.cu's shape argument
// (sign -1, mc not read).  kBlocks as in fold.cu.
template <int kBlocks>
__global__ void __launch_bounds__(FOLD_THREADS, kBlocks)
pack_merge_kernel(const int* __restrict__ A, const int* __restrict__ B,
                  const uint32_t* __restrict__ key, int* out, int nb, int t_rot,
                  int ginv, int Td, FoldShape sh, FheConsts c, FoldTables tb) {
  merge_rows<kBlocks, false>(PairRows{}, A, B, key, out, nb, t_rot, ginv, Td, sh, c, tb);
}

// clusters: persistent clusters (at most nb); blocks: 2 or 1, the
// instantiation (registers a thread) the launch takes.
extern "C" int fhe_pack_merge(const void* A, const void* B, const void* key,
                              void* out, int nb, int clusters, int t_rot, int ginv,
                              int Td, int blocks, FoldShape sh, FheConsts c,
                              FoldTables tb, void* stream) {
  const size_t smem = (size_t)(sh.T + (sh.Lk > 3 ? sh.Lk : 3)) * FOLD_N * sizeof(uint32_t);
  return launch_clusters(blocks == 2 ? &pack_merge_kernel<2> : &pack_merge_kernel<1>,
                         clusters, sh.cs, smem, stream, (const int*)A, (const int*)B,
                         (const uint32_t*)key, (int*)out, nb, t_rot, ginv, Td, sh, c,
                         tb);
}
