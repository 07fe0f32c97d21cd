// Kernel 7: all S levels of the slot-extraction split tree in one launch.
// Level l splits each of the nb * 2^l nodes into two (child0 =
// normalize(x + KS(sigma_g x)), child1 = normalize(X^-t (2x - child0)),
// g = g_l, t = 2^l); the children are kept in the concat layout [child0s |
// child1s], so after the last level node j of a root is the leaf for slot
// j.  The integers are those of S launches of split.cu.
//
// Replaces fhe_ram_tpu/ops/ntt_pallas.py: fused_split_tree_pallas.
//
// Bound on this card: operations, and while the rows are few latency: a
// single write extracts 4 roots, so its levels have 4, 8, ..., 128 rows for
// 132 SMs, and a launch of its own costs each of them ~0.05 ms whatever its
// rows.  Bytes: nb rows in, nb * 2^S out, S keys.
//
// Design: csrc/fold.cu's body (fold_body.cuh).  Every row of a level runs
// split.cu's row step on a thread block cluster: child0 is one trace_step
// on the row (one block a prime, or two groups of 3 that share the output
// components; the digit poly staged in shared memory and gathered at
// sigma_g's words, the residues in shared memory, the Garner step over
// distributed shared memory), and child1 is carried and stored at its
// rotated word in the same Garner step (SplitStore).  ONE launch,
// cooperative and clustered: persistent clusters walk each level's rows r,
// r + clusters, ..., and a grid-wide OpBarrier (a device-memory counter,
// release / acquire, a trap after 2^24 polls) separates the levels, so
// every cluster must be resident: the wrapper sizes the grid by
// cudaOccupancyMaxActiveClusters.  A cluster's size cannot change between
// levels (a single write's levels have 4..128 rows, a batched RMW's of 16
// 64..2048), so the wrapper picks one for the whole tree from its shape
// (ops/ntt_cuda._tree_layout).  Row r of level l is node j = r mod
// 2^l of root b = r / 2^l; its children land at c0 = dst + (b * dst_nodes
// + j) * row and c1 = c0 + 2^l * row.  A level reads rotated positions of
// rows the next would overwrite, so levels alternate between two buffers,
// `out` and `tmp`, arranged so that the last level writes `out`; x, c0 and
// c1 never overlap; what an earlier level wrote is read through L2.
// Offsets are 64-bit: `out` at nb = 64, S = 6 is 384 MiB.  Shared memory:
// the T spectra and max(Lk, 3) residue polys, 112 KB at T = 3, Lk = 4: two
// blocks an SM; nothing in device memory but the rows and one counter.
// Its predecessor, split_row (fhe_core.cuh) over GridRow groups whose size
// followed each level's rows, with the residues parked in a device
// scratch, is kept for timing in
// fhe_ram_tpu_torch/tools/split_tree_predecessor.cu.
#include "fold_body.cuh"

struct SplitLevels {
  int count;                 // levels S
  int ginv[FHE_MAX_STEPS];   // g_l^-1 mod 2n
  int t_back[FHE_MAX_STEPS]; // 2n - 2^l: X^-t = X^t_back
};

// Row r of level l.  Members copied from the kernel's parameters; what is
// derived from them is derived at each use.
struct TreeSplitStep {
  const int* ct;
  int* out;
  int* tmp;
  const uint32_t* keys;
  const SplitLevels& lv;
  long long row_words, key_words;
  int r, l;
  // node j of root b in the buffer level k writes: the last level writes
  // out (2^S nodes a root), the levels before alternate with tmp (2^(S-1))
  __device__ __forceinline__ int* node(int k, int b, int j) const {
    const bool to_out = ((lv.count - 1 - k) & 1) == 0;
    const long long nodes = 1LL << (to_out ? lv.count : lv.count - 1);
    return (to_out ? out : tmp) + ((long long)b * nodes + j) * row_words;
  }
  __device__ __forceinline__ const int* in() const {
    const int r_ = fresh(r), l_ = fresh(l);
    return l_ == 0 ? ct + r_ * row_words : node(l_ - 1, r_ >> l_, r_ & ((1 << l_) - 1));
  }
  __device__ __forceinline__ int ginv() const { return lv.ginv[fresh(l)]; }
  __device__ __forceinline__ const uint32_t* key(int pi) const {
    return keys + ((long long)fresh(l) * FHE_P + pi) * key_words;
  }
  __device__ __forceinline__ SplitStore store() const {
    const int r_ = fresh(r), l_ = fresh(l);
    int* c0 = node(l_, r_ >> l_, r_ & ((1 << l_) - 1));
    return SplitStore{in(), c0, c0 + (row_words << l_), lv.t_back[l_]};
  }
};

// Every row argument 16-byte aligned.  ct: int32[nb, C2, L, n]; keys:
// uint32[S, P, T, M, n] in level order with T = rank * L; out: int32[nb,
// 2^S, C2, L, n]; tmp: int32[nb, 2^(S-1), C2, L, n]; arrived: uint32[1],
// zero.  The grid: persistent clusters of sh.cs blocks, all resident (a
// cooperative launch).  sh: fold.cu's shape argument (sign -1, mc not
// read).  kBlocks as in fold.cu.
template <int kBlocks>
__global__ void __launch_bounds__(FOLD_THREADS, kBlocks)
split_tree_kernel(const int* __restrict__ ct, const uint32_t* __restrict__ keys, int* out,
                  int* tmp, unsigned* arrived, int nb, const __grid_constant__ SplitLevels lv,
                  FoldShape sh, FheConsts c, FoldTables tb) {
  extern __shared__ uint32_t smem[];
  const long long row_words = (long long)sh.C2 * sh.Lout * FOLD_N;
  const long long key_words = (long long)sh.T * sh.M * FOLD_N;
  OpBarrier levels{arrived, 0};
  bool pending = false;   // arrived at "residues read", not yet waited
  for (int l = 0; l < lv.count; ++l) {
    // level l - 1's children are stored, and the rows it read are free
    if (l > 0) levels.sync(gridDim.x, pending);
    for (int r = blockIdx.x / sh.cs; r < nb << l; r += gridDim.x / sh.cs)
      trace_step<kBlocks>(
          TreeSplitStep{ct, out, tmp, keys, lv, row_words, key_words, r, l}, sh.Lout,
          pending, smem, sh, c, tb);
  }
  if (pending) cluster_wait();   // no block leaves while another reads its R
}

static inline size_t split_tree_smem(const FoldShape& sh) {
  return (size_t)(sh.T + (sh.Lk > 3 ? sh.Lk : 3)) * FOLD_N * sizeof(uint32_t);
}

// The most clusters of sh.cs blocks of the instantiation `blocks` (2 or 1)
// that the device holds at once: the largest grid the launch may have.
extern "C" int fhe_split_tree_clusters(FoldShape sh, int blocks, int* clusters) {
  return max_active_clusters(blocks == 2 ? &split_tree_kernel<2> : &split_tree_kernel<1>,
                             sh.cs, split_tree_smem(sh), clusters);
}

// clusters: persistent clusters (at most fhe_split_tree_clusters); blocks:
// 2 or 1, the instantiation (registers a thread) the launch takes.
extern "C" int fhe_split_tree(const void* ct, const void* keys, void* out, void* tmp,
                              void* arrived, int nb, int clusters, SplitLevels lv,
                              int blocks, FoldShape sh, FheConsts c, FoldTables tb,
                              void* stream) {
  return launch_clusters_as(true,
                            blocks == 2 ? &split_tree_kernel<2> : &split_tree_kernel<1>,
                            clusters, sh.cs, split_tree_smem(sh), stream, (const int*)ct,
                            (const uint32_t*)keys, (int*)out, (int*)tmp,
                            (unsigned*)arrived, nb, lv, sh, c, tb);
}
