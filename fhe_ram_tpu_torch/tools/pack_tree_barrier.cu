// The other deal of kernel 8 (csrc/pack_tree.cu), kept for
// tools/time_pack_tree_ntt_predecessors.py only: the same row loop
// (fold_body.cuh merge_rows) on the same clusters, buffers and levels, but
// each level's row pairs dealt over the persistent clusters (r, r +
// clusters, ...) with a grid-wide OpBarrier (fold_body.cuh) between the
// levels in place of the per-row counters: split_tree.cu's deal.  Nothing
// on a serving path builds or launches it.
#include "fold_body.cuh"

struct PackLevels {
  int count;                 // levels log2(M)
  int ginv[FHE_MAX_STEPS];   // g_s^-1 mod 2n
  int rot[FHE_MAX_STEPS];    // t_s = 2^(count-1-s), in [0, 2n)
};

// The buffers of a tree launch.  Members copied from the kernel's
// parameters; what is derived from them is derived at each use.
struct TreeBuffers {
  const int* cts;
  int* out;
  int* tmp;
  const uint32_t* keys_;
  const PackLevels& lv;
  long long row_words, key_words;
  int M, nb;
  // the buffer level k writes: `out` for the last level, else half k & 1
  // of tmp (M/2 * nb rows, then M/4 * nb)
  __device__ __forceinline__ int* buf(int k) const {
    if (k == lv.count - 1) return out;
    return (k & 1) ? tmp + (long long)(M / 2) * nb * row_words : tmp;
  }
  // level s's row pairs read rows r and r + R nb of the buffer level s - 1
  // wrote (the leaves at level 0) and write row r of buf(s)
  __device__ __forceinline__ const int* src_a(int s) const {
    return s == 0 ? cts : buf(s - 1);
  }
  __device__ __forceinline__ const int* src_b(int s) const {
    return src_a(s) + (long long)((M >> (s + 1)) * nb) * row_words;
  }
  __device__ __forceinline__ const uint32_t* level_keys(int s) const {
    return keys_ + (long long)s * FHE_P * key_words;
  }
};

// merge_rows's walk of level s: row pair r is row r of its buffers.
struct LevelRows : TreeBuffers {
  int s;
  __device__ __forceinline__ int item(int r) const { return r; }
  __device__ __forceinline__ void wait(int) const {}
  __device__ __forceinline__ void arrive(int) const {}
  __device__ __forceinline__ int row(int r) const { return r; }
  __device__ __forceinline__ const int* a(int, const int*) const { return src_a(fresh(s)); }
  __device__ __forceinline__ const int* b(int, const int*) const { return src_b(fresh(s)); }
  __device__ __forceinline__ int* dst(int, int*) const { return buf(fresh(s)); }
  __device__ __forceinline__ const uint32_t* keys(int, const uint32_t*) const {
    return level_keys(fresh(s));
  }
  __device__ __forceinline__ int t_rot(int, int) const { return lv.rot[s]; }
  __device__ __forceinline__ int ginv(int, int) const { return lv.ginv[s]; }
};

// As csrc/pack_tree.cu's kernel; arrived: uint32[1], zero.
template <int kBlocks>
__global__ void __launch_bounds__(FOLD_THREADS, kBlocks)
pack_tree_barrier_kernel(const int* cts, const uint32_t* __restrict__ keys, int* out,
                         int* tmp, unsigned* arrived, int M, int nb, int Td,
                         const __grid_constant__ PackLevels lv, FoldShape sh, FheConsts c,
                         FoldTables tb) {
  const long long row_words = (long long)sh.C2 * sh.Lout * FOLD_N;
  const long long key_words = (long long)sh.T * sh.M * FOLD_N;
  OpBarrier levels{arrived, 0};
  bool pending = false;   // merge_rows leaves no cluster barrier pending
  for (int s = 0; s < lv.count; ++s) {
    // level s - 1's merges are stored, and the rows it read are free
    if (s > 0) levels.sync(gridDim.x, pending);
    merge_rows<kBlocks, true>(
        LevelRows{{cts, out, tmp, keys, lv, row_words, key_words, M, nb}, s}, nullptr,
        nullptr, nullptr, nullptr, (M >> (s + 1)) * nb, 0, 0, Td, sh, c, tb);
  }
}

static inline size_t pack_tree_smem(const FoldShape& sh) {
  return (size_t)(sh.T + (sh.Lk > 3 ? sh.Lk : 3)) * FOLD_N * sizeof(uint32_t);
}

extern "C" int fhe_pack_tree_barrier_clusters(FoldShape sh, int blocks, int* clusters) {
  return max_active_clusters(
      blocks == 2 ? &pack_tree_barrier_kernel<2> : &pack_tree_barrier_kernel<1>, sh.cs,
      pack_tree_smem(sh), clusters);
}

extern "C" int fhe_pack_tree_barrier(const void* cts, const void* keys, void* out, void* tmp,
                                     void* arrived, int M, int nb, int clusters, int Td,
                                     PackLevels lv, int blocks, FoldShape sh, FheConsts c,
                                     FoldTables tb, void* stream) {
  return launch_clusters_as(
      true, blocks == 2 ? &pack_tree_barrier_kernel<2> : &pack_tree_barrier_kernel<1>,
      clusters, sh.cs, pack_tree_smem(sh), stream, (const int*)cts, (const uint32_t*)keys,
      (int*)out, (int*)tmp, (unsigned*)arrived, M, nb, Td, lv, sh, c, tb);
}
