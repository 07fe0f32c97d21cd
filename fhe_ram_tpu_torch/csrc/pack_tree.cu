// Kernel 8: a whole pack tree of M leaves in one launch.  Level s merges
// the surviving 2R nodes (R = M >> (s + 1)) pairwise, node j with node
// R + j (out = normalize(u + KS(sigma_g(v))), u/v = A +- X^t B, t =
// 2^(levels-1-s), g = n/t + 1), for every batch column; the last level
// leaves the root.  Full gadget.  The integers are those of log2(M)
// launches of pack_merge.cu.
//
// Replaces fhe_ram_tpu/ops/ntt_pallas.py: fused_pack_tree_pallas.
//
// Bound on this card: operations, and while the rows are few latency: a
// single read_prepare_write packs 4 columns, so its levels have 64, 32,
// ..., 4 row pairs for 132 SMs, and a launch of its own costs each of them
// ~0.06 ms whatever its rows.  Bytes: M * nb rows in, nb out, log2(M) keys.
//
// Design: csrc/fold.cu's body (fold_body.cuh), split_tree.cu's design run
// the other way, with bitwise.cu's deal.  Every row pair of a level runs
// pack_merge.cu's row step (fold_body.cuh merge_rows) on a thread block
// cluster: one block a prime, or two groups of 3 that share the output
// components; v = A - X^t B of each digit poly staged in shared memory and
// gathered at sigma_g's words; the residues in shared memory; the Garner
// step over distributed shared memory.  ONE launch, cooperative and
// clustered (the wrapper sizes the grid by cudaOccupancyMaxActiveClusters:
// every cluster resident).  The row pairs of all levels form one list,
// level by level, that persistent clusters deal (cluster k takes items k,
// k + clusters, ...).  No barrier spans a level: a pair of level s > 0
// waits on device counters only for its two source rows, the stores of
// level s - 1's pairs r and r + R * nb (each block arrives after its
// stores, release; the wait acquires; a wait that outlasts 2^24 polls
// traps: fold_body.cuh unit_arrive / unit_wait; TreeRows).  A cluster takes its
// items in list order and every item an item waits on stands earlier in
// the list, so the earliest unfinished item can always run: every wait
// ends.  On an H100 this ran 2 % faster at nb = 4 and 64 than a grid-wide
// OpBarrier between the levels, whose runs spread more (the wait at each
// level for the slowest cluster; that deal is kept for timing in
// fhe_ram_tpu_torch/tools/pack_tree_barrier.cu).  One cluster size for
// the whole launch, chosen by the wrapper from the tree's shape
// (ops/ntt_cuda._tree_layout, which prices the split tree's levels the
// same way).  Nodes lie node-major as the leaves do ([node, nb, C2, L,
// n]), so pair r of a level is rows r and r + R * nb of its source and row
// r of its destination.  A merge reads rotated and permuted positions of
// both its rows, so a level never writes the buffer it reads: levels
// alternate between the two halves of `tmp` (M/2 * nb rows, then M/4 *
// nb), and the last writes `out`.  Level s writes row r of half s & 1 only
// after level s - 1's pair r, the one pair that read that row, is done: it
// is the first of its sources.  Every row is read through L2 (what an
// earlier level wrote is there).  The first level reads the pre-scaled,
// unnormalized leaves (limbs up to 2^17), as kernel 4 does on the
// per-level route.  Offsets are 64-bit.  Shared memory: the T spectra and
// max(Lk, 3) residue polys, 112 KB at T = 3, Lk = 4: two blocks an SM;
// nothing in device memory but the rows and a counter a row.
// Its predecessor, merge_row (fhe_core.cuh fold_row) over GridRow groups
// whose size followed each level's rows, with the residues parked in a
// device scratch, is kept for timing in
// fhe_ram_tpu_torch/tools/pack_tree_predecessor.cu.
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
  int row_polys, key_polys;   // polys of a row, of a prime's key rows
  int M, nb;
  // the buffer level k writes: `out` for the last level, else half k & 1
  // of tmp (M/2 * nb rows, then M/4 * nb)
  __device__ __forceinline__ int* buf(int k) const {
    if (k == lv.count - 1) return out;
    return (k & 1) ? tmp + (long long)((M / 2) * nb * row_polys) * FOLD_N : tmp;
  }
  // level s's row pairs read rows r and r + R nb of the buffer level s - 1
  // wrote (the leaves at level 0) and write row r of buf(s)
  __device__ __forceinline__ const int* src_a(int s) const {
    return s == 0 ? cts : buf(s - 1);
  }
  __device__ __forceinline__ const int* src_b(int s) const {
    return src_a(s) + (long long)((M >> (s + 1)) * nb * row_polys) * FOLD_N;
  }
  __device__ __forceinline__ const uint32_t* level_keys(int s) const {
    return keys_ + (long long)(s * FHE_P * key_polys) * FOLD_N;
  }
};

// Kernel 8's walk of merge_rows: item i of the list is row pair `row` of
// level `s`, its handle row << 4 | s (one register held across the item;
// the levels are fewer than 16); it waits for the two items of the level
// before that wrote its rows, and its blocks count their stores at done[i]
// (every level's but the last).
struct TreeRows : TreeBuffers {
  unsigned* done;
  int cs;
  // the first item of level s: level s holds items (M - (M >> s)) nb ..
  // (M - (M >> (s + 1))) nb - 1
  __device__ __forceinline__ int first(int s) const { return (M - (M >> s)) * nb; }
  __device__ __forceinline__ int item(int i) const {
    int s = 0;
    while (i >= first(s + 1)) ++s;
    return (i - first(s)) << 4 | s;
  }
  __device__ __forceinline__ static int level(int it) { return it & 15; }
  __device__ __forceinline__ int row(int it) const { return it >> 4; }
  __device__ __forceinline__ void wait(int it) const {
    const int s = level(it);
    if (s == 0) return;
    const int at = first(s - 1) + row(it);   // the items of rows r and r + R nb
    unit_wait(done + at, cs);
    unit_wait(done + at + (M >> (s + 1)) * nb, cs);
  }
  __device__ __forceinline__ void arrive(int it) const {
    if (level(it) < lv.count - 1) unit_arrive(done + first(level(it)) + row(it));
  }
  __device__ __forceinline__ const int* a(int it, const int*) const {
    return src_a(level(fresh(it)));
  }
  __device__ __forceinline__ const int* b(int it, const int*) const {
    return src_b(level(fresh(it)));
  }
  __device__ __forceinline__ int* dst(int it, int*) const { return buf(level(fresh(it))); }
  __device__ __forceinline__ const uint32_t* keys(int it, const uint32_t*) const {
    return level_keys(level(fresh(it)));
  }
  __device__ __forceinline__ int t_rot(int it, int) const { return lv.rot[level(it)]; }
  __device__ __forceinline__ int ginv(int it, int) const { return lv.ginv[level(it)]; }
};

// cts: int32[M, nb, C2, L, n]; keys: uint32[levels, P, T, Mk, n] in merge
// order with T = rank * Td; out: int32[nb, C2, L, n]; tmp: int32[M/2 +
// M/4, nb, C2, L, n]; done: uint32[max(1, (M - 2) nb)], zero: a counter
// for item i of the list, every level's but the last.  keys 16-byte
// aligned.  The grid: persistent clusters of sh.cs blocks, all resident (a
// cooperative launch).  sh: fold.cu's shape argument (sign -1, mc not
// read).  kBlocks as in fold.cu.
template <int kBlocks>
__global__ void __launch_bounds__(FOLD_THREADS, kBlocks)
pack_tree_kernel(const int* cts, const uint32_t* __restrict__ keys, int* out, int* tmp,
                 unsigned* done, int M, int nb, int Td, const __grid_constant__ PackLevels lv,
                 FoldShape sh, FheConsts c, FoldTables tb) {
  merge_rows<kBlocks, true>(
      TreeRows{{cts, out, tmp, keys, lv, sh.C2 * sh.Lout, sh.T * sh.M, M, nb}, done, sh.cs},
      nullptr, nullptr, nullptr, nullptr, (M - 1) * nb, 0, 0, Td, sh, c, tb);
}

static inline size_t pack_tree_smem(const FoldShape& sh) {
  return (size_t)(sh.T + (sh.Lk > 3 ? sh.Lk : 3)) * FOLD_N * sizeof(uint32_t);
}

// The most clusters of sh.cs blocks of the instantiation `blocks` (2 or 1)
// that the device holds at once: the largest grid the launch may have.
extern "C" int fhe_pack_tree_clusters(FoldShape sh, int blocks, int* clusters) {
  return max_active_clusters(blocks == 2 ? &pack_tree_kernel<2> : &pack_tree_kernel<1>,
                             sh.cs, pack_tree_smem(sh), clusters);
}

// clusters: persistent clusters (at most fhe_pack_tree_clusters); blocks:
// 2 or 1, the instantiation (registers a thread) the launch takes.
extern "C" int fhe_pack_tree(const void* cts, const void* keys, void* out, void* tmp,
                             void* done, int M, int nb, int clusters, int Td, PackLevels lv,
                             int blocks, FoldShape sh, FheConsts c, FoldTables tb,
                             void* stream) {
  return launch_clusters_as(true, blocks == 2 ? &pack_tree_kernel<2> : &pack_tree_kernel<1>,
                            clusters, sh.cs, pack_tree_smem(sh), stream, (const int*)cts,
                            (const uint32_t*)keys, (int*)out, (int*)tmp, (unsigned*)done, M,
                            nb, Td, lv, sh, c, tb);
}
