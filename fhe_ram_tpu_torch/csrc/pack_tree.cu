// Kernel 8: a whole pack tree of M leaves in one launch.  Level s merges
// the surviving 2R nodes (R = M >> (s + 1)) pairwise, node j with node
// R + j (merge_row in fhe_core.cuh: out = normalize(u + KS(sigma_g(v))),
// u/v = A +- X^t B, t = 2^(levels-1-s), g = n/t + 1), for every batch
// column; the last level leaves the root.  Full gadget.  The integers are
// those of log2(M) launches of pack_merge.cu.
//
// Replaces fhe_ram_tpu/ops/ntt_pallas.py: fused_pack_tree_pallas.
//
// Bound on this card: operations, and while the rows are few latency: a
// single read or read_prepare_write packs 4 columns, so the levels below
// 32 leaves have 64, 32, ..., 4 row pairs for 132 SMs, and a launch of its
// own costs each of the deep ones ~0.1-0.13 ms whatever its rows.  Bytes:
// M * nb rows in, nb out, log2(M) keys.
// Design: as the split tree's predecessor (tools/split_tree_predecessor.cu),
// run the other way.  ONE cooperative launch; each level deals its row
// pairs over groups of cs_s consecutive blocks (GridRow; cs_s by the
// level's rows, from the wrapper), group g walking pairs g, g + groups,
// ...; a grid-wide barrier separates the levels.
// Nodes lie node-major as the leaves do ([node, nb, C2, L, n]), so pair r
// of a level is rows r and r + R * nb of its source and row r of its
// destination.  A merge reads rotated and permuted positions of both its
// rows, so a level never writes the buffer it reads: levels alternate
// between the two halves of `tmp`, and the last writes `out`.  What an
// earlier level wrote is read through L2.  The first level takes the
// pre-shifted, unnormalized leaves (any int32 is reduced on load).
#include "fhe_core.cuh"

// cts: int32[M, nb, C2, L, n]; keys: uint32[levels, P, T, Mk, n] in merge
// order with T = rank * L; out: int32[nb, C2, L, n]; tmp: int32[M/2 + M/4,
// nb, C2, L, n]; scratch: uint32[blocks, P, Mk, n]; arrived:
// uint32[levels, blocks], zero.  lv.rot[s] = 2^(levels-1-s).
__global__ void __launch_bounds__(FHE_THREADS, 2)
pack_tree_kernel(const int* cts, const uint32_t* __restrict__ keys, int* out,
                 int* tmp, uint32_t* scratch, unsigned* arrived, int M, int nb,
                 TreeLevels lv, FoldShape sh, FheConsts c, FheTables tb) {
  extern __shared__ uint32_t smem[];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int n = 1 << c.log_n;
  const int levels = lv.count;
  const long long row_len = (long long)sh.C2 * sh.Lout * n;
  const long long key_len = (long long)FHE_P * sh.T * sh.M * n;
  int* const half[2] = {tmp, tmp + (long long)(M / 2) * nb * row_len};
  const int* src = cts;
  for (int s = 0; s < levels; ++s) {
    int* dst = s == levels - 1 ? out : half[s & 1];
    const int cs = lv.cs[s];
    const int groups = gridDim.x / cs;
    const int group = blockIdx.x / cs;
    const long long rows = (long long)(M >> (s + 1)) * nb;
    if (group < groups) {
      GridRow blocks(cs, blockIdx.x % cs, arrived + (long long)s * gridDim.x + group);
      uint32_t* scratch_row = scratch + (long long)group * FHE_P * sh.M * n;
      for (long long r = group; r < rows; r += groups)
        merge_row<true>(blocks, src + r * row_len, src + (r + rows) * row_len,
                        dst + r * row_len, keys + s * key_len, lv.rot[s],
                        lv.ginv[s], sh.Lout, sh, c, tb, scratch_row, smem);
    }
    grid.sync();
    src = dst;
  }
}

extern "C" int fhe_pack_tree_blocks(FoldShape sh, int log_n, int* blocks) {
  return tree_blocks(pack_tree_kernel, tree_smem(sh, log_n), blocks);
}

extern "C" int fhe_pack_tree(const void* cts, const void* keys, void* out,
                             void* tmp, void* scratch, void* arrived, int M,
                             int nb, int blocks, TreeLevels lv, FoldShape sh,
                             FheConsts c, FheTables tb, void* stream) {
  return tree_launch(pack_tree_kernel, blocks, tree_smem(sh, c.log_n), stream,
                     (const int*)cts, (const uint32_t*)keys, (int*)out,
                     (int*)tmp, (uint32_t*)scratch, (unsigned*)arrived, M, nb,
                     lv, sh, c, tb);
}
