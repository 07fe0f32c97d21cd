// The predecessor of csrc/split_tree.cu (kernel 7 before its move onto the
// fold body of csrc/fold_body.cuh), kept for
// tools/time_bitwise_split_tree_predecessors.py and chip_smoke.py's checks
// only: the kernel as it was, one cooperative launch whose levels deal
// their rows over GridRow groups (csrc/fhe_core.cuh) running split_row
// (fold_row, radix-2 stages with a barrier each, the residues parked in a
// scratch buffer in device memory), a grid-wide barrier between levels.
// Nothing on a serving path builds or launches it.
//
// Kernel 7: all S levels of the slot-extraction split tree in one launch.
// Level l splits each of the nb * 2^l nodes into two (split_row in
// fhe_core.cuh: child0 = normalize(x + KS(sigma_g x)), child1 =
// normalize(X^-t (2x - child0)), g = g_l, t = 2^l); the children are kept in
// the concat layout [child0s | child1s], so after the last level node j of
// a root is the leaf for slot j.  The integers are those of S launches of
// split.cu.
//
// Replaces fhe_ram_tpu/ops/ntt_pallas.py: fused_split_tree_pallas.
//
// Bound on this card: operations, and while the rows are few latency: a
// single write extracts 4 roots, so its levels have 4, 8, ..., 128 rows for
// 132 SMs, and a launch of its own costs each of them ~0.13 ms whatever its
// rows.  Bytes: nb rows in, nb * 2^S out, S keys.
// Design: ONE cooperative launch (every block resident).  Each level deals
// its rows over groups of cs_l consecutive blocks (GridRow: cs_l = 6 or 3
// while the level has fewer rows than the card has SMs, 1 beyond, chosen
// by the wrapper as for the per-level kernel; a hardware cluster could not
// change size between levels), group g walking rows g, g + groups, ...; a
// grid-wide barrier separates the levels.  A level reads rotated positions
// of rows the next would overwrite, so levels alternate between two
// buffers, `out` and `tmp`, arranged so that the last level writes `out`;
// what an earlier level wrote is read through L2.  Each group parks its
// row's residues in its own slice of `scratch` (one slice a block: the
// grid, not nb * 2^S, sizes it).  Offsets are 64-bit: `out` at nb = 64,
// S = 6 is 384 MiB.  Two blocks an SM (96 KB of shared memory each at
// T = 3, mc = 3), hence the register cap in the launch bounds: the grid a
// cooperative launch may have is what the card holds at once.
#include "fhe_core.cuh"

// ct: int32[nb, C2, L, n]; keys: uint32[S, P, T, M, n] in level order with
// T = rank * L; out: int32[nb, 2^S, C2, L, n]; tmp: int32[nb, 2^(S-1), C2,
// L, n]; scratch: uint32[blocks, P, M, n]; arrived: uint32[S, blocks], zero.
// lv.rot[l] = 2n - 2^l (X^-t), lv.ginv[l] = g_l^-1 mod 2n.
__global__ void __launch_bounds__(FHE_THREADS, 2)
split_tree_predecessor_kernel(const int* ct, const uint32_t* __restrict__ keys, int* out,
                  int* tmp, uint32_t* scratch, unsigned* arrived, int nb,
                  TreeLevels lv, FoldShape sh, FheConsts c, FheTables tb) {
  extern __shared__ uint32_t smem[];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int n = 1 << c.log_n;
  const int S = lv.count;
  const long long row_len = (long long)sh.C2 * sh.Lout * n;
  const long long key_len = (long long)FHE_P * sh.T * sh.M * n;
  const int* src = ct;
  long long src_nodes = 1;  // nodes a root has room for in src
  for (int l = 0; l < S; ++l) {
    const bool to_out = ((S - 1 - l) & 1) == 0;
    int* dst = to_out ? out : tmp;
    const long long dst_nodes = to_out ? 1LL << S : 1LL << (S - 1);
    const int cs = lv.cs[l];
    const int groups = gridDim.x / cs;
    const int group = blockIdx.x / cs;
    const long long parents = 1LL << l;
    const long long rows = nb * parents;
    if (group < groups) {
      GridRow blocks(cs, blockIdx.x % cs, arrived + (long long)l * gridDim.x + group);
      uint32_t* scratch_row = scratch + (long long)group * FHE_P * sh.M * n;
      for (long long r = group; r < rows; r += groups) {
        const long long b = r >> l, j = r & (parents - 1);
        int* c0 = dst + (b * dst_nodes + j) * row_len;
        split_row(blocks, src + (b * src_nodes + j) * row_len, c0,
                  c0 + parents * row_len, keys + l * key_len, lv.rot[l],
                  lv.ginv[l], sh, c, tb, scratch_row, smem);
      }
    }
    grid.sync();
    src = dst;
    src_nodes = dst_nodes;
  }
}

extern "C" int fhe_split_tree_predecessor_blocks(FoldShape sh, int log_n, int* blocks) {
  return tree_blocks(split_tree_predecessor_kernel, tree_smem(sh, log_n), blocks);
}

extern "C" int fhe_split_tree_predecessor(const void* ct, const void* keys, void* out,
                              void* tmp, void* scratch, void* arrived, int nb,
                              int blocks, TreeLevels lv, FoldShape sh,
                              FheConsts c, FheTables tb, void* stream) {
  return tree_launch(split_tree_predecessor_kernel, blocks, tree_smem(sh, c.log_n), stream,
                     (const int*)ct, (const uint32_t*)keys, (int*)out,
                     (int*)tmp, (uint32_t*)scratch, (unsigned*)arrived, nb, lv,
                     sh, c, tb);
}
