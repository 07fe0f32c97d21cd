// The predecessor of csrc/bitwise.cu (kernel 9 before its move onto the
// fold body of csrc/fold_body.cuh), kept for
// tools/time_bitwise_split_tree_predecessors.py and chip_smoke.py's checks
// only: the kernel as it was, a cooperative launch dealt over UnitSlot
// groups (csrc/fhe_core.cuh) folding with fold_row, radix-2 stages with a
// barrier each, and the M * 3 residue polys of a row parked in a scratch
// buffer in device memory.  Nothing on a serving path builds or launches
// it.
//
// Kernel 9: the VM's bitwise group (xor, or, and and their immediate forms)
// in one launch.  For every word bit j, a two-level truth-table select:
//   level 1: inner[j, g, r] = CMux(b_j; hi[g, r], lo[g, r])   r = 0, 1
//            (hi, lo) = (l11, l10) for r = 0 and (l01, l00) for r = 1
//   level 2: out[j, g] = CMux(a_j; inner[j, g, 0], inner[j, g, 1])
// The leaves are the op's constant truth-table words, the same for every
// bit; b_j is bit j of the op's b-operand source (rs2 or the immediate),
// a_j bit j of rs1.
//
// Replaces fhe_ram_tpu/ops/ntt_pallas.py: fused_bitwise_pallas.
//
// Bound on this card: operations.  W * 3G CMux rows (576 at W = 32, G = 6,
// T = 4, M = 6), in two dependent levels of 2G and G rows a bit.  Bytes:
// W * (NG + 1) keys of P * T * M * 16 KB, the leaves, W * G words out.
// Design: the bits are independent, so no barrier spans two bits: a
// cooperative launch deals the bits over groups of 2G x cs blocks
// (UnitSlot in fhe_core.cuh); slot r of a group folds level-1 row r, then,
// for r < G, the level-2 row of op r, with a barrier over the group's
// blocks between the two levels.  With the full enum the card holds all 32
// groups of 12 blocks at once only with cs = 1; the wrapper picks cs.
// Level-1 results live in device memory and are read through L2.
#include "fhe_core.cuh"

#define FHE_MAX_OPS 16

struct OpGroups {
  int count;               // ops G
  int group[FHE_MAX_OPS];  // b-operand source group of each op
};

// hi, lo: int32[G, 2, C2, L, n]; keys: uint32[W, NG + 1, P, T, M, n], per
// bit one key per source group then rs1's; out: int32[W, G, C2, L, n];
// inner: int32[W, G, 2, C2, L, n]; scratch: uint32[groups * 2G * cs, P, M,
// n]; arrived: uint32[groups, 2G + 1], zero.
__global__ void __launch_bounds__(FHE_THREADS, 2)
bitwise_predecessor_kernel(const int* hi, const int* lo, const uint32_t* __restrict__ keys,
               int* out, int* inner, uint32_t* scratch, unsigned* arrived,
               OpGroups ops, int W, int NG, int Td, FoldShape sh, FheConsts c,
               FheTables tb) {
  extern __shared__ uint32_t smem[];
  const int n = 1 << c.log_n;
  const int G = ops.count;
  UnitSlot me(2 * G, sh.cs, arrived);
  const long long ct_len = (long long)sh.C2 * sh.Lout * n;
  const long long pstride = (long long)sh.T * sh.M * n;
  const long long key_len = FHE_P * pstride;
  uint32_t* scratch_row = scratch + (long long)(blockIdx.x / sh.cs) * FHE_P * sh.M * n;
  const int g1 = me.slot >> 1;  // level 1: op and row of this slot
  for (int j = me.group; j < W; j += me.groups) {
    const uint32_t* bit_keys = keys + (long long)j * (NG + 1) * key_len;
    int* inner_j = inner + (long long)j * G * 2 * ct_len;
    CmuxGlue sel;
    sel.n = n;
    sel.L = sh.Lout;
    sel.Td = Td;
    sel.hi = hi + me.slot * ct_len;
    sel.lo = lo + me.slot * ct_len;
    fold_row(me.row, sel, bit_keys + ops.group[g1] * key_len, pstride, sh, c, tb,
             scratch_row, inner_j + me.slot * ct_len, smem);
    me.unit.sync();
    if (me.slot < G) {
      sel.hi = inner_j + (me.slot * 2) * ct_len;
      sel.lo = inner_j + (me.slot * 2 + 1) * ct_len;
      fold_row(me.row, sel, bit_keys + NG * key_len, pstride, sh, c, tb, scratch_row,
               out + ((long long)j * G + me.slot) * ct_len, smem);
    }
  }
}

extern "C" int fhe_bitwise_predecessor_blocks(FoldShape sh, int log_n, int* blocks) {
  return tree_blocks(bitwise_predecessor_kernel, tree_smem(sh, log_n), blocks);
}

extern "C" int fhe_bitwise_predecessor(const void* hi, const void* lo, const void* keys,
                           void* out, void* inner, void* scratch, void* arrived,
                           int blocks, OpGroups ops, int W, int NG, int Td,
                           FoldShape sh, FheConsts c, FheTables tb, void* stream) {
  return tree_launch(bitwise_predecessor_kernel, blocks, tree_smem(sh, c.log_n), stream,
                     (const int*)hi, (const int*)lo, (const uint32_t*)keys,
                     (int*)out, (int*)inner, (uint32_t*)scratch,
                     (unsigned*)arrived, ops, W, NG, Td, sh, c, tb);
}
