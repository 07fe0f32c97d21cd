// The predecessor of csrc/dp_chain.cu (kernel 11 before its move onto the
// fold body of csrc/fold_body.cuh), kept for
// tools/time_chain_predecessors.py only: the kernel as it was, a
// cooperative launch dealt over UnitSlot groups (csrc/fhe_core.cuh, which
// kernel 9, bitwise.cu, still runs) folding with fold_row, radix-2 stages
// with a barrier each, and the M * 3 residue polys of a row parked in a
// scratch buffer in device memory.  Nothing on a serving path builds or
// launches it.
//
// Kernel 11: the VM's carry-DP chain (add, sub, slt, sltu and their
// immediate forms) in one launch.  Per op g a 2-state word F[g, carry]
// ("the result so far given carry-in c") walks the word MSB -> LSB; step d
// (bit j = bits - 1 - d) is two CMux phases:
//   b-phase: inner[g, (a, c)] = CMux(b_j; leaf(a, 1, c), leaf(a, 0, c)),
//            leaf(a, b, c) = F[g, carry_out(a, b, c)] + out_bit(a, b, c) * delta_j
//   a-phase: F[g, c] = CMux(a_j; inner[g, (1, c)], inner[g, (0, c)])
// b_j is bit j of the op's b-operand source (rs2 or the immediate), a_j bit
// j of rs1.  The leaf coefficients are static per op (emit, subtab, flip;
// the slt flip applies at the first step only); the wrapper tabulates them.
//
// Replaces fhe_ram_tpu/ops/ntt_pallas.py: fused_dp_chain_pallas.
//
// Bound on this card: latency.  2 * bits = 64 dependent CMux phases of 4
// and 2 rows an op, 7 ops in the full RV32I enum: 28 rows at most at once.
// Bytes: bits * (NG + 1) keys of P * T * M * 16 KB (2.25 MB at T = 4,
// M = 6), each read by the rows of its phase.
// Design: the ops are independent (each reads its own F and the keys of
// its source group), so no barrier spans two ops: a cooperative launch
// deals the ops over groups of 4 x cs blocks (UnitSlot in fhe_core.cuh),
// slot r of a group folds leaf row r in the b-phase and, for r < 2, state
// row r in the a-phase, with a barrier over the group's blocks between
// phases.  cs = 6 while the rows are few (one prime and half the output
// polys a block, as in the per-level kernels).  F and inner live in device
// memory and are read through L2; F0 is the first step's input, so F is
// never read before it is written.  The leaf is formed on the loads
// (DpLeafGlue): F[co1] - F[co0] + (ob1 - ob0) * delta as digits, F[co0] +
// ob0 * delta as the base, both within the fold's digit bound.
#include "fhe_core.cuh"

#define FHE_MAX_OPS 16
#define FHE_MAX_LEAVES 128  // FHE_MAX_OPS x (first step, later steps) x 4 rows

struct DpTables {
  int count;                           // ops G
  int group[FHE_MAX_OPS];              // b-operand source group of each op
  // leaf row (a, c) of op g: co0 | co1 << 1 | ob0 << 2 | ob1 << 3 (carry-out
  // and emitted bit for b = 0 and b = 1), [g][first step][2a + c]
  unsigned char leaf[FHE_MAX_LEAVES];
};

// One leaf row of the b-phase on an op's state F [2, C2, L, n].
struct DpLeafGlue : CoefficientDigits {
  const int* F;
  const int* delta;  // [C2, L, n] of the step
  long long half;    // C2 * L * n: F[1] - F[0]
  int n, L, Td, co0, co1, ob0, ob1;
  __device__ __forceinline__ int digit(int t, int i) const {
    const int at = ((t / Td) * L + t % Td) * n + i;
    int v = __ldcg(F + co1 * half + at) - __ldcg(F + co0 * half + at);
    if (ob1 != ob0) v += (ob1 - ob0) * __ldcg(delta + at);
    return v;
  }
  __device__ __forceinline__ int base(int c2, int l, int i) const {
    const int at = (c2 * L + l) * n + i;
    int v = __ldcg(F + co0 * half + at);
    if (ob0) v += ob0 * __ldcg(delta + at);
    return v;
  }
};

// f0: int32[G, 2, C2, L, n]; keys: uint32[bits, NG + 1, P, T, M, n] in step
// order (MSB first), per step one key per source group then rs1's;
// deltas: int32[bits, C2, L, n] in step order; F (the output): int32[G, 2,
// C2, L, n]; inner: int32[G, 4, C2, L, n]; scratch: uint32[groups * 4 *
// cs, P, M, n]; arrived: uint32[groups, 5], zero.
__global__ void __launch_bounds__(FHE_THREADS, 2)
dp_chain_predecessor_kernel(const int* f0, const uint32_t* __restrict__ keys,
                const int* deltas, int* F, int* inner, uint32_t* scratch,
                unsigned* arrived, DpTables tab, int bits, int NG, int Td,
                FoldShape sh, FheConsts c, FheTables tb) {
  extern __shared__ uint32_t smem[];
  const int n = 1 << c.log_n;
  UnitSlot me(4, sh.cs, arrived);
  const long long ct_len = (long long)sh.C2 * sh.Lout * n;
  const long long pstride = (long long)sh.T * sh.M * n;
  const long long key_len = FHE_P * pstride;
  uint32_t* scratch_row = scratch + (long long)(blockIdx.x / sh.cs) * FHE_P * sh.M * n;
  for (int g = me.group; g < tab.count; g += me.groups) {
    for (int d = 0; d < bits; ++d) {
      const uint32_t* step_keys = keys + (long long)d * (NG + 1) * key_len;
      const unsigned e = tab.leaf[(g * 2 + (d == 0)) * 4 + me.slot];
      DpLeafGlue leaf;
      leaf.F = (d == 0 ? f0 : F) + g * 2 * ct_len;
      leaf.delta = deltas + d * ct_len;
      leaf.half = ct_len;
      leaf.n = n;
      leaf.L = sh.Lout;
      leaf.Td = Td;
      leaf.co0 = e & 1;
      leaf.co1 = (e >> 1) & 1;
      leaf.ob0 = (e >> 2) & 1;
      leaf.ob1 = (e >> 3) & 1;
      fold_row(me.row, leaf, step_keys + tab.group[g] * key_len, pstride, sh, c, tb,
               scratch_row, inner + (g * 4 + me.slot) * ct_len, smem);
      me.unit.sync();
      if (me.slot < 2) {
        CmuxGlue sel;
        sel.hi = inner + (g * 4 + 2 + me.slot) * ct_len;
        sel.lo = inner + (g * 4 + me.slot) * ct_len;
        sel.n = n;
        sel.L = sh.Lout;
        sel.Td = Td;
        fold_row(me.row, sel, step_keys + NG * key_len, pstride, sh, c, tb,
                 scratch_row, F + (g * 2 + me.slot) * ct_len, smem);
      }
      me.unit.sync();
    }
  }
}

extern "C" int fhe_dp_chain_predecessor_blocks(FoldShape sh, int log_n, int* blocks) {
  return tree_blocks(dp_chain_predecessor_kernel, tree_smem(sh, log_n), blocks);
}

extern "C" int fhe_dp_chain_predecessor(const void* f0, const void* keys, const void* deltas,
                            void* F, void* inner, void* scratch, void* arrived,
                            int blocks, DpTables tab, int bits, int NG, int Td,
                            FoldShape sh, FheConsts c, FheTables tb, void* stream) {
  return tree_launch(dp_chain_predecessor_kernel, blocks, tree_smem(sh, c.log_n), stream,
                     (const int*)f0, (const uint32_t*)keys, (const int*)deltas,
                     (int*)F, (int*)inner, (uint32_t*)scratch, (unsigned*)arrived,
                     tab, bits, NG, Td, sh, c, tb);
}
