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
//
// Design: csrc/fold.cu's body (fold_body.cuh).  Every row of a phase is a
// thread block cluster running fold_body.cuh's cmux_step (one block a
// prime, or two groups of 3 that share the output components while the
// rows are few: ops/ntt_cuda._fold_cs; radix-16 register passes, the
// residues in shared memory, the Garner step over distributed shared
// memory).  The ops are independent (each reads its own F and the keys of
// its source group), so an op is a group of four clusters, slot r folding
// leaf row r in the b-phase and, for r < 2, state row r in the a-phase;
// groups walk the ops g, g + groups, ...  The b-phase's digit poly F[co1]
// - F[co0] + (ob1 - ob0) * delta is formed on 16-byte loads through L2 and
// staged in shared memory (cmux_step), its base F[co0] + ob0 * delta, from
// (co0, co1, ob0, ob1), the op's table entry; the a-phase's digits are
// inner[2 + r] - inner[r], its base inner[r].  F and inner live in device
// memory and are read through L2 (__ldcg); F0 is the first step's input,
// so F is never read before it is written.  After each phase a barrier
// over the op's 4 * cs blocks (OpBarrier: a device-memory counter, release
// / acquire) orders one phase's stores before the next phase's loads;
// slots 2 and 3 skip the a-phase's fold and only arrive.
// Co-residency, the hard part: a barrier over four clusters needs all four
// resident at once.  The launch is cooperative AND clustered (both
// attributes in one cudaLaunchKernelEx), the grid sized by
// cudaOccupancyMaxActiveClusters; the wrapper raises where an op's four
// clusters do not fit, and a spin that never ends traps.  An H100's
// runtime (CUDA 12.8) takes the pair of attributes, so the alternative, an
// op as one non-portable cluster of 4 x 3 blocks with a cluster barrier
// between the phases, is not built.  Shared memory: the T spectra and
// max(Lk, 3) residue polys (the third doubles as the staging buffer), 112
// KB at T = 4, Lk = 3: two blocks an SM; nothing in device memory but F,
// inner and the counters.
// Its predecessor, fold_row over DpLeafGlue and CmuxGlue in UnitSlot
// groups (fhe_core.cuh) with the residues parked in a device scratch, is
// kept for timing in fhe_ram_tpu_torch/tools/dp_chain_predecessor.cu.
#include "fold_body.cuh"

#define FHE_MAX_OPS 16
#define FHE_MAX_LEAVES 128  // FHE_MAX_OPS x (first step, later steps) x 4 rows

struct DpTables {
  int count;                           // ops G
  int group[FHE_MAX_OPS];              // b-operand source group of each op
  // leaf row (a, c) of op g: co0 | co1 << 1 | ob0 << 2 | ob1 << 3 (carry-out
  // and emitted bit for b = 0 and b = 1), [g][first step][2a + c]
  unsigned char leaf[FHE_MAX_LEAVES];
};

// The b-phase digit poly of a leaf row, staged: F[co1] - F[co0] + (ob1 -
// ob0) * delta, each operand read through L2.
struct DpLeafDigits {
  const int4* hi;      // F[co1]'s poly
  const int4* lo;      // F[co0]'s poly
  const int4* delta;   // delta_j's poly
  int dob;             // ob1 - ob0
  __device__ __forceinline__ int4 unit(int q) const {
    int4 v = sub4(__ldcg(hi + q), __ldcg(lo + q));
    if (dob) {
      const int4 e = __ldcg(delta + q);
      v = make_int4(v.x + dob * e.x, v.y + dob * e.y, v.z + dob * e.z, v.w + dob * e.w);
    }
    return v;
  }
  __device__ __forceinline__ int operator()(const int* V, int i) const { return V[i]; }
};

// The b-phase base of a leaf row: F[co0] + ob0 * delta.
struct DpLeafBase {
  const int* lo;
  const int* delta;
  int ob0;
  __device__ __forceinline__ int operator()(int, int, int, long long at) const {
    int v = __ldcg(lo + at);
    if (ob0) v += __ldcg(delta + at);
    return v;
  }
};

// What both phases of op g at step d read.  Members copied from the
// kernel's parameters; what is derived from them is derived at each use.
struct DpOp {
  const int* f0;
  int* F;
  int* inner;
  const int* deltas;
  const uint32_t* keys;
  const DpTables& tab;
  long long ct_words, key_words;
  int g, d, slot, NG, Td, L;
  // poly (component tt / Td, limb tt % Td) of a row, as 16-byte units
  __device__ __forceinline__ const int4* poly(const int* row, int tt) const {
    return reinterpret_cast<const int4*>(row + ((tt / Td) * L + tt % Td) * FOLD_N);
  }
  __device__ __forceinline__ unsigned code() const {
    return tab.leaf[(fresh(g) * 2 + (fresh(d) == 0)) * 4 + slot];
  }
  __device__ __forceinline__ const int* state(int co) const {
    return (fresh(d) == 0 ? f0 : F) + (fresh(g) * 2 + co) * ct_words;
  }
  __device__ __forceinline__ const int* delta() const {
    return deltas + fresh(d) * ct_words;
  }
  __device__ __forceinline__ int* inner_row(int k) const {
    return inner + (fresh(g) * 4 + k) * ct_words;
  }
  // the key of source group `grp` (NG: rs1's) of step d, prime pi
  __device__ __forceinline__ const uint32_t* key_of(int grp, int pi) const {
    return keys + (((long long)fresh(d) * (NG + 1) + grp) * FHE_P + pi) * key_words;
  }
};

// b-phase: leaf row `slot` of op g into inner[g, slot], against the key of
// the op's source group.
struct DpLeafStep : DpOp {
  __device__ __forceinline__ DpLeafDigits digits(int tt) const {
    const unsigned e = code();
    return DpLeafDigits{poly(state((e >> 1) & 1), tt), poly(state(e & 1), tt),
                        poly(delta(), tt), (int)((e >> 3) & 1) - (int)((e >> 2) & 1)};
  }
  __device__ __forceinline__ DpLeafBase base() const {
    const unsigned e = code();
    return DpLeafBase{state(e & 1), delta(), (int)((e >> 2) & 1)};
  }
  __device__ __forceinline__ const uint32_t* key(int pi) const {
    return key_of(tab.group[fresh(g)], pi);
  }
  __device__ __forceinline__ RowStore store() const { return RowStore{inner_row(slot)}; }
};

// a-phase: state row `slot` (< 2) of op g into F[g, slot], against rs1's
// key; its digit poly inner[2 + r] - inner[r] (DiffDigits).
struct DpStateStep : DpOp {
  __device__ __forceinline__ DiffDigits digits(int tt) const {
    return DiffDigits{poly(inner_row(2 + slot), tt), poly(inner_row(slot), tt)};
  }
  __device__ __forceinline__ RowBase base() const { return RowBase{inner_row(slot)}; }
  __device__ __forceinline__ const uint32_t* key(int pi) const { return key_of(NG, pi); }
  __device__ __forceinline__ RowStore store() const {
    return RowStore{F + (fresh(g) * 2 + slot) * ct_words};
  }
};

// Every row argument 16-byte aligned.  f0: int32[G, 2, C2, L, n]; keys:
// uint32[bits, NG + 1, P, T, M, n] in step
// order (MSB first), per step one key per source group then rs1's;
// deltas: int32[bits, C2, L, n] in step order; F (the output): int32[G, 2,
// C2, L, n]; inner: int32[G, 4, C2, L, n]; arrived: uint32[groups], zero.
// The grid: groups x 4 clusters of sh.cs blocks, all resident (a
// cooperative launch).  sh: fold.cu's shape argument (sign +1, mc not
// read).  kBlocks as in fold.cu.
template <int kBlocks>
__global__ void __launch_bounds__(FOLD_THREADS, kBlocks)
dp_chain_kernel(const int* f0, const uint32_t* __restrict__ keys, const int* deltas, int* F,
                int* inner, unsigned* arrived, const __grid_constant__ DpTables tab,
                int bits, int NG, int Td, FoldShape sh, FheConsts c, FoldTables tb) {
  extern __shared__ uint32_t smem[];
  const int cluster = blockIdx.x / sh.cs;
  const int slot = cluster % 4, group = cluster / 4;
  const int groups = gridDim.x / (4 * sh.cs);
  const long long ct_words = (long long)sh.C2 * sh.Lout * FOLD_N;
  const long long key_words = (long long)sh.T * sh.M * FOLD_N;
  OpBarrier op{arrived + group, 0};
  bool pending = false;   // arrived at "residues read", not yet waited
  for (int g = group; g < tab.count; g += groups) {
    for (int d = 0; d < bits; ++d) {
      const DpOp o{f0, F, inner, deltas, keys, tab, ct_words, key_words,
                   g, d, slot, NG, Td, sh.Lout};
      cmux_step<kBlocks>(DpLeafStep{o}, pending, smem, sh, c, tb);
      op.sync(4 * sh.cs, pending);   // inner[g] is complete
      if (slot < 2) cmux_step<kBlocks>(DpStateStep{o}, pending, smem, sh, c, tb);
      op.sync(4 * sh.cs, pending);   // F[g] is complete, inner[g] read
    }
  }
}

static inline size_t dp_chain_smem(const FoldShape& sh) {
  return (size_t)(sh.T + (sh.Lk > 3 ? sh.Lk : 3)) * FOLD_N * sizeof(uint32_t);
}

// The most clusters of sh.cs blocks of the instantiation `blocks` (2 or 1)
// that the device holds at once: an op takes 4.
extern "C" int fhe_dp_chain_clusters(FoldShape sh, int blocks, int* clusters) {
  return max_active_clusters(blocks == 2 ? &dp_chain_kernel<2> : &dp_chain_kernel<1>, sh.cs,
                             dp_chain_smem(sh), clusters);
}

// groups: ops in flight, 4 clusters each (at most fhe_dp_chain_clusters / 4);
// blocks: 2 or 1, the instantiation (registers a thread) the launch takes.
extern "C" int fhe_dp_chain(const void* f0, const void* keys, const void* deltas, void* F,
                            void* inner, void* arrived, int groups, DpTables tab, int bits,
                            int NG, int Td, int blocks, FoldShape sh, FheConsts c,
                            FoldTables tb, void* stream) {
  return launch_clusters_as(true, blocks == 2 ? &dp_chain_kernel<2> : &dp_chain_kernel<1>,
                            4 * groups, sh.cs, dp_chain_smem(sh), stream, (const int*)f0,
                            (const uint32_t*)keys, (const int*)deltas, (int*)F,
                            (int*)inner, (unsigned*)arrived, tab, bits, NG, Td, sh, c, tb);
}
