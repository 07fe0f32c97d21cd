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
// Bound on this card: bytes, barely: the W * (NG + 1) keys of P * T * M *
// 16 KB (1.18 MB each at T = 4, M = 6; 113 MB at W = 32, NG = 2, 34 us at
// 3.35 TB/s), the leaves, W * G words out, against W * 3G CMux rows (576
// at W = 32, G = 6) in two dependent levels of 2G and G rows a bit, 1.9 G
// operations with the leaf rows' transforms shared (28 us at 67
// Tera-op/s).
//
// Design: csrc/fold.cu's body (fold_body.cuh).  Every row is a thread
// block cluster running fold_body.cuh's CMux step (one block a prime, or
// two groups of 3 that share the output components while the rows are
// few: ops/ntt_cuda._fold_cs; radix-16 register passes, the residues in
// shared memory, the Garner step over distributed shared memory).  A
// level-1 row's digits, hi[g, r] - lo[g, r], are the same for every bit,
// so their spectra are made once a leaf row (cmux_forward, into device
// memory), and each level-1 row copies its leaf row's and runs the fold
// half only (cmux_fold): 2G forward passes where the 2WG rows made one
// each (on an H100 faster at the cycle's shape, alternately in one call).
// A (bit, op) pair is a unit u = j * G + g; the items of one list:
//   item s < 2G          the spectra of leaf row s (the cluster's first 3
//                        blocks, one a prime);
//   item 2G + 2u + r     level-1 row r of unit u, stored at inner row 2u + r;
//   item 2G + 2WG + u    the level-2 row of unit u (a whole cmux_step),
//                        stored at out row u.
// Persistent clusters deal the list (cluster k takes items k, k +
// clusters, ...), each level bit-major, so the clusters in flight together
// read few bits' keys and reuse them through L2.  A row waits, on a device
// counter, only for what it reads: a level-1 row for the cs blocks of its
// leaf row's spectra, a level-2 row for the 2 cs blocks of its unit's
// level-1 rows (each block arrives after its stores, release; the wait
// acquires; a wait that outlasts 2^24 polls traps); no barrier spans a
// level or two units.  At the cycle's shape that is 588 items over the 79
// clusters of 3 the card holds: the 12 leaf rows' spectra (while the other
// clusters' first level-1 rows wait for them), then 8 rounds of rows, the
// first 5 of level-1 rows without their forward transforms, where one
// cluster a unit (its three rows, a cluster barrier between the levels)
// took 9 whole rows.  A
// cluster takes its items in list order and every item an item waits on
// stands earlier in the list, so the earliest unfinished item can always
// run: with every cluster resident (a cooperative AND clustered launch,
// the grid from cudaOccupancyMaxActiveClusters) every wait ends.
// Digits: the leaf rows' and the level-2 rows' (inner[2u] - inner[2u +
// 1]), the top Td limbs of each component, staged in shared memory from
// 16-byte loads through L2 (DiffDigits); the base lo[g, r] or inner[2u +
// 1], read through L2 (RowBase).  Shared memory: the T spectra and max(Lk,
// 3) residue polys, 112 KB at T = 4, Lk = 3: two blocks an SM; nothing in
// device memory but inner, the 2G leaf spectra and the counters.
// Its predecessor, fold_row over CmuxGlue in UnitSlot groups (fhe_core.cuh)
// with the residues parked in a device scratch, is kept for timing in
// fhe_ram_tpu_torch/tools/bitwise_predecessor.cu.
#include "fold_body.cuh"

#define FHE_MAX_OPS 16

struct OpGroups {
  int count;               // ops G
  int group[FHE_MAX_OPS];  // b-operand source group of each op
};

// Item i of the list.  Members copied from the kernel's parameters; what is
// derived from them is derived at each use.
struct BitwiseRow {
  const int* hi;
  const int* lo;
  const uint32_t* keys;
  int* out;
  int* inner;
  const OpGroups& ops;
  long long ct_words, key_words;
  int i, W, NG, Td, L;
  __device__ __forceinline__ int level1_items() const { return 2 * W * ops.count; }
  // the row of an arm: the leaves of op g at level 1, the unit's inner rows
  // at level 2
  __device__ __forceinline__ const int* arm(bool high) const {
    const int i_ = fresh(i);
    if (i_ < level1_items())
      return (high ? hi : lo) + ((i_ >> 1) % ops.count * 2 + (i_ & 1)) * ct_words;
    return inner + ((long long)(i_ - level1_items()) * 2 + (high ? 0 : 1)) * ct_words;
  }
  // poly (component tt / Td, limb tt % Td) of a row, as 16-byte units
  __device__ __forceinline__ const int4* poly(const int* row, int tt) const {
    return reinterpret_cast<const int4*>(row + ((tt / Td) * L + tt % Td) * FOLD_N);
  }
  __device__ __forceinline__ DiffDigits digits(int tt) const {
    return DiffDigits{poly(arm(true), tt), poly(arm(false), tt)};
  }
  __device__ __forceinline__ RowBase base() const { return RowBase{arm(false)}; }
  // bit j's key of the op's source group (level 1) or of rs1 (level 2)
  __device__ __forceinline__ const uint32_t* key(int pi) const {
    const int i_ = fresh(i);
    const bool level1 = i_ < level1_items();
    const int u = level1 ? i_ >> 1 : i_ - level1_items();
    const int grp = level1 ? ops.group[u % ops.count] : NG;
    return keys + (((long long)(u / ops.count) * (NG + 1) + grp) * FHE_P + pi) * key_words;
  }
  __device__ __forceinline__ RowStore store() const {
    const int i_ = fresh(i);
    return RowStore{i_ < level1_items() ? inner + i_ * ct_words
                                        : out + (i_ - level1_items()) * ct_words};
  }
};

// This block has stored its part of a level-1 row: count it at the row's
// unit.  Every thread's stores precede the barrier, thread 0's release
// follows it.
__device__ __forceinline__ void unit_arrive(unsigned* count) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> n(*count);
    n.fetch_add(1u, cuda::memory_order_release);
  }
}

// Wait until `target` blocks have arrived at the unit; what they stored is
// then visible to this block's loads through L2.
__device__ __forceinline__ void unit_wait(unsigned* count, unsigned target) {
  if (threadIdx.x == 0) {
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> n(*count);
    unsigned polls = 0;
    while (n.load(cuda::memory_order_acquire) < target)
      if (++polls == (1u << 24)) __trap();
  }
  __syncthreads();
}

// Every row argument 16-byte aligned.  hi, lo: int32[G, 2, C2, L, n]; keys:
// uint32[W, NG + 1, P, T, M, n], per bit one key per source group then
// rs1's; out: int32[W, G, C2, L, n]; inner: int32[W, G, 2, C2, L, n];
// spectra: uint32[2G, P, T, n]; done: uint32[W * G + 2G], zero.  The grid:
// persistent clusters of sh.cs blocks, all resident (a cooperative
// launch).  sh: fold.cu's shape argument (sign +1, mc not read).  kBlocks
// as in fold.cu.
template <int kBlocks>
__global__ void __launch_bounds__(FOLD_THREADS, kBlocks)
bitwise_kernel(const int* hi, const int* lo, const uint32_t* __restrict__ keys, int* out,
               int* inner, uint32_t* spectra, unsigned* done,
               const __grid_constant__ OpGroups ops, int W, int NG, int Td, FoldShape sh,
               FheConsts c, FoldTables tb) {
  extern __shared__ uint32_t smem[];
  const long long ct_words = (long long)sh.C2 * sh.Lout * FOLD_N;
  const long long key_words = (long long)sh.T * sh.M * FOLD_N;
  bool pending = false;   // arrived at "residues read", not yet waited
  for (int i = blockIdx.x / sh.cs; i < (3 * W + 2) * ops.count; i += gridDim.x / sh.cs) {
    // item i < 2G makes the spectra of leaf row s = i, which are the digits
    // of the level-1 row it = s of bit 0: BitwiseRow{it} serves both
    const bool leaf = i < 2 * ops.count;
    const int it = leaf ? i : i - 2 * ops.count;
    const BitwiseRow row{hi, lo, keys, out, inner, ops, ct_words, key_words, it,
                         W, NG, Td, sh.Lout};
    const int rank = (int)cooperative_groups::this_cluster().block_rank();
    if (!leaf && it < 2 * W * ops.count) {   // level 1: copy its leaf row's spectra
      const int s = (it >> 1) % ops.count * 2 + (it & 1);
      unit_wait(done + W * ops.count + s, sh.cs);
      const int4* src = reinterpret_cast<const int4*>(
          spectra + ((long long)s * FHE_P + rank % FHE_P) * sh.T * FOLD_N);
      int4* dst = reinterpret_cast<int4*>(smem);
      for (int q = threadIdx.x; q < sh.T * FOLD_N / 4; q += FOLD_THREADS) dst[q] = __ldcg(src + q);
      __syncthreads();
    } else {   // a leaf row's spectra into device memory, or a level-2 row's
      if (!leaf) unit_wait(done + (it - 2 * W * ops.count), 2 * sh.cs);
      if (!leaf || rank < FHE_P)
        cmux_forward<kBlocks>(
            row, leaf ? spectra + ((long long)it * FHE_P + rank) * sh.T * FOLD_N : smem,
            pending, smem, sh, c, tb);
    }
    if (leaf) {
      unit_arrive(done + W * ops.count + fresh(i));
      continue;
    }
    cmux_fold(row, pending, smem, sh, c, tb);
    const int it_ = fresh(i) - 2 * ops.count;
    if (it_ < 2 * W * ops.count) unit_arrive(done + (it_ >> 1));
  }
  if (pending) cluster_wait();   // no block leaves while another reads its R
}

static inline size_t bitwise_smem(const FoldShape& sh) {
  return (size_t)(sh.T + (sh.Lk > 3 ? sh.Lk : 3)) * FOLD_N * sizeof(uint32_t);
}

// The most clusters of sh.cs blocks of the instantiation `blocks` (2 or 1)
// that the device holds at once: the largest grid the launch may have.
extern "C" int fhe_bitwise_clusters(FoldShape sh, int blocks, int* clusters) {
  return max_active_clusters(blocks == 2 ? &bitwise_kernel<2> : &bitwise_kernel<1>, sh.cs,
                             bitwise_smem(sh), clusters);
}

// clusters: persistent clusters (at most fhe_bitwise_clusters and (3 W +
// 2) G); blocks: 2 or 1, the instantiation (registers a thread) the launch
// takes.
extern "C" int fhe_bitwise(const void* hi, const void* lo, const void* keys, void* out,
                           void* inner, void* spectra, void* done, int clusters, OpGroups ops,
                           int W, int NG, int Td, int blocks, FoldShape sh, FheConsts c,
                           FoldTables tb, void* stream) {
  return launch_clusters_as(true, blocks == 2 ? &bitwise_kernel<2> : &bitwise_kernel<1>,
                            clusters, sh.cs, bitwise_smem(sh), stream, (const int*)hi,
                            (const int*)lo, (const uint32_t*)keys, (int*)out, (int*)inner,
                            (uint32_t*)spectra, (unsigned*)done, ops, W, NG, Td, sh, c, tb);
}
