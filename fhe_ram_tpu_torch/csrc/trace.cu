// Kernel 3: the whole normalized-trace chain in one launch: S sequential
// steps ct <- normalize(ct + KS(sigma_g(ct))), sigma_g applied in the
// kernel, one prepared key per step, optional digit truncation.
//
// Replaces fhe_ram_tpu/ops/ntt_pallas.py: fused_trace_pallas.
//
// Bound on this card: bytes at the read's shapes (B = 4 rows in and out and
// S * P * T * M * 16 KB of keys: 2.35 us at 3.35 TB/s, against 2.25 us of
// operations at 67 Tera-op/s); latency in practice: the steps are
// sequential, and each is 3 * (T + M) transforms a row.
//
// Design: csrc/fold.cu's body (fold_body.cuh), as the pack merge
// (pack_merge.cu) takes it.  A row is a thread block cluster, one block a
// prime (or two groups of 3 that share the output components while the
// rows are few); 256 threads, 16 coefficients each, three radix-16 passes
// a transform; the residues of a component stay in shared memory and the
// Garner, digit split, limb fold and carry run over distributed shared
// memory; persistent clusters; two instantiations (two blocks an SM at 128
// registers, one at up to 255), picked by the wrapper (ops/ntt_cuda._fold_cs,
// _fold_blocks).  A row never needs another row, so the S steps loop inside
// the row: each is fold_body.cuh's trace_step (the digit poly staged in
// shared memory and gathered at sigma_g's words; the base ct + sigma_g(ct)
// added in the Garner step).  From step 1 on a step reads what the cluster
// wrote in the step before: every read of the row goes through L2, and
// the cluster barrier after each step's last Garner step (trace_step's
// `pending`, waited before the next staging) orders the two.  A step reads
// permuted positions of the row it replaces, so steps alternate between
// two buffers (`out` and `tmp`), arranged so that the last step writes
// `out`.  Shared memory: the T spectra and max(Lk, 3) residue polys (the
// third doubles as the staging buffer): 80 KB at T = 2, Lk = 3, 112 KB
// untruncated (T = 3, Lk = 4); nothing in device memory but the rows.
// Its predecessor, fold_row over TraceStepGlue (fhe_core.cuh) with the
// residues parked in a device scratch, is kept for timing in
// fhe_ram_tpu_torch/tools/trace_predecessor.cu.
#include "fold_body.cuh"

struct TraceSteps {
  int count;
  int ginv[FHE_MAX_STEPS];  // g_s^-1 mod 2n
};

// Step s of row r: reads ct (s = 0) or step s - 1's buffer, writes out or
// tmp (the last step out); key s.  Members copied from the kernel's
// parameters; what is derived from them is derived at each use.
struct ChainStep {
  const int* ct;
  int* out;
  int* tmp;
  const uint32_t* keys;
  const TraceSteps& steps;
  long long row_words, key_words;
  int r, s;
  __device__ __forceinline__ int* buffer(int k) const {
    return ((steps.count - 1 - k) & 1) ? tmp : out;
  }
  __device__ __forceinline__ const int* in() const {
    const int s_ = fresh(s);
    return (s_ == 0 ? ct : buffer(s_ - 1)) + fresh(r) * row_words;
  }
  __device__ __forceinline__ int ginv() const { return steps.ginv[fresh(s)]; }
  __device__ __forceinline__ const uint32_t* key(int pi) const {
    return keys + ((long long)fresh(s) * FHE_P + pi) * key_words;
  }
  __device__ __forceinline__ RowStore store() const {
    return RowStore{buffer(fresh(s)) + fresh(r) * row_words};
  }
};

// ct, out, tmp: int32[B, C2, L, n] (tmp unused when S = 1); keys:
// uint32[S, P, T, M, n] with T = rank * Td.  sh: fold.cu's shape argument
// (sign -1, mc not read).  kBlocks as in fold.cu.
template <int kBlocks>
__global__ void __launch_bounds__(FOLD_THREADS, kBlocks)
trace_kernel(const int* __restrict__ ct, const uint32_t* __restrict__ keys, int* out,
             int* tmp, int B, const __grid_constant__ TraceSteps steps, int Td,
             FoldShape sh, FheConsts c, FoldTables tb) {
  extern __shared__ uint32_t smem[];
  const long long row_words = (long long)sh.C2 * sh.Lout * FOLD_N;
  const long long key_words = (long long)sh.T * sh.M * FOLD_N;
  bool pending = false;   // arrived at "residues read", not yet waited
  for (int r = blockIdx.x / sh.cs; r < B; r += gridDim.x / sh.cs)
    for (int s = 0; s < steps.count; ++s)
      trace_step<kBlocks>(ChainStep{ct, out, tmp, keys, steps, row_words, key_words, r, s},
                          Td, pending, smem, sh, c, tb);
  if (pending) cluster_wait();   // no block leaves while another reads its R
}

// clusters: persistent clusters (at most B); blocks: 2 or 1, the
// instantiation (registers a thread) the launch takes.
extern "C" int fhe_trace(const void* ct, const void* keys, void* out, void* tmp, int B,
                         int clusters, TraceSteps steps, int Td, int blocks,
                         FoldShape sh, FheConsts c, FoldTables tb, void* stream) {
  const size_t smem = (size_t)(sh.T + (sh.Lk > 3 ? sh.Lk : 3)) * FOLD_N * sizeof(uint32_t);
  return launch_clusters(blocks == 2 ? &trace_kernel<2> : &trace_kernel<1>, clusters,
                         sh.cs, smem, stream, (const int*)ct, (const uint32_t*)keys,
                         (int*)out, (int*)tmp, B, steps, Td, sh, c, tb);
}
