// Kernel 10: a whole GLWE blind-rotation CMux chain in one launch: S
// sequential steps rows <- normalize(rows + (X^t_s rows - rows) x GGSW_s),
// one prepared bit GGSW and one static rotation per step, optional digit
// truncation (the top Td limbs of the difference are the digits).
//
// Replaces fhe_ram_tpu/ops/ntt_pallas.py: fused_blind_rotate_pallas.
//
// Bound on this card: latency.  The VM launches it with 1 row (select_rd:
// S = 5, T = 4, M = 6; select_store: S = 4, T = 6, M = 8) and 6 rows (the
// pointer conversion: S = 12 and 6, T = 8, M = 10), the steps sequential,
// 3 * (T + M) transforms a row a step.  Bytes: the rows in and out once,
// S * P * T * M * 16 KB of keys (1.8 us at select_rd against 0.3 us of
// operations).
//
// Design: csrc/fold.cu's body (fold_body.cuh), as the trace (trace.cu)
// takes it.  A row is a thread block cluster, one block a prime (or two
// groups of 3 that share the output components while the rows are few:
// ops/ntt_cuda._fold_cs); 256 threads, 16 coefficients each, three
// radix-16 passes a transform; the residues of a component stay in shared
// memory and the Garner, digit split, limb fold and carry run over
// distributed shared memory; persistent clusters; two instantiations (two
// blocks an SM at 128 registers, one at up to 255), picked by the wrapper
// (_fold_blocks).  A row never needs another row, so the S steps loop
// inside the row: each is fold_body.cuh's cmux_step.  X^t is index
// arithmetic with a sign flip on the loads: each block stages the source
// limb ct[c, l] of digit poly tt in shared memory (16-byte loads through
// L2, coalesced), and forward() reads +-ct[(i - t) mod n] - ct[i] from it,
// two words a coefficient, each warp's 32 consecutive words of 32 banks
// (one break at the wrap); no table, no rotated copy in device memory (two
// L2 loads a coefficient in forward() were slower and spilled at 128
// registers).  From step 1 on a step reads what the cluster
// wrote in the step before: every read of the row goes through L2, and the
// cluster barrier after each step's last Garner step (cmux_step's
// `pending`, waited before the next step's first load) orders the two.  A
// step reads rotated positions of the row it replaces, so steps alternate
// between two buffers (`out` and `tmp`), arranged so that the last step
// writes `out`.  Shared memory: the T spectra and max(Lk, 3) residue polys
// (the third doubles as the staging buffer), 112 KB at select_rd (T = 4,
// Lk = 3), 160 KB at select_store (6, 4), 208 KB at the conversion (8, 5):
// one block an SM at the VM's shapes; nothing in device memory but the
// rows.
// Its predecessor, fold_row over RotateCmuxGlue (fhe_core.cuh) with the
// residues parked in a device scratch, is kept for timing in
// fhe_ram_tpu_torch/tools/blind_rotate_predecessor.cu.
#include "fold_body.cuh"

struct RotSteps {
  int count;
  int rot[FHE_MAX_STEPS];  // t_s mod 2n
};

// Digit poly (X^t ct - ct)[c, l] of a step, t in [0, 2n): ct[c, l] is
// staged (read through L2), and the digit at i is +-V[(i - t) mod n] -
// V[i], the sign flipped where the index wraps XOR t >= n.
struct RotDigits {
  const int4* poly;   // ct[c, l]
  int rot;
  __device__ __forceinline__ int4 unit(int q) const { return __ldcg(poly + q); }
  __device__ __forceinline__ int operator()(const int* V, int i) const {
    const int kk = rot & (FOLD_N - 1);
    int v = i < kk ? -V[FOLD_N - kk + i] : V[i - kk];
    if (rot >= FOLD_N) v = -v;
    return v - V[i];
  }
};

// Step s of row r: reads rows (s = 0) or step s - 1's buffer, writes out or
// tmp (the last step out); key s.  Members copied from the kernel's
// parameters; what is derived from them is derived at each use.
struct RotStep {
  const int* rows;
  int* out;
  int* tmp;
  const uint32_t* keys;
  const RotSteps& steps;
  long long row_words, key_words;
  int r, s, Td, L;
  __device__ __forceinline__ int* buffer(int k) const {
    return ((steps.count - 1 - k) & 1) ? tmp : out;
  }
  __device__ __forceinline__ const int* in() const {
    const int s_ = fresh(s);
    return (s_ == 0 ? rows : buffer(s_ - 1)) + fresh(r) * row_words;
  }
  __device__ __forceinline__ RotDigits digits(int tt) const {
    return RotDigits{reinterpret_cast<const int4*>(in() + ((tt / Td) * L + tt % Td) * FOLD_N),
                     steps.rot[fresh(s)]};
  }
  __device__ __forceinline__ RowBase base() const { return RowBase{in()}; }
  __device__ __forceinline__ const uint32_t* key(int pi) const {
    return keys + ((long long)fresh(s) * FHE_P + pi) * key_words;
  }
  __device__ __forceinline__ RowStore store() const {
    return RowStore{buffer(fresh(s)) + fresh(r) * row_words};
  }
};

// rows, out, tmp: int32[B, C2, L, n], 16-byte aligned (tmp unused when S =
// 1); keys:
// uint32[S, P, T, M, n] with T = C2 * Td.  sh: fold.cu's shape argument
// (sign +1, mc not read).  kBlocks as in fold.cu.
template <int kBlocks>
__global__ void __launch_bounds__(FOLD_THREADS, kBlocks)
blind_rotate_kernel(const int* __restrict__ rows, const uint32_t* __restrict__ keys,
                    int* out, int* tmp, int B, const __grid_constant__ RotSteps steps,
                    int Td, FoldShape sh, FheConsts c, FoldTables tb) {
  extern __shared__ uint32_t smem[];
  const long long row_words = (long long)sh.C2 * sh.Lout * FOLD_N;
  const long long key_words = (long long)sh.T * sh.M * FOLD_N;
  bool pending = false;   // arrived at "residues read", not yet waited
  for (int r = blockIdx.x / sh.cs; r < B; r += gridDim.x / sh.cs)
    for (int s = 0; s < steps.count; ++s)
      cmux_step<kBlocks>(
          RotStep{rows, out, tmp, keys, steps, row_words, key_words, r, s, Td, sh.Lout},
          pending, smem, sh, c, tb);
  if (pending) cluster_wait();   // no block leaves while another reads its R
}

// clusters: persistent clusters (at most B); blocks: 2 or 1, the
// instantiation (registers a thread) the launch takes.
extern "C" int fhe_blind_rotate(const void* rows, const void* keys, void* out, void* tmp,
                                int B, int clusters, RotSteps steps, int Td, int blocks,
                                FoldShape sh, FheConsts c, FoldTables tb, void* stream) {
  const size_t smem = (size_t)(sh.T + (sh.Lk > 3 ? sh.Lk : 3)) * FOLD_N * sizeof(uint32_t);
  return launch_clusters(blocks == 2 ? &blind_rotate_kernel<2> : &blind_rotate_kernel<1>,
                         clusters, sh.cs, smem, stream, (const int*)rows,
                         (const uint32_t*)keys, (int*)out, (int*)tmp, B, steps, Td, sh, c,
                         tb);
}
