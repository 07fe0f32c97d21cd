// Kernel 4: one pack-tree merge level with all glue inside:
//   u, v = A +- X^t B,   out = normalize(u + KS(sigma_g(v))).
//
// Replaces fhe_ram_tpu/ops/ntt_pallas.py: fused_pack_merge_pallas.
//
// Bound on this card: bytes at the read's shapes.  A row pair reads
// 2 * C2 * L * 16 KB and writes C2 * L * 16 KB against 3 * (T + M)
// transforms; at nb = 128, T = 2, M = 6 that is 11.4 us of bytes at an
// H100's 3.35 TB/s against 6.0 us of operations at 67 Tera-op/s.
//
// Design: csrc/fold.cu's body (fold_body.cuh), with the merge's glue in its
// loads.  A row pair is a thread block cluster, one block a prime (or two
// groups of 3 while the pairs are few); 256 threads, 16 coefficients each,
// three radix-16 passes a transform; the residues of a component stay in
// shared memory and the Garner, digit split, limb fold and carry run over
// distributed shared memory; persistent clusters; two instantiations (two
// blocks an SM at 128 registers, one at up to 255), picked by the wrapper
// (ops/ntt_cuda._fold_cs, _fold_blocks).  The glue:
//  * Digit poly tt = (mask component tt / Td, limb tt % Td) is sigma_g(v).
//    Each block first stages v = A - X^t B of that poly in a free 16 KB
//    buffer of its shared memory, in natural order: thread t loads
//    coefficients t + 256 r, so the loads of A and of the rotated B (a
//    shift with a sign flip at the wrap) stay coalesced.  forward()'s loads
//    then read v[sigma_src(i)] with sigma's sign: for 32 consecutive i the
//    words ginv * i mod n are 32 distinct banks, ginv being odd
//    (tests/test_torch_kernels.py emulates the staging and checks it).
//  * The base u + sigma_g(v) at the b component: in the Garner step each
//    block adds A[i] + (X^t B)[i] of its coefficients (coalesced) and, at
//    the b component only, sigma_g(v)[i], gathered from L2.
//  * Shared memory: the T spectra and max(Lk, 3) residue polys (the staging
//    buffer is the third, free while the digits are transformed):
//    (T + max(Lk, 3)) * 16 KB, 80 KB at T = 2, Lk = 3.  Nothing goes
//    to device memory but the output.
// Its predecessor, fold_row over MergeGlue (fhe_core.cuh, which kernel 8,
// pack_tree.cu, still runs) with the residues parked in a device scratch,
// is kept for timing in fhe_ram_tpu_torch/tools/pack_merge_predecessor.cu.
#include "fold_body.cuh"

// The base of the merge's carry at (c2, l, i): u = A + X^t B, plus
// sigma_g(v) at the b component; A, B: [C2, L, n] of this pair.
struct MergeBase {
  const int* A;
  const int* B;
  int t_rot, ginv, b_comp;
  __device__ __forceinline__ int operator()(int c2, int, int i, long long at) const {
    const int* a = A + (at - i);
    const int* b = B + (at - i);
    int u = __ldg(a + i) + rot_at(b, i, t_rot, FOLD_N);
    if (c2 == b_comp) {
      bool neg;
      const int src = sigma_src(i, ginv, FOLD_N, neg);
      const int v = __ldg(a + src) - rot_at(b, src, t_rot, FOLD_N);
      u += neg ? -v : v;
    }
    return u;
  }
};

// A, B, out: int32[nb, C2, L, n]; key: uint32[P, T, M, n] with T = rank *
// Td; t_rot in [0, 2n); ginv = g^-1 mod 2n.  sh: fold.cu's shape argument
// (sign -1, mc not read).  kBlocks as in fold.cu.
template <int kBlocks>
__global__ void __launch_bounds__(FOLD_THREADS, kBlocks)
pack_merge_kernel(const int* __restrict__ A, const int* __restrict__ B,
                  const uint32_t* __restrict__ key, int* out, int nb, int t_rot,
                  int ginv, int Td, FoldShape sh, FheConsts c, FoldTables tb) {
  extern __shared__ uint32_t smem[];
  const int t = threadIdx.x;
  const int rank = (int)cooperative_groups::this_cluster().block_rank();
  const int pi = rank % FHE_P, grp = rank / FHE_P;
  const int c2_per = sh.C2 / (sh.cs / FHE_P);
  const int T = sh.T, Lk = sh.Lk, L = sh.Lout;
  uint32_t* spec = smem;                    // [T][16][256], thread-private words
  uint32_t* R = smem + T * FOLD_N;          // [max(Lk, 3)][n] residues / exchange
  int* V = reinterpret_cast<int*>(R + 2 * FOLD_N);   // the staged v
  const uint32_t p = prime(c, pi);
  const int row_polys = sh.C2 * L;
  bool pending = false;   // arrived at "residues read", not yet waited
  for (int r = blockIdx.x / sh.cs; r < nb; r += gridDim.x / sh.cs) {
    // a row's pointers are made where they are used (fresh r): held across
    // the transforms, they spilled at 128 registers
    if (pending) {   // the cluster is done with R
      cluster_wait();
      pending = false;
    }
    uint2 own0[4];   // j = t at stages 0-3
#pragma unroll
    for (int s = 0; s < 4; ++s)
      own0[s] = ldg_pair(tb.fwd + pi * FOLD_N + 4096 - (4096 >> s) + t);
    const uint2 psi_t = ldg_pair(tb.psi_lo + pi * FOLD_THREADS + t);
    for (int tt = 0; tt < T; ++tt) {
      // every thread is past the previous forward's gathers: they precede
      // its first barrier
      const long long at = (long long)(fresh(r) * row_polys + (tt / Td) * L + tt % Td) * FOLD_N;
      // four loads of A and B in flight a thread: sixteen spilled at 128
      // registers
#pragma unroll 4
      for (int q = 0; q < 16; ++q) {
        const int j = t | lay_r<0>(q);
        V[j] = __ldg(A + at + j) - rot_at(B + at, j, t_rot, FOLD_N);
      }
      __syncthreads();
      forward<kBlocks>(
          [&](int i) {
            bool neg;
            const int v = V[sigma_src(i, ginv, FOLD_N, neg)];
            return neg ? -v : v;
          },
          spec + tt * 16 * FOLD_THREADS, R, R + FOLD_N, own0, psi_t, p, tb, pi);
    }
    __syncthreads();   // the last exchange's reads are done: R is free

    uint2 own2[4];   // j = t at stages 8-11
#pragma unroll
    for (int s = 0; s < 4; ++s)
      own2[s] = ldg_pair(tb.inv + pi * FOLD_N + (256 << s) - 1 + t);
    const uint2 ipsi_t = ldg_pair(tb.ipsi_lo + pi * FOLD_THREADS + t);
    const uint32_t* kp = key + (long long)pi * T * sh.M * FOLD_N;
    for (int c2 = grp * c2_per; c2 < (grp + 1) * c2_per; ++c2) {
      for (int lk = 0; lk < Lk; ++lk) {
        uint32_t v[16];
        products(v, spec, kp + (long long)(c2 * Lk + lk) * FOLD_N, T,
                 (long long)sh.M * FOLD_N, p,
                 pi == 0 ? c.mu64[0] : pi == 1 ? c.mu64[1] : c.mu64[2]);
        if (pending) {   // the previous component's residues are read
          cluster_wait();
          pending = false;
        }
        uint32_t* y = R + lk * FOLD_N;
        inverse(v, lk + 1 < Lk ? y + FOLD_N : y, y, own2, ipsi_t, p, tb, pi);
      }
      cluster_arrive();   // every block's residues of component c2 are in
      cluster_wait();
      const long long row = (long long)(fresh(r) * row_polys) * FOLD_N;
      garner_fold(R, grp, pi, c2, MergeBase{A + row, B + row, t_rot, ginv, sh.C2 - 1},
                  RowStore{out + row}, sh, c, tb);
      cluster_arrive();   // done reading the cluster's residues
      pending = true;
    }
  }
  if (pending) cluster_wait();   // no block leaves while another reads its R
}

// clusters: persistent clusters (at most nb); blocks: 2 or 1, the
// instantiation (registers a thread) the launch takes.
extern "C" int fhe_pack_merge(const void* A, const void* B, const void* key,
                              void* out, int nb, int clusters, int t_rot, int ginv,
                              int Td, int blocks, FoldShape sh, FheConsts c,
                              FoldTables tb, void* stream) {
  const size_t smem = (size_t)(sh.T + (sh.Lk > 3 ? sh.Lk : 3)) * FOLD_N * sizeof(uint32_t);
  return launch_clusters(blocks == 2 ? &pack_merge_kernel<2> : &pack_merge_kernel<1>,
                         clusters, sh.cs, smem, stream, (const int*)A, (const int*)B,
                         (const uint32_t*)key, (int*)out, nb, t_rot, ginv, Td, sh, c,
                         tb);
}
