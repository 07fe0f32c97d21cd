// Kernel 1: batched negacyclic NTT over the three CRT primes, forward and
// inverse.
//
// Replaces fhe_ram_tpu/ops/ntt_pallas.py: ntt_fwd_pallas / ntt_inv_pallas,
// both of the JAX package's bodies (the MXU one and the FHERAM_MXU=0
// kernels _fwd_kernel / _inv_kernel compute the same integers).
//
// Bound on this card: bytes.  A (polynomial, prime) moves 16 KB in and 16
// KB out (the forward reads its polynomial once for all three primes)
// against 12 * 2048 butterflies of a few operations each; at 3.35 TB/s
// and 67 Tera-op/s the bytes take the longer.
//
// Design: the radix-16 register transforms of the fold body (fold_body.cuh
// forward_regs / inverse, the transforms of every kernel on it), one
// (polynomial, prime) item a block of 256 threads, 16 coefficients a thread
// in registers, three passes of four radix-2 stages with two
// shared-memory exchanges (two 16 KB buffers), Shoup constants, lazy
// butterflies; blocks are independent (no cluster, no Garner step; blocks
// walking several items gained nothing on an H100), and consecutive blocks
// share a polynomial, so its three primes' loads meet in L2.  Two
// instantiations, four blocks an SM (64 registers a thread) and two (up to
// 128), neither spilling: the wrapper takes the second while the items fit
// the card at two blocks an SM (ops/ntt_cuda._launch_ntt).  The stages are
// the radix-2 body's, so the integers are:
//  * forward: the int32 poly loaded in layout L0 (thread t the
//    coefficients t + 256 r: coalesced), lifted and twisted by psi^i in
//    forward_regs, a last lazy_sub to canonical, and this thread's 16
//    words of layout L2 stored at (t << 4) | r as four 16-byte stores:
//    kernel 1's bit-reversed order, the order the fold's spectral input
//    reads (fold.cu).
//  * inverse: the same 16 words loaded 16 bytes at a time, any int32
//    representative reduced to [0, 2p) (a lift, then a Shoup product by
//    1), inverse() (its residues times psi^-i / n, canonical, land in the
//    second buffer in swizzled order), then read back and stored centered
//    in natural order, coalesced (a warp's reads hit 32 banks).
// One build serves the radix-2 and the two-pass contexts with the same
// integers, as fold.cu and external.cu do.  Its predecessor, ntt_fwd_body / ntt_inv_body of
// fhe_core.cuh over 4096 words in shared memory (one barrier a radix-2
// stage, or three with -DFHE_NTT_TWO_PASS), is kept for timing in
// fhe_ram_tpu_torch/tools/ntt_predecessor.cu.
#include "fold_body.cuh"

// x: int32[B, n] -> out: uint32[P, B, n], canonical, bit-reversed order;
// out 16-byte aligned.  Block i: prime i % 3 of poly i / 3.  kBlocks: the
// blocks an SM the instantiation budgets registers for.
template <int kBlocks>
__global__ void __launch_bounds__(FOLD_THREADS, kBlocks)
ntt_fwd_kernel(const int* __restrict__ x, uint32_t* __restrict__ out, int B, FheConsts c,
               FoldTables tb) {
  extern __shared__ uint32_t smem[];   // two exchange buffers
  const int t = threadIdx.x;
  const int pi = blockIdx.x % FHE_P, b = blockIdx.x / FHE_P;
  const uint32_t p = prime(c, pi);
  uint2 own0[4];   // j = t at stages 0-3
#pragma unroll
  for (int s = 0; s < 4; ++s)
    own0[s] = ldg_pair(tb.fwd + pi * FOLD_N + 4096 - (4096 >> s) + t);
  const uint2 psi_t = ldg_pair(tb.psi_lo + pi * FOLD_THREADS + t);
  const int* src = x + (long long)b * FOLD_N;
  uint32_t v[16];
  forward_regs<kBlocks>([&](int i) { return __ldg(src + i); }, v, smem, smem + FOLD_N, own0,
                        psi_t, p, tb, pi);
  uint4* dst = reinterpret_cast<uint4*>(out + ((long long)pi * B + b) * FOLD_N + (t << 4));
#pragma unroll
  for (int k = 0; k < 4; ++k)
    dst[k] = make_uint4(lazy_sub(v[4 * k], p), lazy_sub(v[4 * k + 1], p),
                        lazy_sub(v[4 * k + 2], p), lazy_sub(v[4 * k + 3], p));
}

// x: int32[P, B, n] residues (any representative), 16-byte aligned ->
// out: int32[P, B, n], centered residues of the convolution, natural order.
// Blocks as in ntt_fwd_kernel.
template <int kBlocks>
__global__ void __launch_bounds__(FOLD_THREADS, kBlocks)
ntt_inv_kernel(const int* __restrict__ x, int* __restrict__ out, int B, FheConsts c,
               FoldTables tb) {
  extern __shared__ uint32_t smem[];   // two exchange buffers
  const int t = threadIdx.x;
  const int pi = blockIdx.x % FHE_P;
  const long long row = ((long long)pi * B + blockIdx.x / FHE_P) * FOLD_N;
  const uint32_t p = prime(c, pi);
  const uint32_t lift = ((0x80000000u + p - 1) / p) * p;   // int32 + lift >= 0
  // the Shoup pair of 1 (floor(2^40 / p) >> 8 = floor(2^32 / p)): x mod p in
  // [0, 2p) for any x < 2^32
  const uint32_t mu40 = pi == 0 ? c.mu40[0] : pi == 1 ? c.mu40[1] : c.mu40[2];
  const uint2 one = make_uint2(1u, mu40 >> 8);
  const int4* src = reinterpret_cast<const int4*>(x + row + (t << 4));
  uint32_t v[16];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int4 w = __ldg(src + k);
    const int e[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[4 * k + j] = shoup(e[j] < 0 ? (uint32_t)e[j] + lift : (uint32_t)e[j], one, p);
  }
  uint2 own2[4];   // j = t at stages 8-11
#pragma unroll
  for (int s = 0; s < 4; ++s)
    own2[s] = ldg_pair(tb.inv + pi * FOLD_N + (256 << s) - 1 + t);
  const uint2 ipsi_t = ldg_pair(tb.ipsi_lo + pi * FOLD_THREADS + t);
  uint32_t* y = smem + FOLD_N;
  inverse(v, smem, y, own2, ipsi_t, p, tb, pi);
  __syncthreads();   // every thread's residues are in y
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int i = t + k * FOLD_THREADS;
    out[row + i] = center(y[swz(i)], p);
  }
}

static const size_t kNttSmem = 2 * FOLD_N * sizeof(uint32_t);

// 3 B blocks, one a (poly, prime); blocks: 4 or 2, the instantiation
// (blocks an SM its registers are budgeted for).
extern "C" int fhe_ntt_fwd(const void* x, void* out, int B, int blocks, FheConsts c,
                           FoldTables tb, void* stream) {
  auto kernel = blocks == 4 ? &ntt_fwd_kernel<4> : &ntt_fwd_kernel<2>;
  kernel<<<FHE_P * B, FOLD_THREADS, kNttSmem, (cudaStream_t)stream>>>((const int*)x,
                                                                      (uint32_t*)out, B, c, tb);
  return (int)cudaGetLastError();
}

extern "C" int fhe_ntt_inv(const void* x, void* out, int B, int blocks, FheConsts c,
                           FoldTables tb, void* stream) {
  auto kernel = blocks == 4 ? &ntt_inv_kernel<4> : &ntt_inv_kernel<2>;
  kernel<<<FHE_P * B, FOLD_THREADS, kNttSmem, (cudaStream_t)stream>>>((const int*)x,
                                                                      (int*)out, B, c, tb);
  return (int)cudaGetLastError();
}
