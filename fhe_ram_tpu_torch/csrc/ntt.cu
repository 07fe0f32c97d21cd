// Kernel 1: batched negacyclic NTT over the three CRT primes, forward and
// inverse.
//
// Replaces fhe_ram_tpu/ops/ntt_pallas.py: ntt_fwd_pallas / ntt_inv_pallas.
//
// Bound on this card: operations.  A transform moves 16 KB in and 16 KB
// out per (polynomial, prime) but does 12 * 2048 modular butterflies on
// it, each a 32x32->64 multiply plus an integer Barrett quotient; at the
// card's memory rate the bytes take ~10 ns, the butterflies far longer.
// Design: one block per (polynomial, prime); the 4096 coefficients stay
// in 16 KB of shared memory for all twelve radix-2 stages (one barrier a
// stage), twiddles come from a per-prime table through the read-only
// cache, psi^k is folded into the load and psi^-k / n into the store.
// Device memory is touched once on the way in and once on the way out.
#include "fhe_core.cuh"

// x: int32[B, n] -> out: uint32[P, B, n], canonical, bit-reversed order.
__global__ void __launch_bounds__(FHE_THREADS)
ntt_fwd_kernel(const int* __restrict__ x, uint32_t* __restrict__ out, int B,
               FheConsts c, FheTables tb) {
  extern __shared__ uint32_t smem[];
  const int n = 1 << c.log_n;
  const int b = blockIdx.x, pi = blockIdx.y;
  const uint32_t p = c.p[pi], mu40 = c.mu40[pi];
  const uint64_t mu64 = c.mu64[pi];
  const int* src = x + (long long)b * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    smem[i] = mulmod(lift(src[i], p, mu64), __ldg(tb.psi + pi * n + i), p, mu40);
  ntt_fwd_smem(smem, 1, c.log_n, tb.fwd_tw + pi * n, p, mu40);
  uint32_t* dst = out + ((long long)pi * B + b) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = smem[i];
}

// x: int32[P, B, n] residues (any representative) -> out: int32[P, B, n],
// centered residues of the convolution, natural order.
__global__ void __launch_bounds__(FHE_THREADS)
ntt_inv_kernel(const int* __restrict__ x, int* __restrict__ out, int B,
               FheConsts c, FheTables tb) {
  extern __shared__ uint32_t smem[];
  const int n = 1 << c.log_n;
  const int b = blockIdx.x, pi = blockIdx.y;
  const uint32_t p = c.p[pi], mu40 = c.mu40[pi];
  const uint64_t mu64 = c.mu64[pi];
  const long long row = ((long long)pi * B + b) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    smem[i] = lift(x[row + i], p, mu64);
  ntt_inv_smem(smem, 1, c.log_n, tb.inv_tw + pi * n, p, mu40);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    out[row + i] =
        center(mulmod(smem[i], __ldg(tb.inv_psi + pi * n + i), p, mu40), p);
}

extern "C" int fhe_ntt_fwd(const void* x, void* out, int B, FheConsts c,
                           FheTables tb, void* stream) {
  dim3 grid(B, FHE_P);
  const size_t smem = sizeof(uint32_t) << c.log_n;
  ntt_fwd_kernel<<<grid, FHE_THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)x, (uint32_t*)out, B, c, tb);
  return (int)cudaGetLastError();
}

extern "C" int fhe_ntt_inv(const void* x, void* out, int B, FheConsts c,
                           FheTables tb, void* stream) {
  dim3 grid(B, FHE_P);
  const size_t smem = sizeof(uint32_t) << c.log_n;
  ntt_inv_kernel<<<grid, FHE_THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)x, (int*)out, B, c, tb);
  return (int)cudaGetLastError();
}
