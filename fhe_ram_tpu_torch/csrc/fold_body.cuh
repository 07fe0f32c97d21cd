// The fold body of csrc/fold.cu, shared by the kernels built on it: the
// fold (kernels 2 and 5, fold.cu) and the pack merge (kernel 4,
// pack_merge.cu).  fold.cu's note sets out the design; this header holds its
// device functions: the Shoup and lazy arithmetic, the three register
// layouts and the swizzle of the exchange buffers, the radix-16 transforms
// (`forward` takes a loader of the digit poly's coefficients, `inverse`),
// the key products, the Garner and the Garner/fold/carry step over
// distributed shared memory (`garner_fold` takes the base to add as a
// functor), and the cluster launch.
#pragma once

#include "fhe_core.cuh"

#define FOLD_THREADS 256   // threads of a fold block: 16 coefficients each
#define FOLD_N 4096        // the ring degree the fold is wired for
#define FOLD_MAX_LK 8      // most key limbs (output polys of a component)

// The host's Shoup pairs (w, floor(w * 2^32 / p)), canonical w; per prime
// (pointers at prime 0, the primes back to back).
struct FoldTables {
  const uint2* fwd;      // [P][n] the DIF stage twiddles, laid out as fwd_tw
  const uint2* inv;      // [P][n] the DIT stage twiddles, laid out as inv_tw
  const uint2* psi_lo;   // [P][256] psi^j
  const uint2* psi_hi;   // [P][16] psi^(256 r)
  const uint2* ipsi_lo;  // [P][256] psi^-j / n
  const uint2* ipsi_hi;  // [P][16] psi^-(256 r)
  const uint2* garner;   // [3] p1^-1 mod p2, p1 mod p3, (p1 p2)^-1 mod p3
};

// x * w mod p in [0, 2p) for any x < 2^32, w = (w, w') a Shoup pair, w < p.
__device__ __forceinline__ uint32_t shoup(uint32_t x, uint2 w, uint32_t p) {
  return x * w.x - __umulhi(x, w.y) * p;
}

// [0, 2 * p2) -> [0, p2): one unsigned min (x - p2 wraps when x < p2).
__device__ __forceinline__ uint32_t lazy_sub(uint32_t x, uint32_t p2) {
  return min(x, x - p2);
}

// A table pair, loaded where it stands in the code: a row's twiddles must
// not be hoisted out of the row loop, where their registers would be held
// across both transform directions.
__device__ __forceinline__ uint2 ldg_pair(const uint2* a) {
  uint2 v;
  asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2];" : "=r"(v.x), "=r"(v.y) : "l"(a));
  return v;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// Coefficient held by thread t in register r in layout L (see the top):
// lay_t<L>(t) | lay_r<L>(r), two disjoint bit fields.
template <int L>
__device__ __forceinline__ int lay_t(int t) {
  return L == 0 ? t : L == 1 ? (t & 15) | ((t >> 4) << 8) : t << 4;
}

template <int L>
__device__ __forceinline__ constexpr int lay_r(int r) {
  return L == 0 ? r << 8 : L == 1 ? r << 4 : r;
}

// Word of an exchange buffer (or residue poly) that holds coefficient i:
// bits 0-3 XOR bits 5-8, bit 4 XOR bit 8.  In every layout the 32 lanes of
// a warp then hit 32 distinct banks for each r (tests/test_torch_kernels.py
// checks it, with the rest of this file's index arithmetic).  swz is linear
// over GF(2), so the word of (t, r) is swz(lay_t(t)) ^ swz(lay_r(r)): one
// XOR with a constant a register.
__device__ __forceinline__ constexpr int swz(int i) {
  return i ^ ((i >> 5) & 15) ^ ((i >> 4) & 16);
}

// v, copied where it stands: what the code derives from it (swizzled
// words, a prime's table pointers) is derived where it is used, not hoisted
// out of the row loop into registers held across both transform directions.
__device__ __forceinline__ int fresh(int v) {
  asm volatile("mov.b32 %0, %0;" : "+r"(v));
  return v;
}

// this thread's swizzled base word in layout L
template <int L>
__device__ __forceinline__ int swz_base() {
  return swz(lay_t<L>(fresh((int)threadIdx.x)));
}

// Write v in layout LA, barrier, read it back in layout LB.
template <int LA, int LB>
__device__ __forceinline__ void exchange(uint32_t v[16], uint32_t* buf) {
  const int a = swz_base<LA>();
#pragma unroll
  for (int r = 0; r < 16; ++r) buf[a ^ swz(lay_r<LA>(r))] = v[r];
  __syncthreads();
  const int b = swz_base<LB>();
#pragma unroll
  for (int r = 0; r < 16; ++r) v[r] = buf[b ^ swz(lay_r<LB>(r))];
}

// Four DIF stages on v (in [0, 2p), out [0, 2p)): stage s pairs registers r
// and r + (8 >> s); mul(x, s, rl) is x times the pair's twiddle, in [0, 2p),
// rl = r's bits below that distance.
template <class Mul>
__device__ __forceinline__ void dif16(uint32_t v[16], uint32_t p, const Mul& mul) {
  const uint32_t p2 = 2 * p;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int hb = 8 >> s;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      if (r & hb) continue;
      const uint32_t a = v[r], b = v[r + hb];
      v[r] = lazy_sub(a + b, p2);
      v[r + hb] = mul(a - b + p2, s, r & (hb - 1));
    }
  }
}

// Four DIT stages on v (in [0, 4p), out [0, 4p)): stage s pairs registers r
// and r + (1 << s); mul as in dif16 (x < 4p).
template <class Mul>
__device__ __forceinline__ void dit16(uint32_t v[16], uint32_t p, const Mul& mul) {
  const uint32_t p2 = 2 * p;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int hb = 1 << s;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      if (r & hb) continue;
      const uint32_t a = lazy_sub(v[r], p2);
      const uint32_t b = mul(v[r + hb], s, r & (hb - 1));
      v[r] = a + b;
      v[r + hb] = a - b + p2;
    }
  }
}

__device__ __forceinline__ uint32_t prime(const FheConsts& c, int pi) {
  return pi == 0 ? c.p[0] : pi == 1 ? c.p[1] : c.p[2];
}

// Forward transform of one digit poly into this thread's 16 spectrum words
// spec_t[r * 256 + t] (layout L2); load(i): the poly's coefficient i (any
// int32), called once for each of this thread's 16 coefficients of layout
// L0 before the first barrier; a and b: the exchange buffers, equal when
// only one is free.  own0[s]: this thread's pass-0 twiddle of rl = 0 at
// stage s (j = t), psi_t = psi^t.
template <int kBlocks, class Load>
__device__ __forceinline__ void forward(const Load& load, uint32_t* spec_t, uint32_t* a,
                                        uint32_t* b, const uint2 own0[4], uint2 psi_t,
                                        uint32_t p, const FoldTables& tb, int pi) {
  const int t = threadIdx.x;
  // at 128 registers (two blocks an SM) the table pointers are made here:
  // held across the row loop, they spilled
  if (kBlocks == 2) pi = fresh(pi);
  const uint2* fwd = tb.fwd + pi * FOLD_N;
  const uint32_t lift = ((0x80000000u + p - 1) / p) * p;   // int32 + lift >= 0
  uint32_t v[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int xv = load(t | lay_r<0>(r));
    const uint32_t u = xv < 0 ? (uint32_t)xv + lift : (uint32_t)xv;
    v[r] = shoup(shoup(u, ldg_pair(tb.psi_hi + pi * 16 + r), p), psi_t, p);
  }
  // stages 0-3 (h = 2048 .. 256, at 4096 - 2h): j = t | rl << 8, whose
  // twiddle is that of (t, 0) times that of (0, rl)
  dif16(v, p, [&](uint32_t x, int s, int rl) {
    if (rl) x = shoup(x, ldg_pair(fwd + 4096 - (4096 >> s) + (rl << 8)), p);
    return shoup(x, own0[s], p);
  });
  if (a == b) __syncthreads();   // the previous transform's last reads
  exchange<0, 1>(v, a);
  // stages 4-7 (h = 128 .. 16): j = (t & 15) | rl << 4
  const int j0 = t & 15;
  dif16(v, p, [&](uint32_t x, int s, int rl) {
    return shoup(x, ldg_pair(fwd + 4096 - (256 >> s) + (j0 | (rl << 4))), p);
  });
  if (a == b) __syncthreads();
  exchange<1, 2>(v, b);
  // stages 8-11 (h = 8 .. 1): j = rl, the same for every thread; j = 0 is 1
  dif16(v, p, [&](uint32_t x, int s, int rl) {
    return rl ? shoup(x, ldg_pair(fwd + 4096 - (16 >> s) + rl), p) : lazy_sub(x, 2 * p);
  });
#pragma unroll
  for (int r = 0; r < 16; ++r) spec_t[r * FOLD_THREADS + t] = v[r];
}

// v[r] = sum_t spec[t] * key[t] at coefficient (t << 4) | r (layout L2), in
// [0, 2p): 64-bit sums of T products (< 2^45), one Barrett reduction.
__device__ __forceinline__ void products(uint32_t v[16], const uint32_t* spec,
                                         const uint32_t* km, int T, long long tstride,
                                         uint32_t p, uint64_t mu64) {
  const int t = threadIdx.x;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint64_t acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0;
    for (int tt = 0; tt < T; ++tt) {
      const uint4* kq = reinterpret_cast<const uint4*>(km + tt * tstride + (t << 4) + 8 * h);
      const uint4 k0 = __ldg(kq), k1 = __ldg(kq + 1);
      const uint32_t kk[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
      const uint32_t* sp = spec + (tt * 16 + 8 * h) * FOLD_THREADS + t;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] += (uint64_t)sp[j * FOLD_THREADS] * kk[j];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[8 * h + j] = (uint32_t)acc[j] - (uint32_t)__umul64hi(acc[j], mu64) * p;
  }
}

// An output poly's inverse transform (v: its products, layout L2, [0, 4p)):
// exchanges through x and then y (equal when only one buffer is free), the
// canonical residues times psi^-i / n land in y in swizzled order.
// own2[s]: this thread's pass-2 twiddle of rl = 0 at stage s (j = t);
// ipsi_t = psi^-t / n.
__device__ __forceinline__ void inverse(uint32_t v[16], uint32_t* x, uint32_t* y,
                                        const uint2 own2[4], uint2 ipsi_t, uint32_t p,
                                        const FoldTables& tb, int pi) {
  const int t = threadIdx.x;
  const uint2* inv = tb.inv + pi * FOLD_N;
  // stages 0-3 (h = 1 .. 8, at h - 1): j = rl, the same for every thread
  dit16(v, p, [&](uint32_t w, int s, int rl) {
    return rl ? shoup(w, ldg_pair(inv + (1 << s) - 1 + rl), p) : lazy_sub(w, 2 * p);
  });
  exchange<2, 1>(v, x);
  // stages 4-7 (h = 16 .. 128): j = (t & 15) | rl << 4
  const int j0 = t & 15;
  dit16(v, p, [&](uint32_t w, int s, int rl) {
    return shoup(w, ldg_pair(inv + (16 << s) - 1 + (j0 | (rl << 4))), p);
  });
  if (x == y) __syncthreads();
  exchange<1, 0>(v, y);
  // stages 8-11 (h = 256 .. 2048): j = t | rl << 8, as in the forward pass 0
  dit16(v, p, [&](uint32_t w, int s, int rl) {
    if (rl) w = shoup(w, ldg_pair(inv + (256 << s) - 1 + (rl << 8)), p);
    return shoup(w, own2[s], p);
  });
  const int a = swz_base<0>();
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const uint32_t u =
        shoup(shoup(v[r], ldg_pair(tb.ipsi_hi + pi * 16 + r), p), ipsi_t, p);
    y[a ^ swz(lay_r<0>(r))] = lazy_sub(u, p);   // the words it read: no barrier
  }
}

// The Garner CRT of one coefficient's canonical residues: the balanced
// mixed-radix value v1 + p1 v2 + p1 p2 v3 (fhe_core.cuh fold_row's, with
// Shoup pairs for the three constants).
__device__ __forceinline__ long long garner(uint32_t r1, uint32_t r2, uint32_t r3,
                                            const FheConsts& c, const uint2 g[3]) {
  const uint32_t p1 = c.p[0], p2 = c.p[1], p3 = c.p[2];
  const int v1 = center(r1, p1);
  const int v2 = center(lazy_sub(shoup(r2 + 2 * p2 - v1, g[0], p2), p2), p2);
  const uint32_t tt = shoup((uint32_t)(v2 + (int)(2 * p3)), g[1], p3);   // [0, 2p3)
  const int v3 = center(lazy_sub(shoup(r3 + 4 * p3 - v1 - tt, g[2], p3), p3), p3);
  return (long long)v1 + (long long)p1 * v2 + (long long)p1 * p2 * v3;
}

// The Garner, digit split, limb fold and carry normalize of output
// component c2 over this block's share of the coefficients (a third, cut at
// multiples of 32 so that a warp's reads stay in one swizzle block); R_q:
// the residue polys of the group's block of prime q.  base(c2, l, i, at):
// what is added to limb l of coefficient i before the carry, at = the word
// (c2 * Lout + l) * n + i of the row.
template <class Base>
__device__ __forceinline__ void garner_fold(const uint32_t* R, int grp, int pi, int c2,
                                            int* out_row, const Base& base,
                                            const FoldShape& sh, const FheConsts& c,
                                            const FoldTables& tb) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const uint32_t* R0 = cluster.map_shared_rank(R, grp * FHE_P);
  const uint32_t* R1 = cluster.map_shared_rank(R, grp * FHE_P + 1);
  const uint32_t* R2 = cluster.map_shared_rank(R, grp * FHE_P + 2);
  const uint2 g[3] = {tb.garner[0], tb.garner[1], tb.garner[2]};
  const int Lk = sh.Lk, Lout = sh.Lout;
  const int i_per = (FOLD_N / FHE_P + 31) & ~31;
  const int i_hi = min(FOLD_N, (pi + 1) * i_per);
  for (int i = pi * i_per + threadIdx.x; i < i_hi; i += FOLD_THREADS) {
    const int si = swz(i);
    int accl[FHE_MAX_L];
#pragma unroll
    for (int l = 0; l < FHE_MAX_L; ++l) accl[l] = 0;
    // unrolled over lk, so that every limb index below is a constant
#pragma unroll
    for (int lk = 0; lk < FOLD_MAX_LK; ++lk) {
      if (lk < Lk) {
        long long xv = garner(R0[lk * FOLD_N + si], R1[lk * FOLD_N + si],
                              R2[lk * FOLD_N + si], c, g);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int dg = (int)((xv + 256) & 511) - 256;
          xv = (xv - dg) >> 9;
          const int e = 9 * k - 17 * (lk + 1);  // this digit has weight 2^e
          if (e < 0) {
            const int tl = (-e - 1) / 17;
            if (tl < FHE_MAX_L && tl < Lout) accl[tl] += dg * (1 << (e + 17 * (tl + 1)));
          }
        }
      }
    }
    int carry = 0;
#pragma unroll
    for (int l = FHE_MAX_L - 1; l >= 0; --l) {
      if (l < Lout) {
        const long long at = ((long long)c2 * Lout + l) * FOLD_N + i;
        int v = sh.sign < 0 ? -accl[l] : accl[l];
        v += base(c2, l, i, at);
        v += carry;
        const int dl = ((v + 65536) & 131071) - 65536;
        carry = (v - dl) >> 17;
        out_row[at] = dl;
      }
    }
  }
}

// Launch `kernel` as `clusters` thread block clusters of cs blocks of
// FOLD_THREADS threads with `smem` bytes of dynamic shared memory each.
template <class... Params, class... Args>
static int launch_clusters(void (*kernel)(Params...), int clusters, int cs, size_t smem,
                           void* stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)clusters * cs);
  cfg.blockDim = dim3(FOLD_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
