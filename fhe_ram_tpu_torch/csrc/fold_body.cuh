// The fold body of csrc/fold.cu, shared by the kernels built on it: the
// fold (kernels 2 and 5, fold.cu), the pack merge (kernel 4,
// pack_merge.cu), the trace chain (kernel 3, trace.cu), the split level
// (kernel 6, split.cu), the split tree (kernel 7, split_tree.cu), the pack
// tree (kernel 8, pack_tree.cu), the bitwise group (kernel 9, bitwise.cu),
// the blind rotation (kernel 10, blind_rotate.cu), the carry-DP chain
// (kernel 11, dp_chain.cu) and the NTT (kernel 1, ntt.cu: the transforms
// alone).  fold.cu's note sets out the design; this header holds its
// device functions: the Shoup and lazy arithmetic, the three register
// layouts and the swizzle of the exchange buffers, the radix-16 transforms
// (`forward_regs` / `forward` take a loader of the digit poly's
// coefficients, `inverse`), the key products, the Garner and the
// Garner/fold/carry step over distributed shared memory (`garner_fold`
// takes the base to add and what to do with each normalized limb as
// functors), one trace step of a row (`trace_step`, which kernels 3, 6 and
// 7 share), the pack merges a cluster walks (`merge_rows`, which kernels 4
// and 8 share), one CMux step of a row (`cmux_step`, which kernels 9, 10
// and 11 share), a barrier over the clusters of a co-resident launch
// (`OpBarrier`), the per-row device counters of kernels 8 and 9
// (`unit_arrive`, `unit_wait`), and the cluster launches.
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

// Forward transform of one digit poly into this thread's 16 registers v[r]
// = coefficient (t << 4) | r of the spectrum (layout L2), in [0, 2p);
// load(i): the poly's coefficient i (any int32), called once for each of
// this thread's 16 coefficients of layout L0 before the first barrier; a
// and b: the exchange buffers, equal when only one is free.  own0[s]: this
// thread's pass-0 twiddle of rl = 0 at stage s (j = t), psi_t = psi^t.
template <int kBlocks, class Load>
__device__ __forceinline__ void forward_regs(const Load& load, uint32_t v[16], uint32_t* a,
                                             uint32_t* b, const uint2 own0[4], uint2 psi_t,
                                             uint32_t p, const FoldTables& tb, int pi) {
  const int t = threadIdx.x;
  // at 128 registers (two blocks an SM) the table pointers are made here:
  // held across the row loop, they spilled
  if (kBlocks == 2) pi = fresh(pi);
  const uint2* fwd = tb.fwd + pi * FOLD_N;
  const uint32_t lift = ((0x80000000u + p - 1) / p) * p;   // int32 + lift >= 0
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
}

// forward_regs into this thread's 16 spectrum words spec_t[r * 256 + t] of
// shared memory (what the key products read).
template <int kBlocks, class Load>
__device__ __forceinline__ void forward(const Load& load, uint32_t* spec_t, uint32_t* a,
                                        uint32_t* b, const uint2 own0[4], uint2 psi_t,
                                        uint32_t p, const FoldTables& tb, int pi) {
  const int t = threadIdx.x;
  uint32_t v[16];
  forward_regs<kBlocks>(load, v, a, b, own0, psi_t, p, tb, pi);
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
// (c2 * Lout + l) * n + i of the row.  store(c2, l, i, at, dl, carry): what
// becomes of the normalized limb dl; the limbs of a coefficient come from
// l = Lout - 1 down to 0, and `carry`, 0 before the first, is the hook's
// own from one limb to the next.
template <class Base, class Store>
__device__ __forceinline__ void garner_fold(const uint32_t* R, int grp, int pi, int c2,
                                            const Base& base, const Store& store,
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
    int carry = 0, hook_carry = 0;
#pragma unroll
    for (int l = FHE_MAX_L - 1; l >= 0; --l) {
      if (l < Lout) {
        const long long at = ((long long)c2 * Lout + l) * FOLD_N + i;
        int v = sh.sign < 0 ? -accl[l] : accl[l];
        v += base(c2, l, i, at);
        v += carry;
        const int dl = ((v + 65536) & 131071) - 65536;
        carry = (v - dl) >> 17;
        store(c2, l, i, at, dl, hook_carry);
      }
    }
  }
}

// The store of the fold, the merge and the trace: limb l of coefficient i
// to its word of the output row.
struct RowStore {
  int* out_row;
  __device__ __forceinline__ void operator()(int, int, int, long long at, int dl,
                                             int&) const {
    out_row[at] = dl;
  }
};

// The base of a trace step's carry at (c2, l, i): ct, plus sigma_g(ct) at
// the b component, gathered from L2 (ct may be what an earlier step of the
// same launch wrote).
struct TraceBase {
  const int* ct;   // [C2, L, n] of the row
  int ginv, b_comp;
  __device__ __forceinline__ int operator()(int c2, int, int i, long long at) const {
    const int* a = ct + (at - i);
    int u = __ldcg(a + i);
    if (c2 == b_comp) {
      bool neg;
      const int src = sigma_src(i, ginv, FOLD_N, neg);
      const int v = __ldcg(a + src);
      u += neg ? -v : v;
    }
    return u;
  }
};

// The store of a split level's Garner step (kernels 6 and 7): child0's limb
// as it comes, and child1 = normalize(X^-t (2x - child0))'s, carried from
// limb to limb of the coefficient, at its rotated word.  x, c0, c1: [C2, L,
// n] of the row, not overlapping; t_back = 2n - t in [0, 2n).
struct SplitStore {
  const int* x;
  int* c0;
  int* c1;
  int t_back;
  __device__ __forceinline__ void operator()(int, int, int i, long long at, int dl,
                                             int& carry) const {
    c0[at] = dl;
    const int kk = t_back & (FOLD_N - 1);
    const bool wrap = i + kk >= FOLD_N;
    int v = 2 * __ldcg(x + at) - dl;
    if (wrap != (t_back >= FOLD_N)) v = -v;
    v += carry;
    const int d = ((v + 65536) & 131071) - 65536;
    carry = (v - d) >> 17;
    c1[at + (wrap ? kk - FOLD_N : kk)] = d;
  }
};

// One trace step on a row, this block's part of it:
//   normalize(ct + KS(sigma_g(ct))),  ct = st.in() [C2, L, n],
// the digits the top Td limbs of sigma_g(ct)'s mask components (T = rank *
// Td), sign -1.  st supplies, each made where it is used (held across the
// transforms, pointers spill at 128 registers):
//   const int* in()            the row's input, read through L2 only
//   int ginv()                 g^-1 mod 2n
//   const uint32_t* key(pi)    prime pi's key rows, uint32[T, M, n]
//   store()                    garner_fold's store hook for the output
// Each block stages digit poly tt = (mask component tt / Td, limb tt % Td)
// of ct in the third residue poly, free while the digits are transformed,
// in natural order (16-byte loads, coalesced); forward() then gathers
// V[sigma_src(i)] with sigma's sign: g^-1 is odd, so a warp's 32 gathers
// hit 32 banks.  pending: as in the merge, this block has arrived at
// "residues read" and not yet waited; the wait before the staging is also
// the barrier after the previous step, whose output the cluster wrote.
// The merge keeps its own loop of the same shape (merge_rows): run through
// this function (its staging and base as hooks) it was slower on an H100,
// at every shape timed.
template <int kBlocks, class Step>
__device__ __forceinline__ void trace_step(const Step& st, int Td, bool& pending,
                                           uint32_t* smem, const FoldShape& sh,
                                           const FheConsts& c, const FoldTables& tb) {
  const int t = threadIdx.x;
  const int rank = (int)cooperative_groups::this_cluster().block_rank();
  const int pi = rank % FHE_P, grp = rank / FHE_P;
  const int c2_per = sh.C2 / (sh.cs / FHE_P);
  const int T = sh.T, Lk = sh.Lk, L = sh.Lout;
  uint32_t* spec = smem;                    // [T][16][256], thread-private words
  uint32_t* R = smem + T * FOLD_N;          // [max(Lk, 3)][n] residues / exchange
  int4* V = reinterpret_cast<int4*>(R + 2 * FOLD_N);   // the staged digit poly
  const uint32_t p = prime(c, pi);
  if (pending) {   // the cluster is done with R and has written in()
    cluster_wait();
    pending = false;
  }
  uint2 own0[4];   // j = t at stages 0-3
#pragma unroll
  for (int s = 0; s < 4; ++s)
    own0[s] = ldg_pair(tb.fwd + pi * FOLD_N + 4096 - (4096 >> s) + t);
  const uint2 psi_t = ldg_pair(tb.psi_lo + pi * FOLD_THREADS + t);
  for (int tt = 0; tt < T; ++tt) {
    // every thread is past the previous forward's gathers: they precede its
    // first barrier
    const int4* src = reinterpret_cast<const int4*>(
        st.in() + ((tt / Td) * L + tt % Td) * FOLD_N);
#pragma unroll
    for (int q = 0; q < FOLD_N / 4 / FOLD_THREADS; ++q)
      V[t + q * FOLD_THREADS] = __ldcg(src + t + q * FOLD_THREADS);
    __syncthreads();
    const int* Vw = reinterpret_cast<const int*>(V);
    const int ginv = st.ginv();
    forward<kBlocks>(
        [&](int i) {
          bool neg;
          const int v = Vw[sigma_src(i, ginv, FOLD_N, neg)];
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
  for (int c2 = grp * c2_per; c2 < (grp + 1) * c2_per; ++c2) {
    for (int lk = 0; lk < Lk; ++lk) {
      uint32_t v[16];
      products(v, spec, st.key(pi) + (long long)(c2 * Lk + lk) * FOLD_N, T,
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
    garner_fold(R, grp, pi, c2, TraceBase{st.in(), st.ginv(), sh.C2 - 1}, st.store(), sh,
                c, tb);
    cluster_arrive();   // done reading the cluster's residues, done writing
    pending = true;     // this component of the output
  }
}

// A word of a row a merge reads: through the read-only path (__ldg) where
// no block of the launch writes the row (kernel 4), through L2 (__ldcg)
// where an earlier level of the same launch wrote it (kernel 8).
template <bool kL2>
__device__ __forceinline__ int ld_row(const int* a) {
  return kL2 ? __ldcg(a) : __ldg(a);
}

// (X^k b)[j] of a poly b of such a row, 0 <= k < 2n: fhe_core.cuh rot_at,
// through L2 for kernel 8.
template <bool kL2>
__device__ __forceinline__ int rot_row(const int* b, int j, int k) {
  if (!kL2) return rot_at(b, j, k, FOLD_N);
  const int kk = k & (FOLD_N - 1);
  const int v = j < kk ? -__ldcg(b + FOLD_N - kk + j) : __ldcg(b + j - kk);
  return k >= FOLD_N ? -v : v;
}

// The base of a merge's carry at (c2, l, i): u = A + X^t B, plus
// sigma_g(v) at the b component; A, B: [C2, L, n] of the pair.
template <bool kL2>
struct MergeBase {
  const int* A;
  const int* B;
  int t_rot, ginv, b_comp;
  __device__ __forceinline__ int operator()(int c2, int, int i, long long at) const {
    const int* a = A + (at - i);
    const int* b = B + (at - i);
    int u = ld_row<kL2>(a + i) + rot_row<kL2>(b, i, t_rot);
    if (c2 == b_comp) {
      bool neg;
      const int src = sigma_src(i, ginv, FOLD_N, neg);
      const int v = ld_row<kL2>(a + src) - rot_row<kL2>(b, src, t_rot);
      u += neg ? -v : v;
    }
    return u;
  }
};

// The pack-tree merges a block's cluster walks, this block's part of each:
//   out = normalize(u + KS(sigma_g(v))),  u, v = A +- X^t B,
// rows [C2, L, n] (limbs up to 2^17: a tree's first level takes the
// pre-scaled, unnormalized leaves), the digits the top Td limbs of
// sigma_g(v)'s mask components (T = rank * Td), sign -1; the items r,
// r + clusters, ... below `items`.  The arguments are kernel 4's own (one
// level: row pair r is row r of A, B and out, one key, one t and g), and
// the walk w maps them to item r's through its handle it = w.item(r),
// made once an item:
//   wait(it), arrive(it)             before and after the item
//   row(it)                          the row of the buffers it reads and
//                                    writes, made where it is used (fresh)
//   a(it, A), b(it, B), dst(it, out) the buffers of its rows and its output
//   keys(it, key)                    prime 0's key rows, uint32[P, T, M, n]
//   t_rot(it, t), ginv(it, g)        t in [0, 2n), g^-1 mod 2n
// kernel 4's walk returns what it is given (pack_merge.cu PairRows), kernel
// 8's the level's (pack_tree.cu TreeRows).  Each block stages digit poly tt
// = (mask component tt / Td, limb tt % Td) of v = A - X^t B in the third
// residue poly, free while the digits are transformed, in natural order:
// thread t loads coefficients t + 256 r, so the loads of A and of the
// rotated B (a shift with a sign flip at the wrap) stay coalesced;
// forward() then gathers V[sigma_src(i)] with sigma's sign: g^-1 is odd, so
// a warp's 32 gathers hit 32 banks.  The base u + sigma_g(v) at the b
// component is MergeBase, gathered in the Garner step.  The loop over the
// items is inside, and its invariants before it, as in kernel 4's own loop
// before both kernels shared it: a step called once an item (rank, prime
// and buffers made inside, or handed in) ran kernel 4 3 % slower on an H100
// at 127 / 160 registers, or spilled 8 bytes at 128; this form builds to
// kernel 4's 128 / 218 and runs at its time.  Nor the trace's step with
// hooks: the merge was slower through trace_step at every shape timed.
template <int kBlocks, bool kL2, class Walk>
__device__ __forceinline__ void merge_rows(const Walk& w, const int* __restrict__ A,
                                           const int* __restrict__ B,
                                           const uint32_t* __restrict__ key, int* out,
                                           int items, int t_rot, int ginv, int Td,
                                           FoldShape sh, FheConsts c, FoldTables tb) {
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
  for (int r = blockIdx.x / sh.cs; r < items; r += gridDim.x / sh.cs) {
    const auto it = w.item(r);
    w.wait(it);
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
      const long long at =
          (long long)(fresh(w.row(it)) * row_polys + (tt / Td) * L + tt % Td) * FOLD_N;
      const int* a = w.a(it, A) + at;
      const int* b = w.b(it, B) + at;
      const int t_it = w.t_rot(it, t_rot);
      // four loads of A and B in flight a thread: sixteen spilled at 128
      // registers
#pragma unroll 4
      for (int q = 0; q < 16; ++q) {
        const int j = t | lay_r<0>(q);
        V[j] = ld_row<kL2>(a + j) - rot_row<kL2>(b, j, t_it);
      }
      __syncthreads();
      const int g_it = w.ginv(it, ginv);
      forward<kBlocks>(
          [&](int i) {
            bool neg;
            const int v = V[sigma_src(i, g_it, FOLD_N, neg)];
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
    const uint32_t* kp = w.keys(it, key) + (long long)pi * T * sh.M * FOLD_N;
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
      const long long row = (long long)(fresh(w.row(it)) * row_polys) * FOLD_N;
      garner_fold(R, grp, pi, c2,
                  MergeBase<kL2>{w.a(it, A) + row, w.b(it, B) + row, w.t_rot(it, t_rot),
                                 w.ginv(it, ginv), sh.C2 - 1},
                  RowStore{w.dst(it, out) + row}, sh, c, tb);
      cluster_arrive();   // done reading the cluster's residues
      pending = true;
    }
    w.arrive(it);
  }
  if (pending) cluster_wait();   // no block leaves while another reads its R
}

// The base of a CMux: lo, a row [C2, L, n] read through L2 (another
// cluster, or this one in an earlier step, may have written it).
struct RowBase {
  const int* lo;
  __device__ __forceinline__ int operator()(int, int, int, long long at) const {
    return __ldcg(lo + at);
  }
};

__device__ __forceinline__ int4 sub4(int4 a, int4 b) {
  return make_int4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

// The digit poly of a CMux whose arms are two rows, staged: hi - lo, both
// read through L2.
struct DiffDigits {
  const int4* hi;
  const int4* lo;
  __device__ __forceinline__ int4 unit(int q) const {
    return sub4(__ldcg(hi + q), __ldcg(lo + q));
  }
  __device__ __forceinline__ int operator()(const int* V, int i) const { return V[i]; }
};

// The forward half of cmux_step: st's T digit polys staged and transformed
// for this block's prime into spec[tt * 4096 + r * 256 + t] (thread t's
// register r), spec in shared memory or device memory; R is free after it.
template <int kBlocks, class Step>
__device__ __forceinline__ void cmux_forward(const Step& st, uint32_t* spec, bool& pending,
                                             uint32_t* smem, const FoldShape& sh,
                                             const FheConsts& c, const FoldTables& tb) {
  const int t = threadIdx.x;
  const int pi = (int)cooperative_groups::this_cluster().block_rank() % FHE_P;
  uint32_t* R = smem + sh.T * FOLD_N;       // [max(Lk, 3)][n] residues / exchange
  int4* V = reinterpret_cast<int4*>(R + 2 * FOLD_N);   // the staged poly
  const uint32_t p = prime(c, pi);
  if (pending) {   // the cluster is done with R and has written the step's input
    cluster_wait();
    pending = false;
  }
  uint2 own0[4];   // j = t at stages 0-3
#pragma unroll
  for (int s = 0; s < 4; ++s)
    own0[s] = ldg_pair(tb.fwd + pi * FOLD_N + 4096 - (4096 >> s) + t);
  const uint2 psi_t = ldg_pair(tb.psi_lo + pi * FOLD_THREADS + t);
  for (int tt = 0; tt < sh.T; ++tt) {
    // every thread is past the previous forward's reads of V: they precede
    // its first barrier
    const auto dg = st.digits(tt);
#pragma unroll
    for (int q = 0; q < FOLD_N / 4 / FOLD_THREADS; ++q)
      V[t + q * FOLD_THREADS] = dg.unit(t + q * FOLD_THREADS);
    __syncthreads();
    const int* Vw = reinterpret_cast<const int*>(V);
    forward<kBlocks>([&](int i) { return dg(Vw, i); }, spec + tt * 16 * FOLD_THREADS, R,
                     R + FOLD_N, own0, psi_t, p, tb, pi);
  }
  __syncthreads();   // the last exchange's reads are done: R is free
}

// The fold half of cmux_step: the key products of the T spectra in shared
// memory, the inverse transforms and the Garner step of this block's
// components into st.store(), with base st.base().
template <class Step>
__device__ __forceinline__ void cmux_fold(const Step& st, bool& pending, uint32_t* smem,
                                          const FoldShape& sh, const FheConsts& c,
                                          const FoldTables& tb) {
  const int t = threadIdx.x;
  const int rank = (int)cooperative_groups::this_cluster().block_rank();
  const int pi = rank % FHE_P, grp = rank / FHE_P;
  const int c2_per = sh.C2 / (sh.cs / FHE_P);
  const int T = sh.T, Lk = sh.Lk;
  uint32_t* spec = smem;                    // [T][16][256], thread-private words
  uint32_t* R = smem + T * FOLD_N;          // [max(Lk, 3)][n] residues / exchange
  const uint32_t p = prime(c, pi);
  uint2 own2[4];   // j = t at stages 8-11
#pragma unroll
  for (int s = 0; s < 4; ++s)
    own2[s] = ldg_pair(tb.inv + pi * FOLD_N + (256 << s) - 1 + t);
  const uint2 ipsi_t = ldg_pair(tb.ipsi_lo + pi * FOLD_THREADS + t);
  for (int c2 = grp * c2_per; c2 < (grp + 1) * c2_per; ++c2) {
    for (int lk = 0; lk < Lk; ++lk) {
      uint32_t v[16];
      products(v, spec, st.key(pi) + (long long)(c2 * Lk + lk) * FOLD_N, T,
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
    garner_fold(R, grp, pi, c2, st.base(), st.store(), sh, c, tb);
    cluster_arrive();   // done reading the cluster's residues, done writing
    pending = true;     // this component of the output
  }
}

// One CMux step on a row, this block's part of it:
//   normalize(lo + (hi - lo)[:Td] x GGSW),
// the digits the top Td limbs of EVERY component of hi - lo (T = C2 * Td),
// no automorphism, sign +1.  st supplies, each made where it is used (held
// across the transforms, pointers spill at 128 registers):
//   digits(tt)                  digit poly tt = (component tt / Td, limb
//                               tt % Td) of hi - lo, in two parts:
//                               unit(q), 16-byte unit q of a poly to stage,
//                               formed on loads through L2; and dg(V, i),
//                               the digit at i from the staged words V
//   base()                      garner_fold's base hook: lo (RowBase, or lo
//                               formed on the loads)
//   const uint32_t* key(pi)     prime pi's key rows, uint32[T, M, n]
//   store()                     garner_fold's store hook for the output
// Each block stages the poly of digit tt in the third residue poly, free
// while the digits are transformed, in natural order (thread t the units t
// + 256 q: 16-byte loads, coalesced), then forward() reads its words: at
// i = t | r << 8 and at shifts of it, 32 banks a warp.  On an H100 this
// ran faster, for both kernels at every VM shape, than forming each
// coefficient on L2 loads in forward(), and spilled nothing at 128
// registers where that did.
// Shared memory: the T spectra and max(Lk, 3) residue polys.  pending: as
// in trace_step; the wait before the first staging is also the barrier
// after the previous step, whose output the cluster wrote.  Kept apart from
// trace_step: the merge run through one hook-generalised row step was
// slower on an H100.  Its two halves, cmux_forward and cmux_fold, are
// also called apart (bitwise.cu: spectra shared by many rows).
template <int kBlocks, class Step>
__device__ __forceinline__ void cmux_step(const Step& st, bool& pending, uint32_t* smem,
                                          const FoldShape& sh, const FheConsts& c,
                                          const FoldTables& tb) {
  cmux_forward<kBlocks>(st, smem, pending, smem, sh, c, tb);
  cmux_fold(st, pending, smem, sh, c, tb);
}

// A barrier over `blocks` blocks of a launch whose blocks are all resident
// at once (a cooperative launch), after which what any of them stored
// before it is visible, through L2 (__ldcg), to all of them: a counter in
// device memory, zero at launch and used by these blocks alone; every
// block adds one and waits until `blocks` more have arrived than at its
// last barrier.  A block that has arrived at a cluster barrier waits it
// first (`pending`).  A spin that outlasts 2^24 polls (seconds, where a
// CMux phase takes tens of microseconds) traps: blocks that are not all
// resident fail the launch instead of hanging the card.
struct OpBarrier {
  unsigned* arrived;
  unsigned target;
  __device__ __forceinline__ void sync(int blocks, bool& pending) {
    if (pending) {
      cluster_wait();
      pending = false;
    }
    __syncthreads();
    target += blocks;
    if (threadIdx.x == 0) {
      __threadfence();
      cuda::atomic_ref<unsigned, cuda::thread_scope_device> count(*arrived);
      count.fetch_add(1u, cuda::memory_order_release);
      unsigned polls = 0;
      while (count.load(cuda::memory_order_acquire) < target)
        if (++polls == (1u << 24)) __trap();
    }
    __syncthreads();
  }
};

// A block has stored its part of a row: count it at the row's counter
// (kernels 8 and 9: a row waits on the counters of the rows it reads).
// Every thread's stores precede the barrier, thread 0's release follows it.
__device__ __forceinline__ void unit_arrive(unsigned* count) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> n(*count);
    n.fetch_add(1u, cuda::memory_order_release);
  }
}

// Wait until `target` blocks have arrived at a counter; what they stored
// is then visible to this block's loads through L2.  A spin that outlasts
// 2^24 polls traps, as OpBarrier's does.
__device__ __forceinline__ void unit_wait(unsigned* count, unsigned target) {
  if (threadIdx.x == 0) {
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> n(*count);
    unsigned polls = 0;
    while (n.load(cuda::memory_order_acquire) < target)
      if (++polls == (1u << 24)) __trap();
  }
  __syncthreads();
}

// Launch `kernel` as `clusters` thread block clusters of cs blocks of
// FOLD_THREADS threads with `smem` bytes of dynamic shared memory each;
// cooperative: all blocks resident at once, or the launch fails.
template <class... Params, class... Args>
static int launch_clusters_as(bool cooperative, void (*kernel)(Params...), int clusters,
                              int cs, size_t smem, void* stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)clusters * cs);
  cfg.blockDim = dim3(FOLD_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cooperative ? 2 : 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <class... Params, class... Args>
static int launch_clusters(void (*kernel)(Params...), int clusters, int cs, size_t smem,
                           void* stream, Args... args) {
  return launch_clusters_as(false, kernel, clusters, cs, smem, stream, args...);
}

// The most clusters of cs blocks of `kernel` with `smem` bytes of dynamic
// shared memory each that the current device holds at once.
template <class... Params>
static int max_active_clusters(void (*kernel)(Params...), int cs, size_t smem,
                               int* clusters) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cs);
  cfg.blockDim = dim3(FOLD_THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(clusters, (const void*)kernel, &cfg);
}
