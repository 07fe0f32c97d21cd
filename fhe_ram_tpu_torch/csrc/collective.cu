// Kernels 13 and 14: the collectives of the row-sharded pack
// (fhe_ram_tpu_torch/parallel/mesh.py) over the `rows` shards of a mesh.
//
// A shard is a set of buffers, not a process: the wrapper passes one input
// pointer and one output pointer a shard (ShardPtrs, by value).  On one card
// every pointer lies in the same device memory; on distinct cards they would
// be peer-mapped pointers, and neither kernel changes.  A shard's blocks read
// from that shard's own buffers and write only into the buffer of the shard
// that receives, as a remote copy does.
//
// Both kernels move bytes and compute nothing: bound by bytes, each input read
// once and each output written once, over 3.35 TB/s.  At the read's chunk
// (one pack root, int32[4, 2, 3, 4096] = 384 KiB) that is microseconds, less
// than one launch costs, so both are launch-bound and simple on purpose:
// 16-byte loads and stores, no staging in shared memory.  Per-shard streams
// and overlapping the collective with the tail merges
// (fhe_ram_tpu/parallel/collective.py:13-17) are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#define FHE_MAX_SHARDS 16
#define COLL_THREADS 256
#define COLL_MAX_BLOCKS 1024   // most blocks a shard of the all-gather
#define EXCH_UNROLL 4          // 16-byte loads an exchange thread keeps in flight

struct ShardPtrs {
  const int* in[FHE_MAX_SHARDS];  // the chunk each shard sends
  int* out[FHE_MAX_SHARDS];       // each shard's output buffer
};

// ---- kernel 13: all-gather, one push launch ----------------------------------
// Replaces fhe_ram_tpu/parallel/collective.py: ring_all_gather (_ag_kernel).
// out_k[s] = in_s for every shard k and slot s.  The TPU kernel moves the
// chunks around a ring of n - 1 hops because its links are a torus; the
// order of the hops cannot be seen in the output.  Here each chunk is pushed
// once to every shard: the grid is n groups of blocks, group s for source
// slot s; each thread loads a 16-byte unit of in_s once (ld.global.nc:
// nothing in the launch writes an input) and stores it into slot s of every
// shard's output.  No block waits for another: one plain launch, no grid
// barrier.  With peer-mapped pointers each card's launch would push its own
// slot alone (the group of its shard) and still no block would wait on
// another card; on an NVLink all-to-all host a one-shot push is the usual
// all-gather.
// Bound: bytes, n chunks read and n^2 written, which is what it moves.
__global__ void __launch_bounds__(COLL_THREADS)
ring_all_gather_kernel(ShardPtrs p, int n, long long words) {
  const int per = (int)gridDim.x / n;
  const int s = (int)blockIdx.x / per;
  const int4* src = reinterpret_cast<const int4*>(p.in[s]);
  const long long units = words / 4;
  for (long long i = (long long)((int)blockIdx.x % per) * blockDim.x + threadIdx.x;
       i < units; i += (long long)per * blockDim.x) {
    const int4 v = __ldg(src + i);
    for (int k = 0; k < n; ++k)
      reinterpret_cast<int4*>(p.out[k] + s * words)[i] = v;
  }
}

// ---- kernel 14: partner exchange --------------------------------------------
// Replaces fhe_ram_tpu/parallel/collective.py: exchange (_exchange_kernel).
// out_{k ^ stride} = in_k: shard k pushes its chunk into the output of its
// XOR partner; the partners form an involution, so one launch is the whole
// round.  Bound: bytes, 2n chunks (0.94 us at n = 4), far below one launch.
// Design, for the launch that bounds it in practice:
//  * One wave: `per` blocks a shard (ops side: parallel/collective.py
//    _exchange_blocks), at most as many over all n shards as the SMs hold
//    at once, so every block starts at once and none waits for a slot.
//    Each thread keeps EXCH_UNROLL 16-byte loads in flight (through L2:
//    what the kernel before wrote) before it stores them, unit i of its
//    shard's chunk at i of the partner's output; a block-stride loop
//    beyond (chunks larger than a wave holds).
//  * Programmatic dependent launch (sm_90): launched with programmatic
//    stream serialization, the grid may start while the kernel before it
//    on the stream (the pack tree or the merge that made the roots) drains;
//    griddepcontrol.wait holds every thread before its first load until
//    that grid has completed and its writes are visible.  Launched without
//    the attribute the wait returns at once.
__global__ void __launch_bounds__(COLL_THREADS)
exchange_kernel(ShardPtrs p, int stride, int units, int per) {
  const int k = (int)blockIdx.x / per;
  const int4* src = reinterpret_cast<const int4*>(p.in[k]);
  int4* dst = reinterpret_cast<int4*>(p.out[k ^ stride]);
  const int step = per * COLL_THREADS;
  const int i0 = ((int)blockIdx.x % per) * COLL_THREADS + (int)threadIdx.x;
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int i = i0; i < units; i += EXCH_UNROLL * step) {
    int4 v[EXCH_UNROLL];
#pragma unroll
    for (int j = 0; j < EXCH_UNROLL; ++j)
      if (i + j * step < units) v[j] = __ldcg(src + i + j * step);
#pragma unroll
    for (int j = 0; j < EXCH_UNROLL; ++j)
      if (i + j * step < units) dst[i + j * step] = v[j];
  }
}

// Blocks a shard of the all-gather: enough for one 16-byte unit a thread,
// at most COLL_MAX_BLOCKS.
static inline int blocks_per_shard(long long words) {
  long long want = (words / 4 + COLL_THREADS - 1) / COLL_THREADS;
  if (want > COLL_MAX_BLOCKS) want = COLL_MAX_BLOCKS;
  return want < 1 ? 1 : (int)want;
}

extern "C" int fhe_ring_all_gather(ShardPtrs p, int n, long long words,
                                   void* stream) {
  if (n < 2 || n > FHE_MAX_SHARDS || words < 4 || words % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int per = blocks_per_shard(words);
  ring_all_gather_kernel<<<per * n, COLL_THREADS, 0, (cudaStream_t)stream>>>(
      p, n, words);
  return (int)cudaGetLastError();
}

// The arguments an exchange launch takes: n shards, a power-of-two stride
// that pairs them, whole 16-byte units (fewer than 2^30 a chunk), per >= 1.
static inline bool exchange_args_ok(int n, int stride, long long words, int per) {
  return n >= 2 && n <= FHE_MAX_SHARDS && words >= 4 && words % 4 == 0 &&
         words / 4 < (1LL << 30) && stride >= 1 && (stride & (stride - 1)) == 0 &&
         n % (2 * stride) == 0 && per >= 1;
}

// per: blocks a shard (the grid is per * n blocks).
extern "C" int fhe_exchange(ShardPtrs p, int n, int stride, long long words, int per,
                            void* stream) {
  if (!exchange_args_ok(n, stride, words, per)) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(per * n));
  cfg.blockDim = dim3(COLL_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err =
      cudaLaunchKernelEx(&cfg, exchange_kernel, p, stride, (int)(words / 4), per);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
