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
// 16-byte loads and stores, a block-stride loop, no staging in shared memory.
// Per-shard streams and overlapping the collective with the tail merges
// (fhe_ram_tpu/parallel/collective.py:13-17) are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#define FHE_MAX_SHARDS 16
#define COLL_THREADS 256
#define COLL_MAX_BLOCKS 1024   // most blocks a shard (a block-stride loop beyond)

struct ShardPtrs {
  const int* in[FHE_MAX_SHARDS];  // the chunk each shard sends
  int* out[FHE_MAX_SHARDS];       // each shard's output buffer
};

// Copy `words` int32 (words % 4 == 0, both pointers 16-byte aligned: the
// wrapper guarantees it) from src to dst, 16 bytes at a time, with block `b`
// of `blocks`, reading through L2 (__ldcg).
__device__ __forceinline__ void copy_words(const int* src, int* dst,
                                           long long words, int b, int blocks) {
  const long long step = (long long)blocks * blockDim.x;
  const int4* s = reinterpret_cast<const int4*>(src);
  int4* d = reinterpret_cast<int4*>(dst);
  for (long long i = (long long)b * blockDim.x + threadIdx.x; i < words / 4;
       i += step)
    d[i] = __ldcg(s + i);
}

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
// round.  Bound: bytes, 2n chunks.  Design: one plain launch, a group of
// blocks a shard; nothing is read that the launch writes.
__global__ void __launch_bounds__(COLL_THREADS)
exchange_kernel(ShardPtrs p, int n, int stride, long long words) {
  const int per = (int)gridDim.x / n;
  const int k = (int)blockIdx.x / per;
  copy_words(p.in[k], p.out[k ^ stride], words, (int)blockIdx.x % per, per);
}

// Blocks a shard: enough for one 16-byte unit a thread, at most
// COLL_MAX_BLOCKS.
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

extern "C" int fhe_exchange(ShardPtrs p, int n, int stride, long long words,
                            void* stream) {
  if (n < 2 || n > FHE_MAX_SHARDS || words < 4 || words % 4 != 0 || stride < 1 ||
      (stride & (stride - 1)) != 0 || n % (2 * stride) != 0)
    return (int)cudaErrorInvalidValue;
  const int per = blocks_per_shard(words);
  exchange_kernel<<<per * n, COLL_THREADS, 0, (cudaStream_t)stream>>>(
      p, n, stride, words);
  return (int)cudaGetLastError();
}
