// The predecessor of kernel 14 in csrc/collective.cu (the exchange before
// its grid became one wave of blocks that keep several loads in flight,
// launched dependent on the kernel before it), kept for
// tools/time_external_exchange_predecessors.py and chip_smoke.py's checks
// only: one plain launch, one 16-byte unit a thread, a group of blocks a
// shard.  Nothing on a serving path builds or launches it.
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

// Replaces fhe_ram_tpu/parallel/collective.py: exchange (_exchange_kernel).
// out_{k ^ stride} = in_k: shard k pushes its chunk into the output of its
// XOR partner; the partners form an involution, so one launch is the whole
// round.  Bound: bytes, 2n chunks.  Design: one plain launch, a group of
// blocks a shard; nothing is read that the launch writes.
__global__ void __launch_bounds__(COLL_THREADS)
exchange_predecessor_kernel(ShardPtrs p, int n, int stride, long long words) {
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

extern "C" int fhe_exchange_predecessor(ShardPtrs p, int n, int stride, long long words,
                                        void* stream) {
  if (n < 2 || n > FHE_MAX_SHARDS || words < 4 || words % 4 != 0 || stride < 1 ||
      (stride & (stride - 1)) != 0 || n % (2 * stride) != 0)
    return (int)cudaErrorInvalidValue;
  const int per = blocks_per_shard(words);
  exchange_predecessor_kernel<<<per * n, COLL_THREADS, 0, (cudaStream_t)stream>>>(
      p, n, stride, words);
  return (int)cudaGetLastError();
}
