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
// Per-shard streams and overlapping the hops with the tail merges
// (fhe_ram_tpu/parallel/collective.py:13-17) are later work.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FHE_MAX_SHARDS 16
#define COLL_THREADS 256

struct ShardPtrs {
  const int* in[FHE_MAX_SHARDS];  // the chunk each shard sends
  int* out[FHE_MAX_SHARDS];       // each shard's output buffer
};

// Copy `words` int32 (words % 4 == 0, both pointers 16-byte aligned: the
// wrapper guarantees it) from src to dst, 16 bytes at a time, with block `b`
// of `blocks`, reading through L2 (__ldcg): in the ring another block of the
// same launch wrote src, and L1 is not coherent across SMs.
__device__ __forceinline__ void copy_words(const int* src, int* dst,
                                           long long words, int b, int blocks) {
  const long long step = (long long)blocks * blockDim.x;
  const int4* s = reinterpret_cast<const int4*>(src);
  int4* d = reinterpret_cast<int4*>(dst);
  for (long long i = (long long)b * blockDim.x + threadIdx.x; i < words / 4;
       i += step)
    d[i] = __ldcg(s + i);
}

// ---- kernel 13: ring all-gather --------------------------------------------
// Replaces fhe_ram_tpu/parallel/collective.py: ring_all_gather (_ag_kernel).
// out_k[s] = in_s for every shard k and slot s, moved around the ring as the
// TPU kernel moves it: at hop h shard k forwards slot (k - h) mod n, which it
// received at hop h - 1 (its own chunk at hop 0), into the same slot of its
// right neighbour's output.  Hop 0 also places the shard's chunk in its own
// slot; both of its copies read the input.
// Bound: bytes, (n + n^2) chunks (n read, n^2 written); the ring itself moves
// 2n(n - 1) + n chunks (a hop reads what the one before wrote).
// Order of the hops: ONE cooperative launch (every block resident) with a
// grid-wide barrier (cooperative_groups grid sync, which fences memory)
// between two hops, and data another block wrote read through L2.  The grid
// is n groups of blocks, one group a shard; every block passes every barrier.
__global__ void __launch_bounds__(COLL_THREADS)
ring_all_gather_kernel(ShardPtrs p, int n, long long words) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int per = (int)gridDim.x / n;
  const int k = (int)blockIdx.x / per;
  const int b = (int)blockIdx.x % per;
  const int right = (k + 1) % n;
  copy_words(p.in[k], p.out[k] + (long long)k * words, words, b, per);
  copy_words(p.in[k], p.out[right] + (long long)k * words, words, b, per);
  for (int h = 1; h < n - 1; ++h) {
    grid.sync();
    const long long slot = (k - h + n) % n;
    copy_words(p.out[k] + slot * words, p.out[right] + slot * words, words, b,
               per);
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

// Blocks a shard: enough for one 16-byte unit a thread, at most `cap`.
static inline int blocks_per_shard(long long words, long long cap) {
  long long want = (words / 4 + COLL_THREADS - 1) / COLL_THREADS;
  if (want > cap) want = cap;
  return want < 1 ? 1 : (int)want;
}

extern "C" int fhe_ring_all_gather(ShardPtrs p, int n, long long words,
                                   void* stream) {
  if (n < 2 || n > FHE_MAX_SHARDS || words < 4 || words % 4 != 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ring_all_gather_kernel, COLL_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  // a cooperative grid must fit the card at once
  const long long resident = (long long)per_sm * sms / n;
  if (resident < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int per = blocks_per_shard(words, resident);
  void* args[] = {&p, &n, &words};
  err = cudaLaunchCooperativeKernel((void*)ring_all_gather_kernel,
                                    dim3((unsigned)(per * n)),
                                    dim3(COLL_THREADS), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int fhe_exchange(ShardPtrs p, int n, int stride, long long words,
                            void* stream) {
  if (n < 2 || n > FHE_MAX_SHARDS || words < 4 || words % 4 != 0 || stride < 1 ||
      (stride & (stride - 1)) != 0 || n % (2 * stride) != 0)
    return (int)cudaErrorInvalidValue;
  const int per = blocks_per_shard(words, 1024);
  exchange_kernel<<<per * n, COLL_THREADS, 0, (cudaStream_t)stream>>>(
      p, n, stride, words);
  return (int)cudaGetLastError();
}
