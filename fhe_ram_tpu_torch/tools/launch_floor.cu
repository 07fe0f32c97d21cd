// An empty kernel, one block of 256 threads: its time between two CUDA
// events is the card's floor for one launch, which
// tools/time_external_exchange_predecessors.py prints beside the kernels
// that sit at it (kernels 1, 13 and 14 at the read's shapes).  Nothing on a
// serving path builds or launches it.
#include <cuda_runtime.h>

__global__ void empty_kernel() {}

extern "C" int fhe_empty(void* stream) {
  empty_kernel<<<1, 256, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
