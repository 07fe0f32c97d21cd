// csrc/collective.cu's exchange (kernel 14) launched without programmatic
// dependent launch: a plain launch of the same kernel with the same grid,
// whose griddepcontrol.wait then returns at once.  Built and timed by
// tools/time_external_exchange_predecessors.py alone, beside the wrapper's
// launch, to show what the dependent launch changes; nothing on a serving
// path builds or launches it.
#include "collective.cu"

extern "C" int fhe_exchange_no_pdl(ShardPtrs p, int n, int stride, long long words, int per,
                                   void* stream) {
  if (!exchange_args_ok(n, stride, words, per)) return (int)cudaErrorInvalidValue;
  exchange_kernel<<<per * n, COLL_THREADS, 0, (cudaStream_t)stream>>>(
      p, stride, (int)(words / 4), per);
  return (int)cudaGetLastError();
}
