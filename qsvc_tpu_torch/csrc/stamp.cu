// The card's clock at one point of a stream: one thread writes %globaltimer
// (nanoseconds) into out[index].
//
// Replaces no TPU kernel: it is the tracing's, not the codec's.  A region
// of a captured program (utils/graphs.py) cannot be timed by CUDA events
// recorded on the host's call, since the host only replays the whole
// graph; a stamp launched at each edge of the region while the program is
// captured becomes a node of the graph, runs after the work queued before
// it and before the work queued after it, and reads the clock at every
// replay (utils/trace.py turns the stamps into device spans).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void stamp_kernel(uint64_t* out) {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *out = t;
}

}  // namespace

extern "C" int qsvc_stamp(void* out, int index, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint64_t*>(out) + index);
  return static_cast<int>(cudaGetLastError());
}
