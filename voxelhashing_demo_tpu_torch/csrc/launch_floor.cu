// An empty kernel: what one launch costs with no work in it.  It replaces
// no TPU kernel and runs on no path of the system; the measurement tools
// time it the way they time every other kernel (a CUDA graph of 20 launches
// through kernels.launch, replayed), and the result is the launch floor of
// that harness: a kernel whose time lies within about 0.1 us of it is
// launch-bound.

#include <cuda_runtime.h>

namespace {

__global__ void launch_floor_kernel() {}

}  // namespace

// Plain C entry point (loaded with ctypes): one CTA of one warp on
// ``stream``; returns cudaGetLastError() as an int (0 = launched).
extern "C" int launch_floor(void* stream) {
  launch_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
