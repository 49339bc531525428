// Two empty kernels: what one launch costs with no work in it, and what a
// grid barrier costs.  They replace no TPU kernel and run on no path of the
// system; the measurement tools time them the way they time every other
// kernel (a CUDA graph of 20 launches through kernels.launch, replayed).
//
//   launch_floor: one CTA of one warp, no work: the launch floor of that
//     harness; a kernel whose time lies within about 0.1 us of it is
//     launch-bound.
//   grid_sync_floor: ``ctas`` CTAs of 256 threads launched cooperatively,
//     as the ICP level kernel (icp.cu) is, running ``syncs`` grid barriers
//     (cooperative_groups::this_grid().sync()) and nothing else: the time
//     over k barriers, less the time of 0, is the barrier floor of a level
//     kernel's iteration.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

__global__ void launch_floor_kernel() {}

__global__ void grid_sync_floor_kernel(int syncs) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int k = 0; k < syncs; ++k) grid.sync();
}

}  // namespace

// Plain C entry points (loaded with ctypes), each on ``stream``; each
// returns a CUDA error code as an int (0 = launched).
extern "C" int launch_floor(void* stream) {
  launch_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" int grid_sync_floor(int ctas, int syncs, void* stream) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(ctas);
  config.blockDim = dim3(256);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, grid_sync_floor_kernel, syncs);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
