// take_along_axis on a 2-D float32 source, for Hopper (sm_90a):
//   axis 0: out[i, j] = src[idx[i, j], j]
//   axis 1: out[i, j] = src[i, idx[i, j]]
// with idx (rows, cols) int32; its length along ``axis`` may differ from
// the source's, its other dimension equals the source's.
//
// Replaces the TPU probe kernels of tools/exp_pallas_gather2.py: f_axis0
// (pallas_call :57, a sublane gather of (512, 256) indices from a
// (256, 256) patch of the image), f_axis1 (:79, a lane gather at
// (512, 128)) and f_axis1b (:101, the same at (512, 256)).  The source may
// be a view with a row stride (the patch img[0:256, 0:256] is passed as it
// is, not copied).
//
// Out of range: an index outside [0, source length along axis) gives NaN,
// as the plain version (ops/image_gather.take_along_axis_reference) does.
//
// Bound: bytes, and few of them: at the probes' shapes the source, the
// indices and the output together are 0.8-1.6 MB, 0.23-0.47 us at
// 3.35 TB/s, well below a launch.  What decides the time is the launch.
//
// Design: one thread per output, 256 threads a CTA; the index load and the
// store are coalesced, the source read goes through the read-only path
// (__ldg).  Axis 0 reads, for a warp, 32 neighbouring columns of rows that
// the indices pick; axis 1 reads inside one source row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
take_along_kernel(const float* __restrict__ src,
                  const int32_t* __restrict__ idx,
                  float* __restrict__ out,
                  int cols, int64_t n, int src_rows, int src_cols,
                  int64_t ld, int axis) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n) return;
  const int64_t r = t / cols;
  const int64_t c = t - r * cols;
  const int k = __ldg(idx + t);
  bool ok;
  int64_t off;
  if (axis == 0) {
    ok = k >= 0 && k < src_rows;
    off = static_cast<int64_t>(k) * ld + c;
  } else {
    ok = k >= 0 && k < src_cols;
    off = r * ld + k;
  }
  out[t] = ok ? __ldg(src + off) : __int_as_float(0x7fc00000);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  ``ld`` is the source's row
// stride in elements (its column stride is 1).  Launches on ``stream`` and
// returns cudaGetLastError() as an int (0 = launched).
extern "C" int take_along(const float* src, const int32_t* idx, float* out,
                          int rows, int cols, int src_rows, int src_cols,
                          int64_t ld, int axis, void* stream) {
  const int64_t n = static_cast<int64_t>(rows) * cols;
  if (n <= 0) return 0;
  if (axis != 0 && axis != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  take_along_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      src, idx, out, cols, n, src_rows, src_cols, ld, axis);
  return static_cast<int>(cudaGetLastError());
}
