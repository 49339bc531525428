// Flat image gather, for Hopper (sm_90a): out[i] = img.flat[idx[i]], or,
// given a column tensor, out[i] = img.flat[idx[i] * cols + col[i]].
//
// Replaces the six TPU probe kernels that gather single pixels out of an
// image held in VMEM: tools/exp_pallas_integrate.py pallas_take_all
// (pallas_call :131) and pallas_take_block (:158), tools/
// exp_pallas_vmem_gather.py pallas_take (:69), pallas_take2 (:89) and
// pallas_taa (:117, the (row, column) form), and tools/exp_pallas_gather.py
// pallas_gather (:63, a row gather plus a one-hot lane sum).  All six
// compute the same function; their block shapes (whole arrays, a grid over
// blocks, 2048 gathers a step) are the TPU's way to stage the image in
// VMEM and have no counterpart here.
//
// Out of range: a flat index outside [0, n_img) (the (row, column) form's
// index formed in 64 bits) gives NaN; negative indices do not wrap.  The
// plain version (ops/image_gather.take_flat_reference) does the same.
//
// Bound: bytes, but the bytes are few.  Each output reads 4 bytes of index
// (8 in the (row, column) form) and writes 4; the image (1.2 MB at
// 640 x 480) is the only data reused, and the 50 MB L2 holds it whole, so
// after the first touches the random reads are L2 hits, not device-memory
// round trips.  At 65 536 gathers the byte bound (indices, output and the
// image once) is about 0.5 us, below a launch; at 524 288 about 1.6 us.
//
// Design: one thread per output, 256 threads a CTA.  Index loads and the
// output store are coalesced; the image read goes through the read-only
// path (__ldg).  Nothing is staged in shared memory: the image does not fit
// a CTA's 227 KB, and the L2 already plays the part VMEM played.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
take_flat_kernel(const float* __restrict__ img,
                 const int32_t* __restrict__ idx,
                 const int32_t* __restrict__ col,
                 float* __restrict__ out,
                 int64_t n_img, int64_t n, int cols) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  int64_t f = __ldg(idx + i);
  if (col != nullptr) f = f * cols + __ldg(col + i);
  out[i] = (f >= 0 && f < n_img) ? __ldg(img + f) : __int_as_float(0x7fc00000);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  ``col`` may be null (flat
// indices).  Launches on ``stream`` and returns cudaGetLastError() as an
// int (0 = launched).
extern "C" int take_flat(const float* img, const int32_t* idx,
                         const int32_t* col, float* out, int64_t n_img,
                         int64_t n, int cols, void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  take_flat_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      img, idx, col, out, n_img, n, cols);
  return static_cast<int>(cudaGetLastError());
}
