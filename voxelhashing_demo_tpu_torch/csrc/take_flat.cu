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
// Contract: int32 indices of any shape, read as a flat run of n (a
// contiguous tensor, at any 4-byte alignment).  A flat
// index outside [0, n_img) (the (row, column) form's index formed in 64
// bits) gives NaN; negative indices do not wrap.  The plain version
// (ops/image_gather.take_flat_reference) does the same.
//
// Bound: bytes, but the bytes are few.  Each output reads 4 bytes of index
// (8 in the (row, column) form) and writes 4; the image (1.2 MB at
// 640 x 480) is the only data reused, and the 50 MB L2 holds it whole.  At
// 65 536 gathers the byte bound (indices, output and the 32-byte sectors
// of the image the indices reach) is 0.46 us, at 524 288 1.62 us.  What
// the byte bound does not see: every random read is its own L1 tag lookup
// and its own 32-byte L2 sector.  On an NVIDIA H100 80GB HBM3 at 700.00 W
// the 524 288 uniform gathers take 5.6-5.7 us warm, about 4.7 over the
// 0.9-1.1 us launch floor: about two SM cycles a gather.  The same gathers
// kept inside the image's first 32 KB (L1 hits) still take 3.35, sorted
// 2.7.  So the cost is the L1TEX path's work per divergent gather, not
// bytes.
//
// Design: one thread per output, 256 threads a CTA, lane-consecutive
// outputs (neighbouring voxels of a projected block read neighbouring
// pixels: one tag serves several lanes), the image read through the
// read-only path (__ldg).  Nothing is staged in shared memory: the image
// does not fit a CTA's 227 KB.  These redesigns were measured against it
// on the card above (PERF.md section 6, chip_probe_compare.py, warm unless
// said); none was faster, so it stays:
//   four or eight outputs a thread, 16-byte index loads and stores, one
//     wave of CTAs: +0.14-0.45 us (+0.4 on the clustered chunk);
//   a grid-stride loop over the resident CTAs: +0.2 at 524 288;
//   the L1 carve-out at its maximum: a tie;
//   the image read with an L2 evict-last policy: within 0.05;
//   the image read past the L1 (ld.global.cg): +0.2 at 524 288, twice
//     the time on gathers an L1 can hold;
//   a cp.async.bulk.prefetch.L2 of the image: no gain cold at 524 288,
//     +0.5 on the cold chunk;
//   streaming index loads (__ldcs): a tie warm, 0.24 off the L2-cold
//     524 288 case but 0.12 on to the cold chunk; streaming stores
//     (__stcs): a tie; both together: +0.1 at 524 288.

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
