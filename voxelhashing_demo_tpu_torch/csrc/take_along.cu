// take_along_axis on a 2-D float32 source, for Hopper (sm_90a):
//   axis 0: out[i, j] = src[idx[i, j], j]
//   axis 1: out[i, j] = src[i, idx[i, j]]
// with idx (rows, cols) int32; its length along ``axis`` may differ from
// the source's, its other dimension equals the source's.
//
// Replaces the TPU probe kernels of tools/exp_pallas_gather2.py: f_axis0
// (pallas_call :57, a sublane gather of (512, 256) indices from a
// (256, 256) patch of the image), f_axis1 (:79, a lane gather at
// (512, 128)) and f_axis1b (:101, the same at (512, 256)).
//
// Contract: the source may be a view with a row stride ``ld`` and unit
// column stride (the patch img[0:256, 0:256] is passed as it is, not
// copied); idx and out are contiguous.  An index outside [0, source length
// along axis) gives NaN, as the plain version
// (ops/image_gather.take_along_axis_reference) does.
//
// Bound: bytes, and few of them: at the probes' shapes the indices, the
// output and the source sectors the indices reach are 0.8-1.6 MB,
// 0.23-0.47 us at 3.35 TB/s.  On axis 0, one thread per output (the first
// design) read, for each warp, 32 columns out of 32 index-picked rows: 32
// L1 tags and 32 L2 sectors for 128 useful bytes (3.0 us on an NVIDIA H100
// 80GB HBM3 at 700.00 W, against 1.7-1.8 on axis 1 at the same size).
//
// Design, axis 0: a CTA of 256 threads owns a strip of 32 source columns
// and 32 output rows (a 2-D grid: 16 x 8 CTAs at the probe's shape).  It
// stages the strip, every source row of it, into shared memory (32 KB at
// 256 rows) with cp.async, 16 bytes a copy where the view allows it (an
// aligned pointer, ld % 4 == 0) and 4 otherwise; its 4 indices a thread are
// loaded before the copies are waited for.  Then each warp takes 32
// columns of one output row: a coalesced index load, a shared-memory read
// whose 32 lanes fall on 32 banks whatever the indices, a coalesced store.
// A source taller than kMaxStagedRows (384 rows: a 48 KB strip, the most
// a CTA takes without opting in to more) takes the same grid with the
// strip read straight from the source (the direct path).  On the H100
// above: 2.1 us warm, 0.71-0.73 of the first design in the same call.  Lost
// there (PERF.md section 6, chip_probe_compare.py): 64 or 128 rows a CTA
// (2.3, 2.7), strips of 8 or 16 columns (2.1-2.9), 512 threads (2.13), a
// 2-CTA cluster that stages half the rows each and reads the other half
// from its partner's shared memory (3.9), the direct path (3.4).
// Axis 1: a 2-D CTA (tx = the row's columns rounded up to a warp, at most
// 256; ty = 256 / tx rows), one output a thread and step, no divide; the
// source row, at most a few KB, is read through the L1.  1.6-1.7 us, 0.1
// under the first design; four outputs a thread with 16-byte index loads and
// stores lost (+0.1-0.4), and so did staging the CTA's source rows in
// shared memory (+0.4).  Indices and output stream (__ldcs / __stcs).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads0 = 256;            // axis 0: threads a CTA
constexpr int kStrip = 32;                 // axis 0: source columns a CTA
constexpr int kSlots = kThreads0 / kStrip; // axis 0: rows a CTA does at once
constexpr int kRowsPerCta = 32;            // axis 0: output rows a CTA
constexpr int kPerThread = kRowsPerCta / kSlots;
constexpr int kMaxStagedRows = 384;        // axis 0: 48 KB; taller: direct
constexpr int kThreads1 = 256;            // axis 1: threads a CTA
static_assert(kRowsPerCta % kSlots == 0, "whole rows a thread");

__device__ __forceinline__ float nan_f() {
  return __int_as_float(0x7fc00000);
}

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
}

// grid (row ranges, strips).  Thread t takes column t % kStrip of the
// strip and output rows t / kStrip + j * kSlots of the CTA's range.
// kStaged: the strip is in shared memory (src_rows x kStrip floats), else
// read from the source.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads0)
take_axis0_kernel(const float* __restrict__ src,
                  const int32_t* __restrict__ idx,
                  float* __restrict__ out, int rows, int cols, int src_rows,
                  int64_t ld, bool vec) {
  extern __shared__ float strip[];
  const int lane = threadIdx.x % kStrip;
  const int c0 = blockIdx.y * kStrip;
  const int c = c0 + lane;
  const int r0 = blockIdx.x * kRowsPerCta + threadIdx.x / kStrip;
  int k[kPerThread];
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int r = r0 + q * kSlots;
    k[q] = (c < cols && r < rows)
               ? __ldcs(idx + static_cast<int64_t>(r) * cols + c)
               : -1;
  }
  if (kStaged) {
    const int width = min(kStrip, cols - c0);
    if (vec && width == kStrip) {
      for (int e = threadIdx.x; e < src_rows * (kStrip / 4); e += kThreads0) {
        const int r = e / (kStrip / 4), q = e % (kStrip / 4);
        copy16(strip + r * kStrip + 4 * q,
               src + static_cast<int64_t>(r) * ld + c0 + 4 * q);
      }
    } else {
      for (int e = threadIdx.x; e < src_rows * kStrip; e += kThreads0) {
        const int r = e / kStrip, q = e % kStrip;
        if (q < width)
          copy4(strip + e, src + static_cast<int64_t>(r) * ld + c0 + q);
      }
    }
    copies_done();
  }
  if (c >= cols) return;
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int r = r0 + q * kSlots;
    if (r >= rows) break;
    const int kq = k[q];
    float v = nan_f();
    if (kq >= 0 && kq < src_rows)
      v = kStaged ? strip[kq * kStrip + lane]
                  : __ldg(src + static_cast<int64_t>(kq) * ld + c);
    __stcs(out + static_cast<int64_t>(r) * cols + c, v);
  }
}

// blockDim (tx, ty), tx * ty = kThreads1: threadIdx.y picks the output
// row, threadIdx.x walks its columns, one output a step.
__global__ void __launch_bounds__(kThreads1)
take_axis1_kernel(const float* __restrict__ src,
                  const int32_t* __restrict__ idx,
                  float* __restrict__ out, int rows, int cols, int src_cols,
                  int64_t ld) {
  const int r = blockIdx.x * blockDim.y + threadIdx.y;
  if (r >= rows) return;
  const float* srow = src + static_cast<int64_t>(r) * ld;
  const int32_t* irow = idx + static_cast<int64_t>(r) * cols;
  float* orow = out + static_cast<int64_t>(r) * cols;
  for (int j = threadIdx.x; j < cols; j += blockDim.x) {
    const int k = __ldcs(irow + j);
    __stcs(orow + j, (k >= 0 && k < src_cols) ? __ldg(srow + k) : nan_f());
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  ``ld`` is the source's row
// stride in elements (its column stride is 1).  Launches on ``stream`` and
// returns cudaGetLastError() as an int (0 = launched).
extern "C" int take_along(const float* src, const int32_t* idx, float* out,
                          int rows, int cols, int src_rows, int src_cols,
                          int64_t ld, int axis, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  if (axis != 0 && axis != 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (axis == 0) {
    const dim3 grid((rows + kRowsPerCta - 1) / kRowsPerCta,
                    (cols + kStrip - 1) / kStrip);
    if (src_rows <= kMaxStagedRows) {
      const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
                       ld % 4 == 0;
      take_axis0_kernel<true><<<grid, kThreads0,
                                static_cast<size_t>(src_rows) * kStrip * 4,
                                s>>>(src, idx, out, rows, cols, src_rows, ld,
                                     vec);
    } else {
      take_axis0_kernel<false><<<grid, kThreads0, 0, s>>>(
          src, idx, out, rows, cols, src_rows, ld, false);
    }
  } else {
    int tx = (cols + 31) / 32 * 32;
    if (tx > kThreads1) tx = kThreads1;
    const int ty = kThreads1 / tx;
    take_axis1_kernel<<<(rows + ty - 1) / ty, dim3(tx, ty), 0, s>>>(
        src, idx, out, rows, cols, src_cols, ld);
  }
  return static_cast<int>(cudaGetLastError());
}
