// Two-step window gather, for Hopper (sm_90a).  For block b, row i and
// column j < keep:
//   c = du[b, i, j];  r = dv[b, i, c];
//   out[b, i, j] = img[v0[b] + r, u0[b] + c]
// that is, out[b, i, j] = patch_b[dv[b, i, du[b, i, j]], du[b, i, j]] with
// patch_b the S x S window of the image at (v0[b], u0[b]) and S the last
// dimension of dv and du.
//
// Replaces the TPU probe kernel tools/exp_pallas_gather2.py f_full
// (pallas_call :145): a 128-step grid with the origins as scalar prefetch;
// each step slices the 256 x 256 patch out of the VMEM image, gathers rows
// by dv into a (512, 256) intermediate (take_along_axis on axis 0), picks
// one column of each row by du (axis 1) and keeps the first 128 columns.
// This kernel computes the function and not that block structure: the
// (512, 256) intermediate is never formed, because only the column du picks
// of each gathered row is ever used, so each output reads one dv element
// and one pixel.
//
// Out of range: a column c outside [0, S), a row r outside [0, S), or a
// pixel outside the image gives NaN (the window is not moved into the
// image), as the plain version (ops/image_gather.
// gather_window_two_step_reference) does.
//
// Bound: bytes.  At the probe's shape (128 blocks x 512 rows, S = 256,
// keep = 128) the kernel must read du[..., :128] (33.5 MB), the 32-byte
// sectors of dv that the picks land in (128 random picks of a 1 KB row
// touch nearly all of its 32 sectors: about 67 MB) and write 33.5 MB, with
// the 1.2 MB image and the origins once: about 40 us at 3.35 TB/s.  It is
// the one probe kernel whose traffic exceeds the L2.
//
// Design: one CTA of 128 threads per (b, i) row, threads over j (a loop
// when keep > 128).  The du load and the output store are coalesced (128 B
// a warp); the dv pick lands inside the row's own 1 KB; the pixel read goes
// through the read-only path (__ldg).  16 such CTAs fill an SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
window_gather_two_step_kernel(const float* __restrict__ img,
                              const int32_t* __restrict__ v0,
                              const int32_t* __restrict__ u0,
                              const int32_t* __restrict__ dv,
                              const int32_t* __restrict__ du,
                              float* __restrict__ out,
                              int H, int W, int R, int S, int keep) {
  const int64_t row = blockIdx.x;          // b * R + i
  const int b = static_cast<int>(row / R);
  const int64_t in_base = row * S;
  const int64_t out_base = row * keep;
  const int vb = __ldg(v0 + b);
  const int ub = __ldg(u0 + b);
  for (int j = threadIdx.x; j < keep; j += kThreads) {
    float val = __int_as_float(0x7fc00000);
    const int c = __ldg(du + in_base + j);
    if (c >= 0 && c < S) {
      const int r = __ldg(dv + in_base + c);
      const int y = vb + r;
      const int x = ub + c;
      if (r >= 0 && r < S && y >= 0 && y < H && x >= 0 && x < W) {
        val = __ldg(img + static_cast<int64_t>(y) * W + x);
      }
    }
    out[out_base + j] = val;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  dv and du are (NB, R, S),
// out (NB, R, keep) with keep <= S.  Launches on ``stream`` and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int window_gather_two_step(
    const float* img, const int32_t* v0, const int32_t* u0,
    const int32_t* dv, const int32_t* du, float* out, int H, int W, int NB,
    int R, int S, int keep, void* stream) {
  const int64_t rows = static_cast<int64_t>(NB) * R;
  if (rows <= 0 || keep <= 0) return 0;
  if (keep > S || rows > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  window_gather_two_step_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      img, v0, u0, dv, du, out, H, W, R, S, keep);
  return static_cast<int>(cudaGetLastError());
}
