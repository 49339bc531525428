// Streamed window depth gather for TSDF integration, for Hopper (sm_90a).
//
// Replaces the TPU kernel voxelhashing_demo_tpu/ops/pallas_gather.py
// gather_depth_window_streamed (body _kernel_streamed), and computes that
// whole function: per block row c, the window origin (v0, u0) is the
// minimum (v, u) over the row's VALID voxels (invalid ones count as
// (H, W)), clipped to [0, H - wh] x [0, W - ww]; a voxel is covered when
// it is valid and inside the wh x ww window, and its value is depth[v, u]
// where covered, 0 elsewhere.  Same contract as window_gather.cu, for any
// number of rows C and any row length V.
//
// The TPU form streamed (C, V, ww) broadcast index arrays into the kernel
// and kept lane 0 of a 128-lane padded output, because Mosaic could not
// lower the compact kernel's relayout.  Neither has a counterpart here.
// What this kernel has of its own is the other decomposition of the work:
//
//   window_gather.cu          one CTA per row, one thread per voxel, the
//                             row minimum through a shared atomicMin and
//                             two __syncthreads; V <= 1024.
//   this file                 one WARP per row, kRowsPerCta rows per CTA.
//                             Each lane strides over its row in chunks of
//                             four voxels: 16-byte loads of v and u, one
//                             4-byte load of valid, running minima in
//                             registers, and the row origin from two
//                             __reduce_min_sync.  No shared memory and no
//                             block barrier.  The second pass takes the
//                             first kKeep chunks of each lane from
//                             registers (all of them up to V = 512) and
//                             rereads later ones, gathers through __ldg
//                             and stores 16 bytes of values and 4 bytes of
//                             covered per chunk.
//
// Rows are read in 16-byte chunks only when every row starts on a 16-byte
// boundary (V % 4 == 0 and aligned base pointers); otherwise the whole row
// takes the scalar loop that also handles the tail.
//
// Bound: bytes.  14 B per voxel cross device memory (v 4, u 4, valid 1
// read; value 4, covered 1 written) plus the depth image once (H * W * 4):
// the per-voxel depth read is a random 4-byte gather into an image that
// stays in L2 and adds no device-memory traffic of its own.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerCta = 8;          // warps per CTA, one row each
constexpr int kKeep = 4;                // chunks per lane held in registers
constexpr unsigned kFull = 0xffffffffu;

struct Window {
  int v0, u0, wh, ww;
};

__device__ __forceinline__ void fold_min(int vi, int ui, unsigned ok,
                                         int& mv, int& mu) {
  if (ok) {
    mv = min(mv, vi);
    mu = min(mu, ui);
  }
}

__device__ __forceinline__ void fold_chunk(const int4& a, const int4& b,
                                           uint32_t m, int& mv, int& mu) {
  fold_min(a.x, b.x, m & 0xffu, mv, mu);
  fold_min(a.y, b.y, (m >> 8) & 0xffu, mv, mu);
  fold_min(a.z, b.z, (m >> 16) & 0xffu, mv, mu);
  fold_min(a.w, b.w, (m >> 24) & 0xffu, mv, mu);
}

// One voxel: covered flag (0/1) and value.
__device__ __forceinline__ unsigned gather_one(
    const float* __restrict__ depth, int W, const Window& win, int vi,
    int ui, unsigned ok, float& value) {
  const int dv = vi - win.v0;
  const int du = ui - win.u0;
  const bool cov = ok && dv >= 0 && dv < win.wh && du >= 0 && du < win.ww;
  value = cov ? __ldg(depth + static_cast<int64_t>(vi) * W + ui) : 0.0f;
  return cov ? 1u : 0u;
}

__device__ __forceinline__ void gather_chunk(
    const float* __restrict__ depth, int W, const Window& win,
    const int4& a, const int4& b, uint32_t m, float4* out, uint32_t* cov) {
  float4 r;
  uint32_t c = gather_one(depth, W, win, a.x, b.x, m & 0xffu, r.x);
  c |= gather_one(depth, W, win, a.y, b.y, (m >> 8) & 0xffu, r.y) << 8;
  c |= gather_one(depth, W, win, a.z, b.z, (m >> 16) & 0xffu, r.z) << 16;
  c |= gather_one(depth, W, win, a.w, b.w, (m >> 24) & 0xffu, r.w) << 24;
  *out = r;
  *cov = c;
}

// V4: number of 4-voxel chunks read with vector loads (V / 4, or 0 when
// rows are not 16-byte aligned); voxels from 4 * V4 on take the scalar
// loop.
__global__ void __launch_bounds__(kRowsPerCta * 32)
window_gather_streamed_kernel(
    const float* __restrict__ depth,
    const int32_t* __restrict__ v,
    const int32_t* __restrict__ u,
    const uint8_t* __restrict__ valid,
    float* __restrict__ out,
    uint8_t* __restrict__ covered,
    int H, int W, int C, int V, int V4, int wh, int ww) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerCta + (threadIdx.x >> 5);
  if (row >= C) return;                 // the whole warp leaves together
  const int64_t base = static_cast<int64_t>(row) * V;

  const int4* v4 = reinterpret_cast<const int4*>(v + base);
  const int4* u4 = reinterpret_cast<const int4*>(u + base);
  const uint32_t* m4 = reinterpret_cast<const uint32_t*>(valid + base);

  int mv = H;
  int mu = W;
  int4 rv[kKeep];
  int4 ru[kKeep];
  uint32_t rm[kKeep];
#pragma unroll
  for (int k = 0; k < kKeep; ++k) {
    const int j = lane + 32 * k;
    if (j < V4) {
      rv[k] = v4[j];
      ru[k] = u4[j];
      rm[k] = m4[j];
      fold_chunk(rv[k], ru[k], rm[k], mv, mu);
    }
  }
  for (int j = lane + 32 * kKeep; j < V4; j += 32) {
    fold_chunk(v4[j], u4[j], m4[j], mv, mu);
  }
  for (int i = 4 * V4 + lane; i < V; i += 32) {
    fold_min(v[base + i], u[base + i], valid[base + i], mv, mu);
  }
  mv = __reduce_min_sync(kFull, mv);
  mu = __reduce_min_sync(kFull, mu);

  Window win;
  win.v0 = min(max(mv, 0), max(H - wh, 0));
  win.u0 = min(max(mu, 0), max(W - ww, 0));
  win.wh = wh;
  win.ww = ww;

  float4* o4 = reinterpret_cast<float4*>(out + base);
  uint32_t* c4 = reinterpret_cast<uint32_t*>(covered + base);
#pragma unroll
  for (int k = 0; k < kKeep; ++k) {
    const int j = lane + 32 * k;
    if (j < V4) {
      gather_chunk(depth, W, win, rv[k], ru[k], rm[k], o4 + j, c4 + j);
    }
  }
  for (int j = lane + 32 * kKeep; j < V4; j += 32) {
    gather_chunk(depth, W, win, v4[j], u4[j], m4[j], o4 + j, c4 + j);
  }
  for (int i = 4 * V4 + lane; i < V; i += 32) {
    float value;
    const unsigned cov = gather_one(depth, W, win, v[base + i], u[base + i],
                                    valid[base + i], value);
    out[base + i] = value;
    covered[base + i] = static_cast<uint8_t>(cov);
  }
}

bool aligned(const void* p, uintptr_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on ``stream`` and
// returns cudaGetLastError() as an int (0 = launched).
extern "C" int window_gather_streamed(
    const float* depth, const int32_t* v, const int32_t* u,
    const uint8_t* valid, float* out, uint8_t* covered,
    int H, int W, int C, int V, int wh, int ww, void* stream) {
  if (C <= 0 || V <= 0) return 0;
  const bool vec = V % 4 == 0 && aligned(v, 16) && aligned(u, 16) &&
                   aligned(out, 16) && aligned(valid, 4) &&
                   aligned(covered, 4);
  const int V4 = vec ? V / 4 : 0;
  const int ctas = (C + kRowsPerCta - 1) / kRowsPerCta;
  window_gather_streamed_kernel<<<ctas, kRowsPerCta * 32, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      depth, v, u, valid, out, covered, H, W, C, V, V4, wh, ww);
  return static_cast<int>(cudaGetLastError());
}
