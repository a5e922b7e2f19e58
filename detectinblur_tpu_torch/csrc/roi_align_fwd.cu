// Multi-scale (FPN) RoIAlign forward for Hopper (sm_90a).
//
// Replaces detectinblur_tpu/ops/roi_align_pallas.py::_kernel_factory (the
// Pallas TPU forward kernel, launched by _kernel_pass). Same function: for
// each roi of each image, on the FPN level picked by torchvision's level
// mapper, average 2x2 bilinear samples per bin over a 7x7 grid, with torch
// roi_align(aligned=False) semantics.
//
// The level and every sample's corner indices and weights come in
// precomputed, from ops/roi_align.py::roi_geometry, the same table the
// plain torch version reads. Out-of-range samples arrive with zero weights.
//
// What bounds it on this card: bytes. At the serving shapes (8 images x
// 1000 rois, C = 256, bucket 832x1088) the output alone is 8000 x 49 x 256
// = 100,352,000 elements: 200.7 MB in bf16, 401.4 MB in f32, i.e. 59.9 us
// and 119.8 us at 3.35 TB/s. The unique feature cells the rois' corners
// touch come on top of that (the smoke script counts them from its own
// inputs and reports the bound). What sets its time is the latency of the
// corner fetches in flight, most of which hit L1.
//
// Design: one block per roi and 512-byte slice of each cell's channels
// (256 bf16, 128 f32): 7 warps, warp j for bin column j, a lane for each
// 16-byte vector. Warp j loads its bin column's 4 corner columns and
// weights once, then for each bin row i gathers the bin's 4 x 4 corner
// cells straight from the level (read-only path, 8 loads in flight),
// sums them in float32 and writes out[i, j] once, in the features' dtype.
// The 7 warps of a block read overlapping cells, which L1 serves. The
// launch bound asks for 4 blocks (28 warps) an SM, which holds ptxas to 72
// registers with no spill; more blocks in flight hide more fetch latency.
//
// Not separable. The separable form out = Ay F[Ys, Xs] Ax^T, which the
// backward uses (roi_align_bwd.cu), reads each unique cell once per roi,
// but a block must then walk the roi's up to 28 unique rows in order, a
// barrier and a round trip to L2 per row. Measured on the card, that walk
// lost to this gather on the serving rois, and a kernel holding both forms
// lost on them too: the walk's shared-memory ring and registers cut the
// blocks in flight for every roi. Numbers in PERF.md.
//
// No tiers: corners are read straight from device memory, so no window
// can overflow. The TPU kernel's oversized-roi tiers exist only because a
// DMA window has a fixed size.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOut = 7;       // bins per axis
constexpr int kSamples = 14;  // kOut x sampling ratio 2
constexpr int kVecs = 32;     // 16-byte vectors of a block's slice: 512 bytes of a cell

struct Levels {
  const void* ptr[4];
  int h[4];
  int w[4];
};

// 16 bytes of channels, 4 f32 or 8 bf16, as raw bits.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void fma(float (&acc)[N], uint4 v, float w) {
    acc[0] += w * __uint_as_float(v.x);
    acc[1] += w * __uint_as_float(v.y);
    acc[2] += w * __uint_as_float(v.z);
    acc[3] += w * __uint_as_float(v.w);
  }
  __device__ static void store(float* p, const float (&v)[N]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void fma(float (&acc)[N], uint4 v, float w) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      acc[2 * k] += w * f.x;
      acc[2 * k + 1] += w * f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&v)[N]) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
};

template <typename T>
__global__ void __launch_bounds__(kVecs * kOut, 4) roi_align_fwd_kernel(
    Levels lv, const int* __restrict__ level, const int2* __restrict__ y_idx,
    const float2* __restrict__ y_w, const int2* __restrict__ x_idx,
    const float2* __restrict__ x_w, T* __restrict__ out, int rois_per_image,
    int channels) {
  constexpr int V = Vec<T>::N;
  const int n = blockIdx.x;
  const int j = threadIdx.y;  // bin column
  const int c = blockIdx.y * kVecs * V + threadIdx.x * V;
  if (c >= channels) return;
  const int l = level[n];
  const int W = lv.w[l];
  const size_t img_cells = static_cast<size_t>(lv.h[l]) * W;
  const T* fc = static_cast<const T*>(lv.ptr[l]) +
                static_cast<size_t>(n / rois_per_image) * img_cells * channels + c;
  const size_t row_stride = static_cast<size_t>(W) * channels;
  const int2* yi = y_idx + n * kSamples;
  const float2* yw = y_w + n * kSamples;

  // Bin column j's 4 corner columns and their weights, with the 1/4 of
  // the mean over the bin's 2 x 2 samples.
  int cx[4];
  float wx[4];
#pragma unroll
  for (int sp = 0; sp < 2; ++sp) {
    const int2 c2 = x_idx[n * kSamples + 2 * j + sp];
    const float2 w2 = x_w[n * kSamples + 2 * j + sp];
    cx[2 * sp] = c2.x; cx[2 * sp + 1] = c2.y;
    wx[2 * sp] = 0.25f * w2.x; wx[2 * sp + 1] = 0.25f * w2.y;
  }
  T* out_col = out + (static_cast<size_t>(n) * kOut * kOut + j) * channels + c;
#pragma unroll 1
  for (int i = 0; i < kOut; ++i) {
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;
#pragma unroll
    for (int sp = 0; sp < 2; ++sp) {
      const int2 r2 = yi[2 * i + sp];
      const float2 w2 = yw[2 * i + sp];
      const T* lo = fc + r2.x * row_stride;
      const T* hi = fc + r2.y * row_stride;
      uint4 v[2][4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        v[0][b] = __ldg(reinterpret_cast<const uint4*>(lo + static_cast<size_t>(cx[b]) * channels));
        v[1][b] = __ldg(reinterpret_cast<const uint4*>(hi + static_cast<size_t>(cx[b]) * channels));
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        Vec<T>::fma(acc, v[0][b], w2.x * wx[b]);
        Vec<T>::fma(acc, v[1][b], w2.y * wx[b]);
      }
    }
    Vec<T>::store(out_col + static_cast<size_t>(i) * kOut * channels, acc);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Features are 4 contiguous NHWC levels
// sharing B and C (C a multiple of 16 bytes); the geometry tables are [n_rois, 14, 2]; out is
// [n_rois, 7, 7, C]. Launches on `stream` and returns cudaGetLastError().
extern "C" int roi_align_fwd(int dtype, const void* f0, const void* f1,
                             const void* f2, const void* f3, int h0, int w0,
                             int h1, int w1, int h2, int w2, int h3, int w3,
                             const void* level, const void* y_idx,
                             const void* y_w, const void* x_idx,
                             const void* x_w, void* out, int n_rois,
                             int rois_per_image, int channels, void* stream) {
  if (n_rois == 0) return 0;
  const int vec = dtype == 0 ? Vec<float>::N : Vec<__nv_bfloat16>::N;
  if (channels % vec) return static_cast<int>(cudaErrorInvalidValue);
  const Levels lv = {{f0, f1, f2, f3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}};
  // One block per roi and slice of 512 bytes of each cell's channels.
  const int slice = kVecs * vec;
  const dim3 block(kVecs, kOut);
  const dim3 grid(n_rois, (channels + slice - 1) / slice);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lvl = static_cast<const int*>(level);
  const int2* yi = static_cast<const int2*>(y_idx);
  const float2* yw = static_cast<const float2*>(y_w);
  const int2* xi = static_cast<const int2*>(x_idx);
  const float2* xw = static_cast<const float2*>(x_w);
  if (dtype == 0) {
    roi_align_fwd_kernel<float><<<grid, block, 0, s>>>(
        lv, lvl, yi, yw, xi, xw, static_cast<float*>(out), rois_per_image, channels);
  } else if (dtype == 1) {
    roi_align_fwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        lv, lvl, yi, yw, xi, xw, static_cast<__nv_bfloat16*>(out), rois_per_image,
        channels);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
