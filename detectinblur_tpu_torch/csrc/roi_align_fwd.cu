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
// plain torch version reads; the kernel only gathers and sums. Out-of-range
// samples arrive with zero weights.
//
// What bounds it on this card: bytes. Per output element it does 16
// multiply-adds (4 samples x 4 corners) against 16 reads that hit the
// roi's corner footprint, so arithmetic is far below the card's rate. At
// the serving shapes (8 images x 1000 rois, C = 256, bucket 832x1088) the
// output alone is 8000 x 49 x 256 = 100,352,000 elements: 200.7 MB in
// bf16, 401.4 MB in f32, i.e. 59.9 us and 119.8 us at 3.35 TB/s. The
// unique feature cells the rois' corners touch come on top of that (the
// smoke script counts them from its own inputs and reports the bound).
//
// Design: one block per roi, threadIdx.y = bin row (7), threadIdx.x runs
// over the channels with one 16-byte vector per thread (4 f32 or 8 bf16),
// so the 256-channel corner reads of a warp are coalesced: channels-last
// puts a cell's channels in one contiguous run. Sums are in f32; the output
// is written once, in the features' dtype. Nothing of the TPU design (window
// DMA, selection-matrix matmuls, oversized-roi tiers) carries over: corners
// are read straight from device memory, so there is no window to overflow.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOut = 7;       // bins per axis
constexpr int kSamples = 14;  // kOut x sampling ratio 2

struct Levels {
  const void* ptr[4];
  int h[4];
  int w[4];
};

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float (&v)[N]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  __device__ static void store(float* p, const float (&v)[N]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&v)[N]) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&v)[N]) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
};

// At most kMaxThreadsX x kOut threads a block: the bound lets ptxas give
// each thread up to 128 registers, so the 16 corner loads of a bin stay in
// flight without spilling (a 1024-thread bound capped it at 64 and spilled).
constexpr int kMaxThreadsX = 64;

template <typename T>
__global__ void __launch_bounds__(kMaxThreadsX * kOut) roi_align_fwd_kernel(
    Levels lv, const int* __restrict__ level, const int2* __restrict__ y_idx,
    const float2* __restrict__ y_w, const int2* __restrict__ x_idx,
    const float2* __restrict__ x_w, T* __restrict__ out, int rois_per_image,
    int channels) {
  constexpr int V = Vec<T>::N;
  const int n = blockIdx.x;
  const int py = threadIdx.y;
  const int l = level[n];
  const int W = lv.w[l];
  const size_t img_cells = static_cast<size_t>(lv.h[l]) * W;
  const T* base = static_cast<const T*>(lv.ptr[l]) +
                  static_cast<size_t>(n / rois_per_image) * img_cells * channels;

  int2 yi[2];
  float2 yw[2];
#pragma unroll
  for (int iy = 0; iy < 2; ++iy) {
    yi[iy] = y_idx[n * kSamples + 2 * py + iy];
    yw[iy] = y_w[n * kSamples + 2 * py + iy];
  }
  T* out_row = out + (static_cast<size_t>(n) * kOut + py) * kOut * channels;

  for (int c = threadIdx.x * V; c < channels; c += blockDim.x * V) {
    for (int px = 0; px < kOut; ++px) {
      float acc[V];
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = 0.f;
#pragma unroll
      for (int iy = 0; iy < 2; ++iy) {
        const T* row_lo = base + static_cast<size_t>(yi[iy].x) * W * channels + c;
        const T* row_hi = base + static_cast<size_t>(yi[iy].y) * W * channels + c;
#pragma unroll
        for (int ix = 0; ix < 2; ++ix) {
          const int2 xi = x_idx[n * kSamples + 2 * px + ix];
          const float2 xw = x_w[n * kSamples + 2 * px + ix];
          const float w00 = yw[iy].x * xw.x, w01 = yw[iy].x * xw.y;
          const float w10 = yw[iy].y * xw.x, w11 = yw[iy].y * xw.y;
          float v00[V], v01[V], v10[V], v11[V];
          Vec<T>::load(row_lo + static_cast<size_t>(xi.x) * channels, v00);
          Vec<T>::load(row_lo + static_cast<size_t>(xi.y) * channels, v01);
          Vec<T>::load(row_hi + static_cast<size_t>(xi.x) * channels, v10);
          Vec<T>::load(row_hi + static_cast<size_t>(xi.y) * channels, v11);
#pragma unroll
          for (int k = 0; k < V; ++k)
            acc[k] += v00[k] * w00 + v01[k] * w01 + v10[k] * w10 + v11[k] * w11;
        }
      }
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] *= 0.25f;
      Vec<T>::store(out_row + static_cast<size_t>(px) * channels + c, acc);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Features are 4 contiguous NHWC levels
// sharing B and C; the geometry tables are [n_rois, 14, 2]; out is
// [n_rois, 7, 7, C]. Launches on `stream` and returns cudaGetLastError().
extern "C" int roi_align_fwd(int dtype, const void* f0, const void* f1,
                             const void* f2, const void* f3, int h0, int w0,
                             int h1, int w1, int h2, int w2, int h3, int w3,
                             const void* level, const void* y_idx,
                             const void* y_w, const void* x_idx,
                             const void* x_w, void* out, int n_rois,
                             int rois_per_image, int channels, void* stream) {
  if (n_rois == 0) return 0;
  const Levels lv = {{f0, f1, f2, f3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}};
  const int vec = dtype == 0 ? Vec<float>::N : Vec<__nv_bfloat16>::N;
  int tx = channels / vec;
  if (tx > kMaxThreadsX) tx = kMaxThreadsX;
  const dim3 block(tx, kOut);
  const dim3 grid(n_rois);
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
