// Multi-scale (FPN) RoIAlign backward for Hopper (sm_90a).
//
// Replaces detectinblur_tpu/ops/roi_align_pallas.py::_bwd_kernel_factory (the
// Pallas TPU backward kernel, launched by _pallas_roi_align_bwd and completed
// by _oversized_grads). Same function: the transpose of the forward over the
// same sample geometry. For roi n of image n / rois_per_image on level
// level[n], bin (i, j) and channel c, every sample (sy, sx) of the bin and
// every bilinear corner (a, b) receives
//
//   grad_l[img, y_idx[n, sy, a], x_idx[n, sx, b], c] +=
//       dout[n, i, j, c] * y_w[n, sy, a] * x_w[n, sx, b] / 4
//
// summed over all rois in float32. The geometry table is the one the forward
// read (ops/roi_align.py::roi_geometry, saved by the autograd Function), so
// the two directions cannot disagree on a level or a sample position.
// Out-of-range samples carry zero weights and are skipped.
//
// What bounds it on this card: bytes. Every level gradient is a float32
// NHWC buffer the wrapper zero-fills (at the train shapes, 8 images on the
// 832x1088 bucket with C = 256, P2..P5 are ~615 MB); the kernel reads the
// cotangent once and does a float32 read-modify-write of every feature cell
// some sample corner touches. 16 multiply-adds per cotangent element are far
// below the card's rate. The smoke script counts the bytes of its own run
// and reports the bound.
//
// Design: the forward's layout. One block per roi, threadIdx.y = bin row
// (7), threadIdx.x runs over the channels with one 16-byte cotangent vector
// per thread (4 f32 or 8 bf16), so each corner update of a warp touches one
// contiguous run of the cell's channels. Rois of one image overlap, and so
// do the samples of neighbouring bins, and blocks run in no order on the
// SMs, so the updates are float32 atomicAdd (RED) into device memory: no
// block can own a window the way a TPU chain does. A roi whose whole
// cotangent is zero (the unsampled slots the masked losses leave, the
// counterpart of the TPU kernel's class-0 rule) returns before any update.
// Nothing of the TPU design carries over: no windows, chains or
// selection-matrix matmuls, hence no oversized tiers and no escape path.
//
// Atomic order changes from run to run, so results are not bitwise
// repeatable: each cell is a float32 sum of up to 16 x (overlapping rois)
// terms in varying order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOut = 7;       // bins per axis
constexpr int kSamples = 14;  // kOut x sampling ratio 2

struct Grads {
  float* ptr[4];
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
};

template <int V>
__device__ __forceinline__ void scatter(float* p, float w, const float (&d)[V]) {
  if (w == 0.f) return;
#pragma unroll
  for (int k = 0; k < V; ++k) atomicAdd(p + k, w * d[k]);
}

// At most kMaxThreadsX x kOut threads a block, as the forward.
constexpr int kMaxThreadsX = 64;

template <typename T>
__global__ void __launch_bounds__(kMaxThreadsX * kOut) roi_align_bwd_kernel(
    Grads gr, const int* __restrict__ level, const int2* __restrict__ y_idx,
    const float2* __restrict__ y_w, const int2* __restrict__ x_idx,
    const float2* __restrict__ x_w, const T* __restrict__ dout,
    int rois_per_image, int channels) {
  constexpr int V = Vec<T>::N;
  const int n = blockIdx.x;
  const int py = threadIdx.y;
  const T* dout_row = dout + (static_cast<size_t>(n) * kOut + py) * kOut * channels;

  bool nonzero = false;
  for (int c = threadIdx.x * V; c < channels; c += blockDim.x * V) {
    for (int px = 0; px < kOut; ++px) {
      float d[V];
      Vec<T>::load(dout_row + static_cast<size_t>(px) * channels + c, d);
#pragma unroll
      for (int k = 0; k < V; ++k) nonzero |= d[k] != 0.f;
    }
  }
  if (!__syncthreads_or(nonzero)) return;

  const int l = level[n];
  const int W = gr.w[l];
  const size_t img_cells = static_cast<size_t>(gr.h[l]) * W;
  float* base = gr.ptr[l] + static_cast<size_t>(n / rois_per_image) * img_cells * channels;

  int2 yi[2];
  float2 yw[2];
#pragma unroll
  for (int iy = 0; iy < 2; ++iy) {
    yi[iy] = y_idx[n * kSamples + 2 * py + iy];
    yw[iy] = y_w[n * kSamples + 2 * py + iy];
  }

  for (int c = threadIdx.x * V; c < channels; c += blockDim.x * V) {
    for (int px = 0; px < kOut; ++px) {
      float d[V];
      Vec<T>::load(dout_row + static_cast<size_t>(px) * channels + c, d);
#pragma unroll
      for (int k = 0; k < V; ++k) d[k] *= 0.25f;
#pragma unroll
      for (int iy = 0; iy < 2; ++iy) {
        float* row_lo = base + static_cast<size_t>(yi[iy].x) * W * channels + c;
        float* row_hi = base + static_cast<size_t>(yi[iy].y) * W * channels + c;
#pragma unroll
        for (int ix = 0; ix < 2; ++ix) {
          const int2 xi = x_idx[n * kSamples + 2 * px + ix];
          const float2 xw = x_w[n * kSamples + 2 * px + ix];
          scatter<V>(row_lo + static_cast<size_t>(xi.x) * channels, yw[iy].x * xw.x, d);
          scatter<V>(row_lo + static_cast<size_t>(xi.y) * channels, yw[iy].x * xw.y, d);
          scatter<V>(row_hi + static_cast<size_t>(xi.x) * channels, yw[iy].y * xw.x, d);
          scatter<V>(row_hi + static_cast<size_t>(xi.y) * channels, yw[iy].y * xw.y, d);
        }
      }
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 cotangent. g0..g3 are 4 contiguous,
// zero-initialised float32 NHWC level gradients sharing B and C; the geometry
// tables are [n_rois, 14, 2]; dout is [n_rois, 7, 7, C]. Accumulates into the
// gradients on `stream` and returns cudaGetLastError().
extern "C" int roi_align_bwd(int dtype, void* g0, void* g1, void* g2, void* g3,
                             int h0, int w0, int h1, int w1, int h2, int w2,
                             int h3, int w3, const void* level,
                             const void* y_idx, const void* y_w,
                             const void* x_idx, const void* x_w,
                             const void* dout, int n_rois, int rois_per_image,
                             int channels, void* stream) {
  if (n_rois == 0) return 0;
  const Grads gr = {{static_cast<float*>(g0), static_cast<float*>(g1),
                     static_cast<float*>(g2), static_cast<float*>(g3)},
                    {h0, h1, h2, h3},
                    {w0, w1, w2, w3}};
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
    roi_align_bwd_kernel<float><<<grid, block, 0, s>>>(
        gr, lvl, yi, yw, xi, xw, static_cast<const float*>(dout), rois_per_image,
        channels);
  } else if (dtype == 1) {
    roi_align_bwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        gr, lvl, yi, yw, xi, xw, static_cast<const __nv_bfloat16*>(dout),
        rois_per_image, channels);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
