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
//
// What bounds it on this card: bytes. Every level gradient is a float32
// NHWC buffer the wrapper zero-fills (at the train shapes, 8 images on the
// 832x1088 bucket with C = 256, P2..P5 are ~615 MB) and casts to the
// features' dtype afterwards; the kernel reads the cotangent once and does
// a float32 read-modify-write of every feature cell some sample corner
// touches. The smoke script counts the bytes of its own run and reports
// the bound.
//
// Design: the separable form below, G_c = Ay^T dout_c Ax.
// One block per roi. A block first votes (__syncthreads_or) on its
// cotangent and returns if it is all zero: the unsampled slots the masked
// losses leave, the counterpart of the TPU kernel's class-0 rule. Warps 0
// and 1 then build the roi's unique rows Ys and columns Xs (at most 28
// each) and their 7-bin weights Ay, Ax in shared memory. Each thread owns
// two neighbouring channels and holds their 7 x 7 cotangent in registers.
// For each unique row r it forms U[j] = sum_i Ay[i, r] dout[i, j] over the
// bins i whose weight on r is nonzero, then for each unique column q issues
// ONE float2 reduction (atomicAdd on float2, a vector RED on sm_90) of
// sum_j U[j] Ax[j, q] into cell (Ys[r], Xs[q]). A warp's RED so covers 64
// consecutive channels of one cell (256 bytes), and a roi issues
// |Ys| x |Xs| of them per 64 channels: the touched cells, each once, where
// a RED per sample corner would be 784 per roi and channel.
//
// No tiers: a roi touches at most 28 x 28 cells whatever its size, so the
// lists never overflow and every roi's gradient is exact. The TPU's
// oversized tiers and take-VJP escape exist only because a DMA window has
// a fixed size.
//
// Rois of one image overlap and blocks run in no order on the SMs, so the
// updates are atomics: results are not bitwise repeatable, each cell being
// a float32 sum over the overlapping rois in varying order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The separable form. A roi's 14 sample rows depend only on sy and its 14
// sample columns only on sx (ops/roi_align.py::roi_geometry), so with 2x2
// samples per bin the forward is
//
//   out_c[i, j] = sum_{r, q} Ay[i, r] * F_c[Ys[r], Xs[q]] * Ax[j, q]
//
// where Ys are the sorted unique rows that some sample corner reaches with a
// nonzero weight (at most 14 samples x 2 corners = 28, whatever the roi's
// size), Xs the same for columns, and
//
//   Ay[i, r] = 1/2 * sum of y_w[sy, a] over the samples sy of bin i and the
//              corners a with y_idx[sy, a] == Ys[r]
//
// (Ax likewise; the two halves make the mean over the bin's 4 samples). The
// backward is its transpose, G_c = Ay^T * dout_c * Ax, whose nonzero cells
// are exactly Ys x Xs: every touched cell once per roi and channel.
constexpr int kOut = 7;                 // bins per axis
constexpr int kSamples = 14;            // kOut x sampling ratio 2
constexpr int kMaxCells = 2 * kSamples; // unique rows (columns) of one roi
constexpr int kPad = 32;                // list length: one entry per lane

// One axis of one roi, in shared memory.
struct __align__(16) Axis {
  int idx[kPad];     // the `count` sorted unique rows
  float w[kPad][8];  // w[r][i] = Ay[i, r]; w[r][7] and rows past count are 0
  int count;
};

// Fills `ax` from one roi's 14 samples (`idx`: low/high row, `wt`: their
// weights). All 32 lanes of one warp call it; lane k < 28 holds corner k & 1
// of sample k >> 1, which lies in bin k >> 2. Deterministic: each weight is
// summed in the same order on every run.
__device__ __forceinline__ void build_axis(Axis& ax, const int2* __restrict__ idx,
                                           const float2* __restrict__ wt, int lane) {
  constexpr unsigned kAll = 0xffffffffu;
  int v = 0;
  float w = 0.f;
  if (lane < kMaxCells) {
    const int2 i2 = idx[lane >> 1];
    const float2 w2 = wt[lane >> 1];
    v = (lane & 1) ? i2.y : i2.x;
    w = (lane & 1) ? w2.y : w2.x;
  }
  const bool valid = lane < kMaxCells && w != 0.f;
  const unsigned valids = __ballot_sync(kAll, valid);
  // The first lane holding a value owns it; every lane's rank is the number
  // of owned values below its own, so duplicates share a rank.
  bool first = valid;
  for (int k = 0; k < kMaxCells; ++k) {
    const int vk = __shfl_sync(kAll, v, k);
    if (k < lane && ((valids >> k) & 1) && vk == v) first = false;
  }
  const unsigned firsts = __ballot_sync(kAll, first);
  int rank = 0;
  for (int k = 0; k < kMaxCells; ++k) {
    const int vk = __shfl_sync(kAll, v, k);
    rank += ((firsts >> k) & 1) && vk < v;
  }
  const int count = __popc(firsts);
  for (int t = lane; t < kPad * 8; t += 32) (&ax.w[0][0])[t] = 0.f;
  if (first) ax.idx[rank] = v;
  __syncwarp();
  // Lanes 4i..4i+3 are bin i's corners: in step s only lanes with k & 3 == s
  // add, so no two lanes of a step share an entry.
  for (int s = 0; s < 4; ++s) {
    if ((lane & 3) == s && valid) ax.w[rank][lane >> 2] += 0.5f * w;
    __syncwarp();
  }
  if (lane == 0) ax.count = count;
}

// Bin weights of row (column) r: w[0..6], and w[7] == 0.
__device__ __forceinline__ void bin_weights(const Axis& ax, int r, float (&w)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(&ax.w[r][0]);
  const float4 b = *reinterpret_cast<const float4*>(&ax.w[r][4]);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

// Two neighbouring channels of a channels-last tensor, as float32.
template <typename T>
struct Pair;

template <>
struct Pair<float> {
  __device__ static float2 load(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
};

template <>
struct Pair<__nv_bfloat16> {
  __device__ static float2 load(const __nv_bfloat16* p) {
    const unsigned u = __ldg(reinterpret_cast<const unsigned*>(p));
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  }
};

// Threads of a block: one per pair of channels, whole warps, at most
// kMaxThreads (the rest loop).
constexpr int kMaxThreads = 128;
int block_threads(int channels) {
  int t = (channels / 2 + 31) / 32 * 32;
  if (t < 32) t = 32;
  return t > kMaxThreads ? kMaxThreads : t;
}

struct Grads {
  float* ptr[4];
  int h[4];
  int w[4];
};

// Magnitude bits of 16 bytes of cotangent: nonzero iff some element is
// neither +0 nor -0.
template <typename T>
__device__ __forceinline__ unsigned magnitude_bits(const T* p) {
  constexpr unsigned kMask = sizeof(T) == 4 ? 0x7fffffffu : 0x7fff7fffu;
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  return (q.x | q.y | q.z | q.w) & kMask;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) roi_align_bwd_kernel(
    Grads gr, const int* __restrict__ level, const int2* __restrict__ y_idx,
    const float2* __restrict__ y_w, const int2* __restrict__ x_idx,
    const float2* __restrict__ x_w, const T* __restrict__ dout,
    int rois_per_image, int channels) {
  __shared__ Axis ys, xs;
  constexpr int kVec = 16 / sizeof(T);
  const int n = blockIdx.x;
  const T* d_roi = dout + static_cast<size_t>(n) * kOut * kOut * channels;

  unsigned bits = 0;
  for (int e = threadIdx.x * kVec; e < kOut * kOut * channels; e += blockDim.x * kVec)
    bits |= magnitude_bits(d_roi + e);
  if (!__syncthreads_or(bits != 0)) return;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0)
    build_axis(ys, y_idx + n * kSamples, y_w + n * kSamples, lane);
  if (warp == (blockDim.x > 32 ? 1 : 0))
    build_axis(xs, x_idx + n * kSamples, x_w + n * kSamples, lane);
  __syncthreads();

  const int l = level[n];
  const int W = gr.w[l];
  const size_t img_cells = static_cast<size_t>(gr.h[l]) * W;
  float* base = gr.ptr[l] + static_cast<size_t>(n / rois_per_image) * img_cells * channels;
  const size_t row_stride = static_cast<size_t>(W) * channels;
  const int ny = ys.count, nx = xs.count;

  for (int c = threadIdx.x * 2; c < channels; c += blockDim.x * 2) {
    float d[kOut][kOut][2];
#pragma unroll
    for (int i = 0; i < kOut; ++i)
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        const float2 v = Pair<T>::load(d_roi + static_cast<size_t>(i * kOut + j) * channels + c);
        d[i][j][0] = v.x;
        d[i][j][1] = v.y;
      }
    for (int r = 0; r < ny; ++r) {
      float ay[8];
      bin_weights(ys, r, ay);
      float u[kOut][2];
#pragma unroll
      for (int j = 0; j < kOut; ++j) u[j][0] = u[j][1] = 0.f;
#pragma unroll
      for (int i = 0; i < kOut; ++i) {
        if (ay[i] != 0.f) {
#pragma unroll
          for (int j = 0; j < kOut; ++j) {
            u[j][0] += ay[i] * d[i][j][0];
            u[j][1] += ay[i] * d[i][j][1];
          }
        }
      }
      float* row = base + ys.idx[r] * row_stride + c;
#pragma unroll 4
      for (int q = 0; q < nx; ++q) {
        float ax[8];
        bin_weights(xs, q, ax);
        float2 g = make_float2(0.f, 0.f);
#pragma unroll
        for (int j = 0; j < kOut; ++j) {
          g.x += ax[j] * u[j][0];
          g.y += ax[j] * u[j][1];
        }
        atomicAdd(reinterpret_cast<float2*>(row + static_cast<size_t>(xs.idx[q]) * channels), g);
      }
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 cotangent. g0..g3 are 4 contiguous,
// zero-initialised float32 NHWC level gradients sharing B and C; the geometry
// tables are [n_rois, 14, 2]; dout is [n_rois, 7, 7, C], C a multiple of 16
// bytes. Accumulates into the gradients on `stream` and returns
// cudaGetLastError().
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
  if (channels % (dtype == 0 ? 4 : 8)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(block_threads(channels));
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
