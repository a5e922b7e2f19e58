// The epilogue of a convolution whose frozen BatchNorm scale was folded
// into its weight, for Hopper (sm_90a):
//
//     out = relu(y + shift [+ residual])
//
// over channels-last [N, H, W, C] tensors, with shift a float32 [C].
//
// Replaces no TPU kernel: the JAX package computes conv, x * scale + bias,
// the residual add and the ReLU as XLA ops, and XLA fuses what follows
// each convolution. As separate PyTorch elementwise ops they are five
// passes over the activation, and the (C, 1, 1)-broadcast mul and add on
// channels-last bf16 miss PyTorch's vectorised path (models/resnet.py,
// ops/conv_epilogue.py).
//
// What bounds it on this card: bytes. y (and the residual) are read once
// and out written once; shift is a few KB and stays in L1. At the
// detect_b8 cell's shapes (8 images, bucket 832x1088) the largest pass,
// 8 x 256 x 208 x 272 bf16 with a residual, moves 695 MB: 0.207 ms at
// 3.35 TB/s.
//
// Design: a grid-stride loop over 16-byte vectors (8 bf16 or 4 f32) of
// the flat buffer, 256 threads a block and 8 blocks an SM, so that every
// SM holds 2048 threads with one or two 16-byte loads each in flight. C is
// a multiple of the vector width (the wrapper refuses anything else), so a
// vector never straddles two pixels: its channels are c0 .. c0 + width - 1
// with c0 = (vector index mod C / width) x width. Each element is summed
// in float32 in the order (y + shift) + residual, ReLU'd and rounded once
// to the tensors' type, as the plain version in ops/conv_epilogue.py
// does, so the two agree bit for bit. Indices are 32-bit inside a launch:
// the C entry cuts a larger tensor into launches of whole pixels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kMaxDevices = 64;

// 16 bytes of channels, 4 f32 or 8 bf16, as float32 values.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float (&v)[N]) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  }
  __device__ static void store(float* p, const float (&v)[N]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&v)[N]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&v)[N]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

template <typename T, bool kResidual>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    conv_epilogue_kernel(const T* __restrict__ y, const float* __restrict__ shift,
                         const T* __restrict__ residual, T* __restrict__ out,
                         uint32_t n_vec, uint32_t c_vec) {
  constexpr int N = Vec<T>::N;
  const uint32_t stride = gridDim.x * kThreads;
  for (uint32_t v = blockIdx.x * kThreads + threadIdx.x; v < n_vec; v += stride) {
    const size_t at = static_cast<size_t>(v) * N;
    float a[N], s[N];
    Vec<T>::load(y + at, a);
    const float4* sp = reinterpret_cast<const float4*>(shift + (v % c_vec) * N);
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 q = __ldg(sp + i);
      s[4 * i] = q.x, s[4 * i + 1] = q.y, s[4 * i + 2] = q.z, s[4 * i + 3] = q.w;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) a[i] += s[i];
    if (kResidual) {
      float r[N];
      Vec<T>::load(residual + at, r);
#pragma unroll
      for (int i = 0; i < N; ++i) a[i] += r[i];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) a[i] = a[i] < 0.0f ? 0.0f : a[i];  // NaN stays NaN, as torch.relu
    Vec<T>::store(out + at, a);
  }
}

int sm_count() {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0) return 0;
  if (dev < kMaxDevices && cached[dev]) return cached[dev];
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices) cached[dev] = sms;
  return sms;
}

template <typename T, bool kResidual>
int launch(const void* y, const float* shift, const void* residual, void* out,
           int64_t numel, int channels, cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  const int sms = sm_count();
  if (sms == 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int64_t c_vec = channels / N;
  // Launches of whole pixels, each under 2^31 vectors.
  const int64_t chunk = (int64_t{1} << 31) / c_vec * c_vec;
  const int64_t n_vec = numel / N;
  for (int64_t start = 0; start < n_vec; start += chunk) {
    const int64_t n = n_vec - start < chunk ? n_vec - start : chunk;
    const int64_t want = (n + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(want < int64_t{sms} * kBlocksPerSm ? want : int64_t{sms} * kBlocksPerSm);
    const size_t at = static_cast<size_t>(start) * N;
    conv_epilogue_kernel<T, kResidual><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(y) + at, shift,
        kResidual ? static_cast<const T*>(residual) + at : nullptr,
        static_cast<T*>(out) + at, static_cast<uint32_t>(n), static_cast<uint32_t>(c_vec));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

template <typename T>
int dispatch(const void* y, const float* shift, const void* residual, void* out,
             int64_t numel, int channels, cudaStream_t stream) {
  return residual ? launch<T, true>(y, shift, residual, out, numel, channels, stream)
                  : launch<T, false>(y, shift, residual, out, numel, channels, stream);
}

}  // namespace

// dtype 0 float32, 1 bfloat16. y, residual (or null) and out are
// channels-last with `channels` innermost, `numel` elements, 16-byte
// aligned, out apart from the others; shift is float32 [channels], 16-byte aligned. Launches on
// `stream`, synchronises nothing and returns cudaGetLastError() after the
// launches (cudaErrorInvalidValue for a type or a channel count the kernel
// does not take).
extern "C" int conv_epilogue(int dtype, const void* y, const void* shift,
                             const void* residual, void* out, int64_t numel,
                             int channels, void* stream) {
  if (numel == 0) return static_cast<int>(cudaSuccess);
  if (channels <= 0 || channels % 8 || numel % channels)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sh = static_cast<const float*>(shift);
  if (dtype == 0) return dispatch<float>(y, sh, residual, out, numel, channels, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(y, sh, residual, out, numel, channels, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
