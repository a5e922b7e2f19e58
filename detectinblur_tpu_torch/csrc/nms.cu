// Exact greedy-NMS aliveness over score-sorted boxes, for Hopper (sm_90a).
//
// Replaces the device-side scan of detectinblur_tpu/ops/nms.py::_alive_sorted
// (a lax.scan over blocks of 128 boxes, each block a lax.while_loop fixpoint
// of the rank-masked suppression operator). JAX left it to XLA; the port's
// plain version (ops/nms.py::_alive_sorted_plain) is a Python loop over the
// blocks that reads a convergence test back on the host in every block.
//
// What it computes, for each of M independent problems of N boxes sorted by
// descending score: box r removes box c when r < c, r is still alive and
// IoU(r, c) > thr; dead entries never remove and are never revived. The
// result is the alive mask after exact greedy suppression, the fixpoint
// that JAX's blocked scan reaches.
//
// Design: two kernels on the caller's stream, and a scratch bitmask the
// wrapper allocates ([M, N, ceil(N/64)] 64-bit words).
//   (a) nms_mask_kernel: a grid over (column word, row word, problem). The
//       column word's 64 boxes and their areas sit in shared memory; thread
//       t takes row r = 64 * row word + t and writes one word, bit j set when
//       IoU(r, c) > thr for c = 64 * column word + j > r. Blocks left of the
//       diagonal exit at once: the scan never reads those words.
//   (b) nms_scan_kernel: one warp per problem walks the 64-box words in
//       order, with the removed bits of every word in shared memory. For
//       word wb, the candidates are its alive, not yet removed boxes; the
//       warp resolves them in rank order from the rows' diagonal words
//       (each kept row clears the candidates it overlaps, one shuffle a
//       kept row), then each lane ORs the kept rows' words into the removed
//       bits of the later words it owns, 8 loads in flight.
// Why this and not a kernel per block of 128 as in JAX: the pairwise test is
// parallel and is what costs operations, so it gets the whole card; the
// greedy order is sequential but touches only bits, so one warp walks it in
// registers and shared memory, with no fixpoint iteration and no host.
//
// Exactness: the IoU is ops/boxes.py::box_iou (= detectinblur_tpu/ops/
// nms.py:90-99) operation for operation, each one correctly rounded through
// the _rn intrinsics so that nvcc cannot contract a product and a sum into
// an FMA: area = (x2 - x1) * (y2 - y1); lt = max, rb = min; wh = clamp(rb -
// lt, 0); inter = wh0 * wh1; union = (area_r + area_c) - inter; inter /
// max(union, 1e-12f); compared with the threshold in float32. max, min and
// clamp propagate NaN as torch.maximum / torch.clamp and jnp.maximum do, so
// a NaN coordinate removes nothing on either side.
//
// What bounds it on this card: operations. At the train RPN's 40 problems of
// 2000 boxes the pairwise test is 40 x 2000 x 1999 / 2 = 80M IoUs of ~14
// float32 operations, ~17 us at 67 TFLOP/s, against 1.4 MB of boxes and
// masks (0.4 us at 3.35 TB/s). The scan's N sequential steps (N/64 words,
// one shuffle per kept box) no roofline counts; at B = 1 the postprocess is
// one problem, so one warp walks its 4096 boxes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWord = 64;                 // boxes per bitmask word
constexpr unsigned kFull = 0xffffffffu;
constexpr int kInFlight = 8;              // mask rows loaded at once in the OR

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __fadd_rn(a, b) : fmaxf(a, b);
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __fadd_rn(a, b) : fminf(a, b);
}

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// IoU(r, c) > thr, in box_iou's order of operations.
__device__ __forceinline__ bool overlaps(float4 r, float area_r, float4 c,
                                         float area_c, float thr) {
  const float w = max_nan(__fsub_rn(min_nan(r.z, c.z), max_nan(r.x, c.x)), 0.0f);
  const float h = max_nan(__fsub_rn(min_nan(r.w, c.w), max_nan(r.y, c.y)), 0.0f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(area_r, area_c), inter);
  return __fdiv_rn(inter, max_nan(uni, 1e-12f)) > thr;
}

__global__ void __launch_bounds__(kWord)
nms_mask_kernel(const float4* __restrict__ boxes,
                unsigned long long* __restrict__ mask, int n, int words,
                float thr) {
  const int cw = blockIdx.x, rw = blockIdx.y, t = threadIdx.x;
  if (cw < rw) return;
  const float4* pb = boxes + static_cast<size_t>(blockIdx.z) * n;
  __shared__ float4 cbox[kWord];
  __shared__ float carea[kWord];
  const int c = cw * kWord + t;
  if (c < n) {
    const float4 b = pb[c];
    cbox[t] = b;
    carea[t] = area(b);
  }
  __syncthreads();
  const int r = rw * kWord + t;
  if (r >= n) return;
  const float4 rb = pb[r];
  const float ra = area(rb);
  const int ncols = min(kWord, n - cw * kWord);
  unsigned long long bits = 0;
  for (int j = cw == rw ? t + 1 : 0; j < ncols; ++j) {
    if (overlaps(rb, ra, cbox[j], carea[j], thr)) bits |= 1ull << j;
  }
  mask[(static_cast<size_t>(blockIdx.z) * n + r) * words + cw] = bits;
}

__global__ void __launch_bounds__(32)
nms_scan_kernel(const unsigned long long* __restrict__ mask,
                const uint8_t* __restrict__ alive_in,
                uint8_t* __restrict__ alive_out, int n, int words) {
  extern __shared__ unsigned long long removed[];
  const int lane = threadIdx.x;
  const size_t m = blockIdx.x;
  const uint8_t* ain = alive_in + m * n;
  uint8_t* aout = alive_out + m * n;
  const unsigned long long* mk = mask + m * n * words;
  for (int w = lane; w < words; w += 32) removed[w] = 0;
  __syncwarp();

  for (int wb = 0; wb < words; ++wb) {
    const int r0 = wb * kWord + lane, r1 = r0 + 32;
    const bool in0 = r0 < n, in1 = r1 < n;
    const unsigned lo = __ballot_sync(kFull, in0 && ain[r0]);
    const unsigned hi = __ballot_sync(kFull, in1 && ain[r1]);
    // Row r's diagonal word: the boxes of this word after r that it removes.
    const unsigned long long d0 = in0 ? mk[r0 * static_cast<size_t>(words) + wb] : 0;
    const unsigned long long d1 = in1 ? mk[r1 * static_cast<size_t>(words) + wb] : 0;
    unsigned long long cand =
        ((static_cast<unsigned long long>(hi) << 32) | lo) & ~removed[wb];
    unsigned long long keep = 0;
    while (cand) {  // the same on every lane
      const int i = __ffsll(static_cast<long long>(cand)) - 1;
      const unsigned long long d = __shfl_sync(kFull, i < 32 ? d0 : d1, i & 31);
      keep |= 1ull << i;
      cand &= ~(d | (1ull << i));
    }
    if (in0) aout[r0] = (keep >> lane) & 1;
    if (in1) aout[r1] = (keep >> (lane + 32)) & 1;

    // The kept boxes remove what they overlap in every later word.
    const unsigned long long* rows = mk + static_cast<size_t>(wb) * kWord * words;
    for (int w = wb + 1 + lane; w < words; w += 32) {
      unsigned long long acc = removed[w];
      unsigned long long k = keep;
      while (k) {
        unsigned long long v[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          v[u] = 0;
          if (k) {
            const int i = __ffsll(static_cast<long long>(k)) - 1;
            k &= k - 1;
            v[u] = rows[static_cast<size_t>(i) * words + w];
          }
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) acc |= v[u];
      }
      removed[w] = acc;
    }
    __syncwarp();
  }
}

}  // namespace

// boxes [M, N, 4] float32 and alive_in / alive_out [M, N] bytes (0 or 1),
// contiguous; mask an [M, N, ceil(N/64)] 64-bit scratch. Launches both
// kernels on `stream`; returns cudaGetLastError() after them.
extern "C" int nms_alive(const void* boxes, const void* alive_in,
                         void* alive_out, void* mask, int m, int n, float thr,
                         void* stream) {
  const int words = (n + kWord - 1) / kWord;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_mask_kernel<<<dim3(words, words, m), kWord, 0, s>>>(
      static_cast<const float4*>(boxes),
      static_cast<unsigned long long*>(mask), n, words, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nms_scan_kernel<<<m, 32, words * sizeof(unsigned long long), s>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const uint8_t*>(alive_in), static_cast<uint8_t*>(alive_out),
      n, words);
  return cudaGetLastError();
}
