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
// wrapper allocates ([M, N, stride] 64-bit words, stride = ceil(N/64)
// rounded up to even).
//   (a) nms_mask_kernel: a grid over (column word, row word, problem). The
//       column word's 64 boxes and their areas sit in shared memory; thread
//       t takes row r = 64 * row word + t and writes one word, bit j set when
//       IoU(r, c) > thr for c = 64 * column word + j > r. Blocks left of the
//       diagonal exit at once: the scan never reads those words.
//   (b) nms_scan_kernel: one block of 10 warps per problem walks the 64-box
//       words in order. Word k's row block (rows 64k .. 64k+63, from column
//       word k rounded down to even) is contiguous per row in the scratch;
//       a loader warp stages it into shared memory, up to 8 stages ahead,
//       by TMA bulk copies (cp.async.bulk + mbarrier): a whole row block in
//       one copy where 4 fit in shared memory (N up to ~7000), else column
//       tiles of 64 words, one copy a row, so any N whose bit arrays fit
//       beside two tiles runs. A resolver warp takes
//       word k's candidates (alive, not removed), finds the kept ones as
//       the fixpoint of "stays unless a kept candidate before it overlaps
//       it" (one OR-reduction of the rows' diagonal words a round), ORs
//       the kept rows' next word into a register (the next word's removed
//       bits), and hands the kept bits to 8 worker warps, which OR them
//       into the removed bits of words k + 2 on (row slices merged by
//       shared-memory atomics) while the resolver goes on to word k + 1.
// Why: the scan's first version (one warp a problem, every row word fetched
// from device memory in the step that needs it, 8 loads in flight) cost
// ~10 us a word on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 14):
// 0.68 ms for the eval postprocess's 1 x 4096, 0.56-0.60 ms for the train
// RPN's 40 x 2000, 0.18 ms for the serving RPN's 40 x 1000, at 0.2% of its
// bound. Its bytes are few (the 4096-box upper triangle is ~1 MB); the
// latency of each step's dependent device-memory round trips set its time.
// Here a step's reads are shared-memory reads of a tile that landed while
// earlier words were resolved, and its critical path is the resolve and
// one OR-reduction; the rest of the ORs overlap the next word's resolve.
// Why two kernels and not a kernel per block of 128 as in JAX: the pairwise
// test is parallel and is what costs operations, so it gets the whole card;
// the greedy order is sequential but touches only bits, so one block walks
// it in registers and shared memory, with no host.
//
// Exactness: the IoU is ops/boxes.py::box_iou (= detectinblur_tpu/ops/
// nms.py:90-99) operation for operation, each one correctly rounded through
// the _rn intrinsics so that nvcc cannot contract a product and a sum into
// an FMA: area = (x2 - x1) * (y2 - y1); lt = max, rb = min; wh = clamp(rb -
// lt, 0); inter = wh0 * wh1; union = (area_r + area_c) - inter; inter /
// max(union, 1e-12f); compared with the threshold in float32. max, min and
// clamp propagate NaN as torch.maximum / torch.clamp and jnp.maximum do, so
// a NaN coordinate removes nothing on either side. The scan reads the same
// bits in another order: OR is commutative and idempotent, and the
// fixpoint of a word is unique (the greedy answer), so its result is the
// plain version's bit for bit.
//
// What bounds it on this card: operations. At the train RPN's 40 problems of
// 2000 boxes the pairwise test is 40 x 2000 x 1999 / 2 = 80M IoUs of ~14
// float32 operations, ~17 us at 67 TFLOP/s, against 1.4 MB of boxes and
// masks (0.4 us at 3.35 TB/s); chip_smoke.py counts only the pairs (kept r,
// alive c > r) a run's answer needs. No roofline counts the scan's chain of
// ceil(N/64) dependent steps (64 for the postprocess's 4096 candidates,
// 32 and 16 for the RPN's 2000 and 1000): its time is that chain's length
// times the cost of a step, which chip_smoke.py phase 14 reports: 0.58-1.05
// us a step on the paths' inputs with whole row blocks (0.067 ms for the
// eval's 1 x 4096 pool, 0.031 ms for the train RPN's 40 x 2000), 4.9 us a
// step in column tiles (16385 boxes), on an H100 80GB HBM3 at 700 W. The
// mask kernel then takes most of the RPN's time (0.168 ms of the train
// RPN's 0.198): its IoU division runs only for pairs that intersect.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kWord = 64;                 // boxes per bitmask word
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWorkers = 8;               // OR warps of the scan
constexpr int kRowsPerWorker = kWord / kWorkers;
constexpr int kScanThreads = 32 * (2 + kWorkers);  // resolver, loader, OR
constexpr int kMaxTile = 64;              // column words of a staged tile
constexpr int kMaxSlots = 8;              // staged tiles in flight
constexpr int kMinWholeSlots = 4;         // least whole row blocks in flight
static_assert(kRowsPerWorker * kWorkers == kWord, "row slices cover a word");

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
  // inter / max(union, 1e-12) is exactly +-0 when inter is +-0 and the
  // union is not NaN: boxes apart skip the division, the costliest step.
  if (inter == 0.0f && uni == uni) return 0.0f > thr;
  return __fdiv_rn(inter, max_nan(uni, 1e-12f)) > thr;
}

__global__ void __launch_bounds__(kWord)
nms_mask_kernel(const float4* __restrict__ boxes, u64* __restrict__ mask,
                int n, int stride, float thr) {
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
  u64 bits = 0;
  for (int j = cw == rw ? t + 1 : 0; j < ncols; ++j) {
    if (overlaps(rb, ra, cbox[j], carea[j], thr)) bits |= 1ull << j;
  }
  mask[(static_cast<size_t>(blockIdx.z) * n + r) * stride + cw] = bits;
}

// The scan's shared-memory plan, made on the host for the kernel.
struct ScanPlan {
  int words;   // 64-box words of a problem, ceil(n / 64)
  int stride;  // the scratch mask's row stride: words rounded up to even
  int whole;   // 1: a stage is a whole row block, one contiguous copy;
               // 0: a stage is a column tile, one copy a row
  int tile;    // column words of a staged tile (even)
  int pitch;   // words of a staged row in shared memory: the stride for a
               // whole row block, else the tile padded to 2 mod 16 so that
               // a column read over the rows is 2-way banked
  int slots;   // staged tiles in flight
  int fixed;   // bytes of barriers and bit arrays before the tiles
};

inline ScanPlan scan_plan(int n, int stride, int smem_limit) {
  ScanPlan p;
  p.words = (n + kWord - 1) / kWord;
  p.stride = stride;
  const int raw = (2 * kMaxSlots + 4 + 3 * p.stride) * 8;
  p.fixed = (raw + 127) / 128 * 128;
  // Whole row blocks while 4 of them fit (N up to ~7000): one TMA request
  // a stage. Staged as 64 requests, one a row, a stage cost ~2.1 us on an
  // H100 whatever the rows' bytes, so one larger copy wins though it also
  // brings the rows' dead words left of the diagonal.
  const int fit_whole = (smem_limit - p.fixed) / (kWord * p.stride * 8);
  p.whole = fit_whole >= kMinWholeSlots;
  p.tile = p.whole ? p.stride : (p.stride < kMaxTile ? p.stride : kMaxTile);
  p.pitch = p.whole ? p.stride : p.tile + ((2 - p.tile) % 16 + 16) % 16;
  const int fit = (smem_limit - p.fixed) / (kWord * p.pitch * 8);
  p.slots = fit < kMaxSlots ? fit : kMaxSlots;
  return p;
}

inline int scan_smem(const ScanPlan& p) {
  return p.fixed + p.slots * kWord * p.pitch * 8;
}

// The first column word of step k's first tile: 0 for a whole row block,
// else even, so that a row's copy starts 16-byte aligned; the tile holds
// columns k and k + 1.
__device__ __forceinline__ int first_column(const ScanPlan& p, int k) {
  return p.whole ? 0 : k & ~1;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(u64* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(u64* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_arrive_expect(u64* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait until the barrier has completed its phase number `phase`.
__device__ __forceinline__ void bar_wait(u64* bar, unsigned phase) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(phase & 1) : "memory");
  } while (!done);
}

// A TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, u64* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// OR of a warp's 64-bit values, the same on every lane.
__device__ __forceinline__ u64 warp_or(u64 v) {
  const unsigned hi = __reduce_or_sync(kFull, static_cast<unsigned>(v >> 32));
  return (static_cast<u64>(hi) << 32)
         | __reduce_or_sync(kFull, static_cast<unsigned>(v));
}

__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const u64* __restrict__ mask,
                const uint8_t* __restrict__ alive_in,
                uint8_t* __restrict__ alive_out, int n, ScanPlan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  u64* full = reinterpret_cast<u64*>(smem);   // a tile landed, per slot
  u64* empty = full + kMaxSlots;              // a slot's readers are done
  u64* keep_ready = empty + kMaxSlots;        // step k's keep bits, by k & 1
  u64* or_done = keep_ready + 2;              // step k's OR, by k & 1
  u64* removed = or_done + 2;                 // [stride] removed bits
  u64* keep = removed + p.stride;             // [stride] kept bits
  u64* alive = keep + p.stride;               // [stride] alive-in bits
  u64* tiles = reinterpret_cast<u64*>(smem + p.fixed);  // [slots][64][pitch]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t m = blockIdx.x;
  const uint8_t* ain = alive_in + m * n;
  uint8_t* aout = alive_out + m * n;
  const u64* mk = mask + m * n * static_cast<size_t>(p.stride);
  const int slot_words = kWord * p.pitch;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.slots; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kWorkers + 1);
    }
    for (int i = 0; i < 2; ++i) {
      bar_init(&keep_ready[i], 1);
      bar_init(&or_done[i], kWorkers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int w = threadIdx.x; w < p.stride; w += kScanThreads) removed[w] = 0;
  for (int w = warp; w < p.words; w += kScanThreads / 32) {
    const int r0 = w * kWord + lane, r1 = r0 + 32;
    const unsigned lo = __ballot_sync(kFull, r0 < n && ain[r0]);
    const unsigned hi = __ballot_sync(kFull, r1 < n && ain[r1]);
    if (lane == 0) alive[w] = (static_cast<u64>(hi) << 32) | lo;
  }
  __syncthreads();

  // Stages: for each word k in order, its row block (rows 64k .. 64k+63)
  // from column first_column(p, k) on, in tiles of `tile` column words;
  // the stage counter s runs over them in the same order in every role.
  if (warp == 1) {
    // The loader: one TMA bulk copy a whole row block, or one a row of a
    // tile, 2 rows a lane.
    unsigned s = 0;
    for (int k = 0; k < p.words; ++k) {
      const int rows = min(kWord, n - kWord * k);
      const u64* block = mk + static_cast<size_t>(kWord * k) * p.stride;
      for (int c0 = first_column(p, k); c0 < p.stride; c0 += p.tile, ++s) {
        const int slot = s % p.slots;
        const int width = min(p.tile, p.stride - c0);
        if (s >= static_cast<unsigned>(p.slots)) {
          bar_wait(&empty[slot], s / p.slots - 1);
        }
        u64* dst = tiles + static_cast<size_t>(slot) * slot_words;
        if (lane == 0) {
          bar_arrive_expect(&full[slot], rows * width * 8);
          // The resolver reads only a word's first tile: arrive for it.
          if (c0 != first_column(p, k)) bar_arrive(&empty[slot]);
          if (p.whole) bulk_load(dst, block, rows * p.stride * 8, &full[slot]);
        }
        __syncwarp();
        for (int i = lane; !p.whole && i < rows; i += 32) {
          bulk_load(dst + i * p.pitch, block + i * p.stride + c0, width * 8,
                    &full[slot]);
        }
      }
    }
  } else if (warp == 0) {
    // The resolver: word k's candidates are its alive boxes that no kept
    // box of an earlier word removed: removed[k] (words <= k - 2, ORed by
    // the workers) and `carry` (word k - 1, ORed here). Among them, the
    // kept set is the fixpoint of "a candidate stays unless a kept
    // candidate before it overlaps it", iterated from all candidates as
    // JAX's block fixpoint: rank j is exact after j + 1 rounds, so it
    // ends within 65 rounds, in one when no candidate overlaps another.
    unsigned s = 0;
    u64 carry = 0;
    for (int k = 0; k < p.words; ++k) {
      const int slot = s % p.slots, c0 = first_column(p, k);
      const u64* tile = tiles + static_cast<size_t>(slot) * slot_words;
      const bool in0 = kWord * k + lane < n, in1 = kWord * k + lane + 32 < n;
      const bool next = k + 1 < p.words;
      bar_wait(&full[slot], s / p.slots);
      // Row r's diagonal word (the boxes of word k after r that it
      // removes) and its next word.
      const u64 d0 = in0 ? tile[lane * p.pitch + k - c0] : 0;
      const u64 d1 = in1 ? tile[(lane + 32) * p.pitch + k - c0] : 0;
      const u64 e0 = in0 && next ? tile[lane * p.pitch + k + 1 - c0] : 0;
      const u64 e1 = in1 && next ? tile[(lane + 32) * p.pitch + k + 1 - c0] : 0;
      if (k >= 2) bar_wait(&or_done[k & 1], (k - 2) >> 1);
      const u64 cand = alive[k] & ~(removed[k] | carry);
      u64 kept = cand;
      while (true) {  // the same on every lane
        const u64 killed = warp_or(((kept >> lane) & 1 ? d0 : 0)
                                   | ((kept >> (lane + 32)) & 1 ? d1 : 0));
        const u64 again = cand & ~killed;
        if (again == kept) break;
        kept = again;
      }
      if (lane == 0) {
        keep[k] = kept;
        bar_arrive(&keep_ready[k & 1]);
      }
      // The next word's removed bits first: they are on the critical path.
      carry = warp_or(((kept >> lane) & 1 ? e0 : 0)
                      | ((kept >> (lane + 32)) & 1 ? e1 : 0));
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[slot]);
      if (in0) aout[kWord * k + lane] = (kept >> lane) & 1;
      if (in1) aout[kWord * k + lane + 32] = (kept >> (lane + 32)) & 1;
      s += (p.stride - c0 + p.tile - 1) / p.tile;
    }
  } else {
    // The workers: the kept rows of word k remove what they overlap in
    // words k + 2 on, while the resolver takes word k + 1. Worker w owns
    // rows 8w .. 8w+7 of each row block and lane j column words j, j+32,
    // ... of each tile; shared-memory atomics merge the row slices.
    const int w = warp - 2;
    const u64 rows_mine = ((1ull << kRowsPerWorker) - 1)
                          << (kRowsPerWorker * w);
    unsigned s = 0;
    for (int k = 0; k < p.words; ++k) {
      bar_wait(&keep_ready[k & 1], k >> 1);
      const u64 mine = keep[k] & rows_mine;
      for (int c0 = first_column(p, k); c0 < p.stride; c0 += p.tile, ++s) {
        const int slot = s % p.slots;
        bar_wait(&full[slot], s / p.slots);
        if (mine) {
          const u64* tile = tiles + static_cast<size_t>(slot) * slot_words;
          const int hi = min(c0 + p.tile, p.words);
          for (int c = max(c0, k + 2) + lane; c < hi; c += 32) {
            u64 acc = 0;
            for (u64 b = mine; b; b &= b - 1) {
              acc |= tile[(__ffsll(static_cast<long long>(b)) - 1) * p.pitch
                          + c - c0];
            }
            if (acc) atomicOr(&removed[c], acc);
          }
        }
        __syncwarp();
        if (lane == 0) bar_arrive(&empty[slot]);
      }
      __threadfence_block();
      __syncwarp();
      if (lane == 0) bar_arrive(&or_done[k & 1]);
    }
  }
}

}  // namespace

// The kernels' C entry points. boxes [M, N, 4] float32 and alive_in /
// alive_out [M, N] bytes (0 or 1), contiguous; mask an [M, N, stride]
// 64-bit scratch, stride >= ceil(N/64) and even, so that every row starts
// 16-byte aligned for the bulk copies. Each launches on `stream` and
// returns cudaGetLastError() after its launch (cudaErrorInvalidValue for
// a stride it does not take, or an N whose bit arrays leave no room for
// two staged tiles).

namespace {

bool stride_ok(int n, int stride) {
  return stride % 2 == 0 && stride >= (n + kWord - 1) / kWord;
}

}  // namespace

extern "C" int nms_mask(const void* boxes, const void* alive_in,
                        void* alive_out, void* mask, int m, int n, int stride,
                        float thr, void* stream) {
  (void)alive_in;
  (void)alive_out;
  if (m == 0 || n == 0) return cudaSuccess;
  if (!stride_ok(n, stride)) return cudaErrorInvalidValue;
  const int words = (n + kWord - 1) / kWord;
  nms_mask_kernel<<<dim3(words, words, m), kWord, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<u64*>(mask), n, stride,
      thr);
  return cudaGetLastError();
}

extern "C" int nms_scan(const void* boxes, const void* alive_in,
                        void* alive_out, void* mask, int m, int n, int stride,
                        float thr, void* stream) {
  (void)boxes;
  (void)thr;
  if (m == 0 || n == 0) return cudaSuccess;
  if (!stride_ok(n, stride)) return cudaErrorInvalidValue;
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  const ScanPlan p = scan_plan(n, stride, limit);
  if (p.slots < 2) return cudaErrorInvalidValue;
  const int smem = scan_smem(p);
  err = cudaFuncSetAttribute(nms_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  nms_scan_kernel<<<m, kScanThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(mask), static_cast<const uint8_t*>(alive_in),
      static_cast<uint8_t*>(alive_out), n, p);
  return cudaGetLastError();
}

extern "C" int nms_alive(const void* boxes, const void* alive_in,
                         void* alive_out, void* mask, int m, int n, int stride,
                         float thr, void* stream) {
  const int err = nms_mask(boxes, alive_in, alive_out, mask, m, n, stride, thr,
                           stream);
  if (err != cudaSuccess) return err;
  return nms_scan(boxes, alive_in, alive_out, mask, m, n, stride, thr, stream);
}
