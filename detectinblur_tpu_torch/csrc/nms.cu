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
//   (a) nms_mask_kernel writes the suppression words. Its contract, for
//       problem m, row r and column word cw >= floor(r/64): bit j of word
//       cw of row r is set exactly when c = 64 cw + j > r, c is alive in
//       alive_in, and IoU(r, c) > thr (below). It writes that word for
//       every alive row r. Words of dead rows, and words left of a row's
//       own word, may stay unwritten, because the scan never reads one
//       into a result: the resolver takes row r's diagonal and next word
//       only when r is kept (nms_scan_kernel, `killed` at :600-601 and
//       `carry` at :611-612), the workers OR only kept rows (`mine`, :630),
//       and kept rows are alive. Dead columns' bits are 0, so a word equals
//       the plain one (ops/nms.py::_suppression_mask_plain) bit for bit.
//       The grid holds only tiles with cw >= rw: block x of a problem is
//       one column word and up to 4 row words rw <= cw, a warp each
//       (numbered column word by column word, mask_blocks_before), and
//       grid y runs over the problems (looping past 65535, so M has no
//       cap). Each block reads its column word's and its row words' alive
//       bytes from alive_in in one round trip (a ballot a 32 bytes) and
//       exits when no row is alive; alive rows against a word with no
//       alive column get 0 and no IoU. Otherwise it stages the column
//       word's 64 boxes, their areas (each made once) and their bits in
//       shared memory, a box a thread (the area is made in the registers
//       the box passed through; a bulk copy would need a second pass over
//       shared memory for it). Each lane takes two rows, r and r + 32:
//         1. the filter, the hot loop: a pair is a candidate when both
//            boxes have a positive width and height and none of rz - cx,
//            cz - rx, rw - cy, cw - ry has its sign bit set, i.e. is < 0
//            (or -0). 4 subtractions a pair on the FMA pipe, an OR and
//            two funnel shifts that collect the sign bits into the words,
//            skipping groups of 8 columns no row of the warp may take. No
//            NaN test: with positive widths and heights no difference is
//            NaN, and a pair whose IoU exceeds thr >= 0 has
//            min(rz, cz) > max(rx, cx) and min(rw, cw) > max(ry, cy),
//            so all four differences are > 0: the filter only rules out
//            pairs whose test is false, whatever the inputs (NaN or
//            infinite coordinates included). When 0 > thr every alive
//            pair is a candidate (inter = 0 then passes).
//         2. the exact test, on the candidates only: candidate_test() for
//            thr >= 2^-20 (no NaN test on the coordinates, two fused
//            multiply-adds against thr and the float after it, the
//            division only between the two), else overlaps(), the general
//            test with max_nan / min_nan and __fdiv_rn. Each lane walks
//            its own candidates, lowest bit first by 32-bit halves.
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
// Why: a block a 64 x 64 tile over the full words x words grid, with
// every pair NaN-tested and divided, ran at 7-12% of even its all-pairs
// bound (0.1201 ms on the serving postprocess's 8 x 4096 pool with 1.3%
// alive, 0.1677 ms on the train RPN's 40 x 2000; chip_smoke.py phase 14,
// an H100 80GB HBM3 at 700 W). On this card a float comparison, a min or
// max, a select, a logic op and a shift run at half the rate of an add
// (64 lanes a clock an SM), so the filter keeps its per-pair work to
// subtractions plus three such ops. What is left of the time: the exact
// tests where boxes overlap (the RPN's coarse levels), each lane walking
// its own candidates, and the launch of the grid's blocks, the floor of
// the mostly dead postprocess.
// The scan's first version (one warp a problem, row words fetched from
// device memory in the step that needs them) cost ~10 us a word, latency
// bound; here a step's reads are shared-memory reads of a tile that
// landed while earlier words were resolved.
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
// a NaN coordinate removes nothing on either side. The filter drops only
// pairs whose test is false, and candidate_test() answers as overlaps() on
// the pairs it lets through (its note), so the words are the one-pass
// test's. The
// scan reads the same bits in another order: OR is commutative and
// idempotent, and the fixpoint of a word is unique (the greedy answer), so
// its result is the plain version's bit for bit.
//
// What bounds it on this card. The mask: operations, counted for the pairs
// it needs, alive r < alive c of a problem, at 14 float32 operations, plus
// 3 a box for its area (chip_smoke.py phase 14 prints this bound and the
// share beside the kernel's time); its bytes are the boxes, alive_in and
// the covered words of the alive rows. Where few boxes are alive (the
// serving postprocess: ~55 of 4096 a problem) the bytes bound it and the
// launch and the per-block alive reads set its time. The scan: no roofline
// counts its chain of ceil(N/64) dependent steps (64 for the postprocess's
// 4096 candidates, 32 and 16 for the RPN's 2000 and 1000); its time is
// that chain's length times the cost of a step, which phase 14 reports:
// 0.58-1.05 us a step with whole row blocks, 4.9 us in column tiles
// (16385 boxes), on an H100 80GB HBM3 at 700 W.

#include <climits>
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
constexpr int kRowWarps = 4;              // row words of a mask block, a warp each
constexpr int kMaskThreads = 32 * kRowWarps;
constexpr int kMaxGridY = 65535;
static_assert(kMaskThreads >= kWord, "a mask block stages a box a thread");
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

// OR of a warp's 64-bit values, the same on every lane.
__device__ __forceinline__ u64 warp_or(u64 v) {
  const unsigned hi = __reduce_or_sync(kFull, static_cast<unsigned>(v >> 32));
  return (static_cast<u64>(hi) << 32)
         | __reduce_or_sync(kFull, static_cast<unsigned>(v));
}

// IoU(r, c) > thr for a pair that passed the mask kernel's filter, when
// thr >= 2^-20 and thr_next is the float after thr: 0 (no), 1 (yes) or 2
// (decide by candidate_divide), the same answer as overlaps() with no NaN
// test on the coordinates and no division away from the threshold. Why it
// is the same:
//  - every coordinate of the pair is a number, and min(rz, cz) >=
//    max(rx, cx), min(rw, cw) >= max(ry, cy) (the filter, and both boxes
//    of a positive width and height): max_nan / min_nan are fmaxf /
//    fminf, w and h are >= 0 and the clamps at 0 change at most the sign
//    of a zero, which leaves the answer no (0 > thr is false). inter =
//    w * h is >= 0, +inf, or NaN as 0 * inf; a NaN inter makes the union
//    NaN. A NaN union gives no in overlaps() (NaN > thr is false) and
//    here. With the union a number, u = fmaxf(union, 1e-12) =
//    max_nan(union, 1e-12) >= 1e-12 or +inf.
//  - RN(inter / u) > thr holds when inter / u >= thr_next (RN is
//    monotone and thr_next is a float) and fails when inter / u <= thr;
//    only inter / u strictly between thr and thr_next needs the division.
//  - __fmaf_rn(-t, u, inter) = RN(inter - t u) has the sign of the exact
//    inter - t u for t in {thr, thr_next}: t >= 2^-20 and u >= 1e-12 >
//    2^-40 are normal, so t u is a multiple of 2^-43 2^-63 = 2^-106 and
//    inter a multiple of 2^-149 (denormals included); a nonzero difference
//    is then at least 2^-149 in size, which RN neither flushes to 0 nor
//    (being at most FLT_MAX in size) takes to infinity. So sign(inter -
//    t u) decides inter / u against t exactly.
//  - u = +inf: inter - t u = -inf (inter finite): no, as inter / inf = 0
//    is not > thr; inter = +inf: NaN, no, as inf / inf is NaN; u finite
//    and inter = +inf: +inf, yes, as inf / u = inf > thr; inter = +-0:
//    -t u < 0, no, as 0 > thr is false.
// The float32 IoUs one ulp below, at and above 0.5 and 0.7 in
// tests/nms_cases.py sit on this boundary.
__device__ __forceinline__ float candidate_inter(float4 r, float4 c) {
  return __fmul_rn(__fsub_rn(fminf(r.z, c.z), fmaxf(r.x, c.x)),
                   __fsub_rn(fminf(r.w, c.w), fmaxf(r.y, c.y)));
}

__device__ __forceinline__ int candidate_test(float4 r, float area_r,
                                              float4 c, float area_c,
                                              float thr, float thr_next) {
  const float inter = candidate_inter(r, c);
  const float uni = __fsub_rn(__fadd_rn(area_r, area_c), inter);
  const float u = fmaxf(uni, 1e-12f);
  const bool above = __fmaf_rn(-thr, u, inter) > 0.0f;
  const bool clear = __fmaf_rn(-thr_next, u, inter) >= 0.0f;
  return uni != uni || !above ? 0 : (clear ? 1 : 2);
}

// RN(inter / u) > thr for a pair candidate_test() left undecided.
__device__ __noinline__ bool candidate_divide(float4 r, float area_r,
                                              float4 c, float area_c,
                                              float thr) {
  const float inter = candidate_inter(r, c);
  const float uni = __fsub_rn(__fadd_rn(area_r, area_c), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-12f)) > thr;
}

// Mask blocks of one problem before column word cw: column word c has
// c / kRowWarps + 1 blocks, one for each kRowWarps row words rw <= c.
__host__ __device__ inline long long mask_blocks_before(long long cw) {
  const long long q = cw / kRowWarps, s = cw % kRowWarps;
  return cw + kRowWarps * q * (q - 1) / 2 + s * q;
}

// The threshold's constants, the same for every pair.
struct Threshold {
  float thr, next;  // thr, and the float after it
  bool zero_hit;    // 0 > thr: a pair with no intersection is a hit
  bool fast;        // thr >= 2^-20: candidate_test() is exact
};

// The block's column word in shared memory: its boxes, their areas, the
// alive columns and those of a positive width and height (low and high
// halves).
struct ColumnWord {
  float4 box[kWord];
  float area[kWord];
  unsigned alive[2];
  unsigned pos[2];
};

// A row's bits in the block's column word: the exact test on each of its
// candidates, lowest first, by 32-bit halves.
__device__ __forceinline__ u64 exact_bits(u64 cand, float4 rb, float ra,
                                          const ColumnWord& cc,
                                          const Threshold& t) {
  u64 bits = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    unsigned got = 0;
    for (unsigned x = static_cast<unsigned>(cand >> (32 * h)); x;) {
      const unsigned low = x & (0u - x);
      x ^= low;
      const int j = 32 * h + 31 - __clz(low);
      const float4 cb = cc.box[j];
      const float ca = cc.area[j];
      int s;
      if (t.fast) {
        s = candidate_test(rb, ra, cb, ca, t.thr, t.next);
        if (s == 2) s = candidate_divide(rb, ra, cb, ca, t.thr);
      } else {
        s = overlaps(rb, ra, cb, ca, t.thr);
      }
      if (s) got |= low;
    }
    bits |= static_cast<u64>(got) << (32 * h);
  }
  return bits;
}

// Column word cw against row word rw of one problem (one warp; rw > cw:
// none), lane l taking rows r0 = 64 rw + l and r1 = r0 + 32. Every return
// before the second __syncthreads is the same for the whole block.
__device__ __forceinline__ void mask_tile(
    const float4* __restrict__ pb, const uint8_t* __restrict__ ain,
    u64* __restrict__ pm, int n, int stride, int cw, int rw,
    const Threshold& t, ColumnWord& cc) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = rw * kWord + lane, r1 = r0 + 32;
  const int c = cw * kWord + threadIdx.x;   // warps 0 and 1: the columns
  // Three loads at once (indices clamped, then masked): one round trip.
  const bool a0 = ain[min(r0, n - 1)], a1 = ain[min(r1, n - 1)];
  const bool ac = ain[min(c, n - 1)];
  const bool mine = rw <= cw;
  const unsigned alo = __ballot_sync(kFull, mine && r0 < n && a0);
  const unsigned ahi = __ballot_sync(kFull, mine && r1 < n && a1);
  const bool live0 = (alo >> lane) & 1, live1 = (ahi >> lane) & 1;
  if (warp < 2) {
    const unsigned bits = __ballot_sync(kFull, c < n && ac);
    if (lane == 0) cc.alive[warp] = bits;
  }
  if (!__syncthreads_or(alo | ahi)) return;   // no alive row in the block
  const u64 cols = (static_cast<u64>(cc.alive[1]) << 32) | cc.alive[0];
  u64* w0 = pm + static_cast<size_t>(r0) * stride + cw;
  u64* w1 = pm + static_cast<size_t>(r1) * stride + cw;
  if (cols == 0) {   // no alive column: the alive rows' words are 0
    if (live0) *w0 = 0;
    if (live1) *w1 = 0;
    return;
  }
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (warp < 2) {
    const float4 b = c < n ? pb[c] : zero;
    cc.box[threadIdx.x] = b;
    cc.area[threadIdx.x] = area(b);
    const unsigned pos = __ballot_sync(kFull, b.z > b.x && b.w > b.y);
    if (lane == 0) cc.pos[warp] = pos;
  }
  const float4 b0 = live0 ? pb[r0] : zero, b1 = live1 ? pb[r1] : zero;
  __syncthreads();
  if (!(alo | ahi)) return;

  // A row may take only alive columns after it (all of a later word, the
  // bits above its own in its own word); unless 0 > thr, only columns of a
  // positive width and height, from a row of a positive width and height.
  const u64 col_ok = cols & (t.zero_hit ? ~0ull
      : (static_cast<u64>(cc.pos[1]) << 32) | cc.pos[0]);
  const bool diag = cw == rw;
  const u64 after0 = diag ? ~0ull << lane << 1 : ~0ull;
  const u64 after1 = diag ? (lane == 31 ? 0 : ~0ull << (lane + 33)) : ~0ull;
  const bool ok0 = live0 && (t.zero_hit || (b0.z > b0.x && b0.w > b0.y));
  const bool ok1 = live1 && (t.zero_hit || (b1.z > b1.x && b1.w > b1.y));
  u64 cand0 = ok0 ? col_ok & after0 : 0;
  u64 cand1 = ok1 ? col_ok & after1 : 0;
  if (!t.zero_hit) {
    // The filter, the hot loop: a pair is a candidate unless one of rz -
    // cx, cz - rx, rw - cy, cw - ry has its sign bit set, i.e. is < 0 (or
    // -0); with both boxes of a positive width and height, none is NaN.
    // Per pair 4 subtractions on the FMA pipe, an OR of three and two
    // funnel shifts that move the sign bits into the words (columns taken
    // from the highest down); no NaN test, no division. A group of 8
    // columns that no row of the warp may take is skipped.
    const u64 need = warp_or(cand0 | cand1);
    unsigned s0[2] = {0, 0}, t0[2] = {0, 0}, s1[2] = {0, 0}, t1[2] = {0, 0};
#pragma unroll
    for (int g = kWord / 8 - 1; g >= 0; --g) {
      const int h = g / 4;
      if (((need >> (8 * g)) & 0xff) == 0) {
        s0[h] <<= 8;
        t0[h] <<= 8;
        s1[h] <<= 8;
        t1[h] <<= 8;
        continue;
      }
#pragma unroll
      for (int k = 7; k >= 0; --k) {
        const float4 cb = cc.box[8 * g + k];
        s0[h] = __funnelshift_l(__float_as_uint(__fsub_rn(b0.z, cb.x))
                                | __float_as_uint(__fsub_rn(cb.z, b0.x))
                                | __float_as_uint(__fsub_rn(b0.w, cb.y)),
                                s0[h], 1);
        t0[h] = __funnelshift_l(__float_as_uint(__fsub_rn(cb.w, b0.y)),
                                t0[h], 1);
        s1[h] = __funnelshift_l(__float_as_uint(__fsub_rn(b1.z, cb.x))
                                | __float_as_uint(__fsub_rn(cb.z, b1.x))
                                | __float_as_uint(__fsub_rn(b1.w, cb.y)),
                                s1[h], 1);
        t1[h] = __funnelshift_l(__float_as_uint(__fsub_rn(cb.w, b1.y)),
                                t1[h], 1);
      }
    }
    cand0 &= ~((static_cast<u64>(s0[1] | t0[1]) << 32) | (s0[0] | t0[0]));
    cand1 &= ~((static_cast<u64>(s1[1] | t1[1]) << 32) | (s1[0] | t1[0]));
  }
  // The exact test on the candidates alone, each lane walking its own.
  const u64 bits0 = cand0 ? exact_bits(cand0, b0, area(b0), cc, t) : 0;
  const u64 bits1 = cand1 ? exact_bits(cand1, b1, area(b1), cc, t) : 0;
  if (live0) *w0 = bits0;
  if (live1) *w1 = bits1;
}

// Grid: x the (column word, row-word group) blocks of a problem, only
// groups that reach the diagonal; y the problems, each block looping over
// every gridDim.y-th one.
__global__ void __launch_bounds__(kMaskThreads, 8)
nms_mask_kernel(const float4* __restrict__ boxes,
                const uint8_t* __restrict__ alive_in, u64* __restrict__ mask,
                int m_count, int n, int stride, float thr) {
  __shared__ ColumnWord cc;
  const int words = (n + kWord - 1) / kWord;
  const long long b = blockIdx.x;
  int lo = 0, hi = words - 1;   // the column word: the last cw whose blocks
  while (lo < hi) {             // start at or before this one
    const int mid = (lo + hi + 1) / 2;
    if (mask_blocks_before(mid) <= b) lo = mid; else hi = mid - 1;
  }
  const int cw = lo;
  const int rw = static_cast<int>(b - mask_blocks_before(cw)) * kRowWarps
                 + threadIdx.x / 32;
  Threshold t;
  t.thr = thr;
  t.next = __int_as_float(__float_as_int(thr) + 1);
  t.zero_hit = 0.0f > thr;
  t.fast = thr >= 0x1p-20f;
  for (int m = blockIdx.y; m < m_count; m += gridDim.y) {
    const size_t base = static_cast<size_t>(m) * n;
    mask_tile(boxes + base, alive_in + base, mask + base * stride, n, stride,
              cw, rw, t, cc);
    __syncthreads();   // the next problem restages the column word
  }
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
  (void)alive_out;
  if (m == 0 || n == 0) return cudaSuccess;
  if (!stride_ok(n, stride)) return cudaErrorInvalidValue;
  const long long blocks = mask_blocks_before((n + kWord - 1) / kWord);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks), m < kMaxGridY ? m : kMaxGridY);
  nms_mask_kernel<<<grid, kMaskThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(alive_in),
      static_cast<u64*>(mask), m, n, stride, thr);
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
