// GT polar rays for Hopper (sm_90a): 36 ray lengths per (contour, center)
// pair from a 360-point contour, by a search of the pair's angles sorted
// into 1-degree bins.
//
// Replaces the TPU kernels of yolo_contour_regression_tpu/ops/pallas_polar.py:
//   gt_rays_pallas3 :217 (kernel _gt_rays_kernel3 :149), row-shared pairs
//     with the all-invalid block skip          -> entry gt_rays_rows
//   gt_rays_pallas2 :333 (kernel _gt_rays_kernel2 :287) and
//   gt_rays_pallas  :101 (kernel _gt_rays_kernel :60), per pair
//                                               -> entry gt_rays_pairs
// One kernel body serves both, templated on where a pair's contour lives:
// shared by the K pairs of a row (rows entry), or one per pair.
//
// Contract, shared with the plain PyTorch versions in ops/gt_rays.py
// (gt_rays_rows_plain, gt_rays_pairs_plain) and ops/polar.py:_gt_rays_dense:
//   contours (R, 360, 2) f32, centers (R, K, 2) f32, valid (R, K) bool (or
//   none: every pair valid) -> out (R, K, 36) f32. For each pair:
//     v    = p - c                               (per contour point)
//     ang  = atan2(vy, vx) * (180/pi), +360 where negative
//     dist = sqrt(vx*vx + vy*vy)
//   and for each ray angle theta = 10 * r degrees:
//     diff = |ang - theta|, folded to 360 - diff where above 180
//     the 4 points of least diff, lowest index first on ties
//     ray  = RAY_EPS if the least diff is above 3 degrees, else the largest
//            dist of the 4; then at least RAY_EPS.
//   A pair with valid == false gets RAY_EPS on every ray, and no work.
//   Every operation rounds once (the _rn intrinsics, and the file is built
//   with -fmad=false), atan2f and the correctly rounded sqrt as the plain
//   version calls them, so the kernel reproduces it bit for bit on the card.
//   The TPU kernel's polynomial atan2 (pallas_polar.py:40-54) is not ported:
//   it exists only because Mosaic has no atan2.
//
// What bounds it: the function needs about 10 operations per (pair, point)
// for the angle and distance (3.6 k), one sort of the pair's 360 angles
// (log2(360!) = 2.5 k comparisons, a compare and a select each), one walk
// of the sorted angles beside the 36 rays, and a few tens per ray to take
// the 4 nearest of its sorted neighbours: about 10 k operations per pair
// (chip_smoke.py:gt_rays_bound_ms), against 8 bytes of center and 144
// bytes of rays per pair, and 2.9 KB of contour per row. With a row's
// contour shared by K pairs it is bound by operations (fp32 issue); per
// pair (K = 1) the contour bytes bound it. That count takes atan2 as one
// operation; atan2f is some 66 instructions on this card (chip_smoke.py
// reads them from the SASS), so the angles alone cost about 3x the bound.
//
// What the design does about it: it sorts the angles only as far as the
// rays need (into whole degrees, by counting), and each ray looks at the
// few points near it. A block takes 8 pairs (8 consecutive candidates of a
// row, or 8 consecutive pairs) with 288 threads, 8 x 36.
//   Phase 1, angles: thread t computes the block's flattened (pair, point)
//   values t, t + 288, ... (10 each) in the plain version's op order, from
//   the contour read as float2 straight from device memory (a per-pair
//   block's 8 contours are one contiguous 23 KB run, read coalesced; a
//   row's shared contour is read by all 8 pairs, from L1). No distance yet:
//   only a ray's 4 nearest points need one.
//   Phase 2, bins: each angle goes to its nearest whole degree, bin
//   floor(ang + 0.5) mod 360 (ang may be 360.0: bin 0), by a counting sort
//   in shared memory: a shared atomic counts the bin and gives the point its
//   slot; thread (p, r) sums bins 10 r .. 10 r + 9 and adds the partial sums
//   before its own; the angle and its 16-bit index are scattered into bin
//   order. Ring j of ray r is bins 10 r - j and 10 r + j (modulo 360; ring
//   180 is one bin): their angles are at least j - 0.5 degrees from the ray,
//   less a rounding below 1e-4 (far inside kStopMarginDeg). The slots repeat
//   every 360 degrees as the bins do, so the rings 0 .. J are one run.
//   Phase 3, order: the cost of each (pair, ray) is guessed from the counts
//   and a ballot ranks the 288 by it, dearest first, so that the rays of a
//   warp scan about as many points as each other.
//   Phase 3, search: every angle within 3 degrees of the ray lies in rings
//   0-3, so with none there the ray is RAY_EPS at once (the gate).
//   Otherwise it scans its own bin if that holds 4 or more (their diffs are
//   at most half a degree), else rings 0-3, keeping the 4 least (diff,
//   index) as 64-bit keys, diff's bits above the index: the order is
//   lexicographic, the stable sort's ties, whatever order the atomics gave
//   the scatter. It is RAY_EPS if the least diff is above 3 degrees. Then it
//   widens the window: with fewer than 4 found, to the least J whose rings
//   hold 4 (a binary search over the counts); with 4, to every ring that may
//   hold a diff up to d3, the 4th least, J = int(d3 + 0.5 + 2 margin)
//   (strict: an equal diff at a lower index still displaces). It reads
//   kBatch angles at once and a point's index only when its diff can enter;
//   the 4 points' distances are computed last, by the plain version's ops.
//   Invalid pairs write RAY_EPS and do no work; a block whose pairs are all
//   invalid reads nothing. tests/test_torch_port_rays.py holds a numpy model
//   of phases 2-3 to the plain version bit for bit on the CPU.
// What holds it back (PERF.md, section 6): phases 1-2 are bound by instruction
// issue, most of it atan2f's; phase 3 lasts as long as each block's slowest
// warp, whose rays see a contour from outside, at the edge of its angular
// span, where a bin holds tens of points.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kPoints = 360;
constexpr int kRays = 36;
constexpr int kBinsPerRay = 10;             // bins of 1 degree
constexpr int kBins = kRays * kBinsPerRay;  // bin b: angles nearest b degrees
constexpr int kGateRing = 3;  // every angle within 3 degrees of a ray: bins b0 - 3 .. b0 + 3
constexpr int kPairsPerBlock = 8;
constexpr int kThreads = kPairsPerBlock * kRays;  // one per (pair, ray)
constexpr int kPointsPerThread = kPairsPerBlock * kPoints / kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kCostClasses = 8;  // a ray's expected scan, 0 and then by powers of 2
constexpr int kBatch = 4;        // slots a search reads at once
constexpr float kGapDeg = 3.0f;
constexpr float kStopMarginDeg = 1e-3f;
constexpr float kRayEps = 1e-6f;
constexpr float kRadToDeg = 57.29577951308232f;  // float(180 / pi)

static_assert(kPointsPerThread * kThreads == kPairsPerBlock * kPoints, "phase 1 tiling");

struct Shared {
  float ang[kPairsPerBlock][kPoints];           // angles in bin order
  float raw[kPairsPerBlock][kPoints];           // phase 1's angles, by point index
  unsigned short idx[kPairsPerBlock][kPoints];  // the point index of each sorted angle
  int start[kPairsPerBlock][kBins + 1];         // counts, then each bin's first slot
  int part[kPairsPerBlock][kRays];              // the prefix's partial sums
  int class_base[kCostClasses][kWarps];         // phase 3's order: first slot per class, warp
  short task[kThreads];                         // phase 3's order: (pair, ray) of each thread
  float2 center[kPairsPerBlock];
  bool ok[kPairsPerBlock];
  int ended;  // threads past phase 3 (BlockClock)
};

// The kernel's own clock, built only with -DGT_RAYS_PROFILE (chip_smoke.py
// reads it): per block, its SM and clock64() at its start, after phase 2,
// after phase 3's order and as its last thread ends. Otherwise it is empty.
#ifdef GT_RAYS_PROFILE
__device__ long long* g_profile;  // 5 per block, in grid order
struct BlockClock {
  long long at[3];
  __device__ void mark(int i) { at[i] = clock64(); }
  __device__ void end(int* ended) {
    const long long now = clock64();
    if (atomicAdd(ended, 1) != kThreads - 1) return;
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    long long* rec = g_profile + 5 * ((long long)blockIdx.y * gridDim.x + blockIdx.x);
    rec[0] = sm + 1;
    rec[1] = at[0];
    rec[2] = at[1];
    rec[3] = at[2];
    rec[4] = now;
  }
};
#else
struct BlockClock {
  __device__ void mark(int) {}
  __device__ void end(int*) {}
};
#endif

// (diff, index) as one key: diff >= 0, so its bits order as its values do
__device__ __forceinline__ unsigned long long rank_key(float diff, int i) {
  return ((unsigned long long)__float_as_uint(diff) << 32) | (unsigned)i;
}

__device__ __forceinline__ float key_diff(unsigned long long k) {
  return __uint_as_float((unsigned)(k >> 32));
}

// Phase 3 for pair p's ray r: the ray's length; pts is the pair's contour.
__device__ __forceinline__ float search_ray(const Shared& s, int p, int r, const float2* pts) {
  const float theta = (float)(r * kBinsPerRay);
  const float* ang = s.ang[p];
  const unsigned short* idx = s.idx[p];
  const int* start = s.start[p];
  const int b0 = r * kBinsPerRay;
  // the first slot of bin b, for b in [-360, 720]: the bins repeat every 360
  // degrees, and so do the slots, so a window of bins is one run of slots
  auto first_slot = [&](int b) {
    return b < 0 ? start[b + kBins] - kPoints
                 : (b >= kBins ? start[b - kBins] + kPoints : start[b]);
  };
  // one past the last bin of rings 0 .. ring (ring 180 is one bin)
  auto ring_end = [&](int ring) { return ring == kBins / 2 ? b0 + kBins / 2 : b0 + ring + 1; };
  float v = kRayEps;
  // the gate: no angle in bins b0 - 3 .. b0 + 3, none within 3 degrees
  if (first_slot(b0 + kGateRing + 1) != first_slot(b0 - kGateRing)) {
    const unsigned long long none = rank_key(INFINITY, kPoints);
    unsigned long long k0 = none, k1 = none, k2 = none, k3 = none;  // ascending
    float d3 = INFINITY;  // the 4th least diff so far: only a diff <= d3 can enter
    // slots j0 .. j1 - 1, kBatch at a time: their angles are read together, so
    // one shared-memory latency serves kBatch points; a point's index is read
    // only if its diff can enter
    auto scan_slots = [&](int j0, int j1) {
      for (int j = j0; j < j1; j += kBatch) {
        float df[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          df[u] = fabsf(__fsub_rn(ang[min(j + u, j1 - 1)], theta));
          if (df[u] > 180.0f) df[u] = __fsub_rn(360.0f, df[u]);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (j + u >= j1 || df[u] > d3) continue;
          const unsigned long long key = rank_key(df[u], idx[j + u]);
          if (key < k3) {  // insert: k3 takes it, then one pass of compare-swaps
            k3 = key;
            unsigned long long lo = min(k2, k3);
            k3 = max(k2, k3);
            k2 = lo;
            lo = min(k1, k2);
            k2 = max(k1, k2);
            k1 = lo;
            lo = min(k0, k1);
            k1 = max(k0, k1);
            k0 = lo;
            d3 = key_diff(k3);
          }
        }
      }
    };
    auto scan = [&](int j0, int j1) {  // slots j0 .. j1 - 1 modulo 360, at most 360
      if (j0 < 0) {
        scan_slots(j0 + kPoints, min(j1, 0) + kPoints);
        j0 = 0;
      }
      if (j1 > kPoints) {
        scan_slots(max(j0, kPoints) - kPoints, j1 - kPoints);
        j1 = kPoints;
      }
      scan_slots(j0, j1);
    };
    // rings 0 .. cov scanned: first the ray's own bin if it holds 4 (then
    // the 4 least diffs are within half a degree, and the gate is passed),
    // else the gate's whole window
    int cov = first_slot(b0 + 1) - first_slot(b0) >= 4 ? 0 : kGateRing;
    scan(first_slot(b0 - cov), first_slot(b0 + cov + 1));
    bool gated = false;
    for (;;) {
      if (key_diff(k0) > kGapDeg) {
        gated = true;
        break;
      }
      int ring;
      if (k3 == none) {  // fewer than 4 so far: the least window that holds 4
        int lo = cov + 1, hi = kBins / 2;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (first_slot(ring_end(mid)) - first_slot(b0 - mid) >= 4)
            hi = mid;
          else
            lo = mid + 1;
        }
        ring = lo;
      } else {  // every ring that may hold a diff <= d3, with the margin twice
        ring = min((int)__fadd_rn(key_diff(k3), 0.5f + 2.0f * kStopMarginDeg), kBins / 2);
        if (ring <= cov) break;
      }
      scan(first_slot(b0 - ring), first_slot(b0 - cov));
      scan(first_slot(ring_end(cov)), first_slot(ring_end(ring)));
      cov = ring;
    }
    if (!gated) {  // the 4 points' distances, by the plain version's ops
      const float2 c = s.center[p];
      auto dist = [&](unsigned long long key) {
        const float2 xy = pts[(unsigned)key];
        const float vx = __fsub_rn(xy.x, c.x), vy = __fsub_rn(xy.y, c.y);
        return __fsqrt_rn(__fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy)));
      };
      v = fmaxf(fmaxf(dist(k0), dist(k1)), fmaxf(dist(k2), dist(k3)));
    }
  }
  return fmaxf(v, kRayEps);
}

template <bool kRowShared>
__global__ void __launch_bounds__(kThreads)
gt_rays_kernel(const float* __restrict__ contours, const float* __restrict__ centers,
               const unsigned char* __restrict__ valid, float* __restrict__ out, int count) {
  __shared__ Shared s;
  const int t = threadIdx.x;
  BlockClock timer;
  timer.mark(0);

  // the block's pairs are [first, first + n); count is K (rows) or P (pairs)
  long long first;
  int n;
  const float2* contour;
  if (kRowShared) {
    const int k0 = blockIdx.y * kPairsPerBlock;
    first = (long long)blockIdx.x * count + k0;
    n = min(kPairsPerBlock, count - k0);
    contour = reinterpret_cast<const float2*>(contours) + (long long)blockIdx.x * kPoints;
  } else {
    first = (long long)blockIdx.x * kPairsPerBlock;
    n = (int)min((long long)kPairsPerBlock, count - first);
    contour = reinterpret_cast<const float2*>(contours) + first * kPoints;
  }
  float* o = out + first * kRays;

  bool mine = false;
  if (t < kPairsPerBlock) {
    mine = t < n && (valid == nullptr || valid[first + t] != 0);
    s.ok[t] = mine;
    if (mine) s.center[t] = make_float2(centers[2 * (first + t)], centers[2 * (first + t) + 1]);
  }
  for (int i = t; i < kPairsPerBlock * (kBins + 1); i += kThreads) (&s.start[0][0])[i] = 0;
  if (t == 0) s.ended = 0;
  if (!__syncthreads_or(mine)) {  // every pair of the block invalid: read nothing
    if (t < n * kRays) o[t] = kRayEps;
    return;
  }

  // phase 1: the angles; phase 2 counts each angle's bin. Thread t takes the
  // block's flattened (pair, point) values t, t + 288, ...
  int slot[kPointsPerThread];  // bin << 16 | slot within it; -1: no point
  {
    int p = 0, q = t;
#pragma unroll
    for (int k = 0; k < kPointsPerThread; ++k) {
      slot[k] = -1;
      if (s.ok[p]) {
        const float2 c = s.center[p];
        const float2 xy = contour[kRowShared ? q : p * kPoints + q];
        float ang = __fmul_rn(atan2f(__fsub_rn(xy.y, c.y), __fsub_rn(xy.x, c.x)), kRadToDeg);
        if (ang < 0.0f) ang = __fadd_rn(ang, 360.0f);
        s.raw[p][q] = ang;
        int bin = (int)__fadd_rn(ang, 0.5f);
        if (bin >= kBins) bin -= kBins;  // ang = 360.0 and just below it
        slot[k] = (bin << 16) | atomicAdd(&s.start[p][bin], 1);
      }
      q += kThreads;
      if (q >= kPoints) q -= kPoints, ++p;
    }
  }
  __syncthreads();
  // counts -> each bin's first slot: thread t, as (pair tp, ray tr), sums
  // bins 10 tr .. 10 tr + 9, then adds the partial sums before its own
  const int tp = t / kRays, tr = t - tp * kRays;
  int c[kBinsPerRay];
  if (s.ok[tp]) {
    int sum = 0;
#pragma unroll
    for (int i = 0; i < kBinsPerRay; ++i) sum += (c[i] = s.start[tp][tr * kBinsPerRay + i]);
    s.part[tp][tr] = sum;
  }
  __syncthreads();
  if (s.ok[tp]) {
    int run = 0;
#pragma unroll
    for (int q = 0; q < kRays; ++q) run += q < tr ? s.part[tp][q] : 0;
#pragma unroll
    for (int i = 0; i < kBinsPerRay; ++i) {
      s.start[tp][tr * kBinsPerRay + i] = run;
      run += c[i];
    }
    if (tr == kRays - 1) s.start[tp][kBins] = run;
  }
  __syncthreads();
  {
    int pk = 0, q = t;
#pragma unroll
    for (int k = 0; k < kPointsPerThread; ++k) {
      if (slot[k] >= 0) {
        const int at = s.start[pk][slot[k] >> 16] + (slot[k] & 0xffff);
        s.ang[pk][at] = s.raw[pk][q];
        s.idx[pk][at] = (unsigned short)q;
      }
      q += kThreads;
      if (q >= kPoints) q -= kPoints, ++pk;
    }
  }
  __syncthreads();
  timer.mark(1);

  // phase 3's order: each thread takes one (pair, ray), the dearest first, so
  // that the rays of a warp scan about as many points as each other. The cost
  // of a ray is guessed from the counts: 0 if its gate's window is empty,
  // else its own bin's points if they are 4 or more, else the window's.
  {
    int cost = 0;
    if (tp < n && s.ok[tp]) {
      const int* st = s.start[tp];
      const int b = tr * kBinsPerRay;
      const int lo = b >= kGateRing ? st[b - kGateRing] : st[b - kGateRing + kBins] - kPoints;
      const int window = st[b + kGateRing + 1] - lo, own = st[b + 1] - st[b];
      cost = window == 0 ? 0 : (own >= 4 ? own : window);
    }
    const int cls = kCostClasses - 1 - min(32 - __clz(cost), kCostClasses - 1);  // dearest: 0
    const int lane = t & 31, warp = t >> 5;
    int rank = 0;
#pragma unroll
    for (int k = 0; k < kCostClasses; ++k) {
      const unsigned same = __ballot_sync(0xffffffffu, cls == k);
      if (cls == k) rank = __popc(same & ((1u << lane) - 1));
      if (lane == 0) s.class_base[k][warp] = __popc(same);
    }
    __syncthreads();
    if (t < kCostClasses) {  // counts -> first slots, class by class, warp by warp
      int total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) total += s.class_base[t][w];
      int upto = total;  // the counts of classes 0 .. t
#pragma unroll
      for (int d = 1; d < kCostClasses; d <<= 1) {
        const int below = __shfl_up_sync((1u << kCostClasses) - 1, upto, d);
        if (t >= d) upto += below;
      }
      int run = upto - total;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int c = s.class_base[t][w];
        s.class_base[t][w] = run;
        run += c;
      }
    }
    __syncthreads();
    s.task[s.class_base[cls][warp] + rank] = (short)t;
    __syncthreads();
  }

  // phase 3: the search, one (pair, ray) per thread
  timer.mark(2);
  const int task = s.task[t];
  const int p = task / kRays;
  if (p < n) {
    const float2* pts = contour + (kRowShared ? 0 : p * kPoints);
    o[task] = s.ok[p] ? search_ray(s, p, task - p * kRays, pts) : kRayEps;
  }
  timer.end(&s.ended);
}

}  // namespace

extern "C" {

// Pairs per block: the rows entry's grid has ceil(K / this) blocks in its
// second dimension, at most 65535, which the wrapper checks. (The name
// dates from the first version, which ran one warp per pair.)
int gt_rays_max_warps() { return kPairsPerBlock; }

// Row-shared pairs: contours (rows, 360, 2), centers (rows, K, 2), valid
// (rows, K) bool, out (rows, K, 36); contours 8-byte aligned. Launches on
// `stream` (a cudaStream_t) and returns cudaGetLastError(); it does not
// synchronise and allocates nothing. The caller checks shapes, types,
// devices, alignment and contiguity.
int gt_rays_rows(const void* contours, const void* centers, const void* valid, void* out,
                 int rows, int pairs_per_row, void* stream) {
  if (rows == 0 || pairs_per_row == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)rows,
                  (unsigned)((pairs_per_row + kPairsPerBlock - 1) / kPairsPerBlock));
  gt_rays_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(contours), static_cast<const float*>(centers),
      static_cast<const unsigned char*>(valid), static_cast<float*>(out), pairs_per_row);
  return (int)cudaGetLastError();
}

// One contour per pair: contours (P, 360, 2), 8-byte aligned, centers (P, 2),
// out (P, 36).
int gt_rays_pairs(const void* contours, const void* centers, void* out, int pairs,
                  void* stream) {
  if (pairs == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)(((long long)pairs + kPairsPerBlock - 1) / kPairsPerBlock);
  gt_rays_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(contours), static_cast<const float*>(centers), nullptr,
      static_cast<float*>(out), pairs);
  return (int)cudaGetLastError();
}

#ifdef GT_RAYS_PROFILE
// Where the kernel's clock writes (5 int64 per block of the next launch), and
// how many blocks of each form an SM holds at once.
int gt_rays_set_profile(void* records) {
  return (int)cudaMemcpyToSymbol(g_profile, &records, sizeof(records));
}
int gt_rays_blocks_per_sm(int rows_form) {
  int n = 0;
  if (rows_form)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gt_rays_kernel<true>, kThreads, 0);
  else
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gt_rays_kernel<false>, kThreads, 0);
  return n;
}
#endif

}  // extern "C"
