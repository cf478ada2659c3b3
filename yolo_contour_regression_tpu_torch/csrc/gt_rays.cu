// GT polar rays for Hopper (sm_90a): 36 ray lengths per (contour, center)
// pair from a 360-point contour, by angle binning.
//
// Replaces the TPU kernels of yolo_contour_regression_tpu/ops/pallas_polar.py:
//   gt_rays_pallas3 :217 (kernel _gt_rays_kernel3 :149), row-shared pairs
//     with the all-invalid block skip          -> entry gt_rays_rows
//   gt_rays_pallas2 :333 (kernel _gt_rays_kernel2 :287) and
//   gt_rays_pallas  :101 (kernel _gt_rays_kernel :60), per pair
//                                               -> entry gt_rays_pairs
// One kernel serves both: the contour of pair j is row j / pairs_per_row;
// the rows entry passes K, the per-pair entry passes 1.
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
// the 4 nearest of its sorted neighbours: about 10 k operations per pair,
// against 8 bytes of center and 144 bytes of rays per pair, and 2.9 KB of
// contour per row. With a row's contour shared by K pairs it is bound by
// operations (fp32 issue); per pair (K = 1) the contour bytes bound it.
// This kernel's own scan does about 68 k operations per pair (5 per (ray,
// point)), some 7 times what the function needs.
//
// What the design does about it (a plain first version): one block per
// (row, group of up to 8 pairs), one warp per pair. The row's 360 points are
// read from device memory once per block into shared memory. Each warp
// computes its pair's 360 angles and distances once (11-12 per lane) into
// shared memory, then each lane owns one or two of the 36 rays and scans the
// 360 angles in index order, keeping a top-4 of (diff, index) in registers
// with a strict '<', so ties keep the lowest index; every lane reads the
// same angle at once (a shared-memory broadcast). Invalid pairs return at
// once, and a block whose pairs are all invalid reads nothing. What it does
// not do yet: lanes 0-3 own two rays and the other 28 one, so the scan takes
// 720 steps where 405 would do; and every ray scans all 360 points, where
// sorting the angles once per pair would let each ray look at a few.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kPoints = 360;
constexpr int kRays = 36;
constexpr int kMaxWarps = 8;
constexpr float kRayStepDeg = 10.0f;
constexpr float kGapDeg = 3.0f;
constexpr float kRayEps = 1e-6f;
constexpr float kRadToDeg = 57.29577951308232f;  // float(180 / pi)

__global__ void __launch_bounds__(kMaxWarps * 32)
gt_rays_kernel(const float* __restrict__ contours, const float* __restrict__ centers,
               const unsigned char* __restrict__ valid, float* __restrict__ out,
               int pairs_per_row) {
  extern __shared__ float smem[];
  float* cx = smem;
  float* cy = smem + kPoints;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  float* ang = smem + 2 * kPoints + warp * 2 * kPoints;
  float* dist = ang + kPoints;

  const long long row = blockIdx.x;
  const int k = blockIdx.y * nwarps + warp;
  const bool in_row = k < pairs_per_row;
  const long long pair = row * pairs_per_row + k;
  const bool active = in_row && (valid == nullptr || valid[pair] != 0);
  float* o = out + pair * kRays;

  if (!__syncthreads_or(active)) {  // all pairs of the block invalid
    if (in_row)
      for (int r = lane; r < kRays; r += 32) o[r] = kRayEps;
    return;
  }
  const float* c = contours + row * (2 * kPoints);
  for (int i = threadIdx.x; i < kPoints; i += blockDim.x) {
    cx[i] = c[2 * i];
    cy[i] = c[2 * i + 1];
  }
  __syncthreads();
  if (!in_row) return;
  if (!active) {
    for (int r = lane; r < kRays; r += 32) o[r] = kRayEps;
    return;
  }

  const float px = centers[2 * pair];
  const float py = centers[2 * pair + 1];
  for (int i = lane; i < kPoints; i += 32) {
    const float vx = __fsub_rn(cx[i], px);
    const float vy = __fsub_rn(cy[i], py);
    float a = __fmul_rn(atan2f(vy, vx), kRadToDeg);
    if (a < 0.0f) a = __fadd_rn(a, 360.0f);
    ang[i] = a;
    dist[i] = __fsqrt_rn(__fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy)));
  }
  __syncwarp();

  for (int r = lane; r < kRays; r += 32) {
    const float theta = (float)r * kRayStepDeg;
    float d0 = INFINITY, d1 = INFINITY, d2 = INFINITY, d3 = INFINITY;
    int i0 = 0, i1 = 0, i2 = 0, i3 = 0;
    for (int i = 0; i < kPoints; ++i) {
      float df = fabsf(__fsub_rn(ang[i], theta));
      if (df > 180.0f) df = __fsub_rn(360.0f, df);
      if (df < d3) {  // strict: a later point never displaces an equal one
        if (df < d2) {
          d3 = d2; i3 = i2;
          if (df < d1) {
            d2 = d1; i2 = i1;
            if (df < d0) {
              d1 = d0; i1 = i0; d0 = df; i0 = i;
            } else {
              d1 = df; i1 = i;
            }
          } else {
            d2 = df; i2 = i;
          }
        } else {
          d3 = df; i3 = i;
        }
      }
    }
    float v = kRayEps;
    if (!(d0 > kGapDeg))
      v = fmaxf(fmaxf(dist[i0], dist[i1]), fmaxf(dist[i2], dist[i3]));
    o[r] = fmaxf(v, kRayEps);
  }
}

int launch(const void* contours, const void* centers, const void* valid, void* out, int rows,
           int pairs_per_row, void* stream) {
  if (rows == 0 || pairs_per_row == 0) return (int)cudaSuccess;
  const int nwarps = pairs_per_row < kMaxWarps ? pairs_per_row : kMaxWarps;
  const dim3 grid((unsigned)rows, (unsigned)((pairs_per_row + nwarps - 1) / nwarps));
  const size_t smem = (size_t)(2 + 2 * nwarps) * kPoints * sizeof(float);
  gt_rays_kernel<<<grid, nwarps * 32, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(contours), static_cast<const float*>(centers),
      static_cast<const unsigned char*>(valid), static_cast<float*>(out), pairs_per_row);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Pairs per block at most, so the wrapper can check the grid's second
// dimension (at most 65535 blocks).
int gt_rays_max_warps() { return kMaxWarps; }

// Row-shared pairs: contours (rows, 360, 2), centers (rows, K, 2), valid
// (rows, K) bool, out (rows, K, 36). Launches on `stream` (a cudaStream_t)
// and returns cudaGetLastError(); it does not synchronise and allocates
// nothing. The caller checks shapes, types, devices and contiguity.
int gt_rays_rows(const void* contours, const void* centers, const void* valid, void* out,
                 int rows, int pairs_per_row, void* stream) {
  return launch(contours, centers, valid, out, rows, pairs_per_row, stream);
}

// One contour per pair: contours (P, 360, 2), centers (P, 2), out (P, 36).
int gt_rays_pairs(const void* contours, const void* centers, void* out, int pairs,
                  void* stream) {
  return launch(contours, centers, nullptr, out, pairs, 1, stream);
}

}  // extern "C"
